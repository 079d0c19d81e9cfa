"""Mistral-Nemo-12B: dense decoder, GQA, 128k context.

[hf:mistralai/Mistral-Nemo-Base-2407; hf] — 40L d5120 32H kv8 head_dim 128
d_ff 14336 vocab 131072.
"""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="mistral-nemo-12b", family="dense", n_layers=40,
        d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14_336,
        vocab=131_072, period=("attn",), rope_theta=1_000_000.0)


def reduced() -> ArchConfig:
    return ArchConfig(
        name="mistral-nemo-12b-reduced", family="dense", n_layers=2,
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
        vocab=256, period=("attn",), rope_theta=1_000_000.0, remat="none")


register("mistral-nemo-12b", full, reduced)
