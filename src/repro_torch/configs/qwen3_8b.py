"""Qwen3-8B: dense decoder, GQA, qk-norm.

[hf:Qwen/Qwen3-8B; hf] — 36L d4096 32H kv8 head_dim 128 d_ff 12288
vocab 151936.
"""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="qwen3-8b", family="dense", n_layers=36,
        d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128, d_ff=12_288,
        vocab=151_936, period=("attn",), qk_norm=True,
        rope_theta=1_000_000.0)


def reduced() -> ArchConfig:
    return ArchConfig(
        name="qwen3-8b-reduced", family="dense", n_layers=2,
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
        vocab=256, period=("attn",), qk_norm=True,
        rope_theta=1_000_000.0, remat="none")


register("qwen3-8b", full, reduced)
