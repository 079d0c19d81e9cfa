"""Qwen2-7B: dense decoder, GQA, QKV bias.

[arXiv:2407.10671; hf] — 28L d3584 28H kv4 head_dim 128 d_ff 18944
vocab 152064.
"""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="qwen2-7b", family="dense", n_layers=28,
        d_model=3584, n_heads=28, n_kv_heads=4, head_dim=128, d_ff=18_944,
        vocab=152_064, period=("attn",), qkv_bias=True,
        rope_theta=1_000_000.0)


def reduced() -> ArchConfig:
    return ArchConfig(
        name="qwen2-7b-reduced", family="dense", n_layers=2,
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
        vocab=256, period=("attn",), qkv_bias=True,
        rope_theta=1_000_000.0, remat="none")


register("qwen2-7b", full, reduced)
