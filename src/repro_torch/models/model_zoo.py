"""Zoo utilities, ported (``repro.models.model_zoo``): parameter counting
and KV-cache construction for the dense decoders."""
from __future__ import annotations

import torch

from .transformer import Transformer


def count_params(cfg) -> int:
    """Parameter count of the port's model, built on the meta device (no
    allocation, so a full-width config costs nothing)."""
    model = Transformer(cfg, torch.device("meta"))
    return sum(p.numel() for p in model.parameters())


def init_cache(cfg, batch: int, max_seq: int, device):
    """Zero-filled serving cache: per layer {"k", "v"} [B, Smax, KVH, dh] in
    ``cfg.act_dtype`` (the reference's [P, B, Smax, KVH, dh] stacks, one
    entry per layer)."""
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=cfg.act_dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.act_dtype, device=device)}
            for _ in range(cfg.n_layers)]
