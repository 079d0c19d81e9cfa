"""Rand index between two partitions — the paper's accuracy metric (Eq. 5),
the port of ``repro.core.rand_index``.

Two paths, as in the reference, chosen by name instead of by tracing:

  · :func:`rand_index` — exact.  The contingency table is counted in int64
    and the C(n, 2) arithmetic runs in Python integers, so the result is
    exact at any N.  The CLI's achieved accuracy uses it.
  · :func:`rand_index_from_contingency_f32` — the same identity in float32
    on the table's device, what the reference computes under ``jit`` for
    the harvest's r_i.  Keeping it float32 keeps the harvested r_i (and so
    h*) on the reference's rounding.
"""
from __future__ import annotations

import numpy as np
import torch


def contingency_table(labels_a, labels_b, ka: int, kb: int) -> torch.Tensor:
    """[ka, kb] int64 counts of points with (label_a=i, label_b=j)."""
    a = torch.as_tensor(labels_a).to(torch.int64).reshape(-1)
    b = torch.as_tensor(labels_b).to(torch.int64).reshape(-1)
    flat = a * kb + b.to(a.device)
    return torch.bincount(flat, minlength=ka * kb).reshape(ka, kb)


def _comb2_int(x: int) -> int:
    return x * (x - 1) // 2


def rand_index_from_contingency(table) -> float:
    """Exact Rand from a contingency table via Python-int arithmetic (no
    float rounding until the final correctly-rounded division)."""
    t = np.asarray(torch.as_tensor(table).cpu(), np.int64)
    n = int(t.sum())
    total = _comb2_int(n)
    if total == 0:
        return 1.0      # single point (or empty) partition: identical
    n11 = sum(_comb2_int(int(v)) for v in t.ravel())
    same_a = sum(_comb2_int(int(v)) for v in t.sum(axis=1))
    same_b = sum(_comb2_int(int(v)) for v in t.sum(axis=0))
    n00 = total - same_a - same_b + n11
    return (n11 + n00) / total


def rand_index(labels_a, labels_b, ka: int, kb: int) -> float:
    """Exact Rand(P_a, P_b) for dense integer label vectors."""
    return rand_index_from_contingency(
        contingency_table(labels_a, labels_b, ka, kb))


def _comb2_f32(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    return x * (x - 1.0) / 2.0


def rand_index_from_contingency_f32(table: torch.Tensor) -> torch.Tensor:
    """Rand from a contingency table in float32 on its device — exact only
    while every pair count stays below 2^24, like the reference's traced
    path; used for regression-fit targets, never for certification."""
    table = table.to(torch.float32)
    total = _comb2_f32(torch.sum(table))
    n11 = torch.sum(_comb2_f32(table))
    same_a = torch.sum(_comb2_f32(torch.sum(table, dim=1)))
    same_b = torch.sum(_comb2_f32(torch.sum(table, dim=0)))
    n00 = total - same_a - same_b + n11
    return torch.where(total > 0,
                       (n11 + n00) / torch.clamp_min(total, 1.0),
                       torch.ones_like(total))
