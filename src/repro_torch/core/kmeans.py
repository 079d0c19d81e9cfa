"""k-means (Lloyd) primitives on tensors — the port of ``repro.core.kmeans``.

The assignment pass always goes through the ``kmeans_assign`` op: the
CUDA kernel for a tensor on the card, its plain PyTorch version for a
tensor on the CPU.  Seeding draws from an explicit ``torch.Generator``;
it follows the reference's algorithm but cannot reproduce JAX's draws.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.kmeans_assign import ops as _kops
from repro_torch.kernels.layout import chunk_points


def assign_and_stats(x, centroids, mask=None):
    """Fused assignment pass through the op.

    Returns (labels [N] int32, sums [K,D] f32, counts [K] f32, j []).
    ``mask``: [N] f32 row weights (weight-0 rows are labelled -1).
    """
    return _kops.kmeans_assign(x, centroids, mask=mask)


def update_centroids(centroids, sums, counts):
    """New centroid = mean of members; empty clusters keep their old one."""
    new = sums / torch.clamp_min(counts, 1.0)[:, None]
    return torch.where(counts[:, None] > 0, new, centroids)


def kmeans_step(x, centroids):
    """One Lloyd iteration. Returns (new_centroids, labels, j)."""
    labels, sums, counts, j = assign_and_stats(x, centroids)
    return update_centroids(centroids, sums, counts), labels, j


def random_init(x, k: int, *, generator: torch.Generator):
    """k distinct data points chosen uniformly."""
    idx = torch.randperm(x.shape[0], generator=generator,
                         device=generator.device)[:k].to(x.device)
    return x[idx].to(torch.float32)


def _min_d2_scan(xc, mask, c, d2):
    """d2 ← min(d2, ‖x − c‖²) chunk by chunk ([C, P] in, [C, P] out).

    Padded rows stay at 0 so they carry no sampling mass; the [P, D]
    difference exists for one chunk at a time.
    """
    out = torch.empty_like(d2)
    for i in range(xc.shape[0]):
        diff = xc[i] - c[None, :]
        nd = torch.minimum(d2[i], torch.sum(diff * diff, dim=-1))
        out[i] = torch.where(mask[i] > 0, nd, 0.0)
    return out


def _draw(weights, fallback, generator):
    """One index ∝ ``weights``; uniform over ``fallback`` > 0 when all the
    mass is zero (every remaining row duplicates a centre)."""
    p = torch.where(torch.sum(weights) > 0, weights, fallback)
    return torch.multinomial(p, 1, generator=generator)[0]


def kmeans_plus_plus_init(x, k: int, *, generator: torch.Generator,
                          chunks: int = 1):
    """k-means++ seeding (D² sampling), streamed over ``chunks`` pieces.

    The reference's algorithm (``repro.core.kmeans.kmeans_plus_plus_init``):
    the running min-distance table lives as [C, P] beside the [C, P, D]
    chunk layout, and each of the k−1 D² draws picks a chunk ∝ its d² mass,
    then a row within it ∝ d² — the exact factorisation of the flat
    categorical, so the distribution does not depend on the chunking.
    ``generator`` must live on ``x``'s device.
    """
    x = x.to(torch.float32)
    n = x.shape[0]
    xc, mask = chunk_points(x, chunks)
    per = mask.shape[1]
    flat = torch.randint(0, n, (), generator=generator, device=x.device)
    first = xc[flat // per, flat % per]
    centroids = torch.zeros((k, x.shape[1]), dtype=torch.float32,
                            device=x.device)
    centroids[0] = first
    d2 = _min_d2_scan(xc, mask, first,
                      torch.where(mask > 0, torch.inf, 0.0))
    for i in range(1, k):
        ci = _draw(torch.sum(d2, dim=1), torch.sum(mask, dim=1), generator)
        ri = _draw(d2[ci], mask[ci], generator)
        c = xc[ci, ri]
        centroids[i] = c
        d2 = _min_d2_scan(xc, mask, c, d2)
    return centroids
