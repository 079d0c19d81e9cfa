"""Plain PyTorch version of the fused k-means assignment kernel.

``kmeans_assign_masked_ref`` repeats the reference oracle
(``repro.kernels.kmeans_assign.ref.kmeans_assign_masked_ref``) term by
term.  The op wrapper uses it for CPU tensors, and ``chip_smoke.py``
holds the CUDA kernel against it on the card.
"""
from __future__ import annotations

import torch


def kmeans_assign_masked_ref(x, w, centroids):
    """(labels [N] i32, sums [K,D] f32, counts [K] f32, j [] f32).

    ``w`` are f32 row weights; weight-0 rows are labelled -1 and carry no
    statistics.
    """
    x = x.to(torch.float32)
    c = centroids.to(torch.float32)
    w = w.to(torch.float32)
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    c2 = torch.sum(c * c, dim=-1)
    d2 = x2 - 2.0 * (x @ c.T) + c2[None, :]
    labels = torch.argmin(d2, dim=-1)
    mind2 = torch.clamp_min(torch.min(d2, dim=-1).values, 0.0)
    j = torch.sum(mind2 * w)
    k = c.shape[0]
    sums = torch.zeros_like(c).index_add_(0, labels, x * w[:, None])
    counts = torch.zeros((k,), dtype=torch.float32,
                         device=x.device).index_add_(0, labels, w)
    labels = torch.where(w > 0, labels, -1).to(torch.int32)
    return labels, sums, counts, j


def kmeans_assign_plain(x3, w2, c):
    """The op's contract on the restart-axis views (``layout.
    restart_operands``): one plain pass per restart, stacked.  ``w2`` None
    weighs every row 1."""
    if w2 is None:
        w2 = torch.ones(x3.shape[:2], dtype=torch.float32, device=x3.device)
    if c.ndim == 2:
        return kmeans_assign_masked_ref(x3[0], w2[0], c)
    outs = [kmeans_assign_masked_ref(x3[min(i, x3.shape[0] - 1)],
                                     w2[min(i, w2.shape[0] - 1)], c[i])
            for i in range(c.shape[0])]
    return tuple(torch.stack(t) for t in zip(*outs))
