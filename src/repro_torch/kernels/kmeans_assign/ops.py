"""The k-means assignment op: plain PyTorch on a CPU tensor, the CUDA
kernel (``csrc/kmeans_assign.cu``) on a CUDA tensor.

Contract (that of ``repro.kernels.kmeans_assign.ops.kmeans_assign``):
x [N, D] | [R, N, D], centroids [K, D] | [R, K, D], mask [N] | [R, N]
f32 row weights (0 drops a row and labels it -1; None weighs every row
1).  Returns (labels i32, sums [K, D], counts [K], j []), with a leading R
iff the centroids carry one.
"""
from __future__ import annotations

import torch

from .. import build, dispatch, layout
from .ref import kmeans_assign_plain

OP = "kmeans_assign"


def _cuda(x3, w2, c3):
    lib = build.load(OP)
    r, k, d = c3.shape
    n = x3.shape[1]
    layout.check_rows_contiguous(x3, w2, OP)
    c3 = c3.contiguous()
    s = -(-n // build.tile_rows(OP))
    labels = torch.empty((r, n), dtype=torch.int32, device=x3.device)
    partials = torch.empty((r, s, k * d + k + 1), dtype=torch.float32,
                           device=x3.device)
    status = lib.kmeans_assign_launch(
        x3.data_ptr(), layout.restart_stride(x3),
        None if w2 is None else w2.data_ptr(), layout.restart_stride(w2),
        c3.data_ptr(), labels.data_ptr(), partials.data_ptr(), r, n, d, k,
        torch.cuda.current_stream(x3.device).cuda_stream)
    build.check(status, f"{OP} (R={r}, N={n}, D={d}, K={k})")
    dispatch.count_launch(OP)
    red = torch.sum(partials, dim=1)        # fixed-order split reduction
    sums = red[:, : k * d].reshape(r, k, d)
    return labels, sums, red[:, k * d: k * d + k], red[:, -1]


def kmeans_assign(x, centroids, *, mask=None):
    """Fused assignment: (labels, sums, counts, j) — see the module header.
    Without a mask every row weighs 1 and the kernel reads no weights."""
    if centroids.dtype != torch.float32:
        raise TypeError(f"{OP}: centroids must be float32")
    if centroids.ndim not in (2, 3) or centroids.shape[-1] != x.shape[-1]:
        raise ValueError(f"{OP}: centroids {tuple(centroids.shape)} do not "
                         f"match x {tuple(x.shape)}")
    if centroids.device != x.device:
        raise ValueError(f"{OP}: x on {x.device}, centroids on "
                         f"{centroids.device}")
    batched = centroids.ndim == 3
    r = centroids.shape[0] if batched else 1
    x3, w2 = layout.restart_operands(x, mask, r, batched, OP)
    if x.device.type == "cpu":
        return kmeans_assign_plain(x3, w2, centroids)
    if x.device.type != "cuda":
        raise ValueError(f"{OP}: unsupported device {x.device}")
    out = _cuda(x3, w2, centroids if batched else centroids[None])
    return out if batched else tuple(t[0] for t in out)


def kmeans_assign_chunked(x, centroids, *, chunks: int = 1, mask=None):
    """Streaming entry point: the op per static row slice, statistics
    summed in slice order (``layout.chunked_sweep``)."""
    n = x.shape[-2]
    if chunks <= 1 or n <= 1:
        return kmeans_assign(x, centroids, mask=mask)

    def call(a, b):
        return kmeans_assign(
            x[..., a:b, :], centroids,
            mask=None if mask is None else mask[..., a:b])

    return layout.chunked_sweep(call, n, chunks)
