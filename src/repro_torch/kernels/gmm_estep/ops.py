"""The GMM E-step op: plain PyTorch on a CPU tensor, the CUDA kernel
(``csrc/gmm_estep.cu``) on a CUDA tensor.

Contract (that of ``repro.kernels.gmm_estep.ops.gmm_estep``): x [N, D] |
[R, N, D], means/var [K, D] | [R, K, D], log_w [K] | [R, K], mask [N] |
[R, N] f32 row weights (0 drops a row and labels it -1; None weighs every
row 1).  Returns (labels i32, loglik [], r_sum [K], r_x [K, D],
r_x2 [K, D]), with a leading R iff the parameters carry one.
"""
from __future__ import annotations

import torch

from .. import build, dispatch, layout
from .ref import _LOG2PI, gmm_estep_plain

OP = "gmm_estep"


def _operands(means, var, log_w):
    """The kernel's (a, b, const) from (means, var, log_w), as the
    reference's ops.py computes them: a = 1/var, b = mean/var, const =
    log w - (sum mean^2/var + sum log var + D log 2pi) / 2."""
    d = means.shape[-1]
    inv_var = 1.0 / var
    b = means * inv_var
    const = log_w - 0.5 * (torch.sum(means ** 2 * inv_var, dim=-1)
                           + torch.sum(torch.log(var), dim=-1)
                           + d * _LOG2PI)
    return inv_var.contiguous(), b.contiguous(), const.contiguous()


def _cuda(x3, w2, means, var, log_w):
    lib = build.load(OP)
    r, k, d = means.shape
    n = x3.shape[1]
    layout.check_rows_contiguous(x3, w2, OP)
    a, b, const = _operands(means, var, log_w)
    s = -(-n // build.tile_rows(OP))
    kd = k * d
    labels = torch.empty((r, n), dtype=torch.int32, device=x3.device)
    partials = torch.empty((r, s, k + 2 * kd + 1), dtype=torch.float32,
                           device=x3.device)
    status = lib.gmm_estep_launch(
        x3.data_ptr(), layout.restart_stride(x3),
        None if w2 is None else w2.data_ptr(), layout.restart_stride(w2),
        a.data_ptr(), b.data_ptr(), const.data_ptr(), labels.data_ptr(),
        partials.data_ptr(), r, n, d, k,
        torch.cuda.current_stream(x3.device).cuda_stream)
    build.check(status, f"{OP} (R={r}, N={n}, D={d}, K={k})")
    dispatch.count_launch(OP)
    red = torch.sum(partials, dim=1)        # fixed-order split reduction
    return (labels, red[:, -1], red[:, :k],
            red[:, k: k + kd].reshape(r, k, d),
            red[:, k + kd: k + 2 * kd].reshape(r, k, d))


def gmm_estep(x, means, var, log_w, *, mask=None):
    """Fused E-step: (labels, loglik, r_sum, r_x, r_x2) — see the module
    header.  Without a mask every row weighs 1 and the kernel reads no
    weights."""
    params = (means, var, log_w)
    if any(p.dtype != torch.float32 for p in params):
        raise TypeError(f"{OP}: parameters must be float32")
    if any(p.device != x.device for p in params):
        raise ValueError(f"{OP}: parameters and x on different devices")
    batched = means.ndim == 3
    if (means.ndim not in (2, 3) or var.shape != means.shape
            or log_w.shape != means.shape[:-1]
            or means.shape[-1] != x.shape[-1]):
        raise ValueError(f"{OP}: means {tuple(means.shape)}, var "
                         f"{tuple(var.shape)}, log_w {tuple(log_w.shape)} "
                         f"do not match x {tuple(x.shape)}")
    r = means.shape[0] if batched else 1
    x3, w2 = layout.restart_operands(x, mask, r, batched, OP)
    if x.device.type == "cpu":
        return gmm_estep_plain(x3, w2, means, var, log_w)
    if x.device.type != "cuda":
        raise ValueError(f"{OP}: unsupported device {x.device}")
    if not batched:
        means, var, log_w = means[None], var[None], log_w[None]
    out = _cuda(x3, w2, means, var, log_w)
    return out if batched else tuple(t[0] for t in out)


def gmm_estep_chunked(x, means, var, log_w, *, chunks: int = 1, mask=None):
    """Streaming entry point: the op per static row slice, statistics
    summed in slice order (``layout.chunked_sweep``)."""
    n = x.shape[-2]
    if chunks <= 1 or n <= 1:
        return gmm_estep(x, means, var, log_w, mask=mask)

    def call(a, b):
        return gmm_estep(x[..., a:b, :], means, var, log_w,
                         mask=None if mask is None else mask[..., a:b])

    return layout.chunked_sweep(call, n, chunks)
