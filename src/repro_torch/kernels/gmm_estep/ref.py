"""Plain PyTorch version of the fused GMM E-step kernel.

``gmm_estep_masked_ref`` repeats the reference oracle
(``repro.kernels.gmm_estep.ref.gmm_estep_masked_ref``) term by term.  The
op wrapper uses it for CPU tensors, and ``chip_smoke.py`` holds the CUDA
kernel against it on the card.
"""
from __future__ import annotations

import torch

_LOG2PI = 1.8378770664093453


def gmm_estep_masked_ref(x, w, means, var, log_w):
    """(labels [N] i32, loglik [], r_sum [K], r_x [K,D], r_x2 [K,D]).

    ``w`` are f32 row weights; weight-0 rows are labelled -1 and carry no
    statistics.
    """
    x = x.to(torch.float32)
    w = w.to(torch.float32)
    inv_var = 1.0 / var
    quad = ((x * x) @ inv_var.T
            - 2.0 * (x @ (means * inv_var).T)
            + torch.sum(means ** 2 * inv_var, dim=-1)[None, :])
    log_det = torch.sum(torch.log(var), dim=-1)
    d = x.shape[-1]
    lp = log_w[None, :] - 0.5 * (quad + log_det[None, :] + d * _LOG2PI)
    lse = torch.logsumexp(lp, dim=-1)
    resp = torch.exp(lp - lse[:, None]) * w[:, None]
    labels = torch.argmax(lp, dim=-1)
    return (torch.where(w > 0, labels, -1).to(torch.int32),
            torch.sum(lse * w), torch.sum(resp, dim=0), resp.T @ x,
            resp.T @ (x * x))


def gmm_estep_plain(x3, w2, means, var, log_w):
    """The op's contract on the restart-axis views: one plain pass per
    restart, stacked.  ``w2`` None weighs every row 1."""
    if w2 is None:
        w2 = torch.ones(x3.shape[:2], dtype=torch.float32, device=x3.device)
    if means.ndim == 2:
        return gmm_estep_masked_ref(x3[0], w2[0], means, var, log_w)
    outs = [gmm_estep_masked_ref(x3[min(i, x3.shape[0] - 1)],
                                 w2[min(i, w2.shape[0] - 1)],
                                 means[i], var[i], log_w[i])
            for i in range(means.shape[0])]
    return tuple(torch.stack(t) for t in zip(*outs))
