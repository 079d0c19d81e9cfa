"""EM for diagonal-covariance Gaussian mixtures — the port of
``repro.core.em_gmm``.

The E-step goes through the ``gmm_estep`` op (the CUDA kernel on the card,
the plain PyTorch version on the CPU); ``log_prob`` keeps the reference's
matmul decomposition for callers that need the [N, K] densities.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels.gmm_estep import ops as _gops

_LOG2PI = 1.8378770664093453
VAR_FLOOR = 1e-6


class GMMParams(NamedTuple):
    means: torch.Tensor     # [K, D]
    var: torch.Tensor       # [K, D] diagonal covariance
    log_w: torch.Tensor     # [K] log mixture weights


def log_prob(x, params: GMMParams):
    """[N,K] per-component log densities via the matmul decomposition."""
    x = x.to(torch.float32)
    inv_var = 1.0 / params.var
    quad = ((x * x) @ inv_var.T
            - 2.0 * (x @ (params.means * inv_var).T)
            + torch.sum(params.means ** 2 * inv_var, dim=-1)[None, :])
    log_det = torch.sum(torch.log(params.var), dim=-1)
    d = x.shape[-1]
    return (params.log_w[None, :]
            - 0.5 * (quad + log_det[None, :] + d * _LOG2PI))


def estep_stats(x, params: GMMParams, mask=None):
    """Fused E-step through the op → (labels, loglik, r_sum, r_x, r_x2)."""
    return _gops.gmm_estep(x, params.means, params.var, params.log_w,
                           mask=mask)


def mstep(params: GMMParams, r_sum, r_x, r_x2, n_total) -> GMMParams:
    safe = torch.clamp_min(r_sum, 1e-10)[:, None]
    means = r_x / safe
    var = torch.clamp_min(r_x2 / safe - means ** 2, VAR_FLOOR)
    # components with no support keep their old parameters
    alive = (r_sum > 1e-8)[:, None]
    means = torch.where(alive, means, params.means)
    var = torch.where(alive, var, params.var)
    log_w = torch.log(torch.clamp_min(r_sum / n_total, 1e-20))
    return GMMParams(means=means, var=var, log_w=log_w)


def em_step(x, params: GMMParams, n_total=None):
    """One EM iteration. Returns (new_params, labels, loglik)."""
    labels, loglik, r_sum, r_x, r_x2 = estep_stats(x, params)
    if n_total is None:
        n_total = torch.tensor(float(x.shape[0]), dtype=torch.float32,
                               device=x.device)
    return mstep(params, r_sum, r_x, r_x2, n_total), labels, loglik


def init_from_kmeans(x, centroids) -> GMMParams:
    """Means from k-means; shared isotropic variance; uniform weights."""
    k = centroids.shape[0]
    x = x.to(torch.float32)
    # population variance (jnp.var), not torch's default correction=1
    global_var = torch.clamp_min(torch.var(x, dim=0, correction=0),
                                 VAR_FLOOR)
    return GMMParams(
        means=centroids.to(torch.float32),
        var=global_var.expand(k, x.shape[1]).contiguous(),
        log_w=torch.full((k,), -math.log(k), dtype=torch.float32,
                         device=x.device),
    )


def random_init(x, k: int, *, generator: torch.Generator) -> GMMParams:
    from .kmeans import random_init as km_random
    return init_from_kmeans(x, km_random(x, k, generator=generator))
