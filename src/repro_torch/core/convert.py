"""Carry parameters and fitted models across between the reference (JAX,
as numpy arrays) and the port (tensors).

``params_from_numpy`` turns reference centroids [K, D] or a reference
``GMMParams`` (means, var, log_w) into the port's; ``params_to_numpy`` goes
the other way (a GMM comes back as a (means, var, log_w) tuple of arrays,
which the reference's ``GMMParams(*arrays)`` takes).  Fitted models
cross as JSON: ``LongTailModel.from_json`` reads either package's files.
"""
from __future__ import annotations

import numpy as np
import torch

from .em_gmm import GMMParams


def params_from_numpy(algorithm: str, arrays, device):
    """Reference parameters (numpy or array-likes) → the port's tensors."""
    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    if algorithm == "kmeans":
        return t(arrays)
    if algorithm == "em":
        means, var, log_w = arrays
        return GMMParams(t(means), t(var), t(log_w))
    raise ValueError(f"unknown algorithm {algorithm!r}")


def params_to_numpy(params):
    """The port's parameters → numpy (a tuple of three arrays for a GMM)."""
    if isinstance(params, GMMParams):
        return tuple(p.detach().cpu().numpy() for p in params)
    return params.detach().cpu().numpy()

