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


def lm_params_from_numpy(cfg, tree, device):
    """The reference's dense-decoder params (nested dicts of arrays) → a
    ``Transformer`` on ``device``, each leaf stored in the module's dtype
    (``cfg.act_dtype``; RMSNorm scales float32)."""
    from repro_torch.models.transformer import Transformer
    model = Transformer(cfg, torch.device(device))
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":
            node = tree["blocks"]["pos0"]
            for key in parts[2:]:
                node = node[key]
            node = node[int(parts[1])]
        else:
            node = tree
            for key in parts:
                node = node[key]
        with torch.no_grad():
            p.copy_(torch.from_numpy(np.array(node, np.float32)))
    return model.eval()


def lm_params_to_numpy(model):
    """A ``Transformer``'s weights → the reference's pytree of float32
    arrays (block leaves stacked over layers under ``blocks/pos0``)."""
    tree: dict = {}
    per_layer: dict = {}
    for name, p in model.named_parameters():
        arr = p.detach().to(torch.float32).cpu().numpy()
        parts = name.split(".")
        if parts[0] == "blocks":
            per_layer.setdefault(tuple(parts[2:]), []).append(arr)
            continue
        node = tree
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = arr
    for path, arrs in per_layer.items():
        node = tree.setdefault("blocks", {}).setdefault("pos0", {})
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack(arrs)
    return tree
