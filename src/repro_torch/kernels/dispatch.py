"""Device resolution and per-op launch counters.

A kernel op takes its plain PyTorch version for a tensor on the CPU and
launches its CUDA kernel for a tensor on the card; there is no other
backend and no fallback between the two.  ``LAUNCHES`` counts kernel
launches per op (a wrapper adds one exactly where it launches), so a run
can show that its main path went through the kernels.
"""
from __future__ import annotations

import torch

LAUNCHES: dict[str, int] = {"kmeans_assign": 0, "gmm_estep": 0,
                            "flash_attention": 0}


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: raise when CUDA is missing rather than run
    on the CPU.  Pass ``"cpu"`` explicitly for a CPU run."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default, but "
                "torch.cuda.is_available() is False; pass device='cpu' "
                "(CLI: --device cpu) to run the plain PyTorch path")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def count_launch(op: str) -> None:
    LAUNCHES[op] += 1


def reset_launches() -> None:
    for op in LAUNCHES:
        LAUNCHES[op] = 0
