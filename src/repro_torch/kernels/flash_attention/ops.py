"""The flash-attention op: plain PyTorch on a CPU tensor, the CUDA kernel
(``csrc/flash_attention.cu``) on a CUDA tensor.

Contract (that of ``repro.kernels.flash_attention.ops.flash_attention``):
q [B, Hq, Sq, dh], k/v [B, Hkv, Skv, dh], f32 or bf16 (all three alike),
Hq a multiple of Hkv (query head h reads kv head h // (Hq / Hkv)), causal
(row >= col), sliding-window (row - window < col <= row, implies causal)
or bidirectional; returns o [B, Hq, Sq, dh] in q's dtype.  The kernel
takes the real Sq and Skv (no padding) and dh up to ``MAX_HEAD_DIM``; its
tile sizes are its own constants.
"""
from __future__ import annotations

import torch

from .. import build, dispatch
from .ref import attention_ref

OP = "flash_attention"
MAX_HEAD_DIM = 256     # the kernel's widest head (gemma3's 256 is the repo's)


def _check(q, k, v, window):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"{OP}: q [B,Hq,Sq,dh], k/v [B,Hkv,Skv,dh]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, sq, dh = q.shape
    bk, hkv, skv, dk = k.shape
    if bk != b or dk != dh or min(b, hq, hkv, sq, skv, dh) < 1:
        raise ValueError(f"{OP}: q {tuple(q.shape)} does not match k/v "
                         f"{tuple(k.shape)}")
    if hq % hkv:
        raise ValueError(f"{OP}: Hq = {hq} is not a multiple of Hkv = {hkv}")
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"{OP}: head_dim {dh} > {MAX_HEAD_DIM}, the widest "
                         f"the kernel takes (q {tuple(q.shape)})")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise TypeError(f"{OP}: q, k, v must all be float32 or all bfloat16; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (k.device == v.device == q.device):
        raise ValueError(f"{OP}: q on {q.device}, k on {k.device}, v on "
                         f"{v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{OP}: q, k and v must be contiguous")
    if window is not None and window < 1:
        raise ValueError(f"{OP}: window must be >= 1, got {window}")


def _cuda(q, k, v, causal, window, scale):
    lib = build.load(OP)
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    status = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, hq, hkv,
        sq, skv, dh, int(causal), -1 if window is None else int(window),
        float(scale), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(status, f"{OP} (B={b}, Hq={hq}, Hkv={hkv}, Sq={sq}, "
                        f"Skv={skv}, dh={dh})")
    dispatch.count_launch(OP)
    return o


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, scale: float | None = None):
    """GQA attention forward — see the module header.  ``scale`` defaults
    to dh ** -0.5."""
    _check(q, k, v, window)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"{OP}: unsupported device {q.device}")
    return _cuda(q, k, v, causal, window, scale)
