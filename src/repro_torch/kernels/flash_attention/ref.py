"""Plain PyTorch version of the flash-attention kernel.

``attention_ref`` repeats the reference oracle
(``repro.kernels.flash_attention.ref.attention_ref``) term by term: exact
softmax in fp32, GQA by repeating each kv head over its query heads, the
causal / sliding-window / bidirectional masks with a -1e30 fill, and the
output cast to q's dtype.  The op wrapper uses it for CPU tensors, and
``chip_smoke.py`` holds the CUDA kernel against it on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1.0e30


def attention_ref(q, k, v, *, causal: bool, window: int | None = None,
                  scale: float | None = None):
    """q [B,Hq,Sq,dh], k/v [B,Hkv,Skv,dh] → [B,Hq,Sq,dh]; exact softmax."""
    _, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if scale is None:
        scale = dh ** -0.5
    group = hq // hkv
    kk = k.repeat_interleave(group, dim=1)
    vv = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     kk.to(torch.float32)) * scale
    rows = torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal or window is not None:
        mask = rows >= cols
    if window is not None:
        mask = mask & (cols > rows - window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p,
                        vv.to(torch.float32)).to(q.dtype)
