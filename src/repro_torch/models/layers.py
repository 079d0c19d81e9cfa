"""Core transformer layers of the dense decoders, ported (``repro.models.
layers``): RMSNorm, RoPE, GQA attention with qk-norm and QKV bias, and the
SwiGLU MLP.

The modules hold their weights in the reference's layouts (``x @ wq``,
``wq`` [d_model, Hq * dh]) and in ``cfg.act_dtype``, except the RMSNorm
scales, which stay float32 because ``rmsnorm`` multiplies in float32.  The
reference casts each weight to the activation dtype at every use, so
storing it cast gives the same bits.

Attention without a cache always calls the ``flash_attention`` op (the
CUDA kernel on the card, its plain version on the CPU), whatever
``cfg.use_flash_kernel`` says.  With a cache (decode) it takes the
reference's plain masked softmax over the whole cache, which the
reference also computes outside any kernel, and writes the new k/v into
the cache in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.flash_attention import flash_attention

NEG_INF = -1.0e30


def _param(shape, dtype, device):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def rmsnorm(x, scale, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def _head_rms(x, eps: float = 1e-6):
    """Per-head qk-norm without its scale, rounded back to x's dtype (the
    reference multiplies by the scale only after this rounding)."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float, device):
        super().__init__()
        self.eps = eps
        self.scale = _param((d,), torch.float32, device)

    def forward(self, x):
        return rmsnorm(x, self.scale, self.eps)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None):
    return theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                   device=device) / head_dim)


def apply_rope(x, positions, theta: float):
    """x [..., S, H, dh], positions [..., S] (broadcastable) → rotated x;
    halves, not interleaved pairs, rotated in float32."""
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, x.device)
    angles = positions[..., :, None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------

def _cache_attention(q, ck, cv, positions):
    """q [B,S,H,dh] at ``positions`` ([S] shared or [B,S] per slot) over the
    whole cache ck/cv [B,Smax,KVH,dh]: plain masked softmax in float32.
    Rows not yet written are excluded by the position mask rows >= cols."""
    b, sq, h, dh = q.shape
    skv, kvh = ck.shape[1], ck.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.to(torch.float32),
                          ck.to(torch.float32)) * dh ** -0.5
    cols = torch.arange(skv, device=q.device)
    if positions.ndim == 2:
        mask = (positions[:, :, None] >= cols)[:, None, None]
    else:
        mask = positions[:, None] >= cols
    probs = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", probs, cv.to(torch.float32))
    return o.reshape(b, sq, h, dh).to(q.dtype)


class Attention(nn.Module):
    """Pre-norm causal GQA self-attention of a decoder layer (kind
    ``attn``; the other kinds are not ported: ``transformer.Transformer``
    refuses them)."""

    def __init__(self, cfg, device):
        super().__init__()
        d, h, kvh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        dt = cfg.act_dtype
        self.cfg = cfg
        self.wq = _param((d, h * dh), dt, device)
        self.wk = _param((d, kvh * dh), dt, device)
        self.wv = _param((d, kvh * dh), dt, device)
        self.wo = _param((h * dh, d), dt, device)
        self.norm = RMSNorm(d, cfg.norm_eps, device)
        if cfg.qkv_bias:
            self.bq = _param((h * dh,), dt, device)
            self.bk = _param((kvh * dh,), dt, device)
            self.bv = _param((kvh * dh,), dt, device)
        if cfg.qk_norm:
            self.q_scale = _param((dh,), dt, device)
            self.k_scale = _param((dh,), dt, device)

    def project_qkv(self, xn, positions):
        cfg = self.cfg
        b, s, _ = xn.shape
        h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q, k, v = xn @ self.wq, xn @ self.wk, xn @ self.wv
        if cfg.qkv_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        q = q.reshape(b, s, h, dh)
        k = k.reshape(b, s, kvh, dh)
        v = v.reshape(b, s, kvh, dh)
        if cfg.qk_norm:
            q = _head_rms(q) * self.q_scale
            k = _head_rms(k) * self.k_scale
        if cfg.rope_theta > 0:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        return q, k, v

    def forward(self, x, *, positions=None, cache=None, cache_pos=None):
        """x [B,S,D] → (out [B,S,D], cache).

        Without a cache: causal attention over x through the flash op; the
        returned cache is this sequence's {"k", "v"} [B,S,KVH,dh] (what
        prefill keeps).  With a cache {"k", "v"} [B,Smax,KVH,dh]: the new
        k/v are written at ``cache_pos`` (an int, or a [B] tensor of
        per-slot offsets) in place, and q attends over the whole cache.
        """
        b, s, _ = x.shape
        xn = self.norm(x)
        if positions is None:
            positions = torch.arange(s, device=x.device)
        q, k, v = self.project_qkv(xn, positions)
        if cache is None:
            o = flash_attention(q.transpose(1, 2).contiguous(),
                                k.transpose(1, 2).contiguous(),
                                v.transpose(1, 2).contiguous(), causal=True)
            o = o.transpose(1, 2)
            cache = {"k": k, "v": v}
        else:
            ck, cv = cache["k"], cache["v"]
            if isinstance(cache_pos, int):
                ck[:, cache_pos:cache_pos + s] = k
                cv[:, cache_pos:cache_pos + s] = v
            else:
                rows = torch.arange(b, device=x.device)
                ck[rows, cache_pos] = k[:, 0].to(ck.dtype)
                cv[rows, cache_pos] = v[:, 0].to(cv.dtype)
            o = _cache_attention(q, ck.to(q.dtype), cv.to(q.dtype), positions)
        return o.reshape(b, s, -1) @ self.wo, cache


# --------------------------------------------------------------------------
# Dense MLP (SwiGLU)
# --------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        d, f, dt = cfg.d_model, cfg.d_ff, cfg.act_dtype
        self.w_gate = _param((d, f), dt, device)
        self.w_up = _param((d, f), dt, device)
        self.w_down = _param((f, d), dt, device)
        self.norm = RMSNorm(d, cfg.norm_eps, device)

    def forward(self, x):
        xn = self.norm(x)
        return (F.silu(xn @ self.w_gate) * (xn @ self.w_up)) @ self.w_down
