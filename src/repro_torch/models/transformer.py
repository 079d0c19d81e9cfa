"""Model assembly for the dense decoders, ported (``repro.models.
transformer``).

The reference stacks each period position's parameters over periods and
runs them under ``lax.scan``; here a ``Transformer`` holds one
``Block`` per layer in an ``nn.ModuleList`` and loops over them.  Only
dense decoders (period ``("attn",)``, MLP in every layer) are ported; the
other layer kinds and families raise ``NotImplementedError``.
Serving only: no autograd, the weights carry ``requires_grad=False`` and
callers run under ``torch.inference_mode()``.

Entry points:
  init_lm(cfg, device=, generator=)          → Transformer (random weights)
  model.forward(tokens)                      → logits [B,S,V]
  model.prefill(tokens)                      → (logits, caches)
  model.decode_step(token, caches, pos)      → (logits [B,V], caches)
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.dispatch import resolve_device
from . import layers

# what the reference initialises as ones, zeros, and the residual
# projections whose normal draw is scaled by 1/sqrt(n_layers)
_ONES = ("scale", "q_scale", "k_scale")
_ZEROS = ("bq", "bk", "bv")
_RESIDUAL_OUT = ("wo", "w_down")


class Block(nn.Module):
    """One decoder layer: h + attn(h), then h + mlp(h)."""

    def __init__(self, cfg, device):
        super().__init__()
        self.attn = layers.Attention(cfg, device)
        self.mlp = layers.MLP(cfg, device)

    def forward(self, h, *, positions=None, cache=None, cache_pos=None):
        att, cache = self.attn(h, positions=positions, cache=cache,
                               cache_pos=cache_pos)
        h = h + att
        return h + self.mlp(h), cache


class Transformer(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        if (cfg.period != ("attn",) or cfg.moe is not None or cfg.d_ff <= 0
                or cfg.encoder_only or cfg.embeddings_input):
            raise NotImplementedError(
                f"{cfg.name}: the port runs dense decoders (attn + MLP "
                "layers); MoE, Mamba/xLSTM, sliding-window and cross "
                "attention, and the encoder-only and embedding-input "
                "families are not ported yet (ROADMAP.md §1 step 11)")
        self.cfg = cfg
        dt = cfg.act_dtype
        self.embed = layers._param((cfg.vocab, cfg.d_model), dt, device)
        self.blocks = nn.ModuleList(
            Block(cfg, device) for _ in range(cfg.n_layers))
        self.final_norm = layers.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        if not cfg.tie_embeddings:
            self.head = layers._param((cfg.d_model, cfg.vocab), dt, device)

    def _embed(self, tokens):
        return self.embed[tokens]

    def _unembed(self, h):
        h = self.final_norm(h)
        w = self.embed.T if self.cfg.tie_embeddings else self.head
        return h @ w

    def forward(self, tokens):
        """tokens [B,S] → logits [B,S,V] (causal, no cache)."""
        h = self._embed(tokens)
        for blk in self.blocks:
            h, _ = blk(h)
        return self._unembed(h)

    def prefill(self, tokens):
        """tokens [B,S] → (logits [B,S,V], caches): one {"k", "v"}
        [B,S,KVH,dh] per layer."""
        h = self._embed(tokens)
        caches = []
        for blk in self.blocks:
            h, c = blk(h)
            caches.append(c)
        return self._unembed(h), caches

    def decode_step(self, token, caches, pos):
        """One token per sequence: token [B,1] and the per-layer caches
        (``model_zoo.init_cache``), written in place at ``pos`` — an int
        shared by every row, or a [B] tensor of per-slot offsets, which is
        also each row's RoPE position.  Returns (logits [B,V], caches)."""
        h = self._embed(token)
        if not torch.is_tensor(pos) or pos.ndim == 0:
            pos = int(pos)
            positions = torch.tensor([pos], device=h.device)
        else:
            positions = pos[:, None]
        for blk, cache in zip(self.blocks, caches):
            h, _ = blk(h, positions=positions, cache=cache, cache_pos=pos)
        return self._unembed(h)[:, 0], caches


@torch.no_grad()
def init_lm(cfg, *, device=None, generator=None) -> Transformer:
    """A model with the reference's initial distributions (normal · 0.02,
    ``wo``/``w_down`` · 1/sqrt(n_layers), norm and qk-norm scales 1, biases
    0), drawn leaf by leaf in float32 on ``device`` (the card unless the
    caller passes ``"cpu"``) and stored cast, so the full width never
    passes through host memory.  ``generator`` must live on that device
    (default: seed 0)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    model = Transformer(cfg, dev)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _ONES:
            p.fill_(1.0)
        elif leaf in _ZEROS:
            p.zero_()
        else:
            std = 0.02
            if leaf in _RESIDUAL_OUT:
                std /= max(1, cfg.n_layers) ** 0.5
            draw = torch.randn(p.shape, generator=generator, device=dev,
                               dtype=torch.float32)
            p.copy_(draw.mul_(std))
            del draw
    return model.eval()
