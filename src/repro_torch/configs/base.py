"""Architecture config schema + registry, ported.

``ArchConfig``, ``MoEConfig`` and ``MambaConfig`` carry every field of the
reference's (``repro.configs.base``), so a config reads the same in both
packages; ``act_dtype`` is a ``torch.dtype``.  The registry holds the
dense decoders this slice serves (qwen3-8b, qwen2-7b, mistral-nemo-12b);
the reference's other architectures raise ``NotImplementedError`` with
the ``ROADMAP.md`` step that ports what they need.

``use_flash_kernel`` is kept for parity and ignored: the port's attention
always goes through the ``flash_attention`` op (the CUDA kernel on the
card, its plain version on the CPU).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    shared_expert: bool = False
    # which period positions get MoE instead of dense MLP (None = all)
    period_mask: tuple[bool, ...] | None = None
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int                      # dense-MLP intermediate (0 = no FFN)
    vocab: int
    period: tuple[str, ...] = ("attn",)
    moe: MoEConfig | None = None
    mamba: MambaConfig | None = None
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rope_theta_global: float | None = None    # gemma3: 1M for global layers
    sliding_window: int | None = None
    encoder_only: bool = False
    cross_attn_tokens: int = 0     # vlm: image tokens fed to cross layers
    cross_norm_kv: bool = True
    embeddings_input: bool = False  # audio/vlm stub frontend: inputs are [B,S,D]
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    use_flash_kernel: bool = False  # ignored by the port (module header)
    xlstm_mlstm_proj: float = 2.0
    xlstm_slstm_proj: float = 4.0 / 3.0
    xlstm_chunk: int = 0
    windowed_local_cache: bool = True
    moe_dispatch_groups: int = 0
    # activation dtype for train/serve
    dtype: str = "bfloat16"
    remat: str = "period"          # "none" | "period"
    sub_quadratic: bool = False    # eligible for long_500k decode

    def __post_init__(self):
        if self.n_layers % len(self.period):
            raise ValueError(f"{self.name}: n_layers {self.n_layers} not a "
                             f"multiple of period {len(self.period)}")

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.period)

    @property
    def act_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def moe_at(self, period_pos: int) -> bool:
        if self.moe is None:
            return False
        if self.moe.period_mask is None:
            return True
        return self.moe.period_mask[period_pos]

    def has_ffn_at(self, period_pos: int) -> bool:
        kind = self.period[period_pos]
        if kind in ("mlstm", "slstm"):
            return False             # xLSTM FFN lives inside the block
        return self.d_ff > 0 or self.moe_at(period_pos)

    def param_count(self) -> int:
        """Exact parameter count from the port's module structure (built on
        the meta device: nothing is allocated)."""
        from repro_torch.models.model_zoo import count_params
        return count_params(self)


_REGISTRY: dict[str, Callable[[], ArchConfig]] = {}
_REDUCED: dict[str, Callable[[], ArchConfig]] = {}

# the reference's other architectures, and what of ROADMAP.md §1 step 11
# each still waits for
LATER = {
    "gemma3-12b": "sliding-window ring KV caches (attn_local)",
    "hubert-xlarge": "the encoder-only audio family",
    "jamba-v0.1-52b": "Mamba SSM layers and MoE",
    "llama-3.2-vision-11b": "VLM cross-attention",
    "llama4-scout-17b-a16e": "MoE layers",
    "qwen3-moe-30b-a3b": "MoE layers",
    "xlstm-350m": "xLSTM cells",
}


def register(name: str, full: Callable[[], ArchConfig],
             reduced: Callable[[], ArchConfig]):
    _REGISTRY[name] = full
    _REDUCED[name] = reduced


def get_config(name: str, reduced: bool = False) -> ArchConfig:
    _ensure_imported()
    if name in LATER:
        raise NotImplementedError(
            f"{name}: {LATER[name]} are not ported yet (ROADMAP.md §1 step "
            f"11); the port serves {sorted(_REGISTRY)}")
    table = _REDUCED if reduced else _REGISTRY
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; have {sorted(table)}")
    return table[name]()


def list_archs() -> list[str]:
    _ensure_imported()
    return sorted(_REGISTRY)


def _ensure_imported():
    from repro_torch.configs import archs  # noqa: F401  (registers on import)
