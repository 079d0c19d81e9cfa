"""The port's dense decoders (``repro_torch.models``) against the
reference's (``repro.models``) on the same weights.

The reference's ``init_lm`` pytree is carried across with
``lm_params_from_numpy``; tokens come from numpy.  For reduced qwen3-8b
(qk-norm), qwen2-7b (QKV bias, given nonzero values here) and
mistral-nemo-12b (neither): ``forward``, ``prefill`` (logits and caches)
and ``decode_step`` at a shared and at per-slot positions.  Each output
is held to TOL · max(1, max |reference|): in float32 1e-4 (sums in
another order; the logits are of order 1).  In bfloat16 the two packages
round at different points (rsqrt, silu, the softmax's cast), so values
may differ by a few bf16 ulps (2^-8 relative): 2e-2 there.  Prefill
attention takes the flash op's plain version on the CPU; the reference's
default route is its pure-jnp ``_sdpa``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import decode_step as jdecode
from repro.models import init_cache as jinit_cache
from repro.models import init_lm as jinit
from repro.models import prefill as jprefill
from repro.models.model_zoo import count_params as jcount
from repro.models.transformer import forward as jforward
from repro_torch.configs import get_config, list_archs
from repro_torch.core.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.models import count_params, init_cache, init_lm
from repro_torch.models.transformer import Transformer

torch.set_num_threads(2)

ARCHS = ["qwen3-8b", "qwen2-7b", "mistral-nemo-12b"]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@functools.cache
def _pair(name, dtype="float32", seed=0):
    """(reference cfg, params; port cfg, model) with the same weights,
    built once per arguments (no test mutates them)."""
    jc = dataclasses.replace(jget(name, reduced=True), dtype=dtype)
    pc = dataclasses.replace(get_config(name, reduced=True), dtype=dtype)
    params = jinit(jax.random.PRNGKey(seed), jc)
    if jc.qkv_bias:      # the reference starts biases at 0: exercise them
        rng = np.random.default_rng(seed)
        attn = params["blocks"]["pos0"]["attn"]
        for b in ("bq", "bk", "bv"):
            attn[b] = jnp.asarray(rng.normal(0, 0.1, attn[b].shape),
                                  jnp.float32)
    if jc.qk_norm:       # and the qk-norm scales at 1
        rng = np.random.default_rng(seed + 1)
        attn = params["blocks"]["pos0"]["attn"]
        for s in ("q_scale", "k_scale"):
            attn[s] = jnp.asarray(rng.uniform(0.5, 1.5, attn[s].shape),
                                  jnp.float32)
    tree = jax.tree.map(np.asarray, params)
    # what the port stores: the reference rounds these leaves at every use
    return jc, params, pc, lm_params_from_numpy(pc, tree, "cpu")


def _close(a, b, dtype):
    a = np.asarray(a.to(torch.float32) if torch.is_tensor(a) else a,
                   np.float32)
    b = np.asarray(b, np.float32)
    err = np.abs(a - b).max()
    assert err <= TOL[dtype] * max(1.0, np.abs(b).max()), err


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCHS)
def test_forward_matches_reference(name, dtype):
    jc, params, _, model = _pair(name, dtype)
    toks = _tokens(jc.vocab, (2, 13))
    want, _ = jforward(params, jc, tokens=jnp.asarray(toks))
    with torch.inference_mode():
        got = model.forward(torch.from_numpy(toks))
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCHS)
def test_prefill_logits_and_caches_match_reference(name, dtype):
    jc, params, _, model = _pair(name, dtype)
    toks = _tokens(jc.vocab, (2, 11), seed=1)
    want, jcaches = jprefill(params, jc, tokens=jnp.asarray(toks))
    with torch.inference_mode():
        got, caches = model.prefill(torch.from_numpy(toks))
    _close(got, want, dtype)
    assert len(caches) == jc.n_layers
    for layer, c in enumerate(caches):
        for kv in ("k", "v"):
            ref = np.asarray(jcaches["pos0"][kv][layer], np.float32)
            assert c[kv].shape == ref.shape
            _close(c[kv], ref, dtype)


@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCHS)
def test_decode_step_matches_reference(name, dtype, per_slot):
    """Prefill 10 tokens of 2 rows into a 16-row cache, then decode one
    token: at the shared position 10, or per slot at (10, 7) — row 1 then
    overwrites its cache row 7 and must not see rows 8 and 9."""
    jc, params, pc, model = _pair(name, dtype)
    b, s, smax = 2, 10, 16
    toks = _tokens(jc.vocab, (b, s + 1), seed=2)
    _, jpre = jprefill(params, jc, tokens=jnp.asarray(toks[:, :s]))
    jc_full = jax.tree.map(
        lambda d, src: jax.lax.dynamic_update_slice(
            d, src.astype(d.dtype), (0,) * src.ndim),
        jinit_cache(jc, b, smax), jpre)
    pos = np.array([s, 7]) if per_slot else s
    want, jnew = jdecode(params, jc, jnp.asarray(toks[:, s:]), jc_full,
                         jnp.asarray(pos, jnp.int32))
    with torch.inference_mode():
        _, pre = model.prefill(torch.from_numpy(toks[:, :s]))
        caches = init_cache(pc, b, smax, "cpu")
        for full, one in zip(caches, pre):
            full["k"][:, :s] = one["k"]
            full["v"][:, :s] = one["v"]
        tpos = torch.from_numpy(pos) if per_slot else s
        got, caches = model.decode_step(torch.from_numpy(toks[:, s:]),
                                        caches, tpos)
    assert got.shape == (b, jc.vocab)
    _close(got, want, dtype)
    for layer, c in enumerate(caches):
        _close(c["k"], jnew["pos0"]["k"][layer], dtype)
        _close(c["v"], jnew["pos0"]["v"][layer], dtype)


@pytest.mark.parametrize("name", ARCHS)
def test_params_round_trip_exactly(name):
    jc, params, pc, model = _pair(name)
    tree = lm_params_to_numpy(model)
    want = jax.tree.map(np.asarray, params)
    assert (jax.tree.structure(tree) == jax.tree.structure(want))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    again = lm_params_to_numpy(lm_params_from_numpy(pc, tree, "cpu"))
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_bf16_model_stores_act_dtype_but_f32_norm_scales():
    _, _, _, model = _pair("qwen3-8b", "bfloat16")
    for name, p in model.named_parameters():
        want = (torch.float32 if name.endswith("norm.scale")
                else torch.bfloat16)
        assert p.dtype == want, name


@pytest.mark.parametrize("name", ARCHS)
def test_count_params_matches_reference_at_full_width(name):
    assert count_params(get_config(name)) == jcount(jget(name))
    assert get_config(name).param_count() == count_params(get_config(name))


def test_qwen3_8b_full_width_parameter_count():
    assert count_params(get_config("qwen3-8b")) == 8_190_735_360


def test_registry_serves_dense_decoders_and_refuses_the_rest():
    assert list_archs() == sorted(ARCHS)
    for name in ("gemma3-12b", "qwen3-moe-30b-a3b", "xlstm-350m",
                 "hubert-xlarge", "jamba-v0.1-52b", "llama-3.2-vision-11b",
                 "llama4-scout-17b-a16e"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            get_config(name)
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Transformer(dataclasses.replace(get_config("qwen3-8b", reduced=True),
                                        period=("mamba",)), "meta")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Transformer(dataclasses.replace(get_config("qwen3-8b", reduced=True),
                                        period=("attn_local",)), "meta")


def test_init_lm_draws_the_reference_distributions_on_the_device():
    cfg = dataclasses.replace(get_config("qwen2-7b", reduced=True),
                              n_layers=4, d_model=128, d_ff=256)
    model = init_lm(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(3))
    params = dict(model.named_parameters())
    assert all(p.device.type == "cpu" for p in params.values())
    assert torch.all(params["blocks.0.attn.norm.scale"] == 1)
    assert torch.all(params["blocks.1.attn.bq"] == 0)
    emb = params["embed"].to(torch.float32)
    assert abs(float(emb.std()) - 0.02) < 1e-3
    wo = params["blocks.2.attn.wo"].to(torch.float32)
    assert abs(float(wo.std()) - 0.02 / 2) < 1e-3     # 1/sqrt(4 layers)
    again = init_lm(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(3))
    assert torch.equal(again.embed, model.embed)


def test_init_lm_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_lm(get_config("qwen3-8b", reduced=True))
