"""The port's LM serving path (``repro_torch.serving``,
``repro_torch.launch.serve``) against the reference's ``Server``.

On the same weights (carried across with ``lm_params_from_numpy``) and
the same requests, at reduced size in float32, ``Server.generate`` must
give the reference's exact tokens: greedy for each dense decoder (and
for qwen3-8b with the reference's prefill on its Pallas kernel, in
interpret mode), and with a temperature from the same seed (numpy draws
in both packages).
Then the contracts of ``tests/test_serving.py``, ported: EOS stripped,
single-token requests, slot refill, admission errors, each held against
a greedy loop over the port's own full forward.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import init_lm as jinit
from repro.serving import Request as JRequest
from repro.serving import Server as JServer
from repro_torch.configs import get_config
from repro_torch.core.convert import lm_params_from_numpy
from repro_torch.kernels import dispatch
from repro_torch.launch import serve
from repro_torch.serving import Request, Server

torch.set_num_threads(2)


@functools.cache
def _pair(name):
    jc = dataclasses.replace(jget(name, reduced=True), dtype="float32")
    pc = dataclasses.replace(get_config(name, reduced=True), dtype="float32")
    params = jinit(jax.random.PRNGKey(0), jc)
    return jc, params, lm_params_from_numpy(
        pc, jax.tree.map(np.asarray, params), "cpu")


# five requests over two slots: slot refill, prompt lengths 3, 5 and 7
PROMPTS = [[3, 1, 4], [2, 7, 1, 8, 2], [5, 9, 2, 6, 5, 3, 5], [1, 1, 2],
           [9, 8, 7, 6, 5]]


def _both(name, temperature=0.0, max_new=(6, 4, 5, 1, 6)):
    jc, params, model = _pair(name)
    want = JServer(params, jc, n_slots=2, max_seq=32, seed=5).generate(
        [JRequest(prompt=p, max_new_tokens=n, temperature=temperature,
                  rid=i) for i, (p, n) in enumerate(zip(PROMPTS, max_new))])
    got = Server(model, n_slots=2, max_seq=32, seed=5).generate(
        [Request(prompt=p, max_new_tokens=n, temperature=temperature, rid=i)
         for i, (p, n) in enumerate(zip(PROMPTS, max_new))])
    return got, want


@pytest.mark.parametrize("name", ["qwen3-8b", "qwen2-7b", "mistral-nemo-12b"])
def test_greedy_tokens_match_reference_server(name):
    dispatch.reset_launches()
    got, want = _both(name)
    assert got == want
    assert [len(got[i]) for i in range(5)] == [6, 4, 5, 1, 6]
    assert dispatch.LAUNCHES["flash_attention"] == 0     # CPU: plain path


def test_greedy_tokens_match_reference_server_on_its_pallas_kernel():
    """The reference with ``use_flash_kernel``: its prefill then reaches
    the Pallas kernel (interpret mode on the CPU)."""
    jc, params, model = _pair("qwen3-8b")
    jc = dataclasses.replace(jc, use_flash_kernel=True)
    reqs = [(p, n) for p, n in zip(PROMPTS, (6, 4, 5, 1, 6))]
    want = JServer(params, jc, n_slots=2, max_seq=32).generate(
        [JRequest(prompt=p, max_new_tokens=n, rid=i)
         for i, (p, n) in enumerate(reqs)])
    got = Server(model, n_slots=2, max_seq=32).generate(
        [Request(prompt=p, max_new_tokens=n, rid=i)
         for i, (p, n) in enumerate(reqs)])
    assert got == want


def test_temperature_tokens_match_reference_server():
    got, want = _both("qwen3-8b", temperature=0.8)
    assert got == want


@pytest.fixture(scope="module")
def model():
    _, _, m = _pair("mistral-nemo-12b")
    return m


def _greedy_reference(model, prompt, n_new):
    """Autoregressive reference via the port's full forward each step."""
    toks, out = list(prompt), []
    with torch.inference_mode():
        for _ in range(n_new):
            logits = model.forward(torch.tensor([toks]))
            out.append(int(torch.argmax(logits[0, -1])))
            toks.append(out[-1])
    return out


def test_server_matches_full_forward_and_refills_slots(model):
    srv = Server(model, n_slots=2, max_seq=64)
    reqs = [Request(prompt=[i + 1, i + 2], max_new_tokens=3 + i % 3, rid=i)
            for i in range(5)]
    out = srv.generate(reqs)
    assert set(out) == set(range(5))
    for i in range(5):
        assert out[i] == _greedy_reference(model, [i + 1, i + 2], 3 + i % 3)


def test_eos_stops_generation_and_is_stripped(model):
    out = Server(model, n_slots=1, max_seq=64).generate(
        [Request(prompt=[1, 2], max_new_tokens=4, rid=0)])
    eos = out[0][1]
    out2 = Server(model, n_slots=1, max_seq=64, eos_id=eos).generate(
        [Request(prompt=[1, 2], max_new_tokens=4, rid=0)])
    assert out2[0] == out[0][:out[0].index(eos)]
    assert eos not in out2[0]


def test_single_token_request_returns_one_token(model):
    out = Server(model, n_slots=1, max_seq=64).generate(
        [Request(prompt=[1, 2, 3], max_new_tokens=1, rid=0)])
    assert out[0] == _greedy_reference(model, [1, 2, 3], 1)


def test_generation_stops_before_the_cache_is_full(model):
    out = Server(model, n_slots=1, max_seq=8).generate(
        [Request(prompt=[1, 2, 3], max_new_tokens=20, rid=0)])
    # positions 3..6 decode; pos reaching max_seq - 1 ends the request
    assert len(out[0]) == 5
    assert out[0] == _greedy_reference(model, [1, 2, 3], 5)


def test_admission_rejects_oversized_and_empty_prompts(model):
    srv = Server(model, n_slots=1, max_seq=8)
    with pytest.raises(ValueError, match="max_seq"):
        srv.generate([Request(prompt=list(range(8)), rid=7)])
    with pytest.raises(ValueError, match="empty prompt"):
        srv.generate([Request(prompt=[], rid=8)])
    with pytest.raises(ValueError, match="max_new_tokens"):
        srv.generate([Request(prompt=[1], max_new_tokens=0, rid=9)])
    with pytest.raises(ValueError, match="request 11"):
        srv.generate([Request(prompt=[1, 2], rid=10),
                      Request(prompt=list(range(99)), rid=11)])


def test_cli_runs_on_cpu(capsys):
    out = serve.main(["--device", "cpu", "--requests", "3", "--slots", "2",
                      "--max-new", "4", "--max-seq", "32"])
    assert sorted(out) == [0, 1, 2]
    assert all(len(v) == 4 for v in out.values())
    assert "3 requests, 12 tokens" in capsys.readouterr().out


def test_cli_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--requests", "1"])
