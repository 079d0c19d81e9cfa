"""The port's kernel ops (``repro_torch.kernels``) against the reference's.

On the CPU each op takes its plain PyTorch version, which must reproduce
the reference op under its ``xla`` backend (the pure-jnp contract) at the
shapes and tolerances of ``tests/test_kernels.py``.  The CUDA kernels
themselves run only on the card: ``chip_smoke.py`` holds them against the
same plain versions there.  Here the wrappers' checks, the layout helpers
and the build's refusal without ``nvcc`` are covered.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import layout as jlayout
from repro.kernels.gmm_estep import ops as jg
from repro.kernels.kmeans_assign import ops as jk
from repro_torch.kernels import build, dispatch, layout
from repro_torch.kernels.gmm_estep import gmm_estep, gmm_estep_chunked
from repro_torch.kernels.kmeans_assign import (kmeans_assign,
                                               kmeans_assign_chunked)

torch.set_num_threads(2)

KM_SHAPES = [(64, 2, 2), (1000, 4, 8), (1024, 3, 6), (777, 11, 10),
             (128, 130, 3), (2048, 4, 16), (31, 7, 5)]
EM_SHAPES = [(64, 2, 2), (1000, 4, 8), (777, 11, 10), (2048, 3, 6)]


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _km_close(a, b):
    """test_kernels.py's k-means tolerances: labels exact, sums rtol 2e-5 /
    atol 1e-2, counts exact, J rtol 2e-5."""
    np.testing.assert_array_equal(a[0].numpy(), np.asarray(b[0]))
    np.testing.assert_allclose(a[1].numpy(), np.asarray(b[1]), rtol=2e-5,
                               atol=1e-2)
    np.testing.assert_allclose(a[2].numpy(), np.asarray(b[2]), rtol=0)
    np.testing.assert_allclose(a[3].numpy(), np.asarray(b[3]), rtol=2e-5)


def _em_close(a, b):
    """test_gmm_estep_sweep's tolerances."""
    np.testing.assert_array_equal(a[0].numpy(), np.asarray(b[0]))
    np.testing.assert_allclose(a[1].numpy(), np.asarray(b[1]), rtol=1e-5)
    np.testing.assert_allclose(a[2].numpy(), np.asarray(b[2]), rtol=2e-4,
                               atol=2e-3)
    np.testing.assert_allclose(a[3].numpy(), np.asarray(b[3]), rtol=2e-4,
                               atol=2e-2)
    np.testing.assert_allclose(a[4].numpy(), np.asarray(b[4]), rtol=2e-4,
                               atol=2e-1)


def _em_params(rng, k, d, r=None):
    lead = () if r is None else (r,)
    mu = rng.normal(0, 3, lead + (k, d)).astype(np.float32)
    var = rng.uniform(0.5, 4, lead + (k, d)).astype(np.float32)
    lw = np.log(rng.dirichlet(np.ones(k), size=lead or None)).astype(
        np.float32)
    return mu, var, lw


@pytest.mark.parametrize("n,d,k", KM_SHAPES)
def test_kmeans_assign_matches_reference(n, d, k):
    rng = np.random.default_rng(n * 7 + d * 3 + k)
    x = rng.normal(0, 10, (n, d)).astype(np.float32)
    c = rng.normal(0, 10, (k, d)).astype(np.float32)
    _km_close(kmeans_assign(_t(x), _t(c)),
              jk.kmeans_assign(jnp.asarray(x), jnp.asarray(c),
                               backend="xla"))


@pytest.mark.parametrize("n,d,k", EM_SHAPES)
def test_gmm_estep_matches_reference(n, d, k):
    rng = np.random.default_rng(n * 5 + d * 11 + k)
    x = rng.normal(0, 3, (n, d)).astype(np.float32)
    mu, var, lw = _em_params(rng, k, d)
    got = gmm_estep(_t(x), _t(mu), _t(var), _t(lw))
    _em_close(got, jg.gmm_estep(*map(jnp.asarray, (x, mu, var, lw)),
                                backend="xla"))
    assert float(got[2].sum()) == pytest.approx(n, rel=1e-4)


@pytest.mark.parametrize("layout_", ["mask", "shared_r2", "per_restart_r2"])
def test_kmeans_assign_mask_and_restarts(layout_):
    rng = np.random.default_rng(3)
    n, d, k = 500, 5, 4
    m = (rng.random(n) > 0.3).astype(np.float32)
    if layout_ == "mask":
        x = rng.normal(0, 5, (n, d)).astype(np.float32)
        c = rng.normal(0, 5, (k, d)).astype(np.float32)
    elif layout_ == "shared_r2":
        x = rng.normal(0, 5, (n, d)).astype(np.float32)
        c = rng.normal(0, 5, (2, k, d)).astype(np.float32)
    else:
        x = rng.normal(0, 5, (2, n, d)).astype(np.float32)
        c = rng.normal(0, 5, (2, k, d)).astype(np.float32)
        m = (rng.random((2, n)) > 0.3).astype(np.float32)
    got = kmeans_assign(_t(x), _t(c), mask=_t(m))
    want = jk.kmeans_assign(jnp.asarray(x), jnp.asarray(c),
                            mask=jnp.asarray(m), backend="xla")
    _km_close(got, want)
    assert (got[0].numpy()[..., m == 0] == -1).all()


@pytest.mark.parametrize("layout_", ["mask", "shared_r2", "per_restart_r2"])
def test_gmm_estep_mask_and_restarts(layout_):
    rng = np.random.default_rng(4)
    n, d, k = 400, 3, 5
    m = (rng.random(n) > 0.3).astype(np.float32)
    if layout_ == "mask":
        x = rng.normal(0, 3, (n, d)).astype(np.float32)
        params = _em_params(rng, k, d)
    else:
        x = rng.normal(0, 3, ((2, n, d) if layout_ == "per_restart_r2"
                              else (n, d))).astype(np.float32)
        params = _em_params(rng, k, d, r=2)
    got = gmm_estep(_t(x), *map(_t, params), mask=_t(m))
    want = jg.gmm_estep(jnp.asarray(x), *map(jnp.asarray, params),
                        mask=jnp.asarray(m), backend="xla")
    _em_close(got, want)
    assert (got[0].numpy()[..., m == 0] == -1).all()


@pytest.mark.parametrize("chunks", [1, 3, 4])
def test_chunked_ops_match_reference_chunking(chunks):
    rng = np.random.default_rng(5)
    x = rng.normal(0, 5, (301, 4)).astype(np.float32)
    c = rng.normal(0, 5, (5, 4)).astype(np.float32)
    m = (rng.random(301) > 0.25).astype(np.float32)
    _km_close(kmeans_assign_chunked(_t(x), _t(c), chunks=chunks, mask=_t(m)),
              jk.kmeans_assign_chunked(jnp.asarray(x), jnp.asarray(c),
                                       chunks=chunks, mask=jnp.asarray(m),
                                       backend="xla"))
    mu, var, lw = _em_params(rng, 5, 4)
    _em_close(gmm_estep_chunked(_t(x), _t(mu), _t(var), _t(lw),
                                chunks=chunks, mask=_t(m)),
              jg.gmm_estep_chunked(*map(jnp.asarray, (x, mu, var, lw)),
                                   chunks=chunks, mask=jnp.asarray(m),
                                   backend="xla"))


@pytest.mark.parametrize("n,chunks", [(10, 1), (10, 3), (100, 7), (5, 9),
                                      (1025, 4)])
def test_layout_matches_reference(n, chunks):
    assert layout.chunk_bounds(n, chunks) == jlayout.chunk_bounds(n, chunks)
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    xc, mask = layout.chunk_points(_t(x), chunks)
    jxc, jmask = jlayout.chunk_points(jnp.asarray(x), chunks)
    np.testing.assert_array_equal(xc.numpy(), np.asarray(jxc))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert layout.round_up(n, 8) == jlayout.round_up(n, 8)


def test_wrappers_reject_bad_operands():
    x = torch.zeros(10, 3)
    c = torch.zeros(2, 3)
    with pytest.raises(TypeError):
        kmeans_assign(x.double(), c)
    with pytest.raises(ValueError):
        kmeans_assign(x, torch.zeros(2, 4))
    with pytest.raises(ValueError):
        kmeans_assign(x, c, mask=torch.ones(9))
    with pytest.raises(ValueError):       # restart axis 3 vs params R = 2
        kmeans_assign(torch.zeros(3, 10, 3), torch.zeros(2, 2, 3))
    with pytest.raises(ValueError):
        kmeans_assign(x.to("meta"), c.to("meta"))
    v = torch.ones(2, 3)
    with pytest.raises(ValueError):
        gmm_estep(x, c, v, torch.zeros(3))
    with pytest.raises(TypeError):
        gmm_estep(x, c, v.double(), torch.zeros(2))


@pytest.mark.parametrize("op", ["kmeans_assign", "gmm_estep"])
@pytest.mark.parametrize("restarts", [None, 2])
def test_no_mask_is_weight_one(op, restarts):
    """mask=None (the main path's sweeps, which pass the kernel no weight
    vector) gives bit for bit what an all-ones mask gives."""
    rng = np.random.default_rng(6)
    n, d, k = 300, 4, 3
    x = _t(rng.normal(0, 4, (n, d)).astype(np.float32))
    ones = torch.ones(n)
    if op == "kmeans_assign":
        lead = () if restarts is None else (restarts,)
        c = _t(rng.normal(0, 4, lead + (k, d)).astype(np.float32))
        got, want = kmeans_assign(x, c), kmeans_assign(x, c, mask=ones)
    else:
        params = tuple(map(_t, _em_params(rng, k, d, r=restarts)))
        got, want = gmm_estep(x, *params), gmm_estep(x, *params, mask=ones)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_kernel_sources_export_the_bound_entry_points():
    for name, fns in build.SIGNATURES.items():
        src = (build.CSRC / f"{name}.cu").read_text()
        assert 'extern "C"' in src
        for fn, (_, argtypes) in fns.items():
            m = re.search(rf"\b{fn}\(([^)]*)\)", src)
            assert m, fn
            assert len(m.group(1).split(",")) == len(argtypes), fn
        # the tile constant the wrapper sizes the partials by
        assert f'extern "C" const int {name}_tile_rows' in src
        # the note every kernel carries: what it replaces and its bound
        assert f"src/repro/kernels/{name}/kernel.py" in src
        assert "bounds it on this card" in src
    assert "--use_fast_math" not in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as cpp
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        build.check(1, "op")


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dispatch.resolve_device(None)
    with pytest.raises(RuntimeError):
        dispatch.resolve_device("cuda")
    assert dispatch.resolve_device("cpu").type == "cpu"


def test_cpu_ops_launch_nothing():
    dispatch.reset_launches()
    kmeans_assign(torch.zeros(8, 2), torch.zeros(2, 2))
    gmm_estep(torch.zeros(8, 2), torch.zeros(2, 2), torch.ones(2, 2),
              torch.zeros(2))
    assert dispatch.LAUNCHES == {"kmeans_assign": 0, "gmm_estep": 0}
