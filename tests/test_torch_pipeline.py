"""The port's slice as a whole — harvest, Eq. 8 fit, early-stopped and
full-convergence production fits, achieved accuracy — against the
reference pipeline (``repro.launch.cluster``) on the same groups.

The reference runs with ``use_kernel=True, kernel_backend="xla"``: each
sweep then goes through its pure-jnp op contract, the route the port's
plain versions take on the CPU.  JAX's random draws cannot be reproduced
in torch, so the port is fed the reference's initial parameters: the
harvest seeds of ``longtail_train._group_init`` and the production seeds
of ``run_production`` (k-means++ from ``PRNGKey(100 + gi)``).

EM cases cap ``max_iters`` below the point where the fp32 log-likelihood
stalls: past it, the reference's exact-equality stops (the EM harvest's
h ≤ 1e-12, the full run's h ≤ 0) fire on last-bit noise that no two
summation orders share.
"""
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import em_gmm as jem
from repro.core import kmeans as jkm
from repro.core import longtail_train as jlt
from repro.core.engine import ClusteringEngine as JEngine
from repro.core.engine import EngineConfig as JConfig
from repro.core.longtail_train import _group_init
from repro.core.rand_index import rand_index as jrand
from repro.core.sampling import random_groups
from repro.data import load, spacenet_pixels
from repro.launch import cluster as jcluster
from repro_torch.core import kmeans as pkm
from repro_torch.core.convert import params_from_numpy
from repro_torch.launch import cluster

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _to_port(algorithm, params):
    arrays = (np.asarray(params) if algorithm == "kmeans"
              else tuple(np.asarray(a) for a in params))
    return params_from_numpy(algorithm, arrays, "cpu")


def _reference(train_g, prod_g, algorithm, k, chunks, max_iters):
    """The reference CLI's main loop, on the xla op route."""
    prod = JConfig(max_iters=max_iters, chunks=chunks, use_kernel=True,
                   kernel_backend="xla",
                   stop_when_frozen=(algorithm == "kmeans"))
    model, _ = jcluster.train_regression(
        train_g, k, algorithm, max_iters=max_iters, family="quadratic",
        train_mode="full", production_config=prod)
    h_star = model.threshold_for(0.99)
    es, fu, acc = [], [], []
    for gi, g in enumerate(prod_g):
        kw = dict(seed=100 + gi, use_kernel=True, kernel_backend="xla",
                  chunks=chunks)
        lab, _, it1, _ = jcluster.run_production(
            g, k, algorithm, h_star, max_iters=max_iters, model=model,
            desired_accuracy=0.99, **kw)
        lab_f, _, it2, _ = jcluster.run_production(
            g, k, algorithm, 0.0, max_iters=max_iters * 3, **kw)
        es.append(it1)
        fu.append(it2)
        acc.append(float(jrand(lab, lab_f, k, k)))
    return h_star, es, fu, acc


def _reference_inits(train_g, prod_g, algorithm, k, chunks):
    """The initial parameters the reference draws: the harvest seeds
    groups from PRNGKey(gi) unchunked, production from PRNGKey(100 + gi)."""
    train = [_to_port(algorithm, _group_init(
        algorithm, jax.random.PRNGKey(gi), jnp.asarray(g), k, 1))
        for gi, g in enumerate(train_g)]
    prod = []
    for gi, g in enumerate(prod_g):
        x = jnp.asarray(g)
        c0 = jkm.kmeans_plus_plus_init(jax.random.PRNGKey(100 + gi), x, k,
                                       chunks=chunks)
        prod.append(_to_port(algorithm, c0 if algorithm == "kmeans"
                             else jem.init_from_kmeans(x, c0)))
    return train, prod


CASES = [
    # dataset, algorithm, k, chunks, max_iters, spacenet image shape
    ("skin", "kmeans", 3, 4, 60, None),
    ("skin", "em", 2, 4, 12, None),
    ("spacenet", "kmeans", 6, 1, 60, (40, 50, 3)),
    ("spacenet", "em", 6, 1, 12, (30, 40, 3)),
]


@pytest.mark.parametrize("dataset,algorithm,k,chunks,max_iters,shape", CASES)
def test_slice_reproduces_reference(dataset, algorithm, k, chunks, max_iters,
                                    shape):
    if dataset == "spacenet":
        groups = spacenet_pixels(n_images=4, k_true=k, shape=shape)
    else:
        groups = random_groups(load(dataset, n=8000), 2000, max_groups=4)
    train_g, prod_g = groups[:2], groups[2:]
    h_ref, es_ref, fu_ref, acc_ref = _reference(
        train_g, prod_g, algorithm, k, chunks, max_iters)
    train_i, prod_i = _reference_inits(train_g, prod_g, algorithm, k, chunks)
    out = cluster.run_pipeline(
        train_g, prod_g, k=k, algorithm=algorithm, desired_accuracy=0.99,
        max_iters=max_iters, chunks=chunks, train_inits=train_i,
        prod_inits=prod_i, device="cpu")
    assert out["h_star"] == pytest.approx(h_ref, rel=1e-3)
    assert out["iters_earlystop_per_group"] == es_ref
    assert out["iters_full_per_group"] == fu_ref
    np.testing.assert_allclose(out["accuracy_per_group"], acc_ref, atol=1e-6)
    assert out["device"] == "cpu"


def test_full_size_spacenet_kmeans_h_star_matches_reference():
    """The land-use case at full size (four 438x406x3 images, k = 6): with
    the port's own k-means++ seeds (drawn on the CPU from seeds 0..3), the
    reference harvest under the same inits fits the same Eq. 8 quadratic,
    and both put h* at the 1e-12 floor: the fit opens downward and is
    negative at r* = 0.99.  So a floored k-means h* at these sizes is the
    reference's behaviour on such traces, not a fault of the port."""
    k = 6
    groups = spacenet_pixels(n_images=4, k_true=k)
    inits = [pkm.kmeans_plus_plus_init(
        torch.as_tensor(g), k, generator=torch.Generator().manual_seed(gi))
        for gi, g in enumerate(groups)]
    plan = jlt.TrainingPlan(
        algorithm="kmeans", k=k, family="quadratic", max_iters=300,
        config=JConfig(max_iters=300, use_kernel=True, kernel_backend="xla"))
    cfg = jlt.harvest_config(plan.config, "kmeans", max_iters=300, seed=None)
    traces = []
    for g, p0 in zip(groups, inits):
        x = jnp.asarray(g)
        res = JEngine("kmeans", cfg).fit(x, jnp.asarray(p0.numpy()))
        traces.append(jlt.engine_trace_to_rh(res.trace, x, algorithm="kmeans",
                                             k=k))
    ref = jlt.fit_for_config(plan, groups, traces=traces)
    model, _ = cluster.train_regression(groups, k, "kmeans", max_iters=300,
                                        family="quadratic", inits=inits,
                                        device="cpu")
    assert model.threshold_for(0.99) == pytest.approx(
        ref.threshold_for(0.99), rel=1e-3)
    assert ref.threshold_for(0.99) == pytest.approx(1e-12)
    np.testing.assert_allclose(model.regression.coeffs,
                               ref.regression.coeffs, rtol=1e-2)


def test_cli_runs_on_cpu_and_refuses_later_flags(tmp_path, capsys):
    out_path, model_path = tmp_path / "rep.json", tmp_path / "model.json"
    out = cluster.main(["--device", "cpu", "--dataset", "skin", "--k", "2",
                        "--n", "3000", "--group-size", "1000",
                        "--train-groups", "2", "--prod-groups", "1",
                        "--max-iters", "30", "--chunks", "2",
                        "--out", str(out_path),
                        "--save-model", str(model_path)])
    assert out_path.exists() and model_path.exists()
    assert 0.0 <= out["achieved_accuracy"] <= 1.0
    assert out["iters_earlystop"] <= out["iters_full"]
    assert "cost-effectiveness (Eq.10)" in capsys.readouterr().out
    for flag in (["--restarts", "2"], ["--mode", "minibatch"], ["--shard"],
                 ["--prefetch"], ["--save-artifact", "a.json"],
                 ["--stats-compression", "int8_ef"]):
        with pytest.raises(SystemExit):
            cluster.main(["--device", "cpu", *flag])
        assert "ROADMAP.md" in capsys.readouterr().err


def test_cli_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cluster.run_production(np.zeros((10, 2), np.float32), 2, "kmeans",
                               0.0, max_iters=2)


_FORBIDDEN = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)"
                        r"(\.|\s))", re.M)


def test_port_imports_no_jax_and_nothing_of_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    bad = [str(f.relative_to(ROOT)) for f in files
           if _FORBIDDEN.search(f.read_text())]
    assert not bad, f"port modules importing jax or repro: {bad}"
