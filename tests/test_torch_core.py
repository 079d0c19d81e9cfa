"""The port's core (``repro_torch.core``, ``repro_torch.data``) against the
reference's, on the same numpy inputs made from a seed.

Randomness is the one thing that cannot carry over (JAX's threefry draws
are not torch's), so the fits take the reference's initial parameters and
the port's own k-means++ seeding is tested on its algorithmic properties.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import em_gmm as jem
from repro.core import kmeans as jkm
from repro.core.rand_index import rand_index as jrand
from repro.core.rand_index import rand_index_pairwise_reference
from repro.core import regression as jreg
from repro.core import cost_model as jcost
from repro.core import sampling as jsamp
from repro.core.earlystop import LongTailModel as JModel
from repro.core.earlystop import change_rate as jchange
from repro.core.earlystop import fit_longtail as jfit
from repro.core.engine import ClusteringEngine as JEngine
from repro.core.engine import EngineConfig as JConfig
from repro.data import synthetic as jsyn
from repro_torch.core import convert, cost_model, em_gmm, kmeans
from repro_torch.core import regression, sampling
from repro_torch.core.earlystop import LongTailModel, change_rate, fit_longtail
from repro_torch.core.rand_index import (contingency_table, rand_index,
                                        rand_index_from_contingency_f32)
from repro_torch.core.engine import ClusteringEngine, EngineConfig
from repro_torch.core.longtail_train import TrainingPlan
from repro_torch.data import synthetic

torch.set_num_threads(2)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _blobs(n=600, d=3, k=4, seed=0, spread=1.5):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 6, (k, d))
    lab = rng.integers(0, k, n)
    return (centers[lab] + rng.normal(0, spread, (n, d))).astype(np.float32)


# --------------------------------------------------------------------------
# k-means / EM primitives
# --------------------------------------------------------------------------

def test_update_centroids_and_step_match_reference():
    x = _blobs()
    c = x[:4].copy()
    sums = np.random.default_rng(1).normal(0, 5, (4, 3)).astype(np.float32)
    counts = np.array([3.0, 0.0, 7.0, 1.0], np.float32)   # one empty
    np.testing.assert_array_equal(
        kmeans.update_centroids(_t(c), _t(sums), _t(counts)).numpy(),
        np.asarray(jkm.update_centroids(jnp.asarray(c), jnp.asarray(sums),
                                        jnp.asarray(counts))))
    got = kmeans.kmeans_step(_t(x), _t(c))
    want = jkm.kmeans_step(jnp.asarray(x), jnp.asarray(c))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=2e-5)


@pytest.mark.parametrize("chunks", [1, 3])
def test_kmeans_plus_plus_picks_distinct_data_rows(chunks):
    x = _blobs(n=300, d=3, k=6, seed=2)
    for seed in range(4):
        g = torch.Generator().manual_seed(seed)
        c = kmeans.kmeans_plus_plus_init(_t(x), 8, generator=g,
                                         chunks=chunks).numpy()
        rows = {tuple(r) for r in c}
        assert len(rows) == 8
        assert rows <= {tuple(r) for r in x}


def test_kmeans_plus_plus_d2_sampling_covers_separated_blobs():
    # five tight blobs 1000 σ apart: D² sampling puts one seed in each
    rng = np.random.default_rng(3)
    lab = np.repeat(np.arange(5), 100)
    x = (1000.0 * np.eye(5)[lab] + rng.normal(0, 1, (500, 5))).astype(
        np.float32)
    for seed in range(6):
        g = torch.Generator().manual_seed(seed)
        c = kmeans.kmeans_plus_plus_init(_t(x), 5, generator=g,
                                         chunks=2).numpy()
        assert set(np.argmax(c, axis=1)) == set(range(5))


def test_kmeans_plus_plus_with_fewer_distinct_rows_than_k():
    x = np.repeat(np.eye(3, dtype=np.float32), 10, axis=0)   # 3 distinct
    c = kmeans.kmeans_plus_plus_init(
        _t(x), 5, generator=torch.Generator().manual_seed(0)).numpy()
    assert {tuple(r) for r in c} == {tuple(r) for r in np.eye(3)}


def test_random_init_picks_distinct_rows():
    x = _blobs(n=50)
    c = kmeans.random_init(_t(x), 7, generator=torch.Generator().manual_seed(1))
    assert len({tuple(r) for r in c.numpy()}) == 7


def test_em_primitives_match_reference():
    x = _blobs(n=400, d=3, k=3, seed=4)
    c = x[[0, 50, 100]]
    gp = jem.init_from_kmeans(jnp.asarray(x), jnp.asarray(c))
    tp = em_gmm.init_from_kmeans(_t(x), _t(c))
    for a, b in zip(tp, gp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    np.testing.assert_allclose(em_gmm.log_prob(_t(x), tp).numpy(),
                               np.asarray(jem.log_prob(jnp.asarray(x), gp)),
                               rtol=1e-5, atol=1e-4)
    got = em_gmm.em_step(_t(x), tp)
    want = jem.em_step(jnp.asarray(x), gp)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-5)
    for a, b in zip(got[0], want[0]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=1e-5)
    # a component with no support keeps its parameters
    r_sum = np.array([5.0, 0.0, 3.0], np.float32)
    r_x = np.ones((3, 3), np.float32)
    r_x2 = np.full((3, 3), 4.0, np.float32)
    a = em_gmm.mstep(tp, _t(r_sum), _t(r_x), _t(r_x2), torch.tensor(8.0))
    b = jem.mstep(gp, *map(jnp.asarray, (r_sum, r_x, r_x2)), 8.0)
    for u, v in zip(a, b):
        np.testing.assert_allclose(u.numpy(), np.asarray(v), rtol=1e-6)


# --------------------------------------------------------------------------
# Rand index
# --------------------------------------------------------------------------

def test_rand_index_exact_path_matches_reference():
    rng = np.random.default_rng(6)
    for n, k in [(1, 2), (50, 3), (1000, 4), (5000, 7)]:
        a = rng.integers(0, k, n)
        b = np.where(rng.random(n) < 0.8, a, rng.integers(0, k, n))
        want = float(jrand(a, b, k, k))
        assert rand_index(_t(a), _t(b), k, k) == want
        if n <= 1000:
            assert want == pytest.approx(
                rand_index_pairwise_reference(a, b), abs=1e-12)
    assert rand_index(_t(a), _t(a), k, k) == 1.0


def test_rand_index_float32_path_matches_reference_trace():
    rng = np.random.default_rng(7)
    traced = jax.jit(lambda a, b: jrand(a, b, 5, 5))
    for n in (300, 3000, 9000):
        a = rng.integers(0, 5, n)
        b = np.where(rng.random(n) < 0.7, a, rng.integers(0, 5, n))
        got = rand_index_from_contingency_f32(
            contingency_table(_t(a), _t(b), 5, 5))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(traced(a, b)),
                                   rtol=2e-7)


# --------------------------------------------------------------------------
# Regression + LongTailModel
# --------------------------------------------------------------------------

def _cloud(seed=8, n=120):
    rng = np.random.default_rng(seed)
    r = rng.uniform(0.0, 1.0, n)
    h = 0.3 * (1.0 - r) ** 2 + 0.01 + rng.normal(0, 1e-3, n) ** 2
    return r, h


@pytest.mark.parametrize("family", regression.FAMILIES)
def test_regression_families_match_reference(family):
    r, h = _cloud()
    got = regression.fit_family(r, h, family)
    want = jreg.fit_family(r, h, family)
    np.testing.assert_allclose(got.coeffs, want.coeffs, rtol=1e-3, atol=1e-5)
    for r_star in (0.8, 0.95, 0.99):
        assert got.threshold_for(r_star) == pytest.approx(
            want.threshold_for(r_star), rel=1e-3)
    assert got.metrics.r2 == pytest.approx(want.metrics.r2, abs=1e-4)
    np.testing.assert_allclose(got.predict(r).numpy(),
                               np.asarray(want.predict(r)), rtol=1e-3,
                               atol=1e-5)


def test_select_model_and_trace_helpers_match_reference():
    r, h = _cloud(seed=9)
    best, table = regression.select_model(r, h)
    jbest, jtable = jreg.select_model(r, h)
    assert best.family == jbest.family and set(table) == set(jtable)
    js = np.array([100.0, 60.0, 50.0, 49.0, 49.0])
    np.testing.assert_array_equal(regression.rh_from_objectives(js),
                                  jreg.rh_from_objectives(js))
    traces = [(np.array([0.5, np.nan, 0.9]), np.array([1.0, 2.0, np.inf])),
              (np.array([0.7]), np.array([0.3]))]
    for a, b in zip(regression.pool_traces(traces),
                    jreg.pool_traces(traces)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(
        change_rate(np.float32(9.0), np.float32(10.0)).numpy(),
        np.asarray(jchange(jnp.float32(9.0), jnp.float32(10.0))))


def test_longtail_model_json_round_trips_both_ways(tmp_path):
    r, h = _cloud(seed=10)
    traces = [(r[:60], h[:60]), (r[60:], h[60:])]
    prov = {"mode": "full", "chunks": 1, "devices": 1}
    jm = jfit(traces, algorithm="kmeans", dataset="skin", family=None,
              engine_config=prov)
    text = jm.to_json()
    tm = LongTailModel.from_json(text)
    assert tm.to_json() == text                   # reference → port
    assert JModel.from_json(tm.to_json()).to_json() == text
    mine = fit_longtail(traces, algorithm="kmeans", dataset="skin",
                        family="quadratic", engine_config=prov)
    assert JModel.from_json(mine.to_json()).to_json() == mine.to_json()
    assert mine.threshold_for(0.99) == pytest.approx(
        jfit(traces, algorithm="kmeans", dataset="skin",
             family="quadratic").threshold_for(0.99), rel=1e-3)
    path = tmp_path / "model.json"          # a model file the reference wrote
    path.write_text(text)
    assert LongTailModel.from_json(path.read_text()).to_json() == text


# --------------------------------------------------------------------------
# Engine, full mode: same stop iteration, params, labels and trace
# --------------------------------------------------------------------------

def _engine_case(algorithm, chunks):
    x = _blobs(n=700, d=3, k=4, seed=11, spread=2.5)
    key = jax.random.PRNGKey(3)
    c0 = jkm.kmeans_plus_plus_init(key, jnp.asarray(x), 4, chunks=chunks)
    if algorithm == "kmeans":
        kw = dict(stop_when_frozen=True, use_h_stop=True, h_star=1e-9,
                  patience=2)
        p0 = c0
    else:
        kw = dict(use_h_stop=True, h_star=1e-4, patience=2)
        p0 = jem.init_from_kmeans(jnp.asarray(x), c0)
    kw.update(max_iters=60, chunks=chunks, trace=True)
    ref = JEngine(algorithm, JConfig(use_kernel=True, kernel_backend="xla",
                                     **kw)).fit(jnp.asarray(x), p0)
    mine = ClusteringEngine(algorithm, EngineConfig(**kw), device="cpu").fit(
        x, convert.params_from_numpy(
            algorithm, np.asarray(p0) if algorithm == "kmeans"
            else tuple(np.asarray(a) for a in p0), "cpu"))
    return ref, mine


@pytest.mark.parametrize("chunks", [1, 4])
@pytest.mark.parametrize("algorithm", ["kmeans", "em"])
def test_engine_fit_matches_reference(algorithm, chunks):
    ref, mine = _engine_case(algorithm, chunks)
    assert mine.n_iters == int(ref.n_iters) > 2
    np.testing.assert_array_equal(mine.labels.numpy(), np.asarray(ref.labels))
    ref_params = (ref.params,) if algorithm == "kmeans" else ref.params
    my_params = (mine.params,) if algorithm == "kmeans" else mine.params
    for a, b in zip(my_params, ref_params):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_allclose(float(mine.objective), float(ref.objective),
                               rtol=2e-5)
    tr, jtr = mine.trace, ref.trace
    np.testing.assert_array_equal(tr.mask.numpy(), np.asarray(jtr.mask))
    np.testing.assert_allclose(tr.objectives.numpy(),
                               np.asarray(jtr.objectives), rtol=2e-5)
    h, jh = tr.h.numpy(), np.asarray(jtr.h)
    np.testing.assert_array_equal(np.isfinite(h), np.isfinite(jh))
    fin = np.isfinite(h)
    np.testing.assert_allclose(h[fin], jh[fin], rtol=1e-2, atol=1e-6)


def test_engine_step_matches_reference():
    x = _blobs(n=300, seed=12)
    c = x[:4]
    got = ClusteringEngine("kmeans", EngineConfig(chunks=3),
                           device="cpu").step(x, c)
    want = JEngine("kmeans", JConfig(chunks=3, use_kernel=True,
                                     kernel_backend="xla")).step(
        jnp.asarray(x), jnp.asarray(c))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)


def test_later_slices_are_refused_not_ignored():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        EngineConfig(mode="minibatch")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TrainingPlan(restarts=2)


def test_from_longtail_polices_provenance():
    r, h = _cloud()
    model = fit_longtail([(r, h)], algorithm="kmeans", dataset="d",
                         family="quadratic",
                         engine_config={"mode": "full",
                                        "kernel_backend": "xla"})
    with pytest.warns(UserWarning, match="kernel_backend"):
        cfg = EngineConfig.from_longtail(model, 0.95, device="cpu")
    assert cfg.h_star == pytest.approx(model.threshold_for(0.95))
    fp = EngineConfig(chunks=4).matched_fingerprint("cpu")
    assert fp["use_kernel"] is True and fp["kernel_backend"] == "torch"
    assert set(fp) == set(JConfig.MATCHED_FIELDS) | {"chunks"}


def test_params_convert_round_trip():
    mu = np.arange(6, dtype=np.float32).reshape(2, 3)
    gp = jem.GMMParams(jnp.asarray(mu), jnp.ones((2, 3)), jnp.zeros(2))
    tp = convert.params_from_numpy("em", tuple(np.asarray(a) for a in gp),
                                   "cpu")
    back = jem.GMMParams(*convert.params_to_numpy(tp))
    for a, b in zip(back, gp):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(
        convert.params_to_numpy(convert.params_from_numpy("kmeans", mu,
                                                          "cpu")), mu)


# --------------------------------------------------------------------------
# numpy copies: data, sampling, cost model
# --------------------------------------------------------------------------

def test_synthetic_data_and_groups_match_reference():
    for name in ("road3d", "skin", "poker"):
        np.testing.assert_array_equal(synthetic.load(name, n=1200, seed=3),
                                      jsyn.load(name, n=1200, seed=3))
    np.testing.assert_array_equal(
        synthetic.spacenet_pixels(2, 6, 1, shape=(20, 30, 3)),
        jsyn.spacenet_pixels(2, 6, 1, shape=(20, 30, 3)))
    data = jsyn.skin(n=5000, seed=1)
    np.testing.assert_array_equal(
        sampling.random_groups(data, 700, seed=2, max_groups=5),
        jsamp.random_groups(data, 700, seed=2, max_groups=5))
    a = sampling.make_grouped(data, 400, fold=2, seed=4)
    b = jsamp.make_grouped(data, 400, fold=2, seed=4)
    np.testing.assert_array_equal(a.train_groups, b.train_groups)
    np.testing.assert_array_equal(a.val_idx, b.val_idx)


def test_cost_report_matches_reference():
    a = cost_model.report(12.5, 40.0, time_train_s=3.0, instance="m4.2xlarge")
    b = jcost.report(12.5, 40.0, time_train_s=3.0, instance="m4.2xlarge")
    for f in ("time_comp_s", "cost_effectiveness", "cost_actual_usd",
              "cost_full_usd", "savings_usd", "cost_train_usd"):
        assert getattr(a, f) == getattr(b, f)
