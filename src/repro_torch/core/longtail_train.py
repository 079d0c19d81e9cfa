"""Configuration-matched long-tail training (the paper's §4–§5.4 training
phase) — the port of the full-mode, one-restart part of
``repro.core.longtail_train``.

``harvest_traces`` runs each training group through ``ClusteringEngine.fit``
with ``trace=True`` under the production config, re-aimed at full
convergence, so the recorded h sequence is the statistic the production
stop compares against h*.  Accuracy r_i is read off the recorded parameter
trajectory: one labelling pass through the op per recorded iteration, and
r_i is the float32 Rand identity against the trace's own final partition
(the paper's §3.2 definition).  ``fit_for_config`` pools the traces, fits
Eq. 8 and stamps the harvest regime into the model's provenance.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.dispatch import resolve_device

from . import em_gmm as _em
from . import kmeans as _km
from .earlystop import LongTailModel, fit_longtail
from .engine import (ClusteringEngine, EngineConfig, Trace, as_points,
                     get_algorithm)
from .rand_index import contingency_table, rand_index_from_contingency_f32

# EM full-batch harvest stop: relative log-likelihood change below this
# counts as converged (the reference's _EM_TOL)
_EM_TOL = 1e-12


def config_fingerprint(config: EngineConfig, device, devices: int = 1
                       ) -> dict:
    """The regime a harvest ran under, as JSON-stampable provenance (the
    reference's keys; ``devices`` records the device count)."""
    d = config.matched_fingerprint(device)
    d["devices"] = int(devices)
    return d


def harvest_config(production: EngineConfig, algorithm: str, *,
                   max_iters: int | None = None) -> EngineConfig:
    """The trace-harvest config: the production layout, with the stop
    re-aimed at full convergence so the trace covers the whole tail —
    k-means stops on frozen centroids (an h stop at h*=0 quits on fp32 J
    plateaus before the Lloyd fixed point), EM at the ``_EM_TOL`` rate."""
    kw: dict = dict(trace=True, h_star=0.0)
    if max_iters is not None:
        kw["max_iters"] = max_iters
    if algorithm == "kmeans":
        kw.update(use_h_stop=False, stop_when_frozen=True)
    else:
        kw.update(use_h_stop=True, h_star=_EM_TOL, patience=1,
                  stop_when_frozen=False)
    return dataclasses.replace(production, **kw)


@dataclasses.dataclass(frozen=True)
class TrainingPlan:
    """What to harvest and fit: algorithm, k and the production
    :class:`EngineConfig` the traces are recorded under.  ``max_iters``
    overrides the harvest iteration budget; ``family=None`` runs the Eq. 8
    model-selection comparison.  One restart per group."""
    algorithm: str = "kmeans"
    k: int = 2
    config: EngineConfig = EngineConfig()
    family: str | None = "quadratic"
    restarts: int = 1
    max_iters: int | None = None
    seed: int = 0
    dataset: str = "train"

    def __post_init__(self):
        if self.restarts != 1:
            raise NotImplementedError(
                "restarts > 1: multi-restart harvests are step 1 of the next "
                "slices' queue in ROADMAP.md")


def group_init(algorithm: str, x, k: int, chunks: int,
               generator: torch.Generator):
    """Per-group seeding, as the production CLI seeds: streamed k-means++
    for k-means, k-means++-seeded GMMs for EM."""
    c0 = _km.kmeans_plus_plus_init(x, k, generator=generator, chunks=chunks)
    if algorithm == "kmeans":
        return c0
    return _em.init_from_kmeans(x, c0)


def _trace_params(params, i: int):
    if isinstance(params, _em.GMMParams):
        return _em.GMMParams(*(p[i] for p in params))
    return params[i]


def engine_trace_to_rh(trace: Trace, x, *, algorithm: str, k: int
                       ) -> tuple[np.ndarray, np.ndarray]:
    """(r_i, h_i) pairs from one engine trace (§3.2 accuracy + Eq. 7 rate).

    Labels every recorded iteration's parameters with one pass through the
    op, and measures r_i against the trace's own final recorded partition
    (the converged one in full mode).  Rows with no iteration behind them
    or an undefined rate (h = ∞ at index 0) are dropped.
    """
    mask = trace.mask.cpu().numpy()
    h = trace.h.cpu().numpy().astype(np.float64)
    n_it = int(mask.sum())
    if n_it == 0:
        return np.zeros((0,)), np.zeros((0,))
    alg = get_algorithm(algorithm)
    x = torch.as_tensor(x).to(trace.objectives.device, torch.float32)
    labels_hist = [alg.kernel_stats(x, _trace_params(trace.params, i), 1)[0]
                   for i in range(n_it)]
    ref = labels_hist[-1]
    r = torch.stack([rand_index_from_contingency_f32(
        contingency_table(lab, ref, k, k)) for lab in labels_hist])
    r = r.cpu().numpy().astype(np.float64)
    valid = np.isfinite(h[:n_it])
    return r[valid], h[:n_it][valid]


def harvest_traces(plan: TrainingPlan, groups, *, inits=None, device=None
                   ) -> list[tuple[np.ndarray, np.ndarray]]:
    """Run every training group under the plan's harvest config and return
    its (r, h) trace.  ``inits[gi]`` (optional) gives group gi's initial
    parameters; otherwise they are seeded from ``plan.seed + gi``."""
    dev = resolve_device(device)
    cfg = harvest_config(plan.config, plan.algorithm,
                         max_iters=plan.max_iters)
    eng = ClusteringEngine(plan.algorithm, cfg, device=dev)
    out: list[tuple[np.ndarray, np.ndarray]] = []
    for gi in range(len(groups)):
        x = as_points(groups[gi], dev)
        if inits is not None:
            params0 = inits[gi]
        else:
            gen = torch.Generator(device=dev).manual_seed(plan.seed + gi)
            params0 = group_init(plan.algorithm, x, plan.k, cfg.chunks, gen)
        res = eng.fit(x, params0)
        out.append(engine_trace_to_rh(res.trace, x, algorithm=plan.algorithm,
                                      k=plan.k))
    return out


def fit_for_config(plan: TrainingPlan, groups, *, inits=None, device=None
                   ) -> LongTailModel:
    """Harvest and fit h = f(r) for the plan's engine configuration,
    stamping the regime into the model."""
    dev = resolve_device(device)
    traces = harvest_traces(plan, groups, inits=inits, device=dev)
    return fit_longtail(
        traces, algorithm=plan.algorithm, dataset=plan.dataset,
        family=plan.family,
        engine_config=config_fingerprint(plan.config, dev))
