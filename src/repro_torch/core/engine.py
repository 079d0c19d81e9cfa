"""Clustering engine, full-batch mode on one device — the port of the
full-mode subset of ``repro.core.engine``.

One fit loop for k-means and EM behind a small algorithm protocol
(``kernel_stats / update / objective / moved``).  Every sweep
goes through the algorithm's kernel op, streamed over ``chunks`` static
row slices: the CUDA kernels on the card, their plain PyTorch versions on
the CPU.

The fit loop keeps its state (parameters, J, h, the patience count, the
moved flag, the trace buffers) on the device and reads one scalar per
iteration — the continue predicate — to decide whether to go on.  Its stop
semantics are the reference's ``_live``/``_fit_loop``: Eq. 7's h is ∞
before the first J, the h stop needs ``patience`` consecutive
h ≤ h* readings and never fires before iteration 2, k-means can also stop
once its centroids are bitwise frozen, and a final full sweep labels the
points at the returned parameters.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, NamedTuple

import torch

from repro_torch.kernels.dispatch import resolve_device
from repro_torch.kernels.gmm_estep import ops as _gops
from repro_torch.kernels.kmeans_assign import ops as _kops

from . import em_gmm as _em
from . import kmeans as _km

_EPS = 1e-30


# --------------------------------------------------------------------------
# Algorithm protocol
# --------------------------------------------------------------------------

class KMeansAlgorithm:
    """Lloyd's k-means.  Params: centroids [K, D].  Stats: (sums, counts, J)."""

    name = "kmeans"
    maximize = False

    def kernel_stats(self, x, params, chunks: int):
        """A full sweep over ``chunks`` static slices → (labels, stats)."""
        labels, sums, counts, j = _kops.kmeans_assign_chunked(
            x, params, chunks=chunks)
        return labels, (sums, counts, j)

    def update(self, params, stats, n_total):
        del n_total  # centroid means normalise by per-cluster counts
        sums, counts, _ = stats
        return _km.update_centroids(params, sums, counts)

    def objective(self, stats):
        return stats[2]

    def moved(self, new_params, params):
        return torch.any(new_params != params)


class EMAlgorithm:
    """Diagonal-covariance GMM via EM.  Params: GMMParams.
    Stats: (r_sum, r_x, r_x2, loglik)."""

    name = "em"
    maximize = True

    def kernel_stats(self, x, params, chunks: int):
        labels, loglik, r_sum, r_x, r_x2 = _gops.gmm_estep_chunked(
            x, params.means, params.var, params.log_w, chunks=chunks)
        return labels, (r_sum, r_x, r_x2, loglik)

    def update(self, params, stats, n_total):
        r_sum, r_x, r_x2, _ = stats
        return _em.mstep(params, r_sum, r_x, r_x2, n_total)

    def objective(self, stats):
        return stats[3]

    def moved(self, new_params, params):
        # EM has no frozen fixed point at fp granularity; the engine never
        # gates EM on movement (stop_when_frozen=False)
        del new_params
        return torch.ones((), dtype=torch.bool, device=params.means.device)


KMEANS = KMeansAlgorithm()
EM = EMAlgorithm()
_ALGORITHMS = {"kmeans": KMEANS, "em": EM}


def get_algorithm(algorithm):
    if isinstance(algorithm, str):
        return _ALGORITHMS[algorithm]
    return algorithm


# --------------------------------------------------------------------------
# Config + results
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine configuration, full mode.

    ``h_star`` is the default threshold (``fit`` takes an override);
    ``patience`` consecutive h ≤ h* readings stop the fit when
    ``use_h_stop``; ``stop_when_frozen`` stops k-means once the centroids
    stop moving bitwise; ``chunks`` streams each sweep over that many
    static row slices; ``trace`` records a per-iteration :class:`Trace`.
    """
    max_iters: int = 300
    h_star: float = 0.0
    patience: int = 1
    chunks: int = 1
    use_h_stop: bool = True
    stop_when_frozen: bool = False
    trace: bool = False
    mode: str = "full"

    def __post_init__(self):
        if self.mode != "full":
            raise NotImplementedError(
                f"mode={self.mode!r}: the port runs full-batch mode only; "
                "minibatch mode is step 7 of ROADMAP.md §1")

    # the reference's engine-regime fields (its MATCHED_FIELDS + chunks);
    # the port has no minibatch knobs, so they read their defaults
    def matched_fingerprint(self, device) -> dict:
        """The regime this config clusters under, in the reference's keys:
        every sweep runs an op, so ``use_kernel`` is True and
        ``kernel_backend`` names the route, ``cuda`` or ``torch``."""
        return {"mode": self.mode, "batch_chunks": 0, "decay": 1.0,
                "ema": 0.0, "use_kernel": True,
                "kernel_backend": kernel_backend(device),
                "chunks": self.chunks}

    @classmethod
    def from_longtail(cls, model, desired_accuracy: float, *, device=None,
                      **kw):
        """Route a fitted LongTailModel through the engine: h* = f(r*).

        A model whose stamped harvest regime differs from this config's
        fires a ``UserWarning``, as in the reference."""
        cfg = cls(h_star=float(model.threshold_for(desired_accuracy)), **kw)
        prov = getattr(model, "engine_config", None)
        if prov:
            mine = cfg.matched_fingerprint(resolve_device(device))
            diff = {f: (prov[f], mine[f]) for f in mine
                    if f != "chunks" and f in prov and prov[f] != mine[f]}
            if diff:
                detail = ", ".join(f"{f}: fitted={a!r} production={b!r}"
                                   for f, (a, b) in sorted(diff.items()))
                warnings.warn(
                    "LongTailModel was fitted under a different engine "
                    f"configuration than it is now serving ({detail})",
                    UserWarning, stacklevel=2)
        return cfg


def kernel_backend(device) -> str:
    """The route a device's sweeps take: ``cuda`` kernels or ``torch``
    plain versions."""
    return "cuda" if torch.device(device).type == "cuda" else "torch"


class Trace(NamedTuple):
    """Per-iteration fit history, recorded on the device when
    ``config.trace``.  Buffers are [max_iters]-shaped; ``mask[i] = 1``
    marks iterations that ran; ``h[0]`` is ∞ (Eq. 7 starts at the second
    sweep); ``params[i]`` is the state ``objectives[i]`` was measured at
    (the pre-update parameters)."""
    objectives: torch.Tensor
    h: torch.Tensor
    mask: torch.Tensor
    params: Any


class EngineResult(NamedTuple):
    params: Any                 # centroids [K,D] | GMMParams
    labels: torch.Tensor        # [N] int32
    objective: torch.Tensor     # [] J / loglik at the final params
    n_iters: int
    h: torch.Tensor             # [] last change rate observed
    trace: Any = None           # Trace when config.trace, else None


def _map_params(fn, params):
    """Apply ``fn`` to every tensor of a parameter set."""
    if isinstance(params, _em.GMMParams):
        return _em.GMMParams(*(fn(p) for p in params))
    return fn(params)


def as_points(x, device) -> torch.Tensor:
    """Points as a contiguous float32 tensor on ``device``."""
    return torch.as_tensor(x).to(device, torch.float32).contiguous()


def as_params(params, device):
    """Parameters (centroids or GMMParams) as float32 tensors on
    ``device``."""
    return _map_params(
        lambda p: torch.as_tensor(p).to(device, torch.float32).contiguous(),
        params)


def _zero_trace(t: int, params0, device) -> Trace:
    """Empty [T]-shaped trace buffers (h starts at ∞ — never measured)."""
    return Trace(
        objectives=torch.zeros((t,), dtype=torch.float32, device=device),
        h=torch.full((t,), torch.inf, dtype=torch.float32, device=device),
        mask=torch.zeros((t,), dtype=torch.float32, device=device),
        params=_map_params(
            lambda p: torch.zeros((t,) + tuple(p.shape), dtype=torch.float32,
                                  device=device), params0))


# --------------------------------------------------------------------------
# Public facade
# --------------------------------------------------------------------------

class ClusteringEngine:
    """One engine, two algorithms, two entry points (step / fit), full mode.

    >>> eng = ClusteringEngine("kmeans", EngineConfig(chunks=8,
    ...                        stop_when_frozen=True), device="cuda")
    >>> c0 = kmeans_plus_plus_init(x, 8, generator=g, chunks=8)
    >>> res = eng.fit(x, c0, h_star=1e-4)
    """

    def __init__(self, algorithm="kmeans", config: EngineConfig | None = None,
                 device=None):
        self.algorithm = get_algorithm(algorithm)
        self.config = config if config is not None else EngineConfig()
        self.device = resolve_device(device)

    def step(self, x, params):
        """One iteration → (new_params, labels, objective)."""
        x = as_points(x, self.device)
        params = as_params(params, self.device)
        n_total = torch.tensor(float(x.shape[0]), dtype=torch.float32,
                               device=self.device)
        labels, stats = self.algorithm.kernel_stats(x, params,
                                                    self.config.chunks)
        return (self.algorithm.update(params, stats, n_total), labels,
                self.algorithm.objective(stats))

    def fit(self, x, params0, h_star=None) -> EngineResult:
        cfg, alg = self.config, self.algorithm
        x = as_points(x, self.device)
        params = as_params(params0, self.device)
        dev = self.device
        n_total = torch.tensor(float(x.shape[0]), dtype=torch.float32,
                               device=dev)
        hs = torch.tensor(cfg.h_star if h_star is None else float(h_star),
                          dtype=torch.float32, device=dev)
        inf = torch.tensor(torch.inf, dtype=torch.float32, device=dev)
        j_curr = h = inf
        hits = torch.zeros((), dtype=torch.int32, device=dev)
        moved = torch.ones((), dtype=torch.bool, device=dev)
        trace = _zero_trace(cfg.max_iters, params, dev) if cfg.trace else None
        it = 0
        while it < cfg.max_iters:
            # the reference's _live: one device scalar read per iteration
            go = moved if cfg.stop_when_frozen else None
            if cfg.use_h_stop and it >= 2:
                more = hits < cfg.patience
                go = more if go is None else go & more
            if go is not None and not bool(go):
                break
            _, stats = alg.kernel_stats(x, params, cfg.chunks)
            j = alg.objective(stats)
            new_params = alg.update(params, stats, n_total)
            h = torch.where(
                torch.isfinite(j_curr),
                torch.abs(j - j_curr) / torch.clamp_min(torch.abs(j_curr),
                                                        _EPS),
                inf)
            hits = torch.where(h <= hs, hits + 1, torch.zeros_like(hits))
            moved = alg.moved(new_params, params)
            if trace is not None:
                trace.objectives[it] = j
                trace.h[it] = h
                trace.mask[it] = 1.0
                if isinstance(params, _em.GMMParams):
                    for buf, p in zip(trace.params, params):
                        buf[it] = p
                else:
                    trace.params[it] = params
            params, j_curr = new_params, j
            it += 1
        labels, stats = alg.kernel_stats(x, params, cfg.chunks)
        return EngineResult(params, labels, alg.objective(stats), it, h,
                            trace)
