"""Regression between objective change rate h and clustering accuracy r
(Eq. 8) — the port of ``repro.core.regression``.

The fits are a few hundred host-side numbers, not a kernel: they run in
float32 on CPU tensors, as the reference runs them in float32.  Least
squares uses ``torch.linalg.lstsq(..., driver="gelsd")``, the SVD-based
solver, like ``jnp.linalg.lstsq``: the float32 Vandermonde on r ∈ [~0.5, 1]
is ill-conditioned, and the QR-based default solvers give other
coefficients, and another h*.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

FAMILIES = ("linear", "quadratic", "cubic", "exponential", "lasso_quadratic",
            "log_quadratic")


@dataclasses.dataclass(frozen=True)
class FitMetrics:
    sse: float
    rmse: float
    r2: float
    adj_r2: float


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, np.float32)).reshape(-1)


@dataclasses.dataclass(frozen=True)
class RegressionModel:
    """A fitted h(r) model.  ``coeffs`` meaning depends on family."""
    family: str
    coeffs: tuple[float, ...]
    metrics: FitMetrics

    def predict(self, r) -> torch.Tensor:
        r = torch.as_tensor(r, dtype=torch.float32)
        c = torch.tensor(self.coeffs, dtype=torch.float32)
        if self.family in ("linear", "quadratic", "cubic", "lasso_quadratic"):
            # coeffs = (β₀, β₁, …) low-to-high degree
            powers = torch.stack([r ** p for p in range(len(self.coeffs))],
                                 dim=-1)
            return powers @ c
        if self.family == "exponential":
            return c[0] * torch.exp(c[1] * r)
        if self.family == "log_quadratic":
            return torch.exp(c[0] + c[1] * r + c[2] * r * r)
        raise ValueError(f"unknown family {self.family}")

    def threshold_for(self, desired_accuracy: float,
                      floor: float = 1e-12) -> float:
        """h* = f(r*) on the monotone envelope min_{r' ≤ r*} f(r'), floored
        at a small positive value (see the reference's docstring)."""
        grid = torch.linspace(0.0, desired_accuracy, 256,
                              dtype=torch.float32)
        return max(float(torch.min(self.predict(grid))), floor)


def _metrics(h: torch.Tensor, pred: torch.Tensor, n_params: int) -> FitMetrics:
    resid = h - pred
    sse = float(torch.sum(resid ** 2))
    n = h.shape[0]
    rmse = float(torch.sqrt(torch.tensor(sse / max(n, 1),
                                         dtype=torch.float32)))
    ss_tot = float(torch.sum((h - torch.mean(h)) ** 2))
    r2 = 1.0 - sse / ss_tot if ss_tot > 0 else 1.0
    denom = n - n_params - 1
    adj = 1.0 - (1.0 - r2) * (n - 1) / denom if denom > 0 else r2
    return FitMetrics(sse=sse, rmse=rmse, r2=r2, adj_r2=adj)


def _lstsq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.lstsq(a, b[:, None], driver="gelsd").solution[:, 0]


def _polyfit(r: torch.Tensor, h: torch.Tensor, degree: int) -> torch.Tensor:
    """Least-squares polynomial fit on the Vandermonde matrix (SVD)."""
    powers = torch.stack([r ** p for p in range(degree + 1)], dim=-1)
    return _lstsq(powers, h)


def _lasso_quadratic(r: torch.Tensor, h: torch.Tensor, lam: float = 1e-4,
                     iters: int = 5000) -> torch.Tensor:
    """Coordinate-descent LASSO on the quadratic basis (deterministic).

    Runs in float32 numpy: 15,000 scalar coordinate updates are host work,
    and numpy's per-call cost is far below eager torch's."""
    x = np.stack([np.ones_like(r.numpy()), r.numpy(), r.numpy() ** 2], -1)
    hn = h.numpy()
    col_sq = np.sum(x ** 2, axis=0)
    beta = np.zeros((3,), np.float32)
    lam32 = np.float32(lam)
    for _ in range(iters):
        for j in range(3):
            resid = hn - x @ beta + x[:, j] * beta[j]
            rho = np.dot(x[:, j], resid)
            beta[j] = (np.sign(rho) * np.maximum(np.abs(rho) - lam32, 0)
                       / np.maximum(col_sq[j], np.float32(1e-12)))
    return torch.from_numpy(beta)


def fit_family(r, h, family: str) -> RegressionModel:
    r = _f32(r)
    h = _f32(h)
    eps = 1e-30
    if family in ("linear", "quadratic", "cubic"):
        c = _polyfit(r, h, {"linear": 1, "quadratic": 2, "cubic": 3}[family])
    elif family == "exponential":
        # h = a·exp(b·r) → log h = log a + b·r on the h > eps points
        w = (h > eps).to(torch.float32)
        logh = torch.log(torch.clamp_min(h, eps))
        sw = torch.sum(w)
        mr = torch.sum(w * r) / torch.clamp_min(sw, 1.0)
        ml = torch.sum(w * logh) / torch.clamp_min(sw, 1.0)
        cov = torch.sum(w * (r - mr) * (logh - ml))
        var = torch.sum(w * (r - mr) ** 2)
        b = cov / torch.clamp_min(var, 1e-12)
        c = torch.stack([torch.exp(ml - b * mr), b])
    elif family == "lasso_quadratic":
        c = _lasso_quadratic(r, h)
    elif family == "log_quadratic":
        w = (h > eps).to(torch.float32)
        logh = torch.log(torch.clamp_min(h, eps))
        x = torch.stack([torch.ones_like(r), r, r * r], dim=-1) * w[:, None]
        c = _lstsq(x, logh * w)
    else:
        raise ValueError(f"unknown family {family}")
    coeffs = tuple(float(v) for v in c)
    model = RegressionModel(family=family, coeffs=coeffs,
                            metrics=FitMetrics(0, 0, 0, 0))
    return dataclasses.replace(
        model, metrics=_metrics(h, model.predict(r), len(coeffs)))


def select_model(r, h, families: Sequence[str] = FAMILIES
                 ) -> tuple[RegressionModel, dict]:
    """Fit every family; select by adjusted R² (paper §4).  Returns
    (best_model, {family: FitMetrics})."""
    fits = {fam: fit_family(r, h, fam) for fam in families}
    table = {fam: m.metrics for fam, m in fits.items()}
    best = max(fits.values(), key=lambda m: m.metrics.adj_r2)
    return best, table


def rh_from_objectives(objectives) -> np.ndarray:
    """h_i = |J_i − J_{i−1}| / |J_{i−1}| over a recorded objective sequence
    (Eq. 7 host-side), aligned with J[1:]."""
    js = np.asarray(objectives, np.float64).reshape(-1)
    return np.abs(np.diff(js)) / np.maximum(np.abs(js[:-1]), 1e-30)


def pool_traces(traces: Sequence[tuple[np.ndarray, np.ndarray]]):
    """Concatenate (r_i, h_i) traces from many training groups into one
    cloud, dropping non-finite rows."""
    rs = np.concatenate([np.asarray(t[0], np.float64).reshape(-1)
                         for t in traces])
    hs = np.concatenate([np.asarray(t[1], np.float64).reshape(-1)
                         for t in traces])
    ok = np.isfinite(rs) & np.isfinite(hs)
    return rs[ok], hs[ok]
