"""The paper's contribution as a reusable control layer — the port of
``repro.core.earlystop`` (clustering side).

``LongTailModel`` packages the offline-trained Eq. 8 regression: set a
desired accuracy r*, get h* = f(r*), and stop the iterative process once
h_i = |J_i − J_{i−1}| / |J_{i−1}| ≤ h* (Eq. 7).  Its JSON is the
reference's format, byte for byte, so a model fitted by either package
loads in the other.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Sequence

import numpy as np
import torch

from .regression import (FitMetrics, RegressionModel, fit_family,
                         pool_traces, select_model)


def change_rate(j_curr, j_prev, eps: float = 1e-30):
    """h_i = |J_i − J_{i−1}| / |J_{i−1}|   (Eq. 7). Safe at J≈0."""
    j_curr = torch.as_tensor(j_curr)
    j_prev = torch.as_tensor(j_prev)
    return torch.abs(j_curr - j_prev) / torch.clamp_min(torch.abs(j_prev),
                                                        eps)


@dataclasses.dataclass(frozen=True)
class LongTailModel:
    """Fitted h(r) regression + provenance, serialisable for reuse.

    ``engine_config`` records the engine regime the (r, h) traces were
    harvested under (``longtail_train.config_fingerprint``); ``None`` marks
    a fit with no stamped regime."""
    regression: RegressionModel
    algorithm: str
    dataset: str
    n_train_groups: int
    comparison: dict | None = None
    engine_config: dict | None = None

    def threshold_for(self, desired_accuracy: float) -> float:
        """h* = f(r*) — the fitted Eq. 8 regression at r*."""
        return self.regression.threshold_for(desired_accuracy)

    def to_json(self) -> str:
        d = {
            "family": self.regression.family,
            "coeffs": list(self.regression.coeffs),
            "metrics": dataclasses.asdict(self.regression.metrics),
            "algorithm": self.algorithm,
            "dataset": self.dataset,
            "n_train_groups": self.n_train_groups,
        }
        if self.comparison is not None:
            d["comparison"] = {k: dataclasses.asdict(v)
                               for k, v in self.comparison.items()}
        if self.engine_config is not None:
            d["engine_config"] = self.engine_config
        return json.dumps(d, indent=2)

    @staticmethod
    def from_json(s: str) -> "LongTailModel":
        d = json.loads(s)
        reg = RegressionModel(family=d["family"], coeffs=tuple(d["coeffs"]),
                              metrics=FitMetrics(**d["metrics"]))
        comparison = None
        if "comparison" in d:
            comparison = {k: FitMetrics(**v)
                          for k, v in d["comparison"].items()}
        return LongTailModel(regression=reg, algorithm=d["algorithm"],
                             dataset=d["dataset"],
                             n_train_groups=d["n_train_groups"],
                             comparison=comparison,
                             engine_config=d.get("engine_config"))


def fit_longtail(traces: Sequence[tuple[np.ndarray, np.ndarray]], *,
                 algorithm: str, dataset: str, family: str | None = None,
                 engine_config: dict | None = None) -> LongTailModel:
    """Pool (r, h) traces from the training groups and fit h = f(r).

    ``family=None`` runs the Eq. 8 model-selection comparison and keeps
    the winner.
    """
    r, h = pool_traces(traces)
    if family is None:
        best, table = select_model(r, h)
    else:
        best, table = fit_family(r, h, family), None
    return LongTailModel(regression=best, algorithm=algorithm, dataset=dataset,
                         n_train_groups=len(traces), comparison=table,
                         engine_config=engine_config)
