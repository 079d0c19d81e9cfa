"""Cloud cost model (paper §3.3, Eq. 6/9/10) — the port of the part of
``repro.core.cost_model`` the pipeline reads.

  · Eq. 6 — ``Cost = Price_unit × N_instances × Time_comp``
  · Eq. 9 — ``Time_comp = Time_train + Time_actual``
  · Eq. 10 — ``cost-effectiveness = Time_actual / Time_full``
"""
from __future__ import annotations

import dataclasses

# $/hour, on-demand (the paper's references: m5.large for the case study,
# m4.2xlarge for the 50-instance illustration in §1)
EC2_ON_DEMAND_USD_PER_HOUR = {
    "m5.large": 0.096,
    "m4.2xlarge": 0.40,
    "m4.10xlarge": 2.00,
    "c5.18xlarge": 3.06,
}


@dataclasses.dataclass(frozen=True)
class CostReport:
    """Eq. 6/9/10 for one (early-stopped run, full-convergence baseline)
    pair."""
    time_train_s: float
    time_actual_s: float
    time_full_s: float
    unit_price_per_hour: float
    n_instances: int = 1

    @property
    def time_comp_s(self) -> float:
        """Eq. 9 — the amortised training phase plus the early-stopped run."""
        return self.time_train_s + self.time_actual_s

    @property
    def cost_effectiveness(self) -> float:
        """Eq. 10 — Time_actual / Time_full (lower = better)."""
        return self.time_actual_s / self.time_full_s

    @property
    def cost_actual_usd(self) -> float:
        """Eq. 6 for the early-stopped run (training amortised in)."""
        return (self.unit_price_per_hour * self.n_instances
                * self.time_comp_s / 3600.0)

    @property
    def cost_full_usd(self) -> float:
        """Eq. 6 for the full-convergence baseline."""
        return (self.unit_price_per_hour * self.n_instances
                * self.time_full_s / 3600.0)

    @property
    def savings_usd(self) -> float:
        return self.cost_full_usd - self.cost_actual_usd

    @property
    def cost_train_usd(self) -> float:
        return (self.unit_price_per_hour * self.n_instances
                * self.time_train_s / 3600.0)


def report(time_actual_s: float, time_full_s: float, *,
           time_train_s: float = 0.0, instance: str = "m5.large",
           n_instances: int = 1, price_table: dict | None = None
           ) -> CostReport:
    """The Eq. 6/9/10 report for a measured (actual, full) time pair;
    ``price_table`` maps instance → on-demand $/h (default: EC2)."""
    table = price_table or EC2_ON_DEMAND_USD_PER_HOUR
    return CostReport(time_train_s=time_train_s, time_actual_s=time_actual_s,
                      time_full_s=time_full_s,
                      unit_price_per_hour=table[instance],
                      n_instances=n_instances)
