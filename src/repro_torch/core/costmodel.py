"""Resource cost models.

Flora applies *current* hourly resource costs to historical runtimes
(paper §II-D).  Two families of cost model live here:

* :class:`LinearPriceModel` — per-resource (vCPU-hour, GiB-hour) pricing as
  used for GCP n2 VMs in the paper's evaluation (§III-C notes that configs
  with equal total cores and total memory cost the same regardless of
  scale-out, i.e. pricing is linear in the resource totals).
* :class:`TpuPriceModel` — $/chip-hour pricing for TPU slices, used by the
  TPU-side adaptation (mesh selection; see DESIGN.md §3).

Both are plain callables so the selector can be handed a time-varying price
source (spot market, carbon intensity) without code changes.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

from repro_torch.core.trace import CloudConfig

# GCP n2 predefined-VM resource rates, europe-west3 (Frankfurt),
# on-demand, as of 2024-12-01 (USD).  The paper's evaluation date.
GCP_N2_FRANKFURT_CPU_HOUR = 0.03805
GCP_N2_FRANKFURT_GIB_HOUR = 0.00510


@dataclasses.dataclass(frozen=True)
class LinearPriceModel:
    """hourly_cost(c) = total_cores * cpu_rate + total_mem_gib * mem_rate."""

    cpu_core_hour: float = GCP_N2_FRANKFURT_CPU_HOUR
    mem_gib_hour: float = GCP_N2_FRANKFURT_GIB_HOUR
    #: multiplier for, e.g., spot discount or carbon-intensity scaling.
    multiplier: float = 1.0

    def __call__(self, config: CloudConfig) -> float:
        return self.multiplier * (
            config.total_cores * self.cpu_core_hour
            + config.total_mem_gib * self.mem_gib_hour)

    def with_mem_to_cpu_ratio(self, ratio: float) -> "LinearPriceModel":
        """Price model where 1 GiB-hour costs ``ratio`` vCPU-hours.

        This is the x-axis of the paper's Fig. 2 (10^-2 .. 10^1): the CPU
        rate is held fixed and the memory rate is set relative to it.
        """
        return LinearPriceModel(cpu_core_hour=self.cpu_core_hour,
                                mem_gib_hour=ratio * self.cpu_core_hour,
                                multiplier=self.multiplier)


def execution_cost(runtime_s: float, config: CloudConfig,
                   price: LinearPriceModel) -> float:
    """cost(j, c) = runtime_in_hours(j, c) * current_hourly_cost(c)."""
    return runtime_s / 3600.0 * price(config)


# --- TPU-side pricing (framework integration) --------------------------------

# Public list prices, USD per chip-hour (us-central, on-demand / spot),
# indicative as of 2024: v5e on-demand 1.2 / spot ~0.72; v5p 4.2 / ~2.1.
TPU_CHIP_HOUR = {
    ("v5e", "ondemand"): 1.20,
    ("v5e", "spot"): 0.72,
    ("v5p", "ondemand"): 4.20,
    ("v5p", "spot"): 2.10,
}


@dataclasses.dataclass(frozen=True)
class TpuPriceModel:
    """$/hour for a whole slice: chips * chip_hour(generation, market)."""

    market: str = "ondemand"
    #: optional override table, e.g. live spot quotes per generation.
    rates: Optional[Mapping[str, float]] = None

    def chip_hour(self, generation: str) -> float:
        if self.rates is not None and generation in self.rates:
            return self.rates[generation]
        return TPU_CHIP_HOUR[(generation, self.market)]

    def slice_hour(self, generation: str, chips: int) -> float:
        return self.chip_hour(generation) * chips
