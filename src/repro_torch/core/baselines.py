"""Baseline resource-selection approaches from the paper's evaluation (§III-B).

Every approach implements ``select(job) -> CloudConfig | None`` (``None``
means "not applicable to this job", e.g. Juggler on non-iterative jobs) or
``expected_norm_cost`` for the random baseline.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import List, Optional, Sequence

from repro_torch.core import costmodel, spark_sim
from repro_torch.core.flora import Flora
from repro_torch.core.trace import CloudConfig, JobClass, JobSpec, Trace

ITERATIVE_ML = ("KMeans", "LinearRegression", "LogisticRegression")


class Approach:
    name: str = "abstract"

    def select(self, job: JobSpec) -> Optional[CloudConfig]:
        raise NotImplementedError


# --- static baselines ---------------------------------------------------------

@dataclasses.dataclass
class StaticResource(Approach):
    """min/max CPU or memory baselines.

    Tie-breaks (several configs share the extreme total): minimising
    approaches prefer the smallest scale-out; maximising approaches prefer
    the largest scale-out; remaining ties break on the paper's config index.
    """

    configs: Sequence[CloudConfig]
    resource: str      # "cpu" | "mem"
    maximize: bool

    def __post_init__(self):
        self.name = ("maximize " if self.maximize else "minimize ") + (
            "CPU" if self.resource == "cpu" else "memory")

    def select(self, job: JobSpec) -> CloudConfig:
        def amount(c: CloudConfig) -> float:
            return c.total_cores if self.resource == "cpu" else c.total_mem_gib
        best = max(amount(c) for c in self.configs) if self.maximize \
            else min(amount(c) for c in self.configs)
        ties = [c for c in self.configs if amount(c) == best]
        ties.sort(key=lambda c: (-c.scale_out if self.maximize else c.scale_out,
                                 c.index))
        return ties[0]


@dataclasses.dataclass
class RandomSelection(Approach):
    """Expected result of a uniform random choice (evaluated in closed form)."""

    configs: Sequence[CloudConfig]
    name: str = "random selection"

    def select(self, job: JobSpec) -> None:  # evaluated via expectation
        return None


# --- profiling-based state-of-the-art baselines -------------------------------

def _unit_noise(tag: str, job: JobSpec, sigma: float) -> float:
    key = f"{tag}|{job.algorithm}|{job.dataset_gib}".encode()
    h = hashlib.md5(key).digest()
    u1 = (int.from_bytes(h[:8], "big") + 1) / (2 ** 64 + 2)
    u2 = (int.from_bytes(h[8:16], "big") + 1) / (2 ** 64 + 2)
    z = math.sqrt(-2.0 * math.log(u1)) * math.cos(2 * math.pi * u2)
    return math.exp(sigma * z)


@dataclasses.dataclass
class Juggler(Approach):
    """Juggler [9]: size total cluster memory to fit the cached dataset.

    From a brief profiling run it measures the cache-to-input ratio, then
    picks the cheapest (hourly) configuration whose total memory fits the
    estimate.  Applicable to iterative ML workloads only.
    """

    configs: Sequence[CloudConfig]
    price: costmodel.LinearPriceModel
    estimate_sigma: float = 0.08
    name: str = "Juggler"

    def select(self, job: JobSpec) -> Optional[CloudConfig]:
        if job.algorithm not in ITERATIVE_ML:
            return None
        kappa = spark_sim.ALGO_PARAMS[job.algorithm].kappa
        need = kappa * job.dataset_gib * _unit_noise("juggler", job,
                                                     self.estimate_sigma)
        fitting = [c for c in self.configs if c.total_mem_gib >= need]
        if not fitting:   # nothing fits: fall back to max memory
            return max(self.configs, key=lambda c: (c.total_mem_gib, c.index))
        fitting.sort(key=lambda c: (self.price(c), -c.cores_per_node, c.index))
        return fitting[0]


@dataclasses.dataclass
class Crispy(Approach):
    """Crispy [11]: extrapolate peak memory from profiling; cost-estimate.

    Estimates the job's full-scale memory footprint (with extrapolation
    error), filters configurations that fit it, and among those picks the
    minimum of a naive predicted cost: profiled unit work scaled linearly
    with total cores (the straightforward scale-out assumption the Crispy
    paper relies on), times the current hourly price.
    """

    configs: Sequence[CloudConfig]
    price: costmodel.LinearPriceModel
    estimate_sigma: float = 0.35
    name: str = "Crispy"

    def select(self, job: JobSpec) -> CloudConfig:
        p = spark_sim.ALGO_PARAMS[job.algorithm]
        need = (p.kappa_peak * job.dataset_gib
                * _unit_noise("crispy-mem", job, self.estimate_sigma))
        fitting = [c for c in self.configs if c.total_mem_gib >= need]
        if not fitting:
            return max(self.configs, key=lambda c: (c.total_mem_gib, c.index))
        # naive cost model: runtime ~ unit_work / total_cores
        unit_work = (p.parse_w + p.w * p.iters) * job.dataset_gib
        unit_work *= _unit_noise("crispy-rt", job, self.estimate_sigma)

        def predicted_cost(c: CloudConfig) -> float:
            t_hours = unit_work / c.total_cores / 3600.0
            return t_hours * self.price(c)
        fitting.sort(key=lambda c: (predicted_cost(c), c.index))
        return fitting[0]


# --- Flora wrappers ------------------------------------------------------------

@dataclasses.dataclass
class FloraApproach(Approach):
    """Flora (or Fw1C with ``one_class=True``) with leave-one-algorithm-out.

    Thin adapter: selection routes through the shared
    :class:`repro_torch.selector.SelectionService` (via :class:`Flora`), so the
    per-(class, exclusion, price-epoch) ranking caches are shared across
    the evaluation's 18 leave-one-out submissions.
    """

    trace: Trace
    price: costmodel.LinearPriceModel
    one_class: bool = False
    #: class-annotation override for the misclassification experiment.
    flip_class: bool = False

    def __post_init__(self):
        self.name = "Flora with one class" if self.one_class else "Flora"
        self._flora = Flora(self.trace, self.price, one_class=self.one_class)

    @property
    def service(self):
        """The underlying :class:`repro_torch.selector.SelectionService`."""
        return self._flora.service

    def select(self, job: JobSpec) -> CloudConfig:
        klass = job.job_class.flipped() if self.flip_class else job.job_class
        return self._flora.select_for_job(job, annotated_class=klass)


def standard_approaches(trace: Trace, price: costmodel.LinearPriceModel
                        ) -> List[Approach]:
    """All approaches of the paper's Table IV, in one list."""
    cfgs = trace.configs
    return [
        StaticResource(cfgs, "cpu", maximize=False),
        RandomSelection(cfgs),
        StaticResource(cfgs, "mem", maximize=False),
        StaticResource(cfgs, "cpu", maximize=True),
        StaticResource(cfgs, "mem", maximize=True),
        FloraApproach(trace, price, one_class=True),
        Juggler(cfgs, price),
        Crispy(cfgs, price),
        FloraApproach(trace, price),
    ]
