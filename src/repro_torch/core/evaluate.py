"""Evaluation harness reproducing the paper's §III experiments.

All experiments follow the paper's protocol:

* selections are simulated, then judged against the trace itself;
* per-job normalization: 1.0 = the best (cheapest / fastest) value any
  configuration achieved for that job (§III-C);
* leave-one-algorithm-out: an approach selecting for ``Sort/188GiB`` never
  sees profiling data of *any* Sort job (§III-A) — enforced inside
  :class:`repro_torch.core.baselines.FloraApproach` for Flora/Fw1C (the other
  baselines do not read the trace at all).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import costmodel
from repro_torch.core.baselines import (Approach, FloraApproach,
                                        RandomSelection, standard_approaches)
from repro_torch.core.trace import CloudConfig, JobClass, JobSpec, Trace
from repro_torch.selector import GcpVmCatalog, ProfilingStore


@dataclasses.dataclass(frozen=True)
class JobResult:
    job: JobSpec
    selection: Optional[CloudConfig]
    norm_cost: float
    norm_runtime: float


@dataclasses.dataclass(frozen=True)
class ApproachResult:
    name: str
    per_job: Tuple[JobResult, ...]
    mean_norm_cost: float
    mean_norm_runtime: float


def _job_cost(trace: Trace, job: JobSpec, config: CloudConfig,
              price: costmodel.LinearPriceModel) -> float:
    return costmodel.execution_cost(trace.runtime_s(job, config), config, price)


def _best_per_job(trace: Trace, price: costmodel.LinearPriceModel
                  ) -> Mapping[str, Tuple[float, float]]:
    """job name -> (min cost, min runtime) over all configs, vectorized.

    One (job x config) matrix from :class:`repro_torch.selector.ProfilingStore`
    replaces the historical per-(job, config) python loops (the paper's
    trace is dense, so the mask is all-true; partial traces min over
    profiled cells only).
    """
    store = ProfilingStore.from_trace(trace)
    catalog = GcpVmCatalog(trace.configs, price)
    hours, mask = store.matrix(config_ids=catalog.ids())
    cost = np.where(mask, hours * catalog.price_vector()[None, :], np.inf)
    runtime = np.where(mask, hours * 3600.0, np.inf)
    best_cost = cost.min(axis=1)
    best_rt = runtime.min(axis=1)
    return {j: (float(best_cost[i]), float(best_rt[i]))
            for i, j in enumerate(store.job_ids)}


def evaluate_approach(trace: Trace, price: costmodel.LinearPriceModel,
                      approach: Approach,
                      jobs: Optional[Sequence[JobSpec]] = None
                      ) -> ApproachResult:
    jobs = list(jobs) if jobs is not None else trace.jobs
    best = _best_per_job(trace, price)
    per_job: List[JobResult] = []
    for job in jobs:
        best_cost, best_rt = best[job.name]
        if isinstance(approach, RandomSelection):
            # closed-form expectation over a uniform choice
            ncost = sum(_job_cost(trace, job, c, price) / best_cost
                        for c in trace.configs) / len(trace.configs)
            nrt = sum(trace.runtime_s(job, c) / best_rt
                      for c in trace.configs) / len(trace.configs)
            per_job.append(JobResult(job, None, ncost, nrt))
            continue
        sel = approach.select(job)
        if sel is None:       # not applicable (e.g. Juggler on a scan)
            continue
        ncost = _job_cost(trace, job, sel, price) / best_cost
        nrt = trace.runtime_s(job, sel) / best_rt
        per_job.append(JobResult(job, sel, ncost, nrt))
    if not per_job:
        return ApproachResult(approach.name, (), math.nan, math.nan)
    mean_c = sum(r.norm_cost for r in per_job) / len(per_job)
    mean_r = sum(r.norm_runtime for r in per_job) / len(per_job)
    return ApproachResult(approach.name, tuple(per_job), mean_c, mean_r)


# --- Table IV -------------------------------------------------------------------

def table4(trace: Trace, price: costmodel.LinearPriceModel
           ) -> List[ApproachResult]:
    results = [evaluate_approach(trace, price, a)
               for a in standard_approaches(trace, price)]
    results.sort(key=lambda r: -r.mean_norm_cost)
    return results


# --- Table V --------------------------------------------------------------------

def table5(trace: Trace, price: costmodel.LinearPriceModel
           ) -> Mapping[str, ApproachResult]:
    wanted = ("Crispy", "Juggler", "Flora with one class", "Flora")
    out: Dict[str, ApproachResult] = {}
    for a in standard_approaches(trace, price):
        if a.name in wanted:
            out[a.name] = evaluate_approach(trace, price, a)
    return out


# --- Fig. 2: price-structure sweep -----------------------------------------------

def fig2_price_sweep(trace: Trace, base: costmodel.LinearPriceModel,
                     ratios: Sequence[float]) -> Mapping[str, List[float]]:
    """Mean normalized cost per approach, as mem/CPU price ratio varies.

    ``ratios[i]`` = hourly cost of 1 GiB expressed in vCPU-hours (the
    paper's Fig. 2 x-axis, 10^-2 .. 10^1).
    """
    curves: Dict[str, List[float]] = {}
    for r in ratios:
        price = base.with_mem_to_cpu_ratio(r)
        for res in table4(trace, price):
            curves.setdefault(res.name, []).append(res.mean_norm_cost)
    return curves


# --- Fig. 3: misclassification sweep ----------------------------------------------

def fig3_misclassification(trace: Trace, price: costmodel.LinearPriceModel,
                           fractions: Sequence[float]
                           ) -> Mapping[str, List[float]]:
    """Expected mean normalized cost when a fraction of given jobs is
    misclassified by the user (test-job labels stay expert-correct, §III-E).

    Computed in closed form: each job contributes
    ``(1-f) * cost(correct class) + f * cost(flipped class)``.
    """
    correct = evaluate_approach(trace, price, FloraApproach(trace, price))
    flipped = evaluate_approach(
        trace, price, FloraApproach(trace, price, flip_class=True))
    fw1c = evaluate_approach(
        trace, price, FloraApproach(trace, price, one_class=True))
    rnd = evaluate_approach(trace, price, RandomSelection(trace.configs))
    flora_curve = [
        (1 - f) * correct.mean_norm_cost + f * flipped.mean_norm_cost
        for f in fractions]
    return {
        "Flora": flora_curve,
        "Flora with one class": [fw1c.mean_norm_cost] * len(fractions),
        "random selection": [rnd.mean_norm_cost] * len(fractions),
    }


# --- Fig. 2 under *dynamic* prices: replayed-journal evaluation (DESIGN.md §8) ---

@dataclasses.dataclass(frozen=True)
class DecisionOutcome:
    """One journaled decision judged against the oracles at its epoch."""

    seq: int
    job_id: object
    job_class: object                  # Optional[JobClass]
    config_id: object                  # the journaled selection
    price_epoch: int
    realized_cost: float               # hours(job, sel) * price_e(sel)
    oracle_config: object              # argmin under the epoch's prices
    oracle_cost: float
    static_config: object              # argmin under the *base* prices...
    static_cost: float                 # ...paying the epoch's price

    @property
    def deviation(self) -> float:
        """Fractional deviation from the per-epoch optimum (>= 0)."""
        return self.realized_cost / self.oracle_cost - 1.0

    @property
    def static_deviation(self) -> float:
        """What a static-price selector would have deviated instead."""
        return self.static_cost / self.oracle_cost - 1.0


@dataclasses.dataclass(frozen=True)
class DynamicEvaluation:
    """Deviation-from-optimal over a whole journaled price history.

    The paper's headline metric (mean deviation from the cost-optimal
    configuration, §III-C) generalized to *moving* prices: every decision
    is judged against the oracle that sees the full runtime matrix under
    the prices of that decision's epoch, and against a static-price
    oracle that picked once under the base prices and never moved.
    """

    outcomes: Tuple[DecisionOutcome, ...]
    #: journaled selections whose (job, config) cell is unprofiled — the
    #: realized cost is unknowable from the trace, so they are excluded
    #: from the means but never silently dropped.
    skipped: int
    #: ranking backend that produced the judged decisions ("numpy" |
    #: "torch_fused") — consumers of the report need to know which
    #: :class:`repro_torch.selector.ScoreContract` the journal was audited
    #: under before trusting per-decision scores (DESIGN.md §9).
    backend: str = "numpy"

    def _mean(self, values: Sequence[float]) -> float:
        return sum(values) / len(values) if values else math.nan

    @property
    def mean_deviation(self) -> float:
        return self._mean([o.deviation for o in self.outcomes])

    @property
    def max_deviation(self) -> float:
        return max((o.deviation for o in self.outcomes), default=math.nan)

    @property
    def static_mean_deviation(self) -> float:
        return self._mean([o.static_deviation for o in self.outcomes])

    @property
    def realized_total(self) -> float:
        return sum(o.realized_cost for o in self.outcomes)

    @property
    def oracle_total(self) -> float:
        return sum(o.oracle_cost for o in self.outcomes)

    @property
    def static_total(self) -> float:
        return sum(o.static_cost for o in self.outcomes)

    def summary(self) -> Dict[str, float]:
        """The machine-readable report (``BENCH_replay.json`` payload)."""
        return {
            "backend": self.backend,
            "decisions": len(self.outcomes),
            "skipped": self.skipped,
            "epochs": len({o.price_epoch for o in self.outcomes}),
            "mean_deviation": self.mean_deviation,
            "max_deviation": self.max_deviation,
            "static_mean_deviation": self.static_mean_deviation,
            "realized_total_usd": self.realized_total,
            "oracle_total_usd": self.oracle_total,
            "static_total_usd": self.static_total,
        }


def dynamic_evaluation(store: ProfilingStore, decisions: Sequence,
                       config_ids: Sequence,
                       base_prices: Mapping,
                       backend: str = "numpy") -> DynamicEvaluation:
    """Judge replayed decisions against per-epoch and static oracles.

    ``decisions`` are duck-typed (``repro_torch.market.replay.ReplayedDecision``
    shaped): each carries ``seq``/``job_id``/``job_class``/``config_id``/
    ``price_epoch`` and the full ``prices`` mapping of its epoch.  Both
    oracles see the *full* runtime/price matrix — no leave-one-out — so
    the deviation measures distance from the true optimum, exactly like
    the paper's static-price evaluation (the selector itself never saw
    its own group's data; the judge may).

    The oracles themselves always run in float64 on the host (they are
    per-decision argmins over a C-vector — there is nothing to
    accelerate); ``backend`` stamps which ranking backend *produced* the
    judged decisions, so the report is self-describing about the
    :class:`repro_torch.selector.ScoreContract` its journal was audited under.
    """
    config_ids = list(config_ids)
    base_vec = np.asarray([base_prices[c] for c in config_ids],
                          dtype=np.float64)
    known_jobs = set(store.job_ids)
    hours_cache: Dict[object, Tuple[np.ndarray, np.ndarray]] = {}
    # decisions of one epoch share one prices mapping (walk() copies per
    # tick), so the vector conversion is paid once per epoch, not per
    # decision
    vec_cache: Dict[int, np.ndarray] = {}
    pos = {c: i for i, c in enumerate(config_ids)}
    outcomes: List[DecisionOutcome] = []
    skipped = 0
    for d in decisions:
        if d.job_id not in known_jobs:
            # a decision for a never-profiled submission (ranked from its
            # class-mates): its realized cost is unknowable from the trace
            skipped += 1
            continue
        row = hours_cache.get(d.job_id)
        if row is None:
            h, m = store.matrix(job_ids=[d.job_id], config_ids=config_ids)
            row = (h[0], m[0])
            hours_cache[d.job_id] = row
        hours, mask = row
        sel = pos.get(d.config_id)
        if sel is None or not mask[sel]:
            skipped += 1
            continue
        live = vec_cache.get(id(d.prices))
        if live is None:
            live = np.asarray([d.prices[c] for c in config_ids],
                              dtype=np.float64)
            vec_cache[id(d.prices)] = live
        cost = np.where(mask, hours * live, np.inf)
        oracle_idx = int(np.argmin(cost))
        static_idx = int(np.argmin(np.where(mask, hours * base_vec,
                                            np.inf)))
        outcomes.append(DecisionOutcome(
            seq=d.seq, job_id=d.job_id, job_class=d.job_class,
            config_id=d.config_id, price_epoch=d.price_epoch,
            realized_cost=float(cost[sel]),
            oracle_config=config_ids[oracle_idx],
            oracle_cost=float(cost[oracle_idx]),
            static_config=config_ids[static_idx],
            static_cost=float(cost[static_idx])))
    return DynamicEvaluation(outcomes=tuple(outcomes), skipped=skipped,
                             backend=backend)


# --- deviation vs turbulence: the dynamic analogue of Fig. 2's x-axis --------

@dataclasses.dataclass(frozen=True)
class TurbulencePoint:
    """One cell of the turbulence sweep: (preset, backend) -> deviation.

    Produced by :func:`repro_torch.market.turbulence.run_point`: a daemon run
    over one adversarial market, its journal audited under the
    backend's :class:`~repro_torch.selector.ScoreContract`, then scored by
    :func:`dynamic_evaluation`.  ``evaluation`` judges decisions
    against the prices the daemon was shown (the journal view);
    ``truth``, when present, re-judges them against the *unlagged*
    market — identical for a zero-latency feed, strictly harsher when
    the preset's ``feed_latency`` delayed the quotes.  A point whose
    ``audit_ok`` is false carries no evidence about the selector (the
    serving path itself diverged) and the bench gates on it.
    """

    preset: str
    level: float
    backend: str
    #: how the daemon got its quotes: "recorded" | "polled" |
    #: "simulated" — identical quote streams must produce identical
    #: curves regardless.
    feed_kind: str
    evaluation: DynamicEvaluation
    truth: Optional[DynamicEvaluation]
    audit_ok: bool
    audit_mismatches: int
    audit_drift: int
    decisions: int
    epochs: int
    feed_errors: int = 0

    @property
    def mean_deviation(self) -> float:
        return self.evaluation.mean_deviation

    @property
    def truth_mean_deviation(self) -> float:
        return self.truth.mean_deviation if self.truth is not None \
            else math.nan

    def summary(self) -> Dict[str, object]:
        """One ``BENCH_turbulence.json`` curve row."""
        out: Dict[str, object] = {
            "preset": self.preset,
            "level": self.level,
            "backend": self.backend,
            "feed_kind": self.feed_kind,
            "audit_ok": self.audit_ok,
            "audit_mismatches": self.audit_mismatches,
            "audit_drift": self.audit_drift,
            "epochs": self.epochs,
            "feed_errors": self.feed_errors,
        }
        out.update(self.evaluation.summary())
        if self.truth is not None:
            out["truth_mean_deviation"] = self.truth.mean_deviation
            out["truth_max_deviation"] = self.truth.max_deviation
        return out


def turbulence_curves(points: Sequence[TurbulencePoint]
                      ) -> Mapping[str, List[TurbulencePoint]]:
    """Group sweep points into per-backend deviation-vs-turbulence
    curves, level-ordered — the dynamic analogue of Fig. 2's per-
    approach lines over the price-ratio axis.  Points that share a
    (backend, level) stay in input order (e.g. a recorded point next
    to its polled twin)."""
    curves: Dict[str, List[TurbulencePoint]] = {}
    for p in points:
        curves.setdefault(p.backend, []).append(p)
    for backend in curves:
        curves[backend].sort(key=lambda p: p.level)
    return curves


def crossover_fraction(trace: Trace, price: costmodel.LinearPriceModel,
                       steps: int = 200) -> float:
    """Misclassification fraction beyond which Fw1C beats two-class Flora."""
    fractions = [i / steps for i in range(steps + 1)]
    curves = fig3_misclassification(trace, price, fractions)
    fw1c = curves["Flora with one class"][0]
    for f, v in zip(fractions, curves["Flora"]):
        if v > fw1c:
            return f
    return 1.0
