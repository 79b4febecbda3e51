"""Automatic job classification (the paper's §V future work).

The paper assigns classes by user annotation and sketches automating it
via "static code analysis and minimal profiling".  This module implements
the minimal-profiling half: given a :class:`JobProfile` (obtainable from a
tiny sample run or static inspection of the job's operators), apply the
paper's §II-C decision rule:

  class A (memory-demanding)  — repeated/specific data loading: the job
      re-reads a cached working set (iterations > 1) or does random access
      over a non-negligible fraction of the input;
  class B (memory-yielding)   — single parallelisable loading: at most a
      few sequential passes and a small retained working set.

Multi-stage jobs are classified by their most significant stage, and the
module reports when *splitting* stages would be advisable (the paper's
select-where-order-by discussion).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.trace import JobClass


@dataclasses.dataclass(frozen=True)
class StageProfile:
    """One stage's data-access characteristics."""

    name: str
    passes_over_input: float     # how often the stage reads its input
    retained_fraction: float     # working set it keeps resident / input
    random_access: bool = False  # state-dependent sample access
    weight: float = 1.0          # share of the job's work in this stage


@dataclasses.dataclass(frozen=True)
class JobProfile:
    algorithm: str
    stages: Tuple[StageProfile, ...]


#: thresholds of the §II-C rule
RETAINED_THRESHOLD = 0.25   # "non-negligibly small" working set
PASSES_THRESHOLD = 2.0      # "at most a few" sequential passes


def classify_stage(s: StageProfile) -> JobClass:
    if s.random_access and s.retained_fraction >= RETAINED_THRESHOLD:
        return JobClass.A
    if s.passes_over_input > PASSES_THRESHOLD \
            and s.retained_fraction >= RETAINED_THRESHOLD:
        return JobClass.A
    return JobClass.B


@dataclasses.dataclass(frozen=True)
class Classification:
    job_class: JobClass
    per_stage: Tuple[Tuple[str, JobClass], ...]
    advise_split: bool           # stages disagree and both are significant

    @property
    def confident(self) -> bool:
        return not self.advise_split


def classify(profile: JobProfile) -> Classification:
    per_stage = tuple((s.name, classify_stage(s)) for s in profile.stages)
    # most significant stage decides (paper: "categorized based on their
    # most significant stage")
    top = max(profile.stages, key=lambda s: s.weight)
    job_class = classify_stage(top)
    significant = [s for s in profile.stages if s.weight >= 0.25]
    classes = {classify_stage(s) for s in significant}
    return Classification(job_class=job_class, per_stage=per_stage,
                          advise_split=len(classes) > 1)


# --- profiles of the paper's test-job algorithms (from spark_sim params) -----

def profile_from_algo(algorithm: str) -> JobProfile:
    """Derive a JobProfile from the simulator's workload parameters — the
    'minimal profiling' stand-in: a sample run measures exactly these."""
    from repro_torch.core.spark_sim import ALGO_PARAMS
    p = ALGO_PARAMS[algorithm]
    stages: List[StageProfile] = [StageProfile(
        name="main", passes_over_input=float(p.iters),
        retained_fraction=p.kappa,
        random_access=(p.storage == "mem" and p.iters > 1),
    )]
    # sort-like second stage for jobs that shuffle heavily with retention
    if p.shuffle >= 1.0 and p.kappa > 0:
        stages = [
            StageProfile("scan", 1.0, 0.0, weight=1.0 - min(p.kappa, 0.9)),
            StageProfile("sort", 2.0, min(p.kappa, 1.0), random_access=True,
                         weight=min(p.kappa, 0.9)),
        ]
    return JobProfile(algorithm=algorithm, stages=tuple(stages))


def auto_class(algorithm: str) -> JobClass:
    return classify(profile_from_algo(algorithm)).job_class
