"""Trace dataset schema for Flora.

A *trace* is the output of the infrastructure-profiling step (Step 0 in the
paper): for every (test job, cluster configuration) pair, the measured
runtime.  The paper's own trace — 18 Spark jobs x 10 GCP configurations =
180 executions — is regenerated offline by
:mod:`repro_torch.core.spark_sim` with the exact job list (Table I) and configuration list (Table II).
"""
from __future__ import annotations

import dataclasses
import enum
import json
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple


class JobClass(enum.Enum):
    """Data-access-pattern classes (paper §II-C)."""

    A = "A"  # repeated specific data loading -> memory-demanding
    B = "B"  # single parallelisable data loading -> memory-yielding

    def flipped(self) -> "JobClass":
        return JobClass.B if self is JobClass.A else JobClass.A


@dataclasses.dataclass(frozen=True)
class CloudConfig:
    """One selectable cluster resource configuration (paper Table II)."""

    index: int                 # 1-based id, as in the paper
    instance_type: str         # e.g. "n2-highmem-8"
    scale_out: int             # number of nodes
    cores_per_node: int
    mem_per_node_gib: float

    @property
    def total_cores(self) -> int:
        return self.scale_out * self.cores_per_node

    @property
    def total_mem_gib(self) -> float:
        return self.scale_out * self.mem_per_node_gib

    @property
    def name(self) -> str:
        return f"#{self.index} {self.instance_type} x{self.scale_out}"


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """A data processing job: algorithm + implementation + input dataset."""

    algorithm: str             # e.g. "Sort"
    data_type: str             # "Text" | "Vector" | "Tabular"
    dataset_gib: float
    job_class: JobClass        # expert ground-truth class (Table I)

    @property
    def name(self) -> str:
        return f"{self.algorithm}/{self.dataset_gib:g}GiB"


@dataclasses.dataclass(frozen=True)
class ExecutionRecord:
    """One profiled execution: job x config -> runtime."""

    job: JobSpec
    config_index: int
    runtime_s: float


class Trace:
    """Profiling trace: runtimes for (job, config) pairs.

    Pure-python container with the access patterns Flora needs: filter by
    class, exclude an algorithm (leave-one-algorithm-out evaluation), look
    up a runtime.
    """

    def __init__(self, configs: Sequence[CloudConfig],
                 records: Iterable[ExecutionRecord]):
        self.configs: List[CloudConfig] = list(configs)
        self.records: List[ExecutionRecord] = list(records)
        self._by_index: Dict[int, CloudConfig] = {c.index: c
                                                  for c in self.configs}
        self._by_key: Dict[Tuple[str, int], float] = {}
        self._jobs: Dict[str, JobSpec] = {}
        for r in self.records:
            self._by_key[(r.job.name, r.config_index)] = r.runtime_s
            self._jobs[r.job.name] = r.job

    # -- basic accessors ---------------------------------------------------
    @property
    def jobs(self) -> List[JobSpec]:
        return list(self._jobs.values())

    def config(self, index: int) -> CloudConfig:
        return self._by_index[index]

    def runtime_s(self, job: JobSpec, config: CloudConfig) -> float:
        return self._by_key[(job.name, config.index)]

    def has(self, job: JobSpec, config: CloudConfig) -> bool:
        return (job.name, config.index) in self._by_key

    # -- filters used by the selector ---------------------------------------
    def filter_jobs(self, *, job_class: Optional[JobClass] = None,
                    exclude_algorithms: Sequence[str] = ()) -> List[JobSpec]:
        out = []
        for j in self.jobs:
            if job_class is not None and j.job_class is not job_class:
                continue
            if j.algorithm in exclude_algorithms:
                continue
            out.append(j)
        return out

    # -- (de)serialisation ---------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "configs": [dataclasses.asdict(c) for c in self.configs],
            "records": [{
                "algorithm": r.job.algorithm,
                "data_type": r.job.data_type,
                "dataset_gib": r.job.dataset_gib,
                "job_class": r.job.job_class.value,
                "config_index": r.config_index,
                "runtime_s": r.runtime_s,
            } for r in self.records],
        }, indent=1)

    @classmethod
    def from_json(cls, text: str) -> "Trace":
        raw = json.loads(text)
        configs = [CloudConfig(**c) for c in raw["configs"]]
        records = []
        for r in raw["records"]:
            job = JobSpec(algorithm=r["algorithm"], data_type=r["data_type"],
                          dataset_gib=r["dataset_gib"],
                          job_class=JobClass(r["job_class"]))
            records.append(ExecutionRecord(job=job,
                                           config_index=r["config_index"],
                                           runtime_s=r["runtime_s"]))
        return cls(configs, records)

    # -- summary statistics (paper Table III) --------------------------------
    def stats(self, hourly_cost: Callable[[CloudConfig], float]) -> Mapping[str, Mapping[str, float]]:
        costs, runtimes = [], []
        for r in self.records:
            c = self.config(r.config_index)
            runtimes.append(r.runtime_s)
            costs.append(r.runtime_s / 3600.0 * hourly_cost(c))
        def describe(xs: List[float]) -> Mapping[str, float]:
            xs = sorted(xs)
            n = len(xs)
            mean = sum(xs) / n
            var = sum((x - mean) ** 2 for x in xs) / (n - 1)
            def q(p: float) -> float:
                # linear-interpolated quantile, matches numpy default
                idx = p * (n - 1)
                lo = int(idx)
                hi = min(lo + 1, n - 1)
                return xs[lo] + (xs[hi] - xs[lo]) * (idx - lo)
            return {"mean": mean, "std": var ** 0.5, "min": xs[0],
                    "25%": q(.25), "50%": q(.5), "75%": q(.75), "max": xs[-1],
                    "count": float(n)}
        return {"cost_usd": describe(costs), "runtime_s": describe(runtimes)}


# --- The paper's evaluation universe (Tables I & II) -------------------------

#: Table II — the ten GCP configurations.
GCP_CONFIGS: Tuple[CloudConfig, ...] = (
    CloudConfig(1, "n2-highcpu-8", 8, 8, 8),
    CloudConfig(2, "n2-standard-8", 8, 8, 32),
    CloudConfig(3, "n2-highmem-8", 8, 8, 64),
    CloudConfig(4, "n2-highmem-4", 4, 4, 32),
    CloudConfig(5, "n2-standard-8", 4, 8, 32),
    CloudConfig(6, "n2-highcpu-32", 4, 32, 32),
    CloudConfig(7, "n2-highmem-8", 2, 8, 64),
    CloudConfig(8, "n2-standard-4", 8, 4, 16),
    CloudConfig(9, "n2-standard-4", 16, 4, 16),
    CloudConfig(10, "n2-highcpu-8", 16, 8, 8),
)

#: Table I — 9 algorithms x 2 dataset sizes, with expert classes.
PAPER_JOBS: Tuple[JobSpec, ...] = (
    JobSpec("Grep", "Text", 3010, JobClass.B),
    JobSpec("Grep", "Text", 6020, JobClass.B),
    JobSpec("Sort", "Text", 94, JobClass.A),
    JobSpec("Sort", "Text", 188, JobClass.A),
    JobSpec("WordCount", "Text", 39, JobClass.B),
    JobSpec("WordCount", "Text", 77, JobClass.B),
    JobSpec("KMeans", "Vector", 102, JobClass.A),
    JobSpec("KMeans", "Vector", 204, JobClass.A),
    JobSpec("LinearRegression", "Vector", 229, JobClass.A),
    JobSpec("LinearRegression", "Vector", 459, JobClass.A),
    JobSpec("LogisticRegression", "Vector", 210, JobClass.A),
    JobSpec("LogisticRegression", "Vector", 420, JobClass.A),
    JobSpec("Join", "Tabular", 85, JobClass.A),
    JobSpec("Join", "Tabular", 172, JobClass.A),
    JobSpec("GroupByCount", "Tabular", 280, JobClass.B),
    JobSpec("GroupByCount", "Tabular", 560, JobClass.B),
    JobSpec("SelectWhereOrderBy", "Tabular", 92, JobClass.B),
    JobSpec("SelectWhereOrderBy", "Tabular", 185, JobClass.B),
)
