"""ProfilingStore: dense (job x config) runtime matrices with persistence.

The store subsumes the two ad-hoc profiling containers the repo grew —
:class:`repro_torch.core.trace.Trace` (GCP, JSON blob) and the
``WorkloadRecord`` lists of the reference package's
``repro.core.tpu_flora`` (TPU, dry-run JSON) — behind one schema:

  * rows are *jobs* (hashable id + optional class + optional group for
    leave-one-group-out evaluation),
  * columns are catalog entry ids,
  * cells are runtime **hours**; missing cells (partial profiling, §II-B)
    are masked, not imputed;
  * inserts are incremental (rows/columns appended on first sight, the
    backing array grows amortized-doubling), so a live profiler can stream
    measurements in;
  * persistence is versioned JSONL — a header line then one record per
    profiled cell — replacing the two incompatible JSON formats.
"""
from __future__ import annotations

import dataclasses
import json
from typing import (Dict, Hashable, Iterable, List, Optional, Sequence,
                    Tuple)

import numpy as np

from repro_torch.core.trace import JobClass, Trace
from repro_torch.obs import MetricsRegistry

JSONL_FORMAT = "repro.selector.profiling-store"
JSONL_VERSION = 1


@dataclasses.dataclass(frozen=True)
class JobMeta:
    """Per-job metadata the selector filters on."""

    job_id: Hashable
    job_class: Optional[JobClass] = None
    #: exclusion group (algorithm / architecture) for the paper's
    #: leave-one-out discipline (§III-A).
    group: Optional[str] = None


class ProfilingStore:
    """Dense runtime-hours matrix over (job, config) with partial masks."""

    def __init__(self, config_ids: Sequence[Hashable] = (),
                 metrics: Optional[MetricsRegistry] = None):
        self._config_ids: List[Hashable] = []
        self._config_pos: Dict[Hashable, int] = {}
        self._job_ids: List[Hashable] = []
        self._job_pos: Dict[Hashable, int] = {}
        self._meta: Dict[Hashable, JobMeta] = {}
        self._hours = np.full((0, 0), np.nan)
        #: mutation counter; consumers (SelectionService) key caches on it
        #: so streamed-in cells invalidate stale rankings.
        self.version = 0
        #: telemetry (DESIGN.md §12); pass a shared registry to export
        #: store counters alongside service/frontend metrics.
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._c_realloc = self.metrics.counter("store.reallocs")
        for c in config_ids:
            self._add_config(c)

    @property
    def realloc_count(self) -> int:
        """Backing-array reallocations; rows and columns both grow by
        amortized doubling, so this stays O(log rows + log cols) —
        asserted by the growth test in tests/test_market.py."""
        return self._c_realloc.value

    # -- growth ------------------------------------------------------------
    def _grown(self, rows: int, cols: int) -> np.ndarray:
        new = np.full((max(rows, 1), max(cols, 1)), np.nan)
        r, c = self._hours.shape
        new[:r, :c] = self._hours
        self._c_realloc.inc()
        return new

    def _add_config(self, config_id: Hashable) -> int:
        pos = self._config_pos.get(config_id)
        if pos is not None:
            return pos
        pos = len(self._config_ids)
        self._config_ids.append(config_id)
        self._config_pos[config_id] = pos
        if pos >= self._hours.shape[1]:
            self._hours = self._grown(self._hours.shape[0],
                                      max(2 * self._hours.shape[1], pos + 1))
        return pos

    def _add_job(self, job_id: Hashable, job_class: Optional[JobClass],
                 group: Optional[str]) -> int:
        pos = self._job_pos.get(job_id)
        if pos is None:
            pos = len(self._job_ids)
            self._job_ids.append(job_id)
            self._job_pos[job_id] = pos
            self._meta[job_id] = JobMeta(job_id, job_class, group)
            if pos >= self._hours.shape[0]:
                self._hours = self._grown(max(2 * self._hours.shape[0],
                                              pos + 1),
                                          self._hours.shape[1])
        elif job_class is not None or group is not None:
            old = self._meta[job_id]
            self._meta[job_id] = JobMeta(
                job_id, job_class if job_class is not None else old.job_class,
                group if group is not None else old.group)
        return pos

    # -- inserts -----------------------------------------------------------
    def add(self, job_id: Hashable, config_id: Hashable,
            runtime_hours: float, *, job_class: Optional[JobClass] = None,
            group: Optional[str] = None) -> None:
        """Record one profiled cell (overwrites re-profiled cells)."""
        if not runtime_hours > 0:
            raise ValueError(
                f"non-positive runtime for {job_id!r} on {config_id!r}")
        r = self._add_job(job_id, job_class, group)
        c = self._add_config(config_id)
        self._hours[r, c] = runtime_hours
        self.version += 1

    # -- accessors ---------------------------------------------------------
    @property
    def config_ids(self) -> List[Hashable]:
        return list(self._config_ids)

    @property
    def job_ids(self) -> List[Hashable]:
        return list(self._job_ids)

    def meta(self, job_id: Hashable) -> JobMeta:
        return self._meta[job_id]

    def has(self, job_id: Hashable, config_id: Hashable) -> bool:
        r = self._job_pos.get(job_id)
        c = self._config_pos.get(config_id)
        return (r is not None and c is not None
                and not np.isnan(self._hours[r, c]))

    def runtime_hours(self, job_id: Hashable, config_id: Hashable) -> float:
        v = self._hours[self._job_pos[job_id], self._config_pos[config_id]]
        if np.isnan(v):
            raise KeyError((job_id, config_id))
        return float(v)

    def __len__(self) -> int:
        """Number of profiled cells."""
        j, c = len(self._job_ids), len(self._config_ids)
        return int(np.count_nonzero(~np.isnan(self._hours[:j, :c])))

    # -- selector-facing views ----------------------------------------------
    def select_jobs(self, *, job_class: Optional[JobClass] = None,
                    exclude_groups: Sequence[str] = ()) -> List[Hashable]:
        """Jobs usable as test jobs for a submission (ordered by insert)."""
        out = []
        for j in self._job_ids:
            m = self._meta[j]
            if job_class is not None and m.job_class is not job_class:
                continue
            if m.group is not None and m.group in exclude_groups:
                continue
            out.append(j)
        return out

    def matrix(self, job_ids: Optional[Sequence[Hashable]] = None,
               config_ids: Optional[Sequence[Hashable]] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(runtime-hours, profiled-mask) matrices, rows/cols as requested.

        Unprofiled cells hold ``nan`` in the hours matrix and ``False`` in
        the mask; callers must never read an unmasked ``nan``.
        """
        jobs = self._job_ids if job_ids is None else list(job_ids)
        cfgs = self._config_ids if config_ids is None else list(config_ids)
        rows = [self._job_pos[j] for j in jobs]
        cols = [self._config_pos.get(c, -1) for c in cfgs]
        hours = np.full((len(rows), len(cols)), np.nan)
        known = [i for i, c in enumerate(cols) if c >= 0]
        if rows and known:
            sub = self._hours[np.ix_(rows, [cols[i] for i in known])]
            hours[:, known] = sub
        mask = ~np.isnan(hours)
        return hours, mask

    # -- versioned JSONL persistence -----------------------------------------
    def dump_jsonl(self) -> str:
        header = {"format": JSONL_FORMAT, "version": JSONL_VERSION,
                  "config_ids": self._config_ids}
        lines = [json.dumps(header)]
        j, c = len(self._job_ids), len(self._config_ids)
        for r in range(j):
            meta = self._meta[self._job_ids[r]]
            for k in range(c):
                v = self._hours[r, k]
                if np.isnan(v):
                    continue
                lines.append(json.dumps({
                    "job": self._job_ids[r],
                    "config": self._config_ids[k],
                    "runtime_hours": float(v),
                    "job_class": (meta.job_class.value
                                  if meta.job_class else None),
                    "group": meta.group,
                }))
        return "\n".join(lines) + "\n"

    def save_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.dump_jsonl())

    @classmethod
    def loads_jsonl(cls, text: str) -> "ProfilingStore":
        lines = [ln for ln in text.splitlines() if ln.strip()]
        if not lines:
            raise ValueError("empty profiling store file")
        header = json.loads(lines[0])
        if header.get("format") != JSONL_FORMAT:
            raise ValueError(f"not a profiling store: {header!r}")
        if header.get("version") != JSONL_VERSION:
            raise ValueError(
                f"unsupported store version {header.get('version')!r}")
        store = cls(config_ids=header.get("config_ids", ()))
        for ln in lines[1:]:
            rec = json.loads(ln)
            klass = (JobClass(rec["job_class"])
                     if rec.get("job_class") else None)
            store.add(rec["job"], rec["config"], rec["runtime_hours"],
                      job_class=klass, group=rec.get("group"))
        return store

    @classmethod
    def load_jsonl(cls, path: str) -> "ProfilingStore":
        with open(path) as f:
            return cls.loads_jsonl(f.read())

    # -- converters from the legacy containers --------------------------------
    @classmethod
    def from_trace(cls, trace: Trace) -> "ProfilingStore":
        """Adapt a GCP :class:`Trace` (runtime seconds -> hours)."""
        store = cls(config_ids=[c.index for c in trace.configs])
        for r in trace.records:
            store.add(r.job.name, r.config_index, r.runtime_s / 3600.0,
                      job_class=r.job.job_class, group=r.job.algorithm)
        return store

    @classmethod
    def from_workload_records(cls, records: Iterable,
                              config_ids: Sequence[Hashable] = ()
                              ) -> "ProfilingStore":
        """Adapt TPU ``WorkloadRecord`` lists (step seconds x steps)."""
        store = cls(config_ids=config_ids)
        for r in records:
            store.add(r.job_id, r.mesh, r.step_seconds * r.steps / 3600.0,
                      job_class=r.job_class, group=r.arch)
        return store
