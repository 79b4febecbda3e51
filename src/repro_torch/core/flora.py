"""Flora — the paper's selector (§II), as an adapter over repro_torch.selector.

Given (i) an infrastructure-profiling trace, (ii) the submitted job's class
annotation, and (iii) *current* hourly prices, rank every cluster
configuration by the sum of per-test-job-normalized predicted costs and
pick the argmin:

    c* = argmin_c  sum_{j in P_K}  cost(j, c) / min_{c'} cost(j, c')
    cost(j, c) = runtime_in_hours(j, c) * current_hourly_cost(c)

The ranking math, profiling storage and caching live in
:mod:`repro_torch.selector` (catalog / store / rank / service); this module keeps
the paper-faithful GCP-VM entry point and the historical ``rank_generic``
signature as a thin shim over the vectorized :func:`repro_torch.selector.rank.rank_pairs`.
"""
from __future__ import annotations

from typing import (Callable, Hashable, List, Mapping, Optional, Sequence,
                    Tuple)

from repro_torch.core import costmodel
from repro_torch.core.trace import CloudConfig, JobClass, JobSpec, Trace
from repro_torch.selector import (GcpVmCatalog, ProfilingStore,
                                  RankedConfig, SelectionService, rank_pairs)

__all__ = ["Flora", "RankedConfig", "rank_generic"]


def rank_generic(
    runtime_hours: Mapping[Tuple[Hashable, Hashable], float],
    jobs: Sequence[Hashable],
    config_ids: Sequence[Hashable],
    hourly_cost: Callable[[Hashable], float],
) -> List[RankedConfig]:
    """Rank configurations by summed normalized cost over ``jobs``.

    .. deprecated:: use :func:`repro_torch.selector.rank.rank_pairs` (sparse) or
       :func:`repro_torch.selector.rank.rank_dense` (dense matrices) directly.
       This shim densifies and delegates; configurations with no profiled
       entries rank last (score ``+inf``), they no longer win at 0.0.
    """
    return rank_pairs(runtime_hours, jobs, config_ids, hourly_cost)


class Flora:
    """The paper's approach: classify, then rank by class-mates' costs."""

    def __init__(self, trace: Trace,
                 price: costmodel.LinearPriceModel,
                 *, one_class: bool = False):
        """``one_class=True`` gives the Fw1C baseline (skip Step 1)."""
        self.trace = trace
        self.price = price
        self.one_class = one_class
        # the paper-table reproduction is definitionally the float64
        # bit-stable contract (legacy dict-loop parity at 1e-12), so the
        # adapter pins numpy (which needs no card: the service's device
        # applies to the fleet backend only)
        self.service = SelectionService(
            GcpVmCatalog(trace.configs, price),
            ProfilingStore.from_trace(trace), price, backend="numpy")

    # -- Step 2: ranking ------------------------------------------------------
    def rank(self, annotated_class: JobClass,
             exclude_algorithms: Sequence[str] = ()) -> List[RankedConfig]:
        job_class = None if self.one_class else annotated_class
        return list(self.service.rank(job_class=job_class,
                                      exclude_groups=tuple(exclude_algorithms)))

    def select(self, annotated_class: JobClass,
               exclude_algorithms: Sequence[str] = ()) -> CloudConfig:
        ranked = self.rank(annotated_class, exclude_algorithms)
        return self.trace.config(ranked[0].config_id)

    # -- convenience: full pipeline for a submitted job -----------------------
    def select_for_job(self, job: JobSpec, *,
                       annotated_class: Optional[JobClass] = None,
                       assume_unique: bool = True) -> CloudConfig:
        """Select a config for ``job``.

        ``annotated_class`` models the user annotation of Step 1; defaults
        to the expert class.  ``assume_unique`` enforces the paper's
        leave-one-algorithm-out discipline: profiling data from the same
        underlying algorithm is never used for the job itself (§III-A).
        """
        klass = annotated_class if annotated_class is not None else job.job_class
        exclude = (job.algorithm,) if assume_unique else ()
        return self.select(klass, exclude_algorithms=exclude)
