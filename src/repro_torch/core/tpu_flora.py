"""Flora over TPU mesh configurations — the framework integration
(counterpart of ``repro/core/tpu_flora.py``).

A *cloud configuration* is a :class:`MeshOption` (a TPU slice and its mesh
split); a *test job* is an (architecture x input shape) workload whose
runtime is the roofline step time of a dry-run report; decode and
long-context serving are class A (state-resident), training and prefill
class B (streaming compute).  Selection runs through the port's own
:class:`~repro_torch.selector.SelectionService` over a
:class:`~repro_torch.selector.TpuSliceCatalog`.  The LM serving engine
plans its decode fleet's mesh through :func:`service_from_dryrun_report`
(:func:`repro_torch.serve.engine.plan_decode_placement`).

The service is on the card unless the caller asks otherwise: the default
backend is ``"torch_fused"`` on ``device="cuda"``; :class:`TpuFlora`
keeps the reference's float64 ``"numpy"`` backend.
"""
from __future__ import annotations

import dataclasses
import re
from typing import List, Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.costmodel import TpuPriceModel
from repro_torch.core.trace import JobClass
from repro_torch.selector import (ProfilingStore, RankedConfig,
                                  SelectionService, TpuSliceCatalog)

__all__ = ["MeshOption", "SHAPE_CLASSES", "TpuFlora", "WorkloadRecord",
           "classify_workload", "make_service",
           "records_from_dryrun_report", "service_from_dryrun_report"]


@dataclasses.dataclass(frozen=True)
class MeshOption:
    """One selectable TPU deployment: slice size x mesh split."""

    name: str               # e.g. "v5e-256 dp16xtp16"
    generation: str         # "v5e" | "v5p"
    chips: int
    mesh_shape: Tuple[int, ...]
    mesh_axes: Tuple[str, ...]

    def hourly_cost(self, price: TpuPriceModel) -> float:
        return price.slice_hour(self.generation, self.chips)


#: Which shapes belong to which class (user-overridable, like the paper's
#: user annotation step).
SHAPE_CLASSES: Mapping[str, JobClass] = {
    "train_4k": JobClass.B,      # streaming compute: FLOP-bound
    "prefill_32k": JobClass.B,   # streaming compute: FLOP-bound
    "decode_32k": JobClass.A,    # state-resident: KV-cache bandwidth-bound
    "long_500k": JobClass.A,     # state-resident: long-context decode
}


def classify_workload(shape_name: str,
                      annotation: Optional[JobClass] = None) -> JobClass:
    """Step 1 — classification.  ``annotation`` models the user label."""
    if annotation is not None:
        return annotation
    return SHAPE_CLASSES[shape_name]


@dataclasses.dataclass(frozen=True)
class WorkloadRecord:
    """One profiled cell: (arch, shape) on a mesh option -> step seconds."""

    arch: str
    shape: str
    mesh: str
    step_seconds: float
    steps: int = 1

    @property
    def job_id(self) -> str:
        return f"{self.arch}:{self.shape}"

    @property
    def job_class(self) -> JobClass:
        return SHAPE_CLASSES[self.shape]


def make_service(options: Sequence[MeshOption],
                 records: Sequence[WorkloadRecord],
                 price: TpuPriceModel, backend: Optional[str] = None, *,
                 device: Union[str, torch.device] = "cuda"
                 ) -> SelectionService:
    """Wire catalog + store + price into a TPU-side selection service
    (``backend=None``: the port's default, ``"torch_fused"`` on
    ``device``)."""
    return SelectionService(
        TpuSliceCatalog(options, price),
        ProfilingStore.from_workload_records(
            records, config_ids=[o.name for o in options]),
        price, classifier=lambda shape: classify_workload(str(shape)),
        backend=backend, device=device)


class TpuFlora:
    """Flora Steps 0-2 over TPU mesh options (adapter over the service)."""

    def __init__(self, options: Sequence[MeshOption],
                 records: Sequence[WorkloadRecord],
                 price: TpuPriceModel, *, one_class: bool = False):
        self.options = list(options)
        self.records = list(records)
        self.price = price
        self.one_class = one_class
        self._by_name = {o.name: o for o in self.options}
        # paper-faithful adapter: pinned to the float64 bit-stable backend
        self.service = make_service(self.options, self.records, price,
                                    backend="numpy")

    def rank(self, job_class: JobClass,
             exclude_archs: Sequence[str] = ()) -> List[RankedConfig]:
        klass = None if self.one_class else job_class
        return list(self.service.rank(job_class=klass,
                                      exclude_groups=tuple(exclude_archs)))

    def select(self, shape_name: str, *,
               annotation: Optional[JobClass] = None,
               exclude_archs: Sequence[str] = ()) -> MeshOption:
        """Full pipeline for a submitted (new) workload; the submitted
        architecture's own profiling data is excluded by
        ``exclude_archs``."""
        decision = self.service.submit(
            shape_name,
            annotation=annotation if not self.one_class else None,
            exclude_groups=tuple(exclude_archs),
            one_class=self.one_class)
        return self._by_name[decision.config_id]


# --- trace I/O ------------------------------------------------------------------

def records_from_dryrun_report(report: Mapping) -> List[WorkloadRecord]:
    """Convert a dry-run JSON report into profiling records: the roofline
    step time is ``max(compute, memory, collective)`` seconds per step;
    failed cells are dropped."""
    out = []
    for cell in report.get("cells", []):
        if not cell.get("ok"):
            continue
        roof = cell["roofline"]
        step = max(roof["compute_s"], roof["memory_s"], roof["collective_s"])
        out.append(WorkloadRecord(arch=cell["arch"], shape=cell["shape"],
                                  mesh=cell["mesh"], step_seconds=step))
    return out


def _mesh_topology(name: str, chips: int) -> Tuple[Tuple[int, ...],
                                                   Tuple[str, ...]]:
    """(shape, axes) from a ``dp{N}xtp{M}`` mesh name; a pure
    data-parallel topology for other names."""
    m = re.fullmatch(r"dp(\d+)xtp(\d+)", name)
    if m:
        return (int(m.group(1)), int(m.group(2))), ("data", "model")
    return (chips,), ("data",)


def service_from_dryrun_report(report: Mapping, price: TpuPriceModel,
                               *, generation: str = "v5e", chips: int = 256,
                               backend: Optional[str] = None,
                               device: Union[str, torch.device] = "cuda"
                               ) -> SelectionService:
    """One-call bridge: dry-run JSON -> catalog + store -> service, with
    one mesh option per mesh name in the report."""
    recs = records_from_dryrun_report(report)
    meshes = sorted({r.mesh for r in recs})
    options = [MeshOption(m, generation, chips, *_mesh_topology(m, chips))
               for m in meshes]
    return make_service(options, recs, price, backend, device=device)
