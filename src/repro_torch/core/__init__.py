"""Flora core on the port: the paper's contribution (cloud resource
selection) plus the TPU-mesh adaptation, over :mod:`repro_torch.selector`.

Layers:
  trace       -- profiling-trace schema + the paper's evaluation universe
  costmodel   -- per-resource (GCP) and per-chip (TPU) price models
  flora       -- the selector: classify -> rank by normalized class cost
  classification -- automatic job classification from stage profiles
  baselines   -- Fw1C, Juggler, Crispy, static and random baselines
  spark_sim   -- calibrated analytical Spark model regenerating the trace
  evaluate    -- paper §III experiments (Tables III-V, Figs. 2-3) and the
                 dynamic-price evaluation of decision journals
  tpu_flora   -- Flora over TPU mesh configurations (imported on its own:
                 it builds on the selector)
"""
from repro_torch.core.trace import (CloudConfig, ExecutionRecord, GCP_CONFIGS,
                                    JobClass, JobSpec, PAPER_JOBS, Trace)
from repro_torch.core.costmodel import LinearPriceModel, TpuPriceModel

__all__ = [
    "CloudConfig", "ExecutionRecord", "GCP_CONFIGS", "JobClass", "JobSpec",
    "LinearPriceModel", "PAPER_JOBS", "TpuPriceModel", "Trace",
]

#: lazily re-exported so that repro_torch.selector (imported by
#: repro_torch.core.flora) can itself import repro_torch.core.trace /
#: costmodel without a package cycle.
_LAZY = {"Flora", "RankedConfig", "rank_generic"}


def __getattr__(name: str):
    if name in _LAZY:
        from repro_torch.core import flora
        return getattr(flora, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

