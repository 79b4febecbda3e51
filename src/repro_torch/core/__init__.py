"""Flora core, as far as the selection path needs it: the profiling-trace
schema (:mod:`~repro_torch.core.trace`) and the price models
(:mod:`~repro_torch.core.costmodel`).  The paper's selector, baselines,
Spark model and experiments live in the reference package ``repro.core``
and are not ported yet.
"""
from repro_torch.core.trace import (CloudConfig, ExecutionRecord, GCP_CONFIGS,
                                    JobClass, JobSpec, PAPER_JOBS, Trace)
from repro_torch.core.costmodel import LinearPriceModel, TpuPriceModel

__all__ = [
    "CloudConfig", "ExecutionRecord", "GCP_CONFIGS", "JobClass", "JobSpec",
    "LinearPriceModel", "PAPER_JOBS", "TpuPriceModel", "Trace",
]
