"""Flora core, as far as the selection and serving paths need it: the
profiling-trace schema (:mod:`~repro_torch.core.trace`), the price models
(:mod:`~repro_torch.core.costmodel`) and Flora over TPU mesh options
(:mod:`~repro_torch.core.tpu_flora`, imported on its own: it builds on
the selector).  The paper's selector, baselines, Spark model and
experiments live in the reference package ``repro.core`` and are not
ported yet.
"""
from repro_torch.core.trace import (CloudConfig, ExecutionRecord, GCP_CONFIGS,
                                    JobClass, JobSpec, PAPER_JOBS, Trace)
from repro_torch.core.costmodel import LinearPriceModel, TpuPriceModel

__all__ = [
    "CloudConfig", "ExecutionRecord", "GCP_CONFIGS", "JobClass", "JobSpec",
    "LinearPriceModel", "PAPER_JOBS", "TpuPriceModel", "Trace",
]
