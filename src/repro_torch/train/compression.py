"""Int8 error-feedback gradient compression (counterpart of
``repro/train/compression.py``).

Gradients are quantised to int8 with one scale a tensor, and the
quantisation residual is fed back into the next step (error feedback
keeps convergence; Karimireddy et al., 2019).  :class:`ErrorFeedback`
carries the residual and works in one process.  The reference's
``compressed_psum`` and ``make_compressed_allreduce`` (the int8 all-reduce
over a ``shard_map`` mesh) wait for the port's sharding slice (ROADMAP.md
§A).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

__all__ = ["ErrorFeedback", "dequantise", "quantise_int8"]

Tensors = Dict[str, torch.Tensor]


def quantise_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantisation.  Returns (q, scale)."""
    x32 = x.float()
    scale = torch.clamp_min(x32.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantise(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


@dataclasses.dataclass
class ErrorFeedback:
    """Residual state + compress step (the state is a dict shaped like the
    gradients)."""

    def init(self, grads_template: Tensors) -> Tensors:
        return {k: torch.zeros(g.shape, dtype=torch.float32,
                               device=g.device)
                for k, g in grads_template.items()}

    def compress(self, grads: Tensors, residual: Tensors
                 ) -> Tuple[Tensors, Tensors]:
        """Quantise (grads + residual); return (dequantised, new
        residual)."""
        deq, res = {}, {}
        for k, g in grads.items():
            x = g.float() + residual[k]
            d = dequantise(*quantise_int8(x))
            deq[k], res[k] = d.to(g.dtype), x - d
        return deq, res
