"""Int8 error-feedback gradient compression for the data-parallel
all-reduce (counterpart of ``repro/train/compression.py``).

Gradients are quantised to int8 with one scale a tensor, and the
quantisation residual is fed back into the next step (error feedback
keeps convergence; Karimireddy et al., 2019).  :class:`ErrorFeedback`
carries the residual; on a mesh each rank keeps its own, shaped like its
local part of each gradient.

:func:`compressed_psum` is the int8 all-reduce over a process group: the
ranks first agree on one scale (an all-reduce with MAX of each rank's
largest magnitude), quantise their partial sums with it, all-gather the
int8 payloads and sum them in int32, and rescale.  Each element is then
within ``n * scale / 2`` of the exact sum over ``n`` ranks.  (The
reference quantises each rank's partial sum with its own scale and
rescales the int32 sum by the largest: a rank with a smaller scale is
counted too large, ROADMAP.md §C entry 11.)  The payload is int8 on the
wire: ``n - 1`` bytes an element reach each rank, against about 8 for a
ring all-reduce of int32, so it is the cheaper at the few ranks of a
data axis here, and the dearer past about eight.

:func:`make_compressed_allreduce` applies it to the gradients of the
sharded train step, which hands them over before the data-axis reduction
(``make_train_step(..., compress_fn=)``): a DTensor gradient that is a
partial sum over the named mesh axes is reduced over their process group
and comes back replicated there; one that is not (already reduced, or a
parameter the batch split does not touch) is the gradient already and
comes back as it is; a plain tensor is taken as this rank's partial sum.
(The reference's gives every leaf the spec ``P()`` and sums the copies
that jit has already reduced, ``n_data`` times the gradient, ROADMAP.md
§C entry 14.)
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence, Tuple

import torch

__all__ = ["ErrorFeedback", "compressed_psum", "dequantise",
           "make_compressed_allreduce", "quantise_int8"]

Tensors = Dict[str, torch.Tensor]


def quantise_int8(x: torch.Tensor, scale: torch.Tensor = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantisation (with ``scale`` given, at
    that scale).  Returns (q, scale)."""
    x32 = x.float()
    if scale is None:
        scale = torch.clamp_min(x32.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantise(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The float32 sum of every rank's ``x`` over ``group`` (default: the
    world), int8 on the wire (see the module's note)."""
    import torch.distributed as dist
    scale = torch.clamp_min(x.float().abs().max(), 1e-12) / 127.0
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    q, _ = quantise_int8(x, scale)
    n = dist.get_world_size(group)
    parts = torch.empty(n * q.numel(), dtype=torch.int8, device=q.device)
    dist.all_gather_into_tensor(parts, q.reshape(-1), group=group)
    total = parts.view((n,) + tuple(q.shape)).to(torch.int32).sum(0)
    return total.float() * scale


def make_compressed_allreduce(mesh, axis_names: Sequence[str] = ("data",)
                              ) -> Callable[[Tensors], Tensors]:
    """The train step's ``compress_fn`` on ``mesh``: each gradient's
    partial sums over ``axis_names`` reduced by :func:`compressed_psum`
    over their process group (see the module's note)."""
    from torch.distributed.tensor import DTensor, Replicate
    names = list(mesh.mesh_dim_names)
    missing = [a for a in axis_names if a not in names]
    if missing or not axis_names:
        raise ValueError(f"axes {list(axis_names)} are not all axes of the "
                         f"mesh {names}")
    dims = sorted(names.index(a) for a in axis_names)
    group = mesh.get_group(dims[0]) if len(dims) == 1 else \
        mesh[tuple(names[i] for i in dims)]._flatten().get_group()

    def reduce(g: torch.Tensor) -> torch.Tensor:
        if not isinstance(g, DTensor):
            return compressed_psum(g, group)
        partial = [i for i in dims if g.placements[i].is_partial()]
        if not partial:
            return g
        if partial != dims:
            raise ValueError(f"a gradient partial over {partial} of the "
                             f"mesh axes {dims}: compress all or none")
        local = compressed_psum(g.to_local(), group).to(g.dtype)
        return DTensor.from_local(
            local, g.device_mesh, [Replicate() if i in dims else p
                                   for i, p in enumerate(g.placements)],
            run_check=False, shape=g.shape, stride=g.stride())

    return lambda grads: {k: reduce(g) for k, g in grads.items()}


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if hasattr(t, "to_local") else t


@dataclasses.dataclass
class ErrorFeedback:
    """Residual state + compress step (the state is a dict shaped like the
    gradients' local parts: one residual a rank)."""

    def init(self, grads_template: Tensors) -> Tensors:
        return {k: torch.zeros(_local(g).shape, dtype=torch.float32,
                               device=_local(g).device)
                for k, g in grads_template.items()}

    def compress(self, grads: Tensors, residual: Tensors
                 ) -> Tuple[Tensors, Tensors]:
        """Quantise (grads + residual), each rank its local part; return
        (dequantised, new residual)."""
        from torch.distributed.tensor import DTensor
        deq, res = {}, {}
        for k, g in grads.items():
            x = _local(g).float() + residual[k]
            d = dequantise(*quantise_int8(x))
            res[k] = x - d
            d = d.to(g.dtype)
            deq[k] = DTensor.from_local(
                d, g.device_mesh, g.placements, run_check=False,
                shape=g.shape, stride=g.stride()) \
                if isinstance(g, DTensor) else d
        return deq, res
