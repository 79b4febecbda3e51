"""Sharding context: logical activation constraints inside model code (the
port's own copy of ``repro/sharding/ctx.py``).

The model annotates activations with *logical* axes, and a thread-local
(rules, mesh) context resolves them to placements on a
:class:`~torch.distributed.device_mesh.DeviceMesh`.  Without a context
(one card, CPU tests) an annotation returns its input.  With one, a
DTensor is redistributed to the resolved placements, and so is its
gradient (as a sharding constraint binds the cotangent in JAX); a plain
tensor is returned as it is only on a one-device mesh, and anything else
raises (an annotation is never dropped without a word).  DTensor picks
each op's sharding greedily, op by op, so without these annotations it
drifts (weights' splits pushed into activations, a free split of a
replicated product's output that a later ``unflatten`` cannot take); they
hold the activations where the reference's rules put them.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence

import torch

__all__ = ["constrain", "constrain_merged", "current", "use"]

_TLS = threading.local()


def current():
    return getattr(_TLS, "ctx", None)


@contextlib.contextmanager
def use(rules, mesh):
    old = current()
    _TLS.ctx = (rules, mesh)
    try:
        yield
    finally:
        _TLS.ctx = old


def constrain(x: torch.Tensor, axes: Sequence[Optional[str]]
              ) -> torch.Tensor:
    """Annotate activation ``x`` with logical axes (no-op without
    context; see the module's note)."""
    ctx = current()
    if ctx is None:
        return x
    rules, mesh = ctx
    from repro_torch.sharding.rules import spec_for
    spec = spec_for(tuple(x.shape), tuple(axes), rules, mesh)
    return _place(x, list(spec), rules, mesh)


def _place(x: torch.Tensor, entries, rules, mesh) -> torch.Tensor:
    """``x`` redistributed to the spec ``entries`` (see the module's
    note on plain tensors)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.sharding.rules import (PartitionSpec, mesh_sizes,
                                            placements_for)
    if not isinstance(x, DTensor):
        if math.prod(mesh_sizes(mesh).values()) == 1:
            return x
        raise TypeError(f"constrain got a plain tensor of shape "
                        f"{tuple(x.shape)} under a mesh of "
                        f"{mesh_sizes(mesh)}: place it as a DTensor first")
    return _Placed.apply(x, placements_for(PartitionSpec(*entries), mesh))


class _Placed(torch.autograd.Function):
    """``x`` redistributed to ``placements``, and its gradient too (as a
    sharding constraint binds the cotangent in JAX; DTensor's own
    ``redistribute`` sends a gradient back to the input's placements)."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(grad.device_mesh, ctx.placements), None


def constrain_merged(x: torch.Tensor, axes: Sequence[Optional[str]],
                     sizes: Sequence[int], dim: int = -1) -> torch.Tensor:
    """Annotate ``x`` whose dimension ``dim`` merges ``len(sizes)``
    dimensions of these ``sizes``; ``axes`` names every dimension with
    the merged ones unmerged (a projection to ``(heads, head_dim)`` before
    its ``unflatten``, or a weight ``(heads, head_dim, embed)`` viewed as
    a matrix).  The merged dimension is split as its first part is when
    no later part is split (whole heads a device), else kept whole: a
    split inside a later part does not survive the ``unflatten`` (nor the
    gradient's).  No-op without context."""
    ctx = current()
    if ctx is None:
        return x
    from repro_torch.sharding.rules import spec_for
    rules, mesh = ctx
    dim = dim % x.dim()
    k = len(sizes)
    shape = tuple(x.shape[:dim]) + tuple(sizes) + tuple(x.shape[dim + 1:])
    spec = spec_for(shape, tuple(axes), rules, mesh)
    entries = list(spec) + [None] * (len(axes) - len(spec))
    inner = entries[dim:dim + k]
    merged = inner[0] if all(e is None for e in inner[1:]) else None
    return _place(x, entries[:dim] + [merged] + entries[dim + k:], rules,
                  mesh)
