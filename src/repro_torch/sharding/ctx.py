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

One context for the sharded program: :func:`spmd`, which both the dry
run's count (:func:`repro_torch.launch.roofline.count`) and the sharded
train step (:func:`repro_torch.train.train_loop.make_train_step`) enter,
so the dry run counts the program the ranks run, where DTensor plans the
step as it does on the dry run's meta mesh: a host of
``launch.dryrun.CARDS_PER_HOST`` devices (DTensor's cost model reads the
devices per host) and an all-to-all run as one collective (DTensor runs
it as an all-gather and a chunk on a CPU mesh).  Other cards per host,
or another torch, may plan other collectives.  Inside it a
plain tensor beside DTensors is taken as replicated
(``implicit_replication``): the RoPE tables and positions, the loss's
vocabulary positions and constants are the same on every rank, drawn
from ``arange`` and the config, so they stay plain rather than being
placed by hand in each of those places.  Anything that differs by rank
(a batch, a gradient) must arrive placed.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence

import torch

__all__ = ["constrain", "constrain_merged", "current", "placed",
           "remat_contexts", "spmd", "use"]

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


@contextlib.contextmanager
def spmd():
    """The sharded program's context (see the module's note): plain
    tensors beside DTensors are taken as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication():
        yield


def _in_spmd() -> bool:
    from torch.distributed.tensor import DTensor
    return bool(DTensor._op_dispatcher._allow_implicit_replication)


def remat_contexts():
    """``torch.utils.checkpoint``'s ``context_fn``: the recompute of a
    checkpointed layer runs under the sharding context (and :func:`spmd`)
    its forward ran under.  On a card autograd runs the backward, and so
    the recompute, on its own device thread, where this module's
    thread-local context is not set: the recompute's annotations would
    do nothing there, and its activations would be placed otherwise than
    the forward's (a DTensor MoE layer's local experts, for one)."""
    ctx, implicit = current(), current() is not None and _in_spmd()

    @contextlib.contextmanager
    def recompute():
        if ctx is None:
            yield
            return
        with use(*ctx), (spmd() if implicit else contextlib.nullcontext()):
            yield
    return contextlib.nullcontext(), recompute()


def constrain(x: torch.Tensor, axes: Sequence[Optional[str]], *,
              weight: bool = False) -> torch.Tensor:
    """Annotate activation ``x`` with logical axes (no-op without
    context; see the module's note).  A ``weight``'s gradient keeps its
    partial sums (see :func:`placed`)."""
    ctx = current()
    if ctx is None:
        return x
    rules, mesh = ctx
    from repro_torch.sharding.rules import spec_for
    spec = spec_for(tuple(x.shape), tuple(axes), rules, mesh)
    return _place(x, list(spec), rules, mesh, weight)


def _place(x: torch.Tensor, entries, rules, mesh, weight: bool
           ) -> torch.Tensor:
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
    return placed(x, placements_for(PartitionSpec(*entries), mesh),
                  weight=weight)


def placed(x, placements, *, weight: bool = False):
    """DTensor ``x`` redistributed to ``placements``, and its gradient too
    (as a sharding constraint binds the cotangent in JAX).  A ``weight``'s
    gradient keeps the mesh axes on which it is a partial sum (the
    batch's): a parameter's gradient is reduced once, onto the
    parameter's placements, by the train step (or handed to its
    ``compress_fn`` before that)."""
    return _Placed.apply(x, tuple(placements), weight)


class _Placed(torch.autograd.Function):
    """``x`` redistributed to ``placements``, and its gradient too (see
    :func:`placed`; DTensor's own ``redistribute`` sends a gradient back
    to the input's placements)."""

    @staticmethod
    def forward(ctx, x, placements, weight):
        ctx.placements, ctx.weight = placements, weight
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        placements = ctx.placements
        if ctx.weight:
            placements = [g if g.is_partial() else p
                          for g, p in zip(grad.placements, placements)]
        return grad.redistribute(grad.device_mesh, placements), None, None


def constrain_merged(x: torch.Tensor, axes: Sequence[Optional[str]],
                     sizes: Sequence[int], dim: int = -1, *,
                     weight: bool = False) -> torch.Tensor:
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
                  mesh, weight)
