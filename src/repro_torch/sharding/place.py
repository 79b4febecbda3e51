"""Weights, batches and checkpoints carried onto a mesh: each rank keeps
its own slice of every whole tensor (the port's counterpart of
``jax.device_put`` with a ``NamedSharding``).

A process is one rank of a :class:`~torch.distributed.device_mesh.
DeviceMesh`; a :class:`~repro_torch.sharding.rules.NamedSharding` names
the tensor's DTensor placements there.  :func:`place` cuts this rank's
slice out of a whole tensor (or numpy array) that every rank holds alike
(DTensor's ``distribute_tensor`` without a collective) and keeps a copy
of it: a dimension split over several mesh axes is cut in mesh order, the
first the major, which is the slice JAX puts on the same device index.  :func:`place_tree` does that
leaf by leaf for a parameter tree (``lm.init_params``'s, ``convert``'s),
:func:`place_batch` for a batch by the rules' ``batch_shardings``, and
:func:`init_placed` draws a model's weights from its seeded generator one
whole leaf at a time on the card, keeps the slice and frees the rest, so
a full-depth model is never whole on one card or on the host and equals
the one-process ``LM(cfg, seed=...)`` leaf for leaf.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.models.types import ParamSpec, SpecTree, map_specs
from repro_torch.sharding.rules import (NamedSharding, batch_shardings,
                                        sharding_for_spec)

__all__ = ["init_placed", "place", "place_batch", "place_on", "place_tree"]


def _tensor(x: Any) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def place(x: Any, sharding: NamedSharding, *,
          device: Optional[torch.device] = None,
          dtype: Optional[torch.dtype] = None):
    """``x`` (whole, the same on every rank) as a DTensor holding this
    rank's slice on ``device`` (default: the mesh's), in ``dtype``."""
    return place_on(x, sharding.mesh, sharding.placements, device=device,
                    dtype=dtype)


def place_on(x: Any, mesh, placements, *,
             device: Optional[torch.device] = None,
             dtype: Optional[torch.dtype] = None):
    """:func:`place` by a mesh and its DTensor placements."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    x = _tensor(x)
    # DTensor's own slicing, with no collective (``src_data_rank=None``:
    # every rank holds ``x``), then a copy of its own: the caller's
    # tensor is not aliased (a replicated slice is ``x`` itself) and the
    # whole may be freed
    local = distribute_tensor(x, mesh, placements,
                              src_data_rank=None).to_local()
    local = local.to(device=device, dtype=dtype or x.dtype, copy=True,
                     memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=x.shape, stride=_contiguous(x.shape))


def _contiguous(shape) -> tuple:
    return torch.empty(shape, device="meta").stride()


def _walk(values: Any, shardings: Any, fn, where: str = "") -> Any:
    if isinstance(shardings, Mapping):
        if set(values) != set(shardings):
            raise ValueError(f"{where or 'tree'}: keys {sorted(values)}, "
                             f"expected {sorted(shardings)}")
        return {k: _walk(values[k], v, fn, f"{where}/{k}")
                for k, v in shardings.items()}
    if isinstance(shardings, (list, tuple)):
        if len(values) != len(shardings):
            raise ValueError(f"{where}: {len(values)} entries, expected "
                             f"{len(shardings)}")
        return [_walk(a, b, fn, f"{where}/{i}")
                for i, (a, b) in enumerate(zip(values, shardings))]
    return fn(values, shardings)


def place_tree(values: Any, shardings: Any, *,
               device: Optional[torch.device] = None) -> Any:
    """A parameter tree (tensors or numpy arrays, whole) placed leaf by
    leaf by the parallel tree of NamedShardings (``tree_shardings``)."""
    return _walk(values, shardings,
                 lambda x, s: place(x, s, device=device))


def place_batch(batch: Mapping[str, Any], rules, mesh, *,
                device: Optional[torch.device] = None
                ) -> Dict[str, Any]:
    """A whole batch (every rank the same) placed by the rules'
    ``batch_shardings``: each rank keeps its rows."""
    batch = {k: _tensor(v) for k, v in batch.items()}
    shardings = batch_shardings(batch, rules, mesh)
    return {k: place(v, shardings[k], device=device)
            for k, v in batch.items()}


def init_placed(specs: SpecTree, rules, mesh, *, seed: int,
                compute_dtype: torch.dtype,
                device: torch.device) -> Any:
    """A model's weights drawn as ``init_params`` draws them (one
    generator seeded with ``seed`` on ``device``, leaves in spec order),
    each leaf placed by ``rules`` on ``mesh`` as soon as it is drawn: only
    this rank's slice is kept."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def leaf(s: ParamSpec):
        whole = s.initialise(gen, compute_dtype, device)
        out = place(whole, sharding_for_spec(s, rules, mesh))
        del whole
        return out
    return map_specs(leaf, specs)
