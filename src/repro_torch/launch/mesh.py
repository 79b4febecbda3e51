"""Mesh construction for the production deployment (the port's own copy
of ``repro/launch/mesh.py``).

``make_production_mesh`` is a FUNCTION (not module state) so importing this
module never touches ``torch.distributed``.  The single-pod mesh is 16x16 =
256 devices; multi-pod adds a leading 2-pod axis = 512.  A mesh is a
:class:`~torch.distributed.device_mesh.DeviceMesh` over the ranks of the
process group, which must be open: ``torchrun`` (or
``init_process_group``) on cards, one rank a card, or :func:`fake_world`
for the dry run, which traces on the CPU over ranks that hold nothing.

``mesh_options`` enumerates alternative splits of the same devices — the
"scale-out vs scale-up" dimension of the paper mapped onto SPMD: at fixed
device count, how the (data, model) axes divide determines whether a
workload gets DP bandwidth or TP memory headroom.  These options are the
mesh selector's configuration space (:mod:`repro_torch.core.tpu_flora`).
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, List, Tuple

import torch

__all__ = ["fake_world", "make_mesh", "make_production_mesh",
           "mesh_options"]


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], *,
              device_type: str = "cuda"):
    """DeviceMesh over the first prod(shape) ranks of the process group
    (one a card; :func:`fake_world` gives the dry run 512 of them and the
    single-pod mesh uses the first 256)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(f"need {n} devices, have {have} — run under "
                           f"launch/dryrun.py (a fake world) or torchrun")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def mesh_options(chips: int = 256) -> List[Tuple[Tuple[int, int], str]]:
    """(data, model) splits of a pod, with names, for the Flora trace."""
    opts = []
    model = 1
    while model <= min(chips, 64):
        data = chips // model
        opts.append(((data, model), f"dp{data}xtp{model}"))
        model *= 4
    return opts


@contextlib.contextmanager
def fake_world(n: int) -> Iterator[None]:
    """A process group of ``n`` ranks in which this process is rank 0 and
    every collective returns at once without moving data (PyTorch's
    ``fake`` backend): the dry run's world, on the CPU, with no card.
    Refuses to start while another group is open (the group belongs to
    the whole process), and destroys its own on the way out."""
    import torch.distributed as dist
    if dist.is_initialized():
        raise RuntimeError("a process group is already open in this "
                           "process; the dry run opens its own fake world "
                           "and cannot share one")
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(f"torch {torch.__version__} has no fake process "
                           f"group (torch.testing._internal.distributed."
                           f"fake_pg), which the dry run needs") from e
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()
