"""Logical-axis -> mesh-axis sharding rules (the port's own copy of
``repro/sharding/rules.py``).

Every parameter/state/activation dimension carries a *logical* axis name
(see ParamSpec.axes).  A :class:`Rules` table maps logical names onto mesh
axes; resolution is divisibility-safe: if a dimension is not divisible by
the mapped mesh axes' total size, it falls back to replication (this is
what makes e.g. llama4's 40 heads work on a 16-way model axis — attention
weights replicate, experts/FFN still shard; the roofline analysis then
shows the replicated-compute cost honestly).

Parallelism coverage:
  DP  — "batch" over ("pod", "data")
  FSDP— "embed" over "data" (ZeRO-3 parameter/optimizer sharding)
  TP  — "heads"/"kv_heads"/"mlp"/"vocab" over "model" (Megatron-style)
  EP  — "experts" over "model"
  SP  — "seq" over "data" (sequence sharding for long activations)

The reference's ``PartitionSpec`` is :class:`PartitionSpec` here (one
entry a tensor dimension: ``None``, a mesh axis name or a tuple of them),
and its ``NamedSharding`` is :class:`NamedSharding`, the pair (mesh,
spec) whose :attr:`~NamedSharding.placements` are the DTensor placements
on a :class:`~torch.distributed.device_mesh.DeviceMesh`, one a mesh
dimension (:func:`placements_for`).  A mesh is anything whose axis sizes
can be read by name: a ``DeviceMesh`` (``mesh_dim_names`` beside its
``shape`` tuple) or an object whose ``shape`` is a dict of them, as the
reference's tests pass.  Nothing here needs a process group except
building a DTensor on the placements.
"""
from __future__ import annotations

import dataclasses
import math
from typing import (Any, Dict, Iterator, List, Mapping, Optional, Sequence,
                    Tuple, Union)

import torch

from repro_torch.models.types import ParamSpec, map_specs

__all__ = ["AxisTarget", "NamedSharding", "PartitionSpec", "Rules",
           "arch_overrides", "batch_shardings", "bytes_per_device",
           "describe", "local_shape", "mesh_sizes", "placements_for",
           "production_rules", "sharding_for_spec", "spec_for",
           "tree_shardings"]

AxisTarget = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """One entry a tensor dimension (trailing replicated ones dropped):
    ``None`` (replicated), a mesh axis name, or a tuple of names (the
    dimension split over their product, the first the major)."""

    def __new__(cls, *entries: AxisTarget) -> "PartitionSpec":
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"



@dataclasses.dataclass(frozen=True)
class Rules:
    table: Mapping[str, AxisTarget]

    def target(self, logical: Optional[str]) -> AxisTarget:
        if logical is None:
            return None
        return self.table.get(logical)

    def with_overrides(self, **kv: AxisTarget) -> "Rules":
        t = dict(self.table)
        t.update(kv)
        return Rules(t)


def production_rules(*, multi_pod: bool = False, fsdp: bool = True) -> Rules:
    batch: AxisTarget = ("pod", "data") if multi_pod else ("data",)
    return Rules({
        "batch": batch,
        "seq": None,
        "embed": ("data",) if fsdp else None,
        "heads": ("model",),
        "kv_heads": ("model",),
        # fallback TP axis: shards attention when head counts do not divide
        # the model axis (e.g. llama4's 40 heads on 16-way TP) — the
        # used-once + divisibility logic in spec_for makes this automatic.
        "head_dim": ("model",),
        # rwkv time-mix keeps head-aligned channels replicated (40 heads x 64
        # channels do not align with a 16-way split); channel-mix shards.
        "heads_flat": None,
        "mlp": ("model",),
        "vocab": ("model",),
        "experts": ("model",),
        "layers": None,
    })


def arch_overrides(cfg, tp: int, kind: str = "train") -> dict:
    """Per-architecture rule overrides for a consistent attention scheme.

    The generic divisibility fallback resolves each tensor independently,
    which can leave q sharded on heads while k/v fall back to head_dim —
    a per-layer resharding storm.  This chooses ONE scheme per arch:

    * H % tp == 0 and G % tp == 0  -> shard heads (Megatron); head_dim off.
    * H % tp == 0, G % tp != 0     -> shard q heads, REPLICATE kv
      (classic MQA tensor-parallel) for train/prefill.  For decode the
      replicated KV cache would blow HBM, so decode switches the whole
      attention to head_dim sharding (scores reduced per step instead).
    * H % tp != 0 (e.g. llama4's 40 heads on tp=16) -> attention fully
      replicated over the model axis (weights stay FSDP-sharded over data);
      FFN/MoE/vocab still shard.  The roofline shows the duplicated-compute
      cost honestly; the Flora mesh selector discovers that such archs
      prefer a dp32xtp8 split (40 % 8 == 0).
    """
    H, G, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if H % tp == 0 and G % tp == 0:
        return {"head_dim": None}
    if H % tp == 0:
        if kind == "decode" and D % tp == 0:
            return {"heads": None, "kv_heads": None}
        return {"head_dim": None}
    if D % tp == 0 and kind == "decode":
        return {"heads": None, "kv_heads": None}
    return {"heads": None, "kv_heads": None, "head_dim": None}


def mesh_sizes(mesh) -> Dict[str, int]:
    """The mesh's axis sizes by name, in mesh order: a ``DeviceMesh``'s
    ``mesh_dim_names`` against its ``shape`` tuple, or a ``shape`` that is
    already a mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names:
        return dict(zip(names, tuple(mesh.shape)))
    if isinstance(mesh.shape, Mapping):
        return dict(mesh.shape)
    raise TypeError(f"cannot read axis sizes by name from {mesh!r}: give "
                    f"the DeviceMesh mesh_dim_names")


def _names(target: AxisTarget) -> Tuple[str, ...]:
    if target is None:
        return ()
    return (target,) if isinstance(target, str) else tuple(target)


def _axes_size(sizes: Mapping[str, int], target: AxisTarget) -> int:
    return math.prod(sizes[n] for n in _names(target))


def spec_for(shape: Sequence[int], axes: Sequence[Optional[str]],
             rules: Rules, mesh) -> PartitionSpec:
    """PartitionSpec for one tensor, with divisibility fallback and
    one-mesh-axis-used-once enforcement."""
    sizes = mesh_sizes(mesh)
    used: set = set()
    entries: List[AxisTarget] = []
    for dim, logical in zip(shape, axes):
        target = rules.target(logical)
        if target is None:
            entries.append(None)
            continue
        names = tuple(n for n in _names(target)
                      if n in sizes and n not in used)
        size = math.prod(sizes[n] for n in names)
        if not names or size <= 1 or dim % size != 0:
            entries.append(None)
            continue
        used.update(names)
        entries.append(names[0] if len(names) == 1 else names)
    while entries and entries[-1] is None:
        entries.pop()
    return PartitionSpec(*entries)


def placements_for(spec: PartitionSpec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``, one a mesh
    dimension: ``Shard(d)`` where tensor dimension ``d``'s entry names
    that mesh axis, ``Replicate()`` elsewhere.  A tuple entry shards its
    dimension on each of its axes; they must come in mesh order (the
    first the major, as JAX splits it), which is also DTensor's order."""
    from torch.distributed.tensor import Replicate, Shard
    order = list(mesh_sizes(mesh))
    out: List[Any] = [Replicate() for _ in order]
    for d, entry in enumerate(spec):
        names = _names(entry)
        idx = [order.index(n) for n in names]
        if idx != sorted(idx):
            raise ValueError(f"entry {entry!r} lists mesh axes out of the "
                             f"mesh's order {tuple(order)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def local_shape(shape: Sequence[int], spec: PartitionSpec,
                mesh) -> Tuple[int, ...]:
    """One device's slice of a tensor of ``shape`` under ``spec``
    (``spec_for`` only splits what divides evenly)."""
    sizes = mesh_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        out[d] //= _axes_size(sizes, entry)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """The reference's ``NamedSharding``: a mesh and a spec; on a
    ``DeviceMesh`` :attr:`placements` are the DTensor placements."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements_for(self.spec, self.mesh)


def sharding_for_spec(spec: ParamSpec, rules: Rules, mesh) -> NamedSharding:
    return NamedSharding(mesh, spec_for(spec.shape, spec.axes, rules, mesh))


def tree_shardings(spec_tree: Any, rules: Rules, mesh) -> Any:
    """NamedSharding tree parallel to a ParamSpec tree."""
    return map_specs(lambda s: sharding_for_spec(s, rules, mesh), spec_tree)


def batch_shardings(batch_specs: Mapping[str, torch.Tensor], rules: Rules,
                    mesh) -> Dict[str, NamedSharding]:
    """Shardings for input batches (meta tensors or any tensor): leading
    dim = batch, rest replicated (sequence sharding is opt-in via
    rules["seq"])."""
    out = {}
    for name, s in batch_specs.items():
        if s.dim() == 0:
            out[name] = NamedSharding(mesh, PartitionSpec())
            continue
        axes: list = ["batch"] + [None] * (s.dim() - 1)
        if s.dim() >= 2 and rules.target("seq") is not None:
            axes[1] = "seq"
        out[name] = NamedSharding(mesh, spec_for(tuple(s.shape), axes, rules,
                                                 mesh))
    return out


def _leaves_with_path(tree: Any, path: str = ""
                      ) -> Iterator[Tuple[str, ParamSpec]]:
    if isinstance(tree, ParamSpec):
        yield path, tree
    elif isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves_with_path(v, f"{path}[{k!r}]")
    else:
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, f"{path}[{i}]")


def describe(spec_tree: Any, rules: Rules, mesh, *, max_rows: int = 0
             ) -> str:
    """Human-readable table of resolved shardings (debugging aid)."""
    rows = []
    for path, s in _leaves_with_path(spec_tree):
        p = spec_for(s.shape, s.axes, rules, mesh)
        rows.append(f"{path:60s} {str(s.shape):24s} {p}")
    if max_rows:
        rows = rows[:max_rows]
    return "\n".join(rows)


def bytes_per_device(spec_tree: Any, rules: Rules, mesh,
                     dtype: torch.dtype = torch.float32) -> int:
    """Parameter bytes resident per device under the resolved shardings,
    each leaf at its storage dtype when the model computes in ``dtype``
    (``ParamSpec.storage_dtype``).  The reference stores every leaf in
    float32, so ``dtype=torch.float32`` gives its figure; a model's own
    ``compute_dtype`` gives the port's bytes (bf16 weights, float32 norm
    scales)."""
    sizes = mesh_sizes(mesh)
    total = 0
    for _, s in _leaves_with_path(spec_tree):
        p = spec_for(s.shape, s.axes, rules, mesh)
        shard = math.prod(_axes_size(sizes, entry) for entry in p)
        n = math.prod(s.shape) // max(shard, 1)
        total += n * s.storage_dtype(dtype).itemsize
    return total
