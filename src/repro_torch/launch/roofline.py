"""Roofline terms of one traced step, on the card's own rates (the port's
own copy of ``repro/launch/roofline.py``).

Terms (per step and per device, one NVIDIA H100 SXM 80GB a device):

    compute_s    = FLOPs_per_device / PEAK_FLOPS_BF16
    memory_s     = HBM_bytes_per_device / HBM_BW
    collective_s = wire_bytes_per_device / LINK_BW

The reference reads its numerators from the XLA compiler (cost analysis and
the optimised HLO's collectives).  The port has no compiler artifact: it
counts the step as it runs, op by op, under a fake world
(:func:`count`, driven by :mod:`repro_torch.launch.dryrun`):

* every op at one device's local size: DTensor runs each op on this
  rank's shards, after the redistributions its sharding rule asks for,
  and the count sees those local calls (a replicated op counts whole on
  every device, as the reference counts replicated compute);
* FLOPs by :data:`torch.utils.flop_counter.flop_registry` (matrix
  products, and the hand-written kernels' counting forms, whose formulas
  the kernel modules register: :mod:`repro_torch.kernels.flash_attention`,
  :mod:`repro_torch.kernels.rwkv6_scan`);
* HBM bytes as each op's tensor inputs read once and outputs written once,
  views and bare allocations free: the port runs eagerly, op by op, so
  nothing is fused away;
* collectives by kind with their payload bytes (the larger of what goes
  in and what comes out of one device), with the reference's ring factor:
  an all-reduce moves twice its payload.  They are the functional
  collectives DTensor issues to redistribute.

The rates are published peaks of NVIDIA's H100 SXM data sheet at its
700 W power limit (dense, no sparsity): 989e12 bf16 FLOP/s on the tensor
cores, 67e12 FP32 FLOP/s outside them, 3.35e12 bytes/s of HBM3.  The
collective term takes one link rate, as the reference does: 50e9 bytes/s,
one 400 Gb/s NDR InfiniBand port a card.  A card's NVLink (900 GB/s) joins
only the 8 cards of its node; any mesh axis larger than a node crosses
the network, whose per-card port is the narrow link, so the term is set
by it.  No compiler gives the port a memory analysis, so a cell has no
``memory`` key (the reference omits it too when its compiler gives none).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Iterator, Mapping

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["COLLECTIVES", "Counts", "FP32_FLOPS", "HBM_BW", "LINK_BW",
           "PEAK_FLOPS_BF16", "Roofline", "analyze", "count",
           "model_flops_per_step"]

# --- hardware constants (NVIDIA H100 SXM 80GB, per card; see the note) ------
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, tensor cores, dense
FP32_FLOPS = 67e12              # FLOP/s, FP32 outside the tensor cores
HBM_BW = 3.35e12                # bytes/s, HBM3
LINK_BW = 50e9                  # bytes/s, one 400 Gb/s NDR port a card

#: the operator namespaces of PyTorch's collectives
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d",
                          "_dtensor")
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
#: a functional collective's name -> its kind
_KINDS = (("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
          ("all_gather", "all-gather"), ("allgather", "all-gather"),
          ("reduce_scatter", "reduce-scatter"),
          ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
          ("broadcast", "collective-permute"),
          ("permute", "collective-permute"))


@dataclasses.dataclass
class Counts:
    """What :func:`count` saw of one step, per device."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    collectives: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {k: 0 for k in COLLECTIVES})


def _nbytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class _Counter(TorchDispatchMode):
    """One device's FLOPs, HBM bytes and collectives, op by op.  An op on
    DTensors is handed back to DTensor (NotImplemented), which runs its
    redistributions (the collectives) and the op itself on this rank's
    local tensors, which come back here: each is counted at its local
    size.  DTensor also runs ops on fake tensors of global size to work
    out its outputs' shapes; those are not the step's work and are not
    counted."""

    def __init__(self, counts: Counts):
        super().__init__()
        self.counts = counts

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        if any(isinstance(t, FakeTensor) for t in ins):
            return out
        c = self.counts
        if getattr(func, "namespace", "") in _COLLECTIVE_NAMESPACES:
            kind = next((k for key, k in _KINDS if key in func.__name__),
                        None)
            if kind is not None:
                payload = max(_nbytes(ins), _nbytes(out))
                c.collectives[kind] += \
                    2 * payload if kind == "all-reduce" else payload
            return out
        if not isinstance(func, torch._ops.OpOverload) or func.is_view:
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            c.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if _nbytes(out) and not packet.__name__.startswith(
                ("empty", "new_empty")):
            c.hbm_bytes += _nbytes(ins) + _nbytes(out)
        return out


@contextlib.contextmanager
def count() -> Iterator[Counts]:
    """Count what runs inside, per device (see the module's note), in the
    sharded program's context (:func:`repro_torch.sharding.ctx.spmd`,
    which the sharded train step enters too)."""
    from repro_torch.sharding.ctx import spmd
    counts = Counts()
    with spmd(), _Counter(counts):
        yield counts


@dataclasses.dataclass(frozen=True)
class Roofline:
    flops: float                   # per device
    hbm_bytes: float               # per device
    wire_bytes: float              # per device
    collectives: Mapping[str, int]

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS_BF16

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.wire_bytes / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Roofline step time: the binding constraint."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> Dict:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "wire_bytes_per_device": self.wire_bytes,
            "collectives": dict(self.collectives),
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "step_s": self.step_s,
        }


def analyze(counts: Counts) -> Roofline:
    """Roofline terms from one step's :class:`Counts`."""
    coll = dict(counts.collectives)
    return Roofline(flops=float(counts.flops),
                    hbm_bytes=float(counts.hbm_bytes),
                    wire_bytes=float(sum(coll.values())), collectives=coll)


def model_flops_per_step(n_params_active: float, tokens_per_step: float,
                         *, training: bool) -> float:
    """MODEL_FLOPS = 6*N*D for training (fwd+bwd), 2*N*D for inference."""
    factor = 6.0 if training else 2.0
    return factor * n_params_active * tokens_per_step
