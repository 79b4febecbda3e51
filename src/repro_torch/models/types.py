"""Model configuration and parameter-spec types (the port's own copy).

Counterpart of ``repro/models/types.py``.  Parameters are nested dicts of
tensors; a parallel tree of :class:`ParamSpec` carries each leaf's shape,
logical axis names, initialiser and storage dtype.

Storage dtype.  The reference stores every parameter in float32 and casts
it to the compute dtype at each use.  The port serves, so it stores each
leaf in the dtype its uses read: ``dtype=None`` (the default) is the
compute dtype, which gives the same bf16 values as the reference's
per-use cast; the leaves the reference reads in float32 (norm scales and
biases, the RWKV decay base and bonus) say ``dtype=torch.float32``.

Initialisation draws from an explicit :class:`torch.Generator` on the
target device, leaf by leaf in spec order, with the reference's
distributions (``ParamSpec.initialise``).  The numbers differ from
``jax.random``'s; tests hand both packages the same weights through
:mod:`repro_torch.convert` instead.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch

__all__ = ["ModelConfig", "NotPortedError", "ParamSpec", "ShapeSpec",
           "SpecTree", "count_params", "init_params", "map_specs"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class NotPortedError(NotImplementedError):
    """An architecture, mode or layer the reference has and the port does
    not have yet (ROADMAP.md §A lists what is left)."""


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Shape + logical axes + initialiser for one parameter tensor."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis name per dim (None = replicated)
    init: str = "normal"              # normal | zeros | ones | uniform
    scale: Optional[float] = None     # stddev override (default: 1/sqrt(fan_in))
    dtype: Optional[torch.dtype] = None   # storage dtype (None: compute dtype)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"differ in rank")

    def storage_dtype(self, compute_dtype: torch.dtype) -> torch.dtype:
        return compute_dtype if self.dtype is None else self.dtype

    def initialise(self, gen: torch.Generator, compute_dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
        dtype = self.storage_dtype(compute_dtype)
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=device)
        if self.init == "uniform":
            x = torch.rand(self.shape, generator=gen, device=device)
            return (x * 2.0 - 1.0).to(dtype)
        if self.init != "normal":
            raise ValueError(f"unknown initialiser {self.init!r}")
        fan_in = self.shape[0] if len(self.shape) > 1 else self.shape[-1]
        scale = self.scale if self.scale is not None else \
            1.0 / math.sqrt(fan_in)
        # scaled in place: the float32 draw is the only temporary (5.4e9
        # values for one of llama4's (128, 5120, 8192) expert leaves)
        x = torch.randn(self.shape, generator=gen, device=device)
        return x.mul_(scale).to(dtype)


SpecTree = Any   # nested dicts / lists with ParamSpec leaves


def map_specs(fn: Callable[[ParamSpec], Any], specs: SpecTree) -> Any:
    """``fn`` applied to every leaf, in insertion order, keeping the
    tree's dicts and lists."""
    if isinstance(specs, ParamSpec):
        return fn(specs)
    if isinstance(specs, dict):
        return {k: map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        return [map_specs(fn, v) for v in specs]
    raise TypeError(f"not a spec tree node: {type(specs).__name__}")


def init_params(specs: SpecTree, gen: torch.Generator,
                compute_dtype: torch.dtype = torch.float32,
                device: Optional[torch.device] = None) -> Any:
    """Materialise a parameter tree from a spec tree, deterministically
    from ``gen`` (leaves drawn in spec order) on ``device`` (default: the
    generator's)."""
    dev = torch.device(device) if device is not None else gen.device
    return map_specs(lambda s: s.initialise(gen, compute_dtype, dev), specs)


def count_params(specs: SpecTree) -> int:
    total = []
    map_specs(lambda s: total.append(math.prod(s.shape)), specs)
    return int(sum(total))


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One configuration covering all assigned architecture families (the
    reference's fields; the dense, MoE, RWKV and RG-LRU hybrid families
    are ported)."""

    name: str
    family: str                 # dense | moe | hybrid | ssm | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_period: int = 1
    moe_d_ff: Optional[int] = None
    shared_expert: bool = False
    capacity_factor: float = 1.25

    # attention details
    qk_norm: bool = False
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0
    window: Optional[int] = None

    # layer pattern for hybrid/ssm stacks; cycled over the depth.
    # entries: "attn" | "rec" (RG-LRU) | "rwkv"
    block_pattern: Tuple[str, ...] = ("attn",)

    # recurrent blocks
    lru_width: Optional[int] = None
    conv_width: int = 4
    rwkv_head_dim: int = 64

    # encoder-decoder
    encoder_layers: int = 0

    # modality frontend stubs
    frontend: Optional[str] = None
    frontend_len: int = 0

    norm: str = "rmsnorm"              # rmsnorm | layernorm
    act: str = "silu"                  # silu | gelu
    gated_mlp: bool = True
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.family in ("hybrid",) and self.lru_width is None:
            object.__setattr__(self, "lru_width", self.d_model)

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def block_kind(self, layer_idx: int) -> str:
        """Kind of decoder layer ``layer_idx`` (cycled block pattern)."""
        return self.block_pattern[layer_idx % len(self.block_pattern)]

    def is_moe_layer(self, layer_idx: int) -> bool:
        if self.num_experts == 0:
            return False
        return (layer_idx % self.moe_period) == (self.moe_period - 1)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input shape (workload geometry)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str      # "train" | "prefill" | "decode"

    @property
    def tokens_per_step(self) -> int:
        if self.kind == "decode":
            return self.global_batch
        return self.seq_len * self.global_batch
