"""Assigned input shapes and batch builders for every cell (the port's own
copy of ``repro/configs/shapes.py``).

The four shapes (seq_len x global_batch) are fixed by the assignment:

    train_4k      4,096 x 256   (training)
    prefill_32k  32,768 x 32    (inference prefill)
    decode_32k   32,768 x 128   (inference decode: 1 token vs KV cache)
    long_500k   524,288 x 1     (long-context decode)

``decode_*``/``long_*`` trace ``decode_step``, not the train step.
``long_500k`` requires sub-quadratic state and therefore only runs for the
SSM/hybrid families (rwkv6-3b, recurrentgemma-9b); it is skipped — and the
skip recorded — for pure full-attention archs.

The reference's ``ShapeDtypeStruct`` stand-ins are tensors on the ``meta``
device here (shape and dtype, no storage), and ``make_batch`` draws from
an explicit :class:`torch.Generator` on an explicit device.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Union

import torch

from repro_torch.models.types import ModelConfig, ShapeSpec

__all__ = ["SHAPES", "SUBQUADRATIC_FAMILIES", "applicable", "batch_specs",
           "cells", "decode_specs", "make_batch", "skip_reason"]

SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> bool:
    if shape.name == "long_500k":
        return cfg.family in SUBQUADRATIC_FAMILIES
    return True


def skip_reason(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    if not applicable(cfg, shape):
        return (f"{cfg.name} is pure full attention; a {shape.seq_len}-token "
                "dense KV cache is not a meaningful configuration "
                "(DESIGN.md §5)")
    return None


def cells(cfg: ModelConfig) -> List[ShapeSpec]:
    return [s for s in SHAPES.values() if applicable(cfg, s)]


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeSpec, *,
                with_labels: bool) -> Dict[str, torch.Tensor]:
    """Meta tensors for a train/prefill batch of this cell."""
    B, T = shape.global_batch, shape.seq_len
    emb_dtype = cfg.compute_dtype
    if cfg.is_encdec:
        # source frames and target tokens split the budget evenly
        F = Tt = T // 2
        out = {
            "frontend_embeds": _sds((B, F, cfg.d_model), emb_dtype),
            "tokens": _sds((B, Tt), torch.int32),
        }
        if with_labels:
            out["labels"] = _sds((B, Tt), torch.int32)
        return out
    if cfg.frontend == "vision":
        F = min(cfg.frontend_len, T // 4)
        out = {
            "frontend_embeds": _sds((B, F, cfg.d_model), emb_dtype),
            "tokens": _sds((B, T - F), torch.int32),
        }
        if with_labels:
            out["labels"] = _sds((B, T), torch.int32)
        return out
    out = {"tokens": _sds((B, T), torch.int32)}
    if with_labels:
        out["labels"] = _sds((B, T), torch.int32)
    return out


def decode_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """(token, pos) meta tensors for a decode step of this cell."""
    B = shape.global_batch
    return {
        "token": _sds((B,), torch.int32),
        "pos": _sds((), torch.int32),
    }


def make_batch(cfg: ModelConfig, shape: ShapeSpec, gen: torch.Generator, *,
               with_labels: bool = True,
               device: Union[str, torch.device, None] = None
               ) -> Dict[str, torch.Tensor]:
    """Concrete random batch matching batch_specs (smoke tests/examples),
    drawn from ``gen`` leaf by leaf in spec order on ``device`` (default:
    the generator's)."""
    dev = torch.device(device) if device is not None else gen.device
    specs = batch_specs(cfg, shape, with_labels=with_labels)
    out = {}
    for name, s in specs.items():
        if s.dtype == torch.int32:
            out[name] = torch.randint(0, cfg.vocab_size, tuple(s.shape),
                                      generator=gen, device=dev,
                                      dtype=torch.int32)
        else:
            out[name] = (torch.randn(tuple(s.shape), generator=gen,
                                     device=dev) * 0.02).to(s.dtype)
    return out
