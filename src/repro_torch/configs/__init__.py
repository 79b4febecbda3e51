"""Architecture configuration registry (the port's own copy).

Counterpart of ``repro/configs/__init__.py``.  ``get(name)`` returns the
published config; ``reduced(cfg)`` a same-family shrunken variant for CPU
tests, by the reference's shrink rules.  The port serves the dense and
RWKV families so far: ``qwen3-1.7b``, ``stablelm-3b`` and ``rwkv6-3b``.  For the other
names ``get`` raises :class:`NotPortedError` (ROADMAP.md §A lists what is
left).
"""
from __future__ import annotations

import dataclasses
import importlib
import math
from typing import List

from repro_torch.models.types import ModelConfig, NotPortedError

__all__ =["ARCH_NAMES", "NotPortedError", "PORTED", "all_configs", "get",
           "reduced"]

#: every architecture the reference knows, in its order
ARCH_NAMES: List[str] = [
    "seamless-m4t-large-v2", "llama4-maverick-400b-a17b",
    "qwen3-moe-30b-a3b", "recurrentgemma-9b", "rwkv6-3b", "stablelm-3b",
    "qwen3-1.7b", "granite-20b", "deepseek-7b", "pixtral-12b",
]

_MODULES = {
    "rwkv6-3b": "rwkv6_3b",
    "stablelm-3b": "stablelm_3b",
    "qwen3-1.7b": "qwen3_1_7b",
}

#: the architectures the port serves
PORTED: List[str] = [n for n in ARCH_NAMES if n in _MODULES]


def get(name: str) -> ModelConfig:
    if name not in ARCH_NAMES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    if name not in _MODULES:
        raise NotPortedError(
            f"architecture {name!r} is not ported yet (ported: {PORTED}; "
            f"ROADMAP.md §A lists what is left)")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def reduced(cfg: ModelConfig, *, d_model: int = 64,
            vocab: int = 512) -> ModelConfig:
    """Same-family shrunken config for CPU tests (the reference's rules)."""
    period = cfg.moe_period if cfg.num_experts else 1
    cyc = math.lcm(len(cfg.block_pattern), period)
    rem = 1 if cfg.num_layers % cyc else 0
    heads = 4
    kv = max(1, heads * cfg.num_kv_heads // cfg.num_heads)
    changes = dict(
        num_layers=2 * cyc + rem,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=d_model // heads,
        d_ff=4 * d_model if cfg.moe_d_ff is None else 2 * d_model,
        vocab_size=vocab,
        dtype="float32",
    )
    if cfg.num_experts:
        changes.update(num_experts=8,
                       experts_per_token=min(cfg.experts_per_token, 2),
                       moe_d_ff=(2 * d_model if cfg.moe_d_ff is not None
                                 else None))
    if cfg.window:
        changes.update(window=16)
    if cfg.family in ("hybrid",):
        changes.update(lru_width=d_model)
    if cfg.family == "ssm":
        changes.update(rwkv_head_dim=16, num_heads=d_model // 16,
                       num_kv_heads=d_model // 16, head_dim=16)
    if cfg.encoder_layers:
        changes.update(encoder_layers=2)
    if cfg.frontend_len:
        changes.update(frontend_len=8)
    return dataclasses.replace(cfg, **changes)
