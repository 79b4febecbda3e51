"""Model construction from configs (counterpart of
``repro/models/registry.py``)."""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.models.encdec import EncDec
from repro_torch.models.lm import LM
from repro_torch.models.types import ModelConfig


def build_model(cfg: ModelConfig, *,
                device: Union[str, torch.device] = "cuda",
                seed: int = 0) -> Union[LM, EncDec]:
    """An :class:`EncDec` when ``cfg.encoder_layers > 0``, else an
    :class:`LM` (dense, MoE, RWKV-6, RG-LRU hybrid, vision-language), with
    weights drawn from ``seed`` on ``device`` (the card unless the caller
    asks for the CPU)."""
    cls = EncDec if cfg.is_encdec else LM
    return cls(cfg, device=device, seed=seed)
