"""Model construction from configs (counterpart of
``repro/models/registry.py``)."""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.models.lm import LM
from repro_torch.models.types import ModelConfig, NotPortedError


def build_model(cfg: ModelConfig, *,
                device: Union[str, torch.device] = "cuda",
                seed: int = 0) -> LM:
    """An :class:`LM` for the decoder-only families (dense, MoE, RWKV-6),
    with weights drawn
    from ``seed`` on ``device`` (the card unless the caller asks for the
    CPU).  Encoder-decoder configs are not ported yet."""
    if cfg.is_encdec:
        raise NotPortedError(f"{cfg.name}: encoder-decoder models (EncDec) "
                             f"are not ported yet")
    return LM(cfg, device=device, seed=seed)
