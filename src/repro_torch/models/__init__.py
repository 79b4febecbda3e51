"""The LM substrate on the port: configs' types, layers (the MoE dispatch
among them), the RG-LRU block and the RWKV-6 time and channel mixes, the
decoder-only :class:`LM` (dense, MoE, RWKV-6, RG-LRU hybrid and
vision-language families) and the encoder-decoder :class:`EncDec`, with every prefill-side
attention and the WKV recurrence on hand-written CUDA kernels."""
from repro_torch.models.types import (ModelConfig, NotPortedError, ParamSpec,
                                      ShapeSpec, count_params)
from repro_torch.models.registry import build_model
from repro_torch.models.encdec import EncDec
from repro_torch.models.lm import LM

__all__ = ["EncDec", "LM", "ModelConfig", "NotPortedError", "ParamSpec",
           "ShapeSpec", "build_model", "count_params"]
