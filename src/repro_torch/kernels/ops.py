"""The model-side entry points of the LM kernels.

Counterpart of ``repro/kernels/ops.py``.  The port's layers call
:func:`flash_attention` (prefill and training attention) and :func:`wkv6`
(every RWKV-6 time mix) through this module.  On CUDA tensors they launch
the hand-written kernels (their gradients too, when one is wanted: the
attention backward and WKV6's); on CPU tensors they run the plain
versions.

The reference's ``use_pallas`` toggle has no counterpart: on the card the
kernels always run, and nothing switches them off.  Its ``interpret``
flag has none either (a CUDA kernel has no interpret mode).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rwkv6_scan as _wkv
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rwkv6_scan import wkv6

__all__ = ["flash_attention", "launches", "reset_launches", "wkv6"]


def launches() -> Dict[str, int]:
    """Both kernels' launch counts, their backwards' included (a
    copy)."""
    return {**_fa.LAUNCHES, **_wkv.LAUNCHES}


def reset_launches() -> None:
    _fa.reset_launches()
    _wkv.reset_launches()
