"""Forward flash attention (causal, windowed or bidirectional; GQA), as
hand-written CUDA.

Counterpart of the reference's Pallas kernel
``repro/kernels/flash_attention.py::flash_attention_pallas`` (body
``_kernel``).  ``q`` is ``(B, Tq, H, D)``, ``k`` and ``v`` are ``(B, Tk, G,
D)`` with ``H = G * R``; query head ``h`` reads KV head ``h // R``.  The
kernels live in ``csrc/flash_attention.cu`` (see its header for the work
split, the masking and what bounds them on the card).  Two variants, chosen
by :func:`variant` from the dtype and the head size alone:

* ``tc`` — ``flash_fwd_sm90``, on the tensor cores (wgmma fed by TMA), for
  bf16 at every ``D`` in :data:`TC_HEAD_DIMS` (``D = 80``'s 160-byte rows
  as a 64-column block and a 16-column tail, each with its own swizzle);
* ``scalar`` — ``flash_fwd_kernel``, scalar fp32 FMAs, for fp32 at every
  ``D``.  It takes bf16 too, but only when named (``_launch(..., kind=
  "scalar")``): the yardstick the tensor-core kernel is timed against.

:func:`attention_ref` is the plain PyTorch version, the counterpart of the
reference's oracle ``repro.kernels.ref.attention_ref``.
:func:`flash_attention` takes it for tensors on the CPU; for CUDA tensors
it launches a kernel or raises, and never falls back.  :data:`LAUNCHES`
counts kernel launches and nothing else: ``flash_attention`` is the total,
``flash_attention_tc`` and ``flash_attention_scalar`` each variant.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build

__all__ = ["HEAD_DIMS", "LAUNCHES", "TC_HEAD_DIMS", "attention_ref",
           "flash_attention", "reset_launches", "variant"]

#: kernel launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_attention_tc": 0,
                             "flash_attention_scalar": 0}
#: the head sizes the kernel is built for: every attention config of the
#: repository up to 128 (the reduced configs' 16, stablelm's 80) and the
#: reference kernel tests' 32 and 64
HEAD_DIMS = (16, 32, 64, 80, 128)
#: the bf16 head sizes the tensor-core kernel takes: rows cut into 128-byte
#: blocks and a 32- or 64-byte tail, each swizzled by its width
TC_HEAD_DIMS = (16, 32, 64, 80, 128)
NEG_INF = -1e30

_SOURCE = "flash_attention"
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "flash_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                            ctypes.c_float, _I, _P],
    "flash_attention_fwd_sm90": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                 _I, ctypes.c_float, _P],
}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def variant(dtype: torch.dtype, D: int) -> str:
    """The kernel a CUDA call runs: ``"tc"`` for bf16 at ``D`` in
    :data:`TC_HEAD_DIMS`, else ``"scalar"``."""
    return "tc" if dtype == torch.bfloat16 and D in TC_HEAD_DIMS \
        else "scalar"


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """Naive softmax attention with GQA, in float32, with the reference's
    ``-1e30`` masks; the result in ``v``'s dtype."""
    B, Tq, H, D = q.shape
    Tk, G = k.shape[1], k.shape[2]
    R = H // G
    qg = q.reshape(B, Tq, G, R, D).float() / math.sqrt(D)
    s = torch.einsum("btgrd,bsgd->bgrts", qg, k.float())
    qpos = torch.arange(Tq, device=q.device)[:, None]
    kpos = torch.arange(Tk, device=q.device)[None, :]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrts,bsgd->btgrd", p, v.float())
    return o.reshape(B, Tq, H, D).to(v.dtype)


def _check(q, k, v, window) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"{name} must be a 4-d tensor")
    B, Tq, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"be (B, Tk, G, D) with q's B={B} and D={D}")
    G = k.shape[2]
    if G < 1 or H % G:
        raise ValueError(f"{H} query heads do not split over {G} KV heads")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share a dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not (k.device == v.device == q.device):
        raise ValueError("q, k and v must be on one device")
    if window is not None and (not isinstance(window, int)
                               or isinstance(window, bool) or window < 1):
        raise ValueError(f"window must be None or a positive int, "
                         f"got {window!r}")


def _launch(q, k, v, causal: bool, window: Optional[int],
            kind: Optional[str] = None) -> torch.Tensor:
    """Launch ``kind`` (default: :func:`variant`'s choice) on CUDA
    tensors; ``"scalar"`` takes every dtype and head size it is built
    for, ``"tc"`` only what :func:`variant` routes to it."""
    B, Tq, H, D = q.shape
    Tk, G = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head sizes {HEAD_DIMS}, got {D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if min(B, Tq, Tk) < 1:
        raise ValueError("empty batch or sequence")
    kind = kind or variant(q.dtype, D)
    o = torch.empty_like(q)
    lib = _build.load(_SOURCE, _SIGNATURES)
    stream = _build.current_stream(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Tq,
            Tk, H, G, D, int(causal), window or 0, 1.0 / math.sqrt(D))
    if kind == "tc":
        if variant(q.dtype, D) != "tc":
            raise ValueError(f"the tensor-core kernel takes bf16 at head "
                             f"sizes {TC_HEAD_DIMS}, got {q.dtype} at {D}")
        # the tensor maps' rule: 16-byte aligned bases (row strides of 2D
        # bytes are multiples of 16 at every such D)
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must start on a 16-byte boundary")
        _build.check(lib.flash_attention_fwd_sm90(*args, stream),
                     "flash_attention_fwd_sm90")
    elif kind == "scalar":
        _build.check(lib.flash_attention_fwd(*args, _DTYPE_CODES[q.dtype],
                                             stream), "flash_attention_fwd")
    else:
        raise ValueError(f"unknown kernel variant {kind!r}")
    LAUNCHES["flash_attention"] += 1
    LAUNCHES[f"flash_attention_{kind}"] += 1
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Attention of ``q`` over ``k``/``v`` (the reference's argument order,
    without its TPU block sizes): ``(B, Tq, H, D)`` in ``q``'s dtype.
    CUDA tensors run a kernel (bf16 or fp32, contiguous, ``D`` in
    :data:`HEAD_DIMS`; the variant :func:`variant` names); CPU tensors the
    plain version."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, k, v, causal, window)
