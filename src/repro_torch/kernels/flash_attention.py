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
  as a 64-column block and a 16-column tail, each with its own swizzle;
  ``D = 160`` and ``D = 256`` in a block shape of their own: one consumer
  warpgroup, 64-row query tiles and 64-key tiles; ``D = 160``'s rows are
  two 64-column blocks and a 32-column tail);
* ``scalar`` — ``flash_fwd_kernel``, scalar fp32 FMAs, for fp32 at every
  ``D``.  It takes bf16 too, but only when named (``_launch(..., kind=
  "scalar")``): the yardstick the tensor-core kernel is timed against.

:func:`attention_ref` is the plain PyTorch version, the counterpart of the
reference's oracle ``repro.kernels.ref.attention_ref``.
:func:`flash_attention` takes it for tensors on the CPU; for CUDA tensors
it launches a kernel or raises, and never falls back.  :data:`LAUNCHES`
counts kernel launches and nothing else: ``flash_attention`` is the
forward's total, ``flash_attention_tc`` and ``flash_attention_scalar``
each variant;
:data:`SHAPE_LAUNCHES` counts the same launches by variant and shape.

The gradients.  :func:`flash_attention` on CUDA tensors goes through
:class:`FlashAttentionFn` when grad mode is on and ``q``, ``k`` or ``v``
requires grad: its forward is the same launch, and it saves q, k, v and
o; its backward launches ``csrc/flash_attention_bwd.cu`` (see its header:
the row statistics recomputed, then dQ and dK/dV, scalar fp32, no
atomics), counted as ``flash_attention_bwd`` in :data:`LAUNCHES` and
under variant ``"bwd"`` in :data:`SHAPE_LAUNCHES`.  Under
``torch.inference_mode`` or ``no_grad`` (serving) nothing changes.
:func:`attention_bwd_ref` is the backward's plain version, from the
explicit formulas in float32; CPU tensors take :func:`attention_ref`,
which autograd differentiates.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build

__all__ = ["FlashAttentionFn", "HEAD_DIMS", "LAUNCHES", "SHAPE_LAUNCHES",
           "TC_HEAD_DIMS", "attention_bwd_ref", "attention_ref",
           "flash_attention", "reset_launches", "variant"]

#: kernel launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_attention_tc": 0,
                             "flash_attention_scalar": 0,
                             "flash_attention_bwd": 0}
#: the same launches by (variant, Tq, Tk, causal)
SHAPE_LAUNCHES: Dict[Tuple[str, int, int, bool], int] = {}
#: the head sizes the kernel is built for: every attention config the port
#: serves (the reduced configs' 16, stablelm's 80, pixtral's 160,
#: recurrentgemma's 256) and the reference kernel tests' 32 and 64
HEAD_DIMS = (16, 32, 64, 80, 128, 160, 256)
#: the bf16 head sizes the tensor-core kernel takes: rows cut into 128-byte
#: blocks and a 32- or 64-byte tail, each swizzled by its width
TC_HEAD_DIMS = (16, 32, 64, 80, 128, 160, 256)
NEG_INF = -1e30

_SOURCE = "flash_attention"
_BWD_SOURCE = "flash_attention_bwd"
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "flash_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                            ctypes.c_float, _I, _P],
    "flash_attention_fwd_sm90": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                 _I, ctypes.c_float, _P],
}
_BWD_SIGNATURES = {"flash_attention_bwd": [_P] * 11 + [_I] * 8
                   + [ctypes.c_float, _I, _P]}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    SHAPE_LAUNCHES.clear()


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
    mask = _mask(Tq, Tk, causal, window, q.device)
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrts,bsgd->btgrd", p, v.float())
    return o.reshape(B, Tq, H, D).to(v.dtype)


def _mask(Tq: int, Tk: int, causal: bool, window: Optional[int],
          device) -> torch.Tensor:
    """The (Tq, Tk) bool mask of allowed scores."""
    qpos = torch.arange(Tq, device=device)[:, None]
    kpos = torch.arange(Tk, device=device)[None, :]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    return mask


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of :func:`attention_ref`'s output ``o``
    given its cotangent ``do``, from the explicit formulas in float32 (no
    autograd): ``P`` the masked softmax, ``dV = P^T dO``, ``dP = dO V^T``,
    ``dS = P * (dP - rowsum(dO * O))`` and 0 where masked, ``dQ = dS K /
    sqrt(D)``, ``dK = dS^T Q / sqrt(D)``, summed over each KV head's R
    query heads.  A fully masked row's softmax is uniform, as the forward's;
    its dS is 0.  The results in the inputs' dtype."""
    B, Tq, H, D = q.shape
    Tk, G = k.shape[1], k.shape[2]
    R = H // G
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Tq, G, R, D).float()
    dog = do.reshape(B, Tq, G, R, D).float()
    kf, vf = k.float(), v.float()
    mask = _mask(Tq, Tk, causal, window, q.device)
    s = torch.einsum("btgrd,bsgd->bgrts", qg * scale, kf)
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    delta = (dog * o.reshape(B, Tq, G, R, D).float()).sum(-1)  # (B,T,G,R)
    dp = torch.einsum("btgrd,bsgd->bgrts", dog, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    ds = torch.where(mask, ds, torch.zeros((), device=q.device))
    dv = torch.einsum("bgrts,btgrd->bsgd", p, dog)
    dk = torch.einsum("bgrts,btgrd->bsgd", ds, qg) * scale
    dq = torch.einsum("bgrts,bsgd->btgrd", ds, kf) * scale
    return (dq.reshape(B, Tq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _check_causal(Tq: int, Tk: int, causal: bool) -> None:
    # the reference's rule: causal masking assumes q and k cover the same
    # positions, so Tq != Tk has no meaning there
    if causal and Tq != Tk:
        raise ValueError(f"a causal call needs as many keys as queries, "
                         f"got Tq={Tq} and Tk={Tk}")


def _check(q, k, v, causal, window) -> None:
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
    _check_causal(Tq, Tk, causal)
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
        _build.check(_build.launch_on(q, lib.flash_attention_fwd_sm90,
                                      *args, stream),
                     "flash_attention_fwd_sm90")
    elif kind == "scalar":
        _build.check(_build.launch_on(q, lib.flash_attention_fwd, *args,
                                      _DTYPE_CODES[q.dtype], stream),
                     "flash_attention_fwd")
    else:
        raise ValueError(f"unknown kernel variant {kind!r}")
    LAUNCHES["flash_attention"] += 1
    LAUNCHES[f"flash_attention_{kind}"] += 1
    key = (kind, Tq, Tk, bool(causal))
    SHAPE_LAUNCHES[key] = SHAPE_LAUNCHES.get(key, 0) + 1
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Attention of ``q`` over ``k``/``v`` (the reference's argument order,
    without its TPU block sizes): ``(B, Tq, H, D)`` in ``q``'s dtype.
    A bidirectional call takes any ``Tq`` and ``Tk`` (an encoder, cross
    attention over it, one decode token over a cross cache); a causal one
    needs ``Tq == Tk`` and raises otherwise.
    CUDA tensors run a kernel (bf16 or fp32, contiguous, ``D`` in
    :data:`HEAD_DIMS`; the variant :func:`variant` names); CPU tensors the
    plain version.  On CUDA a bidirectional call with a window that leaves
    a query row no key in reach (``Tq >= Tk + window``) raises: the
    forward kernels average such a row over their tile's padded keys, not
    over the Tk keys as the plain version and the backward do (ROADMAP.md
    §C, entry 9)."""
    _check(q, k, v, causal, window)
    if q.device.type == "cpu":
        _check_causal(q.shape[1], k.shape[1], causal)
        return attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if not causal and window is not None \
            and q.shape[1] >= k.shape[1] + window:
        raise ValueError(f"a bidirectional call with window {window} over "
                         f"Tq={q.shape[1]} and Tk={k.shape[1]} leaves rows "
                         f"with no key in reach, which the kernels do not "
                         f"take yet")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window)
    return _launch(q, k, v, causal, window)


def _launch_bwd(q, k, v, o, do, causal: bool, window: Optional[int]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward (``csrc/flash_attention_bwd.cu``, one count)
    on CUDA tensors: (dq, dk, dv) in q's dtype."""
    B, Tq, H, D = q.shape
    Tk, G = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head sizes {HEAD_DIMS}, got {D}")
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, expected {q.dtype}")
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} "
                         f"must have q's shape {tuple(q.shape)}")
    if min(B, Tq, Tk) < 1:
        raise ValueError("empty batch or sequence")
    _check_causal(Tq, Tk, causal)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    # the row statistics: max, 1 / sum and rowsum(dO * O)
    stats = torch.empty((3, B, H, Tq), dtype=torch.float32, device=q.device)
    lib = _build.load(_BWD_SOURCE, _BWD_SIGNATURES)
    _build.check(_build.launch_on(
        q, lib.flash_attention_bwd, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), o.data_ptr(), do.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), stats[0].data_ptr(),
        stats[1].data_ptr(), stats[2].data_ptr(), B, Tq, Tk, H, G, D,
        int(causal), window or 0, 1.0 / math.sqrt(D), _DTYPE_CODES[q.dtype],
        _build.current_stream(q)), "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    key = ("bwd", Tq, Tk, bool(causal))
    SHAPE_LAUNCHES[key] = SHAPE_LAUNCHES.get(key, 0) + 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Attention on CUDA tensors with its gradient: the forward kernel
    :func:`variant` names, and the backward kernel.  Reached through
    :func:`flash_attention` when a gradient is wanted."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int]):
        o = _launch(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, o)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = _launch_bwd(q, k, v, o, do.contiguous(), ctx.causal,
                                 ctx.window)
        return dq, dk, dv, None, None
