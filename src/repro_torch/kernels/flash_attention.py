"""Forward flash attention (causal, windowed or bidirectional; GQA), as
hand-written CUDA.

Counterpart of the reference's Pallas kernel
``repro/kernels/flash_attention.py::flash_attention_pallas`` (body
``_kernel``).  ``q`` is ``(B, Tq, H, D)``, ``k`` and ``v`` are ``(B, Tk, G,
D)`` with ``H = G * R``; query head ``h`` reads KV head ``h // R``.  The
kernels live in ``csrc/flash_attention.cu`` (see its header for the work
split, the masking and what bounds them on the card).  Three variants,
chosen by :func:`variant` from the dtype and the head size alone:

* ``tc`` — ``flash_fwd_sm90``, on the tensor cores (wgmma fed by TMA), for
  bf16 at every ``D`` in :data:`TC_HEAD_DIMS` (``D = 80``'s 160-byte rows
  as a 64-column block and a 16-column tail, each with its own swizzle;
  ``D = 160`` and ``D = 256`` in a block shape of their own: one consumer
  warpgroup, 64-row query tiles and 64-key tiles; ``D = 160``'s rows are
  two 64-column blocks and a 32-column tail);
* ``split`` — the same kernel on three bf16 pieces of each fp32 operand
  (``csrc/sm90.cuh``: ``p0 = bf16(x)``, ``p1 = bf16(x - p0)``, ``p2 =
  bf16(x - p0 - p1)``; each product the six piece products with ``i + j
  <= 2``), for fp32 at every ``D`` in :data:`HEAD_DIMS`: a pass
  writes the pieces of q, k and v to bf16 scratch the call allocates,
  then the kernel reads them through the same tensor maps, with K/V
  tiles of 32 or 64 keys;
* ``scalar`` — ``flash_fwd_kernel``, scalar fp32 FMAs.  It takes fp32 and
  bf16, but only when named (``_launch(..., kind="scalar")``): the
  yardstick the tensor-core and the split kernels are timed against.

:func:`split_pieces` and :func:`piece_einsum` are the plain versions of
the split and of the six-product arithmetic, :func:`attention_split_model`
and :func:`attention_bwd_split_model` the split kernels' arithmetic in
plain PyTorch; only tests use them.

:func:`attention_ref` is the plain PyTorch version, the counterpart of the
reference's oracle ``repro.kernels.ref.attention_ref``.
:func:`flash_attention` takes it for tensors on the CPU; for CUDA tensors
it launches a kernel or raises, and never falls back.  :data:`LAUNCHES`
counts kernel launches and nothing else: ``flash_attention`` is the
forward's total, ``flash_attention_tc``, ``flash_attention_split`` and
``flash_attention_scalar`` each variant (the split kernel's pass that
writes the pieces is part of its one launch);
:data:`SHAPE_LAUNCHES` counts the same launches by variant and shape.

The gradients.  :func:`flash_attention` on CUDA tensors goes through
:class:`FlashAttentionFn` when grad mode is on and ``q``, ``k`` or ``v``
requires grad: its forward is the same launch, and it saves q, k, v and
o; its backward launches ``csrc/flash_attention_bwd.cu`` (see its header:
the row statistics recomputed, then dQ, then dK/dV, no atomics), in one
of three variants that :func:`bwd_variant` picks from the dtype and the
head size alone:

* ``tc`` — three passes on the tensor cores (wgmma fed by TMA), for bf16
  at every ``D`` in :data:`BWD_TC_HEAD_DIMS` (at ``D = 160`` and ``256``
  dQ and dK/dV on blocks of two warpgroups that split the output
  columns, and dK/dV's key tiles split over a thread-block cluster where
  the KV heads are too few to fill the card);
* ``split`` — the same one-warpgroup passes on three bf16 pieces of each
  fp32 operand (q, k, v and dO; P and dS split in registers), for fp32 at
  every ``D`` in :data:`BWD_SPLIT_HEAD_DIMS` (all of them), dK and dV on
  two warpgroups, each tile's products added to the gradients in fp32; at
  ``D = 160`` and ``256``, where a tile's pieces leave no room for the
  resident pair and a ring stage in 227 KB, dQ and dK/dV as column pairs:
  two blocks of a thread-block cluster, each half the columns, summing
  their S and dP partials through distributed shared memory
  (:func:`attention_bwd_split_model` sums them in the same order);
* ``scalar`` — three scalar kernels (fp32 and bf16), which no path takes:
  only when named (``_launch_bwd(..., kind="scalar")``), the yardstick.

:data:`LAUNCHES` counts ``flash_attention_bwd`` (every backward call) and
``flash_attention_bwd_tc``, ``flash_attention_bwd_split`` and
``flash_attention_bwd_scalar`` (each variant), and :data:`SHAPE_LAUNCHES`
the same calls under ``"bwd_tc"``, ``"bwd_split"`` or ``"bwd_scalar"``.
Under ``torch.inference_mode`` or ``no_grad`` (serving) nothing changes.
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

__all__ = ["BWD_PAIR_HEAD_DIMS", "BWD_SPLIT_HEAD_DIMS", "BWD_TC_HEAD_DIMS",
           "FlashAttentionFn", "HEAD_DIMS", "LAUNCHES", "SHAPE_LAUNCHES",
           "SPLIT_PAIRS", "TC_HEAD_DIMS", "attention_bwd_ref",
           "attention_bwd_split_model",
           "attention_ref", "attention_split_model", "bwd_variant",
           "flash_attention", "piece_einsum", "reset_launches",
           "split_pieces", "variant"]

#: kernel launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_attention_tc": 0,
                             "flash_attention_split": 0,
                             "flash_attention_scalar": 0,
                             "flash_attention_bwd": 0,
                             "flash_attention_bwd_tc": 0,
                             "flash_attention_bwd_split": 0,
                             "flash_attention_bwd_scalar": 0}
#: the same launches by (variant, Tq, Tk, causal)
SHAPE_LAUNCHES: Dict[Tuple[str, int, int, bool], int] = {}
#: the head sizes the kernel is built for: every attention config the port
#: serves (the reduced configs' 16, stablelm's 80, pixtral's 160,
#: recurrentgemma's 256) and the reference kernel tests' 32 and 64
HEAD_DIMS = (16, 32, 64, 80, 128, 160, 256)
#: the bf16 head sizes the tensor-core kernel takes: rows cut into 128-byte
#: blocks and a 32- or 64-byte tail, each swizzled by its width
TC_HEAD_DIMS = (16, 32, 64, 80, 128, 160, 256)
#: the bf16 head sizes the tensor-core backward takes: all of them (dK
#: and dV, D / 2 fp32 each a thread, fit one warpgroup beside S and dP up
#: to D = 128; at D = 160 and 256 two warpgroups split the columns)
BWD_TC_HEAD_DIMS = HEAD_DIMS
#: the fp32 head sizes the split backward takes: all of them (its
#: one-warpgroup passes' resident tiles' pieces and a ring stage fit 227 KB
#: up to D = 128; at D = 160 and 256 dQ and dK/dV split the columns over a
#: cluster of two blocks)
BWD_SPLIT_HEAD_DIMS = HEAD_DIMS
#: the head sizes whose split backward takes S and dP as the sum of two
#: column halves' partials (a column pair)
BWD_PAIR_HEAD_DIMS = (160, 256)
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
    "flash_attention_fwd_split": [_P] * 5 + [_I] * 8 + [ctypes.c_float, _P],
}
_BWD_SIGNATURES = {"flash_attention_bwd": [_P] * 11 + [_I] * 8
                   + [ctypes.c_float, _I, _P],
                   "flash_attention_bwd_sm90": [_P] * 9 + [_I] * 8
                   + [ctypes.c_float, _P],
                   "flash_attention_bwd_split": [_P] * 10 + [_I] * 8
                   + [ctypes.c_float, _P]}
#: the tensor-core backward's row statistics are padded to its 64-row tile
_BWD_ROWS = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    SHAPE_LAUNCHES.clear()


def variant(dtype: torch.dtype, D: int) -> str:
    """The kernel a CUDA call runs: ``"tc"`` for bf16 at ``D`` in
    :data:`TC_HEAD_DIMS`, ``"split"`` for fp32 at every ``D`` in
    :data:`HEAD_DIMS`, else ``"scalar"``."""
    if dtype == torch.bfloat16 and D in TC_HEAD_DIMS:
        return "tc"
    if dtype == torch.float32 and D in HEAD_DIMS:
        return "split"
    return "scalar"


def bwd_variant(dtype: torch.dtype, D: int) -> str:
    """The backward kernel a CUDA call runs: ``"tc"`` for bf16 at ``D`` in
    :data:`BWD_TC_HEAD_DIMS`, ``"split"`` for fp32 at ``D`` in
    :data:`BWD_SPLIT_HEAD_DIMS`, else ``"scalar"``."""
    if dtype == torch.bfloat16 and D in BWD_TC_HEAD_DIMS:
        return "tc"
    if dtype == torch.float32 and D in BWD_SPLIT_HEAD_DIMS:
        return "split"
    return "scalar"


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


def split_pieces(x: torch.Tensor) -> torch.Tensor:
    """The three bf16 pieces of fp32 ``x``, stacked first: ``p0 =
    bf16(x)``, ``p1 = bf16(x - p0)``, ``p2 = bf16(x - p0 - p1)``, each
    rounded to nearest and each difference exact in fp32, so that they sum
    to ``x`` exactly wherever a bf16 can hold ``x``'s last bit (|x| >=
    2^-110).  Where ``bf16(x)`` overflows, ``p0`` rounds toward zero
    instead.  The plain version of the kernels' ``split3``
    (``csrc/sm90.cuh``); only tests use it."""
    x = x.float()
    p0 = x.to(torch.bfloat16)
    over = torch.isinf(p0) & torch.isfinite(x)
    if bool(over.any()):
        # toward zero: drop the 16 low bits of the fp32 pattern
        rz = (x.view(torch.int32) & -65536).view(torch.float32)
        p0 = torch.where(over, rz.to(torch.bfloat16), p0)
    r = x - p0.float()
    p1 = r.to(torch.bfloat16)
    p2 = (r - p1.float()).to(torch.bfloat16)
    return torch.stack([p0, p1, p2])


#: the piece pairs (A's, B's) of the split kernels' six products, in the
#: order they are issued: smallest first (``csrc/sm90.cuh``)
SPLIT_PAIRS = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))


def piece_einsum(eq: str, a: torch.Tensor, b: torch.Tensor,
                 pieces: int = 3) -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` as the split kernels compute it in fp32:
    for ``pieces`` 3 the sum of the six products of :data:`SPLIT_PAIRS`
    on :func:`split_pieces`, each exact in fp32 (8 x 8 significant bits),
    summed in fp32; for 1 the one product of ``a`` and ``b`` rounded to
    bf16, as the bf16 kernels take them.  Only tests use it."""
    if pieces == 1:
        return torch.einsum(eq, a.to(torch.bfloat16).float(),
                            b.to(torch.bfloat16).float())
    pa, pb = split_pieces(a).float(), split_pieces(b).float()
    out = None
    for i, j in SPLIT_PAIRS:
        term = torch.einsum(eq, pa[i], pb[j])
        out = term if out is None else out + term
    return out


def attention_split_model(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None,
                          pieces: int = 3) -> torch.Tensor:
    """:func:`attention_ref`'s output (float32) by the split forward's
    arithmetic: S = Q K^T by :func:`piece_einsum`, scaled and masked
    (-1e30) in fp32, ``p = exp(s - max)`` in fp32, O = P V by
    :func:`piece_einsum` on p over the row sum of p.  ``pieces`` 1 is the
    one-product (bf16 operand) model.  Only tests use it."""
    B, Tq, H, D = q.shape
    Tk, G = k.shape[1], k.shape[2]
    R = H // G
    qg = q.float().reshape(B, Tq, G, R, D)
    s = piece_einsum("btgrd,bsgd->bgrts", qg, k.float(), pieces)
    s = s / math.sqrt(D)
    mask = _mask(Tq, Tk, causal, window, q.device)
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = piece_einsum("bgrts,bsgd->btgrd", p, v.float(), pieces)
    o = o / p.sum(-1).permute(0, 3, 1, 2)[..., None]
    return o.reshape(B, Tq, H, D)


def attention_bwd_split_model(q, k, v, o, do, *, causal: bool = True,
                              window: Optional[int] = None,
                              pieces: int = 3
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """:func:`attention_bwd_ref`'s gradients (float32) by the split
    backward's arithmetic: S, dP = dO V^T, dV = P^T dO, dK = dS^T Q and
    dQ = dS K by :func:`piece_einsum`; P, delta = rowsum(dO * O) and dS =
    P (dP - delta) in fp32.  At the column pair's head sizes
    (:data:`BWD_PAIR_HEAD_DIMS`) S and dP are each the sum of two
    partials over the halves of the D columns, the first half's plus the
    second's, as the pair's two blocks add them.  Only tests use it."""
    B, Tq, H, D = q.shape
    Tk, G = k.shape[1], k.shape[2]
    R = H // G
    scale = 1.0 / math.sqrt(D)
    qg = q.float().reshape(B, Tq, G, R, D)
    dog = do.float().reshape(B, Tq, G, R, D)
    kf, vf = k.float(), v.float()
    halves = ([slice(0, D // 2), slice(D // 2, D)]
              if D in BWD_PAIR_HEAD_DIMS else [slice(0, D)])

    def contract(a, b):   # over D, a column pair's halves added in order
        parts = [piece_einsum("btgrd,bsgd->bgrts", a[..., c], b[..., c],
                              pieces) for c in halves]
        return parts[0] if len(parts) == 1 else parts[0] + parts[1]
    mask = _mask(Tq, Tk, causal, window, q.device)
    s = contract(qg, kf) * scale
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    delta = (dog * o.float().reshape(B, Tq, G, R, D)).sum(-1)
    dp = contract(dog, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    ds = torch.where(mask, ds, torch.zeros((), device=q.device))
    dv = piece_einsum("bgrts,btgrd->bsgd", p, dog, pieces)
    dk = piece_einsum("bgrts,btgrd->bsgd", ds, qg, pieces) * scale
    dq = piece_einsum("bgrts,bsgd->btgrd", ds, kf, pieces) * scale
    return dq.reshape(B, Tq, H, D), dk, dv


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


def _refuse_unrouted(kind: str, routed: str, dtype, D: int, dims) -> None:
    """Raise unless ``routed`` (the variant the dtype and head size pick)
    is ``kind``: ``"tc"`` takes bf16 and ``"split"`` fp32, each only at
    its head sizes ``dims``."""
    if routed != kind:
        want = "bf16" if kind == "tc" else "float32"
        what = "tensor-core" if kind == "tc" else "split"
        raise ValueError(f"the {what} kernel takes {want} at head sizes "
                         f"{dims}, got {dtype} at {D}")


def _aligned(tensors) -> None:
    # the tensor maps' rule: 16-byte aligned bases (row strides of 2D or
    # 4D bytes are multiples of 16 at every head size)
    for name, t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def _launch(q, k, v, causal: bool, window: Optional[int],
            kind: Optional[str] = None) -> torch.Tensor:
    """Launch ``kind`` (default: :func:`variant`'s choice) on CUDA
    tensors; ``"scalar"`` takes every dtype and head size it is built
    for, ``"tc"`` and ``"split"`` only what :func:`variant` routes to
    them."""
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
    if kind not in ("tc", "split", "scalar"):
        raise ValueError(f"unknown kernel variant {kind!r}")
    if kind != "scalar":
        _refuse_unrouted(kind, variant(q.dtype, D), q.dtype, D,
                         TC_HEAD_DIMS if kind == "tc" else HEAD_DIMS)
        _aligned((("q", q), ("k", k), ("v", v)))
    o = torch.empty_like(q)
    lib = _build.load(_SOURCE, _SIGNATURES)
    stream = _build.current_stream(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Tq,
            Tk, H, G, D, int(causal), window or 0, 1.0 / math.sqrt(D))
    if kind == "tc":
        _build.check(_build.launch_on(q, lib.flash_attention_fwd_sm90,
                                      *args, stream),
                     "flash_attention_fwd_sm90")
    elif kind == "split":
        # q's, k's and v's three bf16 pieces, written by the call
        pieces = torch.empty(3 * (q.numel() + 2 * k.numel()),
                             dtype=torch.bfloat16, device=q.device)
        _build.check(_build.launch_on(
            q, lib.flash_attention_fwd_split, *args[:4], pieces.data_ptr(),
            *args[4:], stream), "flash_attention_fwd_split")
    else:
        _build.check(_build.launch_on(q, lib.flash_attention_fwd, *args,
                                      _DTYPE_CODES[q.dtype], stream),
                     "flash_attention_fwd")
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
    plain version.  A bidirectional call whose window leaves a query row
    no key in reach (``Tq >= Tk + window``) gives that row the mean of v
    over the Tk keys, as the plain version does, and its gradients are
    those of that mean."""
    _check(q, k, v, causal, window)
    if q.device.type == "cpu":
        _check_causal(q.shape[1], k.shape[1], causal)
        return attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window)
    return _launch(q, k, v, causal, window)


def _launch_bwd(q, k, v, o, do, causal: bool, window: Optional[int],
                kind: Optional[str] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward ``kind`` (default: :func:`bwd_variant`'s
    choice; ``csrc/flash_attention_bwd.cu``, counted in the total and the
    variant's count) on CUDA tensors:
    (dq, dk, dv) in q's dtype.  ``"scalar"`` takes every dtype and head
    size it is built for, ``"tc"`` and ``"split"`` only what
    :func:`bwd_variant` routes to them (``"split"``: fp32 at every head
    size, column pairs at ``D = 160`` and ``256``).  A call the kernel
    cannot take raises; nothing falls back to another variant."""
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
    kind = kind or bwd_variant(q.dtype, D)
    if kind not in ("tc", "split", "scalar"):
        raise ValueError(f"unknown kernel variant {kind!r}")
    if kind != "scalar":
        _refuse_unrouted(kind, bwd_variant(q.dtype, D), q.dtype, D,
                         BWD_TC_HEAD_DIMS if kind == "tc"
                         else BWD_SPLIT_HEAD_DIMS)
        _aligned((("q", q), ("k", k), ("v", v), ("o", o), ("do", do)))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    lib = _build.load(_BWD_SOURCE, _BWD_SIGNATURES)
    stream = _build.current_stream(q)
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    shape = (B, Tq, Tk, H, G, D, int(causal), window or 0,
             1.0 / math.sqrt(D))
    if kind != "scalar":
        # the row statistics (max, 1 / sum, rowsum(dO * O)), rows padded
        # to the kernel's tile
        Tqp = -(-Tq // _BWD_ROWS) * _BWD_ROWS
        stats = torch.empty((3, B * H, Tqp), dtype=torch.float32,
                            device=q.device)
        if kind == "tc":
            _build.check(_build.launch_on(
                q, lib.flash_attention_bwd_sm90, *head, stats.data_ptr(),
                *shape, stream), "flash_attention_bwd_sm90")
        else:
            # q's, k's, v's and do's three bf16 pieces, written by the call
            pieces = torch.empty(3 * (2 * q.numel() + 2 * k.numel()),
                                 dtype=torch.bfloat16, device=q.device)
            _build.check(_build.launch_on(
                q, lib.flash_attention_bwd_split, *head, stats.data_ptr(),
                pieces.data_ptr(), *shape, stream),
                "flash_attention_bwd_split")
    else:
        stats = torch.empty((3, B, H, Tq), dtype=torch.float32,
                            device=q.device)
        _build.check(_build.launch_on(
            q, lib.flash_attention_bwd, *head, stats[0].data_ptr(),
            stats[1].data_ptr(), stats[2].data_ptr(), *shape,
            _DTYPE_CODES[q.dtype], stream), "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    LAUNCHES[f"flash_attention_bwd_{kind}"] += 1
    key = (f"bwd_{kind}", Tq, Tk, bool(causal))
    SHAPE_LAUNCHES[key] = SHAPE_LAUNCHES.get(key, 0) + 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Attention on CUDA tensors with its gradient: the forward kernel
    :func:`variant` names, and the backward kernel :func:`bwd_variant`
    names.  Reached through :func:`flash_attention` when a gradient is
    wanted."""

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
