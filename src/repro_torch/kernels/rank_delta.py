"""The fused delta-rank reprice: one fleet tick, as hand-written CUDA.

Counterpart of the reference's Pallas kernel
``repro/kernels/rank_delta.py::_make_kernel`` (``fused_reprice`` and
``fused_reprice_heads``).  One tick of a fleet of member rankings over a
shared (J x C) universe:

* **row minima** — the masked row minima of ``hours * new_prices`` and
  the count of rows whose minimum moved (kernel ``rowmin``);
* **fold** — both norm matrices recomputed from the residents,
  ``P = row_masks @ norm_new`` and ``D = row_masks @ (norm_new -
  norm_old)``; changed columns take ``P``, the others ``scores + D``
  (kernel ``fold``);
* **heads** — optionally every member's k best ``(index, value)`` in
  (score, catalog order), always k *distinct* configs: for k up to
  :data:`SELECT_CAP` one pass over the row in two stages (kernel
  ``select``: per-chunk heads of :data:`SELECT_CHUNK` columns, then a
  merge; two launches on the stream, one count), above it k rounds of a
  block-wide argmin (kernel ``select_rounds``), chosen by k alone.

The kernels live in ``csrc/rank_delta.cu`` (see its header for what
bounds them on the card and why the arithmetic is exact).  Each public
wrapper takes the kernel's plain PyTorch version for tensors on the CPU;
for CUDA tensors it launches the kernel or raises — it never falls back.
:data:`LAUNCHES` counts kernel launches, per kernel, and nothing else.

The reference's in-kernel head tail repeats an index when a member has
fewer finite configs than ``k`` (it re-masks the taken column to ``inf``,
which an all-``inf`` tail already is).  The port keeps a taken-set
instead, so its heads equal ``ranking()[:k]`` in every case.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

__all__ = ["LAUNCHES", "SELECT_CAP", "SELECT_CHUNK", "fold_plain",
           "fused_reprice", "fused_reprice_heads", "fused_reprice_plain",
           "reset_launches", "rowmin_plain", "select_heads",
           "select_heads_plain"]

#: kernel launches since the last :func:`reset_launches`, by kernel
LAUNCHES: Dict[str, int] = {"rowmin": 0, "fold": 0, "select": 0,
                             "select_rounds": 0}
#: the largest k the two-stage ``select`` serves (``kSelectCap`` in
#: ``csrc/rank_delta.cu``); larger k take ``select_rounds``
SELECT_CAP = 64
#: columns a stage-1 block of ``select`` reads (``kSelectChunk``)
SELECT_CHUNK = 2048

_SOURCE = "rank_delta"
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "rank_delta_rowmin": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    "rank_delta_fold": [_P] * 10 + [_I, _I, _I, _P],
    "rank_delta_select": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "rank_delta_select_rounds": [_P, _P, _P, _P, _I, _I, _I, _P],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    return _build.load(_SOURCE, _SIGNATURES)


# --- plain versions ---------------------------------------------------------

def _inf(t: torch.Tensor) -> torch.Tensor:
    return torch.tensor(float("inf"), dtype=t.dtype, device=t.device)


def rowmin_plain(hours, mask, new_prices, row_best):
    """Kernel ``rowmin`` in plain PyTorch: ``(row_best (J, 1), moved (1, 1)
    int32)`` — the masked row minima of ``hours * new_prices`` and the
    count of rows whose minimum changed (order-free, so bit-identical to
    the kernel)."""
    rb_new = torch.where(mask, hours * new_prices, _inf(hours)).amin(
        dim=1, keepdim=True)
    moved = (rb_new != row_best).sum().to(torch.int32).reshape(1, 1)
    return rb_new, moved


def fold_plain(hours, mask, old_prices, new_prices, changed, row_best,
               rb_new, row_masks, scores):
    """Kernel ``fold`` in plain PyTorch: both norms recomputed with the
    kernel's float32 expressions (elementwise multiply and divide are
    IEEE, so the cells are bit-identical), ``P = row_masks @ norm_new``,
    ``D = row_masks @ (norm_new - norm_old)``, then ``changed ? P :
    scores + D``.  The two member sums may round in another order."""
    zero = torch.zeros((), dtype=hours.dtype, device=hours.device)
    norm_old = torch.where(mask, (hours * old_prices) / row_best, zero)
    norm_new = torch.where(mask, (hours * new_prices) / rb_new, zero)
    re_reduce = row_masks @ norm_new
    delta = row_masks @ (norm_new - norm_old)
    return torch.where(changed > 0, re_reduce, scores + delta)


def fused_reprice_plain(hours, mask, old_prices, new_prices, changed,
                        row_best, row_masks, scores):
    """The whole tick in plain PyTorch: ``(scores, row_best, moved)``."""
    rb_new, moved = rowmin_plain(hours, mask, new_prices, row_best)
    out = fold_plain(hours, mask, old_prices, new_prices, changed,
                     row_best, rb_new, row_masks, scores)
    return out, rb_new, moved


def select_heads_plain(scores, finite, k: int):
    """Every row's k best ``(indices, values)`` of the ``inf``-masked
    scores by a stable sort: distinct columns, ties in catalog order,
    unprofiled configs last in catalog order."""
    masked = torch.where(finite, scores, _inf(scores))
    idx = torch.sort(masked, dim=1, stable=True).indices[:, :k]
    return idx.to(torch.int32), masked.gather(1, idx)


# --- checks -----------------------------------------------------------------

def _check(name: str, t: torch.Tensor, dtype: torch.dtype,
           shape: Tuple[int, ...], device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_tick(hours, mask, old_prices, new_prices, changed, row_best,
                row_masks, scores) -> Tuple[int, int, int]:
    if not isinstance(hours, torch.Tensor) or hours.dim() != 2:
        raise ValueError("hours must be a (J, C) tensor")
    J, C = hours.shape
    S = row_masks.shape[0] if isinstance(row_masks, torch.Tensor) else -1
    dev = hours.device
    f32 = torch.float32
    _check("hours", hours, f32, (J, C), dev)
    _check("mask", mask, torch.bool, (J, C), dev)
    for name, vec in (("old_prices", old_prices),
                      ("new_prices", new_prices), ("changed", changed)):
        _check(name, vec, f32, (1, C), dev)
    _check("row_best", row_best, f32, (J, 1), dev)
    _check("row_masks", row_masks, f32, (S, J), dev)
    _check("scores", scores, f32, (S, C), dev)
    return J, C, S


def _check_k(k: int, C: int) -> int:
    if not isinstance(k, int) or isinstance(k, bool) or not 1 <= k <= C:
        raise ValueError(f"k must be an int in [1, {C}], got {k!r}")
    return k


def _stream(t: torch.Tensor) -> int:
    return _build.current_stream(t)


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


# --- kernel launches ----------------------------------------------------------

def _launch_rowmin(hours, mask, new_prices, row_best):
    J, C = hours.shape
    rb_new = torch.empty_like(row_best)
    moved = torch.zeros((1, 1), dtype=torch.int32, device=hours.device)
    _build.check(_lib().rank_delta_rowmin(
        hours.data_ptr(), mask.data_ptr(), new_prices.data_ptr(),
        row_best.data_ptr(), rb_new.data_ptr(), moved.data_ptr(), J, C,
        _stream(hours)), "rank_delta_rowmin")
    LAUNCHES["rowmin"] += 1
    return rb_new, moved


def _launch_fold(hours, mask, old_prices, new_prices, changed, row_best,
                 rb_new, row_masks, scores):
    J, C = hours.shape
    out = torch.empty_like(scores)
    _build.check(_lib().rank_delta_fold(
        hours.data_ptr(), mask.data_ptr(), old_prices.data_ptr(),
        new_prices.data_ptr(), changed.data_ptr(), row_best.data_ptr(),
        rb_new.data_ptr(), row_masks.data_ptr(), scores.data_ptr(),
        out.data_ptr(), J, C, scores.shape[0], _stream(hours)),
        "rank_delta_fold")
    LAUNCHES["fold"] += 1
    return out


def _launch_tick(hours, mask, old_prices, new_prices, changed, row_best,
                 row_masks, scores):
    # the TPU grid's phase order (row minima before the fold) becomes
    # launch order on one stream
    rb_new, moved = _launch_rowmin(hours, mask, new_prices, row_best)
    out = _launch_fold(hours, mask, old_prices, new_prices, changed,
                       row_best, rb_new, row_masks, scores)
    return out, rb_new, moved


def _launch_select(scores, finite, k):
    """The k-head on the card: the two-stage ``select`` for k up to
    :data:`SELECT_CAP`, else ``select_rounds``."""
    S, C = scores.shape
    dev = scores.device
    if k > SELECT_CAP:
        top_i = torch.empty((S, k), dtype=torch.int32, device=dev)
        top_v = torch.empty((S, k), dtype=torch.float32, device=dev)
        _build.check(_lib().rank_delta_select_rounds(
            scores.data_ptr(), finite.data_ptr(), top_v.data_ptr(),
            top_i.data_ptr(), S, C, k, _stream(scores)),
            "rank_delta_select_rounds")
        LAUNCHES["select_rounds"] += 1
        return top_i, top_v
    # one allocation (at one row the call is bound by the host's work):
    # top_i, top_v, then the stage-1 keys, 8-byte aligned
    chunks = -(-C // SELECT_CHUNK)
    buf = torch.empty((2 + 2 * chunks, S, k), dtype=torch.int32, device=dev)
    top_i, top_v = buf[0], buf[1].view(torch.float32)
    # vector loads where every row starts 16 (scores) and 4 (flags) bytes
    # aligned: a shape and address rule, decided before the launch
    vec = C % 4 == 0 and scores.data_ptr() % 16 == 0 \
        and finite.data_ptr() % 4 == 0
    base = buf.data_ptr()
    _build.check(_lib().rank_delta_select(
        scores.data_ptr(), finite.data_ptr(), base + 4 * S * k, base,
        base + 8 * S * k, S, C, k, SELECT_CHUNK, int(vec), _stream(scores)),
        "rank_delta_select")
    LAUNCHES["select"] += 1
    return top_i, top_v


# --- public wrappers ------------------------------------------------------------

def fused_reprice(hours, mask, old_prices, new_prices, changed, row_best,
                  row_masks, scores):
    """One tick: ``(scores (S, C), row_best (J, 1), moved (1, 1) int32)``
    — the reference's argument order, without its TPU tiling arguments.
    CUDA tensors run the ``rowmin`` and ``fold`` kernels; CPU tensors the
    plain version."""
    _check_tick(hours, mask, old_prices, new_prices, changed, row_best,
                row_masks, scores)
    tick = _launch_tick if _on_cuda(hours) else fused_reprice_plain
    return tick(hours, mask, old_prices, new_prices, changed, row_best,
                row_masks, scores)


def select_heads(scores, finite, k: int):
    """Every row's k-head ``(indices (S, k) int32, values (S, k))`` in
    (score, catalog order) over the ``inf``-masked scores.  CUDA tensors
    run the ``select`` kernels (``select_rounds`` above
    :data:`SELECT_CAP`); CPU tensors the plain stable sort."""
    if not isinstance(scores, torch.Tensor) or scores.dim() != 2:
        raise ValueError("scores must be an (S, C) tensor")
    S, C = scores.shape
    _check("scores", scores, torch.float32, (S, C), scores.device)
    _check("finite", finite, torch.bool, (S, C), scores.device)
    k = _check_k(k, C)
    if not _on_cuda(scores):
        return select_heads_plain(scores, finite, k)
    return _launch_select(scores, finite, k)


def fused_reprice_heads(hours, mask, old_prices, new_prices, changed,
                        row_best, row_masks, scores, finite, *, k: int):
    """The tick plus every member's k-head from the new scores:
    ``(scores, row_best, moved, top_i (S, k) int32, top_v (S, k))``."""
    _, C, S = _check_tick(hours, mask, old_prices, new_prices, changed,
                          row_best, row_masks, scores)
    _check("finite", finite, torch.bool, (S, C), hours.device)
    k = _check_k(k, C)
    if _on_cuda(hours):
        tick, select = _launch_tick, _launch_select
    else:
        tick, select = fused_reprice_plain, select_heads_plain
    out, rb, moved = tick(hours, mask, old_prices, new_prices, changed,
                          row_best, row_masks, scores)
    return (out, rb, moved) + select(out, finite, k)
