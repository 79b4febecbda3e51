"""The fused delta-rank reprice: one fleet tick, as hand-written CUDA.

Counterpart of the reference's Pallas kernel
``repro/kernels/rank_delta.py::_make_kernel`` (``fused_reprice`` and
``fused_reprice_heads``).  One tick of a fleet of member rankings over a
shared (J x C) universe:

* **prices** — the tick's ``(1, C)`` new prices and changed-column flags
  from its (column, price) pairs, which the reference builds on the host
  (:func:`scatter_prices`, kernel ``scatter``: the pairs checked and
  sent up in one copy, the old prices copied, the flags cleared and the
  pairs written, queued by one call);
* **row minima** — the masked row minima of ``hours * new_prices`` and
  the count of rows whose minimum moved (kernel ``rowmin``: each row split
  into chunks of :data:`ROWMIN_CHUNK` columns across blocks, combined in
  the same launch by the row's last block through scratch, one a (device,
  stream), whose arrival counters reset themselves; ``rowmin_row``, one
  block a row, is the yardstick it replaced and no wrapper path reaches
  it);
* **fold** — both norm matrices recomputed from the residents,
  ``P = row_masks @ norm_new`` and ``D = row_masks @ (norm_new -
  norm_old)``; changed columns take ``P``, the others ``scores + D``
  (kernel ``fold``: the rows split across a block's 8 warps, 32 columns
  a block, the warps' partials added in fixed order — one launch,
  bit-repeatable; ``fold_col``, one thread a column, is the yardstick
  it replaced and no wrapper path reaches it);
* **heads** — optionally every member's k best ``(index, value)`` in
  (score, catalog order), always k *distinct* configs.  For k up to
  :data:`SELECT_CAP` one pass over the row in two stages (kernel
  ``select``: per-chunk heads of :data:`SELECT_CHUNK` columns held in
  ``R`` registers a lane, then a merge; two launches, one count); above
  it each chunk sorted whole and a tree of merge-path merges cut to k
  (kernel ``select_sort``: 1 + ceil(log2(chunks)) launches, one count).
  :func:`_select_plan` maps ``(S, C, k)`` to the kernel, ``R`` and the
  scratch.  The k-round kernel (``select_rounds``) is a yardstick only.

:func:`fused_reprice` is the two halves in turn, and each half is public
too (:func:`row_minima`, :func:`fold_scores`): the sharded fleet runs
them shard by shard and combines the shards' row minima in between.

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
import math
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build

__all__ = ["LAUNCHES", "ROWMIN_CHUNK", "SELECT_CAP", "SELECT_CHUNK",
           "fold_plain", "fold_scores", "scatter_prices",
           "scatter_prices_plain", "fused_reprice", "fused_reprice_heads",
           "reset_launches", "row_minima", "rowmin_plain", "select_heads",
           "select_heads_plain"]

#: kernel launches since the last :func:`reset_launches`, by kernel
#: (``rowmin_row``, ``fold_col`` and ``select_rounds`` are the
#: yardsticks: no wrapper path launches them)
LAUNCHES: Dict[str, int] = {"scatter": 0, "rowmin": 0, "rowmin_row": 0,
                             "fold": 0, "fold_col": 0, "select": 0,
                             "select_sort": 0, "select_rounds": 0}
#: columns a ``rowmin`` block reads (``kRowminCols`` in
#: ``csrc/rank_delta.cu``)
ROWMIN_CHUNK = 4096
#: the largest k the two-stage ``select`` serves (``kSelectCap`` in
#: ``csrc/rank_delta.cu``); larger k take ``select_sort``
SELECT_CAP = 256
#: columns a stage-1 block of either k-head reads (``kSelectChunk``)
SELECT_CHUNK = 2048

_SOURCE = "rank_delta"
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "rank_delta_scatter": [_P] * 6 + [_I, _I, _P],
    "rank_delta_rowmin": [_P] * 8 + [_I] * 3 + [_P],
    "rank_delta_rowmin_row": [_P] * 6 + [_I, _I, _P],
    "rank_delta_fold": [_P] * 10 + [_I, _I, _I, _P],
    "rank_delta_fold_col": [_P] * 10 + [_I, _I, _I, _P],
    "rank_delta_select": [_P] * 5 + [_I] * 6 + [_P],
    "rank_delta_select_sort": [_P] * 5 + [_I] * 5 + [_P],
    "rank_delta_select_rounds": [_P, _P, _P, _P, _I, _I, _I, _P],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    return _build.load(_SOURCE, _SIGNATURES)


#: ``rowmin``'s scratch by (device, stream handle): arrival counters
#: (int32, all 0 between launches: each launch resets what it bumps) and
#: the rows' partial minima (float32).  Launches on one stream are ordered,
#: so they share it; launches on two streams may overlap, so they never do.
_ROWMIN_SCRATCH: Dict[Tuple[torch.device, int],
                      Tuple[torch.Tensor, torch.Tensor]] = {}
#: what ``rank_delta_scatter`` returns on a stream being captured into a
#: CUDA graph (``cudaErrorStreamCaptureUnsupported``)
_CAPTURE_REFUSED = 900


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


def scatter_prices_plain(cols, prices, old_prices):
    """Kernel ``scatter`` in plain PyTorch: ``(new_prices, changed)``, both
    ``(1, C)`` on ``old_prices``' device — ``old_prices`` with the pairs'
    prices written in, and 1.0 at their columns (0 elsewhere).  ``cols``
    and ``prices`` are 1-D numpy arrays of one length, int32 columns
    (distinct, in ``[0, C)``) and float32 prices."""
    dev = old_prices.device
    idx = torch.from_numpy(cols).to(dev, torch.int64)
    new_prices = old_prices.index_copy(
        1, idx, torch.from_numpy(prices).to(dev).view(1, -1))
    return new_prices, torch.zeros_like(old_prices).index_fill_(1, idx, 1.0)


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


def _check_rowmin(hours, mask, new_prices, row_best) -> Tuple[int, int]:
    if not isinstance(hours, torch.Tensor) or hours.dim() != 2:
        raise ValueError("hours must be a (J, C) tensor")
    J, C = hours.shape
    dev = hours.device
    _check("hours", hours, torch.float32, (J, C), dev)
    _check("mask", mask, torch.bool, (J, C), dev)
    _check("new_prices", new_prices, torch.float32, (1, C), dev)
    _check("row_best", row_best, torch.float32, (J, 1), dev)
    return J, C


def _check_tick(hours, mask, old_prices, new_prices, changed, row_best,
                row_masks, scores) -> Tuple[int, int, int]:
    J, C = _check_rowmin(hours, mask, new_prices, row_best)
    S = row_masks.shape[0] if isinstance(row_masks, torch.Tensor) else -1
    dev = hours.device
    f32 = torch.float32
    _check("old_prices", old_prices, f32, (1, C), dev)
    _check("changed", changed, f32, (1, C), dev)
    _check("row_masks", row_masks, f32, (S, J), dev)
    _check("scores", scores, f32, (S, C), dev)
    return J, C, S


def _check_pairs(cols, prices, C: int) -> Tuple[np.ndarray, np.ndarray]:
    """A tick's pairs as ``(int32 columns, float32 prices)``; raises unless
    the columns are integers, distinct and in ``[0, C)`` and the prices
    floats of the same length."""
    cols, prices = np.asarray(cols), np.asarray(prices)
    if cols.ndim != 1 or cols.dtype.kind not in "iu":
        raise TypeError(f"cols must be a 1-D integer array, got "
                        f"{cols.dtype} of shape {cols.shape}")
    if prices.shape != cols.shape or prices.dtype.kind != "f":
        raise TypeError(f"prices must be a 1-D float array of {cols.size} "
                        f"entries, got {prices.dtype} of shape "
                        f"{prices.shape}")
    if cols.size:
        order = np.sort(cols)
        if order[0] < 0 or order[-1] >= C:
            raise ValueError(f"columns must lie in [0, {C})")
        if (order[1:] == order[:-1]).any():
            raise ValueError("columns must be distinct")
    return (np.ascontiguousarray(cols, np.int32),
            np.ascontiguousarray(prices, np.float32))


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

def _rowmin_scratch(device: torch.device, stream: int, J: int,
                    partials: int):
    """``rowmin``'s scratch for launches on ``stream``, grown to ``J + 1``
    counters and ``partials`` minima (a new counter buffer is zeroed once;
    the old one's launches finish first on the stream).  It must not grow
    while the stream is captured into a CUDA graph: the zeroing would only
    be recorded, and the buffers would come from the graph's pool."""
    counters, part = _ROWMIN_SCRATCH.get((device, stream), (None, None))
    grow = counters is None or counters.numel() < J + 1
    if grow or part.numel() < partials:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "rowmin's scratch for this stream must exist before a CUDA "
                "graph is captured: launch rowmin once at this shape on the "
                "capture stream first")
        if grow:
            counters = torch.zeros(max(J + 1, 64), dtype=torch.int32,
                                   device=device)
        if part is None or part.numel() < partials:
            part = torch.empty(max(partials, 1024), dtype=torch.float32,
                               device=device)
        _ROWMIN_SCRATCH[device, stream] = counters, part
    return counters, part


def _launch_scatter(cols, prices, old_prices):
    """The scatter on the card from checked pairs (``cols`` int32 and
    ``prices`` float32 numpy arrays), sent up in one copy."""
    C = old_prices.shape[1]
    n = cols.size
    new_prices = torch.empty_like(old_prices)
    changed = torch.empty_like(old_prices)
    d_pairs = torch.empty(2 * n, dtype=torch.int32, device=old_prices.device)
    err = _build.launch_on(
        old_prices, _lib().rank_delta_scatter, cols.ctypes.data,
        prices.ctypes.data, d_pairs.data_ptr(), old_prices.data_ptr(),
        new_prices.data_ptr(), changed.data_ptr(), n, C,
        _stream(old_prices))
    if err == _CAPTURE_REFUSED:
        raise RuntimeError("scatter_prices cannot be captured into a CUDA "
                           "graph: a replay would read its pairs from host "
                           "memory again")
    _build.check(err, "rank_delta_scatter")
    LAUNCHES["scatter"] += 1
    return new_prices, changed


def _launch_rowmin(hours, mask, new_prices, row_best, variant="rowmin"):
    """The row minima on the card: the split ``rowmin``, or by name the
    one-block-a-row ``rowmin_row`` it replaced."""
    if variant not in ("rowmin", "rowmin_row"):
        raise ValueError(f"unknown rowmin kernel {variant!r}")
    J, C = hours.shape
    lib = _lib()
    rb_new = torch.empty_like(row_best)
    if variant == "rowmin_row":
        moved = torch.zeros((1, 1), dtype=torch.int32, device=hours.device)
        err = _build.launch_on(
            hours, lib.rank_delta_rowmin_row, hours.data_ptr(),
            mask.data_ptr(), new_prices.data_ptr(), row_best.data_ptr(),
            rb_new.data_ptr(), moved.data_ptr(), J, C, _stream(hours))
    else:
        # written by the kernel, never accumulated: no fill launch
        moved = torch.empty((1, 1), dtype=torch.int32, device=hours.device)
        stream = _stream(hours)
        counters, partials = _rowmin_scratch(
            hours.device, stream, J, J * max(1, -(-C // ROWMIN_CHUNK)))
        # vector loads where C % 4 == 0 and the bases are aligned: the
        # shape and address rule of the k-head's ``vec``
        vec = C % 4 == 0 and hours.data_ptr() % 16 == 0 \
            and new_prices.data_ptr() % 16 == 0 and mask.data_ptr() % 4 == 0
        err = _build.launch_on(
            hours, lib.rank_delta_rowmin, hours.data_ptr(), mask.data_ptr(),
            new_prices.data_ptr(), row_best.data_ptr(), rb_new.data_ptr(),
            moved.data_ptr(), counters.data_ptr(), partials.data_ptr(), J, C,
            int(vec), stream)
    _build.check(err, f"rank_delta_{variant}")
    LAUNCHES[variant] += 1
    return rb_new, moved


def _launch_fold(hours, mask, old_prices, new_prices, changed, row_best,
                 rb_new, row_masks, scores, variant="fold"):
    """The fold on the card: the row-split ``fold``, or by name the
    column-per-thread ``fold_col`` it replaced."""
    if variant not in ("fold", "fold_col"):
        raise ValueError(f"unknown fold kernel {variant!r}")
    J, C = hours.shape
    out = torch.empty_like(scores)
    _build.check(_build.launch_on(
        hours, getattr(_lib(), f"rank_delta_{variant}"), hours.data_ptr(),
        mask.data_ptr(), old_prices.data_ptr(), new_prices.data_ptr(),
        changed.data_ptr(), row_best.data_ptr(), rb_new.data_ptr(),
        row_masks.data_ptr(), scores.data_ptr(), out.data_ptr(), J, C,
        scores.shape[0], _stream(hours)),
        f"rank_delta_{variant}")
    LAUNCHES[variant] += 1
    return out


def _rowmin(hours, mask, new_prices, row_best):
    """Kernel ``rowmin`` on CUDA tensors, its plain version on the CPU."""
    rowmin = _launch_rowmin if _on_cuda(hours) else rowmin_plain
    return rowmin(hours, mask, new_prices, row_best)


def _fold(hours, mask, old_prices, new_prices, changed, row_best, rb_new,
          row_masks, scores):
    """Kernel ``fold`` on CUDA tensors, its plain version on the CPU."""
    fold = _launch_fold if _on_cuda(hours) else fold_plain
    return fold(hours, mask, old_prices, new_prices, changed, row_best,
                rb_new, row_masks, scores)


def _tick(hours, mask, old_prices, new_prices, changed, row_best, row_masks,
          scores):
    # the TPU grid's phase order (row minima before the fold) becomes
    # launch order on one stream
    rb_new, moved = _rowmin(hours, mask, new_prices, row_best)
    out = _fold(hours, mask, old_prices, new_prices, changed, row_best,
                rb_new, row_masks, scores)
    return out, rb_new, moved


class SelectPlan(NamedTuple):
    """How the card computes an (S, C) k-head."""
    #: ``"select"`` (two stages, k <= :data:`SELECT_CAP`) or
    #: ``"select_sort"`` (chunk sorts and a merge tree)
    kernel: str
    #: ``select``: 32-key register lists a lane (1, 2, 4 or 8); else 0
    R: int
    #: the scratch's shape in 64-bit keys, ``chunks`` being the row's
    #: blocks of :data:`SELECT_CHUNK` columns: ``(S, chunks, k)`` for
    #: ``select``, two ping-pong buffers ``(2, S, chunks, min(k,
    #: SELECT_CHUNK))`` for ``select_sort`` (1 + ceil(log2(chunks))
    #: launches, counted as one in :data:`LAUNCHES`)
    scratch: Tuple[int, ...]


def _select_plan(S: int, C: int, k: int) -> SelectPlan:
    """The kernel, ``R`` and scratch the card's k-head takes for an
    ``(S, C)`` score matrix and ``k`` in ``[1, C]`` — by k alone."""
    chunks = -(-C // SELECT_CHUNK)
    if k <= SELECT_CAP:
        R = 1 << ((k - 1) // 32).bit_length()
        return SelectPlan("select", R, (S, chunks, k))
    return SelectPlan("select_sort", 0, (2, S, chunks, min(k, SELECT_CHUNK)))


def _launch_select(scores, finite, k):
    """The k-head on the card, through the kernel :func:`_select_plan`
    names."""
    S, C = scores.shape
    plan = _select_plan(S, C, k)
    keys = math.prod(plan.scratch)
    # one allocation (at one row the call is bound by the host's work):
    # top_i, top_v, then the scratch keys, 8-byte aligned
    buf = torch.empty(2 * S * k + 2 * keys, dtype=torch.int32,
                      device=scores.device)
    top_i = buf[:S * k].view(S, k)
    top_v = buf[S * k:2 * S * k].view(torch.float32).view(S, k)
    # vector loads where every row starts 16 (scores) and 4 (flags) bytes
    # aligned: a shape and address rule, decided before the launch
    vec = C % 4 == 0 and scores.data_ptr() % 16 == 0 \
        and finite.data_ptr() % 4 == 0
    base = buf.data_ptr()
    lib = _lib()
    head = (scores.data_ptr(), finite.data_ptr(), base + 4 * S * k, base,
            base + 8 * S * k, S, C, k, SELECT_CHUNK)
    if plan.kernel == "select":
        err = _build.launch_on(scores, lib.rank_delta_select, *head, plan.R,
                               int(vec), _stream(scores))
    else:
        err = _build.launch_on(scores, lib.rank_delta_select_sort, *head,
                               int(vec), _stream(scores))
    _build.check(err, f"rank_delta_{plan.kernel}")
    LAUNCHES[plan.kernel] += 1
    return top_i, top_v


def _launch_select_rounds(scores, finite, k):
    """The k-round kernel the two k-heads replaced, at any k in [1, C]:
    the yardstick, reached by name only."""
    S, C = scores.shape
    top_i = torch.empty((S, k), dtype=torch.int32, device=scores.device)
    top_v = torch.empty((S, k), dtype=torch.float32, device=scores.device)
    _build.check(_build.launch_on(
        scores, _lib().rank_delta_select_rounds, scores.data_ptr(),
        finite.data_ptr(), top_v.data_ptr(), top_i.data_ptr(), S, C, k,
        _stream(scores)),
        "rank_delta_select_rounds")
    LAUNCHES["select_rounds"] += 1
    return top_i, top_v


# --- public wrappers ------------------------------------------------------------

def scatter_prices(cols, prices, old_prices):
    """A tick's ``(new_prices, changed)``, both ``(1, C)`` float32 on
    ``old_prices``' device: ``old_prices`` with each column of ``cols``
    set to its entry of ``prices`` (rounded to float32), and 1.0 at those
    columns (0 elsewhere).  ``cols`` is a 1-D integer array of distinct
    columns in ``[0, C)``, ``prices`` a float array of its length (numpy
    arrays or anything ``np.asarray`` takes).  For prices on the card,
    kernel ``scatter``: the pairs go up in one copy, read before the call
    returns, so the arrays are free again at once; it refuses a CUDA graph
    capture.  CPU prices take the plain version."""
    if not isinstance(old_prices, torch.Tensor) or old_prices.dim() != 2:
        raise ValueError("old_prices must be a (1, C) tensor")
    C = old_prices.shape[1]
    _check("old_prices", old_prices, torch.float32, (1, C),
           old_prices.device)
    cols, prices = _check_pairs(cols, prices, C)
    if not _on_cuda(old_prices):
        return scatter_prices_plain(cols, prices, old_prices)
    return _launch_scatter(cols, prices, old_prices)


def row_minima(hours, mask, new_prices, row_best):
    """The tick's first half: ``(rb_new (J, 1), moved (1, 1) int32)``, the
    masked row minima of ``hours * new_prices`` and the count of rows
    whose minimum differs from ``row_best``.  CUDA tensors run ``rowmin``;
    CPU tensors its plain version.  On a shard of the config axis the
    minima are the shard's own, and ``moved`` compares them with the
    whole row's minima, so it means nothing there: the sharded fleet
    counts the moved rows after it has combined the shards' minima."""
    _check_rowmin(hours, mask, new_prices, row_best)
    return _rowmin(hours, mask, new_prices, row_best)


def fold_scores(hours, mask, old_prices, new_prices, changed, row_best,
                rb_new, row_masks, scores):
    """The tick's second half: the members' new ``scores (S, C)``, both
    norms recomputed from ``(old_prices, row_best)`` and ``(new_prices,
    rb_new)``; changed columns re-reduced, the others delta-folded.  CUDA
    tensors run ``fold``; CPU tensors its plain version.  Each column's
    sums run over the rows in an order fixed by J alone, so a tick split
    by columns gives the bits of the whole tick."""
    J, _, _ = _check_tick(hours, mask, old_prices, new_prices, changed,
                          row_best, row_masks, scores)
    _check("rb_new", rb_new, torch.float32, (J, 1), hours.device)
    return _fold(hours, mask, old_prices, new_prices, changed, row_best,
                 rb_new, row_masks, scores)


def fused_reprice(hours, mask, old_prices, new_prices, changed, row_best,
                  row_masks, scores):
    """One tick: ``(scores (S, C), row_best (J, 1), moved (1, 1) int32)``
    — the reference's argument order, without its TPU tiling arguments:
    :func:`row_minima`, then :func:`fold_scores` (one ``rowmin`` and one
    ``fold`` launch on CUDA tensors; the plain versions on the CPU)."""
    _check_tick(hours, mask, old_prices, new_prices, changed, row_best,
                row_masks, scores)
    return _tick(hours, mask, old_prices, new_prices, changed, row_best,
                 row_masks, scores)


def select_heads(scores, finite, k: int):
    """Every row's k-head ``(indices (S, k) int32, values (S, k))`` in
    (score, catalog order) over the ``inf``-masked scores.  CUDA tensors
    run ``select`` (``select_sort`` above :data:`SELECT_CAP`); CPU
    tensors the plain stable sort."""
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
    out, rb, moved = _tick(hours, mask, old_prices, new_prices, changed,
                           row_best, row_masks, scores)
    select = _launch_select if _on_cuda(hours) else select_heads_plain
    return (out, rb, moved) + select(out, finite, k)
