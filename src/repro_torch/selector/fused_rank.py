"""Fleet repricing through the fused CUDA delta-rank kernels (the
``torch_fused`` backend).

:class:`TorchFusedRankState` is the counterpart of the reference's
``PallasBatchedRankState`` (with the member machinery it inherits from
``BatchedRankState``): one shared (J x C) universe, member slots with
their row masks (S x J) and score accumulators (S x C), one dispatch per
tick for the whole fleet, and per-member serving.  The tick runs
:func:`repro_torch.kernels.rank_delta.tick_into` — the price scatter, the
row minima, then the member folds — on the card.

No cost or norm matrix is kept: both are recomputed from the read-only
``hours``/``mask`` residents and the price vector, which float32 IEEE
elementwise arithmetic makes bit-identical to what a stored matrix would
hold (DESIGN.md §14).  Per-tick state is the price vector, the masked
row minima and the member accumulators.

A tick's deltas become (int32 column, float32 price) pairs on the host,
packed into a slot of page-locked host memory that the card reads
directly (:class:`~repro_torch.kernels.rank_delta.PairStaging`), and are
scattered there into the tick's ``(1, C)`` price vector and
changed-column flags.  Duplicates collapse on the host (the last wins),
so the columns are distinct and the scatter deterministic.  The job axis
needs no padding (the reference padded it to its TPU tile).

**The tick as a CUDA graph.**  The state keeps two fixed sets of tick
buffers (:class:`~repro_torch.kernels.rank_delta.TickSet`: prices, flags,
row minima, scores) and ticks from one into the other, and two staging
slots that alternate with them.  So each direction's tick (scatter,
rowmin, which writes the moved count straight to the host, and fold) is
the same launches on the same addresses: on the card it is captured once
into a CUDA graph a direction and replayed every tick after the first,
which runs eagerly.  ``d_prices``, ``d_row_best`` and ``d_scores`` are the
current set's buffers, rewritten two ticks later: clone them to keep
them.  Before each tick the state checks that they are still its own; a
tensor assigned to one of them from outside is copied into its own
buffer (a rebind: the graphs stay).  A grow, which replaces the member
tensors, or new ``d_hours``, ``d_mask`` or ``d_row_masks`` drop the
graphs, which are captured again.  :data:`GRAPHS` counts all four.  On
the CPU the same buffers and rotation run the plain versions, eagerly.

:class:`FleetMembers` is the host half this state shares with the
sharded fleet (:mod:`repro_torch.selector.sharded`): member slots,
counts, the price mirror, delta validation and serving from the scores.
"""
from __future__ import annotations

from typing import Dict, Hashable, List, Mapping, Optional, Sequence, \
    Tuple, Union

import numpy as np
import torch

from repro_torch.kernels.rank_delta import (PairStaging, TickSet, capture,
                                            replay, rowmin_scratch,
                                            select_heads, tick_buffers,
                                            tick_into)
from repro_torch.obs import MetricsRegistry, maybe_span
from repro_torch.selector.rank import (
    BackendUnavailableError,
    NothingRankableError,
    RankedConfig,
    SCORE_CONTRACTS,
    _canonicalize_universe,
    _check_k,
    _materialize,
    _position_index,
    _ranked,
    _validated_deltas,
)

__all__ = ["FleetMembers", "GRAPHS", "TorchFusedRankState",
           "resolve_device"]

#: the fused fleets' tick graphs since the last :func:`reset_graphs`:
#: ``captures`` (one a direction, again after an invalidation),
#: ``replays`` (a tick the card ran from a graph), ``rebinds`` (a state
#: tensor assigned from outside, copied into the state's own buffer) and
#: ``invalidations`` (tick buffers reallocated or a captured input
#: replaced; counted on the CPU too, where no graph is kept)
GRAPHS: Dict[str, int] = {"captures": 0, "replays": 0, "rebinds": 0,
                          "invalidations": 0}


def reset_graphs() -> None:
    for name in GRAPHS:
        GRAPHS[name] = 0

Deltas = Union[Mapping[Hashable, float], Sequence[Tuple[Hashable, float]]]


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` as a :class:`torch.device`; a CUDA device with no CUDA
    present raises :class:`BackendUnavailableError` — the port never
    carries on on the CPU unless asked to."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise BackendUnavailableError(
            f"device {str(device)!r} requested but no CUDA device is "
            f"available; pass device='cpu' to run the plain PyTorch path")
    return device


def _cold_row_best(hours, mask, prices):
    """Masked row minima of the cost, off the hot path."""
    inf = torch.tensor(float("inf"), dtype=hours.dtype, device=hours.device)
    return torch.where(mask, hours * prices, inf).amin(dim=1, keepdim=True)


def _member_scores(hours, mask, prices, row_best, row_mask):
    """A new member's accumulators from the *implied* norm matrix,
    recomputed exactly as the fused kernel recomputes it."""
    zero = torch.zeros((), dtype=hours.dtype, device=hours.device)
    norm = torch.where(mask, (hours * prices) / row_best, zero)
    return row_mask @ norm


def _upload(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A contiguous device copy (never a view of the host array)."""
    return torch.tensor(np.ascontiguousarray(array), device=device)


def _grown(t: torch.Tensor, old: int, cap: int) -> torch.Tensor:
    """``t``'s first ``old`` slots in a zeroed tensor of ``cap`` slots."""
    out = torch.zeros((cap,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    out[:old] = t[:old]
    return out


def _member_rows(scores: torch.Tensor, finite: torch.Tensor,
                 rows: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The score and finite-flag rows of the (sorted, distinct) slots
    ``rows``: a view where they are contiguous, else one gather each."""
    lo, hi = rows[0], rows[-1] + 1
    if hi - lo == len(rows):
        return scores[lo:hi], finite[lo:hi]
    idx = torch.tensor(rows, dtype=torch.long, device=scores.device)
    return scores.index_select(0, idx), finite.index_select(0, idx)


class FleetMembers:
    """The host half of a fleet state, which every fleet backend shares:
    the member slots (doubling capacity, retired slots reused), each
    member's per-config counts, the float32 host price mirror, the delta
    validation and the serving of rankings and heads from the scores.
    A subclass keeps the device tensors: it sets ``config_ids``,
    ``job_ids`` and ``_pos``, calls :meth:`_init_host` and
    :meth:`_init_slots`, and defines ``_grow_tensors``, ``scores`` and
    ``heads``."""

    _CAPACITY_BASE = 8

    def _init_host(self, hours: np.ndarray, mask: np.ndarray,
                   host_prices: np.ndarray,
                   metrics: Optional[MetricsRegistry]) -> None:
        self._metrics = metrics
        self._c_mat = (None if metrics is None
                       else metrics.counter("rank.materializations"))
        self._job_pos = (None if self.job_ids is None else
                         {j: i for i, j in enumerate(self.job_ids)})
        self._mask = mask                     # host copy: member counts
        self._n_jobs = hours.shape[0]
        # the host float32 price mirror serves ``prices`` without a device
        # readback; float32 so host and device quotes can never disagree
        # by a rounding
        self._host_prices = host_prices
        self.reprices = 0
        #: one tick == one fleet dispatch, whatever the member count
        self.dispatches = 0
        self.materializations = 0
        self._ranking_memo: Dict[Hashable,
                                 Tuple[int, List[RankedConfig]]] = {}

    def _init_slots(self, cap: int) -> None:
        self._capacity = cap
        self._slots: Dict[Hashable, int] = {}
        #: keys retired via :meth:`retire_state`; serving one raises
        #: :class:`NothingRankableError` (a never-registered key stays a
        #: plain ``ValueError``).
        self._retired: set = set()
        self._free: List[int] = list(range(cap - 1, -1, -1))
        self._counts = np.zeros((cap, len(self.config_ids)), dtype=np.int64)
        #: capacity doublings; a retire-all / re-add cycle reuses slots
        #: and leaves this untouched
        self.realloc_count = 0

    # -- member management ----------------------------------------------------
    def __contains__(self, key: Hashable) -> bool:
        return key in self._slots

    @property
    def n_active(self) -> int:
        """Live member count (what one tick dispatch refreshes)."""
        return len(self._slots)

    def keys(self) -> List[Hashable]:
        return list(self._slots)

    def _slot_of(self, key: Hashable) -> int:
        try:
            return self._slots[key]
        except KeyError:
            if key in self._retired:
                raise NothingRankableError(
                    f"member state {key!r} was retired")
            raise ValueError(f"unknown member state {key!r}")

    def _grow(self) -> None:
        old, cap = self._capacity, self._capacity * 2
        self._grow_tensors(old, cap)
        counts = np.zeros((cap, len(self.config_ids)), dtype=np.int64)
        counts[:old] = self._counts
        self._counts = counts
        self._free.extend(range(cap - 1, old - 1, -1))
        self._capacity = cap
        self.realloc_count += 1

    def _rows_of(self, rows: Optional[Sequence[int]],
                 jobs: Optional[Sequence[Hashable]]) -> np.ndarray:
        if (rows is None) == (jobs is None):
            raise ValueError("pass exactly one of rows= or jobs=")
        if jobs is not None:
            if self._job_pos is None:
                raise ValueError(
                    "jobs= needs a state constructed with job_ids")
            try:
                rows = [self._job_pos[j] for j in jobs]
            except KeyError as e:
                raise ValueError(f"unknown job id {e.args[0]!r}")
        idx = np.asarray(list(rows), dtype=np.intp)
        if idx.size and (idx.min() < 0 or idx.max() >= self._n_jobs):
            raise ValueError(f"row index out of range for "
                             f"{self._n_jobs} jobs")
        if np.unique(idx).size != idx.size:
            raise ValueError("duplicate rows in member selection")
        return idx

    def _new_member(self, key: Hashable, rows: Optional[Sequence[int]],
                    jobs: Optional[Sequence[Hashable]]
                    ) -> Tuple[int, np.ndarray, np.ndarray]:
        """Validate a new member and give it a slot (growing the capacity
        if none is free): ``(slot, row mask (J,) float32, counts (C,))``.
        The subclass fills the slot's tensors, then registers the key."""
        if key in self._slots:
            raise ValueError(f"duplicate member state {key!r}")
        self._retired.discard(key)      # re-registering revives the key
        idx = self._rows_of(rows, jobs)
        if not self._free:
            self._grow()
        slot = self._free.pop()
        row_mask = np.zeros(self._n_jobs, dtype=np.float32)
        row_mask[idx] = 1.0
        counts = self._mask[idx].sum(axis=0) if idx.size else \
            np.zeros(len(self.config_ids), dtype=np.int64)
        self._counts[slot] = counts
        return slot, row_mask, counts

    def _drop_member(self, key: Hashable) -> int:
        """Unregister a member; returns its slot, whose tensors the
        subclass zeroes (it is reused by the next :meth:`add_state`)."""
        slot = self._slots.pop(key, None)
        if slot is None:
            raise ValueError(f"unknown member state {key!r}")
        self._counts[slot] = 0
        self._ranking_memo.pop(key, None)
        self._retired.add(key)
        self._free.append(slot)
        return slot

    # -- prices and the tick's host step -----------------------------------------
    @property
    def prices(self) -> np.ndarray:
        """Current per-config $/h (float32 quotes lifted to float64)."""
        return self._host_prices[0].astype(np.float64)

    def counts(self, key: Hashable) -> np.ndarray:
        """A member's per-config contributing-cell counts."""
        return self._counts[self._slot_of(key)].copy()

    def _pairs(self, deltas: Deltas
               ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """The tick's host step: validate a delta batch (duplicates
        collapse, the last wins, so the columns are distinct).  Returns
        ``(cols int32, prices float32)``, or ``None`` for an empty batch;
        raises before anything is uploaded or changed."""
        validated = _validated_deltas(self._pos, deltas)
        if validated is None:
            return None
        cols, prices = validated
        return cols, prices.astype(np.float32)

    def _commit(self, cols: np.ndarray, prices: np.ndarray) -> None:
        self._host_prices[0, cols] = prices
        self.reprices += 1
        self.dispatches += 1

    # -- per-member serving ----------------------------------------------------
    def _head(self, slot: int, idx: np.ndarray, vals: np.ndarray
              ) -> List[RankedConfig]:
        counts = self._counts[slot]
        return [_ranked(self.config_ids[int(i)], v, counts[int(i)])
                for i, v in zip(idx, vals)]

    def ranking(self, key: Hashable) -> List[RankedConfig]:
        """A member's full sorted ranking under the tolerance contract
        (memoized on the tick count; a fresh list copy each call)."""
        memo = self._ranking_memo.get(key)
        if memo is None or memo[0] != self.reprices:
            slot = self._slot_of(key)
            self.materializations += 1
            if self._c_mat is not None:
                self._c_mat.inc()
            with maybe_span(self._metrics, "rank.materialize"):
                memo = (self.reprices,
                        _materialize(self.scores(key), self._counts[slot],
                                     self.config_ids))
            self._ranking_memo[key] = memo
        return list(memo[1])

    def top_k(self, key: Hashable, k: int) -> List[RankedConfig]:
        """The head of a member's ranking — element-wise equal to
        ``ranking(key)[:k]``, ties in catalog order (:meth:`heads` of the
        one key)."""
        return self.heads([key], k)[0]

    def winner(self, key: Hashable) -> RankedConfig:
        """The member's top pick — ``top_k(key, 1)``."""
        return self.top_k(key, 1)[0]


class TorchFusedRankState(FleetMembers):
    """One fused-kernel dispatch per tick for a whole fleet of rankings.

    Members are added (:meth:`add_state`) and retired
    (:meth:`retire_state`) mid-stream; slot capacity grows by doubling
    (``realloc_count``), and retired slots are zeroed and reused.
    Serving is per member: :meth:`ranking` (memoized on the tick count),
    :meth:`top_k` (the ``select`` kernel on the member's row — an
    explicit catalog-order tie-break, which ``torch.topk`` does not
    promise) and :meth:`winner`.

    **Contract** (:data:`SCORE_CONTRACTS` ``["torch_fused"]``): the
    float32 tolerance envelope of the reference's fused backend.

    ``device`` defaults to ``"cuda"``; with no CUDA device the constructor
    raises :class:`BackendUnavailableError`.  Pass ``device="cpu"`` to run
    the kernels' plain PyTorch versions.
    """

    backend = "torch_fused"
    contract = SCORE_CONTRACTS["torch_fused"]

    def __init__(self, hours: np.ndarray, mask: np.ndarray,
                 prices: np.ndarray, config_ids: Sequence[Hashable],
                 job_ids: Optional[Sequence[Hashable]] = None,
                 capacity: Optional[int] = None,
                 metrics: Optional[MetricsRegistry] = None, *,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.config_ids = list(config_ids)
        self.job_ids = list(job_ids) if job_ids is not None else None
        hours, mask, prices = _canonicalize_universe(hours, mask, prices,
                                                     self.job_ids)
        self._pos = _position_index(self.config_ids)
        host_prices = np.asarray(prices, dtype=np.float32).reshape(1, -1)
        self._init_universe(hours, mask, host_prices, metrics)
        self.d_row_best = _cold_row_best(self.d_hours, self.d_mask,
                                         self.d_prices)
        self._init_members(self._CAPACITY_BASE if capacity is None
                           else max(1, capacity))

    def _init_universe(self, hours: np.ndarray, mask: np.ndarray,
                       host_prices: np.ndarray,
                       metrics: Optional[MetricsRegistry]) -> None:
        self._init_host(hours, mask, host_prices, metrics)
        # read-only residents (uploaded once)
        self.d_hours = _upload(hours.astype(np.float32), self.device)
        self.d_mask = _upload(mask, self.device)
        self.d_prices = _upload(host_prices, self.device)

    def _init_members(self, cap: int) -> None:
        self._init_slots(cap)
        # the tick's two buffer sets and staging slots, made at the first
        # tick; _cur is the set the state's tensors are
        self._sets: Optional[Tuple[TickSet, TickSet]] = None
        self._cur = 0
        self._staging: Optional[PairStaging] = None
        self._graphs: List = [None, None]
        self._inputs: Optional[Tuple[torch.Tensor, ...]] = None
        self._scratch = None
        self._warm = False
        n_cfgs = len(self.config_ids)
        self.d_row_masks = torch.zeros((cap, self._n_jobs),
                                       dtype=torch.float32,
                                       device=self.device)
        self.d_scores = torch.zeros((cap, n_cfgs), dtype=torch.float32,
                                    device=self.device)
        self._d_finite = torch.zeros((cap, n_cfgs), dtype=torch.bool,
                                     device=self.device)

    def _grow_tensors(self, old: int, cap: int) -> None:
        self.d_row_masks = _grown(self.d_row_masks, old, cap)
        self.d_scores = _grown(self.d_scores, old, cap)
        self._d_finite = _grown(self._d_finite, old, cap)

    # -- member management ----------------------------------------------------
    def add_state(self, key: Hashable, *,
                  rows: Optional[Sequence[int]] = None,
                  jobs: Optional[Sequence[Hashable]] = None) -> None:
        """Register a member ranking over a subset of the job axis
        (``rows`` indices, or ``jobs`` ids when the state was built with
        ``job_ids``).  Its accumulators come from the implied current norm
        matrix, so a member added mid-stream is immediately in sync."""
        slot, row_mask, counts = self._new_member(key, rows, jobs)
        d_row = _upload(row_mask, self.device)
        self.d_row_masks[slot] = d_row
        self.d_scores[slot] = _member_scores(
            self.d_hours, self.d_mask, self.d_prices, self.d_row_best,
            d_row)
        self._d_finite[slot] = _upload(counts > 0, self.device)
        self._slots[key] = slot

    def retire_state(self, key: Hashable) -> None:
        """Drop a member: its slot is zeroed (contributes nothing to later
        ticks) and reused by the next :meth:`add_state`.  Serving a
        retired key afterwards raises :class:`NothingRankableError`."""
        slot = self._drop_member(key)
        self.d_row_masks[slot] = 0.0
        self.d_scores[slot] = 0.0
        self._d_finite[slot] = False

    # -- the fused tick ----------------------------------------------------------
    def scores(self, key: Hashable) -> np.ndarray:
        """A member's score accumulators on the host (float64 lift)."""
        row = self.d_scores[self._slot_of(key)]
        return row.cpu().numpy().astype(np.float64)

    def _bind(self) -> Tuple[TickSet, TickSet]:
        """The tick's ``(source, target)`` sets, after making the state's
        tensors its own buffers again: sets (re)made where the shapes
        changed, a tensor assigned from outside copied in, and the graphs
        dropped where a captured input is another tensor now."""
        sets, inputs = self._sets, self._inputs
        if sets is not None:                   # the usual tick: all its own
            own = sets[self._cur]
            if (self.d_scores is own.scores
                    and self.d_row_best is own.row_best
                    and self.d_prices is own.prices
                    and self.d_hours is inputs[0]
                    and self.d_mask is inputs[1]
                    and self.d_row_masks is inputs[2]):
                return own, sets[1 - self._cur]
        S, C = self.d_scores.shape
        shapes = (self.d_prices.shape, self.d_row_best.shape, (S, C))
        fresh = sets is None or shapes != (
            sets[0].prices.shape, sets[0].row_best.shape,
            sets[0].scores.shape)
        if fresh:
            if sets is not None:
                GRAPHS["invalidations"] += 1
            sets = self._sets = tuple(
                tick_buffers(self._n_jobs, C, S, self.device)
                for _ in range(2))
            self._graphs = [None, None]
        own = sets[self._cur]
        for name in ("d_prices", "d_row_best", "d_scores"):
            mine, t = getattr(own, name[2:]), getattr(self, name)
            if t is not mine:
                mine.copy_(t)
                setattr(self, name, mine)
                GRAPHS["rebinds"] += not fresh
        inputs = (self.d_hours, self.d_mask, self.d_row_masks)
        if self._inputs is None or any(
                a is not b for a, b in zip(inputs, self._inputs)):
            if self._inputs is not None and not fresh:
                GRAPHS["invalidations"] += 1
            self._inputs = inputs
            self._graphs = [None, None]
        if self._staging is None:
            self._staging = PairStaging(C, self.device)
        return own, sets[1 - self._cur]

    def _capture(self, slot: int):
        """The tick from set ``slot`` into the other, captured."""
        scratch = self._scratch or rowmin_scratch(
            self.device, self._n_jobs, len(self.config_ids))
        src, dst = self._sets[slot], self._sets[1 - slot]
        graph = capture(lambda: tick_into(
            self.d_hours, self.d_mask, self.d_row_masks, self._staging, slot,
            src, dst, scratch=scratch), self.device)
        self._scratch = scratch
        GRAPHS["captures"] += 1
        return graph

    def _tick(self, pairs: Tuple[np.ndarray, np.ndarray], graph: bool
              ) -> Tuple[TickSet, int]:
        """One tick into the other set, completed: ``(target set, moved)``.
        The state's tensors stay the source set's until :meth:`_turn`.  On
        the card a warm state replays the direction's graph (captured
        first where it has none); ``graph=False``, or the first tick, runs
        the same launches eagerly."""
        src, dst = self._bind()
        slot, staging = self._cur, self._staging
        # _pairs' columns are distinct and in range by construction
        staging.fill(slot, *pairs)
        if graph and self._warm:
            if self._graphs[slot] is None:
                self._graphs[slot] = self._capture(slot)
            replay(self._graphs[slot])
            GRAPHS["replays"] += 1
        else:
            tick_into(self.d_hours, self.d_mask, self.d_row_masks, staging,
                      slot, src, dst)
            self._warm = self.device.type == "cuda"
        # the tick's last node records the slot's event
        staging.wait(slot)
        return dst, int(staging.moved[slot])

    def _turn(self, pairs: Tuple[np.ndarray, np.ndarray]) -> None:
        """The tick's target set becomes the state's, and the host mirror
        and counts take the tick."""
        self._cur ^= 1
        own = self._sets[self._cur]
        self.d_prices, self.d_row_best, self.d_scores = (
            own.prices, own.row_best, own.scores)
        self._commit(*pairs)

    def reprice(self, deltas: Deltas) -> int:
        """Apply ``{config_id: new $/h}`` deltas with ONE fused dispatch
        refreshing every member; returns #rows whose masked row-minimum
        handed off (read back to the host, so a return means the tick's
        kernels have completed).  On the card the dispatch is a replay of
        the tick's CUDA graph."""
        return self._reprice(deltas, graph=True)

    def _reprice(self, deltas: Deltas, graph: bool) -> int:
        """:meth:`reprice`; ``graph=False`` runs the tick's launches eagerly
        (the yardstick, by name only)."""
        pairs = self._pairs(deltas)
        if pairs is None:
            return 0
        _, moved = self._tick(pairs, graph)
        self._turn(pairs)
        return moved

    def reprice_with_heads(self, deltas: Deltas, k: int
                           ) -> Tuple[int, Dict[Hashable,
                                                List[RankedConfig]]]:
        """The tick AND every live member's ``k``-head from the same
        dispatch: ``(moved, {key: [RankedConfig]})``.  Heads are ``k``
        distinct configs equal to ``ranking(key)[:k]``.  An empty delta
        batch degrades to plain :meth:`top_k` serving with no dispatch."""
        k = _check_k(k, len(self.config_ids))
        pairs = self._pairs(deltas)
        if pairs is None:
            return 0, {key: self.top_k(key, k) for key in self._slots}
        # the tick's graph, then select on its scores
        dst, moved = self._tick(pairs, graph=True)
        top_i, top_v = select_heads(dst.scores, self._d_finite, k)
        top_i = top_i.cpu().numpy()
        top_v = top_v.cpu().numpy().astype(np.float64)
        self._turn(pairs)
        heads = {key: self._head(slot, top_i[slot], top_v[slot])
                 for key, slot in self._slots.items()}
        return moved, heads

    # -- per-member serving ----------------------------------------------------
    def heads(self, keys: Sequence[Hashable], k: int
              ) -> List[List[RankedConfig]]:
        """Several members' heads from ONE ``select`` launch over the
        requested members' rows alone: a view where their slots are
        contiguous, else one gather of those rows.  Element ``i`` is
        ``top_k(keys[i], k)``."""
        slots = [self._slot_of(key) for key in keys]
        k = _check_k(k, len(self.config_ids))
        if not slots:
            return []
        rows = sorted(set(slots))
        scores, finite = _member_rows(self.d_scores, self._d_finite, rows)
        top_i, top_v = select_heads(scores, finite, k)
        top_i = top_i.cpu().numpy()
        top_v = top_v.cpu().numpy().astype(np.float64)
        at = {s: r for r, s in enumerate(rows)}
        return [self._head(s, top_i[at[s]], top_v[at[s]]) for s in slots]
