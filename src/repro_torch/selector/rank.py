"""Vectorized normalized-cost ranking (paper §II, step 2) — the numpy half.

The ranking is one matrix computation:

    cost   = runtime_hours (J x C)  *  price_vector (C,)     # broadcast
    norm   = cost / row-min(cost over profiled cells)        # row-normalize
    score  = column-sum of norm over profiled cells          # per config

A config with **zero** profiled cells scores ``+inf`` and ranks last.

This module is the counterpart of the reference's ``repro.selector.rank``
without its JAX states: the float64 numpy path (:func:`rank_dense`,
:func:`rank_pairs`, the incremental :class:`RankState`), the shared
validation and materialization helpers, and the :class:`ScoreContract`
table.  The port's float32 fleet backend, ``"torch_fused"``, lives in
:mod:`repro_torch.selector.fused_rank`.
"""
from __future__ import annotations

import dataclasses
from typing import (Callable, Hashable, List, Mapping, Optional, Sequence,
                    Tuple, Union)

import numpy as np

from repro_torch.obs import MetricsRegistry, maybe_span

#: ``"numpy"``: float64, bit-stable, one :class:`RankState` per live
#: selection.  ``"torch_fused"``: float32, every live selection stacked
#: into one :class:`~repro_torch.selector.fused_rank.TorchFusedRankState`
#: whose tick runs the fused CUDA reprice kernels.
BACKENDS = ("numpy", "torch_fused")
#: the fleet backends: a SelectionService on one of these stacks every
#: live (class, exclusion) ranking into a single shared state, so a price
#: tick is one dispatch fleet-wide.
FLEET_BACKENDS = ("torch_fused",)


class BackendUnavailableError(RuntimeError):
    """A ranking backend or device was requested whose runtime is not
    present (``device="cuda"`` with no CUDA device).  Typed so callers —
    and test harnesses — can tell it from misconfiguration
    ``ValueError``\\ s and from genuine crashes."""


@dataclasses.dataclass(frozen=True)
class ScoreContract:
    """What a backend promises about incremental-vs-cold score equality.

    * numpy/float64: **bit-identical** — the incremental
      :class:`RankState` recomputes updated cells with the cold path's
      exact elementwise arithmetic and re-reduces scores with the same
      full ``norm.sum(axis=0)`` (``rel_tol == abs_tol == 0``).
    * float32: **same-winner-or-tied within tolerance** — delta-folded
      accumulators drift by ulps per tick, so every score lies within
      ``rel_tol``/``abs_tol`` of the cold value and the reported winner
      is the cold winner or tied with it within the same envelope.
    """

    backend: str
    bit_identical: bool
    rel_tol: float = 0.0
    abs_tol: float = 0.0

    def scores_match(self, a: float, b: float) -> bool:
        """Are two scores equal under this contract?  (``inf == inf``
        counts: unprofiled configs score ``+inf`` on every backend.)"""
        if a == b:
            return True
        if self.bit_identical:
            return False
        return abs(a - b) <= self.abs_tol + self.rel_tol * max(abs(a),
                                                               abs(b))

    def winner_matches(self, config_id: Hashable,
                       ranking: Sequence["RankedConfig"]) -> bool:
        """Is ``config_id`` an acceptable winner against a cold
        ``ranking``?  Identical to the cold winner always qualifies; a
        tolerance backend also accepts a config whose *cold* score ties
        the cold winner's within the contract."""
        if not ranking:
            return False
        if config_id == ranking[0].config_id:
            return True
        if self.bit_identical:
            return False
        for r in ranking:
            if r.config_id == config_id:
                return self.scores_match(r.score, ranking[0].score)
        return False


#: Per-backend contracts.  ``"torch_fused"`` carries the envelope of the
#: reference's ``jax_pallas``: its kernels recompute cost and norm cells
#: with the same float32 IEEE expressions (bit-identical cells), re-reduce
#: changed columns from scratch and delta-fold the rest — only the order
#: of the member sums differs, which rel 1e-4 / abs 1e-6 covers with two
#: orders of magnitude of headroom (DESIGN.md §9, §14).
SCORE_CONTRACTS: Mapping[str, ScoreContract] = {
    "numpy": ScoreContract("numpy", bit_identical=True),
    "torch_fused": ScoreContract("torch_fused", bit_identical=False,
                                 rel_tol=1e-4, abs_tol=1e-6),
}


def score_contract(backend: str) -> ScoreContract:
    """The :class:`ScoreContract` for ``backend`` (raises on unknown)."""
    try:
        return SCORE_CONTRACTS[backend]
    except KeyError:
        raise ValueError(f"unknown backend {backend!r} "
                         f"(expected one of {BACKENDS})")


class NothingRankableError(ValueError):
    """The selection has no rankable universe — an empty job selection or
    an entirely-unprofiled catalog.  A routine per-submission outcome,
    distinct from the other ``ValueError``\\ s raised here, which indicate
    misconfiguration and should never be swallowed as a rejection."""


@dataclasses.dataclass(frozen=True)
class RankedConfig:
    config_id: Hashable
    score: float           # sum of normalized costs; lower is better
    mean_norm_cost: float  # score / number of contributing test jobs


def _canonicalize_universe(
        hours: np.ndarray, mask: np.ndarray, prices: np.ndarray,
        job_ids: Optional[Sequence[Hashable]]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Shared input validation for every dense entry point: canonicalize
    dtypes, check shapes, reject empty job axes and non-positive profiled
    costs (both indicate a broken trace, not a rankable universe)."""
    hours = np.asarray(hours, dtype=np.float64)
    mask = np.asarray(mask, dtype=bool)
    prices = np.asarray(prices, dtype=np.float64)
    if hours.shape != mask.shape or hours.shape[1] != prices.shape[0]:
        raise ValueError(f"shape mismatch: hours {hours.shape}, "
                         f"mask {mask.shape}, prices {prices.shape}")
    if hours.shape[0] == 0:
        raise NothingRankableError("no test jobs to learn from")
    bad = mask & ~((hours * prices[None, :]) > 0)
    if bad.any():
        row = int(np.argwhere(bad)[0][0])
        job = job_ids[row] if job_ids is not None else row
        raise ValueError(f"non-positive cost for job {job!r}")
    return hours, mask, prices


def _position_index(config_ids: Sequence[Hashable]
                    ) -> "dict[Hashable, int]":
    """Config id -> column position; rejects duplicates (the states key
    reprice deltas on it, so a duplicate would silently alias columns)."""
    pos = {c: i for i, c in enumerate(config_ids)}
    if len(pos) != len(config_ids):
        raise ValueError("duplicate config ids")
    return pos


def _scores_numpy(hours: np.ndarray, mask: np.ndarray, prices: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    cost = np.where(mask, hours * prices[None, :], np.inf)
    row_best = np.min(cost, axis=1, initial=np.inf)
    with np.errstate(invalid="ignore"):
        norm = np.where(mask, cost / row_best[:, None], 0.0)
    return norm.sum(axis=0), mask.sum(axis=0)


def _ranked(config_id: Hashable, score: float, count: int) -> RankedConfig:
    """One :class:`RankedConfig`: an unprofiled config (``count == 0``)
    scores ``+inf`` whatever its accumulator holds."""
    if not count:
        return RankedConfig(config_id, float("inf"), float("inf"))
    return RankedConfig(config_id, float(score), float(score / count))


def _materialize(scores: np.ndarray, counts: np.ndarray,
                 config_ids: Sequence[Hashable]) -> List[RankedConfig]:
    """Scores/counts -> sorted RankedConfig list (shared by the cold and
    incremental paths so their rankings are identical by construction)."""
    ranked = [_ranked(c, scores[i], counts[i])
              for i, c in enumerate(config_ids)]
    order = {c: i for i, c in enumerate(config_ids)}
    ranked.sort(key=lambda r: (r.score, order[r.config_id]))
    return ranked


def _check_k(k: int, n_cfgs: int) -> int:
    """Validate a top-k depth; clamps to the universe size (asking for
    more head than exists is a serving convenience, not an error)."""
    if not isinstance(k, int) or isinstance(k, bool) or k < 1:
        raise ValueError(f"top_k needs a positive integer k, got {k!r}")
    return min(k, n_cfgs)


def _top_k_numpy(scores: np.ndarray, counts: np.ndarray,
                 config_ids: Sequence[Hashable], k: int
                 ) -> List[RankedConfig]:
    """The head of :func:`_materialize`'s ranking without building and
    sorting all C ``RankedConfig``\\ s: partial-select the k best scores,
    then order only the boundary candidates by the same (score, catalog
    position) key — element-wise identical to ``_materialize(...)[:k]``
    by construction, ties included."""
    k = _check_k(k, len(config_ids))
    eff = np.where(counts > 0, scores, np.inf)
    kth = np.partition(eff, k - 1)[k - 1]
    cand = np.flatnonzero(eff <= kth)
    cand = cand[np.lexsort((cand, eff[cand]))][:k]
    return [_ranked(config_ids[i], scores[i], counts[i]) for i in cand]


def rank_dense(hours: np.ndarray, mask: np.ndarray, prices: np.ndarray,
               config_ids: Sequence[Hashable],
               job_ids: Optional[Sequence[Hashable]] = None
               ) -> List[RankedConfig]:
    """Rank configs from dense (J x C) runtime-hours + profiled-mask, cold,
    in float64 — the reference every other path is held against.

    ``prices`` is the current $/h per config, aligned with ``config_ids``.
    Raises on an empty job axis and on non-positive profiled costs.
    """
    hours, mask, prices = _canonicalize_universe(hours, mask, prices,
                                                 job_ids)
    scores, counts = _scores_numpy(hours, mask, prices)
    return _materialize(scores, counts, config_ids)


def rank_pairs(
    runtime_hours: Mapping[Tuple[Hashable, Hashable], float],
    jobs: Sequence[Hashable],
    config_ids: Sequence[Hashable],
    hourly_cost: Union[Callable[[Hashable], float], Mapping[Hashable, float]],
) -> List[RankedConfig]:
    """Rank from sparse ``{(job, config): hours}`` pairs: densifies and
    dispatches to :func:`rank_dense`."""
    if not jobs:
        raise NothingRankableError("no test jobs to learn from")
    price_of = hourly_cost if callable(hourly_cost) else hourly_cost.__getitem__
    hours = np.zeros((len(jobs), len(config_ids)))
    mask = np.zeros_like(hours, dtype=bool)
    for r, j in enumerate(jobs):
        for k, c in enumerate(config_ids):
            v = runtime_hours.get((j, c))
            if v is not None:
                hours[r, k] = v
                mask[r, k] = True
    prices = np.asarray([price_of(c) for c in config_ids], dtype=np.float64)
    return rank_dense(hours, mask, prices, config_ids, job_ids=list(jobs))


class RankState:
    """Incremental repricing over a fixed (job x config) runtime matrix.

    Keeps the dense intermediates (cost, row-min, normalized-cost
    matrices) alive and on :meth:`reprice` touches only the changed
    cost/norm columns and the rows whose masked row-minimum was or becomes
    a changed column (DESIGN.md §6).

    **Bit-identity contract**: scores after any ``reprice`` sequence are
    bit-identical to a cold ``rank_dense`` at the same prices — updated
    cells use the cold path's exact elementwise arithmetic and scores are
    re-reduced with the same full ``norm.sum(axis=0)``.
    """

    def __init__(self, hours: np.ndarray, mask: np.ndarray,
                 prices: np.ndarray, config_ids: Sequence[Hashable],
                 job_ids: Optional[Sequence[Hashable]] = None,
                 metrics: Optional[MetricsRegistry] = None):
        self.config_ids = list(config_ids)
        self.job_ids = list(job_ids) if job_ids is not None else None
        self._metrics = metrics
        self._c_mat = (None if metrics is None
                       else metrics.counter("rank.materializations"))
        self.hours, self.mask, self.prices = _canonicalize_universe(
            hours, mask, prices, self.job_ids)
        self.prices = self.prices.copy()        # mutated by reprice
        self._pos = _position_index(self.config_ids)
        #: ticks applied since construction (diagnostics, cache keys).
        self.reprices = 0
        #: full-ranking sorts actually performed.
        self.materializations = 0
        self._ranking_memo: Optional[Tuple[int, List[RankedConfig]]] = None
        self._rebuild()

    def _check_positive(self, mask: np.ndarray, cost: np.ndarray) -> None:
        bad = mask & ~(cost > 0)
        if bad.any():
            row = int(np.argwhere(bad)[0][0])
            job = self.job_ids[row] if self.job_ids is not None else row
            raise ValueError(f"non-positive cost for job {job!r}")

    def _rebuild(self) -> None:
        # the cold-path arithmetic, verbatim (bit-identity anchor)
        self.cost = np.where(self.mask, self.hours * self.prices[None, :],
                             np.inf)
        self.row_best = np.min(self.cost, axis=1, initial=np.inf)
        with np.errstate(invalid="ignore"):
            self.norm = np.where(self.mask,
                                 self.cost / self.row_best[:, None], 0.0)
        self.scores = self.norm.sum(axis=0)
        self.counts = self.mask.sum(axis=0)

    def reprice(self, deltas: Union[Mapping[Hashable, float],
                                    Sequence[Tuple[Hashable, float]]]) -> int:
        """Apply ``{config_id: new $/h}`` deltas; returns #rows whose
        masked row-minimum moved (the expensive case)."""
        table = deltas if isinstance(deltas, Mapping) else dict(deltas)
        if not table:
            return 0
        try:
            cols = np.asarray([self._pos[c] for c in table], dtype=np.intp)
        except KeyError as e:
            raise ValueError(f"unknown config id in deltas: {e.args[0]!r}")
        new_prices = np.asarray(list(table.values()), dtype=np.float64)
        new_cost = np.where(self.mask[:, cols],
                            self.hours[:, cols] * new_prices[None, :],
                            np.inf)
        self._check_positive(self.mask[:, cols], new_cost)
        old_cost = self.cost[:, cols]
        self.prices[cols] = new_prices
        self.cost[:, cols] = new_cost
        # rows whose masked minimum was in a changed column, or where a
        # changed column undercuts the old minimum, need a fresh row-min
        was_min = old_cost.min(axis=1, initial=np.inf) == self.row_best
        undercut = new_cost.min(axis=1, initial=np.inf) < self.row_best
        candidates = np.flatnonzero(was_min | undercut)
        moved = np.array([], dtype=np.intp)
        if candidates.size:
            fresh = np.min(self.cost[candidates, :], axis=1, initial=np.inf)
            changed = fresh != self.row_best[candidates]
            moved = candidates[changed]
            self.row_best[moved] = fresh[changed]
        with np.errstate(invalid="ignore"):
            self.norm[:, cols] = np.where(
                self.mask[:, cols],
                self.cost[:, cols] / self.row_best[:, None], 0.0)
            if moved.size:
                self.norm[moved, :] = np.where(
                    self.mask[moved, :],
                    self.cost[moved, :] / self.row_best[moved, None], 0.0)
        # full-matrix reduction, identical to the cold path
        self.scores = self.norm.sum(axis=0)
        self.reprices += 1
        return int(moved.size)

    def ranking(self) -> List[RankedConfig]:
        """The full sorted ranking (bit-identical to ``rank_dense``),
        memoized on the state's tick count; a fresh list copy is returned
        each call."""
        if self._ranking_memo is None or \
                self._ranking_memo[0] != self.reprices:
            self.materializations += 1
            if self._c_mat is not None:
                self._c_mat.inc()
            with maybe_span(self._metrics, "rank.materialize"):
                self._ranking_memo = (
                    self.reprices,
                    _materialize(self.scores, self.counts,
                                 self.config_ids))
        return list(self._ranking_memo[1])

    def top_k(self, k: int) -> List[RankedConfig]:
        """The first ``k`` entries of :meth:`ranking` by partial
        selection (same (score, catalog-order) tie-break)."""
        return _top_k_numpy(self.scores, self.counts, self.config_ids, k)

    def winner(self) -> RankedConfig:
        """argmin only — O(C), no list build/sort."""
        finite = self.counts > 0
        if not finite.any():
            i = 0
        else:
            i = int(np.argmin(np.where(finite, self.scores, np.inf)))
        return _ranked(self.config_ids[i], self.scores[i], self.counts[i])


def _validated_deltas(pos: Mapping[Hashable, int],
                      deltas: Union[Mapping[Hashable, float],
                                    Sequence[Tuple[Hashable, float]]]
                      ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Validate a delta batch: resolve config ids to column positions and
    reject non-positive / non-finite prices.  Returns ``(cols int32,
    new_prices float64)`` (duplicates collapsed, last wins, so the columns
    are distinct) or ``None`` for an empty batch.  Ids resolve and prices
    convert inside ``np.fromiter``, with no Python step per delta."""
    table = deltas if isinstance(deltas, Mapping) else dict(deltas)
    if not table:
        return None
    n = len(table)
    try:
        cols = np.fromiter(map(pos.__getitem__, table), np.int32, n)
    except KeyError as e:
        raise ValueError(f"unknown config id in deltas: {e.args[0]!r}")
    new_prices = np.fromiter(table.values(), np.float64, n)
    bad = ~(np.isfinite(new_prices) & (new_prices > 0))
    if bad.any():
        offender = list(table)[int(np.flatnonzero(bad)[0])]
        raise ValueError(f"non-positive or non-finite price for "
                         f"config {offender!r}")
    return cols, new_prices
