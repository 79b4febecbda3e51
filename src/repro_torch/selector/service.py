"""SelectionService: the submit -> Decision facade over catalog + store.

The service owns the pieces a deployed selector needs around the ranking
math itself:

  * **price epochs** — prices change while the trace does not (§II-D);
    swapping the price source bumps an epoch counter and invalidates every
    cached ranking;
  * **incremental repricing** — when the price source is a mutable
    :class:`~repro_torch.selector.catalog.PriceTable` driven by a market
    feed, :meth:`reprice` applies per-config deltas to the live
    :class:`~repro_torch.selector.rank.RankState` of every cached ranking
    (numpy) or to the one shared
    :class:`~repro_torch.selector.fused_rank.TorchFusedRankState` fleet
    (``torch_fused``, one dispatch per tick) instead of recomputing from
    scratch (DESIGN.md §6);
  * **ranking caches** — rankings depend only on (job class, exclusion
    set, price epoch), so repeat submissions of same-class jobs are O(1)
    dictionary hits (the serving-scale path: one ranking amortized over
    thousands of submissions);
  * **classification** — `submit` resolves the job's class from, in
    order: the explicit annotation, the injected classifier, the store's
    job metadata (Step 1 of the paper).
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, Hashable, List, Mapping,
                    NamedTuple, Optional, Sequence, Tuple, Union)

import torch

from repro_torch.core.trace import JobClass
from repro_torch.obs import MetricsRegistry
from repro_torch.selector.catalog import BaseCatalog, PriceTable
from repro_torch.selector.fused_rank import (TorchFusedRankState,
                                             resolve_device)
from repro_torch.selector.rank import (BACKENDS, FLEET_BACKENDS,
                                       NothingRankableError, RankedConfig,
                                       RankState)
from repro_torch.selector.store import ProfilingStore


class _Deferred(NamedTuple):
    """A head a live fleet member serves, left for one batched launch:
    its head-cache key and the member's key in the fleet."""
    head_key: Tuple
    member: Tuple


def _check_head_k(k, name: str) -> None:
    if not isinstance(k, int) or isinstance(k, bool) or k < 1:
        raise ValueError(f"{name} needs a positive integer k, got {k!r}")


@dataclasses.dataclass(frozen=True)
class Decision:
    """The outcome of one submission."""

    job_id: Hashable
    job_class: Optional[JobClass]
    config_id: Hashable
    entry: Any                          # native config object
    hourly_cost: float
    ranking: Tuple[RankedConfig, ...]
    from_cache: bool
    price_epoch: int
    #: the *effective* exclusion set the ranking was computed under
    #: (explicit argument, or the job's own group by default) — journal
    #: consumers need it to recompute the ranking cold (DESIGN.md §8).
    exclude_groups: Tuple[str, ...] = ()
    #: how :attr:`ranking` was produced: ``"ranking"`` — the full sorted
    #: list; ``"top_k"`` — only the head of the ranking was served
    #: (device-side partial selection, DESIGN.md §10), so :attr:`ranking`
    #: holds the first k entries and nothing below them.  The winner,
    #: score and $/h fields are identical either way — journal audits
    #: hold top-k-served decisions to the same contract (§8).
    served_via: str = "ranking"


class SelectionService:
    """Serving facade: ``submit(job, annotation) -> Decision``."""

    def __init__(self, catalog: BaseCatalog, store: ProfilingStore,
                 price_source: Optional[Any] = None,
                 classifier: Optional[Callable[[Hashable],
                                               JobClass]] = None,
                 backend: Optional[str] = None,
                 serve_top_k: Optional[int] = None,
                 metrics: Optional[MetricsRegistry] = None, *,
                 device: Union[str, torch.device] = "cuda"):
        self.catalog = catalog
        self.store = store
        self.classifier = classifier
        #: the service's telemetry registry (DESIGN.md §12).  Every
        #: counter below lives on it; the market layer (ticker, daemon,
        #: front-end) adopts it by default so one registry carries the
        #: whole tick/serve pipeline.  Inject a shared registry to merge
        #: with store/train/engine telemetry.
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        #: "torch_fused" (the default) stacks every live (class,
        #: exclusion) ranking into one :class:`TorchFusedRankState` on
        #: ``device`` — a tick is one fused kernel dispatch for the whole
        #: fleet, under the float32 tolerance contract (DESIGN.md §9-§10,
        #: §14); "numpy" serves one bit-identical float64
        #: :class:`RankState` per selection and ignores ``device``.
        self.backend = backend if backend is not None else "torch_fused"
        # fail at construction, not first submit: a service that can
        # never rank is misconfiguration the caller should see now
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r} "
                             f"(expected one of {BACKENDS})")
        #: where the fleet state lives; a CUDA device with no CUDA
        #: present raises the typed BackendUnavailableError here
        self.device = (resolve_device(device)
                       if self.backend in FLEET_BACKENDS else None)
        #: default serving depth: ``None`` serves full rankings
        #: (``Decision.served_via == "ranking"``); a positive int makes
        #: ``submit`` serve only the top-k head of the ranking — the
        #: full C-config materialize/sort never runs (DESIGN.md §10).
        #: Overridable per submission via ``submit(..., top_k=)``.
        if serve_top_k is not None and (
                not isinstance(serve_top_k, int)
                or isinstance(serve_top_k, bool) or serve_top_k < 1):
            raise ValueError(f"serve_top_k must be a positive int or "
                             f"None, got {serve_top_k!r}")
        self.serve_top_k = serve_top_k
        self._price_source = price_source
        self._price_epoch = 0
        self._cache: Dict[Tuple, Tuple[RankedConfig, ...]] = {}
        #: top-k heads served without a full materialization, keyed like
        #: the ranking cache plus the depth k.
        self._head_cache: Dict[Tuple, Tuple[RankedConfig, ...]] = {}
        #: live incremental states, keyed like the cache but without the
        #: price tag — a reprice mutates them in place across epochs.
        #: Unused by the fleet backend ("torch_fused"), whose fleet
        #: lives inside the one shared :attr:`_batched` state instead.
        self._states: Dict[Tuple, RankState] = {}
        #: price tag each state was last (re)priced under; a state is only
        #: served when its tag matches the current one.
        self._state_tags: Dict[Tuple, Tuple] = {}
        # the fleet backend's universe: one TorchFusedRankState over the
        # full store, members keyed by base_key, plus the tag/store
        # version it is in sync with
        self._batched: Optional[TorchFusedRankState] = None
        self._batched_tag: Optional[Tuple] = None
        self._batched_store_version: Optional[int] = None
        # counters live on the registry; the attribute names below are
        # the reference's and stay as properties.
        self._c_hits = self.metrics.counter("service.cache_hits")
        self._c_misses = self.metrics.counter("service.cache_misses")
        self._c_refreshes = self.metrics.counter("service.reprice_refreshes")
        self._c_dispatches = self.metrics.counter(
            "service.reprice_dispatches")

    @property
    def cache_hits(self) -> int:
        return self._c_hits.value

    @cache_hits.setter
    def cache_hits(self, v: int) -> None:
        self._c_hits.set(v)

    @property
    def cache_misses(self) -> int:
        return self._c_misses.value

    @cache_misses.setter
    def cache_misses(self, v: int) -> None:
        self._c_misses.set(v)

    @property
    def reprice_refreshes(self) -> int:
        """Rankings refreshed via the incremental path (not recomputes)."""
        return self._c_refreshes.value

    @property
    def reprice_dispatches(self) -> int:
        """Kernel dispatches spent repricing: one per live state per tick
        for the per-state backend, exactly one per tick for the fleet
        backend ("torch_fused") regardless of fleet size."""
        return self._c_dispatches.value

    # -- price management ---------------------------------------------------
    @property
    def price_epoch(self) -> int:
        return self._price_epoch

    @property
    def price_source(self) -> Any:
        return self._price_source

    def set_price_source(self, price_source: Any) -> None:
        """Swap in current prices; invalidates all cached rankings."""
        self._price_source = price_source
        self.invalidate_prices()

    def invalidate_prices(self) -> None:
        """Bump the price epoch (e.g. the same mutable source re-quoted)."""
        self._price_epoch += 1
        self._cache.clear()
        self._head_cache.clear()
        self._states.clear()
        self._state_tags.clear()
        self._batched = None
        self._batched_tag = None
        self._batched_store_version = None

    def price_snapshot(self) -> Tuple[int, Tuple[Tuple[Hashable, float],
                                                 ...]]:
        """``(price_epoch, ((config_id, $/h), ...))`` in catalog order —
        the self-contained state a journal consumer needs to reconstruct
        this service's prices at a later time (DESIGN.md §8).  Works for
        any price source; for a :class:`PriceTable` it is the table's
        current quotes."""
        prices = self.catalog.price_vector(self._price_source)
        return self._price_epoch, tuple(
            (c, float(p)) for c, p in zip(self.catalog.ids(), prices))

    def _price_tag(self) -> Tuple:
        """What cached rankings are keyed on: the epoch, plus the table
        version for :class:`PriceTable` sources — so quotes applied to
        the table *outside* :meth:`reprice` can never serve a stale
        cached ranking (they force a cold recompute instead)."""
        src = self._price_source
        return (self._price_epoch,
                src.version if isinstance(src, PriceTable) else None)

    def reprice(self, deltas: Mapping[Hashable, float]) -> int:
        """Apply ``{config_id: new $/h}`` quotes incrementally.

        Requires the price source to be a :class:`PriceTable` (the table
        is the single source of truth for cold recomputes; applying deltas
        anywhere else would let an incremental ranking and a later cold
        ranking disagree within one epoch).  Delta ids are validated
        against the catalog *before* the table mutates, so a bad batch
        cannot desync live states from the table.  The table is updated,
        the epoch bumps, and every live :class:`RankState` that was in
        sync with the table before this tick is repriced in place (a
        state that missed an out-of-band ``table.apply`` is dropped and
        rebuilt cold); refreshed rankings materialize lazily on the next
        ``rank``/``submit`` (building and sorting the ranking list costs
        more than the incremental update itself at 10k configs — no point
        paying it per tick for classes nobody submits).  Returns the
        number of states repriced incrementally.
        """
        if not isinstance(self._price_source, PriceTable):
            raise ValueError(
                "reprice requires a PriceTable price source; use "
                "set_price_source/invalidate_prices for model sources")
        deltas = dict(deltas)
        if not deltas:
            return 0
        with self.metrics.span("reprice.validate"):
            unknown = [c for c in deltas if c not in self.catalog]
        if unknown:
            raise ValueError(
                f"unknown config ids in price deltas: {unknown[:3]!r}")
        prev_tag = self._price_tag()
        self._price_source.apply(deltas)
        self._price_epoch += 1
        self._cache.clear()
        self._head_cache.clear()
        tag = self._price_tag()
        refreshed = 0
        with self.metrics.span("reprice.dispatch"):
            if self.backend in FLEET_BACKENDS:
                # the whole fleet refreshes in ONE fused dispatch
                if self._batched is not None and (
                        self._batched_store_version != self.store.version
                        or self._batched_tag != prev_tag):
                    # stale trace, or a universe that missed an out-of-band
                    # table.apply before this tick: repricing it would
                    # serve quotes it never saw — drop it, rebuild cold on
                    # demand
                    self._batched = None
                    self._batched_tag = None
                    self._batched_store_version = None
                if self._batched is not None:
                    self._batched.reprice(deltas)
                    self._batched_tag = tag
                    self._c_dispatches.inc()
                    refreshed = self._batched.n_active
            else:
                for key, state in list(self._states.items()):
                    store_version = key[0]
                    if store_version != self.store.version or \
                            self._state_tags.get(key) != prev_tag:
                        # stale trace, or a state that missed an
                        # out-of-band table.apply before this tick:
                        # repricing it would serve quotes it never saw —
                        # drop it, rebuild cold on demand
                        del self._states[key]
                        self._state_tags.pop(key, None)
                        continue
                    state.reprice(deltas)
                    self._state_tags[key] = tag
                    self._c_dispatches.inc()
                    refreshed += 1
        self._c_refreshes.inc(refreshed)
        return refreshed

    # -- fleet management ----------------------------------------------------
    def retire_selection(self, job_class: Optional[JobClass] = None,
                         exclude_groups: Sequence[str] = ()) -> bool:
        """Retire a live (class, exclusion) selection: drop its cached
        rankings/heads and its live state (fleet backend: the member is
        retired from the shared :class:`TorchFusedRankState`, so any stale
        closure still bound to it raises
        :class:`~repro_torch.selector.NothingRankableError` — a typed
        rejection, never a raw ``KeyError`` or a masked-slot score).

        Retirement is *serving-state* hygiene, not a ban: a later submit
        for the same selection rebuilds it cold and serves normally —
        the journal only records a rejection when the selection is
        genuinely unrankable.  Returns True when anything was dropped.
        """
        base_key = (self.store.version, job_class,
                    tuple(sorted(exclude_groups)))
        retired = False
        for cache in (self._cache, self._head_cache):
            for key in [k for k in cache if k[2:5] == base_key]:
                del cache[key]
                retired = True
        if self._states.pop(base_key, None) is not None:
            self._state_tags.pop(base_key, None)
            retired = True
        if self._batched is not None and base_key in self._batched:
            self._batched.retire_state(base_key)
            retired = True
        return retired

    # -- ranking (cached) ----------------------------------------------------
    def _live_serving(self, base_key: Tuple, tag: Tuple
                      ) -> Optional[Tuple[Callable[[], Sequence[RankedConfig]],
                                          Callable[[int],
                                                   Sequence[RankedConfig]]]]:
        """``(ranking_fn, top_k_fn)`` bound to an in-sync live state for
        ``base_key`` (repriced incrementally on the last tick — serving
        from it is a cache hit, no ranking recompute happened), or
        ``None`` when the selection must be built cold."""
        if self.backend in FLEET_BACKENDS:
            b = self._batched
            if b is not None and self._batched_tag == tag and \
                    self._batched_store_version == self.store.version \
                    and base_key in b:
                return (lambda: b.ranking(base_key),
                        lambda k: b.top_k(base_key, k))
            return None
        state = self._states.get(base_key)
        if state is not None and self._state_tags.get(base_key) == tag:
            return state.ranking, state.top_k
        return None

    def _build_serving(self, base_key: Tuple, tag: Tuple,
                       job_class: Optional[JobClass],
                       exclude_groups: Sequence[str]
                       ) -> Tuple[Callable[[], Sequence[RankedConfig]],
                                  Callable[[int], Sequence[RankedConfig]]]:
        """Cold-build the live state serving ``base_key`` and return its
        ``(ranking_fn, top_k_fn)``.  The numpy backend builds one
        RankState over the selection's rows; the fleet backend registers
        the selection as a member of the one shared
        :class:`TorchFusedRankState` over the full store (building that
        universe first if the trace or price tag moved on)."""
        jobs = self.store.select_jobs(job_class=job_class,
                                      exclude_groups=exclude_groups)
        if not jobs:
            raise NothingRankableError("no test jobs to learn from")
        config_ids = self.catalog.ids()
        prices = self.catalog.price_vector(self._price_source)
        if self.backend in FLEET_BACKENDS:
            b = self._batched
            if b is None or \
                    self._batched_store_version != self.store.version \
                    or self._batched_tag != tag:
                all_jobs = self.store.job_ids
                hours, mask = self.store.matrix(job_ids=all_jobs,
                                                config_ids=config_ids)
                b = TorchFusedRankState(hours, mask, prices, config_ids,
                                        job_ids=all_jobs,
                                        metrics=self.metrics,
                                        device=self.device)
                self._batched = b
                self._batched_tag = tag
                self._batched_store_version = self.store.version
            if base_key not in b:
                b.add_state(base_key, jobs=jobs)
            return (lambda: b.ranking(base_key),
                    lambda k: b.top_k(base_key, k))
        hours, mask = self.store.matrix(job_ids=jobs, config_ids=config_ids)
        # build through a live state so later reprices are incremental:
        # RankState's arithmetic is the cold numpy path verbatim
        # (bit-identical)
        for stale in [k for k in self._states
                      if k[0] != self.store.version]:
            del self._states[stale]
            self._state_tags.pop(stale, None)
        state = RankState(hours, mask, prices, config_ids, job_ids=jobs,
                          metrics=self.metrics)
        self._states[base_key] = state
        self._state_tags[base_key] = tag
        return state.ranking, state.top_k

    def _prune_caches(self, tag: Tuple) -> None:
        # a miss means the tag (or trace) moved on; entries under dead
        # tags or store versions are unreachable forever (epoch, table
        # version and store version are all monotonic) — prune them so
        # out-of-band table.apply + submit cycles don't grow the caches
        # without bound
        for cache in (self._cache, self._head_cache):
            for stale in [k for k in cache
                          if k[:2] != tag or k[2] != self.store.version]:
                del cache[stale]

    def rank_cached(self, job_class: Optional[JobClass] = None,
                    exclude_groups: Sequence[str] = ()
                    ) -> Tuple[Tuple[RankedConfig, ...], bool]:
        """Rank the catalog for a class; returns ``(ranking, from_cache)``.

        The hit/miss fact is returned explicitly (not inferred from
        counter deltas, which misreport under reentrant or concurrent
        ``rank`` calls).  ``from_cache`` is also True when the ranking
        materializes from a live, already-repriced :class:`RankState`
        (the incremental path: no ranking recompute happened).
        """
        base_key = (self.store.version, job_class,
                    tuple(sorted(exclude_groups)))
        tag = self._price_tag()
        key = tag + base_key
        hit = self._cache.get(key)
        if hit is not None:
            self._c_hits.inc()
            return hit, True
        live = self._live_serving(base_key, tag)
        if live is not None:
            # repriced incrementally on the last tick; materialize lazily
            ranking = tuple(live[0]())
            self._cache[key] = ranking
            self._c_hits.inc()
            return ranking, True
        self._c_misses.inc()
        self._prune_caches(tag)
        with self.metrics.span("rank.build"):
            serving = self._build_serving(base_key, tag, job_class,
                                          exclude_groups)
        ranking = tuple(serving[0]())
        self._cache[key] = ranking
        return ranking, False

    def rank_head(self, job_class: Optional[JobClass] = None,
                  exclude_groups: Sequence[str] = (), *, k: int
                  ) -> Tuple[Tuple[RankedConfig, ...], bool]:
        """The top-``k`` head of the ranking for a class; returns
        ``(head, from_cache)`` — the lazy serving path (DESIGN.md §10):
        when only the head is needed, the full C-config ranking is never
        materialized.  A cached full ranking is reused when present
        (its head is free); otherwise the head comes straight off the
        live state's score buffer (the ``select`` kernel on the fleet
        backend, a partial selection on numpy) and is cached per
        ``(tag, selection, k)``."""
        _check_head_k(k, "rank_head")
        return self._walk_head(job_class, exclude_groups, k,
                               self._price_tag())

    def rank_heads(self, routes: Sequence[Tuple[Optional[JobClass],
                                                Sequence[str]]], *, k: int
                   ) -> List[Union[Tuple[Tuple[RankedConfig, ...], bool],
                                   NothingRankableError]]:
        """Many selections' top-``k`` heads at once: element ``i`` is what
        ``rank_head(*routes[i], k=k)`` would return, called in order, or
        the :class:`NothingRankableError` it would raise (returned, not
        raised).  The caches and hit/miss counts end as those calls would
        leave them.  On the fleet backend every head a cache does not hold
        and a live member can serve comes from ONE ``select`` launch over
        the requested members' rows (:meth:`TorchFusedRankState.heads`);
        a selection not live yet is built as ``rank_head`` builds it.  On
        numpy it is ``rank_head`` route by route."""
        _check_head_k(k, "rank_heads")
        tag = self._price_tag()
        defer = self.backend in FLEET_BACKENDS
        served: List = []
        pending: List[Tuple[int, _Deferred]] = []
        for i, (klass, excl) in enumerate(routes):
            try:
                got = self._walk_head(klass, excl, k, tag, defer)
            except NothingRankableError as exc:
                got = exc
            if isinstance(got, _Deferred):
                pending.append((i, got))
            served.append(got)
        # a cold build above reuses the universe the live members sit in
        # (same tag and store version), so their slots still hold
        if pending:
            heads = self._batched.heads([d.member for _, d in pending], k)
            for (i, d), head in zip(pending, heads):
                # a route listed twice is served once, then from the cache
                self._c_hits.inc()
                served[i] = (self._head_cache.setdefault(d.head_key,
                                                         tuple(head)), True)
        return served

    def _walk_head(self, job_class, exclude_groups, k: int, tag: Tuple,
                   defer: bool = False):
        """One selection's head as ``rank_head`` serves it: a cached full
        ranking's head, else the head cache, else a live state's head
        (hits), else a cold build (a miss; raises
        :class:`NothingRankableError` where nothing is rankable).  With
        ``defer``, a head a live fleet member would serve is not computed:
        a :class:`_Deferred` comes back for :meth:`rank_heads`, which
        serves it, caches it and counts its hit."""
        base_key = (self.store.version, job_class,
                    tuple(sorted(exclude_groups)))
        key = tag + base_key
        full = self._cache.get(key)
        if full is not None:
            self._c_hits.inc()
            return full[:k], True
        head_key = key + (k,)
        hit = self._head_cache.get(head_key)
        if hit is not None:
            self._c_hits.inc()
            return hit, True
        live = self._live_serving(base_key, tag)
        if live is not None:
            if defer:
                return _Deferred(head_key, base_key)
            head = tuple(live[1](k))
            self._head_cache[head_key] = head
            self._c_hits.inc()
            return head, True
        self._c_misses.inc()
        self._prune_caches(tag)
        with self.metrics.span("rank.build"):
            serving = self._build_serving(base_key, tag, job_class,
                                          exclude_groups)
        head = tuple(serving[1](k))
        self._head_cache[head_key] = head
        return head, False

    def rank(self, job_class: Optional[JobClass] = None,
             exclude_groups: Sequence[str] = ()
             ) -> Tuple[RankedConfig, ...]:
        """Rank the whole catalog for a class (``None`` = all classes)."""
        return self.rank_cached(job_class, exclude_groups)[0]

    # -- the paper pipeline for one submitted job -----------------------------
    def classify(self, job_id: Hashable,
                 annotation: Optional[JobClass] = None
                 ) -> Optional[JobClass]:
        if annotation is not None:
            return annotation
        if self.classifier is not None:
            return self.classifier(job_id)
        if job_id in self.store.job_ids:
            return self.store.meta(job_id).job_class
        return None

    def effective_exclusions(self, job_id: Hashable,
                             exclude_groups: Optional[Sequence[str]] = None
                             ) -> Tuple[str, ...]:
        """The exclusion set a submission actually ranks under: the
        explicit argument, else the job's own group when the job is
        already profiled (the paper's no-recurrence discipline, §III-A).
        Exposed so journal writers can record the effective set even for
        submissions that never produce a Decision (rejections)."""
        if exclude_groups is not None:
            return tuple(exclude_groups)
        if job_id in self.store.job_ids:
            own = self.store.meta(job_id).group
            if own is not None:
                return (own,)
        return ()

    def submit(self, job_id: Hashable, *,
               annotation: Optional[JobClass] = None,
               exclude_groups: Optional[Sequence[str]] = None,
               one_class: bool = False,
               top_k: Optional[int] = None) -> Decision:
        """Classify, rank under current prices, pick the argmin.

        ``exclude_groups`` defaults to the job's own group when the job is
        already profiled (see :meth:`effective_exclusions`).

        ``top_k`` (default: the service's :attr:`serve_top_k`) switches
        the Decision to head-only serving: its ``ranking`` holds the
        first k entries (``served_via == "top_k"``) and the full sorted
        list is never materialized.  Winner, score and $/h are identical
        to full-ranking serving by construction (DESIGN.md §10).
        """
        klass = None if one_class else self.classify(job_id, annotation)
        exclude_groups = self.effective_exclusions(job_id, exclude_groups)
        k = top_k if top_k is not None else self.serve_top_k
        if k is None:
            ranking, from_cache = self.rank_cached(
                job_class=klass, exclude_groups=tuple(exclude_groups))
            served_via = "ranking"
        else:
            ranking, from_cache = self.rank_head(
                job_class=klass, exclude_groups=tuple(exclude_groups),
                k=k)
            served_via = "top_k"
        winner = ranking[0]
        if winner.score == float("inf"):
            # every catalog entry is unprofiled for this selection
            # (catalog/store id mismatch, or a fully-masked trace) —
            # an arbitrary pick must never look like a decision.
            raise NothingRankableError(
                f"no profiled configurations to rank for job {job_id!r} "
                f"(class {klass})")
        return Decision(
            job_id=job_id, job_class=klass, config_id=winner.config_id,
            entry=self.catalog.entry(winner.config_id),
            hourly_cost=self.catalog.hourly_cost(winner.config_id,
                                                 self._price_source),
            ranking=ranking, from_cache=from_cache,
            price_epoch=self._price_epoch,
            exclude_groups=tuple(exclude_groups),
            served_via=served_via)
