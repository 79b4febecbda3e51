"""ServeFrontend: concurrent serving off immutable per-tick snapshots.

The :class:`~repro_torch.market.SelectionDaemon` serializes every tick and
submission on one thread, so one slow submission (a client round-trip, a
placement call) stalls the whole fleet's repricing.  This module is the
concurrency layer on top of the exact same service/journal machinery
(DESIGN.md §11):

  * **one tick thread owns all mutable selection state.**  It is the only
    thread that touches the :class:`~repro_torch.selector.SelectionService`
    (and through it the shared
    :class:`~repro_torch.selector.TorchFusedRankState` delta refresh).  Per tick it polls the feed, applies the deltas, and
    publishes an immutable :class:`Snapshot`: the tick id, the price
    epoch, the price-table version, and the top-k head of every
    registered (class, exclusion) selection — pulled through
    ``SelectionService.rank_heads``, which on ``torch_fused`` serves
    every live selection's head from ONE ``select`` launch over the
    fleet's member rows (a selection not yet live is built through the
    per-selection ``rank_head`` path first).  All CUDA work happens on
    this thread; a snapshot holds only host values (Python floats,
    strings and the catalog's own objects), never a tensor.
  * **N submission workers serve lock-free.**  A worker resolves its
    submission's (class, exclusion) route (memoized, read-only), reads
    ``self._snapshot`` — a single reference load of an object that is
    never mutated after publication — and builds the
    :class:`~repro_torch.selector.Decision` straight from the snapshot
    entry.
    No locks, no service calls, no shared mutable state on this path.
    A route the snapshot does not carry is *forwarded* to the tick
    thread's control queue, which serves it through the full
    ``service.submit`` path, registers the selection, and republishes —
    so each selection forwards only until its first snapshot.
  * **bounded queues, explicit shed.**  :meth:`submit` round-robins
    submissions across per-worker queues and *refuses* (returns False,
    counts a shed) when the target queue is at capacity or the front-end
    is closed — backpressure is a visible outcome, never an unbounded
    buffer.  Every submission is accounted: accepted ones end as exactly
    one journaled decision or rejection, refused ones as exactly one
    shed.
  * **worker-sharded journals, deterministic merge.**  Each thread
    appends records to its own shard (no contention); every record
    carries the tick it was served under (``snapshot_tick`` on
    decisions/rejections, ``tick`` on tick/feed-error records) and its
    shard's ``worker`` id.  :meth:`journal_dump` merges shards by the
    total order ``(tick, worker, per-shard seq)`` — tick-thread records
    first within a tick — and renumbers ``seq``, which lands every
    decision between the tick records of its stamped epoch: the merged
    journal replays through the unmodified
    :class:`~repro_torch.market.JournalReplayer` byte/tolerance-clean.
  * **typed feed failures.**  A ``feed.poll`` that raises surfaces as
    :class:`~repro_torch.market.FeedError`; the tick thread journals a
    ``feed-error`` record, keeps serving off the last good snapshot,
    and retries the same tick with capped exponential backoff.

Thread model: ``submit`` may be called from any number of producer
threads; everything else that mutates state runs on the tick thread or
on exactly one worker.  The inline stepping API (:meth:`step_tick`,
:meth:`serve_queued`) drives the same code paths without threads, which
is what makes deterministic golden tests of a concurrent subsystem
possible: same submissions, same interleave, same merged bytes.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import queue
import threading
import time
from types import MappingProxyType
from typing import (Any, Dict, Hashable, Iterable, List, Mapping, Optional,
                    Sequence, Tuple, Union)

from repro_torch.core.trace import JobClass
from repro_torch.obs import MetricsRegistry, TICK_SPAN
from repro_torch.selector import (Decision, NothingRankableError,
                                  RankedConfig, SelectionService)
from repro_torch.market.daemon import (JOURNAL_FORMAT, JOURNAL_VERSION,
                                       Submission, decision_record,
                                       feed_error_record, metrics_record,
                                       rejection_record, tick_record)
from repro_torch.market.feed import FeedError, PriceFeed
from repro_torch.market.ticker import PriceTicker

#: worker-queue poison pill (shutdown drains, then stops the worker).
_SENTINEL = object()

#: route key: the (class, effective-exclusions) a submission ranks under.
Route = Tuple[Optional[JobClass], Tuple[str, ...]]


@dataclasses.dataclass(frozen=True)
class SnapshotEntry:
    """One selection's published serving state.

    ``head is None`` marks a selection known to be unrankable (no
    profiled configurations) — workers serve those as journaled
    rejections without a service call.  Unrankability is
    price-independent (it is a property of the trace/catalog overlap),
    so a published rejection can never go stale within a run.
    """

    job_class: Optional[JobClass]
    exclude_groups: Tuple[str, ...]
    head: Optional[Tuple[RankedConfig, ...]]
    entry: Any = None               # the winner's native catalog object
    hourly_cost: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """What the tick thread publishes and workers serve from.

    Immutable by construction: frozen dataclass, read-only ``entries``
    mapping, tuple heads.  Publication is a single reference store to
    ``ServeFrontend._snapshot`` and consumption a single reference load,
    so workers always see a complete snapshot — never a half-updated
    one — without any lock (DESIGN.md §11).
    """

    tick: int                       # last applied tick index (-1 = none)
    price_epoch: int
    table_version: int
    k: int                          # head depth the entries carry
    entries: Mapping[Route, SnapshotEntry]


@dataclasses.dataclass
class FrontendStats:
    submitted: int = 0          # accepted into a worker queue
    shed: int = 0               # refused at enqueue (full queue / closed)
    decisions: int = 0          # journaled decisions (workers + control)
    rejected: int = 0           # journaled rejections
    forwarded: int = 0          # worker misses routed to the tick thread
    ticks: int = 0              # mirrors PriceTicker.tick_count
    deltas: int = 0             # mirrors PriceTicker.deltas_applied
    epochs: int = 0             # mirrors PriceTicker.epochs_driven
    feed_errors: int = 0        # polls that raised (tick retried)
    snapshots: int = 0          # snapshots published
    callback_errors: int = 0    # on_decision callbacks that raised

    @property
    def accounted(self) -> bool:
        """Every accepted submission ended as exactly one journaled
        decision or rejection (refused ones as exactly one shed) — the
        drain-accounting invariant the overflow tests pin."""
        return self.submitted == self.decisions + self.rejected


def merge_shards(header_line: str,
                 shards: Sequence[Sequence[Dict[str, Any]]]) -> str:
    """Merge per-thread journal shards into one v2 journal (text).

    Every sharded record is self-describing: decisions/rejections carry
    ``snapshot_tick`` and ``worker``, tick/feed-error/metrics records
    ``tick`` and ``worker``.  The merge sorts by the total order
    ``(tick, worker, position-in-shard)`` — unique per record, so the
    result is deterministic for given shard contents regardless of how
    thread scheduling interleaved the appends — then renumbers ``seq``
    in merged order.  Tick-thread records (worker 0) sort first within
    a tick, which places every worker decision *after* the tick record
    of the epoch it was served under and *before* the next one: exactly
    the ordering :class:`~repro_torch.market.JournalReplayer` needs to
    reconstruct each decision's prices.
    """
    items: List[Tuple[int, int, int, Dict[str, Any]]] = []
    for shard in shards:
        for pos, rec in enumerate(shard):
            tick = rec["snapshot_tick"] if "snapshot_tick" in rec \
                else rec["tick"]
            items.append((tick, rec["worker"], pos, rec))
    items.sort(key=lambda it: it[:3])
    lines = [header_line]
    for seq, (_, _, _, rec) in enumerate(items, start=1):
        rec = dict(rec)
        rec["seq"] = seq
        lines.append(json.dumps(rec))
    return "\n".join(lines) + "\n"


class ServeFrontend:
    """Tick-owned repricing + N lock-free snapshot-serving workers.

    Threaded use::

        fe = ServeFrontend(service, feed, workers=4, queue_capacity=256)
        fe.warm(submissions)        # optional: pre-register selections
        fe.start()
        for sub in submissions:
            fe.submit(sub)          # False = shed (queue full)
        fe.drain(); stats = fe.shutdown()
        audit = JournalReplayer(store, fe.journal_dump()).audit()

    Inline (no threads — deterministic tests and goldens)::

        fe.submit(sub); fe.step_tick(); fe.serve_queued(); fe.close()

    ``on_decision`` is invoked (on the serving thread) with every
    :class:`~repro_torch.selector.Decision` — the reply hook where a real
    deployment answers the client; a slow callback stalls only its own
    worker, never the tick thread's repricing.
    """

    def __init__(self, service: SelectionService, feed: PriceFeed, *,
                 workers: int = 2, queue_capacity: int = 64,
                 top_k: Optional[int] = None,
                 ticks: Optional[int] = None,
                 tick_interval: float = 0.0,
                 idle_sleep: float = 0.001,
                 backoff_base: float = 0.01, backoff_cap: float = 1.0,
                 on_decision: Optional[Any] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 metrics_every: Optional[int] = None,
                 span_sample: int = 32):
        if not isinstance(workers, int) or isinstance(workers, bool) \
                or workers < 1:
            raise ValueError(f"workers must be a positive int, "
                             f"got {workers!r}")
        if not isinstance(queue_capacity, int) or queue_capacity < 1:
            raise ValueError(f"queue_capacity must be a positive int, "
                             f"got {queue_capacity!r}")
        if top_k is None:
            top_k = service.serve_top_k if service.serve_top_k else 3
        if not isinstance(top_k, int) or isinstance(top_k, bool) \
                or top_k < 1:
            raise ValueError(f"top_k must be a positive int, "
                             f"got {top_k!r}")
        if metrics_every is not None and (
                not isinstance(metrics_every, int)
                or isinstance(metrics_every, bool) or metrics_every < 1):
            raise ValueError(f"metrics_every must be a positive int or "
                             f"None, got {metrics_every!r}")
        if not isinstance(span_sample, int) or isinstance(span_sample, bool) \
                or span_sample < 1:
            raise ValueError(f"span_sample must be a positive int, "
                             f"got {span_sample!r}")
        self.service = service
        #: the telemetry registry (DESIGN.md §12); defaults to the
        #: service's so ticks, repricing and serving export as one.
        #: :meth:`metrics` renders it; ``metrics_every`` journals it.
        self.metrics_registry = \
            metrics if metrics is not None else service.metrics
        #: journal a cumulative ``"metrics"`` record (shard 0) every N
        #: successful ticks; ``None`` (default) journals none, keeping
        #: pre-obs golden journals byte-identical.
        self.metrics_every = metrics_every
        #: the worker serve span ("serve.worker") times every
        #: ``span_sample``-th submission per shard (first included) —
        #: the sampling that keeps instrumentation under the <3%
        #: hot-path overhead budget (benchmarks/obs_bench.py); 1 = time
        #: every serve (golden runs).  All *counters* stay exact.
        self.span_sample = span_sample
        self.ticker = PriceTicker(feed, service,
                                  metrics=self.metrics_registry)
        self.workers = workers
        self.queue_capacity = queue_capacity
        self.top_k = top_k
        #: tick budget: the tick loop stops polling past it (``None``
        #: = the feed's recorded horizon when it has one, else
        #: unlimited); control traffic is processed either way.
        self.ticks = ticks if ticks is not None \
            else getattr(feed, "ticks", None)
        self.tick_interval = tick_interval
        self.idle_sleep = idle_sleep
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.on_decision = on_decision

        epoch, prices = service.price_snapshot()
        self._header_line = json.dumps({
            "format": JOURNAL_FORMAT, "version": JOURNAL_VERSION,
            "backend": service.backend,
            "catalog": list(service.catalog.ids()),
            "price_epoch": epoch,
            "prices": [[c, p] for c, p in prices]})

        # shard 0 = tick thread; shards 1..N = workers (append-only
        # lists, one writer each; list.append is atomic under the GIL)
        self._shards: List[List[Dict[str, Any]]] = \
            [[] for _ in range(workers + 1)]
        # per-shard registry cells (the frontend's old private _Counters,
        # migrated onto the registry): cell s is written only by the
        # thread serving shard s — worker s, or the tick thread for 0 —
        # the same single-writer discipline as the journal shards, so
        # increments stay plain int adds with no synchronization.
        reg = self.metrics_registry
        shard_cells = lambda name: [reg.counter(name).cell(s)
                                    for s in range(workers + 1)]
        self._cell_decisions = shard_cells("frontend.decisions")
        self._cell_rejected = shard_cells("frontend.rejected")
        self._cell_forwarded = shard_cells("frontend.forwarded")
        self._cell_cb_errors = shard_cells("frontend.callback_errors")
        self._cell_journal = shard_cells("journal.appends")
        self._c_decisions = reg.counter("frontend.decisions")
        self._c_rejected = reg.counter("frontend.rejected")
        self._c_forwarded = reg.counter("frontend.forwarded")
        self._c_cb_errors = reg.counter("frontend.callback_errors")
        self._c_feed_errors = reg.counter("frontend.feed_errors")
        self._c_snapshots = reg.counter("frontend.snapshots")
        # producer-side accounting: counters, not logs — submit() is
        # called for every submission of a long-running deployment, so
        # anything that grows per call (the old _accepted_log/_shed_log
        # deques) is an unbounded-memory bug, pinned by the memory
        # regression test.  Producer threads each write their own
        # thread-keyed cell.
        self._c_submitted = reg.counter("frontend.submitted")
        self._c_shed = reg.counter("frontend.shed")
        # per-shard serve-span state: countdown-to-next-sample counters
        # (0 = sample now) + bound cells.  spans_enabled/clock are
        # cached as plain attributes — the per-serve cost of sampling
        # must be a couple of list/attribute ops, not registry lookups
        # (the <3% budget is measured, not assumed: obs_bench gates it).
        self._spans_enabled = reg.spans_enabled
        self._clock = reg.clock
        self._span_left = [0] * (workers + 1)
        self._h_serve = [reg.histogram("serve.worker").cell(s)
                         for s in range(workers + 1)]
        self._h_fwd_rtt = reg.histogram("serve.forward_rtt")
        self._queues: List["queue.SimpleQueue"] = \
            [queue.SimpleQueue() for _ in range(workers)]
        self._control: "queue.SimpleQueue" = queue.SimpleQueue()
        self._rr = itertools.count()
        self._route_memo: Dict[Tuple, Route] = {}
        #: registered selections (tick-thread-owned; insertion-ordered,
        #: so snapshot iteration — and with it the journal — is
        #: deterministic).
        self._selections: Dict[Route, bool] = {}
        self._last_tick = -1
        self._feed_failures = 0
        self._closed = False
        self._stop_ticks = False
        self._started = False
        self._thread_errors: List[Tuple[int, BaseException]] = []
        self._tick_thread: Optional[threading.Thread] = None
        self._worker_threads: List[threading.Thread] = []
        self._snapshot: Snapshot = self._build_snapshot()

    # -- snapshot publication (tick thread only) -----------------------------
    def _build_snapshot(self) -> Snapshot:
        svc = self.service
        entries: Dict[Route, SnapshotEntry] = {}
        routes = list(self._selections)
        # every route's head in one call: exactly what per-route
        # rank_head calls would return (heads, rejections, cache state)
        for route, served in zip(routes,
                                 svc.rank_heads(routes, k=self.top_k)):
            klass, excl = route
            if isinstance(served, NothingRankableError):
                entries[route] = SnapshotEntry(klass, excl, None)
                continue
            head, _ = served
            if head[0].score == float("inf"):
                # every catalog entry unprofiled for this selection —
                # same check service.submit applies (DESIGN.md §10)
                entries[route] = SnapshotEntry(klass, excl, None)
                continue
            win = head[0].config_id
            entries[route] = SnapshotEntry(
                klass, excl, tuple(head), svc.catalog.entry(win),
                svc.catalog.hourly_cost(win, svc.price_source))
        return Snapshot(tick=self._last_tick, price_epoch=svc.price_epoch,
                        table_version=svc.price_source.version,
                        k=self.top_k,
                        entries=MappingProxyType(entries))

    def _publish(self) -> None:
        with self.metrics_registry.span("snapshot.build"):
            snap = self._build_snapshot()
        # a single reference store: workers reading self._snapshot see
        # either the old snapshot or the new one, never a mix
        self._snapshot = snap
        self._c_snapshots.inc()

    @property
    def snapshot(self) -> Snapshot:
        """The latest published snapshot (what workers serve from)."""
        return self._snapshot

    # -- routing (read-only, memoized, any thread) ---------------------------
    def _route(self, sub: Submission) -> Route:
        key = (sub.job_id, sub.annotation, sub.exclude_groups)
        hit = self._route_memo.get(key)
        if hit is None:
            klass = self.service.classify(sub.job_id, sub.annotation)
            excl = self.service.effective_exclusions(sub.job_id,
                                                     sub.exclude_groups)
            hit = (klass, tuple(excl))
            self._route_memo[key] = hit
        return hit

    # -- producer side -------------------------------------------------------
    def submit(self, submission: Union[Submission, Hashable]) -> bool:
        """Enqueue a submission; returns False when it was shed (the
        target worker queue is at capacity, or the front-end is closed).
        Callable from any thread.  The capacity check is approximate
        under concurrent producers (``SimpleQueue.qsize`` races by at
        most the producer count) — the bound it enforces is explicit
        backpressure, not an exact high-water mark."""
        if not isinstance(submission, Submission):
            submission = Submission(submission)
        if self._closed:
            self._c_shed.inc()
            return False
        w = next(self._rr) % self.workers
        q = self._queues[w]
        if q.qsize() >= self.queue_capacity:
            self._c_shed.inc()
            return False
        q.put(submission)
        self._c_submitted.inc()
        return True

    def retire_selection(self, job_class: Optional[JobClass] = None,
                         exclude_groups: Sequence[str] = ()) -> None:
        """Ask the tick thread to retire a (class, exclusion) selection:
        it is dropped from the snapshot and retired in the service
        (batched backend: the shared state's member slot is freed).  A
        later submission for it re-registers through the control path —
        or journals a genuine rejection if it is unrankable."""
        self._control.put(("retire", job_class, tuple(exclude_groups)))

    # -- serving (worker w, or inline) ---------------------------------------
    def _serve_one(self, w: int, sub: Submission, t0: float = -1.0) -> None:
        # the lock-free hot path: spans here are hand-rolled (no context
        # manager allocation) and sampled 1-in-span_sample per shard —
        # the <3% overhead budget of DESIGN.md §12.  The serve loops own
        # the sampling countdown (plain local ints; see serve_queued /
        # _worker_loop) and pass ``t0 >= 0`` only for a sampled serve;
        # the default means "not timing this one".  Counters are always
        # exact regardless.
        snap = self._snapshot            # one atomic reference load
        route = self._route(sub)
        entry = snap.entries.get(route)
        if entry is None:
            # selection not published yet (or just retired): the tick
            # thread owns the service, so the miss path goes to it.
            # Stamp the forward time so the control thread can observe
            # the full queue round-trip ("serve.forward_rtt").
            if self._spans_enabled:
                self._control.put(("fwd", sub, self._clock()))
            else:
                self._control.put(sub)
            self._cell_forwarded[w].inc()
            return
        if entry.head is None:
            rec = rejection_record(0, sub.job_id, route[0], route[1],
                                   snap.price_epoch)
            rec["worker"] = w
            rec["snapshot_tick"] = snap.tick
            self._shards[w].append(rec)
            self._cell_journal[w].inc()
            self._cell_rejected[w].inc()
            if t0 >= 0.0:
                self._h_serve[w].observe(self._clock() - t0)
            return
        decision = Decision(
            job_id=sub.job_id, job_class=route[0],
            config_id=entry.head[0].config_id, entry=entry.entry,
            hourly_cost=entry.hourly_cost, ranking=entry.head,
            from_cache=True, price_epoch=snap.price_epoch,
            exclude_groups=route[1], served_via="top_k")
        rec = decision_record(0, decision)
        rec["worker"] = w
        rec["snapshot_tick"] = snap.tick
        self._shards[w].append(rec)
        self._cell_journal[w].inc()
        self._cell_decisions[w].inc()
        if t0 >= 0.0:
            # serve latency proper: snapshot load -> journaled decision,
            # excluding the client-reply callback below (whose cost is
            # the deployment's, not the front-end's)
            self._h_serve[w].observe(self._clock() - t0)
        if self.on_decision is not None:
            try:
                self.on_decision(decision)
            except Exception:
                self._cell_cb_errors[w].inc()

    def serve_queued(self, worker: Optional[int] = None) -> int:
        """Inline mode: serve everything currently queued for ``worker``
        (1-based; ``None`` = every worker, in worker order) on the
        calling thread.  Returns the number of submissions served."""
        served = 0
        spans, clock = self._spans_enabled, self._clock
        stride = self.span_sample
        ws = range(1, self.workers + 1) if worker is None else [worker]
        for w in ws:
            q = self._queues[w - 1]
            left = self._span_left[w]    # sampling countdown, 0 = now
            while True:
                try:
                    sub = q.get_nowait()
                except queue.Empty:
                    break
                if sub is _SENTINEL:
                    continue
                if spans:
                    left -= 1
                    if left < 0:
                        left = stride - 1
                        self._serve_one(w, sub, clock())
                    else:
                        self._serve_one(w, sub)
                else:
                    self._serve_one(w, sub)
                served += 1
            self._span_left[w] = left
        return served

    # -- the tick side (tick thread, or inline) ------------------------------
    def _serve_control(self, sub: Submission) -> int:
        """Serve one forwarded submission through the full service path;
        returns 1 when it registered a new selection."""
        route = self._route(sub)
        fresh = route not in self._selections
        if fresh:
            self._selections[route] = True
        try:
            decision = self.service.submit(
                sub.job_id, annotation=sub.annotation,
                exclude_groups=sub.exclude_groups, top_k=self.top_k)
        except NothingRankableError:
            rec = rejection_record(0, sub.job_id, route[0], route[1],
                                   self.service.price_epoch)
            rec["worker"] = 0
            rec["snapshot_tick"] = self._last_tick
            self._shards[0].append(rec)
            self._cell_journal[0].inc()
            self._cell_rejected[0].inc()
            return 1 if fresh else 0
        rec = decision_record(0, decision)
        rec["worker"] = 0
        rec["snapshot_tick"] = self._last_tick
        self._shards[0].append(rec)
        self._cell_journal[0].inc()
        self._cell_decisions[0].inc()
        if self.on_decision is not None:
            try:
                self.on_decision(decision)
            except Exception:
                self._cell_cb_errors[0].inc()
        return 1 if fresh else 0

    def _drain_control(self) -> int:
        """Process every queued control item; returns the number of
        selection-set changes (registrations + retirements)."""
        changed = 0
        m = self.metrics_registry
        while True:
            try:
                item = self._control.get_nowait()
            except queue.Empty:
                return changed
            if isinstance(item, tuple) and item and item[0] == "retire":
                _, klass, excl = item
                route = (klass, excl)
                if self._selections.pop(route, None) is not None:
                    changed += 1
                self.service.retire_selection(klass, excl)
                continue
            if isinstance(item, tuple) and item and item[0] == "fwd":
                # a worker miss with its forward timestamp: serve it,
                # then observe the whole forwarded round-trip (enqueue
                # -> control drain -> full service path)
                _, sub, t_fwd = item
                changed += self._serve_control(sub)
                if m.spans_enabled:
                    self._h_fwd_rtt.observe(m.clock() - t_fwd)
                continue
            changed += self._serve_control(item)

    def step_tick(self) -> str:
        """One tick-loop iteration: drain control traffic, poll/apply
        one tick (inside the budget), republish the snapshot when
        anything moved.  Returns ``"tick"``, ``"feed-error"`` or
        ``"idle"`` — the threaded loop keys its sleeps off this, and
        inline tests drive it directly for deterministic interleaves."""
        changed = self._drain_control()
        status = "idle"
        deltas = ()
        m = self.metrics_registry
        t0 = -1.0
        if self.ticks is None or self.ticker.tick_count < self.ticks:
            if m.spans_enabled:
                t0 = m.clock()
            try:
                deltas = self.ticker.tick()
            except FeedError as exc:
                self._c_feed_errors.inc()
                self._feed_failures += 1
                rec = feed_error_record(0, exc.tick, str(exc),
                                        self._feed_failures,
                                        self.service.price_epoch)
                rec["worker"] = 0
                rec["tick"] = exc.tick
                self._shards[0].append(rec)
                self._cell_journal[0].inc()
                if changed:
                    self._publish()
                return "feed-error"
            self._feed_failures = 0
            self._last_tick = self.ticker.tick_count - 1
            status = "tick"
            if deltas:
                rec = tick_record(0, deltas, self.service.price_epoch)
                rec["worker"] = 0
                rec["tick"] = self._last_tick
                self._shards[0].append(rec)
                self._cell_journal[0].inc()
        if deltas or changed:
            self._publish()
        if status == "tick":
            if t0 >= 0.0:
                # whole-tick latency, snapshot publication included —
                # successful ticks only (feed errors returned above)
                m.histogram(TICK_SPAN).observe(m.clock() - t0)
            if self.metrics_every is not None and \
                    self.ticker.tick_count % self.metrics_every == 0:
                rec = metrics_record(0, self._last_tick,
                                     self.service.price_epoch, m)
                rec["worker"] = 0
                self._shards[0].append(rec)
                self._cell_journal[0].inc()
        return status

    def backoff_delay(self, failures: Optional[int] = None) -> float:
        """Capped exponential backoff after consecutive feed failures."""
        n = self._feed_failures if failures is None else failures
        return min(self.backoff_cap,
                   self.backoff_base * (2 ** max(0, n - 1)))

    # -- threads -------------------------------------------------------------
    def _tick_loop(self) -> None:
        try:
            while not self._stop_ticks:
                status = self.step_tick()
                if status == "feed-error":
                    # keep serving off the last good snapshot; retry the
                    # same tick after a capped exponential backoff
                    time.sleep(self.backoff_delay())
                elif status == "idle":
                    time.sleep(self.idle_sleep)
                elif self.tick_interval:
                    time.sleep(self.tick_interval)
            # workers are already joined when shutdown flips the flag:
            # anything still in the control queue is the final drain
            self._drain_control()
        except BaseException as exc:          # pragma: no cover - guard
            self._thread_errors.append((0, exc))

    def _worker_loop(self, w: int) -> None:
        q = self._queues[w - 1]
        spans, clock = self._spans_enabled, self._clock
        stride = self.span_sample
        left = self._span_left[w]        # sampling countdown, 0 = now
        try:
            while True:
                try:
                    item = q.get(timeout=0.05)
                except queue.Empty:
                    continue
                if item is _SENTINEL:
                    # drain whatever raced in behind the sentinel, then
                    # exit — nothing accepted is ever dropped
                    while True:
                        try:
                            tail = q.get_nowait()
                        except queue.Empty:
                            break
                        if tail is not _SENTINEL:
                            self._serve_one(w, tail)
                    return
                if spans:
                    left -= 1
                    if left < 0:
                        left = stride - 1
                        self._serve_one(w, item, clock())
                        continue
                self._serve_one(w, item)
        except BaseException as exc:          # pragma: no cover - guard
            self._thread_errors.append((w, exc))

    def warm(self, submissions: Iterable[Union[Submission, Hashable]]
             ) -> int:
        """Pre-register the selections a submission stream will route to
        and publish them, so workers hit the snapshot from the first
        submission.  Call before :meth:`start` (or from the tick
        thread's context).  Returns the registered-selection count."""
        for sub in submissions:
            if not isinstance(sub, Submission):
                sub = Submission(sub)
            self._selections[self._route(sub)] = True
        self._publish()
        return len(self._selections)

    def start(self) -> "ServeFrontend":
        if self._started:
            raise RuntimeError("front-end already started")
        self._started = True
        self._tick_thread = threading.Thread(
            target=self._tick_loop, name="flora-tick", daemon=True)
        self._worker_threads = [
            threading.Thread(target=self._worker_loop, args=(w,),
                             name=f"flora-worker-{w}", daemon=True)
            for w in range(1, self.workers + 1)]
        self._tick_thread.start()
        for t in self._worker_threads:
            t.start()
        return self

    def await_ticks(self, n: Optional[int] = None,
                    timeout: float = 30.0) -> None:
        """Block until the tick thread has consumed ``n`` ticks
        (default: the whole tick budget).  Serving continues off
        intermediate snapshots the whole time — this only waits for
        the market to finish playing out."""
        target = self.ticks if n is None else n
        if target is None:
            raise ValueError("await_ticks needs n= when the front-end "
                             "has no tick budget")
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.ticker.tick_count >= target:
                return
            time.sleep(0.001)
        raise TimeoutError(
            f"tick thread consumed {self.ticker.tick_count}/{target} "
            f"ticks within {timeout}s")

    def drain(self, timeout: float = 30.0) -> None:
        """Block until every accepted submission has been journaled (as
        a decision or a rejection).  Raises ``TimeoutError`` otherwise —
        a deadlocked queue must fail the caller, not hang it."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._drained():
                return
            time.sleep(0.001)
        raise TimeoutError(
            f"front-end failed to drain within {timeout}s: "
            f"{self._c_submitted.value} accepted, "
            f"{self._served_total()} served")

    def _served_total(self) -> int:
        return self._c_decisions.value + self._c_rejected.value

    def _drained(self) -> bool:
        return self._served_total() >= self._c_submitted.value

    def close(self) -> FrontendStats:
        """Inline-mode shutdown: stop accepting, serve every queued
        submission and control item on the calling thread, return
        stats."""
        if self._started:
            raise RuntimeError("close() is the inline-mode drain; a "
                               "started front-end shuts down via "
                               "shutdown()")
        self._closed = True
        while not self._drained():
            before = self._served_total()
            self.serve_queued()
            self._drain_control()
            if self._served_total() == before:  # pragma: no cover
                raise RuntimeError("inline drain made no progress")
        return self.stats()

    def shutdown(self, timeout: float = 30.0) -> FrontendStats:
        """Graceful threaded drain: stop accepting, let every worker
        empty its queue, then let the tick thread serve the remaining
        control traffic, join everything, and surface any thread
        death.  All submitted-or-shed work is accounted for in the
        merged journal afterwards."""
        if not self._started:
            return self.close()
        self._closed = True
        for q in self._queues:
            q.put(_SENTINEL)
        hung = []
        for t in self._worker_threads:
            t.join(timeout)
            if t.is_alive():
                hung.append(t.name)
        self._stop_ticks = True
        assert self._tick_thread is not None
        self._tick_thread.join(timeout)
        if self._tick_thread.is_alive():
            hung.append(self._tick_thread.name)
        if hung:
            raise TimeoutError(f"threads failed to stop: {hung}")
        if self._thread_errors:
            w, exc = self._thread_errors[0]
            raise RuntimeError(
                f"serving thread {w} died: {exc!r}") from exc
        return self.stats()

    def __enter__(self) -> "ServeFrontend":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.shutdown()

    # -- stats + metrics + journal -------------------------------------------
    def stats(self) -> FrontendStats:
        return FrontendStats(
            submitted=self._c_submitted.value,
            shed=self._c_shed.value,
            decisions=self._c_decisions.value,
            rejected=self._c_rejected.value,
            forwarded=self._c_forwarded.value,
            ticks=self.ticker.tick_count,
            deltas=self.ticker.deltas_applied,
            epochs=self.ticker.epochs_driven,
            feed_errors=self._c_feed_errors.value,
            snapshots=self._c_snapshots.value,
            callback_errors=self._c_cb_errors.value)

    def metrics(self, fmt: str = "prom") -> str:
        """Render the front-end's registry: the merged counters and span
        histograms of the whole tick/serve pipeline, as Prometheus text
        (default) or ``fmt="json"`` (DESIGN.md §12).  Safe to call from
        any thread on a live front-end — merge-on-read never blocks the
        writers."""
        return self.metrics_registry.render(fmt)

    def shard_records(self, worker: int) -> List[Dict[str, Any]]:
        """One shard's records (journal order = append order).  Shard 0
        is the tick thread's (ticks, feed errors, control-path
        decisions); shards 1..N belong to the workers."""
        return [dict(rec) for rec in self._shards[worker]]

    def journal_dump(self) -> str:
        """The merged deterministic journal (see :func:`merge_shards`).
        Meaningful after :meth:`shutdown`/:meth:`close`; calling it on a
        live front-end merges whatever has been journaled so far."""
        return merge_shards(self._header_line,
                            [list(shard) for shard in self._shards])

    def save_journal(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.journal_dump())
