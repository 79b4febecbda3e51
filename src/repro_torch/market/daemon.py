"""SelectionDaemon: continuous selection over an interleaved event stream.

The production shape of the selector (ROADMAP north star): submissions
and price ticks arrive interleaved; the daemon routes each submission
through ``SelectionService.submit`` — same-class submissions between two
ticks are amortized into one ranking by the service's cache, and each
tick refreshes rankings incrementally instead of recomputing — and
journals every :class:`~repro_torch.selector.Decision` to versioned JSONL
(header line + one record per event, mirroring ``ProfilingStore``'s
schema).  Everything downstream of the seed is deterministic: the same
event stream against the same universe yields a byte-identical journal,
which is the reproducibility bar the benchmarks enforce.
"""
from __future__ import annotations

import dataclasses
import json
from typing import (Any, Dict, Hashable, Iterable, Iterator, List, Optional,
                    Sequence, Tuple, Union)

from repro_torch.core.trace import JobClass
from repro_torch.obs import MetricsRegistry, TICK_SPAN
from repro_torch.selector import (Decision, NothingRankableError,
                                  SelectionService)
from repro_torch.market.feed import (FeedError, PriceDelta, PriceFeed,
                                     hash_uniform)
from repro_torch.market.ticker import PriceTicker

JOURNAL_FORMAT = "repro.market.decision-journal"
#: v2 makes the journal *self-contained* for replay (DESIGN.md §8): the
#: header snapshots the starting prices and price epoch, tick records
#: carry the applied deltas, decision records carry the winner's score
#: and the effective exclusion set.  Within v2, the header also stamps
#: the service's ranking ``backend`` — replays pick their audit mode
#: from it (numpy: bit-identical; the float32 backends such as
#: torch_fused: the tolerance contract, DESIGN.md §9-§10, §13-§14);
#: journals written before
#: the stamp read as numpy.  New backend names are additive: the stamp
#: is data, and consumers resolve it through ``score_contract``.  Decision records served via device-side top-k carry an
#: additive ``served_via`` field (absent = full-ranking serving); a
#: feed that raises mid-tick journals an additive ``feed-error`` record
#: kind (the tick is retried; prices stay at the last good epoch); and
#: journals merged from the concurrent front-end
#: (the reference's ``repro.market.frontend``) stamp decisions/rejections with
#: additive ``worker`` / ``snapshot_tick`` fields and tick/feed-error
#: records with ``worker`` / ``tick`` — consumers skip unknown fields
#: and record kinds, so none of these bump the version.
#: Every version bump MUST add a migration note to the table in
#: DESIGN.md §8.
JOURNAL_VERSION = 2


# -- shared record builders --------------------------------------------------
# The daemon and the concurrent front-end (repro.market.frontend)
# journal the *same* record shapes — built here once, so the
# byte-exactness contract (numpy journals golden-file identical) can
# never fork between the two serving layers.

def tick_record(seq: int, deltas: Sequence[PriceDelta],
                price_epoch: int) -> Dict[str, Any]:
    return {"kind": "tick", "seq": seq, "deltas": len(deltas),
            "applied": [[d.config_id, d.price] for d in deltas],
            "price_epoch": price_epoch}


def decision_record(seq: int, decision: Decision) -> Dict[str, Any]:
    rec = {
        "kind": "decision", "seq": seq,
        "job": decision.job_id,
        "job_class": (decision.job_class.value
                      if decision.job_class else None),
        "config": decision.config_id,
        "hourly_cost": decision.hourly_cost,
        "score": decision.ranking[0].score,
        "exclude_groups": list(decision.exclude_groups),
        "from_cache": decision.from_cache,
        "price_epoch": decision.price_epoch,
    }
    if decision.served_via != "ranking":
        # additive field (DESIGN.md §8): stamped only for decisions
        # served without a full ranking materialization (top-k head
        # serving, §10) — absence means full-ranking serving, so
        # journals from full-serving daemons keep their bytes
        rec["served_via"] = decision.served_via
    return rec


def rejection_record(seq: int, job_id: Hashable,
                     job_class: Optional[JobClass],
                     exclude_groups: Sequence[str],
                     price_epoch: int) -> Dict[str, Any]:
    return {"kind": "rejected", "seq": seq, "job": job_id,
            "job_class": job_class.value if job_class else None,
            "exclude_groups": list(exclude_groups),
            "price_epoch": price_epoch}


def feed_error_record(seq: int, tick: int, error: str, failures: int,
                      price_epoch: int) -> Dict[str, Any]:
    """Additive record kind (DESIGN.md §8): ``feed.poll`` raised at
    ``tick`` (the tick is being retried; ``failures`` counts the
    consecutive failures so far) and prices stayed at ``price_epoch``.
    Replay consumers skip unknown kinds, so audits are unchanged."""
    return {"kind": "feed-error", "seq": seq, "tick": tick,
            "error": error, "failures": failures,
            "price_epoch": price_epoch}


def metrics_record(seq: int, tick: int, price_epoch: int,
                   registry: MetricsRegistry) -> Dict[str, Any]:
    """Additive record kind (DESIGN.md §8/§12): a cumulative telemetry
    snapshot taken after tick ``tick`` — every counter plus every span
    histogram (bucket bounds, per-bucket counts, ns-exact sum) from the
    serving registry, names sorted.  Cumulative-not-delta means a
    consumer can recover rates between any two records and the *last*
    record alone carries whole-run percentiles
    (:meth:`repro_torch.market.JournalReplayer.audit` surfaces ``tick.total``
    as ``ReplayAudit.tick_latency``).  Gauges are excluded: they are
    instantaneous reads, not mergeable accounting.  Replay consumers
    that predate the kind skip it, so audits stay byte-exact."""
    snap = registry.snapshot()
    return {"kind": "metrics", "seq": seq, "tick": tick,
            "price_epoch": price_epoch,
            "counters": snap["counters"],
            "histograms": snap["histograms"]}


@dataclasses.dataclass(frozen=True)
class Submission:
    """A job submission event in the daemon stream."""

    job_id: Hashable
    annotation: Optional[JobClass] = None
    exclude_groups: Optional[Tuple[str, ...]] = None


@dataclasses.dataclass(frozen=True)
class Tick:
    """A price-tick event: poll the feed once."""


Event = Union[Submission, Tick]


@dataclasses.dataclass
class DaemonStats:
    events: int = 0
    submissions: int = 0
    decisions: int = 0
    rejected: int = 0           # submissions with nothing rankable
    ticks: int = 0              # mirrors PriceTicker.tick_count
    deltas: int = 0             # mirrors PriceTicker.deltas_applied
    epochs: int = 0             # mirrors PriceTicker.epochs_driven
    feed_errors: int = 0        # polls that raised (tick retried)


class SelectionDaemon:
    """Consume events, decide, journal.  One instance = one journal."""

    def __init__(self, service: SelectionService, feed: PriceFeed,
                 metrics: Optional[MetricsRegistry] = None,
                 metrics_every: Optional[int] = None):
        self.service = service
        #: telemetry registry; defaults to the service's so the whole
        #: tick/serve pipeline exports as one (DESIGN.md §12).
        self.metrics = metrics if metrics is not None else service.metrics
        #: journal a cumulative ``"metrics"`` record every N successful
        #: ticks (``None`` — the default — journals none, keeping
        #: pre-obs journals byte-identical).
        if metrics_every is not None and (
                not isinstance(metrics_every, int)
                or isinstance(metrics_every, bool) or metrics_every < 1):
            raise ValueError(f"metrics_every must be a positive int or "
                             f"None, got {metrics_every!r}")
        self.metrics_every = metrics_every
        self.ticker = PriceTicker(feed, service, metrics=self.metrics)
        self._c_journal = self.metrics.counter("journal.appends")
        self.stats = DaemonStats()
        epoch, prices = service.price_snapshot()
        self._journal: List[str] = [json.dumps({
            "format": JOURNAL_FORMAT, "version": JOURNAL_VERSION,
            "backend": service.backend,
            "catalog": list(service.catalog.ids()),
            "price_epoch": epoch,
            # (config_id, $/h) pairs, not an object: JSON objects force
            # string keys, which would corrupt non-string config ids
            "prices": [[c, p] for c, p in prices]})]
        self._seq = 0
        self._feed_failures = 0     # consecutive; resets on a good tick

    # -- event handling ------------------------------------------------------
    def handle(self, event: Event) -> Optional[Decision]:
        """Process one event; returns the Decision for submissions."""
        self.stats.events += 1
        if isinstance(event, Tick):
            m = self.metrics
            t0 = m.clock() if m.spans_enabled else None
            try:
                deltas = self.ticker.tick()
            except FeedError as exc:
                # typed failure path: the feed died mid-tick, the tick
                # index was not consumed (the next Tick retries it) and
                # prices stayed at the last good epoch — journal the
                # event and keep serving instead of dying
                self.stats.feed_errors += 1
                self._feed_failures += 1
                self._record(feed_error_record(
                    self._next_seq(), exc.tick, str(exc),
                    self._feed_failures, self.service.price_epoch))
                return None
            self._feed_failures = 0
            # the ticker owns the tick bookkeeping; mirror, don't re-count
            self.stats.ticks = self.ticker.tick_count
            self.stats.deltas = self.ticker.deltas_applied
            self.stats.epochs = self.ticker.epochs_driven
            if deltas:
                self._record(tick_record(self._next_seq(), deltas,
                                         self.service.price_epoch))
            if t0 is not None:
                # successful ticks only; a FeedError tick returned above
                m.histogram(TICK_SPAN).observe(m.clock() - t0)
            if self.metrics_every is not None and \
                    self.ticker.tick_count % self.metrics_every == 0:
                self._record(metrics_record(
                    self._next_seq(), self.ticker.tick_count,
                    self.service.price_epoch, m))
            return None
        self.stats.submissions += 1
        try:
            with self.metrics.span("serve.submit"):
                decision = self.service.submit(
                    event.job_id, annotation=event.annotation,
                    exclude_groups=event.exclude_groups)
        except NothingRankableError:
            # nothing rankable for this submission (empty class, id
            # mismatch, retired member): journal the rejection, keep
            # serving — any other ValueError is misconfiguration and
            # propagates
            self.stats.rejected += 1
            klass = self.service.classify(event.job_id, event.annotation)
            excl = self.service.effective_exclusions(event.job_id,
                                                     event.exclude_groups)
            self._record(rejection_record(
                self._next_seq(), event.job_id, klass, excl,
                self.service.price_epoch))
            return None
        self.stats.decisions += 1
        self._record(decision_record(self._next_seq(), decision))
        return decision

    def run(self, events: Iterable[Event]) -> DaemonStats:
        for event in events:
            self.handle(event)
        return self.stats

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def _record(self, rec: Dict[str, Any]) -> None:
        self._journal.append(json.dumps(rec))
        self._c_journal.inc()

    # -- versioned JSONL journal ---------------------------------------------
    def journal_dump(self) -> str:
        return "\n".join(self._journal) + "\n"

    def save_journal(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.journal_dump())

    @staticmethod
    def loads_journal(text: str) -> Tuple[Dict[str, Any],
                                          List[Dict[str, Any]]]:
        """Parse a journal: (header, records).  Rejects foreign formats."""
        lines = [ln for ln in text.splitlines() if ln.strip()]
        if not lines:
            raise ValueError("empty decision journal")
        header = json.loads(lines[0])
        if header.get("format") != JOURNAL_FORMAT:
            raise ValueError(f"not a decision journal: {header!r}")
        if header.get("version") != JOURNAL_VERSION:
            raise ValueError(
                f"unsupported journal version {header.get('version')!r} "
                f"(current {JOURNAL_VERSION}; migration notes in "
                f"DESIGN.md §8)")
        return header, [json.loads(ln) for ln in lines[1:]]

    @classmethod
    def load_journal(cls, path: str) -> Tuple[Dict[str, Any],
                                              List[Dict[str, Any]]]:
        with open(path) as f:
            return cls.loads_journal(f.read())


def synthetic_stream(job_ids: Sequence[Hashable], n_events: int, *,
                     seed: int = 0, tick_fraction: float = 0.1
                     ) -> Iterator[Event]:
    """A deterministic interleaved submission/tick stream.

    Event kinds and job picks are hash-seeded (same discipline as
    :class:`SimulatedSpotFeed`), so ``(job_ids, n_events, seed)`` fully
    determines the stream — the determinism bar for daemon benchmarks.
    """
    if not job_ids:
        raise ValueError("no job ids to submit")
    for i in range(n_events):
        if hash_uniform(seed, "kind", i) < tick_fraction:
            yield Tick()
        else:
            yield Submission(job_ids[int(hash_uniform(seed, "job", i)
                                         * len(job_ids))])
