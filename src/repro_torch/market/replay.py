"""Replay: recorded price feeds and decision-journal consumers (DESIGN.md §8).

This module closes the loop of the live market
(:mod:`repro_torch.market.daemon`).  Three pieces:

  * :class:`RecordedPriceFeed` — a :class:`~repro_torch.market.feed.PriceFeed`
    over a recorded price history (CSV).  Unlike the stateful
    :class:`~repro_torch.market.feed.SimulatedSpotFeed`, a recording is a pure
    function of the tick, so replays are byte-deterministic by
    construction: the same file yields the same batches in the same
    order, forever.
  * :func:`record_feed` — capture *any* feed to that CSV format, turning
    a one-off simulation (or, later, a live billing API poll) into a
    reproducible fixture.  Recording a recording is the identity on the
    bytes.
  * :class:`JournalReplayer` — re-read a version-2 decision journal (the
    header snapshots the starting prices; tick records carry the applied
    deltas), reconstruct the price epoch at every decision, and
    :meth:`~JournalReplayer.audit` each journaled selection against a
    cold :func:`~repro_torch.selector.rank_dense` at that epoch, under the
    :class:`~repro_torch.selector.ScoreContract` of the backend stamped in
    the header — **bit-identical** for numpy journals, tolerance mode
    (same winner or contract-tied, scores in envelope, float32 drift
    surfaced in :attr:`ReplayAudit.drift`) for float32 journals
    (DESIGN.md §9) — an end-to-end consistency check of the whole
    feed → ticker → incremental-reprice → cache → decision path.
    :meth:`~JournalReplayer.evaluate` then scores the history against
    per-epoch and static-price oracles
    (:func:`repro_torch.core.evaluate.dynamic_evaluation`).

The CSV format (version 1):

    # repro.market.recorded-price-feed v1 ticks=40
    tick,config_id,price
    0,"\"n2-4x16\"",12.79
    ...

``tick`` is a non-decreasing integer; ``config_id`` is JSON-encoded (so
int and str ids round-trip with their types); ``price`` is ``repr(float)``
(round-trips to the exact same double).  Malformed rows raise
``ValueError`` with the offending line number — a price history that
parses partially is worse than one that fails loudly.
"""
from __future__ import annotations

import csv
import dataclasses
import io
import json
from typing import (Any, Dict, Hashable, Iterator, List, Mapping, Optional,
                    Sequence, Tuple, Union)

import numpy as np

from repro_torch.core.trace import JobClass
from repro_torch.market.daemon import SelectionDaemon
from repro_torch.obs import TICK_SPAN, histogram_quantile
from repro_torch.market.feed import PriceDelta, PriceFeed
from repro_torch.selector import (NothingRankableError, ProfilingStore,
                                  ScoreContract, rank_dense,
                                  score_contract)

FEED_FORMAT = "repro.market.recorded-price-feed"
FEED_VERSION = 1
_CSV_COLUMNS = ("tick", "config_id", "price")


# --- recorded feeds --------------------------------------------------------------

def _check_price(delta: PriceDelta, tick: int) -> None:
    """Reject quotes ``loads`` would refuse *at capture time* — a
    recording that cannot be loaded back is worse than a failed
    capture."""
    if not np.isfinite(delta.price) or not delta.price > 0:
        raise ValueError(
            f"non-positive or non-finite price {delta.price!r} for "
            f"{delta.config_id!r} at tick {tick}")


class RecordedPriceFeed:
    """Replays a recorded price history; a pure function of the tick.

    ``poll(t)`` returns the batch recorded at tick ``t`` (``()`` for
    quiet ticks and for ticks beyond the recording — past the end the
    market is simply flat).  :attr:`ticks` is the recorded horizon, so
    harnesses can size their event streams to consume the whole history.
    """

    def __init__(self, batches: Mapping[int, Sequence[PriceDelta]],
                 ticks: Optional[int] = None):
        self._batches: Dict[int, Tuple[PriceDelta, ...]] = {}
        for t, batch in batches.items():
            if not (isinstance(t, int) and t >= 0):
                raise ValueError(f"bad tick index {t!r}")
            seen = set()
            for d in batch:
                _check_price(d, t)
                if d.config_id in seen:
                    raise ValueError(f"duplicate quote for "
                                     f"{d.config_id!r} at tick {t}")
                seen.add(d.config_id)
            self._batches[t] = tuple(batch)
        last = max(self._batches) + 1 if self._batches else 0
        #: recorded horizon: polls at ``tick >= ticks`` are beyond the
        #: recording (always empty).
        self.ticks = last if ticks is None else ticks
        if self.ticks < last:
            raise ValueError(f"ticks={self.ticks} shorter than the last "
                             f"recorded batch (tick {last - 1})")

    # -- the feed protocol --------------------------------------------------
    def poll(self, tick: int) -> Tuple[PriceDelta, ...]:
        return self._batches.get(tick, ())

    def stream(self, ticks: Optional[int] = None, start: int = 0
               ) -> Iterator[Tuple[PriceDelta, ...]]:
        n = self.ticks if ticks is None else ticks
        for t in range(start, start + n):
            yield self.poll(t)

    def config_ids(self) -> List[Hashable]:
        """Every config id quoted anywhere in the recording (first-seen
        order)."""
        seen: Dict[Hashable, None] = {}
        for t in sorted(self._batches):
            for d in self._batches[t]:
                seen.setdefault(d.config_id, None)
        return list(seen)

    # -- CSV parsing --------------------------------------------------------
    @classmethod
    def loads(cls, text: str) -> "RecordedPriceFeed":
        lines = text.splitlines()
        if not lines:
            raise ValueError(
                "line 1: empty recorded price feed (expected the "
                f"'# {FEED_FORMAT} v{FEED_VERSION}' magic line)")
        if not lines[0].startswith("#"):
            raise ValueError(
                f"not a recorded price feed (missing '# {FEED_FORMAT} "
                f"v{FEED_VERSION}' magic line)")
        magic = lines[0].lstrip("#").split()
        if not magic or magic[0] != FEED_FORMAT:
            raise ValueError(f"not a recorded price feed: {lines[0]!r}")
        if len(magic) < 2 or magic[1] != f"v{FEED_VERSION}":
            raise ValueError(
                f"unsupported recorded-feed version in {lines[0]!r} "
                f"(current v{FEED_VERSION})")
        ticks = None
        for field in magic[2:]:
            if field.startswith("ticks="):
                try:
                    ticks = int(field[len("ticks="):])
                except ValueError:
                    raise ValueError(f"bad ticks= field in {lines[0]!r}")
        if len(lines) < 2 or \
                tuple(lines[1].strip().split(",")) != _CSV_COLUMNS:
            raise ValueError(
                f"line 2: expected header '{','.join(_CSV_COLUMNS)}', "
                f"got {lines[1].strip() if len(lines) > 1 else ''!r}")
        batches: Dict[int, List[PriceDelta]] = {}
        prev_tick = -1
        for lineno, row in zip(
                range(3, len(lines) + 1),
                csv.reader(lines[2:], lineterminator="\n")):
            if not row:
                continue                      # blank trailing line
            if len(row) != 3:
                raise ValueError(
                    f"line {lineno}: expected 3 fields "
                    f"(tick,config_id,price), got {len(row)}: {row!r}")
            try:
                tick = int(row[0])
            except ValueError:
                raise ValueError(
                    f"line {lineno}: tick {row[0]!r} is not an integer")
            if tick < prev_tick:
                raise ValueError(
                    f"line {lineno}: tick {tick} out of order "
                    f"(after {prev_tick})")
            if tick < 0:
                raise ValueError(f"line {lineno}: negative tick {tick}")
            prev_tick = tick
            try:
                config_id = json.loads(row[1])
            except json.JSONDecodeError:
                raise ValueError(
                    f"line {lineno}: config_id {row[1]!r} is not valid "
                    f"JSON")
            if isinstance(config_id, (list, dict)):
                raise ValueError(
                    f"line {lineno}: config_id {row[1]!r} is not hashable")
            try:
                price = float(row[2])
            except ValueError:
                raise ValueError(
                    f"line {lineno}: price {row[2]!r} is not a number")
            if not np.isfinite(price) or not price > 0:
                raise ValueError(
                    f"line {lineno}: non-positive or non-finite price "
                    f"{price!r} for {config_id!r}")
            batch = batches.setdefault(tick, [])
            if any(d.config_id == config_id for d in batch):
                # two quotes for one config in one tick are ambiguous —
                # which is "the" price of the epoch depends on
                # application order, which replay must not guess
                raise ValueError(
                    f"line {lineno}: duplicate quote for {config_id!r} "
                    f"at tick {tick}")
            batch.append(PriceDelta(config_id, price))
        return cls(batches, ticks=ticks)

    @classmethod
    def load(cls, path: str) -> "RecordedPriceFeed":
        with open(path) as f:
            return cls.loads(f.read())


def record_feed(feed: PriceFeed, ticks: int, path: Optional[str] = None,
                start: int = 0) -> str:
    """Drive ``feed.poll`` for ``ticks`` ticks, capturing every batch as
    recorded-feed CSV; returns the text (and writes ``path`` if given).

    Prices are serialized with ``repr`` and config ids as JSON, so
    ``RecordedPriceFeed.loads(record_feed(feed, n))`` replays the exact
    batches (same floats, same ordering), and re-recording a recording
    reproduces the bytes.
    """
    buf = io.StringIO()
    # the header records the *horizon* (last tick + 1), not the batch
    # count, so recordings that start mid-stream stay loadable
    buf.write(f"# {FEED_FORMAT} v{FEED_VERSION} ticks={start + ticks}\n")
    writer = csv.writer(buf, lineterminator="\n")
    writer.writerow(_CSV_COLUMNS)
    for t in range(start, start + ticks):
        for d in feed.poll(t):
            _check_price(d, t)
            writer.writerow([t, json.dumps(d.config_id),
                             repr(float(d.price))])
    text = buf.getvalue()
    if path is not None:
        with open(path, "w") as f:
            f.write(text)
    return text


# --- journal replay --------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReplayedDecision:
    """One journaled decision with its reconstructed price epoch."""

    seq: int
    job_id: Hashable
    job_class: Optional[JobClass]
    config_id: Hashable
    hourly_cost: float
    score: float
    price_epoch: int
    exclude_groups: Tuple[str, ...]
    #: the full ``{config_id: $/h}`` quote state at this decision
    #: (shared between decisions of the same epoch).
    prices: Mapping[Hashable, float]
    #: how the daemon served the decision's ranking: ``"ranking"`` (the
    #: default — full materialized list, and what journals without the
    #: additive field mean) or ``"top_k"`` (device-side head serving,
    #: DESIGN.md §10).  The audit treats both identically: a journaled
    #: decision carries exactly the winner/score/$-per-hour fields either
    #: way, and those are what the cold re-rank is held against.
    served_via: str = "ranking"
    #: additive front-end provenance (DESIGN.md §8/§11): the serving
    #: shard (0 = the tick thread's control path, 1..N = snapshot
    #: workers) and the tick of the snapshot the decision was served
    #: off.  ``None`` for single-threaded daemon journals — the audit
    #: ignores both either way (the stamped price epoch is what the
    #: cold re-rank is pinned to).
    worker: Optional[int] = None
    snapshot_tick: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ReplayMismatch:
    """One field where the journal and the cold recompute disagree."""

    seq: int
    job_id: Hashable
    field: str
    journaled: Any
    replayed: Any


@dataclasses.dataclass(frozen=True)
class ReplayAudit:
    """Outcome of one :meth:`JournalReplayer.audit` pass.

    ``mismatches`` are contract violations (the audit failed);
    ``drift`` surfaces within-contract float32 divergence when auditing
    in tolerance mode — journaled scores that differ from the cold
    float64 value by accumulated delta-update ulps (field
    ``"score-drift"``, typically handoff-row renormalization), and
    near-tie winner swaps the contract accepts (field ``"winner-tie"``).
    Drift never fails the audit; it is the visibility the float32
    contract owes its consumers (DESIGN.md §9).
    """

    decisions: int
    ticks: int
    rejected: int
    mismatches: Tuple[ReplayMismatch, ...]
    #: within-contract divergences (tolerance mode only; empty for numpy)
    drift: Tuple[ReplayMismatch, ...] = ()
    #: the contract the audit ran under (None = pre-contract caller)
    contract: Optional[ScoreContract] = None
    #: ``feed-error`` records walked past (additive kind, DESIGN.md §8):
    #: ticks whose poll raised and was retried — prices never moved, so
    #: they are provenance, not a failure condition.
    feed_errors: int = 0
    #: ``metrics`` records walked past (additive kind, DESIGN.md §8/§12):
    #: periodic cumulative telemetry exports.  Like feed errors they are
    #: provenance, not selections — only their stamped price epoch is
    #: verified against the reconstructed one.
    metrics_records: int = 0
    #: tick latency recovered from the journal alone: ``{"p50": s,
    #: "p99": s, "count": n}`` from the *last* ``metrics`` record's
    #: cumulative ``tick.total`` histogram (records are cumulative, so
    #: the last one covers the whole run).  ``None`` when the journal
    #: carries no metrics records or no tick spans were observed.
    tick_latency: Optional[Mapping[str, float]] = None

    @property
    def ok(self) -> bool:
        return not self.mismatches


class JournalReplayer:
    """Re-reads a v2 decision journal against the profiling store.

    The journal is self-contained on the *price* side (header snapshot +
    per-tick deltas); the runtime side comes from ``store``, which must
    hold the same trace the daemon served from — that is the point: the
    audit detects *any* divergence between what the daemon journaled and
    what a cold ranking at the reconstructed epoch says, whether the
    cause is an incremental-reprice bug, an out-of-band price mutation
    the journal never saw, or a drifted trace.
    """

    def __init__(self, store: ProfilingStore,
                 journal: Union[str, Tuple[Dict[str, Any],
                                           List[Dict[str, Any]]]]):
        if isinstance(journal, str):
            header, records = SelectionDaemon.loads_journal(journal)
        else:
            header, records = journal
        if "prices" not in header:
            raise ValueError("journal header has no price snapshot "
                             "(pre-v2 journal?)")
        self.store = store
        self.header = header
        self.records = list(records)
        self.catalog_ids: List[Hashable] = list(header["catalog"])
        #: ranking backend the daemon served with (stamped in the header
        #: since the float32 backends landed; older v2 journals read as
        #: numpy — they could only have been written by the numpy path).
        self.backend: str = header.get("backend", "numpy")

    @classmethod
    def load(cls, store: ProfilingStore, path: str) -> "JournalReplayer":
        return cls(store, SelectionDaemon.load_journal(path))

    # -- price-state reconstruction -----------------------------------------
    def walk(self) -> Iterator[Tuple[Dict[str, Any], int,
                                     Mapping[Hashable, float]]]:
        """Yield ``(record, epoch, prices)`` with the price state *after*
        applying the record (ticks mutate it; everything else reads it).
        A fresh mapping is created per tick, so yielded snapshots stay
        valid after the walk moves on."""
        epoch = int(self.header.get("price_epoch", 0))
        prices: Dict[Hashable, float] = {c: float(p)
                                         for c, p in self.header["prices"]}
        for rec in self.records:
            if rec.get("kind") == "tick":
                prices = dict(prices)
                for config_id, price in rec["applied"]:
                    prices[config_id] = float(price)
                epoch += 1
            yield rec, epoch, prices

    def decisions(self) -> List[ReplayedDecision]:
        out = []
        for rec, epoch, prices in self.walk():
            if rec.get("kind") != "decision":
                continue
            klass = JobClass(rec["job_class"]) if rec.get("job_class") \
                else None
            out.append(ReplayedDecision(
                seq=rec["seq"], job_id=rec["job"], job_class=klass,
                config_id=rec["config"], hourly_cost=rec["hourly_cost"],
                score=rec["score"], price_epoch=rec["price_epoch"],
                exclude_groups=tuple(rec.get("exclude_groups", ())),
                prices=prices,
                served_via=rec.get("served_via", "ranking"),
                worker=rec.get("worker"),
                snapshot_tick=rec.get("snapshot_tick")))
        return out

    # -- the consistency audit ----------------------------------------------
    def _rank_cold(self, job_class: Optional[JobClass],
                   exclude_groups: Sequence[str],
                   prices: Mapping[Hashable, float]):
        jobs = self.store.select_jobs(job_class=job_class,
                                      exclude_groups=exclude_groups)
        if not jobs:
            raise NothingRankableError("no test jobs to learn from")
        hours, mask = self.store.matrix(job_ids=jobs,
                                        config_ids=self.catalog_ids)
        vec = np.asarray([prices[c] for c in self.catalog_ids],
                         dtype=np.float64)
        return rank_dense(hours, mask, vec, self.catalog_ids, job_ids=jobs)

    def audit(self, contract: Optional[ScoreContract] = None
              ) -> ReplayAudit:
        """Verify every journaled selection against a cold
        :func:`rank_dense` (numpy/float64) at its reconstructed epoch,
        under the journal's :class:`~repro_torch.selector.ScoreContract`.

        ``contract`` defaults to the backend stamped in the journal
        header (``score_contract(self.backend)``):

        * **numpy** — bit-identical: the winning config id, its score,
          the stamped $/h against the reconstructed quote, and the
          stamped price epoch are compared with exact equality.  JSON
          floats round-trip through ``repr``, so one ulp of drift
          anywhere in the reprice path surfaces here.
        * **float32 backends** (``torch_fused`` here; the reference's
          ``jax`` family) — tolerance mode: the journaled winner must
          be the cold winner or tied with it within the contract, and
          the journaled score must be within rel/abs tolerance of
          that config's cold score.  Within-contract divergence —
          float32 delta-accumulation drift (handoff-row renormalization
          above all) and accepted near-tie winner swaps — is surfaced
          in :attr:`ReplayAudit.drift`, never silently absorbed.  The
          $/h and price-epoch comparisons stay exact: quotes flow
          through the float64 :class:`~repro_torch.selector.PriceTable` on
          every backend.

        Top-k-served decisions (``"served_via": "top_k"``, DESIGN.md
        §10) audit through the same path with no special casing: the
        journal record carries exactly the winner/score/$-per-hour
        fields regardless of how much ranking tail the daemon
        materialized, so the comparison against the cold re-rank is
        unchanged.

        Rejections are audited identically in both modes: a journaled
        rejection whose (class, exclusions) re-ranks cold to a *valid*
        winner means the daemon silently served nothing for a rankable
        job — that is a mismatch, not bookkeeping.

        Decisions between the same two ticks with the same
        (class, exclusions) share identical rank inputs, so the cold
        ranking is memoized per ``(epoch, class, exclusions)`` — the
        audit costs O(epochs x distinct selections), not O(decisions).
        """
        if contract is None:
            contract = score_contract(self.backend)
        n_dec = n_tick = n_rej = n_feed = n_met = 0
        last_metrics: Optional[Dict[str, Any]] = None
        mismatches: List[ReplayMismatch] = []
        drift: List[ReplayMismatch] = []
        rank_memo: Dict[Tuple, Any] = {}

        def differ(seq, job, field, journaled, replayed):
            mismatches.append(ReplayMismatch(seq, job, field, journaled,
                                             replayed))

        def ranked_at(rec, epoch, prices):
            """Memoized cold ranking (None when nothing is rankable)."""
            klass = JobClass(rec["job_class"]) if rec.get("job_class") \
                else None
            excl = tuple(rec.get("exclude_groups", ()))
            key = (epoch, klass, excl)
            if key in rank_memo:
                return rank_memo[key]
            try:
                ranking = self._rank_cold(klass, excl, prices)
            except NothingRankableError:
                ranking = None
            if ranking is not None and \
                    ranking[0].score == float("inf"):
                ranking = None
            rank_memo[key] = ranking
            return ranking

        for rec, epoch, prices in self.walk():
            kind = rec.get("kind")
            if kind == "tick":
                n_tick += 1
                if rec["price_epoch"] != epoch:
                    differ(rec["seq"], None, "price_epoch",
                           rec["price_epoch"], epoch)
                continue
            if kind == "feed-error":
                # additive kind: a poll that raised and was retried —
                # no price movement, nothing to verify beyond the epoch
                n_feed += 1
                if rec["price_epoch"] != epoch:
                    differ(rec["seq"], None, "price_epoch",
                           rec["price_epoch"], epoch)
                continue
            if kind == "metrics":
                # additive kind: cumulative telemetry export — verify
                # the stamped epoch and keep the last record, whose
                # cumulative tick.total histogram covers the whole run
                n_met += 1
                if rec["price_epoch"] != epoch:
                    differ(rec["seq"], None, "price_epoch",
                           rec["price_epoch"], epoch)
                last_metrics = rec
                continue
            seq, job = rec.get("seq"), rec.get("job")
            if kind == "rejected":
                n_rej += 1
                if rec["price_epoch"] != epoch:
                    differ(seq, job, "price_epoch", rec["price_epoch"],
                           epoch)
                ranking = ranked_at(rec, epoch, prices)
                if ranking is not None:
                    differ(seq, job, "rejected", None,
                           ranking[0].config_id)
                continue
            if kind != "decision":
                continue
            n_dec += 1
            if rec["price_epoch"] != epoch:
                differ(seq, job, "price_epoch", rec["price_epoch"], epoch)
            ranking = ranked_at(rec, epoch, prices)
            if ranking is None:
                differ(seq, job, "rankable", rec["config"], None)
                continue
            winner = ranking[0]
            if not contract.winner_matches(rec["config"], ranking):
                differ(seq, job, "config", rec["config"],
                       winner.config_id)
            else:
                # the cold score the journaled score answers to: the
                # journaled config's own (identical to the winner's
                # except on an accepted near-tie swap)
                cold = winner if rec["config"] == winner.config_id else \
                    next(r for r in ranking
                         if r.config_id == rec["config"])
                if cold is not winner:
                    drift.append(ReplayMismatch(
                        seq, job, "winner-tie", rec["config"],
                        winner.config_id))
                if not contract.scores_match(rec["score"], cold.score):
                    differ(seq, job, "score", rec["score"], cold.score)
                elif rec["score"] != cold.score:
                    drift.append(ReplayMismatch(
                        seq, job, "score-drift", rec["score"],
                        cold.score))
            quote = prices.get(rec["config"])
            if rec["hourly_cost"] != quote:
                differ(seq, job, "hourly_cost", rec["hourly_cost"], quote)
        tick_latency = None
        if last_metrics is not None:
            h = last_metrics.get("histograms", {}).get(TICK_SPAN)
            if h and h.get("count"):
                tick_latency = {
                    "p50": histogram_quantile(h["le"], h["counts"], 0.50),
                    "p99": histogram_quantile(h["le"], h["counts"], 0.99),
                    "count": int(h["count"]),
                }
        return ReplayAudit(decisions=n_dec, ticks=n_tick, rejected=n_rej,
                           mismatches=tuple(mismatches),
                           drift=tuple(drift), contract=contract,
                           feed_errors=n_feed, metrics_records=n_met,
                           tick_latency=tick_latency)

    # -- dynamic-price evaluation -------------------------------------------
    def evaluate(self, base_prices: Optional[Mapping[Hashable, float]]
                 = None):
        """Score the journaled history against per-epoch and static-price
        oracles; see :func:`repro_torch.core.evaluate.dynamic_evaluation`.

        ``base_prices`` defaults to the header snapshot (the static
        oracle then models a selector that never saw a price move).
        """
        from repro_torch.core.evaluate import dynamic_evaluation
        if base_prices is None:
            base_prices = {c: float(p) for c, p in self.header["prices"]}
        return dynamic_evaluation(self.store, self.decisions(),
                                  self.catalog_ids, base_prices,
                                  backend=self.backend)
