"""The port's serving front-end against the reference package.

The reference front-end's cases run on the port (``numpy``, and the
``torch_fused`` fleet at ``device="cpu"``, where the kernels' plain
PyTorch versions stand in for the CUDA launches).  On numpy the port
writes the reference's golden front-end journal byte for byte; on
``torch_fused`` an inline interleave is held, decision by decision,
against the reference front-end on ``jax_batched`` under the float32
score contract, and both packages' replayers pass its journal.

The snapshot build asks the service for every selection's head at once
(``SelectionService.rank_heads``): it must equal per-selection
``rank_head`` calls exactly (heads, rejections, caches, hit/miss counts)
and cost one k-head call per snapshot on the fleet backend.
"""
import json
import os
import threading
import time

import numpy as np
import pytest

from repro.core.trace import JobClass as RefJobClass
from repro.market import JournalReplayer as RefReplayer
from repro.market import RecordedPriceFeed as RefRecorded
from repro.market import ServeFrontend as RefFrontend
from repro.market import SimulatedSpotFeed as RefSim
from repro.market import Submission as RefSubmission
from repro.market import record_feed as ref_record_feed
from repro.selector import BatchedRankState as RefFleet
from repro.selector import IdentityCatalog as RefCatalog
from repro.selector import PriceTable as RefTable
from repro.selector import ProfilingStore as RefStore
from repro.selector import SelectionService as RefService
from repro.selector import score_contract as ref_contract
from repro_torch.core.trace import JobClass
from repro_torch.kernels import rank_delta as rd
from repro_torch.market import (JournalReplayer, MarketEvent, PriceDelta,
                                RecordedPriceFeed, SelectionDaemon,
                                ServeFrontend, SimulatedSpotFeed, Submission,
                                merge_shards, record_feed)
from repro_torch.selector import (IdentityCatalog, NothingRankableError,
                                  PriceTable, ProfilingStore,
                                  SelectionService, TorchFusedRankState,
                                  score_contract)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
GOLDEN_FRONTEND = os.path.join(
    FIXTURES, "decision_journal_v2_frontend.golden.jsonl")
N_WORKERS = 2
CONTRACT = score_contract("torch_fused")


# --- shared universe (the reference front-end tests' own) ----------------------

def _universe(store_cls=ProfilingStore, klass_cls=JobClass):
    """6 jobs (classes A/B, groups g0-g2) x 8 configs, fully profiled."""
    ids = [f"c{i}" for i in range(8)]
    store = store_cls(config_ids=ids)
    for j in range(6):
        klass = klass_cls.A if j % 2 else klass_cls.B
        for i, c in enumerate(ids):
            store.add(f"j{j}", c, 0.2 + ((j * 5 + i * 3) % 13) / 4.0,
                      job_class=klass, group=f"g{j % 3}")
    base = {c: 1.0 + i for i, c in enumerate(ids)}
    return store, ids, base


def _recorded(base, n_ticks=12, seed=9):
    sim = SimulatedSpotFeed(base, seed=seed, change_fraction=0.5)
    return RecordedPriceFeed.loads(record_feed(sim, n_ticks))


def _service(store, ids, base, backend="numpy", **kw):
    if backend == "torch_fused":
        kw.setdefault("device", "cpu")
    return SelectionService(IdentityCatalog(ids), store, PriceTable(base),
                            backend=backend, **kw)


def _frontend(backend="numpy", n_ticks=12, feed=None, **kw):
    store, ids, base = _universe()
    if feed is None:
        feed = _recorded(base, n_ticks=n_ticks)
    svc = _service(store, ids, base, backend,
                   serve_top_k=kw.pop("serve_top_k", None))
    return ServeFrontend(svc, feed, **kw), store


UNRANKABLE = Submission("j1", exclude_groups=("g0", "g1", "g2"))


class _FlakyFeed:
    """Recorded feed whose poll raises ``times`` times at each tick in
    ``fail_ticks``."""

    def __init__(self, inner, fail_ticks, times=2):
        self.inner = inner
        self.ticks = inner.ticks
        self._remaining = {t: times for t in fail_ticks}

    def config_ids(self):
        return self.inner.config_ids()

    def poll(self, tick):
        if self._remaining.get(tick, 0) > 0:
            self._remaining[tick] -= 1
            raise ConnectionError(f"transient market outage at {tick}")
        return self.inner.poll(tick)


# --- the golden journal ------------------------------------------------------------

def golden_frontend(backend="numpy"):
    store, ids, base = _universe()
    feed = _FlakyFeed(_recorded(base, n_ticks=5), fail_ticks=(2,), times=1)
    return ServeFrontend(_service(store, ids, base, backend), feed,
                         workers=2, top_k=2), store


def run_golden(fe):
    """The reference golden's interleave: worker decisions, a worker-served
    rejection, a forwarded decision and a transient feed failure."""
    fe.warm([Submission("j1"), Submission("j2"), UNRANKABLE])
    fe.submit(Submission("j1"))
    fe.submit("j2")                      # bare job ids wrap to Submissions
    fe.step_tick()
    fe.serve_queued()
    fe.submit(UNRANKABLE)
    fe.submit(Submission("j3"))          # unwarmed: forwarded
    fe.step_tick()
    fe.serve_queued()
    assert fe.step_tick() == "feed-error"
    assert fe.step_tick() == "tick"
    fe.submit(Submission("j1"))
    fe.step_tick()
    fe.serve_queued()
    fe.step_tick()
    return fe.close()


def test_port_numpy_frontend_regenerates_reference_golden():
    """The port's numpy front-end writes the reference's pinned journal
    byte for byte: record shapes, worker/snapshot stamps, the feed-error
    record and the (tick, worker, seq) merge order."""
    fe, _ = golden_frontend()
    stats = run_golden(fe)
    assert stats.accounted and stats.feed_errors == 1
    with open(GOLDEN_FRONTEND) as f:
        assert fe.journal_dump() == f.read()


@pytest.mark.parametrize("backend", ["numpy", "torch_fused"])
def test_inline_run_is_deterministic_and_audit_clean(backend):
    fe1, store = golden_frontend(backend)
    stats = run_golden(fe1)
    fe2, _ = golden_frontend(backend)
    run_golden(fe2)
    assert fe1.journal_dump() == fe2.journal_dump()
    assert stats.decisions == 4 and stats.rejected == 1
    assert stats.forwarded == 1 and stats.shed == 0
    assert stats.ticks == 5 and stats.snapshots > 0
    replayer = JournalReplayer(store, fe1.journal_dump())
    assert replayer.backend == backend
    audit = replayer.audit()
    assert audit.ok, audit.mismatches[:5]
    assert audit.decisions == stats.decisions
    assert audit.rejected == stats.rejected
    assert audit.feed_errors == stats.feed_errors == 1
    assert audit.contract.bit_identical == (backend == "numpy")
    decisions = replayer.decisions()
    assert any(d.worker and d.worker > 0 for d in decisions)
    assert any(d.worker == 0 for d in decisions)


def test_merged_journal_parses_as_v2():
    fe, _ = golden_frontend()
    run_golden(fe)
    header, records = SelectionDaemon.loads_journal(fe.journal_dump())
    assert header["backend"] == "numpy"
    kinds = [r["kind"] for r in records]
    assert {"tick", "decision", "rejected", "feed-error"} <= set(kinds)
    assert [r["seq"] for r in records] == list(range(1, len(records) + 1))
    for r in records:
        assert "worker" in r
        assert ("snapshot_tick" in r) == (r["kind"] in ("decision",
                                                        "rejected"))
        assert ("tick" in r) == (r["kind"] in ("tick", "feed-error",
                                               "metrics"))


# --- merge_shards ------------------------------------------------------------------

def test_merge_shards_total_order_and_seq():
    header = '{"format": "test-header"}'
    tick0 = {"kind": "tick", "seq": 0, "worker": 0, "tick": 0}
    tick1 = {"kind": "tick", "seq": 0, "worker": 0, "tick": 1}
    d_w1_t0 = {"kind": "decision", "seq": 0, "worker": 1,
               "snapshot_tick": 0, "job": "a"}
    d_w1_t1 = {"kind": "decision", "seq": 0, "worker": 1,
               "snapshot_tick": 1, "job": "b"}
    d_w2_t0 = {"kind": "decision", "seq": 0, "worker": 2,
               "snapshot_tick": 0, "job": "c"}
    shards = [[tick0, tick1], [d_w1_t0, d_w1_t1], [d_w2_t0]]
    merged = merge_shards(header, shards)
    lines = merged.splitlines()
    assert lines[0] == header
    recs = [json.loads(ln) for ln in lines[1:]]
    assert [r["seq"] for r in recs] == [1, 2, 3, 4, 5]
    assert [(r["kind"], r["worker"]) for r in recs] == [
        ("tick", 0), ("decision", 1), ("decision", 2),
        ("tick", 0), ("decision", 1)]
    assert merge_shards(header, list(reversed(shards))) == merged
    assert tick0["seq"] == 0


def test_merge_shards_tolerates_degenerate_shards():
    header = '{"format": "test-header"}'
    tick0 = {"kind": "tick", "seq": 0, "worker": 0, "tick": 0}
    d_w2_t0 = {"kind": "decision", "seq": 0, "worker": 2,
               "snapshot_tick": 0, "job": "a"}
    busy = [[tick0], [d_w2_t0]]
    merged = merge_shards(header, busy)
    assert merge_shards(header, [[], *busy]) == merged
    assert merge_shards(header, [[tick0], [], [d_w2_t0], []]) == merged
    recs = [json.loads(ln) for ln in merged.splitlines()[1:]]
    assert [r["seq"] for r in recs] == [1, 2]
    assert merge_shards(header, [[], [], []]) == header + "\n"
    assert merge_shards(header, []) == header + "\n"


def test_zero_record_worker_shard_still_audits_clean():
    fe, store = _frontend(workers=2, queue_capacity=1, n_ticks=4)
    assert fe.step_tick() == "tick"
    assert fe.submit(Submission("j1"))
    assert fe.submit(Submission("j2"))
    assert fe.submit(Submission("j1")) is False
    assert fe.submit(Submission("j2")) is False
    fe.serve_queued()
    fe.step_tick()
    stats = fe.close()
    assert stats.forwarded == 2 and stats.decisions == 2
    assert stats.shed == 2 and stats.accounted
    _, records = SelectionDaemon.loads_journal(fe.journal_dump())
    served = [r for r in records if r["kind"] in ("decision", "rejected")]
    assert len(served) == 2
    assert all(r["worker"] == 0 for r in records)
    assert [r["seq"] for r in records] == list(range(1, len(records) + 1))
    audit = JournalReplayer(store, fe.journal_dump()).audit()
    assert audit.ok, audit.mismatches[:5]
    assert audit.decisions == 2


# --- parameters, close, backoff ----------------------------------------------------

@pytest.mark.parametrize("kw", [
    {"workers": 0}, {"workers": -1}, {"workers": True},
    {"queue_capacity": 0}, {"top_k": 0}, {"top_k": True},
    {"metrics_every": 0}, {"span_sample": 0},
])
def test_frontend_rejects_bad_params(kw):
    store, ids, base = _universe()
    with pytest.raises(ValueError):
        ServeFrontend(_service(store, ids, base), _recorded(base), **kw)


def test_submit_after_close_is_shed():
    fe, _ = _frontend(workers=1)
    fe.submit(Submission("j1"))
    fe.close()
    assert fe.submit(Submission("j2")) is False
    stats = fe.stats()
    assert stats.shed == 1 and stats.submitted == 1 and stats.accounted


def test_close_refuses_started_frontend():
    fe, _ = _frontend(workers=1)
    fe.start()
    try:
        with pytest.raises(RuntimeError, match="shutdown"):
            fe.close()
    finally:
        fe.shutdown()


def test_backoff_delay_is_capped_exponential():
    fe, _ = _frontend(backoff_base=0.01, backoff_cap=0.5)
    assert fe.backoff_delay(1) == pytest.approx(0.01)
    assert fe.backoff_delay(2) == pytest.approx(0.02)
    assert fe.backoff_delay(4) == pytest.approx(0.08)
    assert fe.backoff_delay(50) == 0.5


# --- threads: bursts, flaky feeds, thread deaths ------------------------------------

@pytest.mark.parametrize("backend", ["numpy", "torch_fused"])
def test_burst_ten_x_capacity_sheds_drains_and_accounts(backend):
    capacity = 4
    fe, store = _frontend(backend, workers=2, queue_capacity=capacity,
                          on_decision=lambda d: time.sleep(0.002))
    fe.warm([Submission("j1"), Submission("j2")])
    burst = [Submission("j1" if i % 2 else "j2")
             for i in range(10 * 2 * capacity)]
    accepted = []
    with fe:
        def produce(subs):
            accepted.append(sum(fe.submit(s) for s in subs))

        producers = [threading.Thread(target=produce, args=(burst[i::2],))
                     for i in range(2)]
        for t in producers:
            t.start()
        for t in producers:
            t.join()
        fe.drain(timeout=30.0)
        fe.await_ticks(timeout=30.0)
    stats = fe.stats()
    assert stats.submitted == sum(accepted)
    assert stats.submitted + stats.shed == len(burst)
    assert stats.shed > 0 and stats.submitted > 0
    assert stats.accounted and stats.rejected == 0
    _, records = SelectionDaemon.loads_journal(fe.journal_dump())
    served = [r for r in records if r["kind"] in ("decision", "rejected")]
    assert len(served) == stats.submitted
    audit = JournalReplayer(store, fe.journal_dump()).audit()
    assert audit.ok, audit.mismatches[:5]
    assert audit.decisions == stats.decisions


@pytest.mark.parametrize("backend", ["numpy", "torch_fused"])
def test_threaded_flaky_feed_keeps_serving_and_audits(backend):
    store, ids, base = _universe()
    feed = _FlakyFeed(_recorded(base, n_ticks=12), fail_ticks=(3, 7),
                      times=2)
    fe = ServeFrontend(_service(store, ids, base, backend), feed,
                       workers=N_WORKERS, backoff_base=0.001,
                       backoff_cap=0.01)
    fe.warm([Submission("j1"), Submission("j2")])
    with fe:
        for i in range(30):
            assert fe.submit(Submission("j1" if i % 2 else "j2"))
            time.sleep(0.001)
        fe.await_ticks(timeout=30.0)
        fe.drain(timeout=30.0)
    stats = fe.stats()
    assert stats.ticks == 12 and stats.feed_errors == 4
    assert stats.accounted and stats.decisions == 30
    audit = JournalReplayer(store, fe.journal_dump()).audit()
    assert audit.ok, audit.mismatches[:5]
    assert audit.feed_errors == 4 and audit.decisions == 30


def test_thread_death_is_raised_by_shutdown():
    """An exception on the tick thread is kept and raised by
    ``shutdown``; it is never swallowed."""
    store, ids, base = _universe()

    class _Broken:
        """Polls fine, but quotes a config the catalog does not hold:
        ``reprice`` raises on the tick thread (misconfiguration, not a
        feed error)."""
        ticks = 3

        def poll(self, tick):
            return (PriceDelta("nowhere", 1.0),)

    fe = ServeFrontend(_service(store, ids, base), _Broken(), workers=1)
    fe.start()
    fe._tick_thread.join(timeout=30.0)
    with pytest.raises(RuntimeError, match="serving thread 0 died"):
        fe.shutdown()


def test_feed_error_backoff_state_resets_on_good_tick():
    store, ids, base = _universe()
    feed = _FlakyFeed(_recorded(base, n_ticks=4), fail_ticks=(1,), times=3)
    svc = _service(store, ids, base)
    fe = ServeFrontend(svc, feed, workers=1, backoff_base=0.01)
    assert fe.step_tick() == "tick"
    epoch_before = svc.price_epoch
    delays = []
    while fe.step_tick() == "feed-error":
        delays.append(fe.backoff_delay())
        assert svc.price_epoch == epoch_before
    assert delays == [pytest.approx(0.01), pytest.approx(0.02),
                      pytest.approx(0.04)]
    assert fe.backoff_delay() == pytest.approx(0.01)
    assert fe.ticker.tick_count == 2
    fe.close()


def test_feed_error_failures_reset_across_fail_recover_fail():
    store, ids, base = _universe()
    feed = _FlakyFeed(_recorded(base, n_ticks=5), fail_ticks=(1, 3),
                      times=2)
    fe = ServeFrontend(_service(store, ids, base), feed, workers=1,
                       backoff_base=0.01)
    statuses = []
    while fe.ticker.tick_count < 5:
        statuses.append(fe.step_tick())
        if statuses[-1] == "tick":
            assert fe.backoff_delay() == pytest.approx(0.01)
    assert statuses.count("feed-error") == 4
    assert statuses.count("tick") == 5
    fe.close()
    records = [json.loads(ln) for ln in fe.journal_dump().splitlines()[1:]]
    errs = [r for r in records if r["kind"] == "feed-error"]
    assert [e["failures"] for e in errs] == [1, 2, 1, 2]
    assert [e["tick"] for e in errs] == [1, 1, 3, 3]
    audit = JournalReplayer(store, fe.journal_dump()).audit()
    assert audit.ok and audit.feed_errors == 4


# --- retirement, rejections ----------------------------------------------------------

@pytest.mark.parametrize("backend", ["numpy", "torch_fused"])
def test_retired_selection_revives_through_control_path(backend):
    fe, store = _frontend(backend, workers=1, n_ticks=6)
    fe.warm([Submission("j1")])
    fe.submit(Submission("j1"))
    fe.step_tick()
    fe.serve_queued()
    assert (JobClass.A, ("g1",)) in fe.snapshot.entries
    fe.retire_selection(JobClass.A, ("g1",))
    fe.step_tick()
    assert (JobClass.A, ("g1",)) not in fe.snapshot.entries
    fe.submit(Submission("j1"))
    fe.serve_queued()
    fe.step_tick()
    assert (JobClass.A, ("g1",)) in fe.snapshot.entries
    fe.submit(Submission("j1"))
    fe.serve_queued()
    stats = fe.close()
    assert stats.decisions == 3 and stats.rejected == 0
    assert stats.forwarded == 1
    audit = JournalReplayer(store, fe.journal_dump()).audit()
    assert audit.ok, audit.mismatches[:5]


def test_service_retire_selection_drops_caches_and_reports():
    store, ids, base = _universe()
    svc = _service(store, ids, base)
    svc.submit("j1")
    svc.submit("j1")
    assert svc.cache_misses == 1 and svc.cache_hits == 1
    assert svc.retire_selection(JobClass.A, ("g1",)) is True
    assert svc.retire_selection(JobClass.A, ("g1",)) is False
    svc.submit("j1")
    assert svc.cache_misses == 2


def test_fleet_retired_member_raises_typed_not_raw():
    store, ids, base = _universe()
    svc = _service(store, ids, base, "torch_fused")
    d1 = svc.submit("j1")
    base_key = (store.version, JobClass.A, ("g1",))
    assert svc._batched is not None and base_key in svc._batched
    assert svc.retire_selection(JobClass.A, ("g1",)) is True
    for serve in (lambda: svc._batched.ranking(base_key),
                  lambda: svc._batched.top_k(base_key, 1),
                  lambda: svc._batched.heads([base_key], 1)):
        with pytest.raises(NothingRankableError, match="retired"):
            serve()
    d2 = svc.submit("j1")
    assert d2.config_id == d1.config_id


@pytest.mark.parametrize("backend", ["numpy", "torch_fused"])
def test_unrankable_selection_serves_snapshot_rejections(backend):
    fe, store = _frontend(backend, workers=1, n_ticks=4)
    fe.warm([UNRANKABLE])
    route = (JobClass.A, ("g0", "g1", "g2"))
    assert fe.snapshot.entries[route].head is None
    fe.submit(UNRANKABLE)
    fe.step_tick()
    fe.serve_queued()
    stats = fe.close()
    assert stats.rejected == 1 and stats.decisions == 0
    assert stats.forwarded == 0
    audit = JournalReplayer(store, fe.journal_dump()).audit()
    assert audit.ok and audit.rejected == 1


# --- seeded interleaves ----------------------------------------------------------------

def _event_market(seed):
    """A seeded universe and event-bearing market (numpy draws)."""
    rng = np.random.default_rng(seed)
    n_cfgs = int(rng.integers(2, 6))
    cfgs = [f"c{i}" for i in range(n_cfgs)]
    base = {c: float(rng.uniform(0.5, 20.0)) for c in cfgs}
    n_ticks = int(rng.integers(2, 11))
    regions = ("us-central1", "europe-west3", "asia-east1")
    events = [MarketEvent(str(rng.choice(regions)),
                          start_tick=int(rng.integers(0, n_ticks)),
                          duration=int(rng.integers(1, n_ticks + 1)),
                          factor=float(rng.choice([0.25, 0.5, 2.0, 4.0])),
                          kind=str(rng.choice(["discount", "eviction"])))
              for _ in range(int(rng.integers(1, 4)))]
    jobs = [f"j{i}" for i in range(int(rng.integers(2, 5)))]
    rt = {(j, c): float(rng.uniform(0.01, 100.0)) for j in jobs
          for c in cfgs}
    program = [int(x) for x in rng.integers(0, 8, int(rng.integers(5, 41)))]
    return cfgs, base, events, n_ticks, jobs, rt, program, float(
        rng.uniform(0.0, 1.0))


@pytest.mark.parametrize("backend", ["numpy", "torch_fused"])
@pytest.mark.parametrize("seed", range(6))
def test_seeded_interleave_audits_clean(seed, backend):
    """Any interleave of ticks, worker serves and submissions over an
    event-bearing market: every decision re-ranks cold to the same
    answer at its stamped epoch (numpy bit-identical, torch_fused within
    the contract), and every accepted submission is accounted."""
    cfgs, base, events, n_ticks, jobs, rt, program, cf = _event_market(seed)
    store = ProfilingStore(config_ids=cfgs)
    for idx, j in enumerate(jobs):
        for c in cfgs:
            store.add(j, c, rt[(j, c)],
                      job_class=JobClass.A if idx % 2 else JobClass.B)
    feed = SimulatedSpotFeed(base, seed=seed, change_fraction=cf,
                             volatility=0.15, events=events)
    fe = ServeFrontend(_service(store, cfgs, base, backend), feed,
                       workers=2, ticks=n_ticks)
    for op in program:
        if op == 0:
            fe.step_tick()
        elif op == 1:
            fe.serve_queued()
        else:
            fe.submit(Submission(jobs[op % len(jobs)]))
    stats = fe.close()
    assert stats.accounted and stats.shed == 0
    audit = JournalReplayer(store, fe.journal_dump()).audit()
    assert audit.ok, audit.mismatches[:3]
    assert audit.decisions == stats.decisions


# --- the threaded soak -----------------------------------------------------------------

SOAK_SELECTIONS = [("j1", None), ("j2", None), ("j3", None), ("j4", None),
                   ("j1", ("g2", "g3")), ("j2", ("g1",))]


def _soak(n_ticks=220):
    ids = [f"c{i}" for i in range(16)]
    store = ProfilingStore(config_ids=ids)
    for j in range(12):
        klass = JobClass.A if j % 2 else JobClass.B
        for i, c in enumerate(ids):
            store.add(f"j{j}", c,
                      0.1 + ((j * 13 + i * 7) % 29) / 8.0
                      + (0.5 if klass is JobClass.A and i % 3 == 0
                         else 0.0),
                      job_class=klass, group=f"g{j % 4}")
    base = {c: 1.0 + (i * 11 % 17) for i, c in enumerate(ids)}
    sim = SimulatedSpotFeed(
        base, seed=42, change_fraction=0.5, volatility=0.08,
        events=[MarketEvent("us-central1", 40, 30, 0.5, "discount"),
                MarketEvent("europe-west3", 120, 20, 3.0, "eviction")])
    return store, ids, base, RecordedPriceFeed.loads(record_feed(sim,
                                                                 n_ticks))


@pytest.mark.parametrize("backend", ["numpy", "torch_fused"])
def test_threaded_soak_recorded_market(backend):
    """N workers serve the six soak selections off live snapshots while
    the 220-tick recorded market plays out on the tick thread: zero shed,
    every submission accounted, the journal audit-clean, and the fleet
    backend one dispatch per price epoch."""
    store, ids, base, feed = _soak()
    svc = _service(store, ids, base, backend, serve_top_k=3)
    fe = ServeFrontend(svc, feed, workers=N_WORKERS, queue_capacity=512,
                       tick_interval=0.001)
    assert fe.warm([Submission(j, exclude_groups=e)
                    for j, e in SOAK_SELECTIONS]) == len(SOAK_SELECTIONS)
    n_subs = 150
    with fe:
        for i in range(n_subs):
            job, excl = SOAK_SELECTIONS[i % len(SOAK_SELECTIONS)]
            assert fe.submit(Submission(job, exclude_groups=excl))
            time.sleep(0.001)
        fe.await_ticks(timeout=60.0)
        fe.drain(timeout=30.0)
    stats = fe.stats()
    assert stats.ticks == 220 and stats.epochs >= 180
    assert stats.shed == 0 and stats.accounted
    assert stats.decisions == n_subs and stats.rejected == 0
    assert stats.forwarded == 0
    replayer = JournalReplayer(store, fe.journal_dump())
    assert replayer.backend == backend
    audit = replayer.audit()
    assert audit.ok, audit.mismatches[:5]
    assert audit.decisions == n_subs
    decisions = replayer.decisions()
    assert all(d.worker and d.worker > 0 for d in decisions)
    if backend == "torch_fused":
        assert svc._batched.n_active == len(SOAK_SELECTIONS)
        assert stats.epochs - 1 <= svc.reprice_dispatches <= stats.epochs
        assert all(d.served_via == "top_k" for d in decisions)


class _GatedFeed:
    """Recorded feed whose poll blocks until its tick is released."""

    def __init__(self, inner):
        self.inner = inner
        self.ticks = inner.ticks
        self._allowed = 0
        self._cv = threading.Condition()

    def config_ids(self):
        return self.inner.config_ids()

    def allow(self, upto):
        with self._cv:
            self._allowed = upto
            self._cv.notify_all()

    def poll(self, tick):
        with self._cv:
            assert self._cv.wait_for(lambda: self._allowed > tick,
                                     timeout=30.0)
        return self.inner.poll(tick)


def _wait_snapshot(fe, tick, timeout=30.0):
    deadline = time.monotonic() + timeout
    while fe.snapshot.tick < tick:
        if time.monotonic() > deadline:
            raise TimeoutError(f"snapshot never reached tick {tick}")
        time.sleep(0.001)


@pytest.mark.parametrize("backend", ["numpy", "torch_fused"])
def test_threaded_journal_equals_inline_journal_same_interleave(backend):
    n_ticks = 4

    def run(threaded):
        store, ids, base = _universe()
        sim = SimulatedSpotFeed(base, seed=9, change_fraction=1.0)
        gate = _GatedFeed(RecordedPriceFeed.loads(record_feed(sim,
                                                              n_ticks)))
        if not threaded:
            gate.allow(n_ticks)
        fe = ServeFrontend(_service(store, ids, base, backend), gate,
                           workers=2)
        fe.warm([Submission("j1"), Submission("j2")])
        if threaded:
            fe.start()
        for t in range(n_ticks):
            for s in ("j1", "j2", "j1"):
                fe.submit(Submission(s))
            if threaded:
                fe.drain(timeout=30.0)
                gate.allow(t + 1)
                _wait_snapshot(fe, t)
            else:
                fe.serve_queued()
                fe.step_tick()
        if threaded:
            fe.shutdown()
        else:
            fe.close()
        return fe.journal_dump()

    assert run(threaded=True) == run(threaded=False)


# --- against the reference front-end ---------------------------------------------------

def _interleave(fe, sub, jobs, rng_seed=5, rounds=12):
    """Ticks, worker serves and submissions in a seeded order."""
    rng = np.random.default_rng(rng_seed)
    fe.warm([sub(j) for j in jobs[:3]])
    for _ in range(rounds):
        for j in rng.choice(jobs, 3):
            fe.submit(sub(str(j), exclude_groups=None))
        fe.serve_queued()
        fe.step_tick()
    fe.submit(sub("j1", exclude_groups=("g0", "g1", "g2")))
    return fe.close()


def test_torch_fused_frontend_matches_reference_jax_batched():
    """The same market and interleave through the port's front-end on
    ``torch_fused`` and the reference's on ``jax_batched``: record by
    record the same kinds, ticks and routing; decision by decision the
    same job, class, exclusions and epoch with the winner equal or tied
    within the contract.  Both packages' replayers pass the journal."""
    jobs = ["j1", "j2", "j3", "j4", "j5"]
    store, ids, base = _universe()
    text = record_feed(SimulatedSpotFeed(base, seed=9, change_fraction=0.5),
                       12)
    fe = ServeFrontend(_service(store, ids, base, "torch_fused",
                                serve_top_k=3),
                       RecordedPriceFeed.loads(text), workers=2)
    stats = _interleave(fe, Submission, jobs)

    rstore, rids, rbase = _universe(RefStore, RefJobClass)
    assert ref_record_feed(RefSim(rbase, seed=9, change_fraction=0.5),
                           12) == text
    rsvc = RefService(RefCatalog(rids), rstore, RefTable(rbase),
                      backend="jax_batched", serve_top_k=3)
    rfe = RefFrontend(rsvc, RefRecorded.loads(text), workers=2)
    rstats = _interleave(rfe, RefSubmission, jobs)
    assert (stats.decisions, stats.rejected, stats.forwarded) == \
        (rstats.decisions, rstats.rejected, rstats.forwarded)

    ph, precs = SelectionDaemon.loads_journal(fe.journal_dump())
    rh, rrecs = SelectionDaemon.loads_journal(rfe.journal_dump())
    assert (ph["backend"], rh["backend"]) == ("torch_fused", "jax_batched")
    assert len(precs) == len(rrecs)
    n_dec = 0
    for p, r in zip(precs, rrecs):
        assert p["kind"] == r["kind"]
        if p["kind"] != "decision":
            assert p == r
            continue
        n_dec += 1
        for field in ("seq", "job", "job_class", "exclude_groups",
                      "price_epoch", "served_via", "worker",
                      "snapshot_tick"):
            assert p[field] == r[field], field
        # the same winner, or one tied with it within the contract (the
        # audits below hold each winner against a cold re-rank)
        assert CONTRACT.scores_match(p["score"], r["score"])
        if p["config"] == r["config"]:
            assert p["hourly_cost"] == r["hourly_cost"]
    assert n_dec == stats.decisions > 30
    audit = JournalReplayer(store, fe.journal_dump()).audit()
    assert audit.ok, audit.mismatches[:3]
    ref_audit = RefReplayer(RefStore.loads_jsonl(store.dump_jsonl()),
                            fe.journal_dump()).audit(
        contract=ref_contract("jax_batched"))
    assert ref_audit.ok, ref_audit.mismatches[:3]
    assert ref_audit.decisions == audit.decisions == stats.decisions


# --- rank_heads: one call for every route ------------------------------------------------

ROUTES = [(JobClass.A, ("g1",)), (JobClass.B, ("g2",)), (JobClass.A, ()),
          (JobClass.A, ("g0", "g1", "g2")), (None, ("g0",)),
          (JobClass.B, ("g2",))]


def _head_services(backend, partial):
    """Two services over one seeded, partly profiled universe."""
    rng = np.random.default_rng(11)
    ids = [f"c{i}" for i in range(12)]
    hours = rng.uniform(0.1, 5.0, (9, 12))
    keep = rng.random((9, 12)) >= partial
    keep[:, 0] = True

    def build():
        store = ProfilingStore(config_ids=ids)
        for j in range(9):
            for c in np.flatnonzero(keep[j]):
                store.add(f"j{j}", ids[c], float(hours[j, c]),
                          job_class=JobClass.A if j % 2 else JobClass.B,
                          group=f"g{j % 3}")
        prices = {c: float(p) for c, p in zip(ids,
                                              rng.uniform(1, 9, 12))}
        return _service(store, ids, prices, backend)

    state = rng.bit_generator.state
    one = build()
    rng.bit_generator.state = state
    return one, build(), ids


def _per_route(svc, routes, k):
    out = []
    for klass, excl in routes:
        try:
            out.append(svc.rank_head(klass, excl, k=k))
        except NothingRankableError as exc:
            out.append(exc)
    return out


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, NothingRankableError):
            assert isinstance(g, NothingRankableError)
            assert str(g) == str(w)
        else:
            assert g == w


@pytest.mark.parametrize("backend", ["numpy", "torch_fused"])
@pytest.mark.parametrize("k", [1, 3, 12])
def test_rank_heads_equals_per_route_rank_head(backend, k):
    """Cold, live and cached routes, a rejection and a repeated route:
    ``rank_heads`` returns what per-route ``rank_head`` calls return and
    leaves the same caches and hit/miss counts, tick after tick."""
    batch, single, ids = _head_services(backend, partial=0.3)
    rng = np.random.default_rng(2)
    for tick in range(4):
        routes = ROUTES[:3 + tick]
        _same(batch.rank_heads(routes, k=k), _per_route(single, routes, k))
        assert (batch.cache_hits, batch.cache_misses) == \
            (single.cache_hits, single.cache_misses)
        assert batch._head_cache == single._head_cache
        if tick == 2:
            batch.rank(JobClass.A, ("g1",))       # a full ranking cached
            single.rank(JobClass.A, ("g1",))
        deltas = {ids[c]: float(rng.uniform(1, 9))
                  for c in rng.choice(12, 4, replace=False)}
        batch.reprice(deltas)
        single.reprice(deltas)
    with pytest.raises(ValueError):
        batch.rank_heads(ROUTES, k=0)


def test_rank_heads_unprofiled_head_scores_inf():
    """A selection whose every catalog entry is unprofiled serves an
    ``inf`` head, exactly as ``rank_head`` does (the front-end turns it
    into a snapshot rejection)."""
    ids = ["a", "b", "ghost"]
    store = ProfilingStore(config_ids=ids)
    store.add("j0", "a", 1.0, job_class=JobClass.A, group="g0")
    store.add("j1", "b", 2.0, job_class=JobClass.B, group="g1")
    base = {"a": 1.0, "b": 2.0, "ghost": 3.0}
    svc = _service(store, ids, base, "torch_fused")
    other = _service(store, ids, base, "torch_fused")
    routes = [(JobClass.A, ()), (JobClass.B, ())]
    _same(svc.rank_heads(routes, k=3), _per_route(other, routes, 3))
    svc.reprice({"ghost": 2.5})
    other.reprice({"ghost": 2.5})
    got = svc.rank_heads(routes, k=3)
    _same(got, _per_route(other, routes, 3))
    assert got[0][0][-1].score == float("inf")


#: members asked for, by their position in slot order: contiguous slots
#: (a view), gaps, a repeat, and one member; ``retire`` frees a slot first
HEAD_PICKS = [([0, 1, 2], None), ([0, 2], None), ([3, 1, 3], None),
              ([2], None), ([0, 1, 2], 1), ([2, 0], 3)]


@pytest.mark.parametrize("pick,retire", HEAD_PICKS)
def test_fleet_heads_read_only_the_requested_rows(monkeypatch, pick,
                                                  retire):
    """``TorchFusedRankState.heads`` runs ONE k-head call over the
    requested members' rows alone (a gap is gathered, not spanned), and
    each head equals the reference fleet's ``top_k`` (``lax.top_k``):
    the same configs in the same order, scores within the contract."""
    rng = np.random.default_rng(len(pick) * 10 + (retire or 0))
    J, C, k = 10, 60, 7
    hours = rng.uniform(0.05, 10.0, (J, C))
    mask = rng.random((J, C)) > 0.25
    prices = rng.uniform(0.5, 20.0, C)
    ids = [f"c{i}" for i in range(C)]
    port = TorchFusedRankState(hours, mask, prices.copy(), ids,
                               device="cpu")
    ref = RefFleet(hours, mask, prices.copy(), ids)
    for m in range(5):
        rows = sorted(int(i) for i in rng.choice(J, 1 + m, replace=False))
        port.add_state(f"m{m}", rows=rows)
        ref.add_state(f"m{m}", rows=rows)
    cols = rng.choice(C, 12, replace=False)
    deltas = {ids[c]: float(p) for c, p in
              zip(cols, rng.uniform(0.5, 20.0, cols.size))}
    assert port.reprice(deltas) == ref.reprice(deltas)
    by_slot = sorted(port._slots, key=port._slots.get)
    if retire is not None:
        port.retire_state(by_slot.pop(retire))
    keys = [by_slot[i] for i in pick]
    calls = []
    plain = rd.select_heads_plain

    def counted(scores, finite, kk):
        calls.append(scores.shape[0])
        return plain(scores, finite, kk)

    monkeypatch.setattr(rd, "select_heads_plain", counted)
    got = port.heads(keys, k)
    assert calls == [len(set(keys))]
    for key, head in zip(keys, got):
        want = ref.top_k(key, k)
        assert [r.config_id for r in head] == [r.config_id for r in want]
        for g, w in zip(head, want):
            assert CONTRACT.scores_match(g.score, w.score), (key, g, w)
        assert head == port.ranking(key)[:k]


def test_snapshot_build_is_one_head_call_per_snapshot(monkeypatch):
    """On the fleet backend a published snapshot costs one k-head call
    (the plain version of ``select`` here; one launch on the card)
    whatever the number of routes; a forwarded submission costs one."""
    calls = []
    plain = rd.select_heads_plain

    def counted(scores, finite, k):
        calls.append(scores.shape[0])
        return plain(scores, finite, k)

    monkeypatch.setattr(rd, "select_heads_plain", counted)
    fe, store = _frontend("torch_fused", workers=2, n_ticks=8,
                          serve_top_k=3)
    warm = [Submission(j, exclude_groups=e) for j, e in
            (("j1", None), ("j2", None), ("j3", None), ("j4", None),
             ("j1", ("g2",)))]
    fe.warm(warm)
    assert len(calls) == len(warm)            # cold builds, one each
    del calls[:]
    snaps = fe.stats().snapshots
    for t in range(8):
        for sub in warm:
            fe.submit(sub)
        if t == 3:
            fe.submit(Submission("j5", exclude_groups=("g1", "g2")))
        fe.serve_queued()
        fe.step_tick()
    stats = fe.close()
    published = stats.snapshots - snaps
    assert stats.forwarded == 1 and published >= 8
    # one call a snapshot, plus the forwarded (cold) selection's one
    assert len(calls) == published + 1
    assert max(calls) > 1                     # many member rows at once
    audit = JournalReplayer(store, fe.journal_dump()).audit()
    assert audit.ok, audit.mismatches[:3]


def test_snapshot_holds_host_values_only():
    """Workers read only host values: a snapshot entry holds Python
    floats and strings (no tensor), on the fleet backend as on numpy."""
    fe, _ = _frontend("torch_fused", workers=1, serve_top_k=3)
    fe.warm([Submission("j1"), Submission("j2")])
    fe.step_tick()
    for entry in fe.snapshot.entries.values():
        assert type(entry.hourly_cost) is float
        for r in entry.head:
            assert type(r.config_id) is str
            assert type(r.score) is float
            assert type(r.mean_norm_cost) is float
    fe.close()
