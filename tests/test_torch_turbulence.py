"""The port's turbulence sweep against the reference package.

  * **byte-determinism**: every preset's market is a pure function of
    ``(seed, knobs)`` and equals the reference's, event for event and
    byte for byte in its recording; the calm preset regenerates the
    bundled ``examples/data/gcp_spot_prices.csv`` fixture;
  * **the sweep**: ``run_sweep`` on ``numpy`` gives the reference's
    ``TurbulencePoint.summary()`` exactly; on ``torch_fused``
    (``device="cpu"``: the kernels' plain versions) every point audits
    clean and its deviations agree with numpy's to rel 1e-4;
  * **transport-independence**: a stubbed ``PollingPriceFeed`` serving a
    recording's quotes gives the recorded feed's evaluation;
  * ``JournalReplayer.evaluate`` equals the reference's on one journal.
"""
import math
import os

import pytest

from repro.core.trace import JobClass as RefJobClass
from repro.market import JournalReplayer as RefReplayer
from repro.market import RecordedPriceFeed as RefRecorded
from repro.market import SelectionDaemon as RefDaemon
from repro.market import Submission as RefSubmission
from repro.market import Tick as RefTick
from repro.market import make_market as ref_make_market
from repro.market import record_feed as ref_record_feed
from repro.market import run_sweep as ref_run_sweep
from repro.market import turbulence as ref_turbulence
from repro.selector import IdentityCatalog as RefCatalog
from repro.selector import PriceTable as RefTable
from repro.selector import ProfilingStore as RefStore
from repro.selector import SelectionService as RefService
from repro_torch.core import costmodel, spark_sim
from repro_torch.core.evaluate import TurbulencePoint, turbulence_curves
from repro_torch.core.trace import JobClass
from repro_torch.market import (JournalReplayer, LaggedPriceFeed,
                                PollingPriceFeed, RecordedPriceFeed,
                                SelectionDaemon, SimulatedSpotFeed,
                                Submission, TURBULENCE_PRESETS, Tick,
                                TurbulencePreset, correlated_spike_events,
                                eviction_storm_events, flash_crash_events,
                                make_market, record_feed, run_point,
                                run_sweep, synthetic_stream)
from repro_torch.market.feed import DEFAULT_REGIONS
from repro_torch.market.turbulence import preset as resolve_preset
from repro_torch.selector import (GcpVmCatalog, IdentityCatalog, PriceTable,
                                  ProfilingStore, SelectionService)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "examples", "data", "gcp_spot_prices.csv")
N_CFGS = 8


def _universe(store_cls=ProfilingStore, klass_cls=JobClass):
    ids = [f"c{i}" for i in range(N_CFGS)]
    store = store_cls(config_ids=ids)
    for j in range(6):
        klass = klass_cls.A if j % 2 else klass_cls.B
        for i, c in enumerate(ids):
            store.add(f"j{j}", c,
                      0.2 + ((j * 7 + i * 5) % 13) / 6.0
                      + (0.4 if klass is klass_cls.A and i % 2 == 0
                         else 0.0),
                      job_class=klass, group=f"g{j % 3}")
    base = {c: 1.0 + (i * 5 % 11) for i, c in enumerate(ids)}
    return store, ids, base


def _stream(n_ticks=30, sub=Submission, tick=Tick):
    for t in range(n_ticks):
        yield tick()
        if t % 2 == 0:
            yield sub(f"j{(t // 2) % 6}")


def _service(store, ids, base, backend="numpy"):
    return SelectionService(IdentityCatalog(ids), store, PriceTable(base),
                            backend=backend, device="cpu")


def _ref_service(backend="numpy"):
    store, ids, base = _universe(RefStore, RefJobClass)
    return RefService(RefCatalog(ids), store, RefTable(base),
                      backend=backend)


# --- generators and presets -----------------------------------------------------

def test_eviction_storm_covers_every_region_with_staggered_starts():
    events = eviction_storm_events(7, 100, storms=3, severity=3.0)
    assert len(events) == 3 * len(DEFAULT_REGIONS)
    n = len(DEFAULT_REGIONS)
    for storm in (events[i:i + n] for i in range(0, len(events), n)):
        assert {e.region for e in storm} == set(DEFAULT_REGIONS)
        starts = [e.start_tick for e in storm]
        assert max(starts) - min(starts) <= 3
        assert all(e.kind == "eviction" for e in storm)
        assert all(3.0 <= e.factor < 6.0 for e in storm)
        assert len({e.duration for e in storm}) == 1


def test_correlated_spikes_always_hit_at_least_two_regions_same_tick():
    events = correlated_spike_events(3, 80, spikes=5, severity=2.5)
    spikes = {}
    for e in events:
        spikes.setdefault((e.start_tick, e.duration), []).append(e)
    assert len(spikes) == 5
    for members in spikes.values():
        assert len(members) >= 2
        assert set(DEFAULT_REGIONS[:2]) <= {e.region for e in members}
        assert all(e.factor >= 2.5 for e in members)


def test_flash_crash_pairs_each_crash_with_an_overshoot_recovery():
    events = flash_crash_events(9, 60, crashes=2, depth=0.25,
                                overshoot=1.8)
    crashes = [e for e in events if e.kind == "flash-crash"]
    recoveries = [e for e in events if e.kind == "recovery"]
    assert len(crashes) == len(recoveries) == 2 * len(DEFAULT_REGIONS)
    for c, r in zip(crashes, recoveries):
        assert c.factor == 0.25 and r.factor == 1.8
        assert r.start_tick == c.start_tick + c.duration
        assert r.duration == max(2, c.duration // 2)


@pytest.mark.parametrize("gen", ["eviction_storm_events",
                                 "correlated_spike_events",
                                 "flash_crash_events"])
@pytest.mark.parametrize("seed,ticks", [(0, 40), (7, 100), (123, 400)])
def test_generators_equal_reference(gen, seed, ticks):
    got = getattr(__import__("repro_torch.market.turbulence",
                             fromlist=[gen]), gen)(seed, ticks)
    want = getattr(ref_turbulence, gen)(seed, ticks)
    assert [tuple(vars(e).values()) for e in got] == \
        [tuple(vars(e).values()) for e in want]
    with pytest.raises(ValueError):
        getattr(__import__("repro_torch.market.turbulence",
                           fromlist=[gen]), gen)(seed, 0)


def test_flash_crash_rejects_bad_depth():
    with pytest.raises(ValueError):
        flash_crash_events(0, 50, depth=1.5)


def test_preset_resolver_and_levels():
    assert resolve_preset("calm") is TURBULENCE_PRESETS["calm"]
    custom = TurbulencePreset("mine", level=9.0)
    assert resolve_preset(custom) is custom
    with pytest.raises(ValueError, match="calm"):
        resolve_preset("hurricane")
    levels = [p.level for p in sorted(TURBULENCE_PRESETS.values(),
                                      key=lambda p: p.level)]
    assert levels == sorted(set(levels)) and levels[0] == 0.0
    assert sorted(TURBULENCE_PRESETS) == \
        sorted(ref_turbulence.TURBULENCE_PRESETS)


def test_lagged_feed_is_a_pure_reindexing():
    _, _, base = _universe()
    text = record_feed(SimulatedSpotFeed(base, seed=4,
                                         change_fraction=0.5), 20)
    lagged = LaggedPriceFeed(RecordedPriceFeed.loads(text), 3)
    plain = RecordedPriceFeed.loads(text)
    assert lagged.poll(0) == lagged.poll(1) == lagged.poll(2) == ()
    for t in range(3, 20):
        assert lagged.poll(t) == plain.poll(t - 3)
    for bad in (-1, 1.5):
        with pytest.raises(ValueError):
            LaggedPriceFeed(plain, bad)


@pytest.mark.parametrize("name", sorted(TURBULENCE_PRESETS))
@pytest.mark.parametrize("seed", [23, 11])
def test_every_preset_is_byte_deterministic_and_equals_reference(name,
                                                                 seed):
    _, _, base = _universe()
    ticks = 200
    m1 = make_market(name, base, seed=seed, ticks=ticks)
    m2 = make_market(name, base, seed=seed, ticks=ticks)
    assert m1.events == m2.events
    t1 = record_feed(m1.feed, ticks)
    assert t1 == record_feed(m2.feed, ticks)
    replay = RecordedPriceFeed.loads(t1)
    assert record_feed(replay, ticks) == t1
    ref = ref_make_market(name, base, seed=seed, ticks=ticks)
    assert ref_record_feed(ref.feed, ticks) == t1
    assert [tuple(vars(e).values()) for e in m1.events] == \
        [tuple(vars(e).values()) for e in ref.events]


def test_calm_preset_regenerates_the_bundled_fixture():
    trace = spark_sim.generate_trace(seed=0)
    catalog = GcpVmCatalog(trace.configs, costmodel.LinearPriceModel())
    base = dict(PriceTable.from_catalog(catalog).items())
    with open(FIXTURE) as f:
        fixture = f.read()
    market = make_market("calm", base, seed=11, ticks=40)
    assert record_feed(market.raw, 40) == fixture


# --- the sweep ----------------------------------------------------------------------

def _summary_equal(got, want):
    g, w = dict(got), dict(want)
    for key in set(g) | set(w):
        a, b = g.get(key), w.get(key)
        if isinstance(a, float) and math.isnan(a):
            assert isinstance(b, float) and math.isnan(b), key
        else:
            assert a == b, key


@pytest.fixture(scope="module")
def sweeps():
    """The full preset grid on the small universe: the port on numpy and
    torch_fused, the reference on numpy."""
    store, ids, base = _universe()
    events = list(_stream(30))
    port = run_sweep(lambda b: _service(store, ids, base, b), base, events,
                     backends=["numpy", "torch_fused"], seed=6)
    rstore, rids, rbase = _universe(RefStore, RefJobClass)
    ref = ref_run_sweep(
        lambda b: RefService(RefCatalog(rids), rstore, RefTable(rbase),
                             backend=b),
        rbase, list(_stream(30, RefSubmission, RefTick)),
        backends=["numpy"], seed=6)
    return port, ref


def test_run_sweep_numpy_summaries_equal_reference(sweeps):
    port, ref = sweeps
    numpy_points = [p for p in port if p.backend == "numpy"]
    assert [p.preset for p in numpy_points] == [p.preset for p in ref]
    assert len(numpy_points) == len(TURBULENCE_PRESETS)
    for p, r in zip(numpy_points, ref):
        _summary_equal(p.summary(), r.summary())
        assert p.audit_ok and p.audit_drift == 0


def test_run_sweep_torch_fused_audits_clean_and_tracks_numpy(sweeps):
    port, _ = sweeps
    by = {(p.preset, p.backend): p for p in port}
    for name in TURBULENCE_PRESETS:
        fused, plain = by[name, "torch_fused"], by[name, "numpy"]
        assert fused.audit_ok, (name, fused.audit_mismatches)
        assert fused.decisions == plain.decisions == 15
        assert fused.epochs == plain.epochs
        assert fused.mean_deviation == pytest.approx(plain.mean_deviation,
                                                     rel=1e-4, abs=1e-12)
        assert fused.truth_mean_deviation == pytest.approx(
            plain.truth_mean_deviation, rel=1e-4, abs=1e-12)
    curves = turbulence_curves(port)
    assert sorted(curves) == ["numpy", "torch_fused"]
    for curve in curves.values():
        assert [p.level for p in curve] == sorted(p.level for p in curve)


def test_run_sweep_orders_points_and_lag_splits_truth_from_journal():
    store, ids, base = _universe()
    points = run_sweep(lambda b: _service(store, ids, base, b), base,
                       list(_stream(30)),
                       presets=["laggy_storm", "calm", "volatile"],
                       backends=["numpy"], seed=6)
    assert [p.preset for p in points] == ["calm", "volatile",
                                          "laggy_storm"]
    assert all(isinstance(p, TurbulencePoint) for p in points)
    for p in points:
        if p.preset == "laggy_storm":
            assert p.truth_mean_deviation != p.mean_deviation
        else:
            assert p.truth_mean_deviation == p.mean_deviation


@pytest.mark.parametrize("backend", ["numpy", "torch_fused"])
def test_polled_feed_equals_recorded_feed(backend):
    store, ids, base = _universe()
    market = make_market("eviction_storm", base, seed=6, ticks=30)
    text = record_feed(market.raw, 30)
    p1 = run_point(_service(store, ids, base, backend),
                   RecordedPriceFeed.loads(text), _stream(30),
                   preset_name="eviction_storm", level=3.0,
                   truth=RecordedPriceFeed.loads(text))
    replay = RecordedPriceFeed.loads(text)
    p2 = run_point(_service(store, ids, base, backend),
                   PollingPriceFeed(lambda t: {"quotes": [
                       {"config_id": d.config_id, "price": d.price}
                       for d in replay.poll(t)]}),
                   _stream(30), preset_name="eviction_storm", level=3.0,
                   feed_kind="polled", truth=RecordedPriceFeed.loads(text))
    assert p1.evaluation.summary() == p2.evaluation.summary()
    assert p1.mean_deviation == p2.mean_deviation
    assert p1.audit_ok and p2.audit_ok
    assert (p1.feed_kind, p2.feed_kind) == ("recorded", "polled")


def test_run_point_truth_judge_matches_journal_on_unlagged_feeds():
    store, ids, base = _universe()
    text = record_feed(make_market("volatile", base, seed=2,
                                   ticks=30).raw, 30)
    point = run_point(_service(store, ids, base),
                      RecordedPriceFeed.loads(text), _stream(30),
                      preset_name="volatile", level=1.0,
                      truth=RecordedPriceFeed.loads(text))
    assert point.audit_ok
    assert point.truth_mean_deviation == point.mean_deviation
    assert point.summary()["truth_mean_deviation"] == point.mean_deviation
    no_truth = run_point(_service(store, ids, base),
                         RecordedPriceFeed.loads(text), _stream(30))
    assert no_truth.truth is None
    assert math.isnan(no_truth.truth_mean_deviation)
    assert "truth_mean_deviation" not in no_truth.summary()


# --- the paper's universe, and JournalReplayer.evaluate ---------------------------------

@pytest.mark.parametrize("backend", ["numpy", "torch_fused"])
def test_calm_point_on_the_paper_universe(backend):
    """The turbulence bench's baseline: the paper's universe, 400 events,
    the bundled fixture.  The calm mean deviation stays at the recorded
    6.4% on both backends, and the truth judge equals the journal's."""
    trace = spark_sim.generate_trace(seed=0)
    store = ProfilingStore.from_trace(trace)
    catalog = GcpVmCatalog(trace.configs, costmodel.LinearPriceModel())
    svc = SelectionService(catalog, store, PriceTable.from_catalog(catalog),
                           backend=backend, device="cpu")
    events = list(synthetic_stream([j.name for j in trace.jobs], 400,
                                   seed=3, tick_fraction=0.15))
    point = run_point(svc, RecordedPriceFeed.load(FIXTURE), events,
                      preset_name="calm", truth=RecordedPriceFeed.load(
                          FIXTURE))
    assert point.audit_ok
    assert point.mean_deviation <= 0.0645
    assert point.truth_mean_deviation == point.mean_deviation
    if backend == "numpy":
        assert point.mean_deviation == pytest.approx(0.064462, abs=5e-7)


def test_journal_replayer_evaluate_equals_reference():
    store, ids, base = _universe()
    text = record_feed(make_market("flash_crash", base, seed=1,
                                   ticks=30).raw, 30)
    daemon = SelectionDaemon(_service(store, ids, base, "torch_fused"),
                             RecordedPriceFeed.loads(text))
    daemon.run(_stream(30))
    journal = daemon.journal_dump()
    got = JournalReplayer(store, journal).evaluate()
    rstore = RefStore.loads_jsonl(store.dump_jsonl())
    want = RefReplayer(rstore, journal).evaluate()
    assert got.summary() == want.summary()
    assert got.backend == "torch_fused" and len(got.outcomes) == 15
    moved = {c: p * 1.5 for c, p in base.items()}
    assert JournalReplayer(store, journal).evaluate(moved).summary() == \
        RefReplayer(rstore, journal).evaluate(moved).summary()
    # the reference daemon over the same recording writes a journal the
    # port evaluates to the same numbers
    ref_daemon = RefDaemon(_ref_service(), RefRecorded.loads(text))
    ref_daemon.run(_stream(30, RefSubmission, RefTick))
    numpy_daemon = SelectionDaemon(_service(store, ids, base),
                                   RecordedPriceFeed.loads(text))
    numpy_daemon.run(_stream(30))
    assert numpy_daemon.journal_dump() == ref_daemon.journal_dump()
    assert JournalReplayer(store, ref_daemon.journal_dump()).evaluate() \
        .summary() == RefReplayer(
            rstore, ref_daemon.journal_dump()).evaluate().summary()
