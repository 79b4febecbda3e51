"""The port's selection service and daemon against the reference package.

A ``torch_fused`` service (``device="cpu"``: the kernels' plain PyTorch
versions) and a reference ``jax_pallas`` service (its Pallas kernel in
``interpret=True`` mode) are built over the same store and prices and
driven by the same submissions and price ticks.  Decision by decision they
must agree under the float32 score contract.  Journals move between the
packages unchanged: a port journal audits clean in the port's
``JournalReplayer`` and in the reference's (given the contract
explicitly), and a ``numpy`` daemon writes the same bytes in both.
"""
import numpy as np
import pytest
import torch

from repro.core.trace import JobClass as RefJobClass
from repro.market import JournalReplayer as RefReplayer
from repro.market import SelectionDaemon as RefDaemon
from repro.market import SimulatedSpotFeed as RefFeed
from repro.market import synthetic_stream as ref_stream
from repro.selector import IdentityCatalog as RefCatalog
from repro.selector import PriceTable as RefTable
from repro.selector import ProfilingStore as RefStore
from repro.selector import SelectionService as RefService
from repro.selector import score_contract as ref_contract
from repro_torch.core.trace import JobClass
from repro_torch.market import (JournalReplayer, SelectionDaemon,
                                SimulatedSpotFeed, synthetic_stream)
from repro_torch.selector import (BackendUnavailableError, IdentityCatalog,
                                  NothingRankableError, PriceTable,
                                  ProfilingStore, SelectionService,
                                  TorchFusedRankState, score_contract)

CONTRACT = score_contract("torch_fused")


def _market(n_jobs=8, n_cfgs=16, seed=1, groups=4, partial=0.0):
    """Runtimes, profiling mask and prices from a numpy seed."""
    rng = np.random.default_rng(seed)
    hours = rng.uniform(0.1, 5.0, (n_jobs, n_cfgs))
    keep = rng.random((n_jobs, n_cfgs)) >= partial
    keep[np.arange(n_jobs), rng.integers(0, n_cfgs, n_jobs)] = True
    prices = rng.uniform(1.0, 20.0, n_cfgs)
    return hours, keep, prices, groups


def _store(store_cls, klass_cls, hours, keep, groups):
    n_jobs, n_cfgs = hours.shape
    ids = [f"c{i}" for i in range(n_cfgs)]
    store = store_cls(config_ids=ids)
    for j in range(n_jobs):
        klass = klass_cls.A if j % 2 else klass_cls.B
        for c in np.flatnonzero(keep[j]):
            store.add(f"j{j}", ids[c], float(hours[j, c]),
                      job_class=klass, group=f"g{j % groups}")
    return store, ids


def _port_service(market, backend="torch_fused", **kw):
    hours, keep, prices, groups = market
    store, ids = _store(ProfilingStore, JobClass, hours, keep, groups)
    table = PriceTable({c: float(p) for c, p in zip(ids, prices)})
    if backend == "torch_fused":
        kw.setdefault("device", "cpu")
    return SelectionService(IdentityCatalog(ids), store, table,
                            backend=backend, **kw)


def _ref_service(market, backend="jax_pallas", **kw):
    hours, keep, prices, groups = market
    store, ids = _store(RefStore, RefJobClass, hours, keep, groups)
    table = RefTable({c: float(p) for c, p in zip(ids, prices)})
    return RefService(RefCatalog(ids), store, table, backend=backend, **kw)


def _assert_rankings_agree(got, want):
    """Same winner (or tied within the contract) and every served score
    within the contract of the other package's score for that config."""
    want_score = {r.config_id: r.score for r in want}
    assert CONTRACT.scores_match(got[0].score, want[0].score), \
        (got[0], want[0])
    if got[0].config_id != want[0].config_id:
        assert CONTRACT.scores_match(want_score[got[0].config_id],
                                     want[0].score), (got[0], want[0])
    for r in got:
        assert CONTRACT.scores_match(r.score, want_score[r.config_id]), r


SELECTIONS = [("j1", None), ("j2", None), ("j1", ("g2",)), ("j2", ("g3",)),
              ("j5", ())]


@pytest.mark.parametrize("serve_top_k", [None, 3])
def test_service_matches_reference_pallas_service(serve_top_k):
    """Submit, tick, submit: every decision of the port's fleet service
    agrees with the reference ``jax_pallas`` service under the contract,
    and each tick is ONE fused dispatch for the whole fleet."""
    market = _market(partial=0.2)
    port = _port_service(market, serve_top_k=serve_top_k)
    ref = _ref_service(market, serve_top_k=serve_top_k)
    rng = np.random.default_rng(4)
    ids = port.catalog.ids()
    for tick in range(4):
        for job, excl in SELECTIONS:
            d = port.submit(job, exclude_groups=excl)
            r = ref.submit(job, exclude_groups=excl)
            assert d.served_via == r.served_via
            assert len(d.ranking) == len(r.ranking)
            assert d.price_epoch == r.price_epoch
            assert d.exclude_groups == r.exclude_groups
            _assert_rankings_agree(list(d.ranking), list(r.ranking))
            if d.config_id == r.config_id:
                assert d.hourly_cost == r.hourly_cost
        cols = rng.choice(len(ids), 5, replace=False)
        deltas = {ids[c]: float(rng.uniform(1.0, 20.0)) for c in cols}
        assert port.reprice(deltas) == ref.reprice(deltas) == 5
    assert isinstance(port._batched, TorchFusedRankState)
    assert port.reprice_dispatches == port._batched.dispatches == 4
    assert port.cache_hits == ref.cache_hits
    assert port.cache_misses == ref.cache_misses


def test_service_out_of_band_apply_and_retire():
    """The desync guard: an out-of-band ``PriceTable.apply`` drops the
    fleet for a cold rebuild instead of serving quotes it never saw.  A
    retired selection's stale closure raises the typed error, and a later
    submit rebuilds it — beside a numpy service as the reference."""
    market = _market(seed=3)
    port = _port_service(market)
    ref = _port_service(market, backend="numpy")
    port.submit("j1")
    ref.submit("j1")
    port.price_source.apply({"c2": 0.333})
    ref.price_source.apply({"c2": 0.333})
    assert port.reprice({"c5": 7.7}) == 0      # dropped, not repriced
    ref.reprice({"c5": 7.7})
    _assert_rankings_agree(list(port.submit("j1").ranking),
                           list(ref.submit("j1").ranking))
    fleet = port._batched
    key = fleet.keys()[0]
    stale_top_k = port._live_serving(key, port._price_tag())[1]
    assert port.retire_selection(*key[1:])
    with pytest.raises(NothingRankableError, match="retired"):
        stale_top_k(1)
    assert not port.retire_selection(*key[1:])
    d = port.submit("j1")
    _assert_rankings_agree(list(d.ranking), list(ref.submit("j1").ranking))
    assert fleet.n_active == 1 and fleet.realloc_count == 0


def test_service_backends_and_default_device(monkeypatch):
    """The fleet backend runs on the card unless asked otherwise: with no
    CUDA device, building it without ``device=`` raises the typed error.
    The numpy backend needs no device; unknown backends are refused."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hours, keep, prices, groups = _market()
    store, ids = _store(ProfilingStore, JobClass, hours, keep, groups)
    table = PriceTable({c: float(p) for c, p in zip(ids, prices)})
    with pytest.raises(BackendUnavailableError, match="cuda"):
        SelectionService(IdentityCatalog(ids), store, table,
                         backend="torch_fused")
    with pytest.raises(BackendUnavailableError):
        SelectionService(IdentityCatalog(ids), store, table)
    svc = SelectionService(IdentityCatalog(ids), store, table,
                           backend="numpy")
    assert svc.device is None and svc.submit("j0").config_id in ids
    with pytest.raises(ValueError, match="unknown backend"):
        SelectionService(IdentityCatalog(ids), store, table,
                         backend="jax_pallas", device="cpu")


def _daemons(market, backend_port, backend_ref, n_events=80, seed=7,
             change_fraction=0.4, serve_top_k=3):
    port = _port_service(market, backend=backend_port,
                         serve_top_k=serve_top_k)
    ref = _ref_service(market, backend=backend_ref, serve_top_k=serve_top_k)
    base = dict(port.price_source.items())
    port_d = SelectionDaemon(port, SimulatedSpotFeed(
        base, seed=4, change_fraction=change_fraction))
    ref_d = RefDaemon(ref, RefFeed(dict(base), seed=4,
                                   change_fraction=change_fraction))
    jobs = port.store.job_ids
    port_d.run(synthetic_stream(jobs, n_events, seed=seed,
                                tick_fraction=0.25))
    ref_d.run(ref_stream(jobs, n_events, seed=seed, tick_fraction=0.25))
    return port_d, ref_d


def test_daemon_journal_matches_reference_decision_by_decision():
    """The same feed and stream through both daemons: identical tick
    records (the feed is a pure function of its seed) and, decision by
    decision, the same job, class, exclusions and epoch with the winner
    and its score within the contract."""
    market = _market(n_jobs=8, n_cfgs=13, seed=9, partial=0.15)
    port_d, ref_d = _daemons(market, "torch_fused", "jax_pallas")
    ph, precs = SelectionDaemon.loads_journal(port_d.journal_dump())
    rh, rrecs = RefDaemon.loads_journal(ref_d.journal_dump())
    assert ph["backend"] == "torch_fused" and rh["backend"] == "jax_pallas"
    assert {k: v for k, v in ph.items() if k != "backend"} == \
        {k: v for k, v in rh.items() if k != "backend"}
    assert len(precs) == len(rrecs)
    n_dec = 0
    for p, r in zip(precs, rrecs):
        assert p["kind"] == r["kind"]
        if p["kind"] != "decision":
            assert p == r
            continue
        n_dec += 1
        for field in ("seq", "job", "job_class", "exclude_groups",
                      "price_epoch", "served_via", "from_cache"):
            assert p[field] == r[field], field
        assert CONTRACT.scores_match(p["score"], r["score"])
        if p["config"] == r["config"]:
            assert p["hourly_cost"] == r["hourly_cost"]
    assert n_dec > 40
    assert port_d.stats.epochs > 5
    assert port_d.service.reprice_dispatches == port_d.stats.epochs


def test_port_journal_audits_in_both_packages():
    """A port daemon's journal passes the port's ``audit()`` (which knows
    the ``torch_fused`` contract) and the reference replayer's, given the
    reference's float32 contract explicitly; the store crosses through
    its shared JSONL format."""
    market = _market(n_jobs=8, n_cfgs=13, seed=9, partial=0.15)
    port_d, _ = _daemons(market, "torch_fused", "jax_pallas")
    journal = port_d.journal_dump()
    store = port_d.service.store
    audit = JournalReplayer(store, journal).audit()
    assert audit.ok, audit.mismatches[:3]
    assert audit.decisions == port_d.stats.decisions > 0
    ref_store = RefStore.loads_jsonl(store.dump_jsonl())
    replayer = RefReplayer(ref_store, journal)
    assert replayer.backend == "torch_fused"
    ref_audit = replayer.audit(contract=ref_contract("jax_pallas"))
    assert ref_audit.ok, ref_audit.mismatches[:3]
    assert ref_audit.decisions == audit.decisions


def test_numpy_daemon_journals_are_byte_identical():
    """The float64 numpy backend is bit-stable in both packages: the same
    market and stream write the same journal bytes, and each package's
    replayer audits the other's journal in exact mode."""
    market = _market(n_jobs=8, n_cfgs=13, seed=2, partial=0.1)
    port_d, ref_d = _daemons(market, "numpy", "numpy", n_events=60)
    assert port_d.journal_dump() == ref_d.journal_dump()
    audit = JournalReplayer(port_d.service.store,
                            ref_d.journal_dump()).audit()
    assert audit.ok and audit.decisions > 0
