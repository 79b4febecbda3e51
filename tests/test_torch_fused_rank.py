"""``TorchFusedRankState`` against the reference's ``PallasBatchedRankState``.

The port's fleet state runs here with ``device="cpu"`` (the kernels'
plain PyTorch versions); the reference runs its Pallas kernel in
``interpret=True`` mode.  Tick by tick both must report the same handoff
count and hold every member within the float32 score contract of each
other and of the cold numpy float64 ``rank_dense`` — over seeded fleets,
padded-J reference tilings, SimulatedSpotFeed event markets, duplicate
deltas, member add/retire/slot reuse, and the fused heads.  Also home to
the state conversion from the reference (``repro_torch.convert``).
"""
import numpy as np
import pytest
import torch

from repro.selector import PallasBatchedRankState
from repro.selector import ProfilingStore as RefStore
from repro.selector import RankState as RefRankState
from repro.core.trace import JobClass as RefJobClass
from repro_torch.convert import (FLEET_ARRAYS, fleet_state_from_reference,
                                 store_from_reference)
from repro_torch.market import MarketEvent, SimulatedSpotFeed
from repro_torch.selector import (BackendUnavailableError,
                                  NothingRankableError, TorchFusedRankState,
                                  rank_dense, score_contract)

CONTRACT = score_contract("torch_fused")
#: the reference tilings: default (J padded to 8), a 4-row tile, and a
#: tiled C axis (its phase-0 minimum spans tiles)
TILINGS = ({}, {"block_j": 4}, {"block_j": 4, "block_c": 8})


def assert_within_contract(candidate, reference, contract=CONTRACT):
    """Same winner (or tied within tolerance) and every score inside the
    rel/abs envelope."""
    assert candidate
    ref_score = {r.config_id: r.score for r in reference}
    assert contract.winner_matches(candidate[0].config_id, reference), (
        candidate[0], reference[0])
    for r in candidate:
        assert contract.scores_match(r.score, ref_score[r.config_id]), (
            r, ref_score[r.config_id])


def _fleet_universe(seed, n_jobs=10, n_cfgs=24, n_members=4, partial=True):
    rng = np.random.default_rng(seed)
    hours = rng.uniform(0.05, 10.0, (n_jobs, n_cfgs))
    if partial:
        mask = rng.random((n_jobs, n_cfgs)) > 0.25
        mask[np.arange(n_jobs), rng.integers(0, n_cfgs, n_jobs)] = True
    else:
        mask = np.ones((n_jobs, n_cfgs), dtype=bool)
    prices = rng.uniform(0.5, 20.0, n_cfgs)
    ids = [f"c{i}" for i in range(n_cfgs)]
    members = {"all": list(range(n_jobs))}
    for m in range(n_members - 1):
        size = int(rng.integers(1, n_jobs))
        members[f"m{m}"] = sorted(
            int(i) for i in rng.choice(n_jobs, size, replace=False))
    return rng, hours, mask, prices, ids, members


def _pair(hours, mask, prices, ids, members, **tiling):
    port = TorchFusedRankState(hours, mask, prices.copy(), ids,
                               device="cpu")
    ref = PallasBatchedRankState(hours, mask, prices.copy(), ids, **tiling)
    for key, rows in members.items():
        port.add_state(key, rows=rows)
        ref.add_state(key, rows=rows)
    return port, ref


def _assert_parity(port, ref, members, hours, mask, live, ids):
    for key, rows in members.items():
        cold = rank_dense(hours[rows], mask[rows], live, ids)
        rp = port.ranking(key)
        assert_within_contract(rp, cold)
        assert_within_contract(rp, ref.ranking(key))
        k = min(3, len(ids))
        assert port.top_k(key, k) == rp[:k]


def _random_deltas(rng, live, ids):
    k = int(rng.integers(1, len(ids)))
    cols = rng.choice(len(ids), k, replace=False)
    return {ids[c]: float(live[c] * rng.uniform(0.5, 2.0)) for c in cols}


@pytest.mark.parametrize("tiling", TILINGS)
@pytest.mark.parametrize("seed", range(3))
def test_fleet_tick_by_tick_against_pallas(seed, tiling):
    """Seeded fleets (partial masks on even seeds; J of 6-8 rows, so the
    reference pads its job axis to the tile): same handoff counts and
    within-contract rankings every tick, one dispatch per tick."""
    rng, hours, mask, prices, ids, members = _fleet_universe(
        seed, n_jobs=6 + seed, n_cfgs=16, partial=seed % 2 == 0)
    port, ref = _pair(hours, mask, prices, ids, members, **tiling)
    live = prices.copy()
    for _ in range(4):
        deltas = _random_deltas(rng, live, ids)
        assert port.reprice(deltas) == ref.reprice(deltas)
        for c, p in deltas.items():
            live[int(c[1:])] = p
        _assert_parity(port, ref, members, hours, mask, live, ids)
    assert port.dispatches == port.reprices == 4
    assert port.n_active == len(members)


def test_event_market_against_pallas():
    """Discount/eviction boundary re-quote bursts from the port's
    SimulatedSpotFeed: the port and the reference agree per tick."""
    rng, hours, mask, prices, ids, members = _fleet_universe(
        7, n_jobs=8, n_cfgs=11, partial=False)
    base = {c: float(p) for c, p in zip(ids, prices)}
    feed = SimulatedSpotFeed(
        base, seed=5, change_fraction=0.3, volatility=0.15,
        events=[MarketEvent("us-central1", 2, 4, 0.25, "discount"),
                MarketEvent("europe-west3", 5, 3, 4.0, "eviction")])
    port, ref = _pair(hours, mask, prices, ids, members)
    live = prices.copy()
    for t in range(8):
        batch = feed.poll(t)
        if not batch:
            continue
        deltas = {d.config_id: d.price for d in batch}
        assert port.reprice(deltas) == ref.reprice(deltas)
        for d in batch:
            live[ids.index(d.config_id)] = d.price
        _assert_parity(port, ref, members, hours, mask, live, ids)


def test_duplicate_deltas_idempotent_by_construction():
    """A batch with duplicate config ids (last wins) and its collapsed
    dict form produce the same tick, bit-for-bit."""
    rng, hours, mask, prices, ids, members = _fleet_universe(
        5, n_jobs=8, n_cfgs=12)
    a = TorchFusedRankState(hours, mask, prices.copy(), ids, device="cpu")
    b = TorchFusedRankState(hours, mask, prices.copy(), ids, device="cpu")
    for key, rows in members.items():
        a.add_state(key, rows=rows)
        b.add_state(key, rows=rows)
    dup = [(ids[2], 9.9), (ids[5], 0.4), (ids[2], 1.1), (ids[2], 0.7)]
    collapsed = {ids[2]: 0.7, ids[5]: 0.4}
    assert a.reprice(dup) == b.reprice(collapsed)
    for key in members:
        assert np.array_equal(a.scores(key), b.scores(key))
    assert np.array_equal(a.prices, b.prices)


def test_members_added_retired_and_slot_reuse():
    """Mid-stream adds sync at once; retired members raise the typed
    error; a retire-all / re-add cycle reuses slots (``realloc_count``
    pinned) and the revived member bit-matches a cold build; new
    concurrent members grow capacity — all beside the reference."""
    rng, hours, mask, prices, ids, members = _fleet_universe(
        11, n_jobs=12, n_cfgs=17, n_members=4)
    port = TorchFusedRankState(hours, mask, prices.copy(), ids, capacity=4,
                               device="cpu")
    ref = PallasBatchedRankState(hours, mask, prices.copy(), ids,
                                 capacity=4)
    live = prices.copy()

    def tick():
        deltas = _random_deltas(rng, live, ids)
        assert port.reprice(deltas) == ref.reprice(deltas)
        for c, p in deltas.items():
            live[int(c[1:])] = p

    def check(keys):
        for key in keys:
            rows = members[key]
            cold = rank_dense(hours[rows], mask[rows], live, ids)
            assert_within_contract(port.ranking(key), cold)
            assert_within_contract(port.ranking(key), ref.ranking(key))

    for s in (port, ref):
        s.add_state("all", rows=members["all"])
    tick()
    for s in (port, ref):
        s.add_state("m0", rows=members["m0"])          # post-tick add
    tick()
    check(("all", "m0"))
    assert port.realloc_count == ref.realloc_count == 0
    for key in ("all", "m0"):
        port.retire_state(key)
        ref.retire_state(key)
    assert port.n_active == 0
    with pytest.raises(NothingRankableError, match="retired"):
        port.ranking("m0")
    with pytest.raises(NothingRankableError, match="retired"):
        port.top_k("m0", 1)
    with pytest.raises(ValueError, match="unknown member"):
        port.ranking("never-registered")
    for key in ("all", "m0"):
        port.add_state(key, rows=members[key])
        ref.add_state(key, rows=members[key])
    assert port.realloc_count == 0                   # reuse, not growth
    cold_state = TorchFusedRankState(hours, mask, port.prices, ids,
                                     device="cpu")
    cold_state.add_state("m0", rows=members["m0"])
    assert np.array_equal(port.scores("m0"), cold_state.scores("m0"))
    for i in range(5):
        rows = [int(r) for r in rng.choice(12, 3, replace=False)]
        port.add_state(f"late{i}", rows=rows)
        ref.add_state(f"late{i}", rows=rows)
    assert port.realloc_count == ref.realloc_count == 1
    tick()
    check(("all", "m0"))


def test_validates_members_and_deltas():
    rng, hours, mask, prices, ids, _ = _fleet_universe(3, n_jobs=4,
                                                       n_cfgs=6)
    s = TorchFusedRankState(hours, mask, prices, ids,
                            job_ids=[f"j{i}" for i in range(4)],
                            device="cpu")
    s.add_state("a", rows=[0, 1])
    with pytest.raises(ValueError, match="duplicate member"):
        s.add_state("a", rows=[2])
    with pytest.raises(ValueError, match="exactly one of"):
        s.add_state("b", rows=[0], jobs=["j0"])
    with pytest.raises(ValueError, match="unknown job id"):
        s.add_state("b", jobs=["ghost"])
    # rows= is validated against the true J: the reference's first
    # padding row (4 of its 8-row kernel axis) is out of range here too
    with pytest.raises(ValueError, match="out of range"):
        s.add_state("b", rows=[4])
    with pytest.raises(ValueError, match="duplicate rows"):
        s.add_state("b", rows=[1, 1])
    with pytest.raises(ValueError, match="unknown member"):
        s.retire_state("ghost")
    with pytest.raises(ValueError, match="unknown config id"):
        s.reprice({"ghost": 1.0})
    with pytest.raises(ValueError, match="non-positive"):
        s.reprice({ids[0]: -1.0})
    assert s.reprice({}) == 0
    s.add_state("b", jobs=["j2", "j3"])
    assert s.keys() == ["a", "b"] and "b" in s


def _universe_with_ties(n_jobs=5, n_cfgs=12, seed=2):
    """The last three columns are exact clones (bit-equal scores) and
    column 0 is never profiled."""
    rng = np.random.default_rng(seed)
    hours = rng.uniform(0.05, 10.0, (n_jobs, n_cfgs))
    hours[:, n_cfgs - 2] = hours[:, n_cfgs - 3]
    hours[:, n_cfgs - 1] = hours[:, n_cfgs - 3]
    mask = np.ones((n_jobs, n_cfgs), dtype=bool)
    mask[:, 0] = False
    prices = rng.uniform(0.5, 20.0, n_cfgs)
    prices[n_cfgs - 2] = prices[n_cfgs - 3]
    prices[n_cfgs - 1] = prices[n_cfgs - 3]
    return hours, mask, prices, [f"c{i}" for i in range(n_cfgs)]


@pytest.mark.parametrize("n_cfgs", [12, 13])
def test_top_k_boundary_with_ties(n_cfgs):
    """k in {C-1, C, C+1, 10·C}: the head is exactly the head of the
    member's own ranking, clone ties in catalog order, the unprofiled
    config last, within contract of the reference's numpy ranking."""
    hours, mask, prices, ids = _universe_with_ties(n_cfgs=n_cfgs)
    C = len(ids)
    s = TorchFusedRankState(hours, mask, prices, ids, device="cpu")
    s.add_state("all", rows=list(range(hours.shape[0])))
    ref = RefRankState(hours, mask, prices, ids).ranking()
    clones = ids[C - 3:]
    for k in (C - 1, C, C + 1, 10 * C):
        head = s.top_k("all", k)
        assert head == s.ranking("all")[:min(k, C)], k
        assert_within_contract(head, ref, score_contract("torch_fused"))
        got = [r.config_id for r in head if r.config_id in clones]
        assert got == clones[:len(got)], (k, got)
        if k >= C:
            assert head[-1].config_id == "c0"
    assert s.winner("all") == s.ranking("all")[0]


def test_fused_heads_equal_ranking_after_ticks():
    """reprice_with_heads — the tick and every member's k-head from one
    dispatch — equals ranking()[:k] at every boundary k, including a
    member with fewer profiled configs than k (where the reference would
    repeat a config)."""
    hours, mask, prices, ids = _universe_with_ties(n_cfgs=13)
    C = len(ids)
    mask[1, 1:] = False
    mask[1, [3, 5]] = True                 # row 1: two profiled configs
    s = TorchFusedRankState(hours, mask, prices, ids, device="cpu")
    s.add_state("all", rows=list(range(hours.shape[0])))
    s.add_state("sparse", rows=[1])
    ticks = ({ids[3]: 0.01}, {ids[7]: 40.0, ids[1]: 0.2},
             {ids[C - 3]: 0.5, ids[C - 2]: 0.5, ids[C - 1]: 0.5})
    for deltas, k in zip(ticks, (1, C - 1, C + 1)):
        twin = TorchFusedRankState(hours, mask, s.prices, ids,
                                   device="cpu")
        twin.add_state("all", rows=list(range(hours.shape[0])))
        twin.add_state("sparse", rows=[1])
        before = s.dispatches
        moved, heads = s.reprice_with_heads(deltas, k)
        assert moved == twin.reprice(deltas)
        assert s.dispatches == before + 1
        for key in ("all", "sparse"):
            assert heads[key] == s.ranking(key)[:min(k, C)], (key, k)
            ids_served = [r.config_id for r in heads[key]]
            assert len(set(ids_served)) == len(ids_served)
    before = s.dispatches
    moved, heads = s.reprice_with_heads({}, 3)
    assert moved == 0 and s.dispatches == before
    assert heads["all"] == s.ranking("all")[:3]
    for bad in (0, -1, 1.5, True):
        with pytest.raises(ValueError, match="positive integer"):
            s.reprice_with_heads({ids[0]: 1.0}, bad)


def test_ranking_memoized_on_tick_count():
    rng, hours, mask, prices, ids, members = _fleet_universe(4)
    s = TorchFusedRankState(hours, mask, prices, ids, device="cpu")
    s.add_state("all", rows=members["all"])
    first = s.ranking("all")
    first.pop()                               # callers get a copy
    assert s.ranking("all") != first and s.materializations == 1
    s.reprice({ids[0]: 3.0})
    s.ranking("all")
    s.ranking("all")
    assert s.materializations == 2


def _plain(ranking):
    """A ranking as plain tuples (the two packages' RankedConfig classes
    never compare equal to each other)."""
    return [(r.config_id, r.score, r.mean_norm_cost) for r in ranking]


def test_numpy_rank_bitwise_equal_to_reference():
    """The port's copy of the float64 path — ``rank_dense``, ``rank_pairs``
    and the incremental ``RankState`` — gives the reference's rankings bit
    for bit, tick after tick (the anchor every float32 check leans on)."""
    from repro.selector import rank_dense as ref_rank_dense
    from repro.selector import rank_pairs as ref_rank_pairs
    from repro_torch.selector import RankState, rank_pairs
    rng, hours, mask, prices, ids, _ = _fleet_universe(6, n_jobs=7,
                                                       n_cfgs=15)
    assert _plain(rank_dense(hours, mask, prices, ids)) == \
        _plain(ref_rank_dense(hours, mask, prices, ids))
    jobs = [f"j{i}" for i in range(7)]
    pairs = {(jobs[j], ids[c]): float(hours[j, c])
             for j, c in zip(*np.nonzero(mask))}
    quote = dict(zip(ids, prices))
    assert _plain(rank_pairs(pairs, jobs, ids, quote)) == \
        _plain(ref_rank_pairs(pairs, jobs, ids, quote))
    port, ref = (RankState(hours, mask, prices.copy(), ids),
                 RefRankState(hours, mask, prices.copy(), ids))
    live = prices.copy()
    for _ in range(4):
        deltas = _random_deltas(rng, live, ids)
        assert port.reprice(deltas) == ref.reprice(deltas)
        for c, p in deltas.items():
            live[int(c[1:])] = p
        assert _plain(port.ranking()) == _plain(ref.ranking()) == \
            _plain(rank_dense(hours, mask, live, ids))
        assert _plain(port.top_k(4)) == _plain(ref.top_k(4))
        assert _plain([port.winner()]) == _plain([ref.winner()])


def test_default_device_is_the_card(monkeypatch):
    """Built without ``device=``, the state asks for CUDA and, with none
    present, raises the typed error instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, hours, mask, prices, ids, _ = _fleet_universe(0)
    with pytest.raises(BackendUnavailableError, match="cuda"):
        TorchFusedRankState(hours, mask, prices, ids)
    with pytest.raises(BackendUnavailableError):
        TorchFusedRankState(hours, mask, prices, ids, device="cuda:0")


# --- conversion from the reference ---------------------------------------------

def test_reference_fleet_carried_across_mid_stream():
    """A reference fleet (J=10 padded to 16 by its tile) stopped after a
    few ticks, converted, continues the same stream: every later tick
    matches the reference within contract, with the same handoffs."""
    rng, hours, mask, prices, ids, members = _fleet_universe(
        9, n_jobs=10, n_cfgs=14)
    ref = PallasBatchedRankState(hours, mask, prices.copy(), ids,
                                 block_j=8)
    for key, rows in members.items():
        ref.add_state(key, rows=rows)
    live = prices.copy()
    for _ in range(2):
        deltas = _random_deltas(rng, live, ids)
        ref.reprice(deltas)
        for c, p in deltas.items():
            live[int(c[1:])] = p
    ref.retire_state("m1")
    arrays = {name: np.asarray(getattr(ref, name)) for name in FLEET_ARRAYS}
    assert arrays["d_hours"].shape[0] == 16
    port = fleet_state_from_reference(arrays, ids, None, 10, ref._slots,
                                      device="cpu")
    live_members = {k: v for k, v in members.items() if k != "m1"}
    assert port.keys() == list(live_members)
    for key in live_members:
        assert np.array_equal(port.scores(key), ref.scores(key))
    for _ in range(3):
        deltas = _random_deltas(rng, live, ids)
        assert port.reprice(deltas) == ref.reprice(deltas)
        for c, p in deltas.items():
            live[int(c[1:])] = p
        _assert_parity(port, ref, live_members, hours, mask, live, ids)
    port.add_state("late", rows=[0, 9])       # a free slot is reused
    assert port.realloc_count == 0
    with pytest.raises(ValueError, match="missing"):
        fleet_state_from_reference({}, ids, None, 10, {}, device="cpu")


def test_store_round_trips_between_packages():
    """The JSONL format is shared: a reference store converts to the
    port's and back with identical bytes."""
    rng = np.random.default_rng(1)
    ref = RefStore(config_ids=["a", "b", 3])
    for j in range(5):
        for c in ("a", "b", 3):
            if rng.random() < 0.8:
                ref.add(f"j{j}", c, float(rng.uniform(0.1, 4.0)),
                        job_class=RefJobClass.A if j % 2 else None,
                        group=f"g{j % 2}")
    text = ref.dump_jsonl()
    port = store_from_reference(text)
    assert port.dump_jsonl() == text
    assert RefStore.loads_jsonl(port.dump_jsonl()).dump_jsonl() == text
    h_ref, m_ref = ref.matrix()
    h_port, m_port = port.matrix()
    assert np.array_equal(m_ref, m_port)
    assert np.array_equal(h_ref[m_ref], h_port[m_port])
