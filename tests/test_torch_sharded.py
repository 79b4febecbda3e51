"""``TorchShardedRankState`` (the ``torch_sharded`` backend) against the
reference's sharded fleet, its batched fleet, the port's fused fleet and
the cold numpy float64 rank.

The port's shards run here on the CPU, several to a device
(``devices=["cpu"] * n``, the kernels' plain PyTorch versions) — the
counterpart of the reference suite's
``--xla_force_host_platform_device_count=8``.  This file ports the cases
of ``tests/test_sharded_parity.py`` at shard counts 1, 2 and 8 on its
universes.  In process the reference has one device, so it is held at
``devices=1``; one test runs the reference at 2 and 8 forced host
devices in a subprocess and holds the port at the same counts against
what it wrote.

Every comparison of scores uses the float32 contract (rel 1e-4, abs 1e-6,
same or tied winner); row minima and handoff counts compare exactly.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.market import JournalReplayer as RefReplayer
from repro.selector import BatchedRankState as RefBatched
from repro.selector import ProfilingStore as RefStore
from repro.selector import ShardedBatchedRankState as RefSharded
from repro.selector import score_contract as ref_contract
from repro_torch.core import costmodel, spark_sim
from repro_torch.core.trace import JobClass
from repro_torch.kernels import rank_delta as rd
from repro_torch.market import (JournalReplayer, MarketEvent,
                                RecordedPriceFeed, SelectionDaemon,
                                ServeFrontend, SimulatedSpotFeed, Submission,
                                run_point, run_sweep, synthetic_stream)
from repro_torch.selector import (BackendUnavailableError, GcpVmCatalog,
                                  IdentityCatalog, NothingRankableError,
                                  PriceTable, ProfilingStore, RankState,
                                  SelectionService, TorchFusedRankState,
                                  TorchShardedRankState, rank_dense,
                                  score_contract)
from repro_torch.selector.rank import _materialize
from test_batched_parity import _fleet_universe, _universe_with_ties
from test_torch_frontend import _recorded
from test_torch_frontend import _universe as _frontend_universe
from test_torch_turbulence import FIXTURE
from test_torch_turbulence import _stream as _sweep_stream
from test_torch_turbulence import _universe as _sweep_universe

try:        # the property half needs hypothesis; everything else runs
            # without it
    from hypothesis import given, settings, strategies as st
    from test_batched_parity import fleet_streams
    from test_rank_properties import event_markets, _event_feed
    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover
    HAVE_HYPOTHESIS = False

CONTRACT = score_contract("torch_sharded")
#: the reference suite's shard counts
SHARD_COUNTS = (1, 2, 8)
ROOT = Path(__file__).resolve().parent.parent


def cpu(n):
    return ["cpu"] * n


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


def _fleets(hours, mask, prices, ids, members, n):
    """The port's sharded and fused fleets and the reference's batched and
    one-device sharded fleets over one universe, with the same members."""
    fleets = (TorchShardedRankState(hours, mask, prices.copy(), ids,
                                    devices=cpu(n)),
              TorchFusedRankState(hours, mask, prices.copy(), ids,
                                  device="cpu"),
              RefBatched(hours, mask, prices.copy(), ids),
              RefSharded(hours, mask, prices.copy(), ids, devices=1))
    for fleet in fleets:
        for key, rows in members.items():
            fleet.add_state(key, rows=rows)
    return fleets


def _assert_parity(fleets, members, hours, mask, live, ids):
    """Every member of the sharded fleet within the contract of the cold
    rank and of each other fleet; its k-head the head of its ranking."""
    sharded, *others = fleets
    for key, rows in members.items():
        got = sharded.ranking(key)
        assert_within_contract(got, rank_dense(hours[rows], mask[rows],
                                               live, ids))
        for other in others:
            assert_within_contract(got, other.ranking(key))
        k = min(3, len(ids))
        assert sharded.top_k(key, k) == got[:k]


def _random_deltas(rng, live, ids):
    k = int(rng.integers(1, len(ids)))
    cols = rng.choice(len(ids), k, replace=False)
    return {ids[c]: float(live[c] * rng.uniform(0.5, 2.0)) for c in cols}


def _apply(live, deltas):
    for c, p in deltas.items():
        live[int(c[1:])] = p


# --- deterministic differential sweeps ---------------------------------------------

@pytest.mark.parametrize("n", SHARD_COUNTS)
@pytest.mark.parametrize("seed", range(3))
def test_sharded_fleet_within_contract_seeded(seed, n):
    """Seeded fleets (C not a multiple of the shard count, so the last
    shard is short or empty): after each tick every member is within the
    contract of the cold rank, the port's fused fleet and the reference's
    batched and one-device sharded fleets; the handoff count equals
    theirs; one dispatch a tick."""
    rng, hours, mask, prices, ids, members = _fleet_universe(
        seed, n_jobs=6 + seed, n_cfgs=13 + 4 * seed, partial=seed % 2 == 0)
    fleets = _fleets(hours, mask, prices, ids, members, n)
    sharded = fleets[0]
    live = prices.copy()
    for _ in range(5):
        deltas = _random_deltas(rng, live, ids)
        moved = [fleet.reprice(deltas) for fleet in fleets]
        assert moved == [moved[0]] * len(fleets)
        _apply(live, deltas)
        _assert_parity(fleets, members, hours, mask, live, ids)
    assert sharded.dispatches == sharded.reprices == 5
    assert sharded.n_active == len(members)
    assert sharded.n_devices == n


@pytest.mark.parametrize("n", SHARD_COUNTS)
def test_sharded_event_market_within_contract(n):
    """Discount/eviction boundary re-quote bursts from the port's
    SimulatedSpotFeed: the sharded fleet tracks every reference."""
    rng, hours, mask, prices, ids, members = _fleet_universe(
        7, n_jobs=8, n_cfgs=11, partial=False)
    base = {c: float(p) for c, p in zip(ids, prices)}
    feed = SimulatedSpotFeed(
        base, seed=5, change_fraction=0.3, volatility=0.15,
        events=[MarketEvent("us-central1", 2, 4, 0.25, "discount"),
                MarketEvent("europe-west3", 5, 3, 4.0, "eviction")])
    fleets = _fleets(hours, mask, prices, ids, members, n)
    live = prices.copy()
    for t in range(10):
        batch = feed.poll(t)
        if not batch:
            continue
        deltas = {d.config_id: d.price for d in batch}
        moved = [fleet.reprice(deltas) for fleet in fleets]
        assert moved == [moved[0]] * len(fleets)
        for d in batch:
            live[ids.index(d.config_id)] = d.price
        _assert_parity(fleets, members, hours, mask, live, ids)


@pytest.mark.parametrize("n", SHARD_COUNTS)
def test_sharded_states_added_retired_and_slot_reuse(n):
    """Members added mid-stream sync with every prior tick; retired
    members raise the typed rankable-nothing error; a retire-all /
    re-add cycle reuses the zeroed slots (``realloc_count`` pinned), the
    revived member's scores equal a cold build's bit for bit, and new
    members past the capacity double it."""
    rng, hours, mask, prices, ids, members = _fleet_universe(
        11, n_jobs=12, n_cfgs=17, n_members=4)
    sharded = TorchShardedRankState(hours, mask, prices.copy(), ids,
                                    devices=cpu(n), capacity=4)
    live = prices.copy()

    def tick():
        deltas = _random_deltas(rng, live, ids)
        sharded.reprice(deltas)
        _apply(live, deltas)

    sharded.add_state("all", rows=members["all"])
    tick()
    sharded.add_state("m0", rows=members["m0"])     # post-tick add
    tick()
    for key in ("all", "m0"):
        assert_within_contract(sharded.ranking(key), rank_dense(
            hours[members[key]], mask[members[key]], live, ids))
    assert sharded.realloc_count == 0
    for key in ("all", "m0"):
        sharded.retire_state(key)
    assert sharded.n_active == 0 and sharded.keys() == []
    with pytest.raises(NothingRankableError, match="retired"):
        sharded.ranking("m0")
    with pytest.raises(NothingRankableError, match="retired"):
        sharded.top_k("m0", 1)
    with pytest.raises(ValueError, match="unknown member"):
        sharded.ranking("never-registered")
    for key in ("all", "m0"):
        sharded.add_state(key, rows=members[key])
    assert sharded.realloc_count == 0               # reuse, not growth
    assert "m0" in sharded and "ghost" not in sharded
    # the revived member equals a cold build at the live prices, bitwise:
    # both seed from the same float32 quotes and the same row minima
    cold = TorchShardedRankState(hours, mask, sharded.prices, ids,
                                 devices=cpu(n))
    cold.add_state("m0", rows=members["m0"])
    assert np.array_equal(sharded.scores("m0"), cold.scores("m0"))
    np.testing.assert_array_equal(sharded.counts("m0"),
                                  mask[members["m0"]].sum(axis=0))
    for i in range(5):
        sharded.add_state(f"late{i}", rows=[int(r) for r in
                                            rng.choice(12, 3,
                                                       replace=False)])
    assert sharded.realloc_count == 1               # 4 -> 8
    tick()
    for key in ("all", "m0"):
        assert_within_contract(sharded.ranking(key), rank_dense(
            hours[members[key]], mask[members[key]], live, ids))


def test_sharded_validates_members_deltas_and_devices():
    """The reference's errors for members and deltas, raised before
    anything changes; ``devices=`` read as the reference reads it, and no
    CUDA path carries on without a card."""
    rng, hours, mask, prices, ids, _ = _fleet_universe(3, n_jobs=4,
                                                       n_cfgs=6)
    s = TorchShardedRankState(hours, mask, prices, ids, devices=cpu(2),
                              job_ids=[f"j{i}" for i in range(4)])
    s.add_state("a", rows=[0, 1])
    before = s.scores("a")
    with pytest.raises(ValueError, match="duplicate member"):
        s.add_state("a", rows=[2])
    with pytest.raises(ValueError, match="exactly one of"):
        s.add_state("b", rows=[0], jobs=["j0"])
    with pytest.raises(ValueError, match="unknown job id"):
        s.add_state("b", jobs=["ghost"])
    with pytest.raises(ValueError, match="out of range"):
        s.add_state("b", rows=[99])
    with pytest.raises(ValueError, match="unknown member"):
        s.retire_state("ghost")
    with pytest.raises(ValueError, match="unknown config id"):
        s.reprice({"ghost": 1.0})
    with pytest.raises(ValueError, match="non-positive"):
        s.reprice({ids[0]: -1.0, ids[1]: 2.0})
    assert s.reprice({}) == 0
    assert s.reprices == s.dispatches == 0
    assert np.array_equal(s.scores("a"), before)
    for bad in (0, -1, []):
        with pytest.raises(ValueError, match="devices"):
            TorchShardedRankState(hours, mask, prices, ids, devices=bad)
    if not torch.cuda.is_available():
        for asked in (None, 1, 2, "cuda", ["cuda:0"], ["cpu", "cuda"]):
            with pytest.raises(BackendUnavailableError):
                TorchShardedRankState(hours, mask, prices, ids,
                                      devices=asked)
    s1 = TorchShardedRankState(hours, mask, prices, ids, devices="cpu")
    assert s1.n_devices == 1 and s1.devices == (torch.device("cpu"),)


# --- the half-tick wrappers, split by columns ------------------------------------------

def _tick_tensors(seed, J, C, S, n_changed):
    rng = np.random.default_rng(seed)
    hours = rng.uniform(0.5, 4.0, (J, C)).astype(np.float32)
    mask = rng.random((J, C)) > 0.2
    mask[J - 1] = False                      # a row with no profiled cell
    hours = np.where(mask, hours, 1.0).astype(np.float32)
    oldp = rng.uniform(0.1, 2.0, (1, C)).astype(np.float32)
    newp = oldp.copy()
    cols = rng.choice(C, n_changed, replace=False)
    newp[0, cols] = (newp[0, cols] * rng.uniform(0.4, 1.6, n_changed)
                     ).astype(np.float32)
    changed = np.zeros((1, C), np.float32)
    changed[0, cols] = 1.0
    t = {k: torch.from_numpy(v) for k, v in dict(
        hours=hours, mask=mask, oldp=oldp, newp=newp, changed=changed,
        rm=(rng.random((S, J)) > 0.5).astype(np.float32)).items()}
    t["rb"] = torch.where(t["mask"], t["hours"] * t["oldp"],
                          torch.tensor(float("inf"))).amin(1, keepdim=True)
    norm = torch.where(t["mask"], (t["hours"] * t["oldp"]) / t["rb"],
                       torch.zeros(()))
    t["scores"] = t["rm"] @ norm
    return t


@pytest.mark.parametrize("C", [37, 100])
@pytest.mark.parametrize("D", [1, 2, 3, 4])
def test_half_tick_split_by_columns_matches_the_whole_tick(D, C):
    """``row_minima`` on each column block, the min across blocks and
    ``fold_scores`` on each block against ``fused_reprice`` over all C:
    row minima and the handoff count bitwise, scores within the contract
    (the plain fold's member sums may round per width)."""
    t = _tick_tensors(D * 100 + C, J=9, C=C, S=5, n_changed=C // 5)
    whole, rb_whole, moved_whole = rd.fused_reprice(
        t["hours"], t["mask"], t["oldp"], t["newp"], t["changed"], t["rb"],
        t["rm"], t["scores"])
    width = -(-C // D)
    blocks = [slice(lo, min(lo + width, C)) for lo in range(0, C, width)]

    def part(name, b):
        return t[name][:, b].contiguous()

    partial = [rd.row_minima(part("hours", b), part("mask", b),
                             part("newp", b), t["rb"])[0] for b in blocks]
    rb = partial[0]
    for p in partial[1:]:
        rb = torch.minimum(rb, p)
    assert torch.equal(rb, rb_whole)
    assert int((rb != t["rb"]).sum()) == int(moved_whole)
    out = torch.cat([rd.fold_scores(
        part("hours", b), part("mask", b), part("oldp", b), part("newp", b),
        part("changed", b), t["rb"], rb, t["rm"], part("scores", b))
        for b in blocks], dim=1)
    both_inf = torch.isinf(out) & torch.isinf(whole)
    err = (out - whole).abs()
    tol = CONTRACT.abs_tol + CONTRACT.rel_tol * torch.maximum(out.abs(),
                                                              whole.abs())
    assert bool(((err <= tol) | both_inf).all())
    if D == 1:
        assert torch.equal(out, whole)


def test_half_tick_wrappers_compose_to_the_tick_and_check_arguments():
    """``fused_reprice`` is ``row_minima`` then ``fold_scores``, bitwise;
    each half refuses what ``fused_reprice`` refuses."""
    t = _tick_tensors(5, J=7, C=23, S=3, n_changed=4)
    args = (t["hours"], t["mask"], t["oldp"], t["newp"], t["changed"],
            t["rb"], t["rm"], t["scores"])
    out, rb, moved = rd.fused_reprice(*args)
    rb2, moved2 = rd.row_minima(t["hours"], t["mask"], t["newp"], t["rb"])
    out2 = rd.fold_scores(t["hours"], t["mask"], t["oldp"], t["newp"],
                          t["changed"], t["rb"], rb2, t["rm"], t["scores"])
    assert torch.equal(rb, rb2) and torch.equal(moved, moved2)
    assert torch.equal(out, out2)
    with pytest.raises(ValueError, match="row_best"):
        rd.row_minima(t["hours"], t["mask"], t["newp"], t["rb"][:3])
    with pytest.raises(TypeError, match="new_prices"):
        rd.row_minima(t["hours"], t["mask"], t["newp"].double(), t["rb"])
    with pytest.raises(ValueError, match="rb_new"):
        rd.fold_scores(t["hours"], t["mask"], t["oldp"], t["newp"],
                       t["changed"], t["rb"], rb2[:2], t["rm"], t["scores"])
    with pytest.raises(ValueError, match="scores"):
        rd.fold_scores(t["hours"], t["mask"], t["oldp"], t["newp"],
                       t["changed"], t["rb"], rb2, t["rm"],
                       t["scores"][:, :5].contiguous())


# --- the k boundaries ----------------------------------------------------------------

def _k_boundary_cases(C):
    return (C - 1, C, C + 1, 10 * C)


@pytest.mark.parametrize("n_cfgs", [12, 13])
def test_k_boundary_parity_with_ties(n_cfgs):
    """k in {C-1, C, C+1, 10·C} at every shard count: the sharded head is
    exactly the head of its own ranking, boundary ties included (the tie
    universe clones its last three profiled columns, which the 8-shard
    split puts on different shards), and within the contract of the
    numpy head; the clones resolve in catalog order."""
    hours, mask, prices, ids = _universe_with_ties(n_cfgs=n_cfgs)
    C = len(ids)
    ref = RankState(hours, mask, prices, ids).ranking()
    clones = [ids[C - 3], ids[C - 2], ids[C - 1]]
    for n in SHARD_COUNTS:
        s = TorchShardedRankState(hours, mask, prices, ids, devices=cpu(n))
        s.add_state("all", rows=list(range(hours.shape[0])))
        for k in _k_boundary_cases(C):
            head = s.top_k("all", k)
            assert head == s.ranking("all")[:min(k, C)], (n, k)
            assert_within_contract(head, ref)
            got = [r.config_id for r in head if r.config_id in clones]
            assert got == clones[:len(got)], (n, k, got)


@pytest.mark.parametrize("n", SHARD_COUNTS)
def test_sharded_top_k_boundary_after_ticks(n):
    """The merge stays exact through ticks that move the row minima:
    every boundary k serves exactly the ranking's head."""
    hours, mask, prices, ids = _universe_with_ties(n_cfgs=13)
    C = len(ids)
    s = TorchShardedRankState(hours, mask, prices, ids, devices=cpu(n))
    s.add_state("all", rows=list(range(hours.shape[0])))
    s.add_state("head", rows=[0, 1])
    for deltas in ({ids[3]: 0.01}, {ids[7]: 40.0, ids[1]: 0.2},
                   {ids[C - 3]: 0.5, ids[C - 2]: 0.5, ids[C - 1]: 0.5}):
        s.reprice(deltas)
        for key in ("all", "head"):
            full = s.ranking(key)
            for k in (1, 3) + _k_boundary_cases(C):
                assert s.top_k(key, k) == full[:min(k, C)], (key, k)
            assert s.winner(key) == full[0]
        assert s.heads(["head", "all", "head"], 4) == [
            s.ranking("head")[:4], s.ranking("all")[:4],
            s.ranking("head")[:4]]
    for bad in (0, -1, 1.5, True):
        with pytest.raises(ValueError, match="positive integer"):
            s.top_k("all", bad)


# --- the reference at 2 and 8 devices, in a subprocess --------------------------------

#: the reference side: ShardedBatchedRankState at each device count over
#: the cases the parent wrote, each member's scores, handoff count and
#: 3-head written after every tick
CHILD = r"""
import sys
import numpy as np
from repro.selector import ShardedBatchedRankState
src, out = sys.argv[1], sys.argv[2]
cases = np.load(src)
res = {}
for n in (2, 8):
    for c in range(int(cases["n_cases"])):
        p = f"c{c}_"
        hours, mask = cases[p + "hours"], cases[p + "mask"]
        ids = [f"c{i}" for i in range(hours.shape[1])]
        s = ShardedBatchedRankState(hours, mask, cases[p + "prices"], ids,
                                    devices=n)
        rows = cases[p + "members"]
        for m, r in enumerate(rows):
            s.add_state(m, rows=np.flatnonzero(r).tolist())
        for t in range(int(cases[p + "ticks"])):
            cols, prices = cases[p + f"t{t}_cols"], cases[p + f"t{t}_prices"]
            q = f"n{n}_c{c}_t{t}_"
            res[q + "moved"] = np.int64(s.reprice(
                {ids[i]: float(v) for i, v in zip(cols, prices)}))
            res[q + "scores"] = np.stack([s.scores(m)
                                          for m in range(len(rows))])
            res[q + "heads"] = np.asarray(
                [[ids.index(r.config_id) for r in s.top_k(m, 3)]
                 for m in range(len(rows))])
np.savez(out, **res)
"""


@pytest.fixture(scope="module")
def reference_at_2_and_8(tmp_path_factory):
    """The seeded cases, and what the reference wrote for them at 2 and 8
    forced host devices."""
    tmp = tmp_path_factory.mktemp("sharded_reference")
    cases, arrays = [], {"n_cases": np.int64(3)}
    for c, seed in enumerate(range(3)):
        rng, hours, mask, prices, ids, members = _fleet_universe(
            seed, n_jobs=6 + seed, n_cfgs=13 + 4 * seed,
            partial=seed % 2 == 0)
        rows = np.zeros((len(members), hours.shape[0]), bool)
        for m, r in enumerate(members.values()):
            rows[m, r] = True
        live, ticks = prices.copy(), []
        for _ in range(5):
            deltas = _random_deltas(rng, live, ids)
            _apply(live, deltas)
            ticks.append(deltas)
        p = f"c{c}_"
        arrays.update({p + "hours": hours, p + "mask": mask,
                       p + "prices": prices, p + "members": rows,
                       p + "ticks": np.int64(len(ticks))})
        for t, deltas in enumerate(ticks):
            arrays[p + f"t{t}_cols"] = np.asarray(
                [int(k[1:]) for k in deltas], np.int64)
            arrays[p + f"t{t}_prices"] = np.asarray(list(deltas.values()))
        cases.append((hours, mask, prices, ids, rows, ticks))
    np.savez(tmp / "cases.npz", **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(tmp / "cases.npz"),
         str(tmp / "reference.npz")], capture_output=True, text=True,
        timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return cases, dict(np.load(tmp / "reference.npz"))


@pytest.mark.parametrize("case", range(3))
@pytest.mark.parametrize("n", [2, 8])
def test_port_matches_reference_at_2_and_8_devices(reference_at_2_and_8,
                                                   n, case):
    """At the reference's device count, tick by tick: the same handoff
    count, every member's ranking within the contract of the reference's
    scores, and each 3-head's scores within the contract of the
    reference's head at the same rank."""
    cases, ref = reference_at_2_and_8
    hours, mask, prices, ids, rows, ticks = cases[case]
    s = TorchShardedRankState(hours, mask, prices.copy(), ids,
                              devices=cpu(n))
    for m, r in enumerate(rows):
        s.add_state(m, rows=np.flatnonzero(r).tolist())
    for t, deltas in enumerate(ticks):
        q = f"n{n}_c{case}_t{t}_"
        assert s.reprice(deltas) == int(ref[q + "moved"])
        for m in range(len(rows)):
            want = _materialize(ref[q + "scores"][m], s.counts(m), ids)
            got = s.ranking(m)
            assert_within_contract(got, want)
            want_score = {r.config_id: r.score for r in want}
            for g, i in zip(s.top_k(m, 3), ref[q + "heads"][m]):
                assert CONTRACT.scores_match(g.score, want_score[ids[i]])
    assert s.dispatches == len(ticks)


# --- hypothesis property half ---------------------------------------------------------

if HAVE_HYPOTHESIS:
    @settings(max_examples=12, deadline=None)
    @given(fleet_streams(), st.sampled_from(SHARD_COUNTS))
    def test_sharded_fleet_within_contract_property(data, n):
        """For any fleet and reprice stream: torch_sharded within the
        contract of the cold rank and of every other fleet, per tick."""
        jobs, cfgs, rt, prices, stream, members = data
        hours = np.asarray([[rt[(j, c)] for c in cfgs] for j in jobs])
        mask = np.ones_like(hours, dtype=bool)
        pv = np.asarray([prices[c] for c in cfgs])
        fleets = _fleets(hours, mask, pv, cfgs, members, n)
        live = pv.copy()
        for deltas in stream:
            moved = [fleet.reprice(deltas) for fleet in fleets]
            assert moved == [moved[0]] * len(fleets)
            for c, p in deltas.items():
                live[cfgs.index(c)] = p
            _assert_parity(fleets, members, hours, mask, live, cfgs)

    @settings(max_examples=10, deadline=None)
    @given(event_markets(), st.sampled_from(SHARD_COUNTS))
    def test_sharded_event_market_within_contract_property(market, n):
        """Event-bearing bursts through the sharded fleet stay within the
        contract of the cold rank at every shard count."""
        cfgs, base, events, seed, change_fraction, n_ticks, jobs, rt = \
            market
        hours = np.asarray([[rt[(j, c)] for c in cfgs] for j in jobs])
        mask = np.ones_like(hours, dtype=bool)
        live = np.asarray([base[c] for c in cfgs])
        members = {"all": list(range(len(jobs)))}
        fleets = _fleets(hours, mask, live, cfgs, members, n)
        feed = _event_feed(base, events, seed, change_fraction)
        for t in range(n_ticks):
            batch = feed.poll(t)
            if not batch:
                continue
            deltas = {d.config_id: d.price for d in batch}
            for fleet in fleets:
                fleet.reprice(deltas)
            for d in batch:
                live[cfgs.index(d.config_id)] = d.price
            _assert_parity(fleets, members, hours, mask, live, cfgs)
else:
    @pytest.mark.skip(reason="hypothesis not installed (property half "
                             "of the sharded parity suite)")
    def test_sharded_parity_properties_skipped():
        pass  # pragma: no cover


# --- service, daemon, front-end, sweep ------------------------------------------------

def _service(backend, serve_top_k=None, n_cfgs=16, seed=1, shards=2):
    """``test_batched_parity._fleet_service``'s universe on the port."""
    rng = np.random.default_rng(seed)
    ids = [f"c{i}" for i in range(n_cfgs)]
    store = ProfilingStore(config_ids=ids)
    for j in range(8):
        klass = JobClass.A if j % 2 else JobClass.B
        for c in ids:
            store.add(f"j{j}", c, float(rng.uniform(0.1, 5.0)),
                      job_class=klass, group=f"g{j % 4}")
    table = PriceTable({c: float(rng.uniform(1.0, 20.0)) for c in ids})
    return SelectionService(IdentityCatalog(ids), store, table,
                            backend=backend, serve_top_k=serve_top_k,
                            device=cpu(shards))


def test_service_torch_sharded_backend_one_dispatch_per_tick():
    """A torch_sharded service stacks every live (class, exclusion)
    ranking into one TorchShardedRankState: a tick refreshes the whole
    fleet in one dispatch, within the contract of a numpy service."""
    svc, ref = _service("torch_sharded"), _service("numpy")
    assert svc.device == (torch.device("cpu"),) * 2 and ref.device is None
    selections = [("j1", None), ("j2", None), ("j1", ("g2",)),
                  ("j2", ("g3",))]
    for job, excl in selections:
        assert_within_contract(
            list(svc.submit(job, exclude_groups=excl).ranking),
            list(ref.submit(job, exclude_groups=excl).ranking))
    assert isinstance(svc._batched, TorchShardedRankState)
    assert svc._batched.n_active == 4 and svc._batched.n_devices == 2
    deltas = {f"c{i}": float(0.5 + i) for i in range(0, 16, 3)}
    assert svc.reprice(deltas) == 4          # whole fleet refreshed...
    assert svc.reprice_dispatches == 1       # ...in one dispatch
    assert svc._batched.dispatches == 1
    ref.reprice(deltas)
    for job, excl in selections:
        assert_within_contract(
            list(svc.submit(job, exclude_groups=excl).ranking),
            list(ref.submit(job, exclude_groups=excl).ranking))
    svc.reprice({"c1": 9.0})
    assert svc.reprice_dispatches == 2
    d = svc.submit("j1", top_k=3)
    assert d.served_via == "top_k"
    assert tuple(d.ranking) == tuple(svc.submit("j1").ranking[:3])
    # two live routes' heads at once (j1's own group is excluded)
    routes = [(JobClass.A, ("g1",)), (JobClass.B, ("g3",))]
    for (head, hit), route in zip(svc.rank_heads(routes, k=2), routes):
        assert hit and head == svc.rank(*route)[:2]


def test_sharded_service_survives_out_of_band_table_apply():
    """An out-of-band PriceTable.apply drops the sharded universe for a
    cold rebuild instead of serving quotes it never saw."""
    svc, ref = _service("torch_sharded"), _service("numpy")
    svc.submit("j1")
    ref.submit("j1")
    svc.price_source.apply({"c2": 0.333})
    ref.price_source.apply({"c2": 0.333})
    deltas = {"c5": 7.7}
    assert svc.reprice(deltas) == 0          # fleet dropped, not repriced
    ref.reprice(deltas)
    assert_within_contract(list(svc.submit("j1").ranking),
                           list(ref.submit("j1").ranking))


def test_sharded_daemon_journal_audits_in_tolerance_mode():
    """A torch_sharded daemon stamps its backend in the journal header;
    the port's replayer audits it clean under the backend's contract, and
    the reference's under its own sharded contract."""
    rng = np.random.default_rng(9)
    ids = [f"c{i}" for i in range(13)]
    store = ProfilingStore(config_ids=ids)
    for j in range(8):
        klass = JobClass.A if j % 2 else JobClass.B
        for c in ids:
            store.add(f"j{j}", c, float(rng.uniform(0.1, 5.0)),
                      job_class=klass, group=f"g{j % 4}")
    base = {c: float(rng.uniform(1.0, 20.0)) for c in ids}
    svc = SelectionService(IdentityCatalog(ids), store, PriceTable(base),
                           backend="torch_sharded", serve_top_k=3,
                           device=cpu(8))
    daemon = SelectionDaemon(svc, SimulatedSpotFeed(base, seed=4,
                                                    change_fraction=0.4))
    for event in synthetic_stream([f"j{i}" for i in range(8)], 60,
                                  seed=7, tick_fraction=0.25):
        daemon.handle(event)
    assert svc.reprice_dispatches == svc._batched.dispatches > 0
    journal = daemon.journal_dump()
    assert json.loads(journal.splitlines()[0])["backend"] == "torch_sharded"
    replayer = JournalReplayer(store, journal)
    assert replayer.backend == "torch_sharded"
    assert not score_contract(replayer.backend).bit_identical
    audit = replayer.audit()
    assert audit.ok, audit.mismatches[:3]
    assert audit.decisions > 0
    ref_audit = RefReplayer(RefStore.loads_jsonl(store.dump_jsonl()),
                            journal).audit(contract=ref_contract(
                                "jax_sharded"))
    assert ref_audit.ok, ref_audit.mismatches[:3]
    assert ref_audit.decisions == audit.decisions


def test_sharded_frontend_is_one_select_a_shard_per_snapshot(monkeypatch):
    """A ServeFrontend over a 2-shard service: each published snapshot
    costs one k-head call a shard whatever the number of routes (the
    plain version of ``select`` here; one launch a shard on the card), a
    forwarded submission one a shard, and the merged journal audits
    clean."""
    calls = []
    plain = rd.select_heads_plain

    def counted(scores, finite, k):
        calls.append(scores.shape[0])
        return plain(scores, finite, k)

    monkeypatch.setattr(rd, "select_heads_plain", counted)
    store, ids, base = _frontend_universe()
    svc = SelectionService(IdentityCatalog(ids), store, PriceTable(base),
                           backend="torch_sharded", serve_top_k=3,
                           device=cpu(2))
    fe = ServeFrontend(svc, _recorded(base, n_ticks=8), workers=2)
    warm = [Submission(j, exclude_groups=e) for j, e in
            (("j1", None), ("j2", None), ("j3", None), ("j4", None),
             ("j1", ("g2",)))]
    fe.warm(warm)
    assert len(calls) == 2 * len(warm)        # cold builds, one a shard
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
    assert len(calls) == 2 * (published + 1)
    assert max(calls) > 1                     # many member rows at once
    audit = JournalReplayer(store, fe.journal_dump()).audit()
    assert audit.ok, audit.mismatches[:3]
    assert audit.contract.backend == "torch_sharded"


def test_sweep_on_torch_sharded_audits_clean_and_tracks_numpy():
    """The turbulence grid on the small universe at 2 shards: every point
    audits clean, with numpy's decisions and epochs and its deviations
    within rel 1e-4."""
    store, ids, base = _sweep_universe()
    points = run_sweep(
        lambda b: SelectionService(IdentityCatalog(ids), store,
                                   PriceTable(base), backend=b,
                                   device=cpu(2)),
        base, list(_sweep_stream(30)), backends=["numpy", "torch_sharded"],
        seed=6)
    by = {(p.preset, p.backend): p for p in points}
    for name in {p.preset for p in points}:
        got, want = by[name, "torch_sharded"], by[name, "numpy"]
        assert got.audit_ok, (name, got.audit_mismatches)
        assert got.decisions == want.decisions and got.epochs == want.epochs
        assert got.mean_deviation == pytest.approx(want.mean_deviation,
                                                   rel=1e-4, abs=1e-12)


def test_calm_point_on_the_paper_universe_equals_numpy():
    """The turbulence bench's calm point (the paper's universe, 400
    events, the bundled fixture) at 2 shards: audit-clean, with the same
    mean deviation as numpy's, exactly."""
    trace = spark_sim.generate_trace(seed=0)
    store = ProfilingStore.from_trace(trace)
    catalog = GcpVmCatalog(trace.configs, costmodel.LinearPriceModel())
    events = list(synthetic_stream([j.name for j in trace.jobs], 400,
                                   seed=3, tick_fraction=0.15))
    points = {}
    for backend in ("numpy", "torch_sharded"):
        svc = SelectionService(catalog, store,
                               PriceTable.from_catalog(catalog),
                               backend=backend, device=cpu(2))
        points[backend] = run_point(
            svc, RecordedPriceFeed.load(FIXTURE), events,
            preset_name="calm", truth=RecordedPriceFeed.load(FIXTURE))
    got, want = points["torch_sharded"], points["numpy"]
    assert got.audit_ok and got.backend == "torch_sharded"
    assert got.mean_deviation == want.mean_deviation
    assert got.decisions == want.decisions
