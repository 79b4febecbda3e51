"""The fused fleet's tick on fixed buffers, as a CUDA graph replays it.

``TorchFusedRankState`` packs a tick's (column, price) pairs into a
staging slot (``rank_delta.pack_pairs``; on the card page-locked host
memory that kernel ``scatter`` reads when it runs) and ticks from one of
two fixed buffer sets into the other (``rank_delta.tick_into``), so the
card can replay one captured graph a direction.  Here, on the CPU, where
the same buffers and rotation run the plain versions eagerly, the
staging layout is held against its definition, the staged scatter
against the reference's densify (``PallasBatchedRankState._dense_tick``)
bit for bit, the rotation over many ticks against the eager tick on new
tensors (``scatter_prices`` then ``fused_reprice``) and against
``fused_reprice`` on the reference's dense vectors, and the rebinds and
invalidations against a grow, a retire, an add and tensors assigned from
outside.  The graphs themselves run on the card only
(``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

from repro.selector import PallasBatchedRankState
from repro_torch.kernels import rank_delta as rd
from repro_torch.selector import TorchFusedRankState
from repro_torch.selector import fused_rank


def _universe(seed, J=7, C=200, n_members=3):
    rng = np.random.default_rng(seed)
    hours = rng.uniform(0.05, 10.0, (J, C))
    mask = rng.random((J, C)) > 0.25
    mask[np.arange(J), rng.integers(0, C, J)] = True
    prices = rng.uniform(0.5, 20.0, C)
    ids = [f"c{i}" for i in range(C)]
    members = {"all": list(range(J))}
    for m in range(n_members - 1):
        members[f"m{m}"] = sorted(int(i) for i in rng.choice(
            J, int(rng.integers(1, J)), replace=False))
    return rng, hours, mask, prices, ids, members


def _port(hours, mask, prices, ids, members, capacity=None):
    port = TorchFusedRankState(hours, mask, prices.copy(), ids,
                               capacity=capacity, device="cpu")
    for key, rows in members.items():
        port.add_state(key, rows=rows)
    return port


def _deltas(rng, live, ids, n=None):
    """n distinct columns' new prices as a sequence with duplicates (the
    last wins) and a price at its current value."""
    C = len(ids)
    cols = rng.choice(C, int(rng.integers(1, C + 1)) if n is None else n,
                      replace=False)
    pairs = [(ids[c], float(live[c] * rng.uniform(0.5, 2.0))) for c in cols]
    if len(pairs) > 1:
        dup, last = int(cols[0]), int(cols[-1])
        pairs += [(ids[dup], 77.0), (ids[last], float(live[last])),
                  (ids[dup], float(live[dup] * 1.5))]
    return pairs


def _bits(t):
    return t.view(torch.int32)


def _eager_tick(port, pairs):
    """The tick as the fleet ran it on new tensors: ``scatter_prices``,
    then ``fused_reprice``, from the state's current tensors."""
    newp, changed = rd.scatter_prices(*pairs, port.d_prices.clone())
    scores, rb, moved = rd.fused_reprice(
        port.d_hours, port.d_mask, port.d_prices.clone(), newp, changed,
        port.d_row_best.clone(), port.d_row_masks, port.d_scores.clone())
    return scores, rb, newp, int(moved)


def _assert_tick(port, moved, want):
    scores, rb, newp, want_moved = want
    assert moved == want_moved
    assert torch.equal(_bits(port.d_scores), _bits(scores))
    assert torch.equal(_bits(port.d_row_best), _bits(rb))
    assert torch.equal(_bits(port.d_prices), _bits(newp))


def test_pack_pairs_layout():
    """A slot is ``1 + 2 cap`` int32 words: n in word 0, the columns from
    word 1, the prices' float32 bits from word ``1 + cap``; the rest is
    left as it was, and too many pairs raise before anything is
    written."""
    cap = 10
    slot = np.full(1 + 2 * cap, -7, np.int32)
    cols = np.array([9, 0, 4], np.int32)
    prices = np.array([0.5, 1 / 3, 1e30], np.float32)
    rd.pack_pairs(slot, cols, prices)
    assert slot[0] == 3
    assert slot[1:4].tolist() == [9, 0, 4]
    assert np.array_equal(slot[1 + cap:4 + cap], prices.view(np.int32))
    assert (slot[4:1 + cap] == -7).all() and (slot[4 + cap:] == -7).all()
    got_cols, got_prices = rd.staged_pairs(slot)
    assert np.array_equal(got_cols, cols)
    assert np.array_equal(got_prices.view(np.int32), prices.view(np.int32))
    rd.pack_pairs(slot, cols[:0], prices[:0])
    assert slot[0] == 0 and rd.staged_pairs(slot)[0].size == 0
    full = np.arange(cap, dtype=np.int32)
    with pytest.raises(ValueError, match="do not fit"):
        rd.pack_pairs(slot, np.arange(cap + 1, dtype=np.int32),
                      np.ones(cap + 1, np.float32))
    assert slot[0] == 0
    rd.pack_pairs(slot, full, full.astype(np.float32))
    assert slot[0] == cap


def test_cpu_staging_has_two_slots_and_moved_words():
    """The CPU staging: two numpy slots of the layout's size and a moved
    word a slot; filling waits on nothing."""
    staging = rd.PairStaging(5, torch.device("cpu"))
    assert len(staging.slots) == 2
    assert all(s.dtype == np.int32 and s.size == 11 for s in staging.slots)
    assert staging.moved.size == 2
    staging.fill(1, np.array([3], np.int32), np.array([2.5], np.float32))
    staging.release(1)
    staging.wait(1)
    assert rd.staged_pairs(staging.slots[1])[0].tolist() == [3]
    assert staging.slots[0][0] == 0


@pytest.mark.parametrize("n", ["0", "1", "C/100", "C"])
def test_staged_scatter_equals_reference_densify(n):
    """The pairs packed into a slot and scattered from it equal the
    reference's dense ``(1, C)`` price and changed vectors bit for bit,
    duplicates collapsed to the last; no pairs copy the prices and flag
    nothing."""
    rng, hours, mask, prices, ids, members = _universe(21)
    C = len(ids)
    port = _port(hours, mask, prices, ids, members)
    ref = PallasBatchedRankState(hours, mask, prices.copy(), ids)
    count = {"0": 0, "1": 1, "C/100": C // 100, "C": C}[n]
    slot = np.zeros(1 + 2 * C, np.int32)
    if count == 0:
        rd.pack_pairs(slot, np.zeros(0, np.int32), np.zeros(0, np.float32))
        newp, changed = rd.scatter_staged_plain(slot, port.d_prices)
        assert torch.equal(newp, port.d_prices) and not changed.any()
        return
    deltas = _deltas(rng, port.prices, ids, count)
    cols, new = port._pairs(deltas)
    assert cols.size == count
    rd.pack_pairs(slot, cols, new)
    newp, changed = rd.scatter_staged_plain(slot, port.d_prices)
    newp_ref, changed_ref = ref._dense_tick(deltas)
    assert np.array_equal(newp.numpy().view(np.int32),
                          newp_ref.view(np.int32))
    assert np.array_equal(changed.numpy(), changed_ref)


def test_rotation_matches_eager_and_dense_ticks_over_24_ticks():
    """24 ticks (every third with heads) through the two buffer sets: each
    tick's scores, row minima, prices and moved equal, bit for bit, the
    eager tick on new tensors from the same state and ``fused_reprice``
    on the reference's densified vectors; the sets and slots alternate,
    the state's tensors are always the current set's, and nothing is
    rebound or invalidated."""
    fused_rank.reset_graphs()
    rng, hours, mask, prices, ids, members = _universe(22, C=64)
    port = _port(hours, mask, prices, ids, members)
    ref = PallasBatchedRankState(hours, mask, prices.copy(), ids)
    sets = None
    for tick in range(24):
        deltas = _deltas(rng, port.prices, ids)
        pairs = port._pairs(deltas)
        eager = _eager_tick(port, pairs)
        newp, changed = ref._dense_tick(deltas)
        dense = rd.fused_reprice(
            port.d_hours, port.d_mask, port.d_prices, torch.from_numpy(newp),
            torch.from_numpy(changed), port.d_row_best, port.d_row_masks,
            port.d_scores)
        slot = port._cur
        if tick % 3 == 2:
            moved, heads = port.reprice_with_heads(deltas, 4)
            for key in members:
                assert heads[key] == port.ranking(key)[:4]
        else:
            moved = port.reprice(deltas)
        ref._host_prices = newp
        _assert_tick(port, moved, eager)
        _assert_tick(port, moved, dense[:2] + (torch.from_numpy(newp),
                                               int(dense[2])))
        sets = sets or port._sets
        assert port._sets is sets and port._cur == 1 - slot
        own = sets[port._cur]
        assert port.d_scores is own.scores
        assert port.d_row_best is own.row_best
        assert port.d_prices is own.prices
        assert rd.staged_pairs(port._staging.slots[slot])[0].tolist() == \
            pairs[0].tolist()
        assert port._staging.moved[slot] == moved
    assert port.reprices == port.dispatches == 24
    assert fused_rank.GRAPHS == {"captures": 0, "replays": 0, "rebinds": 0,
                                 "invalidations": 0}


def test_grow_retire_add_and_outside_assignment_keep_the_tick_exact():
    """Mid-stream: a retire and an add into the freed slot keep the sets;
    an add past the capacity grows the members, and the next tick makes
    new sets (an invalidation); the three tick tensors assigned from
    outside are copied into the state's own buffers (three rebinds), new
    ``d_row_masks`` invalidate.  Every tick equals the eager tick from
    the same state bit for bit."""
    fused_rank.reset_graphs()
    rng, hours, mask, prices, ids, members = _universe(23, C=48)
    port = _port(hours, mask, prices, ids, members, capacity=3)

    def tick():
        pairs = port._pairs(_deltas(rng, port.prices, ids))
        want = _eager_tick(port, pairs)
        _assert_tick(port, port.reprice(dict(zip(
            [ids[c] for c in pairs[0]], pairs[1].tolist()))), want)

    tick()
    tick()
    sets = port._sets
    port.retire_state("m0")
    tick()
    port.add_state("m9", rows=[0, 2, 5])
    tick()
    assert port._sets is sets and port.realloc_count == 0
    assert fused_rank.GRAPHS["invalidations"] == 0
    port.add_state("m10", rows=[1, 3])                # past the capacity
    assert port.realloc_count == 1
    tick()
    assert port._sets is not sets
    assert port._sets[0].scores.shape == (6, len(ids))
    assert fused_rank.GRAPHS == {"captures": 0, "replays": 0, "rebinds": 0,
                                 "invalidations": 1}
    tick()
    port.d_scores = port.d_scores.clone()
    port.d_row_best = port.d_row_best.clone()
    port.d_prices = port.d_prices.clone()
    tick()
    assert fused_rank.GRAPHS["rebinds"] == 3
    assert fused_rank.GRAPHS["invalidations"] == 1
    own = port._sets[port._cur]
    assert port.d_scores is own.scores and port.d_prices is own.prices
    port.d_row_masks = port.d_row_masks.clone()
    tick()
    assert fused_rank.GRAPHS["invalidations"] == 2
    port.retire_state("m9")
    port.add_state("m11", rows=[4])
    for _ in range(3):
        tick()
    assert fused_rank.GRAPHS == {"captures": 0, "replays": 0, "rebinds": 3,
                                 "invalidations": 2}
    for key in ("all", "m1", "m10", "m11"):
        want = TorchFusedRankState(hours, mask, port.prices, ids,
                                   device="cpu")
        want.add_state(key, rows={"all": list(range(7)), "m10": [1, 3],
                                  "m11": [4]}.get(key, members.get(key)))
        np.testing.assert_allclose(port.scores(key), want.scores(key),
                                   rtol=1e-4, atol=1e-6)


def test_a_select_that_raises_after_the_tick_leaves_the_state(monkeypatch):
    """``reprice_with_heads`` whose k-head raises after the tick has run
    into the other set leaves the state's tensors, prices and counts as
    they were, and the next tick is exact."""
    rng, hours, mask, prices, ids, members = _universe(24, C=40)
    port = _port(hours, mask, prices, ids, members)
    port.reprice({ids[1]: 2.0})
    snap = (port.prices.copy(), port.d_scores.clone(),
            port.d_row_best.clone(), port.d_prices.clone(), port.reprices,
            port._cur)

    def boom(*args, **kwargs):
        raise RuntimeError("select failed")

    with monkeypatch.context() as patched:
        patched.setattr(fused_rank, "select_heads", boom)
        with pytest.raises(RuntimeError, match="select failed"):
            port.reprice_with_heads({ids[3]: 4.0}, 2)
    assert np.array_equal(port.prices, snap[0])
    assert torch.equal(port.d_scores, snap[1])
    assert torch.equal(port.d_row_best, snap[2])
    assert torch.equal(port.d_prices, snap[3])
    assert (port.reprices, port._cur) == snap[4:]
    pairs = port._pairs({ids[3]: 4.0})
    want = _eager_tick(port, pairs)
    _assert_tick(port, port.reprice({ids[3]: 4.0}), want)
