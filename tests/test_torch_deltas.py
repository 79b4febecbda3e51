"""The fleet tick's deltas as (column, price) pairs.

``TorchFusedRankState`` validates a delta batch on the host into (int32
column, float32 price) pairs, which ``scatter_prices`` uploads in one copy
and scatters on the device into the tick's ``(1, C)`` new prices and
changed-column flags.  Here, on the CPU (``device="cpu"``), that path is
held against the reference's dense densify
(``PallasBatchedRankState._dense_tick``, built on
``repro.selector.rank._validated_deltas``) bit for bit, against the
reference's errors message for message, and against a dense tick built
by hand; a tick that raises leaves the state as it was.
"""
import numpy as np
import pytest
import torch

from repro.selector import PallasBatchedRankState
from repro.selector.rank import _validated_deltas as ref_validated_deltas
from repro_torch.kernels import rank_delta as rd
from repro_torch.selector import TorchFusedRankState
from repro_torch.selector import fused_rank
from repro_torch.selector.rank import _validated_deltas


def _universe(seed, J=7, C=40, n_members=3):
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


def _port(hours, mask, prices, ids, members):
    port = TorchFusedRankState(hours, mask, prices.copy(), ids,
                               device="cpu")
    for key, rows in members.items():
        port.add_state(key, rows=rows)
    return port


def _seeded_deltas(rng, live, ids):
    """A dict, or a sequence of pairs with duplicates (the last wins) and
    a price set to its current value."""
    C = len(ids)
    cols = rng.choice(C, int(rng.integers(1, C + 1)), replace=False)
    pairs = [(ids[c], float(live[c] * rng.uniform(0.5, 2.0))) for c in cols]
    if rng.random() < 0.5:
        return dict(pairs)
    dup, last = int(cols[0]), int(cols[-1])
    return pairs + [(ids[dup], 77.0), (ids[last], float(live[last])),
                    (ids[dup], float(live[dup] * 1.5))]


def _scattered(port, deltas):
    """The pair path's device vectors for ``deltas``: ``(new_p, changed)``
    as numpy."""
    d_newp, changed = rd.scatter_prices(*port._pairs(deltas), port.d_prices)
    return d_newp.numpy(), changed.numpy()


def _snapshot(port):
    return (port.prices.copy(), port.d_prices.clone(),
            port.d_row_best.clone(), port.d_scores.clone(), port.reprices,
            port.dispatches, {k: port.scores(k) for k in port.keys()})


def _assert_unchanged(port, snap):
    prices, d_prices, rb, scores, reprices, dispatches, members = snap
    assert np.array_equal(port.prices, prices)
    assert torch.equal(port.d_prices, d_prices)
    assert torch.equal(port.d_row_best, rb)
    assert torch.equal(port.d_scores, scores)
    assert (port.reprices, port.dispatches) == (reprices, dispatches)
    for key, row in members.items():
        assert np.array_equal(port.scores(key), row)


@pytest.mark.parametrize("seed", range(4))
def test_scatter_equals_reference_densify(seed):
    """Tick after tick, the scattered ``new_p`` and ``changed`` equal the
    reference's dense ``(1, C)`` vectors bit for bit, and the pairs are
    the reference's ``_validated_deltas`` columns and float32 prices."""
    rng, hours, mask, prices, ids, members = _universe(seed)
    port = _port(hours, mask, prices, ids, members)
    ref = PallasBatchedRankState(hours, mask, prices.copy(), ids)
    live = port.prices
    for _ in range(6):
        deltas = _seeded_deltas(rng, live, ids)
        newp_ref, changed_ref = ref._dense_tick(deltas)
        ref_cols, ref_prices = ref_validated_deltas(ref._pos, deltas)
        cols, new = port._pairs(deltas)
        assert np.array_equal(cols, ref_cols)
        assert np.array_equal(new, ref_prices.astype(np.float32))
        newp, changed = _scattered(port, deltas)
        assert np.array_equal(newp.view(np.int32), newp_ref.view(np.int32))
        assert np.array_equal(changed, changed_ref)
        port.reprice(deltas)
        ref._host_prices = newp_ref     # the reference's commit, no kernel
        live = port.prices
        assert np.array_equal(live, ref.prices)


def test_pair_tick_equals_dense_tick_bitwise():
    """The whole pair tick against the dense tick built by hand from the
    reference's densify: scores, row minima, prices and moved bit for
    bit, with duplicates and a price at its current value."""
    rng, hours, mask, prices, ids, members = _universe(3, J=9, C=57)
    port = _port(hours, mask, prices, ids, members)
    ref = PallasBatchedRankState(hours, mask, prices.copy(), ids)
    for _ in range(5):
        deltas = _seeded_deltas(rng, port.prices, ids)
        newp, changed = ref._dense_tick(deltas)
        want = rd.fused_reprice(
            port.d_hours, port.d_mask, port.d_prices,
            torch.from_numpy(newp), torch.from_numpy(changed),
            port.d_row_best, port.d_row_masks, port.d_scores)
        moved = port.reprice(deltas)
        ref._host_prices = newp
        for got, exp in zip((port.d_scores, port.d_row_best),
                            want[:2]):
            assert torch.equal(got.view(torch.int32), exp.view(torch.int32))
        assert moved == int(want[2])
        assert np.array_equal(port.d_prices.numpy(), newp)


#: batches the reference rejects, in the order it checks: ids first, then
#: the first bad price in table order
BAD_BATCHES = {
    "unknown id": {"ghost": 1.0},
    "unknown after good": [("c1", 2.0), ("nope", 3.0)],
    "zero": {"c2": 0.0},
    "negative": {"c3": -1.0},
    "nan": {"c4": float("nan")},
    "inf": {"c5": float("inf")},
    "-inf": {"c6": float("-inf")},
    "first bad in table order": [("c1", 2.0), ("c7", -3.0), ("c8", 0.0)],
    "unknown beats bad price": [("c7", -3.0), ("ghost", 1.0)],
    "bad duplicate wins": [("c9", 2.0), ("c9", float("nan"))],
}


@pytest.mark.parametrize("name", list(BAD_BATCHES))
def test_errors_match_reference_and_leave_state(name):
    """Every batch the reference rejects raises the same ``ValueError``
    message from ``reprice`` and ``reprice_with_heads``, before anything
    is uploaded or changed: prices, scores, row minima and the tick
    counts stay as they were."""
    rng, hours, mask, prices, ids, members = _universe(5)
    port = _port(hours, mask, prices, ids, members)
    port.reprice({ids[0]: 3.25})                      # mid-stream
    bad = BAD_BATCHES[name]
    with pytest.raises(ValueError) as want:
        ref_validated_deltas(port._pos, bad)
    with pytest.raises(ValueError) as got:
        _validated_deltas(port._pos, bad)
    assert str(got.value) == str(want.value)
    snap = _snapshot(port)
    with pytest.raises(ValueError) as got:
        port.reprice(bad)
    assert str(got.value) == str(want.value)
    _assert_unchanged(port, snap)
    with pytest.raises(ValueError) as got:
        port.reprice_with_heads(bad, 3)
    assert str(got.value) == str(want.value)
    _assert_unchanged(port, snap)


@pytest.mark.parametrize("empty", [{}, []])
def test_empty_batch_is_no_tick(empty):
    """An empty batch (a dict or a sequence) dispatches nothing and
    changes nothing; with heads it serves ``top_k`` as it stands."""
    assert _validated_deltas({}, empty) is None
    rng, hours, mask, prices, ids, members = _universe(6)
    port = _port(hours, mask, prices, ids, members)
    snap = _snapshot(port)
    assert port.reprice(empty) == 0
    moved, heads = port.reprice_with_heads(empty, 4)
    assert moved == 0 and heads["all"] == port.top_k("all", 4)
    _assert_unchanged(port, snap)


def test_duplicate_pairs_resolve_to_the_last():
    """A sequence with one id three times gives that column once, at the
    last price, and ticks bit for bit like the collapsed dict."""
    rng, hours, mask, prices, ids, members = _universe(8)
    a = _port(hours, mask, prices, ids, members)
    b = _port(hours, mask, prices, ids, members)
    dup = [(ids[4], 9.5), (ids[11], 0.75), (ids[4], 1.25), (ids[4], 2.5)]
    cols, new = a._pairs(dup)
    assert cols.tolist() == [4, 11]
    assert new.tolist() == [2.5, 0.75]
    assert a.reprice(dup) == b.reprice({ids[4]: 2.5, ids[11]: 0.75})
    assert a.prices[4] == np.float32(2.5)
    for key in members:
        assert np.array_equal(a.scores(key), b.scores(key))


def test_price_at_its_current_value_is_still_changed():
    """A delta that sets a price to what it is marks its column changed
    (the fold re-reduces it) and leaves the price vector as it was."""
    rng, hours, mask, prices, ids, members = _universe(9)
    port = _port(hours, mask, prices, ids, members)
    same = {ids[6]: float(port.prices[6]), ids[30]: float(port.prices[30])}
    newp, changed = _scattered(port, same)
    assert np.array_equal(newp, port.d_prices.numpy())
    assert np.flatnonzero(changed[0]).tolist() == [6, 30]


def test_prices_match_after_20_ticks():
    """After 20 seeded ticks (dicts and duplicate-laden sequences) the
    host mirror, the device prices and the float32 quotes applied in
    order all agree exactly."""
    rng, hours, mask, prices, ids, members = _universe(10, C=64)
    port = _port(hours, mask, prices, ids, members)
    quotes = prices.astype(np.float32)
    for tick in range(20):
        deltas = _seeded_deltas(rng, port.prices, ids)
        for cid, p in (deltas.items() if isinstance(deltas, dict)
                       else deltas):
            quotes[int(cid[1:])] = np.float32(p)
        if tick % 2:
            port.reprice(deltas)
        else:
            port.reprice_with_heads(deltas, 5)
    assert port.reprices == port.dispatches == 20
    assert np.array_equal(port.prices, quotes.astype(np.float64))
    assert np.array_equal(port.d_prices.numpy()[0], quotes)


@pytest.mark.parametrize("heads", [False, True])
def test_a_tick_whose_kernels_raise_leaves_the_state(monkeypatch, heads):
    """A tick that fails after its pairs were staged (the tick's
    kernels raise) leaves prices, scores, row minima and the tick counts
    on the device and the host as they were."""
    rng, hours, mask, prices, ids, members = _universe(12)
    port = _port(hours, mask, prices, ids, members)
    port.reprice({ids[2]: 1.5})

    def boom(*args, **kwargs):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(fused_rank, "tick_into", boom)
    snap = _snapshot(port)
    with pytest.raises(RuntimeError, match="launch failed"):
        if heads:
            port.reprice_with_heads({ids[3]: 4.0, ids[9]: 0.5}, 2)
        else:
            port.reprice({ids[3]: 4.0, ids[9]: 0.5})
    _assert_unchanged(port, snap)


@pytest.mark.parametrize("deltas", [
    {"c3": 2, "c0": np.float32(1.5), "c7": np.float64(0.25)},
    [("c1", 1.0), ("c2", "2.5"), ("c1", 3.0)],
    {"c39": 1e300},
], ids=["numbers", "string price and duplicates", "past float32"])
def test_validated_deltas_match_reference(deltas):
    """Ids resolved and prices converted without a Python step per delta
    give the reference's columns and float64 prices (ints, numpy scalars,
    numeric strings, and a finite price past float32's range)."""
    pos = {f"c{i}": i for i in range(40)}
    cols, new_prices = _validated_deltas(pos, deltas)
    ref_cols, ref_prices = ref_validated_deltas(pos, deltas)
    assert cols.dtype == np.int32
    assert cols.tolist() == ref_cols.tolist()
    assert np.array_equal(new_prices, ref_prices)
