"""The port on the card: each CUDA kernel against its plain PyTorch version,
the fleet state and service on CUDA against the same on the CPU, and a
reduced-config serving engine whose kernel counters move.

Every test here needs a CUDA device and carries the ``cuda`` marker; without
one it skips.  The file imports no JAX, so it runs on a machine with the
card alone:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rank_delta as rd
from repro_torch.kernels import rwkv6_scan as wk
from repro_torch.selector import fused_rank
from repro_torch.models import LM
from repro_torch.serve import Engine, Request
from repro_torch.selector import (IdentityCatalog, PriceTable,
                                  ProfilingStore, SelectionService,
                                  TorchFusedRankState, TorchShardedRankState,
                                  rank_dense, score_contract)

CONTRACT = score_contract("torch_fused")
REL, ABS = CONTRACT.rel_tol, CONTRACT.abs_tol

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run on the card only)")
    return torch.device("cuda")


def _tick_inputs(seed, J, C, S, n_changed, masked_rows=(), device="cpu"):
    """A masked universe mid-stream plus one tick's new prices, and each
    member's finite-config mask, as tensors on ``device``."""
    rng = np.random.default_rng(seed)
    hours = rng.uniform(0.5, 4.0, (J, C)).astype(np.float32)
    mask = rng.random((J, C)) > 0.2
    mask[list(masked_rows)] = False
    hours = np.where(mask, hours, 1.0).astype(np.float32)
    oldp = rng.uniform(0.1, 2.0, (1, C)).astype(np.float32)
    newp = oldp.copy()
    cols = rng.choice(C, size=n_changed, replace=False)
    newp[0, cols] = (newp[0, cols] * rng.uniform(0.4, 1.6, n_changed)
                     ).astype(np.float32)
    changed = np.zeros((1, C), np.float32)
    changed[0, cols] = 1.0
    cost_old = np.where(mask, hours * oldp, np.inf)
    rb_old = cost_old.min(axis=1, keepdims=True).astype(np.float32)
    with np.errstate(invalid="ignore"):
        norm_old = np.where(mask, cost_old / rb_old, 0.0).astype(np.float32)
    rm = (rng.random((S, J)) > 0.4).astype(np.float32)
    scores = (rm @ norm_old).astype(np.float32)
    fin = (rm @ mask.astype(np.float32)) > 0
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (hours, mask, oldp, newp, changed, rb_old, rm,
                           scores, fin))


@pytest.mark.parametrize("seed", range(3))
def test_cuda_kernels_match_plain_versions(cuda_device, seed):
    """Minima and moved bitwise, scores within the envelope, heads equal
    to the stable sort, an identity tick bitwise, one launch each."""
    *t, fin = _tick_inputs(30 + seed, J=13, C=300, S=7, n_changed=9,
                           masked_rows=(4,), device=cuda_device)
    before = dict(rd.LAUNCHES)
    s, rb, mv, ti, tv = rd.fused_reprice_heads(*t, fin, k=10)
    assert {n: rd.LAUNCHES[n] - before[n] for n in before} == \
        {"scatter": 0, "scatter_pageable": 0, "rowmin": 1, "rowmin_row": 0,
         "fold": 1, "fold_col": 0, "select": 1, "select_sort": 0,
         "select_rounds": 0}
    rb_p, mv_p = rd.rowmin_plain(t[0], t[1], t[3], t[5])
    assert torch.equal(rb, rb_p) and int(mv) == int(mv_p)
    s_p = rd.fold_plain(*t[:6], rb, t[6], t[7])
    np.testing.assert_allclose(s.cpu().numpy(), s_p.cpu().numpy(),
                               rtol=REL, atol=ABS)
    ti_p, tv_p = rd.select_heads_plain(s, fin, 10)
    assert torch.equal(ti, ti_p) and torch.equal(tv, tv_p)
    zeros = torch.zeros_like(t[2])
    s0, rb0, mv0 = rd.fused_reprice(t[0], t[1], t[2], t[2], zeros, t[5],
                                    t[6], t[7])
    assert torch.equal(s0, t[7]) and torch.equal(rb0, t[5]) and int(mv0) == 0


def test_cuda_select_distinct_when_k_exceeds_finite(cuda_device):
    """A row with 2 finite configs and k = C: the kernel serves every
    column once, the finite ones first, the rest in catalog order."""
    scores = torch.tensor([[3.0, 1.0, 1.0, 7.0, 1.0, 2.0]],
                          device=cuda_device)
    finite = torch.tensor([[False, True, False, False, True, False]],
                          device=cuda_device)
    ti, tv = rd.select_heads(scores, finite, 6)
    assert ti.tolist() == [[1, 4, 0, 2, 3, 5]]
    assert tv[0, :2].tolist() == [1.0, 1.0]
    assert torch.isinf(tv[0, 2:]).all()


def _select_inputs(device, S, C, seed, p_finite=0.8):
    rng = np.random.default_rng(seed)
    scores = rng.uniform(0.0, 10.0, (S, C)).astype(np.float32)
    finite = rng.random((S, C)) < p_finite
    return (torch.from_numpy(scores).to(device),
            torch.from_numpy(finite).to(device))


def _assert_select_exact(scores, finite, k, kernel="select"):
    """The card's k-head equals the plain stable sort in indices and
    values (bit for bit), through the kernel that ``k`` names: one
    launch count of it and none of any other kernel."""
    assert rd._select_plan(*scores.shape, k).kernel == kernel
    before = dict(rd.LAUNCHES)
    ti, tv = rd.select_heads(scores, finite, k)
    torch.cuda.synchronize()
    assert {n: rd.LAUNCHES[n] - before[n] for n in before} == \
        {n: int(n == kernel) for n in before}
    pi, pv = rd.select_heads_plain(scores, finite, k)
    assert torch.equal(ti, pi)
    assert torch.equal(tv.view(torch.int32), pv.view(torch.int32))


@pytest.mark.parametrize("S, C, k", [(1, 10_000, 1), (1, 10_000, 10),
                                     (16, 100_000, 10), (5, 4_097, 10),
                                     (3, 777, 33), (2, 20, 20)],
                         ids=str)
def test_cuda_select_matches_stable_sort(cuda_device, S, C, k):
    """The two-stage ``select`` at the service's row (1 x 10k), the fleet
    heads (16 x 100k), C not a multiple of the chunk nor of 4, k over a
    warp's 32 slots, and k = C."""
    _assert_select_exact(*_select_inputs(cuda_device, S, C, seed=C + k), k)


@pytest.mark.parametrize("S, C, k", [(1, 10_000, 65), (1, 10_000, 256),
                                     (1, 10_000, 257), (3, 4_097, 1_000),
                                     (2, 777, 777), (16, 100_000, 1_000),
                                     (1, 10_000, 10_000)],
                         ids=str)
def test_cuda_khead_above_64_matches_stable_sort(cuda_device, S, C, k):
    """The k-head past the old cap of 64: the two-stage ``select`` with 4
    and 8 register lists up to its cap of 256, ``select_sort`` from 257
    (one chunk a row, a ragged 3 chunks, 5 and 49 chunks; k = C)."""
    kernel = "select" if k <= rd.SELECT_CAP else "select_sort"
    _assert_select_exact(*_select_inputs(cuda_device, S, C, seed=C + k), k,
                         kernel)


def test_cuda_select_rounds_is_kept_as_the_yardstick(cuda_device):
    """The k-round kernel, reached by name only, still equals the plain
    stable sort past the old cap."""
    scores, finite = _select_inputs(cuda_device, 2, 3_000, seed=4)
    before = dict(rd.LAUNCHES)
    ti, tv = rd._launch_select_rounds(scores, finite, 65)
    torch.cuda.synchronize()
    assert {n: rd.LAUNCHES[n] - before[n] for n in before} == \
        {n: int(n == "select_rounds") for n in before}
    pi, pv = rd.select_heads_plain(scores, finite, 65)
    assert torch.equal(ti, pi) and torch.equal(tv, pv)


def test_cuda_select_edge_rows(cuda_device):
    """A wholly unprofiled row (catalog order), k above a row's finite
    count, ties in catalog order, -0.0 against +0.0 (one score), and k at
    the two-stage cap and one above it (``select_sort``)."""
    scores, finite = _select_inputs(cuda_device, 4, 9_000, seed=1)
    finite[1] = False                       # wholly unprofiled
    finite[2] = False
    finite[2, [17, 4_500, 8_999]] = True    # 3 finite, k = 10
    scores[3] = 2.0
    scores[3, :100:3] = -0.0                # 100 tied signed zeros first
    scores[3, 1:100:3] = 0.0
    scores[3, 2:100:3] = -0.0
    _assert_select_exact(scores, finite, 10)
    ties, fin = _select_inputs(cuda_device, 3, 30_000, seed=2)
    ties = torch.floor(ties / 4)            # three distinct scores
    _assert_select_exact(ties, fin, rd.SELECT_CAP)
    _assert_select_exact(ties, fin, rd.SELECT_CAP + 1, "select_sort")
    _assert_select_exact(scores, finite, rd.SELECT_CAP + 1, "select_sort")
    _assert_select_exact(scores, finite, 9_000, "select_sort")


def _rowmin_args(seed, J, C, device):
    """Hours, mask, old and new prices and the settled row minima; from J
    = 3 a fully masked row (0), a row whose one profiled cell is the last
    column, in the last chunk (1), and a row of zero hours (2)."""
    rng = np.random.default_rng(seed)
    hours = rng.uniform(0.5, 4.0, (J, C)).astype(np.float32)
    mask = rng.random((J, C)) > 0.2
    if J >= 3:
        mask[0] = False
        mask[1] = False
        mask[1, C - 1] = True
        hours[2] = 0.0
    oldp = rng.uniform(0.1, 2.0, (1, C)).astype(np.float32)
    newp = (oldp * rng.uniform(0.5, 1.5, (1, C))).astype(np.float32)
    h, m, po, pn = (torch.from_numpy(a).to(device)
                    for a in (hours, mask, oldp, newp))
    rb, _ = rd.rowmin_plain(h, m, po, torch.zeros((J, 1), device=device))
    return h, m, po, pn, rb


def _assert_rowmin_bitwise(got, want):
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert int(got[1]) == int(want[1])


@pytest.mark.parametrize("C", [1, 3, 2_047, 2_048, 2_049, 4_095, 4_096,
                               4_097, 10_000, 10_001])
@pytest.mark.parametrize("J", [1, 64])
def test_cuda_rowmin_matches_plain_bitwise(cuda_device, J, C):
    """The split ``rowmin`` (vector loads at C = 10,000, scalar at C = 3
    and 10,001; short of, at and one past 2,048 and the kernel's 4,096
    columns a block) and the one-block-a-row ``rowmin_row`` it replaced
    equal the plain version bit for bit, minima and moved, each under its
    own launch count; two launches agree, and an identity tick moves
    nothing."""
    h, m, po, pn, rb = _rowmin_args(J * 100_000 + C, J, C, cuda_device)
    want = rd.rowmin_plain(h, m, pn, rb)
    before = dict(rd.LAUNCHES)
    a = rd._launch_rowmin(h, m, pn, rb)
    b = rd._launch_rowmin(h, m, pn, rb)
    row = rd._launch_rowmin(h, m, pn, rb, variant="rowmin_row")
    torch.cuda.synchronize()
    assert {n: rd.LAUNCHES[n] - before[n] for n in before} == \
        {n: {"rowmin": 2, "rowmin_row": 1}.get(n, 0) for n in before}
    for got in (a, b, row):
        _assert_rowmin_bitwise(got, want)
    ident = rd._launch_rowmin(h, m, po, rb)
    _assert_rowmin_bitwise(ident, (rb, 0))


def test_cuda_rowmin_counters_reset_over_100_launches(cuda_device):
    """100 launches in a row on one stream's scratch, over three price
    vectors and with every output kept alive: each equals the plain
    version (the arrival counters return to 0 after every launch)."""
    h, m, po, pn, rb = _rowmin_args(7, 64, 10_000, cuda_device)
    prices = [pn, po, (pn * 0.75).contiguous()]
    got = [rd._launch_rowmin(h, m, prices[i % 3], rb) for i in range(100)]
    torch.cuda.synchronize()
    wants = [rd.rowmin_plain(h, m, p, rb) for p in prices]
    for i, g in enumerate(got):
        _assert_rowmin_bitwise(g, wants[i % 3])


def test_cuda_rowmin_two_streams_in_turn(cuda_device):
    """Launches on two streams, in turn and never waiting on each other,
    each on its own inputs: every result equals the plain version (each
    stream has its own scratch, so their arrival counters never mix)."""
    cases = [_rowmin_args(11 + i, 64, 100_000, cuda_device)
             for i in range(2)]
    streams = [torch.cuda.Stream(cuda_device) for _ in cases]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(cuda_device))
    got = [[], []]
    for _ in range(20):
        for i, (h, m, _, pn, rb) in enumerate(cases):
            with torch.cuda.stream(streams[i]):
                got[i].append(rd._launch_rowmin(h, m, pn, rb))
    torch.cuda.synchronize()
    for (h, m, _, pn, rb), outs in zip(cases, got):
        want = rd.rowmin_plain(h, m, pn, rb)
        for g in outs:
            _assert_rowmin_bitwise(g, want)


def test_cuda_rowmin_in_a_cuda_graph(cuda_device):
    """Captured into a CUDA graph after one launch on the capture stream,
    ``rowmin`` replays bitwise equal to the plain version, replay after
    replay; a capture on a stream whose scratch does not exist yet raises
    instead of recording a zeroing that would run only on replay."""
    h, m, _, pn, rb = _rowmin_args(13, 64, 10_000, cuda_device)
    want = rd.rowmin_plain(h, m, pn, rb)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        rd._launch_rowmin(h, m, pn, rb)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = rd._launch_rowmin(h, m, pn, rb)
    for _ in range(5):
        graph.replay()
        torch.cuda.synchronize()
        _assert_rowmin_bitwise(out, want)
    wide = _rowmin_args(14, 300, 10_000, cuda_device)   # more counters
    with pytest.raises(RuntimeError, match="before a CUDA graph"):
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=side):
            rd._launch_rowmin(wide[0], wide[1], wide[3], wide[4])


@pytest.mark.parametrize("calls", [1, 3])
@pytest.mark.parametrize("C, n", [(1, 0), (1, 1), (3, 2), (10_000, 100),
                                  (10_000, 10_000), (100_000, 1_000)],
                         ids=str)
def test_cuda_scatter_matches_plain_bitwise(cuda_device, C, n, calls):
    """The tick's price scatter on the card equals its plain version
    (``index_copy``, ``index_fill_``) bit for bit and leaves the old prices
    as they were — also for ``calls`` scatters back to back with no wait
    between them, each with its own pairs through the one staging
    buffer."""
    rng = np.random.default_rng(C + n)
    prices = torch.from_numpy(rng.uniform(0.5, 20.0, (1, C)).astype(
        np.float32)).to(cuda_device)
    keep = prices.clone()
    pairs = [(rng.choice(C, n, replace=False).astype(np.int32),
              rng.uniform(0.5, 20.0, n).astype(np.float32))
             for _ in range(calls)]
    before = dict(rd.LAUNCHES)
    got = [rd.scatter_prices(cols, new, prices) for cols, new in pairs]
    torch.cuda.synchronize()
    assert {k: rd.LAUNCHES[k] - before[k] for k in before} == \
        {k: calls * int(k == "scatter") for k in before}
    for out, (cols, new) in zip(got, pairs):
        want = rd.scatter_prices_plain(cols, new, prices)
        for a, b in zip(out, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(prices, keep)


def test_cuda_scatter_refuses_bad_columns(cuda_device):
    """On the card too, a column out of range or repeated raises before
    anything is launched."""
    prices = torch.ones((1, 8), device=cuda_device)
    before = dict(rd.LAUNCHES)
    for cols in ([8], [-1], [2, 2]):
        with pytest.raises(ValueError, match="columns must"):
            rd.scatter_prices(np.array(cols), np.ones(len(cols)), prices)
    assert rd.LAUNCHES == before


def _staged_cases(rng, C):
    """Pairs for n = 0, 1, 1%, every column, then 1 and 0 again: what one
    graph replays with n changing."""
    ns = sorted({0, 1, max(1, C // 100), C}) + [1, 0]
    return [(rng.choice(C, n, replace=False).astype(np.int32),
             rng.uniform(0.5, 20.0, n).astype(np.float32)) for n in ns]


def _assert_bits(a, b):
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("C", [1, 3, 257, 10_000, 100_000])
def test_cuda_staged_scatter_matches_plain_across_replays(cuda_device, C):
    """Kernel ``scatter`` from a staging slot equals its plain version bit
    for bit, launched and replayed from ONE captured graph whose pairs
    change between replays (n = 0, 1, 1%, C, 1, 0); the old prices stay
    as they were, and each replay counts one ``scatter``."""
    rng = np.random.default_rng(C)
    prices = torch.from_numpy(rng.uniform(0.5, 20.0, (1, C)).astype(
        np.float32)).to(cuda_device)
    keep = prices.clone()
    staging = rd.PairStaging(C, cuda_device)
    new_p, changed = torch.empty_like(prices), torch.empty_like(prices)
    cases = _staged_cases(rng, C)
    for cols, new in cases:
        staging.fill(0, cols, new)
        rd._launch_scatter_staged(staging, 0, prices, new_p, changed)
        staging.release(0)
        staging.wait(0)
        for a, b in zip((new_p, changed),
                        rd.scatter_prices_plain(cols, new, prices)):
            _assert_bits(a, b)
    graph = rd.capture(lambda: rd._launch_scatter_staged(
        staging, 1, prices, new_p, changed), cuda_device)
    before = dict(rd.LAUNCHES)
    for cols, new in cases:
        staging.fill(1, cols, new)
        rd.replay(graph, ("scatter",))
        staging.release(1)
        staging.wait(1)
        for a, b in zip((new_p, changed),
                        rd.scatter_prices_plain(cols, new, prices)):
            _assert_bits(a, b)
    assert {k: rd.LAUNCHES[k] - before[k] for k in before} == \
        {k: len(cases) * int(k == "scatter") for k in before}
    assert torch.equal(prices, keep)


def test_cuda_pageable_scatter_is_the_yardstick(cuda_device):
    """The scatter it replaced, by name only: equal to the plain version,
    counted as ``scatter_pageable`` (not ``scatter``), and it refuses a
    graph capture."""
    rng = np.random.default_rng(4)
    prices = torch.from_numpy(rng.uniform(0.5, 20.0, (1, 10_000)).astype(
        np.float32)).to(cuda_device)
    cols = rng.choice(10_000, 100, replace=False).astype(np.int32)
    new = rng.uniform(0.5, 20.0, 100).astype(np.float32)
    before = dict(rd.LAUNCHES)
    got = rd._launch_scatter_pageable(cols, new, prices)
    for a, b in zip(got, rd.scatter_prices_plain(cols, new, prices)):
        _assert_bits(a, b)
    assert {k: rd.LAUNCHES[k] - before[k] for k in before} == \
        {k: int(k == "scatter_pageable") for k in before}
    with pytest.raises(RuntimeError, match="cannot be captured"):
        rd.capture(lambda: rd._launch_scatter_pageable(cols, new, prices),
                   cuda_device)


def _graph_fleet(device, seed, J, C, S, capacity=None):
    rng = np.random.default_rng(seed)
    hours = rng.uniform(0.05, 10.0, (J, C))
    mask = rng.random((J, C)) > 0.15
    mask[np.arange(J), rng.integers(0, C, J)] = True
    prices = rng.uniform(0.5, 20.0, C)
    ids = [f"c{i}" for i in range(C)]
    members = {"all": list(range(J))}
    for m in range(S - 1):
        members[f"m{m}"] = sorted(int(i) for i in rng.choice(
            J, int(rng.integers(1, J)), replace=False))
    state = TorchFusedRankState(hours, mask, prices, ids,
                                capacity=capacity or S, device=device)
    for key, rows in members.items():
        state.add_state(key, rows=rows)
    return state, ids, members


def _tick_deltas(rng, state, ids, frac=0.01):
    C = len(ids)
    cols = rng.choice(C, max(1, int(C * frac)), replace=False)
    live = state.prices
    return {ids[c]: float(live[c] * rng.uniform(0.7, 1.3)) for c in cols}


def _eager_tick(state, deltas):
    """The tick on new tensors from the state's current ones, and the
    dense tick from the same: ``((scores, rb, prices, moved), ...)``."""
    pairs = state._pairs(deltas)
    newp, changed = rd.scatter_prices(*pairs, state.d_prices)
    s, rb, mv = rd.fused_reprice(
        state.d_hours, state.d_mask, state.d_prices, newp, changed,
        state.d_row_best, state.d_row_masks, state.d_scores)
    dense_p = state._host_prices.copy()
    dense_p[0, pairs[0]] = pairs[1]
    flags = np.zeros_like(dense_p)
    flags[0, pairs[0]] = 1.0
    d_newp = torch.from_numpy(dense_p).to(state.device)
    ds, drb, dmv = rd.fused_reprice(
        state.d_hours, state.d_mask, state.d_prices, d_newp,
        torch.from_numpy(flags).to(state.device), state.d_row_best,
        state.d_row_masks, state.d_scores)
    return ((s, rb, newp, int(mv.item())),
            (ds, drb, d_newp, int(dmv.item())))


def _assert_state_is(state, moved, want):
    scores, rb, newp, want_moved = want
    assert moved == want_moved
    _assert_bits(state.d_scores, scores)
    _assert_bits(state.d_row_best, rb)
    _assert_bits(state.d_prices, newp)


def test_cuda_graphed_tick_equals_eager_tick_over_100_ticks(cuda_device):
    """Two fleets at 64 x 10,000 x 16 from one seed take the same 100
    ticks of 1% of prices (every fifth with heads): the graphed one
    (``reprice``, ``reprice_with_heads``) and the eager one
    (``_reprice(graph=False)``) agree with each other and with the dense
    tick on scores, row minima, prices and moved bit for bit, and on the
    heads.  The graphed fleet ran its first tick eagerly, captured two
    graphs and replayed the other 99; one ``scatter``, ``rowmin`` and
    ``fold`` a tick on each fleet."""
    graphed, ids, members = _graph_fleet(cuda_device, 7, 64, 10_000, 16)
    eager, _, _ = _graph_fleet(cuda_device, 7, 64, 10_000, 16)
    rng = np.random.default_rng(8)
    fused_rank.reset_graphs()
    rd.reset_launches()
    ticks, heads_ticks = 100, 0
    for tick in range(ticks):
        deltas = _tick_deltas(rng, graphed, ids)
        _, dense = _eager_tick(graphed, deltas)
        if tick % 5 == 4:
            moved, heads = graphed.reprice_with_heads(deltas, 10)
            heads_ticks += 1
        else:
            moved = graphed.reprice(deltas)
        m_eager = eager._reprice(deltas, graph=False)
        _assert_state_is(graphed, moved, dense)
        _assert_state_is(graphed, m_eager, (eager.d_scores,
                                            eager.d_row_best,
                                            eager.d_prices, m_eager))
        if tick % 5 == 4:
            keys = list(members)
            assert [heads[k] for k in keys] == eager.heads(keys, 10)
    assert fused_rank.GRAPHS == {"captures": 2, "replays": ticks - 1,
                                 "rebinds": 0, "invalidations": 0}
    # a tick each on both fleets and in the eager and dense ticks held
    # beside them (the dense tick scatters on the host)
    assert rd.LAUNCHES["scatter"] == 3 * ticks
    assert rd.LAUNCHES["rowmin"] == rd.LAUNCHES["fold"] == 4 * ticks
    assert rd.LAUNCHES["scatter_pageable"] == 0
    assert rd.LAUNCHES["select"] == 2 * heads_ticks


def test_cuda_tick_graph_is_recaptured_or_rebound_never_stale(cuda_device):
    """A graphed fleet through a retire, an add into the freed slot, a
    grow, its tick tensors assigned from outside and new row masks:
    every tick equals the eager tick from the same state bit for bit.
    The grow and the new row masks drop the graphs (each direction is
    captured again), the assignment rebinds three tensors and keeps
    them."""
    state, ids, members = _graph_fleet(cuda_device, 9, 21, 3_000, 4,
                                       capacity=4)
    rng = np.random.default_rng(10)
    fused_rank.reset_graphs()

    def tick():
        deltas = _tick_deltas(rng, state, ids, 0.02)
        want, _ = _eager_tick(state, deltas)
        _assert_state_is(state, state.reprice(deltas), want)

    for _ in range(3):
        tick()
    assert fused_rank.GRAPHS["captures"] == 2
    state.retire_state("m0")
    state.add_state("m7", rows=[0, 5, 9])
    tick()
    tick()
    assert fused_rank.GRAPHS["captures"] == 2
    state.add_state("m8", rows=[2, 3])               # past the capacity
    assert state.realloc_count == 1
    tick()
    tick()
    assert fused_rank.GRAPHS["captures"] == 4
    assert fused_rank.GRAPHS["invalidations"] == 1
    state.d_scores = state.d_scores.clone()
    state.d_row_best = state.d_row_best.clone()
    state.d_prices = state.d_prices.clone()
    tick()
    assert fused_rank.GRAPHS["rebinds"] == 3
    assert fused_rank.GRAPHS["captures"] == 4
    state.d_row_masks = state.d_row_masks.clone()
    tick()
    tick()
    assert fused_rank.GRAPHS["captures"] == 6
    assert fused_rank.GRAPHS["invalidations"] == 2
    assert fused_rank.GRAPHS["replays"] == 9


def test_cuda_failed_tick_capture_raises(cuda_device, monkeypatch):
    """``rowmin`` captured on a stream with no scratch for its shape
    raises, and with the graph's own scratch replays bitwise; a fleet
    whose tick capture fails raises (it never carries on eagerly) and
    leaves the state as it was, and once the fault is gone it captures
    and ticks exactly."""
    h, m, _, pn, rb = _rowmin_args(16, 5_000, 64, cuda_device)
    with pytest.raises(RuntimeError, match="before a CUDA graph"):
        rd.capture(lambda: rd._launch_rowmin(h, m, pn, rb), cuda_device)
    scratch = rd.rowmin_scratch(cuda_device, 5_000, 64)
    out = (torch.empty_like(rb),
           torch.empty((1, 1), dtype=torch.int32, device=cuda_device))
    graph = rd.capture(lambda: rd._launch_rowmin(h, m, pn, rb, out=out,
                                                 scratch=scratch),
                       cuda_device)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        _assert_rowmin_bitwise(out, rd.rowmin_plain(h, m, pn, rb))
    state, ids, _ = _graph_fleet(cuda_device, 11, 13, 2_000, 3)
    rng = np.random.default_rng(12)
    state.reprice(_tick_deltas(rng, state, ids))          # eager, warm
    fused_rank.reset_graphs()
    monkeypatch.setattr(fused_rank, "rowmin_scratch",
                        lambda device, J, C: rd.rowmin_scratch(device, 1, 1))
    snap = (state.d_scores.clone(), state.d_row_best.clone(),
            state.d_prices.clone(), state.prices.copy(), state.reprices)
    with pytest.raises(ValueError, match="too small"):
        state.reprice(_tick_deltas(rng, state, ids))
    assert fused_rank.GRAPHS["captures"] == fused_rank.GRAPHS["replays"] == 0
    for a, b in zip(snap[:3], (state.d_scores, state.d_row_best,
                               state.d_prices)):
        _assert_bits(a, b)
    assert np.array_equal(state.prices, snap[3])
    assert state.reprices == snap[4]
    monkeypatch.undo()
    deltas = _tick_deltas(rng, state, ids)
    want, _ = _eager_tick(state, deltas)
    _assert_state_is(state, state.reprice(deltas), want)
    assert fused_rank.GRAPHS["captures"] == fused_rank.GRAPHS["replays"] == 1


def _pair_and_dense_ticks(state, deltas):
    """One tick of ``state`` through the pair path, then from the same
    state through dense (1, C) vectors built by hand: both results."""
    before = (state.d_scores, state.d_row_best, state.d_prices)
    moved = state.reprice(deltas)
    pairs = (state.d_scores, state.d_row_best, state.d_prices, moved)
    C = len(state.config_ids)
    newp = before[2].cpu().numpy().copy()
    changed = np.zeros((1, C), np.float32)
    for cid, p in dict(deltas).items():
        c = state.config_ids.index(cid)
        newp[0, c] = np.float32(p)
        changed[0, c] = 1.0
    d_newp = torch.from_numpy(newp).to(state.device)
    scores, rb, mv = rd.fused_reprice(
        state.d_hours, state.d_mask, before[2], d_newp,
        torch.from_numpy(changed).to(state.device), before[1],
        state.d_row_masks, before[0])
    return pairs, (scores, rb, d_newp, int(mv.item()))


def test_cuda_pair_tick_equals_dense_tick_bitwise(cuda_device):
    """The pair tick (columns and prices uploaded, scattered on the card)
    gives the scores, row minima, prices and moved of the dense tick
    bit for bit — with duplicates (the last wins), a price set to its
    current value (still a changed column) and 1% and 30% of the
    columns."""
    state, hours, mask, ids, members = _fleet(cuda_device, C=2_003)
    rng = np.random.default_rng(9)
    live = state.prices
    for n in (20, 600, 1):
        cols = rng.choice(len(ids), n, replace=False)
        deltas = [(ids[c], float(live[c] * rng.uniform(0.6, 1.4)))
                  for c in cols]
        deltas += [(ids[cols[0]], 99.0), (ids[cols[0]], float(live[cols[0]]))]
        pairs, dense = _pair_and_dense_ticks(state, deltas)
        for a, b in zip(pairs[:3], dense[:3]):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert pairs[3] == dense[3]
        live = state.prices
        assert np.array_equal(live.astype(np.float32),
                              state.d_prices.cpu().numpy()[0])


def _fold_args(seed, J, C, S, device, identity=False):
    """One tick's fold arguments with a fully masked row (row 0) and the
    new row minima from the plain ``rowmin``."""
    *t, _ = _tick_inputs(seed, J, C, S, 0 if identity else max(1, C // 50),
                         masked_rows=(0,), device=device)
    if identity:
        t[3] = t[2]
    rb_new, _ = rd.rowmin_plain(t[0], t[1], t[3], t[5])
    return t[:6] + [rb_new, t[6], t[7]]


@pytest.mark.parametrize("C", [300, 10_001])
@pytest.mark.parametrize("J", [1, 13, 64, 65])
@pytest.mark.parametrize("S", [1, 8, 16, 17, 33])
def test_cuda_fold_matches_plain_and_fold_col(cuda_device, S, J, C):
    """The row-split ``fold`` against the plain version and against the
    column-per-thread ``fold_col`` it replaced, within the envelope (the
    member sums re-associated), at 8 and 16 member accumulators and past
    them, J past a staged chunk of 64 rows, C past a 32-column tile; a
    fully masked row never yields NaN.  Each launch counts under its own
    name."""
    args = _fold_args(S * 1000 + J, J, C, S, cuda_device)
    before = dict(rd.LAUNCHES)
    got = rd._launch_fold(*args)
    col = rd._launch_fold(*args, variant="fold_col")
    torch.cuda.synchronize()
    assert {n: rd.LAUNCHES[n] - before[n] for n in before} == \
        {n: int(n in ("fold", "fold_col")) for n in before}
    want = rd.fold_plain(*args)
    assert torch.isfinite(got).all()
    for other in (want, col):
        np.testing.assert_allclose(got.cpu().numpy(), other.cpu().numpy(),
                                   rtol=REL, atol=ABS)


@pytest.mark.parametrize("S", [8, 16])
def test_cuda_fold_is_repeatable_and_identity_is_bitwise(cuda_device, S):
    """Two launches on the same inputs give the same bits (the warps'
    partials add in a fixed order), and an identity tick leaves every
    score bit for bit, at the fleet's 64 x 10,000."""
    args = _fold_args(3, 64, 10_000, S, cuda_device)
    a, b = rd._launch_fold(*args), rd._launch_fold(*args)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    same = _fold_args(3, 64, 10_000, S, cuda_device, identity=True)
    out = rd._launch_fold(*same)
    assert torch.equal(out.view(torch.int32), same[8].view(torch.int32))


def _fleet(device, seed=5, J=21, C=700, n_members=6):
    rng = np.random.default_rng(seed)
    hours = rng.uniform(0.05, 10.0, (J, C))
    mask = rng.random((J, C)) > 0.2
    mask[np.arange(J), rng.integers(0, C, J)] = True
    prices = rng.uniform(0.5, 20.0, C)
    ids = [f"c{i}" for i in range(C)]
    state = TorchFusedRankState(hours, mask, prices, ids, capacity=4,
                                device=device)
    members = {"all": list(range(J))}
    for m in range(n_members - 1):
        members[f"m{m}"] = sorted(int(i) for i in rng.choice(
            J, int(rng.integers(1, J)), replace=False))
    for key, rows in members.items():
        state.add_state(key, rows=rows)
    return state, hours, mask, ids, members


def test_cuda_fleet_matches_cpu_fleet_and_cold_rank(cuda_device):
    """The same ticks on a CUDA fleet and a CPU fleet: the same handoffs,
    heads equal to each state's own ranking head, every member within the
    contract of the cold float64 rank; capacity grew once."""
    gpu, hours, mask, ids, members = _fleet(cuda_device)
    cpu, *_ = _fleet("cpu")
    assert gpu.realloc_count == cpu.realloc_count == 1
    rng = np.random.default_rng(0)
    live = gpu.prices.copy()
    for tick in range(12):
        cols = rng.choice(len(ids), 7 if tick % 3 else 210, replace=False)
        new = (live[cols] * rng.uniform(0.7, 1.3, cols.size)
               ).astype(np.float32)
        deltas = {ids[c]: float(p) for c, p in zip(cols, new)}
        if tick % 2:
            assert gpu.reprice(deltas) == cpu.reprice(deltas)
        else:
            mg, hg = gpu.reprice_with_heads(deltas, 10)
            mc, hc = cpu.reprice_with_heads(deltas, 10)
            assert mg == mc
            for key in members:
                assert hg[key] == gpu.ranking(key)[:10]
                assert hc[key] == cpu.ranking(key)[:10]
        live[cols] = new
        for key, rows in members.items():
            cold = rank_dense(hours[rows], mask[rows], live, ids)
            got = gpu.ranking(key)
            assert CONTRACT.winner_matches(got[0].config_id, cold)
            ref = {r.config_id: r.score for r in cold}
            assert all(CONTRACT.scores_match(r.score, ref[r.config_id])
                       for r in got)
            assert gpu.top_k(key, 5) == got[:5]
    assert gpu.dispatches == 12


def test_cuda_service_serves_through_the_kernels(cuda_device):
    """A ``torch_fused`` service on the card: submissions before and after
    a tick launch every kernel of the path and agree with a numpy service
    under the contract."""
    rng = np.random.default_rng(2)
    ids = [f"c{i}" for i in range(300)]
    quotes = {c: float(p) for c, p in zip(ids, rng.uniform(1, 20, 300))}
    services = []
    for backend, device in (("torch_fused", "cuda"), ("numpy", "cpu")):
        store = ProfilingStore(config_ids=ids)
        sub = np.random.default_rng(3)
        for j in range(12):
            for c in ids:
                if sub.random() < 0.85:
                    store.add(f"j{j}", c, float(sub.uniform(0.1, 5.0)),
                              group=f"g{j % 3}")
        services.append(SelectionService(
            IdentityCatalog(ids), store, PriceTable(dict(quotes)),
            backend=backend, device=device, serve_top_k=5))
    gpu, ref = services
    rd.reset_launches()
    for step in range(3):
        for job in ("j0", "j4", "j8"):
            d, r = gpu.submit(job), ref.submit(job)
            assert d.served_via == "top_k" and len(d.ranking) == 5
            assert CONTRACT.scores_match(d.ranking[0].score,
                                         r.ranking[0].score)
        deltas = {ids[i]: float(rng.uniform(1, 20)) for i in
                  rng.choice(300, 9, replace=False)}
        gpu.reprice(deltas)
        ref.reprice(deltas)
    # every kernel of the path, one scatter, rowmin and fold a tick; the
    # sort serves only k > 256 and the yardsticks no path at all
    assert all(rd.LAUNCHES[n] > 0 for n in ("rowmin", "fold", "select")) \
        and rd.LAUNCHES["scatter"] == rd.LAUNCHES["rowmin"] \
        == rd.LAUNCHES["fold"] == 3 \
        and all(rd.LAUNCHES[n] == 0 for n in (
            "rowmin_row", "select_sort", "fold_col", "select_rounds")), \
        rd.LAUNCHES
    assert gpu.reprice_dispatches == 3


def test_cuda_threaded_frontend_serves_from_one_select_a_snapshot(
        cuda_device):
    """The front-end on the card with its tick thread and 3 workers: zero
    shed, an audit-clean merged journal, one ``scatter``, ``rowmin`` and
    ``fold`` a fleet tick, and at most one ``select`` a published
    snapshot plus one a forwarded submission (never one a route)."""
    from repro_torch.market import (JournalReplayer, RecordedPriceFeed,
                                    ServeFrontend, SimulatedSpotFeed,
                                    Submission, record_feed)
    rng = np.random.default_rng(5)
    ids = [f"c{i}" for i in range(2_000)]
    store = ProfilingStore(config_ids=ids)
    for j in range(24):
        for c in ids:
            if rng.random() < 0.8:
                store.add(f"j{j}", c, float(rng.uniform(0.1, 5.0)),
                          group=f"g{j % 6}")
    base = {c: float(p) for c, p in zip(ids, rng.uniform(1, 20, 2_000))}
    market = record_feed(SimulatedSpotFeed(base, seed=5,
                                           change_fraction=0.02), 40)
    svc = SelectionService(IdentityCatalog(ids), store, PriceTable(base),
                           backend="torch_fused", device="cuda",
                           serve_top_k=10)
    fe = ServeFrontend(svc, RecordedPriceFeed.loads(market), workers=3,
                       queue_capacity=1_000)
    subs = [Submission(f"j{i % 24}") for i in range(400)]
    fe.warm(subs[:5])            # groups g0-g4: g5's route is forwarded
    snaps = fe.stats().snapshots
    rd.reset_launches()
    with fe:
        for sub in subs:
            assert fe.submit(sub)
        fe.drain(timeout=120.0)
        fe.await_ticks(timeout=120.0)
    launches, stats = dict(rd.LAUNCHES), fe.stats()
    assert stats.shed == 0 and stats.accounted and stats.decisions == 400
    audit = JournalReplayer(store, fe.journal_dump()).audit()
    assert audit.ok, audit.mismatches[:3]
    assert launches["scatter"] == launches["rowmin"] == launches["fold"] \
        == svc.reprice_dispatches > 0
    assert 0 < launches["select"] <= stats.snapshots - snaps \
        + stats.forwarded
    assert all(launches[n] == 0 for n in ("rowmin_row", "fold_col",
                                          "select_rounds", "select_sort"))
    assert stats.forwarded >= 1 and len(fe.snapshot.entries) == 6


def test_cuda_turbulence_point_matches_cpu_point(cuda_device):
    """One ``torch_fused`` turbulence point at the paper's universe (18
    jobs x 10 configs: C is no multiple of 4) on the card and on the CPU:
    both audit clean, the same decisions and epochs, the mean deviation
    within rel 1e-4, and one ``scatter``, ``rowmin`` and ``fold`` a fleet
    tick."""
    from repro_torch.core import costmodel, spark_sim
    from repro_torch.market import (RecordedPriceFeed, make_market,
                                    record_feed, run_point,
                                    synthetic_stream)
    from repro_torch.selector import GcpVmCatalog
    trace = spark_sim.generate_trace(seed=0)
    store = ProfilingStore.from_trace(trace)
    catalog = GcpVmCatalog(trace.configs, costmodel.LinearPriceModel())
    base = dict(PriceTable.from_catalog(catalog).items())
    events = list(synthetic_stream([j.name for j in trace.jobs], 400,
                                   seed=3, tick_fraction=0.15))
    text = record_feed(make_market("flash_crash", base, seed=11,
                                   ticks=60).raw, 60)
    points = {}
    for device in ("cuda", "cpu"):
        svc = SelectionService(catalog, store,
                               PriceTable.from_catalog(catalog),
                               backend="torch_fused", device=device)
        rd.reset_launches()
        points[device] = run_point(svc, RecordedPriceFeed.loads(text),
                                   events, preset_name="flash_crash",
                                   truth=RecordedPriceFeed.loads(text))
        if device == "cuda":
            assert rd.LAUNCHES["scatter"] == rd.LAUNCHES["rowmin"] == \
                rd.LAUNCHES["fold"] == svc.reprice_dispatches > 0
    gpu, cpu = points["cuda"], points["cpu"]
    assert gpu.audit_ok and cpu.audit_ok
    assert (gpu.decisions, gpu.epochs) == (cpu.decisions, cpu.epochs)
    assert gpu.mean_deviation == pytest.approx(cpu.mean_deviation,
                                               rel=1e-4, abs=1e-12)


# --- the LM kernels -----------------------------------------------------------

#: (B, T, H, G, D, causal, window): GQA, MQA, bidirectional, windowed,
#: ragged T (12, 100, 130, 1000: no multiple of the 128-row tile), every
#: head size the kernels are built for, the qwen3-1.7b prefill's shape,
#: and at D = 80 (a 64-column block and a 16-column tail) the stablelm-3b
#: prefill's shape, GQA, ragged T = 100, a window over T = 1000, T = 1
#: and T = 129 (one past a tile); at D = 256 (the kernels' own block
#: shape: 64-row tiles) the recurrentgemma-9b prefill's shape, its
#: 4,096-token prompt past the 2,048 window, GQA, ragged T = 1, 100, 129
#: and 1,000, windowed and bidirectional; at D = 160 (the same 64-row
#: block, two 64-column blocks and a 32-column tail) the pixtral-12b
#: prefill's shape (1,024 patches and 1,024 tokens), GQA at T = 256,
#: ragged T = 100, a window over T = 1,000, T = 1 and T = 65 (one past a
#: 64-row tile)
ATTN_CASES = [
    (2, 128, 4, 2, 64, True, None),
    (2, 64, 8, 1, 32, True, None),
    (1, 96, 2, 2, 16, False, None),
    (1, 256, 4, 4, 32, True, 64),
    (2, 12, 16, 8, 128, True, None),
    (1, 100, 4, 2, 80, True, 16),
    (1, 130, 2, 1, 128, False, None),
    (1, 100, 4, 1, 64, True, None),
    (1, 1000, 4, 2, 128, True, 300),
    (4, 1024, 16, 8, 128, True, None),
    (4, 1024, 32, 32, 80, True, None),
    (2, 256, 8, 2, 80, True, None),
    (1, 100, 4, 4, 80, True, None),
    (1, 1000, 4, 2, 80, True, 300),
    (2, 1, 4, 4, 80, True, None),
    (1, 129, 4, 2, 80, False, None),
    # the prefill shapes of deepseek-7b (MHA), granite-20b (48 query heads
    # on one KV head), qwen3-moe-30b-a3b (D = 64) and llama4's 2-layer check
    (4, 1024, 32, 32, 128, True, None),
    (4, 1024, 48, 1, 128, True, None),
    (4, 1024, 32, 4, 64, True, None),
    (2, 1024, 40, 8, 128, True, None),
    (4, 1024, 16, 1, 256, True, None),
    (1, 4096, 16, 1, 256, True, 2048),
    (2, 256, 8, 2, 256, True, None),
    (2, 1, 4, 1, 256, True, None),
    (1, 100, 4, 1, 256, True, None),
    (1, 129, 4, 2, 256, False, None),
    (1, 1000, 4, 1, 256, True, 300),
    (4, 2048, 32, 8, 160, True, None),
    (2, 256, 8, 2, 160, True, None),
    (1, 100, 4, 4, 160, True, None),
    (1, 1000, 4, 2, 160, True, 300),
    (2, 1, 4, 4, 160, True, None),
    (1, 65, 4, 2, 160, True, None),
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_flash_attention_matches_plain(cuda_device, case, dtype):
    """The kernel :func:`fa.variant` names against the plain version on
    the same card tensors (fp32 atol 2e-5, bf16 atol 2e-2, rtol 1e-2):
    the tensor-core kernel for bf16 at every head size, the split one
    (three bf16 pieces an operand on the tensor cores) for fp32; one
    launch per call, counted in the total and its variant."""
    B, T, H, G, D, causal, window = case
    gen = torch.Generator(device=cuda_device).manual_seed(sum(case[:5]))
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device
                           ).to(dtype)
               for shape in ((B, T, H, D), (B, T, G, D), (B, T, G, D)))
    kind = fa.variant(dtype, D)
    assert kind == ("tc" if dtype == torch.bfloat16 else "split")
    before = dict(fa.LAUNCHES)
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {
        "flash_attention": 1, "flash_attention_tc": int(kind == "tc"),
        "flash_attention_split": int(kind == "split"),
        "flash_attention_scalar": 0,
        "flash_attention_bwd": 0, "flash_attention_bwd_tc": 0,
        "flash_attention_bwd_split": 0, "flash_attention_bwd_scalar": 0}
    want = fa.attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == want.shape
    atol = 2e-5 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=atol,
                               rtol=1e-2)


@pytest.mark.parametrize("D,H,G", [(128, 16, 8), (80, 32, 32), (256, 16, 1),
                                   (160, 32, 8)],
                         ids=["D128", "D80", "D256", "D160"])
def test_cuda_flash_attention_scalar_kernel_on_bf16(cuda_device, D, H, G):
    """The scalar kernel still takes bf16 when named (the yardstick the
    tensor-core kernel is timed against): at the qwen3-1.7b (D = 128),
    stablelm-3b (D = 80), recurrentgemma-9b (D = 256, MQA) and
    pixtral-12b (D = 160, 32 over 8) head layouts it agrees with the plain version and with the tensor-core
    kernel, which bf16 at each of them takes by default."""
    assert fa.variant(torch.bfloat16, D) == "tc"
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device
                           ).to(torch.bfloat16)
               for shape in ((2, 300, H, D), (2, 300, G, D),
                             (2, 300, G, D)))
    scalar = fa._launch(q, k, v, True, None, "scalar")
    tc = fa._launch(q, k, v, True, None, "tc")
    want = fa.attention_ref(q, k, v, causal=True)
    for got in (scalar, tc):
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), atol=2e-2,
                                   rtol=1e-2)
    with pytest.raises(ValueError, match="tensor-core"):
        fa._launch(q.float(), k.float(), v.float(), True, None, "tc")
    with pytest.raises(ValueError, match="split"):
        fa._launch(q, k, v, True, None, "split")


@pytest.mark.parametrize("D,H,G", [(128, 16, 8), (256, 16, 1), (160, 32, 8),
                                   (64, 4, 2)],
                         ids=["D128", "D256", "D160", "D64"])
def test_cuda_flash_attention_scalar_kernel_on_fp32(cuda_device, D, H, G):
    """fp32 takes the split kernel (three bf16 pieces an operand on the
    tensor cores) by default; the scalar kernel, its yardstick, still
    takes fp32 when named.  Both agree with the plain version (atol 2e-5,
    rtol 1e-2), one launch each under its own variant."""
    assert fa.variant(torch.float32, D) == "split"
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device)
               for shape in ((2, 300, H, D), (2, 300, G, D),
                             (2, 300, G, D)))
    before = dict(fa.LAUNCHES)
    split = fa._launch(q, k, v, True, None)
    scalar = fa._launch(q, k, v, True, None, "scalar")
    torch.cuda.synchronize()
    for kind in ("split", "scalar"):
        assert fa.LAUNCHES[f"flash_attention_{kind}"] == \
            before[f"flash_attention_{kind}"] + 1
    want = fa.attention_ref(q, k, v, causal=True)
    for got in (split, scalar):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   atol=2e-5, rtol=1e-2)


def test_cuda_flash_attention_refuses_what_it_does_not_take(cuda_device):
    q = torch.zeros((1, 8, 2, 48), device=cuda_device)
    with pytest.raises(ValueError, match="head sizes"):
        fa.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 32), device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q)
    q = torch.zeros((1, 2, 8, 32), device=cuda_device).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q, q, q)


def _wkv_inputs(device, B, T, H, N, dtype, seed=0, strong=False):
    gen = torch.Generator(device=device).manual_seed(seed)
    r, k, v = (torch.randn((B, T, H, N), generator=gen, device=device
                           ).to(dtype) for _ in range(3))
    if strong:     # RWKV-6's own decay: w = exp(-exp(x)), x in [-8, 2]
        x = torch.rand((B, T, H, N), generator=gen, device=device) * 10 - 8
        w = torch.exp(-torch.exp(x))
    else:
        w = torch.sigmoid(torch.randn((B, T, H, N), generator=gen,
                                      device=device)) * 0.5 + 0.45
    u = torch.randn((H, N), generator=gen, device=device) * 0.5
    s0 = torch.randn((B, H, N, N), generator=gen, device=device)
    return r, k, v, w, u, s0


def _wkv_close(got, want):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   atol=1e-4, rtol=1e-3)


#: a decode step at two widths, ragged T, T one past the split kernel's
#: 16-step chunk and past a power of two, all three head sizes, and
#: rwkv6-3b's prefill and decode shapes at batch 4
WKV_SHAPES = [(2, 1, 3, 64), (1, 37, 2, 64), (2, 100, 2, 16), (1, 64, 4, 32),
              (2, 17, 3, 64), (1, 1025, 2, 64), (4, 1024, 40, 64),
              (4, 1, 40, 64)]


@pytest.mark.parametrize("shape", WKV_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_wkv6_matches_plain(cuda_device, shape, dtype):
    """The split kernel against its plain version (atol 1e-4, rtol 1e-3),
    one launch of it per call and none of the sequential kernel."""
    args = _wkv_inputs(cuda_device, *shape, dtype)
    before = dict(wk.LAUNCHES)
    got = wk.wkv6(*args)
    torch.cuda.synchronize()
    assert {n: wk.LAUNCHES[n] - before[n] for n in before} == {
        "wkv6": 1, "wkv6_seq": 0, "wkv6_bwd": 0,
        "wkv6_bwd_block": 0}
    _wkv_close(got, wk.wkv6_scan_ref(*args))


@pytest.mark.parametrize("shape", [(2, 17, 3, 64), (1, 1025, 2, 64),
                                   (2, 50, 2, 16), (1, 40, 3, 32)], ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_wkv6_strong_decays(cuda_device, shape, dtype):
    """RWKV-6's own decay range (w from about 6e-4 to just below 1)."""
    args = _wkv_inputs(cuda_device, *shape, dtype, seed=7, strong=True)
    _wkv_close(wk.wkv6(*args), wk.wkv6_scan_ref(*args))


@pytest.mark.parametrize("shape", [(4, 1024, 40, 64), (4, 1, 40, 64),
                                   (2, 100, 2, 16), (1, 64, 4, 32)], ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_wkv6_split_matches_sequential(cuda_device, shape, dtype):
    """The split kernel against the sequential one it replaced, on the
    same inputs; the sequential kernel counts under both names."""
    args = _wkv_inputs(cuda_device, *shape, dtype, seed=5)
    split = wk.wkv6(*args)
    before = dict(wk.LAUNCHES)
    seq = wk._launch(*args, variant="seq")
    torch.cuda.synchronize()
    assert {n: wk.LAUNCHES[n] - before[n] for n in before} == {
        "wkv6": 1, "wkv6_seq": 1, "wkv6_bwd": 0, "wkv6_bwd_block": 0}
    _wkv_close(split, seq)


def test_cuda_wkv6_state_carry(cuda_device):
    r, k, v, w, u, s0 = _wkv_inputs(cuda_device, 1, 64, 2, 64,
                                    torch.float32, seed=3)
    y_full, s_full = wk.wkv6_scan_ref(r, k, v, w, u, s0)
    y1, s_mid = wk.wkv6(r[:, :29].contiguous(), k[:, :29].contiguous(),
                        v[:, :29].contiguous(), w[:, :29].contiguous(), u,
                        s0)
    y2, sT = wk.wkv6(r[:, 29:].contiguous(), k[:, 29:].contiguous(),
                     v[:, 29:].contiguous(), w[:, 29:].contiguous(), u,
                     s_mid)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).cpu().numpy(),
                               y_full.cpu().numpy(), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(sT.cpu().numpy(), s_full.cpu().numpy(),
                               atol=1e-4, rtol=1e-3)


def _params_of(lm):
    return {"embed": dict(lm.embed.items()),
            "final_norm": dict(lm.final_norm.items()),
            "layers": [{g: dict(block[g].items()) for g in block.groups}
                       for block in lm.blocks]}


#: (model, head size, dtype): the reduced configs in fp32, and stablelm-3b
#: at its real head size 80 and recurrentgemma-9b at its 256 in bf16 (2
#: heads, d_model twice the head size), which run the tensor-core kernel
ENGINE_CASES = [("qwen3-1.7b", None, "float32"), ("rwkv6-3b", None, "float32"),
                ("stablelm-3b", 80, "bfloat16"),
                ("qwen3-moe-30b-a3b", None, "float32"),
                ("recurrentgemma-9b", None, "float32"),
                ("recurrentgemma-9b", 256, "bfloat16")]


@pytest.mark.parametrize("name,head_dim,dtype", ENGINE_CASES,
                         ids=["qwen3-1.7b", "rwkv6-3b", "stablelm-3b-d80",
                              "qwen3-moe-30b-a3b", "recurrentgemma-9b",
                              "recurrentgemma-9b-d256"])
def test_cuda_reduced_engine_runs_through_the_kernels(cuda_device, name,
                                                      head_dim, dtype):
    """A reduced model served on the card: each layer's kernel launches
    once per prefill (flash attention, on attention layers: the split
    kernel in fp32, the tensor-core one in bf16) or once per model call
    (WKV6), and the prefill logits equal the same weights' on the CPU
    within the decode-parity tolerance (2e-3) in fp32, and within the LM
    path's bf16 bound (relative L2 0.1, ``chip_smoke.REL_L2_TOL``) in
    bf16."""
    cfg = configs.reduced(configs.get(name))
    if head_dim is not None:
        cfg = dataclasses.replace(configs.reduced(configs.get(name),
                                                  d_model=2 * head_dim),
                                  num_heads=2, num_kv_heads=2,
                                  head_dim=head_dim)
    cfg = dataclasses.replace(cfg, dtype=dtype)
    cpu = LM(cfg, device="cpu", seed=1)
    gpu = LM(cfg, device=cuda_device, params=_params_of(cpu))
    eng = Engine(gpu, slots=2, max_len=24, device=cuda_device)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 12))
    fa.reset_launches()
    wk.reset_launches()
    comps = eng.serve([Request(uid=i, prompt=p, max_new_tokens=4)
                       for i, p in enumerate(prompts)])
    assert sorted(c.uid for c in comps) == [0, 1, 2]
    assert eng.prefills == 2 and eng.decode_steps == 6
    if name == "rwkv6-3b":
        assert wk.LAUNCHES["wkv6"] == cfg.num_layers * (2 + 6)
        assert wk.LAUNCHES["wkv6_seq"] == 0
        assert fa.LAUNCHES["flash_attention"] == 0
    else:
        kind = "tc" if dtype == "bfloat16" else "split"
        n_attn = sum(cfg.block_kind(i) == "attn"
                     for i in range(cfg.num_layers))
        assert fa.LAUNCHES["flash_attention"] == n_attn * 2
        assert fa.LAUNCHES[f"flash_attention_{kind}"] == n_attn * 2
        for other in {"tc", "split", "scalar"} - {kind}:
            assert fa.LAUNCHES[f"flash_attention_{other}"] == 0
        assert wk.LAUNCHES["wkv6"] == 0
    tokens = torch.as_tensor(prompts[:2])
    want, _ = cpu.prefill({"tokens": tokens}, cpu.init_state(2, 24))
    got, _ = gpu.prefill({"tokens": tokens.to(cuda_device)},
                         gpu.init_state(2, 24))
    got, want = got.float().cpu(), want.float()
    if dtype == "float32":
        assert float((got - want).abs().max()) < 2e-3
    else:
        assert float((got - want).norm() / want.norm()) < 0.1


#: (B, Tq, Tk, H, G, D): bidirectional calls with Tq != Tk, the
#: encoder-decoder's: seamless-m4t-large-v2's cross prefill (its 1,024-token
#: prompt over 4,096 frames) and cross decode (one token over them), a
#: ragged source, Tk < Tq, one token at D = 256, one past a tile at D = 80
#: and at D = 160
BIDIR_CASES = [(4, 1024, 4096, 16, 16, 64), (4, 1, 4096, 16, 16, 64),
               (2, 7, 1000, 16, 16, 64), (1, 100, 37, 4, 2, 128),
               (2, 1, 130, 4, 1, 256), (1, 129, 300, 4, 4, 80),
               (1, 129, 300, 4, 4, 160)]


@pytest.mark.parametrize("case", BIDIR_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_flash_attention_bidirectional_tq_ne_tk(cuda_device, case,
                                                     dtype):
    """Both kernels with as many keys as the source has and as many
    queries as the call brings, against the plain version (fp32 atol
    2e-5, bf16 atol 2e-2, rtol 1e-2), one launch of the variant each.
    bf16 is also held to relative L2 1e-2: over 4,096 random keys the
    output is about 0.026, on the scale of its atol."""
    B, Tq, Tk, H, G, D = case
    gen = torch.Generator(device=cuda_device).manual_seed(sum(case))
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device
                           ).to(dtype)
               for shape in ((B, Tq, H, D), (B, Tk, G, D), (B, Tk, G, D)))
    kind = fa.variant(dtype, D)
    before = dict(fa.LAUNCHES)
    got = fa.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert fa.LAUNCHES[f"flash_attention_{kind}"] == \
        before[f"flash_attention_{kind}"] + 1
    want = fa.attention_ref(q, k, v, causal=False)
    assert got.shape == (B, Tq, H, D) and got.dtype == dtype
    atol = 2e-5 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=atol,
                               rtol=1e-2)
    if dtype == torch.bfloat16:
        got, want = got.float(), want.float()
        assert float((got - want).norm() / want.norm()) < 1e-2


def test_cuda_flash_attention_refuses_causal_tq_ne_tk(cuda_device):
    q = torch.zeros((1, 4, 2, 64), device=cuda_device, dtype=torch.bfloat16)
    k = torch.zeros((1, 9, 2, 64), device=cuda_device, dtype=torch.bfloat16)
    before = dict(fa.LAUNCHES)
    with pytest.raises(ValueError, match="causal"):
        fa.flash_attention(q, k, k, causal=True)
    assert fa.LAUNCHES == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_encdec_engine_serves_through_the_kernels(cuda_device, dtype):
    """The reduced encoder-decoder served on the card with its requests'
    frames (20 a request, ragged against every tile): a prefill launches
    the kernel once an encoder layer and twice a decoder layer, a decode
    step once a decoder layer (cross decode), every launch the variant
    the dtype names; the prefill logits equal the same weights' on the
    CPU (fp32 within 2e-3, bf16 within relative L2 0.1)."""
    from repro_torch.models import EncDec
    cfg = dataclasses.replace(
        configs.reduced(configs.get("seamless-m4t-large-v2")), dtype=dtype)
    cpu = EncDec(cfg, device="cpu", seed=1)
    params = {"embed": dict(cpu.embed.items()),
              "enc_layers": [{g: dict(b[g].items()) for g in b.groups}
                             for b in cpu.enc_blocks],
              "enc_norm": dict(cpu.enc_norm.items()),
              "dec_layers": [{g: dict(b[g].items()) for g in b.groups}
                             for b in cpu.dec_blocks],
              "final_norm": dict(cpu.final_norm.items())}
    gpu = EncDec(cfg, device=cuda_device, params=params)
    F = 20
    eng = Engine(gpu, slots=2, max_len=24, enc_len=F, device=cuda_device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (3, 12))
    frames = rng.standard_normal((3, F, cfg.d_model)).astype(np.float32)
    fa.reset_launches()
    comps = eng.serve([Request(uid=i, prompt=prompts[i], max_new_tokens=4,
                               frames=frames[i]) for i in range(3)])
    assert sorted(c.uid for c in comps) == [0, 1, 2]
    assert eng.prefills == 2 and eng.decode_steps == 6
    kind = "tc" if dtype == "bfloat16" else "split"
    n = (cfg.encoder_layers + 2 * cfg.num_layers) * 2 + cfg.num_layers * 6
    assert fa.LAUNCHES["flash_attention"] == \
        fa.LAUNCHES[f"flash_attention_{kind}"] == n
    E, L = cfg.encoder_layers, cfg.num_layers
    assert fa.SHAPE_LAUNCHES == {(kind, F, F, False): E * 2,
                                 (kind, 12, 12, True): L * 2,
                                 (kind, 12, F, False): L * 2,
                                 (kind, 1, F, False): L * 6}
    batch = {"tokens": torch.as_tensor(prompts[:2]),
             "frontend_embeds": torch.as_tensor(frames[:2])}
    want, _ = cpu.prefill(batch, cpu.init_state(2, 24, F))
    got, _ = gpu.prefill({k: v.to(cuda_device) for k, v in batch.items()},
                         gpu.init_state(2, 24, F))
    got, want = got.float().cpu(), want.float()
    if dtype == "float32":
        assert float((got - want).abs().max()) < 2e-3
    else:
        assert float((got - want).norm() / want.norm()) < 0.1


def _vlm_config(dtype):
    """Reduced pixtral-12b at its real head size 160 (d_model 320, 2 query
    heads on one KV head), in ``dtype``."""
    cfg = configs.reduced(configs.get("pixtral-12b"), d_model=320)
    return dataclasses.replace(cfg, num_heads=2, num_kv_heads=1,
                               head_dim=160, dtype=dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_vlm_engine_serves_patches_through_the_kernel(cuda_device,
                                                           dtype):
    """Reduced pixtral-12b at D = 160 served on the card with its
    requests' patches (20 a request, ragged against the 64-row tile): a
    prefill launches the variant the dtype names once a layer, causal
    over the patches and the prompt; the prefill logits equal the same
    weights' on the CPU (fp32 within 2e-3, bf16 within relative L2
    0.1)."""
    cfg = _vlm_config(dtype)
    cpu = LM(cfg, device="cpu", seed=1)
    gpu = LM(cfg, device=cuda_device, params=_params_of(cpu))
    F, T = 20, 12
    eng = Engine(gpu, slots=2, max_len=F + T + 4, device=cuda_device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (3, T))
    patches = rng.standard_normal((3, F, cfg.d_model)).astype(np.float32)
    fa.reset_launches()
    comps = eng.serve([Request(uid=i, prompt=prompts[i], max_new_tokens=4,
                               frames=patches[i]) for i in range(3)])
    assert sorted(c.uid for c in comps) == [0, 1, 2]
    assert eng.prefills == 2 and eng.decode_steps == 6
    kind = "tc" if dtype == "bfloat16" else "split"
    n = cfg.num_layers * 2
    assert fa.LAUNCHES["flash_attention"] == \
        fa.LAUNCHES[f"flash_attention_{kind}"] == n
    assert fa.SHAPE_LAUNCHES == {(kind, F + T, F + T, True): n}
    batch = {"tokens": torch.as_tensor(prompts[:2]),
             "frontend_embeds": torch.as_tensor(patches[:2])}
    want, _ = cpu.prefill(batch, cpu.init_state(2, F + T))
    got, _ = gpu.prefill({k: v.to(cuda_device) for k, v in batch.items()},
                         gpu.init_state(2, F + T))
    got, want = got.float().cpu(), want.float()
    if dtype == "float32":
        assert float((got - want).abs().max()) < 2e-3
    else:
        assert float((got - want).norm() / want.norm()) < 0.1


def test_cuda_pixtral_prefill_kernel_against_plain(cuda_device):
    """pixtral-12b at full width cut to 2 layers, bf16: a prefill of 2 x
    (256 patches + 256 tokens) through the tensor-core kernel at D = 160
    and with the plain attention in its place, within the LM path's bf16
    bound (relative L2 0.1, ``chip_smoke.REL_L2_TOL``); one launch a
    layer, all logits finite."""
    from repro_torch.kernels import ops
    cfg = dataclasses.replace(configs.get("pixtral-12b"), num_layers=2)
    lm = LM(cfg, device=cuda_device, seed=3)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 256),
                                     generator=gen, device=cuda_device),
             "frontend_embeds": torch.randn((2, 256, cfg.d_model),
                                            generator=gen,
                                            device=cuda_device)}
    fa.reset_launches()
    with torch.inference_mode():
        got, _ = lm.prefill(batch, lm.init_state(2, 512))
        assert fa.SHAPE_LAUNCHES == {("tc", 512, 512, True): 2}
        path = ops.flash_attention
        ops.flash_attention = fa.attention_ref
        try:
            want, _ = lm.prefill(batch, lm.init_state(2, 512))
        finally:
            ops.flash_attention = path
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    assert float((got - want).norm() / want.norm()) < 0.1


def _moe_weights(specs, rng):
    """A numpy leaf per spec, at 1/sqrt(the contraction width) (the router
    at its own 0.02), so the MoE output is of order 1."""
    if isinstance(specs, dict):
        return {k: _moe_weights(v, rng) for k, v in specs.items()}
    scale = specs.scale or 1.0 / np.sqrt(specs.shape[-2])
    return (rng.standard_normal(specs.shape) * scale).astype(np.float32)


def _tensors(tree, device):
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    return torch.from_numpy(tree).to(device)


@pytest.mark.parametrize("T", [1, 64], ids=["decode", "prefill"])
@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b",
                                  "llama4-maverick-400b-a17b"])
def test_cuda_moe_apply_matches_cpu(cuda_device, name, T):
    """The MoE layer on the card against the same call on the CPU, fp32,
    reduced (8 experts; qwen3-moe top-2, llama4 top-1 with its shared
    expert), at the default capacity factor: the same routes (expert ids
    and kept slots), ``y`` and the load-balance term within 1e-5 (the
    card's fp32 products are full fp32, only their sums' order differs)."""
    from repro_torch.models import layers as L
    cfg = configs.reduced(configs.get(name))
    rng = np.random.default_rng(T)
    weights = _moe_weights(L.moe_specs(cfg), rng)
    x = rng.standard_normal((4, T, cfg.d_model)).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda_device):
        p, xt = _tensors(weights, dev), torch.from_numpy(x).to(dev)
        _, gates, idx = L.moe_route(p, cfg, xt)
        y, aux = L.moe_apply(p, cfg, xt)
        pos = L._positions_in_expert(idx.reshape(4, -1))
        out[str(dev)] = [t.cpu() for t in (gates, idx, pos, y, aux)]
    (g0, i0, p0, y0, a0), (g1, i1, p1, y1, a1) = out["cpu"], out["cuda"]
    assert torch.equal(i0, i1) and torch.equal(p0, p1)
    assert float(y0.abs().max()) > 0.5
    for a, b in ((g0, g1), (y0, y1), (a0, a1)):
        assert float((a - b).abs().max()) < 1e-5


# --- the sharded fleet and the device guard ------------------------------------

@pytest.mark.parametrize("C", [10_000, 10_003])
@pytest.mark.parametrize("D", [2, 3, 4])
def test_cuda_split_tick_is_bitwise_the_whole_tick(cuda_device, D, C):
    """``row_minima`` on each column block, the min across blocks and
    ``fold_scores`` on each block, against one ``fused_reprice`` over all
    C on the same inputs: scores, row minima and ``moved`` bit for bit
    (the fold's sums run in an order fixed by J alone).  C = 10,003 gives
    blocks whose width is no multiple of 4 (``rowmin``'s scalar loads)."""
    hours, mask, oldp, newp, changed, rb, rm, scores, _ = _tick_inputs(
        40 + D, J=64, C=C, S=16, n_changed=C // 100, masked_rows=(7,),
        device=cuda_device)
    whole, rb_whole, moved_whole = rd.fused_reprice(
        hours, mask, oldp, newp, changed, rb, rm, scores)
    width = -(-C // D)
    blocks = [slice(lo, min(lo + width, C)) for lo in range(0, C, width)]

    def part(t, b):
        return t[:, b].contiguous()

    before = dict(rd.LAUNCHES)
    partial = [rd.row_minima(part(hours, b), part(mask, b), part(newp, b),
                             rb)[0] for b in blocks]
    got_rb = partial[0]
    for p in partial[1:]:
        got_rb = torch.minimum(got_rb, p)
    out = torch.cat([rd.fold_scores(
        part(hours, b), part(mask, b), part(oldp, b), part(newp, b),
        part(changed, b), rb, got_rb, rm, part(scores, b))
        for b in blocks], dim=1)
    assert rd.LAUNCHES["rowmin"] - before["rowmin"] == len(blocks)
    assert rd.LAUNCHES["fold"] - before["fold"] == len(blocks)
    assert torch.equal(got_rb.view(torch.int32), rb_whole.view(torch.int32))
    assert int((got_rb != rb).sum()) == int(moved_whole)
    assert torch.equal(out.view(torch.int32), whole.view(torch.int32))


@pytest.mark.parametrize("layout", ["two_on_one_card", "one_a_card"])
def test_cuda_sharded_fleet_matches_fused_fleet(cuda_device, layout):
    """Two shards on one card, or one shard a card (every local card;
    needs two), against the fused fleet, tick by tick: the same handoff
    counts, every member within the contract of the fused fleet's scores
    and of the cold rank, heads naming the fused fleet's configs and equal
    to ``ranking()[:k]``; one ``scatter``, ``rowmin`` and ``fold`` a shard
    a tick and one ``select`` a shard a ``heads`` call."""
    if layout == "two_on_one_card":
        devices = [cuda_device] * 2
    elif torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices (one shard a card)")
    else:
        devices = None
    rng = np.random.default_rng(8)
    J, C = 24, 3_001
    hours = rng.uniform(0.05, 10.0, (J, C))
    mask = rng.random((J, C)) > 0.15
    mask[np.arange(J), rng.integers(0, C, J)] = True
    prices = rng.uniform(0.5, 20.0, C)
    ids = [f"c{i}" for i in range(C)]
    members = {"all": list(range(J))}
    for m in range(7):
        members[f"m{m}"] = sorted(int(i) for i in rng.choice(
            J, int(rng.integers(1, J)), replace=False))
    sharded = TorchShardedRankState(hours, mask, prices, ids,
                                    devices=devices)
    D = sharded.n_devices
    fused = TorchFusedRankState(hours, mask, prices, ids,
                                device=cuda_device)
    for key, rows in members.items():
        sharded.add_state(key, rows=rows)
        fused.add_state(key, rows=rows)
    live = sharded.prices.copy()
    keys = list(members)
    for tick in range(6):
        cols = rng.choice(C, 30, replace=False)
        new = (live[cols] * rng.uniform(0.7, 1.3, 30)).astype(np.float32)
        deltas = {ids[c]: float(p) for c, p in zip(cols, new)}
        rd.reset_launches()
        moved = sharded.reprice(deltas)
        assert {n: rd.LAUNCHES[n] for n in ("scatter", "rowmin", "fold")} \
            == dict.fromkeys(("scatter", "rowmin", "fold"), D)
        assert moved == fused.reprice(deltas)
        rd.reset_launches()
        live[cols] = new
        heads = sharded.heads(keys, 10)
        assert rd.LAUNCHES["select"] == D
        # the same configs in the same order; a member's first
        # accumulators, a matmul at the shard's width, may round apart
        for got, want in zip(heads, fused.heads(keys, 10)):
            assert [r.config_id for r in got] == [r.config_id for r in want]
            assert all(CONTRACT.scores_match(g.score, w.score)
                       for g, w in zip(got, want))
        for key, rows in members.items():
            got = sharded.ranking(key)
            assert heads[keys.index(key)] == got[:10]
            for want in (fused.ranking(key),
                         rank_dense(hours[rows], mask[rows], live, ids)):
                assert CONTRACT.winner_matches(got[0].config_id, want)
                ref = {r.config_id: r.score for r in want}
                assert all(CONTRACT.scores_match(r.score, ref[r.config_id])
                           for r in got)
    assert sharded.top_k("all", 1_000) == sharded.ranking("all")[:1_000]
    assert sharded.dispatches == 6


def test_cuda_sharded_devices_above_the_card_count_raise(cuda_device):
    n = torch.cuda.device_count()
    hours, mask = np.ones((2, 3)), np.ones((2, 3), bool)
    for bad in (n + 1, [f"cuda:{n}"], 0):
        with pytest.raises(ValueError, match="devices"):
            TorchShardedRankState(hours, mask, np.ones(3), ["a", "b", "c"],
                                  devices=bad)
    s = TorchShardedRankState(hours, mask, np.ones(3), ["a", "b", "c"])
    assert s.n_devices == n


def test_cuda_kernels_launch_on_their_tensors_device(cuda_device):
    """With card 0 current, every kernel on tensors of the last card runs
    there and agrees with its plain version, and card 0 stays current.
    Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices (a tensor off the current "
                    "card)")
    last = torch.device("cuda", torch.cuda.device_count() - 1)
    torch.cuda.set_device(0)
    hours, mask, oldp, newp, changed, rb, rm, scores, fin = _tick_inputs(
        9, J=13, C=5_000, S=8, n_changed=50, device=last)
    cols = np.arange(0, 5_000, 97, dtype=np.int32)
    pr = np.linspace(0.5, 2.0, cols.size).astype(np.float32)
    got_p = rd.scatter_prices(cols, pr, oldp)
    want_p = rd.scatter_prices_plain(cols, pr, oldp)
    assert all(torch.equal(a, b) for a, b in zip(got_p, want_p))
    got_rb, got_mv = rd.row_minima(hours, mask, newp, rb)
    want_rb, want_mv = rd.rowmin_plain(hours, mask, newp, rb)
    assert torch.equal(got_rb, want_rb) and torch.equal(got_mv, want_mv)
    out = rd.fold_scores(hours, mask, oldp, newp, changed, rb, got_rb, rm,
                         scores)
    want = rd.fold_plain(hours, mask, oldp, newp, changed, rb, got_rb, rm,
                         scores)
    tol = ABS + REL * torch.maximum(out.abs(), want.abs())
    assert bool(((out - want).abs() <= tol).all())
    for k in (10, 300):
        ti, tv = rd.select_heads(out, fin, k)
        pi, pv = rd.select_heads_plain(out, fin, k)
        assert torch.equal(ti, pi) and torch.equal(tv, pv)
    gen = torch.Generator(device=last).manual_seed(3)
    for dtype in (torch.bfloat16, torch.float32):
        q, k_, v = (torch.randn((1, 100, 4, 64), generator=gen,
                                device=last).to(dtype) for _ in range(3))
        got = fa.flash_attention(q, k_, v, causal=True)
        want = fa.attention_ref(q, k_, v, causal=True)
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(),
                                   atol=2e-2 if dtype == torch.bfloat16
                                   else 2e-5, rtol=1e-2)
    args = _wkv_inputs(last, 1, 37, 2, 64, torch.float32)
    _wkv_close(wk.wkv6(*args), wk.wkv6_scan_ref(*args))
    torch.cuda.synchronize(last)
    assert torch.cuda.current_device() == 0


# --- training: the attention backward kernel, the loss on the card -------------

#: (B, Tq, Tk, H, G, causal, window): causal, a window, bidirectional with
#: Tq != Tk (fully masked rows at Tq > Tk with a window), GQA R = 1, 2, 4
#: and 48, ragged T, Tq = 1
BWD_CASES = [(2, 128, 128, 4, 2, True, None), (1, 100, 100, 4, 1, True, 16),
             (2, 37, 53, 4, 4, False, None), (1, 100, 37, 4, 2, False, 8),
             (2, 1, 130, 4, 1, False, None), (1, 70, 70, 48, 1, True, None),
             (1, 1, 1, 4, 4, True, None)]
BWD_LIMIT = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _rel_or_floor(got, want, floor):
    """Relative L2, against ``floor`` where the true gradient vanishes
    (dq and dk at Tq = Tk = 1, where the softmax is constant)."""
    got, want = got.double(), want.double()
    denom = want.norm()
    if denom < 1e-6 * floor:
        denom = floor
    return float((got - want).norm() / denom)


def _bwd_inputs(device, dtype, D, case, seed):
    B, Tq, Tk, H, G, causal, window = case
    gen = torch.Generator(device=device).manual_seed(seed)
    q, do = (torch.randn((B, Tq, H, D), generator=gen,
                         device=device).to(dtype) for _ in range(2))
    k, v = (torch.randn((B, Tk, G, D), generator=gen,
                        device=device).to(dtype) for _ in range(2))
    o = fa.attention_ref(q, k, v, causal=causal, window=window).contiguous()
    return q, k, v, o, do


@pytest.mark.parametrize("D", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
def test_cuda_attention_bwd_matches_plain(cuda_device, D, dtype):
    """Each backward variant that takes (dtype, D) against the plain
    version on every case: the one ``bwd_variant`` names (the tensor-core
    kernel for bf16, the split one for fp32, both at every D; the split
    one's column pair at D = 160 and 256), and the scalar yardstick too,
    reached by name at every D (fp32 at 160 and 256 included); one
    launch a call, counted in the total and its variant."""
    routed = fa.bwd_variant(dtype, D)
    kinds = [routed, "scalar"] if routed != "scalar" else ["scalar"]
    for i, case in enumerate(BWD_CASES):
        q, k, v, o, do = _bwd_inputs(cuda_device, dtype, D, case, D + i)
        causal, window = case[5], case[6]
        want = fa.attention_bwd_ref(q, k, v, o, do, causal=causal,
                                    window=window)
        for kind in kinds:
            before = dict(fa.LAUNCHES)
            got = fa._launch_bwd(q, k, v, o, do, causal, window, kind=kind)
            assert fa.LAUNCHES["flash_attention_bwd"] == \
                before["flash_attention_bwd"] + 1
            assert fa.LAUNCHES[f"flash_attention_bwd_{kind}"] == \
                before[f"flash_attention_bwd_{kind}"] + 1
            torch.cuda.synchronize()
            floor = float(want[2].double().norm())
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                assert g.dtype == dtype and g.shape == w.shape
                err = _rel_or_floor(g, w, floor)
                assert err < BWD_LIMIT[dtype], (kind, name, case, err)


@pytest.mark.parametrize("D", fa.BWD_TC_HEAD_DIMS)
def test_cuda_attention_bwd_tc_is_deterministic(cuda_device, D):
    """Two calls of the tensor-core backward on the same inputs give the
    same bits: every block owns its output rows and sums in a fixed
    order (no atomics)."""
    for i, case in enumerate(BWD_CASES):
        q, k, v, o, do = _bwd_inputs(cuda_device, torch.bfloat16, D, case,
                                     7 * D + i)
        first = fa._launch_bwd(q, k, v, o, do, case[5], case[6])
        second = fa._launch_bwd(q, k, v, o, do, case[5], case[6])
        torch.cuda.synchronize()
        for a, b in zip(first, second):
            assert torch.equal(a, b), case


@pytest.mark.parametrize("D", fa.BWD_SPLIT_HEAD_DIMS)
def test_cuda_attention_bwd_split_is_deterministic(cuda_device, D):
    """Two calls of the split backward (fp32 on three bf16 pieces, at
    every head size; D = 160 and 256 as column pairs whose S and dP
    partials are summed across a cluster) on the same inputs give the
    same bits, as the tensor-core one's."""
    for i, case in enumerate(BWD_CASES):
        q, k, v, o, do = _bwd_inputs(cuda_device, torch.float32, D, case,
                                     5 * D + i)
        first = fa._launch_bwd(q, k, v, o, do, case[5], case[6])
        second = fa._launch_bwd(q, k, v, o, do, case[5], case[6])
        torch.cuda.synchronize()
        for a, b in zip(first, second):
            assert torch.equal(a, b), case


#: the D = 160 and 256 cases of ATTN_CASES: the training shapes of
#: pixtral-12b and recurrentgemma-9b, the 4,096-token one past the 2,048
#: window, windows, bidirectional, T = 1 and one past a tile
WIDE_BWD_CASES = [c for c in ATTN_CASES if c[4] in (160, 256)]


@pytest.mark.parametrize("case", WIDE_BWD_CASES, ids=str)
def test_cuda_attention_bwd_tc_at_wide_head_sizes(cuda_device, case):
    """The tensor-core backward at D = 160 and 256 (two warpgroups a
    block; dK/dV's key tiles split over a cluster where the KV heads are
    few) against ``attention_bwd_ref``: each of dq, dk, dv within
    relative L2 1e-2, one launch counted under ``tc``, none under
    ``scalar``."""
    B, T, H, G, D, causal, window = case
    q, k, v, o, do = _bwd_inputs(cuda_device, torch.bfloat16, D,
                                 (B, T, T, H, G, causal, window), 11 * D + T)
    assert fa.bwd_variant(torch.bfloat16, D) == "tc"
    fa.reset_launches()
    got = fa._launch_bwd(q, k, v, o, do, causal, window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention_bwd_tc"] == 1
    assert fa.LAUNCHES["flash_attention_bwd_scalar"] == 0
    want = fa.attention_bwd_ref(q, k, v, o, do, causal=causal, window=window)
    floor = float(want[2].double().norm())
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        err = _rel_or_floor(g, w, floor)
        assert err < BWD_LIMIT[torch.bfloat16], (name, case, err)


@pytest.mark.parametrize("case", WIDE_BWD_CASES, ids=str)
def test_cuda_attention_bwd_split_at_wide_head_sizes(cuda_device, case):
    """The split backward at D = 160 and 256 (fp32; dQ and dK/dV as
    column pairs over a cluster, dK/dV's query heads split over it too
    where the KV heads are few) against ``attention_bwd_ref``: each of
    dq, dk, dv within relative L2 1e-5, one launch counted under
    ``split``, none under ``scalar``."""
    B, T, H, G, D, causal, window = case
    q, k, v, o, do = _bwd_inputs(cuda_device, torch.float32, D,
                                 (B, T, T, H, G, causal, window), 13 * D + T)
    assert fa.bwd_variant(torch.float32, D) == "split"
    fa.reset_launches()
    got = fa._launch_bwd(q, k, v, o, do, causal, window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention_bwd_split"] == 1
    assert fa.LAUNCHES["flash_attention_bwd_scalar"] == 0
    want = fa.attention_bwd_ref(q, k, v, o, do, causal=causal, window=window)
    floor = float(want[2].double().norm())
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        err = _rel_or_floor(g, w, floor)
        assert err < BWD_LIMIT[torch.float32], (name, case, err)


@pytest.mark.parametrize("D", [160, 256])
def test_cuda_flash_attention_backward_counts_by_variant(cuda_device, D):
    """A bf16 call with gradients at D = 160 and 256 through
    ``flash_attention``: one forward and one backward launch, both on the
    tensor cores; the scalar kernels' counts stay 0.  The backward is
    first launched on this thread (which sets the kernels' attributes)
    and then on a new host thread, which has no current context until a
    launch binds one, as autograd's backward thread has none on its first
    launch; both give the autograd call's bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(D)
    q = torch.randn((2, 130, 4, D), generator=gen, device=cuda_device)
    k, v = (torch.randn((2, 130, 1, D), generator=gen, device=cuda_device)
            for _ in range(2))
    leaves = [t.to(torch.bfloat16).requires_grad_() for t in (q, k, v)]
    do = torch.randn(q.shape, generator=gen, device=cuda_device).to(
        torch.bfloat16)
    with torch.no_grad():
        o = fa._launch(*leaves, True, None)
    main = fa._launch_bwd(*leaves, o, do, True, None)
    fresh = {}

    def launch():
        try:
            fresh["grads"] = fa._launch_bwd(*leaves, o, do, True, None)
            torch.cuda.synchronize()
        except Exception as exc:   # re-raised on the test's thread
            fresh["error"] = exc
    thread = threading.Thread(target=launch)
    thread.start()
    thread.join()
    if "error" in fresh:
        raise fresh["error"]
    fa.reset_launches()
    out = fa.flash_attention(*leaves, causal=True)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert {name: n for name, n in fa.LAUNCHES.items()} == {
        "flash_attention": 1, "flash_attention_tc": 1,
        "flash_attention_split": 0, "flash_attention_scalar": 0,
        "flash_attention_bwd": 1, "flash_attention_bwd_tc": 1,
        "flash_attention_bwd_split": 0, "flash_attention_bwd_scalar": 0}
    assert fa.SHAPE_LAUNCHES[("bwd_tc", 130, 130, True)] == 1
    for a, b, c in zip(main, fresh["grads"], got):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_cuda_attention_bwd_refuses_tc_where_scalar(cuda_device):
    """The tensor-core backward named where ``bwd_variant`` names another
    kernel (fp32: the split one, at D = 64, 160 and 256) raises, and
    launches nothing; so does the split backward named in bf16 (at D =
    64, 160 and 256)."""
    for dtype, D in ((torch.float32, 64), (torch.float32, 160),
                     (torch.float32, 256)):
        q, k, v, o, do = _bwd_inputs(cuda_device, dtype, D, BWD_CASES[0], 0)
        before = dict(fa.LAUNCHES)
        with pytest.raises(ValueError, match="takes bf16 at head sizes"):
            fa._launch_bwd(q, k, v, o, do, True, None, kind="tc")
        assert fa.LAUNCHES == before
    for dtype, D in ((torch.bfloat16, 160), (torch.bfloat16, 256),
                     (torch.bfloat16, 64)):
        q, k, v, o, do = _bwd_inputs(cuda_device, dtype, D, BWD_CASES[0], 0)
        before = dict(fa.LAUNCHES)
        with pytest.raises(ValueError, match="takes float32 at head sizes"):
            fa._launch_bwd(q, k, v, o, do, True, None, kind="split")
        assert fa.LAUNCHES == before


def test_cuda_flash_attention_backward_routes_through_the_kernel(
        cuda_device):
    """With gradients wanted, ``flash_attention`` goes through the
    autograd Function: one forward and one backward launch; without them
    (``inference_mode``) the forward alone, as serving runs it."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn((2, 64, 4, 64), generator=gen, device=cuda_device)
    k, v = (torch.randn((2, 64, 2, 64), generator=gen, device=cuda_device)
            for _ in range(2))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.reset_launches()
    o = fa.flash_attention(*leaves, causal=True)
    do = torch.randn_like(o)
    got = torch.autograd.grad(o, leaves, do)
    assert fa.LAUNCHES["flash_attention"] == 1
    assert fa.LAUNCHES["flash_attention_bwd"] == 1
    want = fa.attention_bwd_ref(q, k, v, o.detach(), do, causal=True)
    for g, w in zip(got, want):
        assert _rel_or_floor(g, w, 1.0) < 1e-5
    fa.reset_launches()
    with torch.inference_mode():
        fa.flash_attention(*leaves, causal=True)
    assert fa.LAUNCHES["flash_attention"] == 1
    assert fa.LAUNCHES["flash_attention_bwd"] == 0


#: the WKV6 backward's cases (B, T, H, N): a step alone, ragged T, one
#: past the 16-step chunk and past a power of two, every head size, and
#: rwkv6-3b's training shape
WKV_BWD_SHAPES = [(2, 1, 3, 64), (1, 37, 2, 64), (2, 100, 2, 16),
                  (1, 64, 4, 32), (2, 17, 3, 64), (1, 1025, 2, 64),
                  (4, 1024, 40, 64)]


def _wkv_bwd_inputs(device, shape, dtype, seed):
    """The forward's inputs (strong decays, a random s0), dy and dsT."""
    B, T, H, N = shape
    args = _wkv_inputs(device, *shape, dtype, seed=seed, strong=True)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    dy = torch.randn((B, T, H, N), generator=gen, device=device)
    dsT = torch.randn((B, H, N, N), generator=gen, device=device)
    return args, dy, dsT


@pytest.mark.parametrize("shape", WKV_BWD_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_wkv6_backward_matches_plain(cuda_device, shape, dtype):
    """The forward's checkpoints against ``wkv6_fwd_ref``, and the backward
    kernel (one launch) against ``wkv6_bwd_ref``: each of dr, dk, dv, dw,
    du and ds0 within relative L2 1e-5 (fp32) or 1e-2 (bf16), with a
    nonzero dsT, and without dsT or ds0 as the train step launches it."""
    args, dy, dsT = _wkv_bwd_inputs(cuda_device, shape, dtype, 11)
    y, sT, ckpt = wk._launch(*args, ckpt=True)
    _wkv_close((y, sT, ckpt), wk.wkv6_fwd_ref(*args))
    for cot, want_ds0 in ((dsT, True), (None, False)):
        before = dict(wk.LAUNCHES)
        got = wk._launch_bwd(*args[:5], ckpt, dy, cot, want_ds0)
        torch.cuda.synchronize()
        assert {n: wk.LAUNCHES[n] - before[n] for n in before} == {
            "wkv6": 0, "wkv6_seq": 0, "wkv6_bwd": 1, "wkv6_bwd_block": 0}
        want = wk.wkv6_bwd_ref(*args, dy, cot)
        assert (got[5] is not None) == want_ds0
        for name, g, w in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got,
                              want[:6 if want_ds0 else 5]):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            assert _rel_or_floor(g, w, 1.0) < BWD_LIMIT[dtype], name


def test_cuda_wkv6_backward_is_deterministic(cuda_device):
    """Two calls give the same bits: every sum is taken in a fixed order
    (over the lanes by a fixed butterfly, over a cluster's ranks in rank
    order), du's over b by a second kernel in order (no atomics)."""
    for i, shape in enumerate(WKV_BWD_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            args, dy, dsT = _wkv_bwd_inputs(cuda_device, shape, dtype, i)
            _, _, ckpt = wk._launch(*args, ckpt=True)
            first = wk._launch_bwd(*args[:5], ckpt, dy, dsT, True)
            second = wk._launch_bwd(*args[:5], ckpt, dy, dsT, True)
            torch.cuda.synchronize()
            for a, b in zip(first, second):
                assert torch.equal(a, b), (shape, dtype)


@pytest.mark.parametrize("shape", WKV_BWD_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("variant", ["cluster", "block"])
def test_cuda_wkv6_backward_variants_match_plain(cuda_device, variant, shape,
                                                 dtype):
    """Each backward kernel by name (the cluster kernel the train step runs,
    and the one-block-a-stream yardstick) against ``wkv6_bwd_ref``, strong
    decays, a nonzero s0 and dsT: one launch counted under its variant,
    each of the six gradients within relative L2 1e-5 (fp32) or 1e-2
    (bf16)."""
    args, dy, dsT = _wkv_bwd_inputs(cuda_device, shape, dtype, 17)
    _, _, ckpt = wk._launch(*args, ckpt=True)
    before = dict(wk.LAUNCHES)
    got = wk._launch_bwd(*args[:5], ckpt, dy, dsT, True, variant=variant)
    torch.cuda.synchronize()
    assert {n: wk.LAUNCHES[n] - before[n] for n in before} == {
        "wkv6": 0, "wkv6_seq": 0, "wkv6_bwd": 1,
        "wkv6_bwd_block": int(variant == "block")}
    want = wk.wkv6_bwd_ref(*args, dy, dsT)
    for name, g, w in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert _rel_or_floor(g, w, 1.0) < BWD_LIMIT[dtype], name


@pytest.mark.parametrize("shape", [(4, 1024, 40, 64), (1, 1025, 2, 64),
                                   (2, 37, 3, 32), (2, 100, 2, 16)], ids=str)
def test_cuda_wkv6_backward_five_calls_bitwise(cuda_device, shape):
    """Five calls of the cluster kernel on the same inputs give the same
    bits, at rwkv6-3b's training shape and at ragged T, with and without
    dsT and ds0."""
    args, dy, dsT = _wkv_bwd_inputs(cuda_device, shape, torch.bfloat16, 19)
    _, _, ckpt = wk._launch(*args, ckpt=True)
    for cot, want_ds0 in ((dsT, True), (None, False)):
        calls = [wk._launch_bwd(*args[:5], ckpt, dy, cot, want_ds0)
                 for _ in range(5)]
        torch.cuda.synchronize()
        for other in calls[1:]:
            for a, b in zip(calls[0], other):
                assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("shape", WKV_BWD_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_wkv6_backward_cluster_matches_yardstick(cuda_device, shape,
                                                      dtype):
    """The cluster kernel against the kernel it replaced, on the same
    inputs: each gradient within ``BWD_LIMIT``."""
    args, dy, dsT = _wkv_bwd_inputs(cuda_device, shape, dtype, 23)
    _, _, ckpt = wk._launch(*args, ckpt=True)
    new = wk._launch_bwd(*args[:5], ckpt, dy, dsT, True)
    old = wk._launch_bwd(*args[:5], ckpt, dy, dsT, True, variant="block")
    torch.cuda.synchronize()
    for name, a, b in zip(("dr", "dk", "dv", "dw", "du", "ds0"), new, old):
        assert _rel_or_floor(a, b, 1.0) < BWD_LIMIT[dtype], name


def test_cuda_wkv6_backward_runs_in_one_wave(cuda_device):
    """At rwkv6-3b's training shape in bf16 (B = 4, H = 40: 160 streams)
    the card holds every cluster (two blocks of 32 state columns) at once;
    the yardstick's 160 blocks of one an SM do not fit."""
    if torch.cuda.get_device_properties(0).multi_processor_count < 132:
        pytest.skip("the one-wave claim is for a 132-SM H100")
    occ = wk.bwd_occupancy(64, torch.bfloat16)
    assert occ["blocks_per_stream"] == 2 and occ["clusters"] >= 160, occ
    old = wk.bwd_occupancy(64, torch.bfloat16, "block")
    assert old["clusters"] == 0 and old["blocks_per_sm"] == 1, old


def test_cuda_wkv6_gradients_route_through_the_kernels(cuda_device):
    """With gradients wanted, ``wkv6`` goes through ``WKV6Fn``: one forward
    launch (with checkpoints) and one backward launch, the gradients of
    every input against the plain backward; under ``inference_mode`` the
    forward alone, as serving runs it."""
    args, dy, dsT = _wkv_bwd_inputs(cuda_device, (2, 40, 3, 64),
                                    torch.bfloat16, 5)
    leaves = [t.clone().requires_grad_() for t in args]
    wk.reset_launches()
    y, sT = wk.wkv6(*leaves)
    got = torch.autograd.grad((y, sT), leaves, (dy, dsT))
    assert wk.LAUNCHES == {"wkv6": 1, "wkv6_seq": 0, "wkv6_bwd": 1,
                           "wkv6_bwd_block": 0}
    want = wk.wkv6_bwd_ref(*args, dy, dsT)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert _rel_or_floor(g, w, 1.0) < BWD_LIMIT[torch.bfloat16]
    wk.reset_launches()
    with torch.inference_mode():
        wk.wkv6(*leaves)
    assert wk.LAUNCHES == {"wkv6": 1, "wkv6_seq": 0, "wkv6_bwd": 0,
        "wkv6_bwd_block": 0}


def test_cuda_reduced_rwkv_training_step_matches_cpu(cuda_device):
    """A reduced rwkv6-3b train step in fp32 on the card (the split kernel
    twice a layer with remat, the backward kernel once) against the same
    step on the CPU."""
    from repro_torch.train.train_loop import (TrainConfig, make_train_step,
                                              trainable_params)
    cfg = configs.reduced(configs.get("rwkv6-3b"))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 40)).astype(
                 np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (2, 40)).astype(
                 np.int32)}
    out = []
    for dev in ("cpu", cuda_device):
        model = LM(cfg, device="cpu", seed=0).to(dev)
        params = trainable_params(model)
        step, opt = make_train_step(model, TrainConfig())
        wk.reset_launches()
        _, _, m = step(params, opt.init(params), batch)
        out.append((float(m["loss"]), {k: p.detach().cpu()
                                       for k, p in params.items()},
                    dict(wk.LAUNCHES)))
    (l_cpu, p_cpu, _), (l_gpu, p_gpu, launches) = out
    assert launches == {"wkv6": 2 * cfg.num_layers, "wkv6_seq": 0,
                        "wkv6_bwd": cfg.num_layers, "wkv6_bwd_block": 0}
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-5)
    for k in p_cpu:
        np.testing.assert_allclose(p_gpu[k].numpy(), p_cpu[k].numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_cuda_reduced_training_step_matches_cpu(cuda_device):
    """A reduced qwen3-1.7b train step in fp32 on the card (the forward
    and backward kernels, 2 + 2 forward launches with remat, 2 backward)
    against the same step on the CPU."""
    from repro_torch.train.train_loop import (TrainConfig, make_train_step,
                                              trainable_params)
    cfg = configs.reduced(configs.get("qwen3-1.7b"))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 40)).astype(
                 np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (2, 40)).astype(
                 np.int32)}
    out = []
    for dev in ("cpu", cuda_device):
        model = LM(cfg, device="cpu", seed=0).to(dev)
        params = trainable_params(model)
        # the defaults' first rate, 3e-6: an element whose gradient is at
        # rounding level may step either way (see test_torch_train.py)
        step, opt = make_train_step(model, TrainConfig())
        fa.reset_launches()
        _, _, m = step(params, opt.init(params), batch)
        out.append((float(m["loss"]), {k: p.detach().cpu()
                                       for k, p in params.items()},
                    dict(fa.LAUNCHES)))
    (l_cpu, p_cpu, _), (l_gpu, p_gpu, launches) = out
    assert launches["flash_attention"] == 4
    assert launches["flash_attention_bwd"] == 2
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-5)
    for k in p_cpu:
        np.testing.assert_allclose(p_gpu[k].numpy(), p_cpu[k].numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_cuda_forward_rows_with_no_key_match_plain(cuda_device):
    """ROADMAP.md §C, entry 9 (closed): a bidirectional call with a
    window and Tq > Tk leaves rows with no key in reach (row t sees key s
    when t - s < 8: rows from 37 - 1 + 8 = 44 see none).  The forward
    kernels give such a row ``attention_ref``'s mean of v over the Tk
    keys, and every other row its own softmax: fp32 on the split and the
    scalar kernel (atol 2e-5), bf16 on the tensor-core and the scalar
    kernel (atol 2e-2, as the other forward checks)."""
    for Tq in (100, 45):
        for dtype, kinds, atol in ((torch.float32, ("split", "scalar"),
                                    2e-5),
                                   (torch.bfloat16, ("tc", "scalar"), 2e-2)):
            gen = torch.Generator(device=cuda_device).manual_seed(3)
            q = torch.randn((1, Tq, 4, 32), generator=gen,
                            device=cuda_device).to(dtype)
            k, v = (torch.randn((1, 37, 2, 32), generator=gen,
                                device=cuda_device).to(dtype)
                    for _ in range(2))
            want = fa.attention_ref(q, k, v, causal=False, window=8).float()
            mean_v = v.float().mean(1, keepdim=True).repeat_interleave(2, 2)
            assert torch.allclose(want[:, 44:], mean_v.expand_as(
                want[:, 44:]), atol=1e-2)
            for kind in kinds:
                got = fa._launch(q, k, v, False, 8, kind).float()
                torch.cuda.synchronize()
                assert torch.allclose(got, want, atol=atol, rtol=1e-2), \
                    (Tq, dtype, kind, float((got - want).abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
def test_cuda_flash_attention_gradients_on_rows_with_no_key(cuda_device,
                                                           dtype):
    """``flash_attention`` takes a bidirectional windowed call whose rows
    from 44 on have no key: its forward and its gradients through
    ``FlashAttentionFn`` (one forward and one backward launch) against
    the plain versions on the same call."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    q = torch.randn((1, 100, 4, 32), generator=gen, device=cuda_device)
    k, v = (torch.randn((1, 37, 2, 32), generator=gen, device=cuda_device)
            for _ in range(2))
    do = torch.randn((1, 100, 4, 32), generator=gen, device=cuda_device)
    q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.reset_launches()
    o = fa.flash_attention(*leaves, causal=False, window=8)
    got = torch.autograd.grad(o, leaves, do)
    assert fa.LAUNCHES["flash_attention"] == 1
    assert fa.LAUNCHES["flash_attention_bwd"] == 1
    assert fa.LAUNCHES[f"flash_attention_bwd_{fa.bwd_variant(dtype, 32)}"] \
        == 1
    want_o = fa.attention_ref(q, k, v, causal=False, window=8)
    atol = 2e-5 if dtype == torch.float32 else 2e-2
    assert torch.allclose(o.detach().float(), want_o.float(), atol=atol,
                          rtol=1e-2)
    want = fa.attention_bwd_ref(q, k, v, o.detach(), do, causal=False,
                                window=8)
    floor = float(want[2].double().norm())
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel_or_floor(g, w, floor) < BWD_LIMIT[dtype], name
    assert float(got[0][:, 44:].float().abs().max()) == 0.0


# --- the sharding rules on a real mesh of four cards ---------------------------

MESH_CHILD = r"""
import json, os, sys
import torch, torch.distributed as dist
from torch.distributed.tensor import distribute_tensor
from repro_torch import configs
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lm
from repro_torch.models.types import map_specs
from repro_torch.sharding import rules as R
rank = int(os.environ["RANK"])
torch.cuda.set_device(rank)
dist.init_process_group("nccl", device_id=torch.device("cuda", rank))
cfg = configs.get("qwen3-1.7b")
mesh = make_mesh((2, 2), ("data", "model"))
rules = R.production_rules().with_overrides(**R.arch_overrides(cfg, 2))
specs = lm.param_specs(cfg)
local = []

def place(s):
    full = torch.empty(s.shape, dtype=s.storage_dtype(cfg.compute_dtype),
                       device="cuda")
    d = distribute_tensor(full, mesh, R.sharding_for_spec(s, rules,
                                                          mesh).placements)
    t = d.to_local()
    local.append(t.numel() * t.element_size())
    del full, d, t

map_specs(place, specs)
torch.cuda.synchronize()
out = {"local": sum(local), "leaves": len(local),
       "want": R.bytes_per_device(specs, rules, mesh, cfg.compute_dtype)}
with open(sys.argv[1] % rank, "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
"""


def test_cuda_four_card_mesh_holds_bytes_per_device(cuda_device, tmp_path):
    """qwen3-1.7b's parameters distributed by ``tree_shardings`` over a
    2 x 2 ``DeviceMesh`` of four cards (NCCL, four ranks): each rank's
    local bytes equal ``bytes_per_device`` at the model's dtype (bf16
    weights, float32 norm scales)."""
    import json
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices (a 2 x 2 mesh, one rank a "
                    "card)")
    root = Path(__file__).resolve().parent.parent
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(4):
        env = dict(os.environ, PYTHONPATH=str(root / "src"),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   RANK=str(rank), WORLD_SIZE="4", LOCAL_RANK=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", MESH_CHILD, str(tmp_path / "r%d.json")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
    got = [json.loads((tmp_path / f"r{r}.json").read_text())
           for r in range(4)]
    for r, g in enumerate(got):
        assert g["local"] == g["want"], (r, g)
    print(f"[mesh] qwen3-1.7b on 2 x 2 cards: {got[0]['leaves']} leaves, "
          f"{got[0]['local']} bytes a rank = bytes_per_device "
          f"{got[0]['want']}")
