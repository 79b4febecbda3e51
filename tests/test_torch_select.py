"""The port's k-head above 64 against the reference, and its dispatch.

On the CPU :func:`repro_torch.kernels.rank_delta.select_heads` and the
fused heads take the plain stable sort; here they are held against the
reference at k past the old two-stage cap of 64: the Pallas kernel's
in-kernel top-k tail (``interpret=True``, one C tile) and the reference
fleet's ``top_k`` (``jax.lax.top_k``).  Every member of these universes
has at least k profiled configs, so the reference's repeated-index tail
(ROADMAP §C 1) cannot show.  The card's kernels are held against the
plain sort in ``test_torch_cuda.py``; :func:`rd._select_plan`, which
picks the kernel, its register lists and its scratch, is pure and is
pinned here.
"""
import numpy as np
import pytest
import torch

from repro.kernels import rank_delta as ref_rd
from repro.selector import BatchedRankState
from repro_torch.kernels import rank_delta as rd
from repro_torch.selector import TorchFusedRankState, score_contract

REL, ABS = 1e-4, 1e-6
CONTRACT = score_contract("torch_fused")


def _dense_universe(seed, J, C, S):
    """A universe mid-stream where every member has every column of at
    least one of its rows profiled: each member's finite count is C."""
    rng = np.random.default_rng(seed)
    hours = rng.uniform(0.5, 4.0, (J, C)).astype(np.float32)
    mask = rng.random((J, C)) > 0.2
    mask[0] = True
    hours = np.where(mask, hours, 1.0).astype(np.float32)
    oldp = rng.uniform(0.1, 2.0, (1, C)).astype(np.float32)
    newp = oldp.copy()
    cols = rng.choice(C, size=C // 10, replace=False)
    newp[0, cols] = (newp[0, cols] * rng.uniform(0.4, 1.6, cols.size)
                     ).astype(np.float32)
    changed = np.zeros((1, C), np.float32)
    changed[0, cols] = 1.0
    cost = np.where(mask, hours * oldp, np.inf)
    rb = cost.min(axis=1, keepdims=True).astype(np.float32)
    norm = np.where(mask, cost / rb, 0.0).astype(np.float32)
    rm = (rng.random((S, J)) > 0.5).astype(np.float32)
    rm[:, 0] = 1.0
    scores = (rm @ norm).astype(np.float32)
    fin = (rm @ mask.astype(np.float32)) > 0
    return hours, mask, oldp, newp, changed, rb, rm, scores, fin


@pytest.mark.parametrize("k", [65, 130])
def test_plain_fused_heads_match_reference_kernel_above_64(k):
    """The port's fused heads against the reference kernel's in-kernel
    top-k at k past 64: row minima and moved exactly, scores within the
    envelope, every head's indices equal and values within it."""
    u = _dense_universe(k, J=8, C=144, S=3)
    assert (u[-1].sum(axis=1) >= k).all()
    ref = ref_rd.fused_reprice_heads(*u, block_j=8, block_c=144, k=k,
                                     interpret=True)
    got = rd.fused_reprice_heads(*(torch.from_numpy(a) for a in u), k=k)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               rtol=REL, atol=ABS)
    assert np.array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert int(got[2][0, 0]) == int(np.asarray(ref[2])[0, 0])
    assert np.array_equal(got[3].numpy(), np.asarray(ref[3]))
    np.testing.assert_allclose(got[4].numpy(), np.asarray(ref[4]),
                               rtol=REL, atol=ABS)
    assert got[3].dtype == torch.int32 and got[3].shape == (3, k)


def _fleets(seed, J=10, C=400, n_members=4):
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
    port = TorchFusedRankState(hours, mask, prices.copy(), ids, device="cpu")
    ref = BatchedRankState(hours, mask, prices.copy(), ids)
    for key, rows in members.items():
        port.add_state(key, rows=rows)
        ref.add_state(key, rows=rows)
    return rng, port, ref, ids, members


@pytest.mark.parametrize("k", [65, 300, 400])
def test_plain_top_k_matches_reference_fleet_top_k(k):
    """``TorchFusedRankState.top_k`` on the CPU against the reference
    fleet's ``top_k`` (``jax.lax.top_k``) after two ticks, at k past 64
    up to k = C: the same configs in the same order, every score within
    the contract, unprofiled configs last in catalog order in both."""
    rng, port, ref, ids, members = _fleets(k)
    live = port.prices.copy()
    for _ in range(2):
        cols = rng.choice(len(ids), 40, replace=False)
        new = (live[cols] * rng.uniform(0.7, 1.3, cols.size)
               ).astype(np.float32)
        deltas = {ids[c]: float(p) for c, p in zip(cols, new)}
        assert port.reprice(deltas) == ref.reprice(deltas)
        live[cols] = new
    for key in members:
        got, want = port.top_k(key, k), ref.top_k(key, k)
        assert len(got) == k
        assert [r.config_id for r in got] == [r.config_id for r in want]
        for g, w in zip(got, want):
            assert CONTRACT.scores_match(g.score, w.score), (key, g, w)
        assert got == port.ranking(key)[:k]


#: (S, C, k) -> (kernel, R, scratch): the two-stage kernel's register
#: lists at and past each power of two up to its cap, the sort from one
#: past it to k = C, and ragged chunk counts (1, 2, 3, 5, 49)
PLANS = [
    ((3, 10_000, 1), ("select", 1, (3, 5, 1))),
    ((3, 10_000, 32), ("select", 1, (3, 5, 32))),
    ((3, 10_000, 33), ("select", 2, (3, 5, 33))),
    ((3, 10_000, 64), ("select", 2, (3, 5, 64))),
    ((3, 10_000, 65), ("select", 4, (3, 5, 65))),
    ((3, 10_000, 128), ("select", 4, (3, 5, 128))),
    ((3, 10_000, 129), ("select", 8, (3, 5, 129))),
    ((3, 10_000, 256), ("select", 8, (3, 5, 256))),
    ((3, 10_000, 257), ("select_sort", 0, (2, 3, 5, 257))),
    ((3, 10_000, 10_000), ("select_sort", 0, (2, 3, 5, 2048))),
    ((1, 2_048, 2_048), ("select_sort", 0, (2, 1, 1, 2048))),
    ((2, 777, 777), ("select_sort", 0, (2, 2, 1, 777))),
    ((4, 2_049, 300), ("select_sort", 0, (2, 4, 2, 300))),
    ((3, 4_097, 1_000), ("select_sort", 0, (2, 3, 3, 1000))),
    ((16, 100_000, 1_000), ("select_sort", 0, (2, 16, 49, 1000))),
    ((16, 100_000, 10), ("select", 1, (16, 49, 10))),
]


@pytest.mark.parametrize("shape, want", PLANS, ids=[str(p[0]) for p in PLANS])
def test_select_plan(shape, want):
    """Which kernel, how many register lists and what scratch each (S, C,
    k) takes; k alone picks the kernel."""
    plan = rd._select_plan(*shape)
    assert (plan.kernel, plan.R, plan.scratch) == want
    if plan.kernel == "select":
        # the fewest lists that hold k keys
        assert 32 * plan.R >= shape[2] and (plan.R == 1
                                            or 16 * plan.R < shape[2])
    else:
        assert shape[2] > rd.SELECT_CAP


def test_select_cap_is_the_sources():
    """The wrapper's cap and chunk are the CUDA source's constants."""
    src = (rd._build.CSRC / "rank_delta.cu").read_text()
    assert f"constexpr int kSelectCap = {rd.SELECT_CAP};" in src
    assert "kSelectChunk = kChunkThreads * kLaneKeys" in src
    assert "constexpr int kChunkThreads = 256;" in src
    assert "constexpr int kLaneKeys = 8;" in src
    assert rd.SELECT_CHUNK == 256 * 8
