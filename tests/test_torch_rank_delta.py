"""The port's fused delta-rank kernels against the reference Pallas kernel.

On the CPU every wrapper in :mod:`repro_torch.kernels.rank_delta` takes
its plain PyTorch version; those are held here against the reference's
``repro.kernels.rank_delta`` (Pallas, ``interpret=True`` on the CPU, at
every tiling) on the same numpy inputs: row minima and the handoff count
exactly, scores within rel 1e-4 / abs 1e-6 (the reorder of the member
sums), an identity tick bit-for-bit.  The CUDA kernels themselves are held
against the plain versions in ``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro.kernels import rank_delta as ref_rd
from repro_torch.kernels import rank_delta as rd

REL, ABS = 1e-4, 1e-6


def _universe(seed, J=16, C=24, S=5, n_changed=3, masked_rows=()):
    """A random masked universe mid-stream: settled row minima and scores
    plus one tick's new prices (numpy float32, as both packages hold
    them)."""
    rng = np.random.default_rng(seed)
    hours = rng.uniform(0.5, 4.0, (J, C)).astype(np.float32)
    mask = rng.random((J, C)) > 0.2
    for r in masked_rows:
        mask[r] = False
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
    return hours, mask, oldp, newp, changed, rb_old, rm, scores


def _torch(*arrays, device="cpu"):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays)


def _assert_scores_close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=REL, atol=ABS)


@pytest.mark.parametrize("blocks", [(16, 24), (8, 24), (4, 12), (8, 8)])
def test_plain_reprice_matches_reference_kernel(blocks):
    """The port's tick == the reference Pallas tick at every reference
    tiling: row minima and moved exactly, scores within the envelope."""
    u = _universe(0)
    want_s, want_rb, want_mv = ref_rd.fused_reprice(
        *u, block_j=blocks[0], block_c=blocks[1], interpret=True)
    s, rb, mv = rd.fused_reprice(*_torch(*u))
    assert np.array_equal(rb.numpy(), np.asarray(want_rb))
    assert int(mv[0, 0]) == int(np.asarray(want_mv)[0, 0])
    _assert_scores_close(s.numpy(), want_s)


@pytest.mark.parametrize("seed", range(3))
def test_plain_reprice_matches_reference_many_changes(seed):
    """Many changed columns move many row minima: still exact minima and
    handoff counts, scores within the envelope."""
    u = _universe(10 + seed, n_changed=12)
    want_s, want_rb, want_mv = ref_rd.fused_reprice(
        *u, block_j=8, block_c=24, interpret=True)
    s, rb, mv = rd.fused_reprice(*_torch(*u))
    assert int(np.asarray(want_mv)[0, 0]) > 0
    assert np.array_equal(rb.numpy(), np.asarray(want_rb))
    assert int(mv[0, 0]) == int(np.asarray(want_mv)[0, 0])
    _assert_scores_close(s.numpy(), want_s)


def test_identity_tick_is_bitwise_noop_in_both_packages():
    """Unchanged prices: norm_new - norm_old is an exact zero, so both
    the reference and the port leave scores and row minima bit-for-bit
    unchanged (DESIGN.md §14)."""
    hours, mask, oldp, _, _, rb_old, rm, scores = _universe(1)
    zeros = np.zeros_like(oldp)
    args = (hours, mask, oldp, oldp, zeros, rb_old, rm, scores)
    ref_s, ref_rb, ref_mv = ref_rd.fused_reprice(*args, block_j=8,
                                                 block_c=24, interpret=True)
    s, rb, mv = rd.fused_reprice(*_torch(*args))
    for got in (np.asarray(ref_s), s.numpy()):
        assert np.array_equal(got, scores)
    for got in (np.asarray(ref_rb), rb.numpy()):
        assert np.array_equal(got, rb_old)
    assert int(mv[0, 0]) == int(np.asarray(ref_mv)[0, 0]) == 0


@pytest.mark.parametrize("seed", range(3))
def test_plain_parts_match_numpy_oracle_ragged(seed):
    """J not a multiple of 8, C not a multiple of any block, and fully
    masked rows (the reference needs its tiles to divide, so the port is
    held to the unfused numpy oracle here): a fully masked row keeps an
    ``inf`` minimum, never counts as a handoff and never yields NaN."""
    u = _universe(20 + seed, J=13, C=29, S=4, n_changed=5,
                  masked_rows=(2, 11))
    hours, mask, oldp, newp, changed, rb_old, rm, scores = u
    with np.errstate(invalid="ignore"):
        cost_old = np.where(mask, hours * oldp, np.inf)
        cost_new = np.where(mask, hours * newp, np.inf)
        rb_new = cost_new.min(axis=1, keepdims=True).astype(np.float32)
        norm_old = np.where(mask, cost_old / rb_old, 0.0).astype(np.float32)
        norm_new = np.where(mask, cost_new / rb_new, 0.0).astype(np.float32)
    want = np.where(changed > 0, rm @ norm_new,
                    scores + rm @ (norm_new - norm_old))
    t = _torch(*u)
    rb, mv = rd.rowmin_plain(t[0], t[1], t[3], t[5])
    assert np.array_equal(rb.numpy(), rb_new)
    assert np.isinf(rb.numpy()[[2, 11]]).all()
    assert int(mv[0, 0]) == int((rb_new != rb_old).sum())
    s = rd.fold_plain(*t[:6], rb, t[6], t[7])
    assert np.isfinite(s.numpy()).all()
    _assert_scores_close(s.numpy(), want)
    whole = rd.fused_reprice(*t)
    assert torch.equal(whole[0], s) and torch.equal(whole[1], rb)


def test_heads_match_reference_on_finite_prefix():
    """The port's fused heads and the reference's in-kernel top-k agree
    on every member's first ``min(k, n_finite)`` entries (indices and
    values), where the reference's tail is well defined."""
    u = _universe(2, S=6)
    hours, mask, oldp, newp, changed, rb_old, rm, scores = u
    fin = (rm @ mask.astype(np.float32)) > 0
    fin[0, 5:] = False                   # member 0: only 5 finite configs
    k = 8
    ref = ref_rd.fused_reprice_heads(*u, fin, block_j=8, block_c=24, k=k,
                                     interpret=True)
    got = rd.fused_reprice_heads(*_torch(*u, fin), k=k)
    _assert_scores_close(got[0].numpy(), ref[0])
    assert np.array_equal(got[1].numpy(), np.asarray(ref[1]))
    ref_ti, ref_tv = np.asarray(ref[3]), np.asarray(ref[4])
    ti, tv = got[3].numpy(), got[4].numpy()
    for s in range(rm.shape[0]):
        n = min(k, int(fin[s].sum()))
        assert np.array_equal(ti[s, :n], ref_ti[s, :n]), s
        np.testing.assert_allclose(tv[s, :n], ref_tv[s, :n], rtol=REL,
                                   atol=ABS)
        assert len(set(ti[s])) == k          # the port's head is distinct


def test_heads_distinct_when_k_exceeds_finite():
    """A member with 2 profiled configs out of 6 and k=4: the reference's
    argmin tail re-masks a column that is already ``inf`` and serves
    index 0 again; the port serves 4 distinct configs — the 2 profiled
    ones by score, then the unprofiled ones in catalog order, exactly
    ``ranking()[:4]``."""
    J, C = 8, 6
    rng = np.random.default_rng(3)
    hours = rng.uniform(0.5, 4.0, (J, C)).astype(np.float32)
    mask = np.zeros((J, C), bool)
    mask[:, [2, 4]] = True
    hours = np.where(mask, hours, 1.0).astype(np.float32)
    oldp = rng.uniform(0.1, 2.0, (1, C)).astype(np.float32)
    newp = oldp.copy()
    newp[0, 4] *= np.float32(0.5)
    changed = np.zeros((1, C), np.float32)
    changed[0, 4] = 1.0
    cost = np.where(mask, hours * oldp, np.inf)
    rb = cost.min(axis=1, keepdims=True).astype(np.float32)
    norm = np.where(mask, cost / rb, 0.0).astype(np.float32)
    rm = np.ones((1, J), np.float32)
    scores = (rm @ norm).astype(np.float32)
    fin = (rm @ mask.astype(np.float32)) > 0
    args = (hours, mask, oldp, newp, changed, rb, rm, scores, fin)
    ref = ref_rd.fused_reprice_heads(*args, block_j=8, block_c=C, k=4,
                                     interpret=True)
    ref_ti = np.asarray(ref[3])[0]
    assert len(set(ref_ti.tolist())) < 4, ref_ti      # the reference fault
    got = rd.fused_reprice_heads(*_torch(*args), k=4)
    ti = got[3].numpy()[0]
    s = got[0].numpy()[0]
    order = [2, 4] if s[2] <= s[4] else [4, 2]
    assert ti.tolist() == order + [0, 1]
    assert np.isinf(got[4].numpy()[0, 2:]).all()


def test_select_heads_plain_ties_and_unprofiled_order():
    """Equal scores resolve in catalog order; unprofiled configs come
    last, in catalog order."""
    scores = torch.tensor([[3.0, 1.0, 1.0, 7.0, 1.0, 2.0]])
    finite = torch.tensor([[True, True, True, False, True, False]])
    ti, tv = rd.select_heads(scores, finite, 6)
    assert ti.tolist() == [[1, 2, 4, 0, 3, 5]]
    assert tv[0, :4].tolist() == [1.0, 1.0, 1.0, 3.0]
    assert torch.isinf(tv[0, 4:]).all()


def test_select_heads_plain_ties_signed_zeros_in_catalog_order():
    """-0.0 and +0.0 are one score (the kernel's packed keys canonicalise
    -0.0 for that): they tie and resolve in catalog order, whichever sign
    comes first, and each head keeps its own column's value."""
    scores = torch.tensor([[0.0, -0.0, 2.0, -0.0, 0.0, -1.0],
                           [-0.0, 0.0, -0.0, 0.0, 5.0, 1.0]])
    finite = torch.tensor([[True, True, True, True, True, True],
                           [True, True, False, True, True, True]])
    ti, tv = rd.select_heads(scores, finite, 5)
    assert ti.tolist() == [[5, 0, 1, 3, 4], [0, 1, 3, 5, 4]]
    assert torch.signbit(tv[0, 2]) and not torch.signbit(tv[0, 1])
    assert torch.equal(tv, scores.gather(1, ti.long()).where(
        finite.gather(1, ti.long()), torch.tensor(float("inf"))))


def test_wrappers_validate_inputs():
    t = list(_torch(*_universe(4)))
    fin = torch.ones_like(t[7], dtype=torch.bool)
    bad_dtype = list(t)
    bad_dtype[0] = t[0].double()
    with pytest.raises(TypeError, match="hours"):
        rd.fused_reprice(*bad_dtype)
    bad_shape = list(t)
    bad_shape[3] = t[3][:, :-1].contiguous()
    with pytest.raises(ValueError, match="new_prices"):
        rd.fused_reprice(*bad_shape)
    strided = list(t)
    strided[7] = t[7].t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        rd.fused_reprice(*strided)
    with pytest.raises(TypeError, match="mask"):
        rd.fused_reprice(t[0], t[0], *t[2:])
    for k in (0, 25, True, 1.5):
        with pytest.raises(ValueError, match="k must be"):
            rd.fused_reprice_heads(*t, fin, k=k)
    with pytest.raises(TypeError, match="finite"):
        rd.select_heads(t[7], t[7], 2)
    meta = [x.to("meta") for x in t]
    with pytest.raises(ValueError, match="unsupported device"):
        rd.fused_reprice(*meta)


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    """A CPU tensor runs the plain version: no library is built and no
    launch is counted (the counters move only where a kernel launches)."""
    rd.reset_launches()
    u = _torch(*_universe(5))
    fin = torch.ones_like(u[7], dtype=torch.bool)
    rd.fused_reprice(*u)
    rd.fused_reprice_heads(*u, fin, k=3)
    C = u[7].shape[1]
    rd.fused_reprice_heads(*u, fin, k=C)
    rd.select_heads(u[7], fin, 3)
    rd.select_heads(u[7], fin, C)
    rd.scatter_prices([3, 0], [1.5, 2.5], u[2])
    assert rd.LAUNCHES == {"scatter": 0, "scatter_pageable": 0,
                           "rowmin": 0, "rowmin_row": 0, "fold": 0,
                           "fold_col": 0, "select": 0, "select_sort": 0,
                           "select_rounds": 0}


def test_launch_fold_names_only_its_two_kernels():
    """The card's fold is reached as ``fold`` or, by name, ``fold_col``;
    any other name raises before a library is built or a launch counted."""
    rd.reset_launches()
    t = _torch(*_universe(6))
    with pytest.raises(ValueError, match="unknown fold kernel"):
        rd._launch_fold(*t[:6], t[5], t[6], t[7], variant="fold_rows")
    assert sum(rd.LAUNCHES.values()) == 0


def test_launch_rowmin_names_only_its_two_kernels():
    """The card's row minima are reached as ``rowmin`` or, by name,
    ``rowmin_row``; anything else raises before a library is built or a
    launch counted."""
    rd.reset_launches()
    t = _torch(*_universe(6))
    with pytest.raises(ValueError, match="unknown rowmin kernel"):
        rd._launch_rowmin(t[0], t[1], t[3], t[5], variant="rowmin_split")
    assert sum(rd.LAUNCHES.values()) == 0


def test_rowmin_chunk_is_the_sources():
    """The chunk the wrapper sizes ``rowmin``'s scratch by is the CUDA
    source's: 256 threads x 4 float4 groups."""
    src = (rd._build.CSRC / "rank_delta.cu").read_text()
    assert "constexpr int kRowminThreads = 256;" in src
    assert "constexpr int kRowminGroups = 4;" in src
    assert "kRowminCols = kRowminThreads * 4 * kRowminGroups;" in src
    assert rd.ROWMIN_CHUNK == 256 * 4 * 4


def test_scatter_prices_plain_writes_the_pairs():
    """The plain scatter: the old prices with the pairs' written in (as
    float32), 1.0 at the pairs' columns and 0 elsewhere; no pairs copy
    the prices and flag nothing; the old vector is not touched."""
    old = torch.tensor([[1.0, 2.0, 3.0, 4.0, 5.0]])
    keep = old.clone()
    new, changed = rd.scatter_prices(np.array([4, 1, 2], np.int32),
                                     np.array([0.5, 9.0, 3.0]), old)
    assert new.tolist() == [[1.0, 9.0, 3.0, 4.0, 0.5]]
    assert changed.tolist() == [[0.0, 1.0, 1.0, 0.0, 1.0]]
    assert torch.equal(old, keep)
    new, changed = rd.scatter_prices(np.array([], np.int64),
                                     np.array([], np.float32), old)
    assert torch.equal(new, old) and not changed.any()
    new, _ = rd.scatter_prices(np.array([0], np.uint8),
                               np.array([1 / 3]), old)
    assert new[0, 0].item() == float(np.float32(1 / 3))


@pytest.mark.parametrize("cols, prices, err, match", [
    ([5], [2.0], ValueError, r"columns must lie in \[0, 5\)"),
    ([-1], [2.0], ValueError, r"columns must lie in \[0, 5\)"),
    ([2, 1 << 40], [2.0, 3.0], ValueError, "columns must lie in"),
    ([1, 3, 1], [2.0, 3.0, 4.0], ValueError, "columns must be distinct"),
    ([1.0], [2.0], TypeError, "cols must be a 1-D integer array"),
    ([[1, 2]], [[2.0, 3.0]], TypeError, "cols must be a 1-D integer array"),
    ([1, 2], [2.0], TypeError, "prices must be a 1-D float array"),
    ([1], [2], TypeError, "prices must be a 1-D float array"),
])
def test_scatter_prices_refuses_what_it_does_not_take(cols, prices, err,
                                                      match):
    """A column out of range, a repeated column or arrays of the wrong kind
    raise before a library is built or a launch counted, and the old
    prices stay as they were; so do prices that are not a (1, C) float32
    row."""
    rd.reset_launches()
    old = torch.ones((1, 5))
    with pytest.raises(err, match=match):
        rd.scatter_prices(np.array(cols), np.array(prices), old)
    assert torch.equal(old, torch.ones((1, 5)))
    with pytest.raises(ValueError):
        rd.scatter_prices([1], [2.0], torch.ones((2, 5)))
    with pytest.raises(TypeError):
        rd.scatter_prices([1], [2.0], torch.ones((1, 5), dtype=torch.float64))
    assert sum(rd.LAUNCHES.values()) == 0
