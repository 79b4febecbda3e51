"""The port on the card: each CUDA kernel against its plain PyTorch version,
and the fleet state and service on CUDA against the same on the CPU.

Every test here needs a CUDA device and carries the ``cuda`` marker; without
one it skips.  The file imports no JAX, so it runs on a machine with the
card alone:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import rank_delta as rd
from repro_torch.selector import (IdentityCatalog, PriceTable,
                                  ProfilingStore, SelectionService,
                                  TorchFusedRankState, rank_dense,
                                  score_contract)

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
        {"rowmin": 1, "fold": 1, "select": 1}
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
    a tick launch every kernel and agree with a numpy service under the
    contract."""
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
    assert all(n > 0 for n in rd.LAUNCHES.values()), rd.LAUNCHES
    assert gpu.reprice_dispatches == 3
