"""The port on the card: each CUDA kernel against its plain PyTorch version,
the fleet state and service on CUDA against the same on the CPU, and a
reduced-config serving engine whose kernel counters move.

Every test here needs a CUDA device and carries the ``cuda`` marker; without
one it skips.  The file imports no JAX, so it runs on a machine with the
card alone:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rank_delta as rd
from repro_torch.kernels import rwkv6_scan as wk
from repro_torch.models import LM
from repro_torch.serve import Engine, Request
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
        {"rowmin": 1, "fold": 1, "select": 1, "select_rounds": 0}
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
    values (bit for bit), through the kernel that ``k`` names."""
    before = dict(rd.LAUNCHES)
    ti, tv = rd.select_heads(scores, finite, k)
    torch.cuda.synchronize()
    assert {n: rd.LAUNCHES[n] - before[n] for n in ("select",
                                                   "select_rounds")} == \
        {"select": int(kernel == "select"),
         "select_rounds": int(kernel == "select_rounds")}
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


def test_cuda_select_edge_rows(cuda_device):
    """A wholly unprofiled row (catalog order), k above a row's finite
    count, ties in catalog order, -0.0 against +0.0 (one score), and k at
    the two-stage cap and one above it (the k-round kernel)."""
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
    _assert_select_exact(ties, fin, rd.SELECT_CAP + 1, "select_rounds")


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
    # every kernel of the path; the k-round select serves only k > 64
    assert all(rd.LAUNCHES[n] > 0 for n in ("rowmin", "fold", "select")) \
        and rd.LAUNCHES["select_rounds"] == 0, rd.LAUNCHES
    assert gpu.reprice_dispatches == 3


# --- the LM kernels -----------------------------------------------------------

#: (B, T, H, G, D, causal, window): GQA, MQA, bidirectional, windowed,
#: ragged T (12, 100, 130, 1000: no multiple of the 128-row tile), every
#: head size the kernels are built for, and the qwen3-1.7b prefill's
#: shape
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
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_flash_attention_matches_plain(cuda_device, case, dtype):
    """The kernel :func:`fa.variant` names against the plain version on
    the same card tensors (fp32 atol 2e-5, bf16 atol 2e-2, rtol 1e-2):
    the tensor-core kernel for bf16 at D != 80, the scalar one otherwise;
    one launch per call, counted in the total and its variant."""
    B, T, H, G, D, causal, window = case
    gen = torch.Generator(device=cuda_device).manual_seed(sum(case[:5]))
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device
                           ).to(dtype)
               for shape in ((B, T, H, D), (B, T, G, D), (B, T, G, D)))
    kind = fa.variant(dtype, D)
    assert kind == ("tc" if dtype == torch.bfloat16 and D != 80
                    else "scalar")
    before = dict(fa.LAUNCHES)
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {
        "flash_attention": 1, "flash_attention_tc": int(kind == "tc"),
        "flash_attention_scalar": int(kind == "scalar")}
    want = fa.attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == want.shape
    atol = 2e-5 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=atol,
                               rtol=1e-2)


def test_cuda_flash_attention_scalar_kernel_on_bf16(cuda_device):
    """The scalar kernel still takes bf16 at every head size (the path
    D = 80 runs on): at the qwen3-1.7b prefill shape it agrees with the
    plain version and with the tensor-core kernel."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device
                           ).to(torch.bfloat16)
               for shape in ((2, 300, 16, 128), (2, 300, 8, 128),
                             (2, 300, 8, 128)))
    scalar = fa._launch(q, k, v, True, None, "scalar")
    tc = fa._launch(q, k, v, True, None, "tc")
    want = fa.attention_ref(q, k, v, causal=True)
    for got in (scalar, tc):
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), atol=2e-2,
                                   rtol=1e-2)
    with pytest.raises(ValueError, match="tensor-core"):
        fa._launch(q.float(), k.float(), v.float(), True, None, "tc")


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


def _wkv_inputs(device, B, T, H, N, dtype, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    r, k, v = (torch.randn((B, T, H, N), generator=gen, device=device
                           ).to(dtype) for _ in range(3))
    w = torch.sigmoid(torch.randn((B, T, H, N), generator=gen,
                                  device=device)) * 0.5 + 0.45
    u = torch.randn((H, N), generator=gen, device=device) * 0.5
    s0 = torch.randn((B, H, N, N), generator=gen, device=device)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("shape", [(2, 1, 3, 64), (1, 37, 2, 64),
                                   (2, 100, 2, 16), (1, 64, 4, 32)],
                         ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_wkv6_matches_plain(cuda_device, shape, dtype):
    """The kernel against its plain version (atol 1e-4, rtol 1e-3): a
    decode step, ragged T, both model head sizes, one launch per call."""
    args = _wkv_inputs(cuda_device, *shape, dtype)
    before = wk.LAUNCHES["wkv6"]
    y, sT = wk.wkv6(*args)
    torch.cuda.synchronize()
    assert wk.LAUNCHES["wkv6"] == before + 1
    y_p, s_p = wk.wkv6_scan_ref(*args)
    np.testing.assert_allclose(y.cpu().numpy(), y_p.cpu().numpy(),
                               atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(sT.cpu().numpy(), s_p.cpu().numpy(),
                               atol=1e-4, rtol=1e-3)


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


@pytest.mark.parametrize("name", ["qwen3-1.7b", "rwkv6-3b"])
def test_cuda_reduced_engine_runs_through_the_kernels(cuda_device, name):
    """A reduced (fp32) model served on the card: each layer's kernel
    launches once per prefill (flash attention) or once per model call
    (WKV6), and the prefill logits equal the same weights' on the CPU
    within the decode-parity tolerance (2e-3)."""
    cfg = configs.reduced(configs.get(name))
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
    if name == "qwen3-1.7b":       # fp32: the scalar kernel
        assert fa.LAUNCHES["flash_attention"] == cfg.num_layers * 2
        assert fa.LAUNCHES["flash_attention_scalar"] == cfg.num_layers * 2
        assert wk.LAUNCHES["wkv6"] == 0
    else:
        assert wk.LAUNCHES["wkv6"] == cfg.num_layers * (2 + 6)
        assert fa.LAUNCHES["flash_attention"] == 0
    tokens = torch.as_tensor(prompts[:2])
    want, _ = cpu.prefill({"tokens": tokens}, cpu.init_state(2, 24))
    got, _ = gpu.prefill({"tokens": tokens.to(cuda_device)},
                         gpu.init_state(2, 24))
    assert float((got.cpu() - want).abs().max()) < 2e-3
