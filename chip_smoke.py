#!/usr/bin/env python3
"""Run the port's live-market selection path and its LM serving path on
one CUDA card and check them.

    python3 chip_smoke.py [--seed N]

Phases:

1. build the CUDA kernels from ``src/repro_torch/csrc`` with ``nvcc``, one
   process per source, all started together (``-Xptxas -v`` registers,
   shared memory and spills printed, and each source's build time);
2. hold every ``rank_delta`` kernel against its plain PyTorch version on
   the card: ragged shapes, fully masked rows, a member with fewer
   profiled configs than k, an identity tick (bitwise), 1% and 30%
   changed columns, k past the two-stage ``select``'s cap (the k-round
   kernel), and the fleet's own shapes — then time each kernel, its
   plain version, the kernel it replaced (the k-round ``select``) and,
   where one exists, the one PyTorch call that computes the same thing;
3. run :class:`TorchFusedRankState` at 64 jobs x 10,000 configs x 16
   members for 100 ticks (1% of prices per tick) and at 64 x 100,000 for
   10 (cut from 20 to leave room for the LM phases), holding every member
   against the float64 ``rank_dense`` under the score contract, the fused
   heads against ``ranking()[:10]``, and timing the tick;
4. serve a ``SelectionService(backend="torch_fused")`` over a 64 x 10,000
   store through a ``SelectionDaemon`` for 1,000 events and audit its
   journal with ``JournalReplayer`` — the selection path, read through
   the kernels' launch counters — then hold each kernel against its
   plain version at the shapes that path gave it and time it there;
5. hold both flash-attention kernels and the WKV6 kernel against their
   plain versions: the tensor-core kernel (bf16) and the scalar one
   (fp32, and bf16 at D = 80); causal, windowed and bidirectional; GQA
   and MQA; ragged T; head sizes 16 to 128; a decode step, ragged T and a
   two-call state carry for WKV6;
6. plan the decode fleet's mesh through the port's selection service from
   a hand-made dry-run report;
7. serve ``qwen3-1.7b`` and then ``rwkv6-3b`` at full width (random bf16
   weights from the seed): 8 requests of 1,024-token prompts over 4
   slots, 32 new tokens each — the LM path, read through the kernels'
   launch counters (28 flash-attention launches per prefill, every one
   the tensor-core kernel; 32 WKV6 launches per prefill and per decode
   step) — after a warm-up at the traffic's shapes, and once more for
   the spread.  Then: all logits finite; the first wave's prefill logits
   against a pass whose kernel is swapped for its plain version; prefill
   + decode against ``forward`` at full width, 4 layers, fp32 (the
   scalar attention kernel); and the kernels at the shapes the path gave
   them, against their plain versions and timed beside their bounds, the
   kernel they replaced (the scalar attention kernel, bf16) and, for
   attention, ``scaled_dot_product_attention``;
8. last, the profiled phases: a second 1,000-event daemon on phase 4's
   service under ``torch.profiler`` (the card's busy share), then each
   model's first-wave prefill and 8 decode steps (device time by kernel,
   busy share).

Every phase runs on every call.  Every check that fails exits non-zero.
The last three lines are the ``{"kernels": [...]}`` record, the card's
name and power limit, and ``{"ok": true, "device": {...}}``.  In the
record, ``earlier_ms`` is the time, on the same inputs in the same run,
of the kernel the entry's function ran on before this kernel (the k-round
``select``, the scalar attention kernel in bf16); null where the kernel
is the one that was there.  ``select``'s entries add ``device_ms`` and
``library_device_ms``: the same calls replayed from a CUDA graph, the
card's time without the host's.  Without a
CUDA device the script exits non-zero before printing any result.  It
imports ``torch``, ``numpy``, the standard library and the port
(``src/repro_torch``), nothing else.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: published H100 SXM peaks (NVIDIA data sheet) for the bounds
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
REL_TOL, ABS_TOL = 1e-4, 1e-6
SOURCE = "src/repro_torch/csrc/rank_delta.cu"
#: what each CUDA kernel replaces on the main path: the fused Pallas body
#: (``_make_kernel``) for ``rowmin`` and ``fold``; for ``select``, the
#: ``jax.lax.top_k`` that the reference fleet's ``top_k`` serves from
#: (the service calls ``top_k``, never ``reprice_with_heads``)
REPLACES = {"rowmin": "src/repro/kernels/rank_delta.py:69",
            "fold": "src/repro/kernels/rank_delta.py:69",
            "select": "src/repro/selector/rank.py:1218",
            "select_rounds": "src/repro/selector/rank.py:1218"}
#: ``select`` also ports the Pallas kernel's in-kernel top-k tail, which
#: only ``fused_reprice_heads`` runs (phases 2 and 3, not the service)
ALSO_REPLACES = {"select": "src/repro/kernels/rank_delta.py:157",
                 "select_rounds": "src/repro/kernels/rank_delta.py:157"}
KERNELS = ("rowmin", "fold", "select", "select_rounds")
#: the kernels the selection path launches (``select_rounds`` serves only
#: k above ``rank_delta.SELECT_CAP``; the path's k is 10)
PATH_KERNELS = ("rowmin", "fold", "select")
SOURCES = ("rank_delta", "flash_attention", "wkv6_scan")


class CheckFailed(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def log(*parts) -> None:
    print(*parts, flush=True)


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = FP32_FLOPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events, after warm-up; inputs stay resident in L2 as on the tick
    path)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(torch, fn, calls: int = 50, replays: int = 20) -> float:
    """Device time of ``fn`` per call with the host out of the way:
    ``calls`` calls captured in one CUDA graph, replayed.  Where a call's
    host work outlasts its kernels, ``time_ms`` reads the host and this
    reads the card."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (replays * calls)


# --- phase 1 --------------------------------------------------------------------

def phase_build(torch) -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()

    def timed(name):
        t = time.perf_counter()
        lib, out = _build.build(name)
        return lib, out, time.perf_counter() - t

    with ThreadPoolExecutor(len(SOURCES)) as pool:   # one nvcc per source
        built = dict(zip(SOURCES, pool.map(timed, SOURCES)))
    log(f"[build] nvcc {', '.join(s + '.cu' for s in SOURCES)} in "
        f"parallel: {time.perf_counter() - t0:.2f} s -> {_build.BUILD_DIR} ("
        + ", ".join(f"{s}.cu {built[s][2]:.2f} s" for s in SOURCES) + ")")
    for name in SOURCES:
        for line in built[name][1].splitlines():
            if "ptxas info" in line and ("registers" in line
                                         or "Compiling entry" in line
                                         or "smem" in line) \
                    or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    log(f"[build] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "float32 matmuls must not run in TF32")


# --- phase 2 --------------------------------------------------------------------

def make_universe(torch, np, rng, J, C, S, frac, *, dev, masked_rows=(),
                  sparse_member=False, identity=False):
    """A masked universe mid-stream: settled row minima and accumulators
    plus one tick's new prices (as the fleet holds them)."""
    hours = rng.uniform(0.5, 4.0, (J, C)).astype(np.float32)
    mask = rng.random((J, C)) > 0.2
    for r in masked_rows:
        mask[r] = False
    if sparse_member:
        mask[J - 1] = False
        mask[J - 1, rng.choice(C, 3, replace=False)] = True
    hours = np.where(mask, hours, 1.0).astype(np.float32)
    oldp = rng.uniform(0.1, 2.0, (1, C)).astype(np.float32)
    newp = oldp.copy()
    changed = np.zeros((1, C), np.float32)
    if not identity:
        n = max(1, int(round(frac * C)))
        cols = rng.choice(C, n, replace=False)
        newp[0, cols] = (newp[0, cols] * rng.uniform(0.4, 1.6, n)
                         ).astype(np.float32)
        changed[0, cols] = 1.0
    rm = (rng.random((S, J)) > 0.5).astype(np.float32)
    if sparse_member:
        rm[S - 1] = 0.0
        rm[S - 1, J - 1] = 1.0
    t = {k: torch.from_numpy(v).to(dev) for k, v in dict(
        hours=hours, mask=mask, oldp=oldp, newp=newp, changed=changed,
        rm=rm).items()}
    inf = torch.tensor(float("inf"), device=dev)
    t["rb"] = torch.where(t["mask"], t["hours"] * t["oldp"], inf).amin(
        dim=1, keepdim=True)
    zero = torch.zeros((), device=dev)
    norm = torch.where(t["mask"], (t["hours"] * t["oldp"]) / t["rb"], zero)
    t["scores"] = t["rm"] @ norm
    t["finite"] = (t["rm"] @ t["mask"].float()) > 0
    return t


def within(torch, a, b) -> bool:
    both_inf = torch.isinf(a) & torch.isinf(b) & (a == b)
    err = (a - b).abs()
    tol = ABS_TOL + REL_TOL * torch.maximum(a.abs(), b.abs())
    return bool(((err <= tol) | both_inf).all())


def max_err(torch, a, b) -> float:
    same = (a == b)
    diff = torch.where(same, torch.zeros_like(a), (a - b).abs())
    return float(diff.max()) if diff.numel() else 0.0


def check_select(torch, scores, finite, k, label, errs,
                 kernel="select") -> None:
    """The ``select`` kernel (``select_rounds`` past the cap) against the
    plain stable sort: the same indices and values, and every head k
    distinct configs."""
    from repro_torch.kernels import rank_delta as rd
    check((kernel == "select_rounds") == (k > rd.SELECT_CAP),
          f"{label}: k={k} is not {kernel}'s")
    before = rd.LAUNCHES[kernel]
    ti_k, tv_k = rd._launch_select(scores, finite, k)
    check(rd.LAUNCHES[kernel] == before + 1, f"{label}: {kernel} did not "
          f"launch")
    ti_p, tv_p = rd.select_heads_plain(scores, finite, k)
    check(torch.equal(ti_k, ti_p), f"{label}: select indices differ from "
          f"the stable sort")
    check(torch.equal(tv_k, tv_p), f"{label}: select values differ")
    rows = ti_k.cpu().numpy()
    check(all(len(set(r)) == len(r) for r in rows),
          f"{label}: a head repeats a config")
    errs[kernel] = max(errs[kernel], max_err(torch, tv_k, tv_p))


def check_kernels(torch, t, label, k, errs, identity=False) -> None:
    """Every kernel against its plain version on the tick ``t``: row
    minima and moved bitwise, scores within the contract, heads equal to
    the stable sort, an identity tick bitwise unchanged, and the whole-tick
    wrappers equal to their parts."""
    from repro_torch.kernels import rank_delta as rd
    J, C = t["hours"].shape
    S = t["rm"].shape[0]
    args = (t["hours"], t["mask"], t["oldp"], t["newp"], t["changed"],
            t["rb"], t["rm"], t["scores"])
    rb_k, moved_k = rd._launch_rowmin(t["hours"], t["mask"], t["newp"],
                                      t["rb"])
    rb_p, moved_p = rd.rowmin_plain(t["hours"], t["mask"], t["newp"],
                                    t["rb"])
    check(torch.equal(rb_k, rb_p), f"{label}: row minima not bitwise equal")
    check(int(moved_k) == int(moved_p), f"{label}: moved {int(moved_k)} != "
          f"{int(moved_p)}")
    fold_args = args[:6] + (rb_k, t["rm"], t["scores"])
    s_k = rd._launch_fold(*fold_args)
    s_p = rd.fold_plain(*fold_args)
    check(within(torch, s_k, s_p), f"{label}: fold outside rel "
          f"{REL_TOL}/abs {ABS_TOL}")
    if identity:
        check(torch.equal(s_k, t["scores"]) and torch.equal(rb_k, t["rb"])
              and int(moved_k) == 0,
              f"{label}: identity tick not bitwise unchanged")
    kk = min(k, C)
    check_select(torch, s_k, t["finite"], kk, label, errs)
    if C > rd.SELECT_CAP:       # the k-round kernel, past the cap
        check_select(torch, s_k, t["finite"], rd.SELECT_CAP + 1,
                     label + " k > cap", errs, "select_rounds")
    out, rb, moved, ti, _ = rd.fused_reprice_heads(*args, t["finite"], k=kk)
    ti_k, _ = rd.select_heads_plain(s_k, t["finite"], kk)
    check(torch.equal(out, s_k) and torch.equal(rb, rb_k)
          and torch.equal(ti, ti_k), f"{label}: fused wrapper differs")
    torch.cuda.synchronize()
    errs["rowmin"] = max(errs["rowmin"], max_err(torch, rb_k, rb_p))
    errs["fold"] = max(errs["fold"], max_err(torch, s_k, s_p))
    log(f"[parity] {label}: J={J} C={C} S={S} moved={int(moved_k)} "
        f"fold max|err|={max_err(torch, s_k, s_p):.3g} ok")


def parity_case(torch, np, rng, label, J, C, S, frac, k, errs, **kw):
    t = make_universe(torch, np, rng, J, C, S, frac,
                      dev=torch.device("cuda"), **kw)
    check_kernels(torch, t, label, k, errs, identity=kw.get("identity",
                                                             False))
    return t


def phase_parity(torch, np, seed):
    rng = np.random.default_rng(seed)
    errs = {name: 0.0 for name in KERNELS}
    parity_case(torch, np, rng, "ragged 1%", 61, 1000, 5, 0.01, 10, errs,
                masked_rows=(3, 40), sparse_member=True)
    parity_case(torch, np, rng, "ragged 30%", 37, 777, 19, 0.30, 25, errs,
                masked_rows=(0,), sparse_member=True)
    parity_case(torch, np, rng, "identity", 61, 1000, 5, 0.0, 10, errs,
                masked_rows=(7,), identity=True)
    parity_case(torch, np, rng, "small, k = C", 9, 20, 3, 0.3, 20, errs,
                sparse_member=True)
    parity_case(torch, np, rng, "fleet 64x10k identity", 64, 10_000, 16,
                0.0, 10, errs, identity=True)
    parity_case(torch, np, rng, "fleet 64x100k identity", 64, 100_000, 16,
                0.0, 10, errs, identity=True)
    big = parity_case(torch, np, rng, "fleet 64x100k 1%", 64, 100_000, 16,
                      0.01, 10, errs, sparse_member=True)
    main = parity_case(torch, np, rng, "fleet 64x10k 1%", 64, 10_000, 16,
                       0.01, 10, errs, sparse_member=True)
    return errs, main, big


def time_kernels(torch, t, k=10, heads=None):
    """Each kernel, its plain version and the library call on the tick
    ``t``.  ``select`` runs on ``heads`` (``(scores, finite)``) when
    given — the one member row the service's ``top_k`` serves — else on
    every member row of ``t`` (the fused heads tick)."""
    from repro_torch.kernels import rank_delta as rd
    J, C = t["hours"].shape
    S = t["rm"].shape[0]
    sel_scores, sel_finite = heads if heads else (t["scores"], t["finite"])
    R = sel_scores.shape[0]
    rb_new, _ = rd.rowmin_plain(t["hours"], t["mask"], t["newp"], t["rb"])
    fold_args = (t["hours"], t["mask"], t["oldp"], t["newp"], t["changed"],
                 t["rb"], rb_new, t["rm"], t["scores"])
    inf = torch.tensor(float("inf"), device=t["scores"].device)
    masked = torch.where(sel_finite, sel_scores, inf)
    kr = min(rd.SELECT_CAP + 1, C)
    out_i = torch.empty((R, kr), dtype=torch.int32, device=masked.device)
    out_v = torch.empty((R, kr), dtype=torch.float32, device=masked.device)

    def rounds(kk):
        """The k-round ``select`` kernel, the one the two-stage kernel
        replaced, at any k."""
        rd._build.check(rd._lib().rank_delta_select_rounds(
            sel_scores.data_ptr(), sel_finite.data_ptr(), out_v.data_ptr(),
            out_i.data_ptr(), R, C, kk, rd._stream(sel_scores)),
            "rank_delta_select_rounds")

    res = {
        "rowmin": dict(
            ms=time_ms(torch, lambda: rd._launch_rowmin(
                t["hours"], t["mask"], t["newp"], t["rb"])),
            plain_ms=time_ms(torch, lambda: rd.rowmin_plain(
                t["hours"], t["mask"], t["newp"], t["rb"])),
            library_ms=None),
        "fold": dict(
            ms=time_ms(torch, lambda: rd._launch_fold(*fold_args)),
            plain_ms=time_ms(torch, lambda: rd.fold_plain(*fold_args)),
            library_ms=None),
        "select": dict(
            ms=time_ms(torch, lambda: rd._launch_select(
                sel_scores, sel_finite, k)),
            earlier_ms=time_ms(torch, lambda: rounds(k)),
            plain_ms=time_ms(torch, lambda: rd.select_heads_plain(
                sel_scores, sel_finite, k)),
            library_ms=time_ms(torch, lambda: torch.topk(
                masked, k, dim=1, largest=False)),
            device_ms=graph_ms(torch, lambda: rd._launch_select(
                sel_scores, sel_finite, k)),
            library_device_ms=graph_ms(torch, lambda: torch.topk(
                masked, k, dim=1, largest=False))),
        # the k-round kernel where it serves now: k past the cap
        "select_rounds": dict(
            ms=time_ms(torch, lambda: rounds(kr)),
            plain_ms=time_ms(torch, lambda: rd.select_heads_plain(
                sel_scores, sel_finite, kr)),
            library_ms=time_ms(torch, lambda: torch.topk(
                masked, kr, dim=1, largest=False))),
    }
    mask = t["mask"]
    nnz = float(mask.sum())
    member_cells = float((t["rm"] @ mask.float().sum(dim=1,
                                                     keepdim=True)).sum())
    res["rowmin"]["bound"] = bound_ms(J * C * 5 + C * 4 + J * 8 + 4,
                                      2 * nnz)
    res["fold"]["bound"] = bound_ms(
        J * C * 5 + 3 * C * 4 + 2 * J * 4 + S * J * 4 + 2 * S * C * 4,
        5 * nnz + 4 * member_cells)
    res["select"]["bound"] = bound_ms(R * C * 5 + R * k * 8, R * C)
    res["select_rounds"]["bound"] = bound_ms(R * C * 5 + R * kr * 8, R * C)
    for name, r in res.items():
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        earlier = f", k-round kernel {r['earlier_ms']:.4f} ms" \
            if "earlier_ms" in r else ""
        if "device_ms" in r:
            earlier += (f"; replayed from a CUDA graph, kernel "
                        f"{r['device_ms']:.4f} ms, library "
                        f"{r['library_device_ms']:.4f} ms")
        log(f"[time] {name}: kernel {r['ms']:.4f} ms{earlier}, plain "
            f"{r['plain_ms']:.4f} ms, library {lib} ms, bound "
            f"{r['bound'][0]:.5f} ms ({r['bound'][1]}) at J={J} C={C} "
            f"S={R if name.startswith('select') else S} "
            f"k={kr if name == 'select_rounds' else k}")
    return res


# --- phase 3 --------------------------------------------------------------------

def assert_member(state, key, hours, mask, rows, live, ids, contract,
                  rank_dense) -> None:
    cold = rank_dense(hours[rows], mask[rows], live, ids)
    got = state.ranking(key)
    check(contract.winner_matches(got[0].config_id, cold),
          f"member {key}: winner {got[0]} vs cold {cold[0]}")
    ref = {r.config_id: r.score for r in cold}
    bad = [r for r in got if not contract.scores_match(r.score,
                                                       ref[r.config_id])]
    check(not bad, f"member {key}: {len(bad)} scores outside the contract, "
          f"first {bad[:1]} vs {ref[bad[0].config_id] if bad else None}")


def phase_fleet(torch, np, seed, J, C, S, ticks, check_every, label,
                card="", device="cuda"):
    from repro_torch.kernels import rank_delta as rd
    from repro_torch.selector import (TorchFusedRankState, rank_dense,
                                      score_contract)
    rng = np.random.default_rng(seed)
    hours = rng.uniform(0.05, 10.0, (J, C))
    mask = rng.random((J, C)) > 0.15
    mask[np.arange(J), rng.integers(0, C, J)] = True
    prices = rng.uniform(0.5, 20.0, C)
    ids = [f"c{i}" for i in range(C)]
    members = {"all": list(range(J))}
    for m in range(S - 1):
        size = int(rng.integers(1, J))
        members[f"m{m}"] = sorted(int(i) for i in
                                  rng.choice(J, size, replace=False))
    contract = score_contract("torch_fused")
    state = TorchFusedRankState(hours, mask, prices, ids, capacity=S,
                                device=device)
    for key, rows in members.items():
        state.add_state(key, rows=rows)
    live = state.prices.copy()          # the float32 quotes, lifted
    n_chg = max(1, C // 100)

    def next_deltas():
        cols = rng.choice(C, n_chg, replace=False)
        new = (live[cols] * rng.uniform(0.7, 1.3, n_chg)).astype(np.float32)
        return {ids[c]: float(p) for c, p in zip(cols, new)}, cols, new

    k = 10
    for tick in range(1, ticks + 1):
        deltas, cols, new = next_deltas()
        if tick % 2:
            state.reprice(deltas)
            heads = None
        else:
            _, heads = state.reprice_with_heads(deltas, k)
        live[cols] = new
        verify = tick % check_every == 0
        if heads is not None:
            for key in members:
                check(heads[key] == state.ranking(key)[:k],
                      f"{label} tick {tick}: head of {key} differs from "
                      f"ranking()[:{k}]")
        if verify:
            for key, rows in members.items():
                assert_member(state, key, hours, mask, rows, live, ids,
                              contract, rank_dense)
            log(f"[fleet] {label} tick {tick}: {len(members)} members "
                f"within contract")
    check(state.dispatches == state.reprices == ticks,
          f"{label}: dispatches {state.dispatches} != ticks {ticks}")
    # an identity tick on the live, mid-stream fleet: bitwise unchanged
    zeros = torch.zeros_like(state.d_prices)
    out, rb, moved = rd.fused_reprice(
        state.d_hours, state.d_mask, state.d_prices, state.d_prices, zeros,
        state.d_row_best, state.d_row_masks, state.d_scores)
    check(torch.equal(out, state.d_scores)
          and torch.equal(rb, state.d_row_best) and int(moved) == 0,
          f"{label}: identity tick changed the fleet")
    # the tick's time, after warm-up: host delta densify + uploads + the
    # two kernels + the handoff count read back
    batches = [next_deltas()[0] for _ in range(60)]
    for d in batches[:10]:
        state.reprice(d)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for d in batches[10:]:
        state.reprice(d)
    stop.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / 50
    dev_ms = start.elapsed_time(stop) / 50
    tick_bytes = (J * C * 5 + C * 4 + J * 8) + (
        J * C * 5 + 3 * C * 4 + 2 * J * 4 + S * J * 4 + 2 * S * C * 4)
    log(f"[fleet] {label}: {ticks} ticks, one dispatch each; per tick "
        f"{dev_ms:.4f} ms (CUDA events) / {host_ms:.4f} ms (host), bound "
        f"{tick_bytes / HBM_BYTES_PER_S * 1e3:.5f} ms ({tick_bytes} bytes "
        f"at 3.35 TB/s) on {card}")
    # where the tick's time goes: the host densify alone, and the two
    # kernels alone on the fleet's own tensors (CUDA events); the rest is
    # the two uploads, the launches and the handoff count read back
    t0 = time.perf_counter()
    for d in batches[10:]:
        state._dense_tick(d)
    densify_ms = (time.perf_counter() - t0) * 1e3 / 50
    kernels_ms = time_ms(torch, lambda: rd.fused_reprice(
        state.d_hours, state.d_mask, state.d_prices, state.d_prices, zeros,
        state.d_row_best, state.d_row_masks, state.d_scores), iters=50)
    log(f"[fleet] {label}: per tick densify {densify_ms:.4f} ms (host), "
        f"rowmin+fold {kernels_ms:.4f} ms (device), rest "
        f"{host_ms - densify_ms - kernels_ms:.4f} ms; kernels are "
        f"{kernels_ms / host_ms:.1%} of the tick")


# --- phase 4 --------------------------------------------------------------------

def phase_service(np, seed, n_jobs=64, n_cfgs=10_000, n_events=1_000,
                  device="cuda"):
    from repro_torch.core.trace import JobClass
    from repro_torch.market import (JournalReplayer, SelectionDaemon,
                                    SimulatedSpotFeed, synthetic_stream)
    from repro_torch.selector import (IdentityCatalog, PriceTable,
                                      ProfilingStore, SelectionService)
    rng = np.random.default_rng(seed)
    ids = [f"cfg{i}" for i in range(n_cfgs)]
    store = ProfilingStore(config_ids=ids)
    hours = rng.uniform(0.1, 5.0, (n_jobs, n_cfgs))
    keep = rng.random((n_jobs, n_cfgs)) >= 0.2          # partial profiling
    for j in range(n_jobs):
        klass = JobClass.A if j % 2 else JobClass.B
        for c in np.flatnonzero(keep[j]):
            store.add(f"job{j}", ids[c], float(hours[j, c]),
                      job_class=klass, group=f"g{j % 6}")
    table = PriceTable({c: float(p) for c, p in
                        zip(ids, rng.uniform(1.0, 30.0, n_cfgs))})
    service = SelectionService(IdentityCatalog(ids), store, table,
                               backend="torch_fused", device=device,
                               serve_top_k=10)
    feed = SimulatedSpotFeed(dict(table.items()), seed=seed,
                             change_fraction=0.01)
    daemon = SelectionDaemon(service, feed)
    t0 = time.perf_counter()
    stats = daemon.run(synthetic_stream(store.job_ids, n_events, seed=seed))
    secs = time.perf_counter() - t0
    fleet = service._batched
    check(fleet is not None and 0 < fleet.dispatches <= stats.epochs,
          f"service: fleet dispatches {getattr(fleet, 'dispatches', None)} "
          f"for {stats.epochs} price epochs")
    check(service.reprice_dispatches == fleet.dispatches,
          "service: more than one dispatch per tick")
    t0 = time.perf_counter()
    audit = JournalReplayer(store, daemon.journal_dump()).audit()
    audit_secs = time.perf_counter() - t0
    check(audit.ok, f"journal audit failed: {audit.mismatches[:3]}")
    check(audit.decisions == stats.decisions > 0, "audit saw no decisions")
    log(f"[service] {n_events} events in {secs:.3f} s "
        f"({n_events / secs:.1f} events/s): {stats.decisions} decisions, "
        f"{stats.ticks} ticks, {stats.epochs} epochs, {fleet.n_active} "
        f"members; audit ok in {audit_secs:.3f} s ({audit.decisions} "
        f"decisions, {len(audit.drift)} within-contract drift records)")
    # the service's own spans (host clock): where the daemon's time went
    spans = service.metrics.snapshot()["histograms"]
    log("[service] spans (count x mean ms): " + ", ".join(
        f"{name} {h['count']} x {h['sum'] * 1e3 / h['count']:.4f}"
        for name, h in spans.items() if h["count"]))
    return service, store, table


# --- phase 8 (first half): the profiled daemon; phase 4's kernels ------------

def phase_busy(torch, seed, service, store, table, n_events=1_000):
    """The card's busy share over a second daemon run on the warm
    service, traced by ``torch.profiler`` (CUDA activity only): the union
    of the kernel and copy intervals the trace holds, over the run's wall
    time.  Reported as not measured when the trace holds no device
    activity."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.market import (SelectionDaemon, SimulatedSpotFeed,
                                    synthetic_stream)
    feed = SimulatedSpotFeed(dict(table.items()), seed=seed + 1,
                             change_fraction=0.01)
    daemon = SelectionDaemon(service, feed)
    events = synthetic_stream(store.job_ids, n_events, seed=seed + 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stats = daemon.run(events)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    head = (f"[busy] {n_events} events ({stats.ticks} ticks, "
            f"{stats.decisions} decisions) in {wall:.3f} s under the "
            f"profiler")
    if not spans:
        log(f"{head}: busy share not measured (no device activity in the "
            f"trace)")
        return
    log(f"{head}: {len(spans)} device intervals, busy {busy_us / 1e3:.3f} "
        f"ms = {busy_us / 1e6 / wall:.3%} of the wall time")


def phase_main_path_kernels(torch, np, seed, fleet, errs, k=10):
    """The kernels at the shapes the main path gave them: the service
    fleet's own tensors (S = its slot capacity) with a 1% tick, and, for
    ``select``, one member's score row as the service's ``top_k`` serves
    it.  Held against the plain versions, then timed."""
    rng = np.random.default_rng(seed + 2)
    C = len(fleet.config_ids)
    newp = fleet._host_prices.copy()
    cols = rng.choice(C, max(1, C // 100), replace=False)
    newp[0, cols] = (newp[0, cols] * rng.uniform(0.7, 1.3, cols.size)
                     ).astype(np.float32)
    changed = np.zeros_like(newp)
    changed[0, cols] = 1.0
    t = dict(hours=fleet.d_hours, mask=fleet.d_mask, oldp=fleet.d_prices,
             newp=torch.from_numpy(newp).to(fleet.device),
             changed=torch.from_numpy(changed).to(fleet.device),
             rb=fleet.d_row_best, rm=fleet.d_row_masks,
             scores=fleet.d_scores, finite=fleet._d_finite)
    check_kernels(torch, t, "main path 1%", k, errs)
    slot = min(fleet._slots.values())
    row = (fleet.d_scores[slot:slot + 1], fleet._d_finite[slot:slot + 1])
    check_select(torch, *row, k, "main path top_k row", errs)
    return time_kernels(torch, t, k, heads=row)


# --- phase 5: the LM kernels against their plain versions ---------------------

#: (B, T, H, G, D, causal, window): GQA, MQA, bidirectional, windowed,
#: ragged T (the engine's 12-token prompts, 100, 130) and every head size
#: the kernel is built for
ATTN_CASES = [
    (2, 128, 4, 2, 64, True, None),
    (2, 64, 8, 1, 32, True, None),
    (1, 96, 2, 2, 16, False, None),
    (1, 256, 4, 4, 32, True, 64),
    (2, 12, 16, 8, 128, True, None),
    (1, 100, 4, 2, 80, True, 16),
    (1, 130, 2, 1, 128, False, None),
    (1, 200, 4, 4, 64, True, 48),
    (1, 100, 4, 1, 64, True, None),
    (1, 1000, 4, 2, 128, True, 300),
]
#: (B, T, H, N): a decode step, ragged T, both model head sizes
WKV_CASES = [(2, 1, 3, 64), (4, 1, 40, 64), (1, 37, 2, 64), (2, 100, 2, 16),
             (1, 64, 4, 32)]
#: the end-to-end bound on kernel vs plain prefill logits in bf16 (relative
#: L2; the reason is at its check in ``phase_serve``)
REL_L2_TOL = 0.1
#: the reference kernel tests' tolerances
ATTN_TOL = {"float32": (2e-5, 1e-2), "bfloat16": (2e-2, 1e-2)}
WKV_TOL = (1e-4, 1e-3)
LM_KERNELS = {
    "flash_attention": dict(
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:28",
        arch="qwen3-1.7b"),
    "flash_attention_scalar": dict(
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:28"),
    "wkv6": dict(
        source="src/repro_torch/csrc/wkv6_scan.cu",
        replaces="src/repro/kernels/rwkv6_scan.py:25",
        arch="rwkv6-3b"),
}
#: the kernel each served model's path runs
SERVED = ("flash_attention", "wkv6")


def allclose(torch, a, b, atol, rtol) -> bool:
    a, b = a.float(), b.float()
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all())


def sync(torch, dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def attn_inputs(torch, B, T, H, G, D, dtype, seed, dev="cuda"):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                 for shape in ((B, T, H, D), (B, T, G, D), (B, T, G, D)))


def wkv_inputs(torch, B, T, H, N, dtype, seed, random_state=True,
               dev="cuda"):
    gen = torch.Generator(device=dev).manual_seed(seed)
    r, k, v = (torch.randn((B, T, H, N), generator=gen, device=dev
                           ).to(dtype) for _ in range(3))
    w = torch.sigmoid(torch.randn((B, T, H, N), generator=gen,
                                  device=dev)) * 0.5 + 0.45
    u = torch.randn((H, N), generator=gen, device=dev) * 0.5
    s0 = torch.randn((B, H, N, N), generator=gen, device=dev) \
        * float(random_state)
    return r, k, v, w, u, s0


def check_attention(torch, q, k, v, causal, window, label, errs=None):
    """The kernel :func:`flash_attention.variant` names against the plain
    version; the error goes to ``errs`` under its record name."""
    from repro_torch.kernels import flash_attention as fa
    kind = fa.variant(q.dtype, q.shape[-1])
    before = fa.LAUNCHES[f"flash_attention_{kind}"]
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    check(fa.LAUNCHES[f"flash_attention_{kind}"] == before + 1,
          f"{label}: the {kind} kernel did not launch")
    want = fa.attention_ref(q, k, v, causal=causal, window=window)
    sync(torch, q.device)
    atol, rtol = ATTN_TOL[str(q.dtype).split(".")[-1]]
    err = max_err(torch, got.float(), want.float())
    check(got.dtype == q.dtype and got.shape == want.shape,
          f"{label}: flash attention returned {got.dtype} {tuple(got.shape)}")
    check(allclose(torch, got, want, atol, rtol),
          f"{label}: flash attention outside atol {atol} rtol {rtol} "
          f"(max |err| {err:.3g})")
    if errs is not None:
        name = "flash_attention" if kind == "tc" else "flash_attention_scalar"
        errs[name] = max(errs[name], err)
    return err


def check_wkv(torch, args, label, errs=None):
    from repro_torch.kernels import rwkv6_scan as wk
    y, sT = wk.wkv6(*args)
    y_p, s_p = wk.wkv6_scan_ref(*args)
    sync(torch, y.device)
    atol, rtol = WKV_TOL
    err = max(max_err(torch, y, y_p), max_err(torch, sT, s_p))
    check(allclose(torch, y, y_p, atol, rtol)
          and allclose(torch, sT, s_p, atol, rtol),
          f"{label}: wkv6 outside atol {atol} rtol {rtol} (max |err| "
          f"{err:.3g})")
    if errs is not None:
        errs["wkv6"] = max(errs["wkv6"], err)
    return err


def phase_lm_parity(torch, dev="cuda"):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rwkv6_scan as wk
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for case in ATTN_CASES:
            B, T, H, G, D, causal, window = case
            q, k, v = attn_inputs(torch, B, T, H, G, D, dtype,
                                  sum(case[:5]), dev)
            err = check_attention(torch, q, k, v, causal, window,
                                  f"attn {case} {name}")
            log(f"[lm-parity] flash attention {name} "
                f"({fa.variant(dtype, D)}) B={B} T={T} H={H} G={G} D={D} "
                f"causal={causal} window={window}: max |err| {err:.3g} ok")
        for case in WKV_CASES:
            args = wkv_inputs(torch, *case, dtype, sum(case), dev=dev)
            err = check_wkv(torch, args, f"wkv {case} {name}")
            log(f"[lm-parity] wkv6 {name} B,T,H,N={case}: max |err| "
                f"{err:.3g} ok")
        # the two-call state carry
        r, k, v, w, u, s0 = wkv_inputs(torch, 1, 64, 2, 64, dtype, 11,
                                       dev=dev)
        y_full, s_full = wk.wkv6_scan_ref(r, k, v, w, u, s0)
        halves = [tuple(a[:, sl].contiguous() for a in (r, k, v, w))
                  for sl in (slice(0, 29), slice(29, 64))]
        y1, s_mid = wk.wkv6(*halves[0], u, s0)
        y2, s_T = wk.wkv6(*halves[1], u, s_mid)
        sync(torch, dev)
        check(allclose(torch, torch.cat([y1, y2], 1), y_full, *WKV_TOL)
              and allclose(torch, s_T, s_full, *WKV_TOL),
              f"wkv6 {name}: state carry across two calls differs")
        log(f"[lm-parity] wkv6 {name} state carry over 29 + 35 steps ok")


# --- phase 6: decode-fleet placement ------------------------------------------

def placement_report():
    """A hand-made dry-run report: decode and train cells of three
    architectures on four mesh splits (the high-TP split decodes
    fastest, the high-DP one trains fastest)."""
    speed = {"dp256xtp1": (1.0, 4.0), "dp32xtp8": (1.2, 1.5),
             "dp16xtp16": (1.5, 1.0), "dp8xtp32": (2.5, 1.1)}
    cells = []
    for arch in ("qwen3-1.7b", "rwkv6-3b", "stablelm-3b"):
        for mesh, (train, decode) in speed.items():
            for shape, step in (("train_4k", train), ("decode_32k", decode)):
                cells.append({"arch": arch, "shape": shape, "mesh": mesh,
                              "ok": True, "roofline": {
                                  "compute_s": step, "memory_s": step / 2,
                                  "collective_s": step / 4}})
    return {"cells": cells}


def phase_placement(dev="cuda"):
    from repro_torch.core.costmodel import TpuPriceModel
    from repro_torch.core.tpu_flora import service_from_dryrun_report
    from repro_torch.serve import plan_decode_placement
    service = service_from_dryrun_report(placement_report(),
                                         TpuPriceModel("spot"), device=dev)
    decision = plan_decode_placement(service,
                                     exclude_archs=("qwen3-1.7b",))
    check(decision.config_id == "dp16xtp16",
          f"placement picked {decision.config_id}, expected dp16xtp16")
    log(f"[placement] decode fleet: mesh {decision.config_id} at "
        f"{decision.hourly_cost:.2f} $/h (class {decision.job_class.value}, "
        f"{service.backend} on {service.device}); ranking "
        f"{[r.config_id for r in decision.ranking]}")
    return decision


# --- phase 7: LM serving at full width; phase 8's model profiles --------------

def profile_window(torch, fn, dev="cuda"):
    """Device time by kernel name and the busy share over ``fn()``, from
    ``torch.profiler`` (CUDA activity; CPU activity on a CPU rehearsal)."""
    from torch.profiler import ProfilerActivity, profile
    on_card = torch.device(dev).type == "cuda"
    kind = torch.autograd.DeviceType.CUDA if on_card \
        else torch.autograd.DeviceType.CPU
    sync(torch, dev)
    with profile(activities=[ProfilerActivity.CUDA if on_card
                             else ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        fn()
        sync(torch, dev)
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == kind)
    busy_us, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    by_name = sorted(((getattr(e, "self_device_time_total", 0.0), e.key,
                       e.count) for e in prof.key_averages()),
                     reverse=True)
    return wall, busy_us, by_name


def phase_parity_4_layers(torch, cfg, seed, dev="cuda"):
    """``cfg``'s width, 4 layers, fp32: prefill + 6 decode steps against
    ``forward`` within the reference's decode-parity tolerance 2e-3."""
    from repro_torch.models import build_model
    name = cfg.name
    cfg = dataclasses.replace(cfg, num_layers=4, dtype="float32")
    model = build_model(cfg, device=dev, seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen,
                           device=dev)
    with torch.inference_mode():
        full = model({"tokens": tokens})
        state = model.init_state(2, 12)
        logits, state = model.prefill({"tokens": tokens[:, :6]}, state)
        errs = [float((logits - full[:, 5]).abs().max())]
        for t in range(6, 12):
            logits, state = model.decode_step(tokens[:, t], t, state)
            errs.append(float((logits - full[:, t]).abs().max()))
    check(max(errs) < 2e-3, f"{name} 4-layer fp32: prefill/decode vs "
          f"forward max |err| {max(errs):.3g} >= 2e-3")
    log(f"[serve] {name} 4 layers fp32 at d_model {cfg.d_model}: prefill + "
        f"6 decode steps vs forward max |err| {max(errs):.3g} (< 2e-3) ok")
    del model, full, state
    free_card(torch, dev)


def free_card(torch, dev) -> None:
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()


def card_gib(torch, dev, peak=False) -> float:
    if torch.device(dev).type != "cuda":
        return float("nan")
    f = torch.cuda.max_memory_allocated if peak \
        else torch.cuda.memory_allocated
    return f() / 2**30


def phase_serve(torch, np, cfg, seed, card, placement=None, n_requests=8,
                prompt_len=1024, slots=4, max_new=32, dev="cuda"):
    """Serve ``cfg`` (the published width on the card); returns what the
    kernel phase needs (the path's launches and shapes)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rwkv6_scan as wk
    from repro_torch.models import build_model, count_params
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serve import Engine, Request
    name = cfg.name
    kernel = "wkv6" if "rwkv" in cfg.block_pattern else "flash_attention"
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=seed)
    sync(torch, dev)
    n_params = count_params(model.param_specs())
    log(f"[serve] {name}: {n_params / 1e9:.3f} B params ({cfg.dtype}) "
        f"drawn on {dev} in {time.perf_counter() - t0:.2f} s, "
        f"{card_gib(torch, dev):.2f} GiB")
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size, (n_requests, prompt_len))
    reqs = [Request(uid=i, prompt=prompts[i], max_new_tokens=max_new)
            for i in range(n_requests)]
    # warm-up at the traffic's shapes (library loads, cuBLAS handles and
    # heuristics, the allocator's blocks), outside the counted run
    Engine(model, slots=slots, max_len=prompt_len + max_new, device=dev
           ).generate_batch([dataclasses.replace(reqs[0],
                                                 max_new_tokens=2)])
    metrics = MetricsRegistry()
    eng = Engine(model, slots=slots, max_len=prompt_len + max_new,
                 placement=placement, metrics=metrics, device=dev)
    sync(torch, dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    comps = eng.serve(reqs)
    sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = ops.launches()
    check(sorted(c.uid for c in comps) == list(range(n_requests))
          and all(len(c.tokens) == max_new for c in comps),
          f"{name}: served {len(comps)} completions")
    waves = -(-n_requests // slots)
    check(eng.prefills == waves and eng.decode_steps == waves
          * (max_new - 1), f"{name}: {eng.prefills} prefills, "
          f"{eng.decode_steps} decode steps")
    L = cfg.num_layers
    if kernel == "flash_attention":
        # every prefill launch the tensor-core kernel
        n = L * eng.prefills
        expect = {"flash_attention": n, "flash_attention_tc": n,
                  "flash_attention_scalar": 0, "wkv6": 0}
    else:
        expect = {"flash_attention": 0, "flash_attention_tc": 0,
                  "flash_attention_scalar": 0,
                  "wkv6": L * (eng.prefills + eng.decode_steps)}
    check(launches == expect, f"{name}: kernel launches {launches}, "
          f"expected {expect} for {L} layers")
    hist = metrics.snapshot()["histograms"]
    pre_s, dec_s = hist["serve.prefill"]["sum"], hist["serve.decode"]["sum"]
    pre_tok = n_requests * prompt_len
    dec_tok = eng.decode_steps * slots
    log(f"[serve] {name}: {n_requests} requests x {prompt_len}-token "
        f"prompts over {slots} slots, {max_new} new tokens each, in "
        f"{wall:.3f} s; launches {launches} (= {L} layers x "
        f"{'prefills' if kernel == 'flash_attention' else 'model calls'})")
    log(f"[serve] {name}: prefill {pre_tok} tokens in {pre_s:.4f} s = "
        f"{pre_tok / pre_s:.1f} tokens/s; decode {eng.decode_steps} steps "
        f"x {slots} slots in {dec_s:.4f} s = {dec_tok / dec_s:.1f} "
        f"tokens/s ({dec_s / eng.decode_steps * 1e3:.3f} ms a step); peak "
        f"{card_gib(torch, dev, peak=True):.2f} GiB on {card}")
    # the same traffic again on the warm engine: the spread within a call
    again = MetricsRegistry()
    Engine(model, slots=slots, max_len=prompt_len + max_new,
           metrics=again, device=dev).serve(reqs)
    sync(torch, dev)
    hist = again.snapshot()["histograms"]
    pre_2, dec_2 = hist["serve.prefill"]["sum"], hist["serve.decode"]["sum"]
    log(f"[serve] {name}: the same traffic again: prefill "
        f"{pre_tok / pre_2:.1f} tokens/s, decode {dec_tok / dec_2:.1f} "
        f"tokens/s ({dec_2 / eng.decode_steps * 1e3:.3f} ms a step)")
    if placement is not None:
        check(eng.placement is placement, "placement not attached")
        log(f"[serve] {name}: engine placement mesh "
            f"{eng.placement.config_id} at "
            f"{eng.placement.hourly_cost:.2f} $/h")

    # the first wave again: finite logits, and against the plain version
    first = {"tokens": torch.as_tensor(prompts[:slots], device=dev)}
    with torch.inference_mode():
        logits, _ = model.prefill(first, model.init_state(
            slots, prompt_len + max_new))
        # for this pass alone the model-side entry point is the plain
        # version; the package has no switch for it
        plain = fa.attention_ref if kernel == "flash_attention" \
            else wk.wkv6_scan_ref
        original = getattr(ops, kernel)
        setattr(ops, kernel, plain)
        try:
            logits_p, _ = model.prefill(first, model.init_state(
                slots, prompt_len + max_new))
        finally:
            setattr(ops, kernel, original)
    check(bool(torch.isfinite(logits.float()).all()),
          f"{name}: non-finite prefill logits")
    a, b = logits.float(), logits_p.float()
    rel = float((a - b).norm() / b.norm())
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    # bf16 over the depth: the kernel and the plain version take their
    # fp32 sums in another order, so each layer's bf16 activations round
    # the other way wherever a sum sits near a rounding boundary (a step
    # of 2^-8), and the random-weight residual stream carries these on
    # through every later layer.  On an H100 that drift measured 0.02 of
    # the logits' norm over qwen3-1.7b's 28 layers and 0.05 over
    # rwkv6-3b's 32, so the bound is twice the larger.  The kernels
    # themselves are held to the reference tolerances in phase 5 and at
    # the path's shapes in ``time_lm_kernel``; this check covers the
    # path's own activations.
    check(rel < REL_L2_TOL, f"{name}: kernel vs plain prefill logits "
          f"relative error {rel:.3g} >= {REL_L2_TOL}")
    log(f"[serve] {name}: first-wave prefill logits, kernel vs plain "
        f"{kernel}: relative L2 error {rel:.3g} (< {REL_L2_TOL}, bf16 over "
        f"{L} layers), max |err| {float((a - b).abs().max()):.3g} of max "
        f"|logit| {float(b.abs().max()):.3g}, argmax agreement "
        f"{agree:.0%}; all finite")

    shapes = dict(B=slots, T=prompt_len, d=cfg.d_model, H=cfg.num_heads,
                  G=cfg.num_kv_heads, D=cfg.head_dim,
                  N=cfg.rwkv_head_dim, dtype=cfg.compute_dtype)
    del model, eng, logits, logits_p, first
    free_card(torch, dev)
    return dict(kernel=kernel, launches=launches, shapes=shapes)


def phase_lm_profile(torch, np, cfg, seed, prompt_len=1024, slots=4,
                     steps=8, dev="cuda"):
    """Where the time goes: the model rebuilt from the same seed runs the
    first wave's prefill and ``steps`` decode steps under
    ``torch.profiler`` (device time by kernel, busy share).  Before that,
    the same decode steps unprofiled, timed by the host clock: this phase
    runs after every other profiled phase, so that reading shows what the
    earlier profiler sessions left behind in the launch path."""
    from repro_torch.models import build_model
    model = build_model(cfg, device=dev, seed=seed)
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size, (slots, prompt_len))
    first = {"tokens": torch.as_tensor(prompts, device=dev)}

    def window():
        with torch.inference_mode():
            st = model.init_state(slots, prompt_len + steps)
            lg, st = model.prefill(first, st)
            tok = lg.argmax(-1)
            sync(torch, dev)
            t0 = time.perf_counter()
            for step in range(steps):
                lg, st = model.decode_step(tok, prompt_len + step, st)
                tok = lg.argmax(-1)
            sync(torch, dev)
            return time.perf_counter() - t0

    window()                                  # warm-up
    step_ms = window() / steps * 1e3
    wall, busy_us, by_name = profile_window(torch, window, dev)
    total = sum(t for t, _, _ in by_name) or 1.0
    log(f"[profile] {cfg.name}: decode step unprofiled, after the earlier "
        f"profiler sessions: {step_ms:.3f} ms")
    log(f"[profile] {cfg.name}: prefill + {steps} decode steps under the "
        f"profiler: {wall:.4f} s wall, card busy {busy_us / 1e3:.3f} ms = "
        f"{busy_us / 1e6 / wall:.1%}; top kernels by device time:")
    for t_us, key, count in by_name[:8]:
        log(f"[profile]   {t_us / 1e3:9.3f} ms {t_us / total:6.1%} "
            f"x{count} {key[:90]}")
    del model, first
    free_card(torch, dev)


def time_lm_kernel(torch, kernel, shapes, errs, seed, dev="cuda"):
    """The kernel at the shapes its path gave it: held against its plain
    version, then timed beside the plain version, the library call (SDPA
    for attention, none for WKV6) and its bound.  For attention, also the
    scalar kernel on the same bf16 inputs (the kernel this path ran
    before the tensor-core one: ``earlier_ms``) and, as its own entry
    under ``"scalar"``, on fp32 inputs of the same shape, its dtype."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rwkv6_scan as wk
    sh = shapes
    B, T, dt = sh["B"], sh["T"], sh["dtype"]
    if kernel == "flash_attention":
        H, G, D = sh["H"], sh["G"], sh["D"]
        q, k, v = attn_inputs(torch, B, T, H, G, D, dt, seed, dev)
        err = check_attention(torch, q, k, v, True, None,
                              f"path shape {(B, T, H, G, D)}", errs)
        log(f"[lm-parity] flash attention bfloat16 (tc) at the path shape "
            f"B={B} T={T} H={H} G={G} D={D}: max |err| {err:.3g} ok")
        sdpa = torch.nn.functional.scaled_dot_product_attention
        pairs = B * H * T * (T + 1) // 2
        n_elems = 2 * B * T * H * D + 2 * B * T * G * D

        def timed(q, k, v, kind, ops_per_s):
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            out = dict(
                ms=time_ms(torch, lambda: fa._launch(q, k, v, True, None,
                                                     kind),
                           iters=50 if kind == "tc" else 10, warmup=3),
                plain_ms=time_ms(torch, lambda: fa.attention_ref(
                    q, k, v, causal=True), iters=5, warmup=1),
                library_ms=time_ms(torch, lambda: sdpa(
                    qt, kt, vt, is_causal=True, enable_gqa=True),
                    iters=50, warmup=3),
                bound=bound_ms(q.element_size() * n_elems, 4 * D * pairs,
                               ops_per_s))
            del qt, kt, vt
            return out

        r = timed(q, k, v, "tc", BF16_FLOPS_PER_S)
        r["earlier_ms"] = time_ms(torch, lambda: fa._launch(
            q, k, v, True, None, "scalar"), iters=10, warmup=2)
        q32, k32, v32 = (x.float() for x in (q, k, v))
        err = check_attention(torch, q32, k32, v32, True, None,
                              f"path shape {(B, T, H, G, D)} fp32", errs)
        log(f"[lm-parity] flash attention float32 (scalar) at the path "
            f"shape: max |err| {err:.3g} ok")
        # the scalar kernel's fp32 FMAs: the fp32 peak off the tensor cores
        r["scalar"] = timed(q32, k32, v32, "scalar", FP32_FLOPS_PER_S)
        del q32, k32, v32
        what = f"B={B} T={T} H={H} G={G} D={D} causal bf16"
        sc = r["scalar"]
        log(f"[time] flash_attention_scalar: kernel {sc['ms']:.4f} ms, "
            f"plain {sc['plain_ms']:.4f} ms, library "
            f"{sc['library_ms']:.4f} ms, bound {sc['bound'][0]:.5f} ms "
            f"({sc['bound'][1]}) at B={B} T={T} H={H} G={G} D={D} causal "
            f"fp32")
    else:
        H, N = sh["d"] // sh["N"], sh["N"]
        args = wkv_inputs(torch, B, T, H, N, dt, seed, random_state=False,
                          dev=dev)
        check_wkv(torch, args, f"path shape {(B, T, H, N)}", errs)
        dec = wkv_inputs(torch, B, 1, H, N, dt, seed + 1, dev=dev)
        check_wkv(torch, dec, f"decode shape {(B, 1, H, N)}", errs)
        r = dict(
            ms=time_ms(torch, lambda: wk.wkv6(*args), iters=20, warmup=3),
            plain_ms=time_ms(torch, lambda: wk.wkv6_scan_ref(*args),
                             iters=3, warmup=1),
            library_ms=None,
            decode_ms=time_ms(torch, lambda: wk.wkv6(*dec), iters=200))

        def wkv_bound(steps):
            n_bytes = (3 * 2 + 4 + 4) * B * steps * H * N + 4 * H * N \
                + 2 * 4 * B * H * N * N
            return bound_ms(n_bytes, 5 * N * N * B * H * steps)
        r["bound"] = wkv_bound(T)
        r["decode_bound"] = wkv_bound(1)
        what = f"B={B} T={T} H={H} N={N} bf16 r/k/v"
    lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
    earlier = f", scalar kernel {r['earlier_ms']:.4f} ms" \
        if "earlier_ms" in r else ""
    log(f"[time] {kernel}: kernel {r['ms']:.4f} ms{earlier}, plain "
        f"{r['plain_ms']:.4f} ms, library {lib} ms, bound "
        f"{r['bound'][0]:.5f} ms ({r['bound'][1]}) at {what}")
    if "decode_ms" in r:
        log(f"[time] {kernel}: decode step (T=1) kernel "
            f"{r['decode_ms']:.4f} ms, bound {r['decode_bound'][0]:.6f} ms "
            f"({r['decode_bound'][1]})")
    return r


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import rank_delta as rd
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    card = gpu_name_and_limit()
    log(f"[env] {card}")
    t_start = time.perf_counter()

    def done(phase: str) -> None:
        log(f"[{phase}] done at {time.perf_counter() - t_start:.1f} s")

    phase_build(torch)
    done("build")
    errs, main_shape, big_shape = phase_parity(torch, np, args.seed)
    # the fleet heads tick's k-head: every member row of 64 x 100k x 16
    heads_times = time_kernels(torch, big_shape)
    time_kernels(torch, main_shape)
    done("parity")
    phase_fleet(torch, np, args.seed, 64, 10_000, 16, 100, 10,
                "64x10000x16", card)
    rd.reset_launches()
    phase_fleet(torch, np, args.seed + 1, 64, 100_000, 16, 10, 10,
                "64x100000x16", card)
    fleet_heads_launches = rd.LAUNCHES["select"]
    done("fleet")
    rd.reset_launches()
    service, store, table = phase_service(np, args.seed)
    launches = dict(rd.LAUNCHES)
    done("service")
    for name in PATH_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched on "
              f"the main path")
    times = phase_main_path_kernels(torch, np, args.seed, service._batched,
                                    errs)
    done("main-path kernels")
    phase_lm_parity(torch)
    done("lm-parity")
    placement = phase_placement()
    done("placement")
    from repro_torch import configs
    lm_errs = {name: 0.0 for name in LM_KERNELS}
    lm_runs = {}
    for name in SERVED:
        cfg = configs.get(LM_KERNELS[name]["arch"])
        run = phase_serve(torch, np, cfg, args.seed, card, placement)
        check(run["kernel"] == name, f"{cfg.name} ran {run['kernel']}")
        phase_parity_4_layers(torch, cfg, args.seed)
        run["times"] = time_lm_kernel(torch, name, run["shapes"], lm_errs,
                                      args.seed)
        lm_runs[name] = run
        done(f"serve {cfg.name}")
    # the profiled phases come last: a profiler session may slow the
    # host's launches for the rest of the process (phase_lm_profile reads
    # whether it did), and the serving phases time those launches
    phase_busy(torch, args.seed, service, store, table)
    done("busy")
    del service, store, table
    for name in SERVED:
        phase_lm_profile(torch, np, configs.get(LM_KERNELS[name]["arch"]),
                         args.seed)
    done("profile")

    def entry(name, source, replaces, n_launches, err, r):
        e = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": n_launches,
             "max_abs_err": err, "ms": r["ms"],
             "earlier_ms": r.get("earlier_ms"), "plain_ms": r["plain_ms"],
             "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
             "library_ms": r["library_ms"]}
        if "device_ms" in r:
            e.update(device_ms=r["device_ms"],
                     library_device_ms=r["library_device_ms"])
        return e

    kernels = []
    for name in KERNELS:
        kernels.append(entry(f"rank_delta_{name}", SOURCE, REPLACES[name],
                             launches[name], errs[name], times[name]))
        if name in ALSO_REPLACES:
            kernels[-1]["also_replaces"] = ALSO_REPLACES[name]
    # the same select kernel at the fleet heads tick's shape (B2)
    kernels.append(entry("rank_delta_select_heads_64x100000x16", SOURCE,
                         ALSO_REPLACES["select"], launches["select"],
                         errs["select"], heads_times["select"]))
    kernels[-1]["fleet_launches"] = fleet_heads_launches
    qwen, rwkv = lm_runs["flash_attention"], lm_runs["wkv6"]
    runs = {"flash_attention": (qwen["launches"]["flash_attention_tc"],
                                qwen["times"]),
            "flash_attention_scalar": (
                qwen["launches"]["flash_attention_scalar"],
                qwen["times"]["scalar"]),
            "wkv6": (rwkv["launches"]["wkv6"], rwkv["times"])}
    for name, spec in LM_KERNELS.items():
        n_launches, r = runs[name]
        kernels.append(entry(name, spec["source"], spec["replaces"],
                             n_launches, lm_errs[name], r))
        if "decode_ms" in r:
            kernels[-1].update(decode_ms=r["decode_ms"],
                               decode_bound_ms=r["decode_bound"][0])
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
