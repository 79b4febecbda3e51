#!/usr/bin/env python3
"""Run the port's live-market selection path and its LM serving path on
one CUDA card and check them.

    python3 chip_smoke.py [--seed N]

Phases:

1. build the CUDA kernels from ``src/repro_torch/csrc`` with ``nvcc``, one
   process per source, all started together (``-Xptxas -v`` registers,
   shared memory and spills printed, and each source's build time);
2. hold every ``rank_delta`` kernel against its plain PyTorch version on
   the card: the tick's price ``scatter`` (bitwise, C = 1 to 100,000, n =
   0 to C, each case scattered twice back to back); ``rowmin`` and the
   one-block-a-row ``rowmin_row`` it replaced, bitwise, at C = 1 to
   10,001 around its 4,096-column chunk (``ROWMIN_EDGES``) and 100 times
   in a row on one scratch; ragged shapes, fully masked rows, a member
   with fewer profiled configs than k, an identity tick (bitwise), 1%
   and 30% changed columns, the fold twice on the same inputs (bitwise) and
   against the column-per-thread ``fold_col`` it replaced, the
   two-stage ``select`` at its cap (256), ``select_sort`` one past it
   and at k = C on one row, the k-round ``select_rounds`` (the
   yardstick) past its old cap, and the fleet's own shapes — then time
   each kernel, its plain version, the kernel it replaced
   (``rowmin_row``, ``fold_col``, ``select_rounds``) and, where one
   exists, the one PyTorch call that computes the same thing; and
   ``scatter`` at 10,000 and 100,000 columns and a 1% tick beside its
   plain version, the PyTorch scatter;
3. run :class:`TorchFusedRankState` at 64 jobs x 10,000 configs x 16
   members for 100 ticks (1% of prices per tick) and at 64 x 100,000 for
   10 (cut from 20 to leave room for the LM phases), holding every member
   against the float64 ``rank_dense`` under the score contract, the fused
   heads against ``ranking()[:10]``, a tick bit for bit against the
   dense path it replaced (the whole (1, C) price and changed vectors
   built on the host and uploaded), and timing the tick and its host
   step through both paths in turns;
4. serve a ``SelectionService(backend="torch_fused")`` over a 64 x 10,000
   store through a ``SelectionDaemon`` for 1,000 events and audit its
   journal with ``JournalReplayer`` — the selection path, read through
   the kernels' launch counters: one ``scatter``, one ``rowmin`` and one
   ``fold`` a tick, ``select`` for the k-heads, no ``rowmin_row``,
   ``select_sort``, ``fold_col`` or ``select_rounds`` — then hold each
   kernel against its plain version at the shapes that path gave it and
   time it there, and time the k-head at k = 65 to 10,000 on one member
   row and at k = 1,000 on the 64 x 100,000 fleet's 16 rows
   (``HEAD_SHAPES``) beside ``torch.topk`` and, up to k = 1,000 on one
   row, the k-round kernel;
5. serve phase 4's store and catalog through the front-end
   (``ServeFrontend``, ``torch_fused``, ``serve_top_k=10``) at 1 and 4
   workers and through the daemon, on one recorded 100-tick market (1% of
   prices a tick) and 1,000 submissions, each decision followed by a
   1 ms modelled client reply: zero shed, every submission journaled,
   ``shutdown`` raising nothing, each merged journal audit-clean, one
   ``scatter``, ``rowmin`` and ``fold`` a fleet tick and at most one
   ``select`` a published snapshot plus one a forwarded submission (never
   one a route), read through the launch counters around each
   front-end run.  Submissions/s of all three, the speed-up and scaling
   efficiency beside the reference benchmark's claims (recorded, not
   gated), and the snapshot build's heads in turns: one ``select`` for
   every route against one a route;
6. the reference turbulence benchmark's universe (the paper's trace at
   seed 0, 18 jobs x 10 configs), 400 events: the calm preset regenerates
   ``examples/data/gcp_spot_prices.csv`` byte for byte, the calm fixture's
   mean deviation stays <= 0.0645 on numpy and on ``torch_fused``, every
   preset's point on both backends audits clean (``scatter``, ``rowmin``
   and ``fold`` once a fleet tick, at C = 10), a stubbed
   ``PollingPriceFeed`` evaluates as the recorded feed on ``torch_fused``,
   and the quickstart's picks through the port's Flora (class A -> #9,
   class B -> #1, Flora the best row of Table IV);
7. hold both flash-attention kernels and the WKV6 kernel against their
   plain versions: the tensor-core kernel (bf16) and the scalar one
   (fp32); causal, windowed and bidirectional; GQA and MQA; ragged T;
   head sizes 16 to 128, with D = 80 (a 64-column block and a 16-column
   tail) also at stablelm-3b's prefill shape, GQA, T = 1, 100, 129 and a
   windowed T = 1,000; for WKV6 a decode step,
   ragged T, one step past the split kernel's chunk, RWKV-6's strong
   decays (w = exp(-exp(x)), x in [-8, 2]) and a two-call state carry;
8. plan the decode fleet's mesh through the port's selection service from
   a hand-made dry-run report;
9. serve ``qwen3-1.7b``, ``stablelm-3b`` and then ``rwkv6-3b`` at full
   width (random bf16 weights from the seed): 8 requests of 1,024-token
   prompts over 4 slots, 32 new tokens each — the LM path, read through
   the kernels' launch counters (28 and 32 flash-attention launches per
   prefill, every one the tensor-core kernel; 32 WKV6 launches per
   prefill and per decode step) — after a warm-up at the traffic's
   shapes, and once more for the spread.  Then: all logits finite; the
   first wave's prefill logits against a pass whose kernel is swapped
   for its plain version; for attention, the first wave's prefill timed
   in turns with the tensor-core kernel and with the scalar one it
   replaced; prefill + decode against ``forward`` at full width, 4
   layers, fp32 (the scalar attention kernel); and the kernels at the
   shapes the path gave them, against their plain versions and timed
   beside their bounds, the kernel they replaced (the scalar attention
   kernel, bf16; the sequential WKV6 kernel) and, for attention,
   ``scaled_dot_product_attention``; for WKV6 also the decode step back
   to back and from a CUDA graph;
10. last, the profiled phases: a second 1,000-event daemon on phase 4's
    service under ``torch.profiler`` (the card's busy share), then each
    model's first-wave prefill and 8 decode steps (device time by
    kernel, busy share).

Every phase runs on every call.  Every check that fails exits non-zero.
The last three lines are the ``{"kernels": [...]}`` record, the card's
name and power limit, and ``{"ok": true, "device": {...}}``.  In the
record, ``earlier_ms`` is the time, on the same inputs in the same run,
of the kernel the entry's function ran on before this kernel (the
one-block-a-row ``rowmin``, the k-round ``select``, the column-per-thread
fold, the scalar attention kernel in bf16, the sequential WKV6 kernel);
null where the kernel is the one that was there.  The k-head, ``rowmin``
and ``fold`` entries add ``device_ms`` (and the k-heads
``library_device_ms``): the same calls replayed from a CUDA graph, the
card's time without the host's (``earlier_device_ms`` the earlier
kernel's).  The ``scatter``, ``rowmin``, ``fold`` and ``select`` entries add
``frontend_launches`` (phase 5's 4-worker front-end run) and
``turbulence_launches`` (phase 6's sweep).  ``rank_delta_scatter`` is the
price scatter at the
service's C = 10,000 (``rank_delta_scatter_100000`` at 100,000), a 1%
tick; ``rank_delta_rowmin_64x*`` and ``rank_delta_fold_64x*`` are
``rowmin`` and the fold at 16 members on the two fleet shapes;
``rank_delta_khead_<rows>x<columns>_k<k>`` the k-head at each timed
shape, with the ``kernel`` that k takes.
``wkv6`` adds the decode step's times (``decode_ms`` back to back,
``decode_graph_ms`` from a CUDA graph, ``decode_earlier_ms`` and
``decode_earlier_graph_ms`` the sequential kernel) and its bound.
``flash_attention`` (qwen3-1.7b, D = 128) and ``flash_attention_d80``
(stablelm-3b, D = 80) add ``wave_ms`` and ``wave_earlier_ms``: the first
wave's prefill with the tensor-core kernel and with the scalar one.
Without a CUDA device the script exits non-zero before printing any
result.  It
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
#: what each CUDA kernel replaces on the main path: the reference's host
#: densify of a tick's prices (``_dense_tick``, numpy, no Pallas kernel)
#: for ``scatter``; the fused Pallas body (``_make_kernel``) for ``rowmin``
#: and ``fold``; for ``select``, the
#: ``jax.lax.top_k`` that the reference fleet's ``top_k`` serves from
#: (the service calls ``top_k``, never ``reprice_with_heads``)
REPLACES = {"scatter": "src/repro/selector/pallas_rank.py:248",
            "rowmin": "src/repro/kernels/rank_delta.py:69",
            "rowmin_row": "src/repro/kernels/rank_delta.py:69",
            "fold": "src/repro/kernels/rank_delta.py:69",
            "fold_col": "src/repro/kernels/rank_delta.py:69",
            "select": "src/repro/selector/rank.py:1218",
            "select_sort": "src/repro/selector/rank.py:1218",
            "select_rounds": "src/repro/selector/rank.py:1218"}
#: the k-heads also port the Pallas kernel's in-kernel top-k tail, which
#: only ``fused_reprice_heads`` runs (phases 2 and 3, not the service)
ALSO_REPLACES = {"select": "src/repro/kernels/rank_delta.py:157",
                 "select_sort": "src/repro/kernels/rank_delta.py:157",
                 "select_rounds": "src/repro/kernels/rank_delta.py:157"}
KERNELS = ("scatter", "rowmin", "rowmin_row", "fold", "fold_col", "select",
           "select_sort", "select_rounds")
#: the kernels the selection path launches (its k is 10: ``select_sort``
#: serves only k above ``rank_delta.SELECT_CAP``)
PATH_KERNELS = ("scatter", "rowmin", "fold", "select")
#: the k-head's timed (rows, columns, k): one member row of the service's
#: 64 x 10,000 fleet and the 64 x 100,000 fleet's 16 member rows
HEAD_SHAPES = ((1, 10_000, 65), (1, 10_000, 256), (1, 10_000, 257),
               (1, 10_000, 1_000), (1, 10_000, 10_000), (16, 100_000, 1_000))
#: the largest k at which the k-round kernel is timed beside a k-head
ROUNDS_MAX_K = 1_000
SOURCES = ("rank_delta", "flash_attention", "wkv6_scan")
#: rowmin's edge shapes (J, C): one column, C not a multiple of 4 (scalar
#: loads), one short of, at and one past 2,048 and 4,096 columns (the
#: kernel's chunk, ``rank_delta.ROWMIN_CHUNK``), the fleet's C (vector
#: loads) and one past it (scalar loads)
ROWMIN_EDGES = tuple((J, C) for J in (1, 64)
                     for C in (1, 3, 2_047, 2_048, 2_049, 4_095, 4_096,
                               4_097, 10_000, 10_001))


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
    # captured on the warm-up stream, where rowmin's scratch already exists
    with torch.cuda.graph(graph, stream=side):
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


def bitwise(torch, a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def max_err(torch, a, b) -> float:
    same = (a == b)
    diff = torch.where(same, torch.zeros_like(a), (a - b).abs())
    return float(diff.max()) if diff.numel() else 0.0


def check_select(torch, scores, finite, k, label, errs,
                 kernel="select") -> None:
    """The k-head kernel ``k`` takes (``select``; ``select_sort`` past the
    cap) against the plain stable sort: the same indices and values, bit
    for bit, and every head k distinct configs."""
    from repro_torch.kernels import rank_delta as rd
    check(rd._select_plan(*scores.shape, k).kernel == kernel,
          f"{label}: k={k} is not {kernel}'s")
    before = dict(rd.LAUNCHES)
    ti_k, tv_k = rd._launch_select(scores, finite, k)
    check({n: rd.LAUNCHES[n] - before[n] for n in before}
          == {n: int(n == kernel) for n in before},
          f"{label}: {kernel} did not launch alone")
    ti_p, tv_p = rd.select_heads_plain(scores, finite, k)
    check(torch.equal(ti_k, ti_p), f"{label}: {kernel} indices differ from "
          f"the stable sort")
    check(torch.equal(tv_k.view(torch.int32), tv_p.view(torch.int32)),
          f"{label}: {kernel} values differ")
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
    rb_r, moved_r = rd._launch_rowmin(t["hours"], t["mask"], t["newp"],
                                      t["rb"], variant="rowmin_row")
    rb_p, moved_p = rd.rowmin_plain(t["hours"], t["mask"], t["newp"],
                                    t["rb"])
    check(bitwise(torch, rb_k, rb_p) and bitwise(torch, rb_r, rb_p),
          f"{label}: row minima not bitwise equal")
    check(int(moved_k) == int(moved_p) == int(moved_r), f"{label}: moved "
          f"{int(moved_k)} (rowmin_row {int(moved_r)}) != {int(moved_p)}")
    fold_args = args[:6] + (rb_k, t["rm"], t["scores"])
    s_k = rd._launch_fold(*fold_args)
    s_p = rd.fold_plain(*fold_args)
    check(within(torch, s_k, s_p), f"{label}: fold outside rel "
          f"{REL_TOL}/abs {ABS_TOL}")
    again = rd._launch_fold(*fold_args)
    check(torch.equal(again.view(torch.int32), s_k.view(torch.int32)),
          f"{label}: two folds of the same inputs differ")
    s_col = rd._launch_fold(*fold_args, variant="fold_col")
    check(within(torch, s_k, s_col), f"{label}: fold and fold_col differ "
          f"beyond rel {REL_TOL}/abs {ABS_TOL}")
    if identity:
        check(torch.equal(s_k, t["scores"]) and torch.equal(rb_k, t["rb"])
              and int(moved_k) == 0,
              f"{label}: identity tick not bitwise unchanged")
    kk = min(k, C)
    check_select(torch, s_k, t["finite"], kk, label, errs,
                 rd._select_plan(S, C, kk).kernel)
    if C > rd.SELECT_CAP:       # the cap, one past it, and k = C on a row
        check_select(torch, s_k, t["finite"], rd.SELECT_CAP,
                     label + " k = cap", errs)
        check_select(torch, s_k, t["finite"], rd.SELECT_CAP + 1,
                     label + " k = cap + 1", errs, "select_sort")
        check_select(torch, s_k[:1], t["finite"][:1], C, label + " k = C",
                     errs, "select_sort")
        # the yardstick the timings compare with, past the old cap of 64
        kr = rd.SELECT_CAP + 1
        ti_r, tv_r = rd._launch_select_rounds(s_k, t["finite"], kr)
        ti_p, tv_p = rd.select_heads_plain(s_k, t["finite"], kr)
        check(torch.equal(ti_r, ti_p) and torch.equal(tv_r, tv_p),
              f"{label}: select_rounds differs from the stable sort")
        errs["select_rounds"] = max(errs["select_rounds"],
                                    max_err(torch, tv_r, tv_p))
    out, rb, moved, ti, _ = rd.fused_reprice_heads(*args, t["finite"], k=kk)
    ti_k, _ = rd.select_heads_plain(s_k, t["finite"], kk)
    check(torch.equal(out, s_k) and torch.equal(rb, rb_k)
          and torch.equal(ti, ti_k), f"{label}: fused wrapper differs")
    torch.cuda.synchronize()
    errs["rowmin"] = max(errs["rowmin"], max_err(torch, rb_k, rb_p))
    errs["rowmin_row"] = max(errs["rowmin_row"], max_err(torch, rb_r, rb_p))
    errs["fold"] = max(errs["fold"], max_err(torch, s_k, s_p))
    errs["fold_col"] = max(errs["fold_col"], max_err(torch, s_col, s_p))
    log(f"[parity] {label}: J={J} C={C} S={S} moved={int(moved_k)} "
        f"fold max|err|={max_err(torch, s_k, s_p):.3g} ok")


def parity_case(torch, np, rng, label, J, C, S, frac, k, errs, **kw):
    t = make_universe(torch, np, rng, J, C, S, frac,
                      dev=torch.device("cuda"), **kw)
    check_kernels(torch, t, label, k, errs, identity=kw.get("identity",
                                                             False))
    return t


def rowmin_case(torch, np, rng, J, C, dev):
    """Hours, mask, old and new prices and the settled row minima at (J,
    C); from J = 3 a fully masked row (0), a row whose one profiled cell
    is the last column (1: the last chunk) and a row of zero hours (2)."""
    from repro_torch.kernels import rank_delta as rd
    hours = rng.uniform(0.5, 4.0, (J, C)).astype(np.float32)
    mask = rng.random((J, C)) > 0.2
    if J >= 3:
        mask[0] = False
        mask[1] = False
        mask[1, C - 1] = True
        hours[2] = 0.0
    oldp = rng.uniform(0.1, 2.0, (1, C)).astype(np.float32)
    newp = (oldp * rng.uniform(0.5, 1.5, (1, C))).astype(np.float32)
    h, m, po, pn = (torch.from_numpy(a).to(dev)
                    for a in (hours, mask, oldp, newp))
    rb, _ = rd.rowmin_plain(h, m, po, torch.zeros((J, 1), device=dev))
    return h, m, po, pn, rb


def check_rowmin_edges(torch, np, rng, errs) -> None:
    """``rowmin`` at :data:`ROWMIN_EDGES` against the plain version and the
    yardstick ``rowmin_row``, minima and moved bit for bit: twice in a
    row, and an identity tick (moved 0); then 100 launches in a row on the
    same scratch at the fleet's 64 x 10,000, over three price vectors,
    each held against the plain version (the arrival counters reset)."""
    from repro_torch.kernels import rank_delta as rd
    dev = torch.device("cuda")
    for J, C in ROWMIN_EDGES:
        h, m, po, pn, rb = rowmin_case(torch, np, rng, J, C, dev)
        want = rd.rowmin_plain(h, m, pn, rb)
        runs = [rd._launch_rowmin(h, m, pn, rb),
                rd._launch_rowmin(h, m, pn, rb),
                rd._launch_rowmin(h, m, pn, rb, variant="rowmin_row")]
        ident = rd._launch_rowmin(h, m, po, rb)
        for rb_k, mv_k in runs:
            check(bitwise(torch, rb_k, want[0])
                  and int(mv_k) == int(want[1]),
                  f"rowmin {J} x {C}: differs from the plain version")
            errs["rowmin"] = max(errs["rowmin"],
                                 max_err(torch, rb_k, want[0]))
        check(bitwise(torch, ident[0], rb) and int(ident[1]) == 0,
              f"rowmin {J} x {C}: identity tick moved")
    h, m, po, pn, rb = rowmin_case(torch, np, rng, 64, 10_000, dev)
    prices = [pn, po, (pn * 0.75).contiguous()]
    got = [rd._launch_rowmin(h, m, prices[i % 3], rb) for i in range(100)]
    wants = [rd.rowmin_plain(h, m, p, rb) for p in prices]
    bad = [i for i, (rb_k, mv_k) in enumerate(got)
           if not (bitwise(torch, rb_k, wants[i % 3][0])
                   and int(mv_k) == int(wants[i % 3][1]))]
    check(not bad, f"rowmin: launches {bad[:5]} of 100 on one scratch "
          f"differ from the plain version")
    log(f"[parity] rowmin: {len(ROWMIN_EDGES)} edge shapes (C = 1 to "
        f"10,001, J = 1 and 64), twice, identity, rowmin_row, and 100 "
        f"launches in a row: bitwise ok")


def make_pairs(np, rng, C, n):
    """n distinct (int32 column, float32 price) pairs over C columns."""
    return (rng.choice(C, n, replace=False).astype(np.int32),
            rng.uniform(0.5, 20.0, n).astype(np.float32))


def check_scatter(torch, np, rng, errs) -> None:
    """``scatter`` against its plain version (the pairs uploaded,
    ``index_copy`` and ``index_fill_``), new prices and flags bit for
    bit: C = 1, 3, 10,000 and 100,000; n = 0, 1, 1% and every column; two
    scatters back to back."""
    from repro_torch.kernels import rank_delta as rd
    dev = torch.device("cuda")
    cases = 0
    for C in (1, 3, 10_000, 100_000):
        prices = torch.from_numpy(rng.uniform(0.5, 20.0, (1, C)).astype(
            np.float32)).to(dev)
        for n in sorted({0, 1, max(1, C // 100), C}):
            pairs = [make_pairs(np, rng, C, n) for _ in range(2)]
            got = [rd.scatter_prices(*p, prices) for p in pairs]
            for p, out in zip(pairs, got):
                want = rd.scatter_prices_plain(*p, prices)
                check(all(bitwise(torch, a, b) for a, b in zip(out, want)),
                      f"scatter C={C} n={n}: differs from the plain "
                      f"version")
                errs["scatter"] = max(errs["scatter"],
                                      max_err(torch, out[0], want[0]))
            cases += 1
    log(f"[parity] scatter: {cases} cases (C = 1 to 100,000, n = 0 to C, "
        f"twice back to back): bitwise ok")


def time_scatter(torch, np, rng, C, frac=0.01):
    """``scatter`` at C columns and a tick of ``frac`` of them, back to back,
    beside its plain version (the PyTorch scatter it replaced on the card:
    upload, ``index_copy``, ``zeros_like``, ``index_fill_``).  It reads its
    pairs from host memory, so it refuses a CUDA graph and has no graph
    time."""
    from repro_torch.kernels import rank_delta as rd
    n = max(1, int(round(frac * C)))
    prices = torch.from_numpy(rng.uniform(0.5, 20.0, (1, C)).astype(
        np.float32)).to(torch.device("cuda"))
    cols, new = make_pairs(np, rng, C, n)

    def kernel():
        return rd._launch_scatter(cols, new, prices)

    def plain():
        return rd.scatter_prices_plain(cols, new, prices)

    r = dict(ms=time_ms(torch, kernel), plain_ms=time_ms(torch, plain),
             library_ms=None, bound=bound_ms(12 * C + 8 * n, n))
    log_time("scatter", r, f"C={C}, n={n}")
    return r


def phase_parity(torch, np, seed):
    rng = np.random.default_rng(seed)
    errs = {name: 0.0 for name in KERNELS}
    check_scatter(torch, np, rng, errs)
    check_rowmin_edges(torch, np, rng, errs)
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


def head_bound(R, C, k):
    """The k-head's bound: each score and flag read once, each head entry
    written once; one compare a cell."""
    return bound_ms(R * C * 5 + R * k * 8, R * C)


def time_head(torch, scores, finite, k, rounds=True):
    """The k-head ``k`` takes on ``(scores, finite)``, timed back to back
    and replayed from a CUDA graph, beside the plain stable sort,
    ``torch.topk`` (both ways) and, where ``rounds``, the k-round kernel
    it replaced (``earlier_ms``)."""
    from repro_torch.kernels import rank_delta as rd
    R, C = scores.shape
    inf = torch.tensor(float("inf"), device=scores.device)
    masked = torch.where(finite, scores, inf)
    r = dict(
        kernel=rd._select_plan(R, C, k).kernel,
        ms=time_ms(torch, lambda: rd._launch_select(scores, finite, k)),
        device_ms=graph_ms(torch, lambda: rd._launch_select(scores, finite,
                                                            k)),
        plain_ms=time_ms(torch, lambda: rd.select_heads_plain(
            scores, finite, k), iters=20),
        library_ms=time_ms(torch, lambda: torch.topk(
            masked, k, dim=1, largest=False)),
        library_device_ms=graph_ms(torch, lambda: torch.topk(
            masked, k, dim=1, largest=False)),
        bound=head_bound(R, C, k))
    if rounds:
        r["earlier_ms"] = time_ms(torch, lambda: rd._launch_select_rounds(
            scores, finite, k), iters=10, warmup=2)
    return r


def log_time(name, r, shape) -> None:
    """One ``[time]`` line; "graph" is the same call replayed from a CUDA
    graph (the card's time without the host's)."""
    def ms(key):
        return f"{r[key]:.4f}" if r.get(key) is not None else "null"

    kernel = ms("ms") + (f" (graph {ms('device_ms')})"
                         if "device_ms" in r else "")
    earlier = f", earlier kernel {ms('earlier_ms')}" + (
        f" (graph {ms('earlier_device_ms')})"
        if "earlier_device_ms" in r else "") + " ms" \
        if "earlier_ms" in r else ""
    lib = ms("library_ms") + (f" (graph {ms('library_device_ms')})"
                              if "library_device_ms" in r else "")
    log(f"[time] {name}: kernel {kernel} ms{earlier}, plain "
        f"{ms('plain_ms')} ms, library {lib} ms, bound "
        f"{r['bound'][0]:.5f} ms ({r['bound'][1]}) at {shape}")


def time_kernels(torch, t, k=10, heads=None):
    """Each kernel, its plain version, the kernel it replaced and the
    library call on the tick ``t``.  The k-heads run on ``heads``
    (``(scores, finite)``) when given — the one member row the service's
    ``top_k`` serves — else on every member row of ``t`` (the fused heads
    tick): ``select`` at ``k`` and the k-round kernel at 65, one past its
    old cap (``select_sort`` is timed by :func:`time_heads`)."""
    from repro_torch.kernels import rank_delta as rd
    J, C = t["hours"].shape
    S = t["rm"].shape[0]
    sel_scores, sel_finite = heads if heads else (t["scores"], t["finite"])
    R = sel_scores.shape[0]
    rb_new, _ = rd.rowmin_plain(t["hours"], t["mask"], t["newp"], t["rb"])
    fold_args = (t["hours"], t["mask"], t["oldp"], t["newp"], t["changed"],
                 t["rb"], rb_new, t["rm"], t["scores"])
    inf = torch.tensor(float("inf"), device=sel_scores.device)
    masked = torch.where(sel_finite, sel_scores, inf)
    kr = min(65, C)

    def fold(variant):
        return lambda: rd._launch_fold(*fold_args, variant=variant)

    def rowmin(variant="rowmin"):
        return lambda: rd._launch_rowmin(t["hours"], t["mask"], t["newp"],
                                         t["rb"], variant=variant)

    res = {
        "rowmin": dict(
            ms=time_ms(torch, rowmin()),
            earlier_ms=time_ms(torch, rowmin("rowmin_row")),
            device_ms=graph_ms(torch, rowmin()),
            earlier_device_ms=graph_ms(torch, rowmin("rowmin_row")),
            plain_ms=time_ms(torch, lambda: rd.rowmin_plain(
                t["hours"], t["mask"], t["newp"], t["rb"])),
            library_ms=None),
        "fold": dict(
            ms=time_ms(torch, fold("fold")),
            earlier_ms=time_ms(torch, fold("fold_col")),
            device_ms=graph_ms(torch, fold("fold")),
            earlier_device_ms=graph_ms(torch, fold("fold_col")),
            plain_ms=time_ms(torch, lambda: rd.fold_plain(*fold_args)),
            library_ms=None),
        "select": time_head(torch, sel_scores, sel_finite, k),
        # the k-round kernel where it served: k one past its old cap of 64
        "select_rounds": dict(
            ms=time_ms(torch, lambda: rd._launch_select_rounds(
                sel_scores, sel_finite, kr), iters=20),
            plain_ms=time_ms(torch, lambda: rd.select_heads_plain(
                sel_scores, sel_finite, kr), iters=20),
            library_ms=time_ms(torch, lambda: torch.topk(
                masked, kr, dim=1, largest=False))),
    }
    res["rowmin_row"] = dict(ms=res["rowmin"]["earlier_ms"],
                             device_ms=res["rowmin"]["earlier_device_ms"],
                             plain_ms=res["rowmin"]["plain_ms"],
                             library_ms=None)
    res["fold_col"] = dict(ms=res["fold"]["earlier_ms"],
                           device_ms=res["fold"]["earlier_device_ms"],
                           plain_ms=res["fold"]["plain_ms"], library_ms=None)
    mask = t["mask"]
    nnz = float(mask.sum())
    member_cells = float((t["rm"] @ mask.float().sum(dim=1,
                                                     keepdim=True)).sum())
    res["rowmin"]["bound"] = res["rowmin_row"]["bound"] = bound_ms(
        J * C * 5 + C * 4 + J * 8 + 4, 2 * nnz)
    res["fold"]["bound"] = res["fold_col"]["bound"] = bound_ms(
        J * C * 5 + 3 * C * 4 + 2 * J * 4 + S * J * 4 + 2 * S * C * 4,
        5 * nnz + 4 * member_cells)
    res["select_rounds"]["bound"] = head_bound(R, C, kr)
    tick = f"J={J} C={C} S={S}"
    for name in ("rowmin", "rowmin_row", "fold", "fold_col"):
        log_time(name, res[name], tick)
    for name, kk in (("select", k), ("select_rounds", kr)):
        log_time(name, res[name], f"{R} x {C}, k={kk}")
    return res


def time_heads(torch, row, big):
    """The k-head at every (rows, columns, k) of :data:`HEAD_SHAPES`: the
    service's member row (1 x 10,000) and the 64 x 100,000 fleet's rows;
    the k-round kernel beside it on one row up to :data:`ROUNDS_MAX_K`."""
    rows = {1: row, 16: big}
    out = {}
    for R, C, k in HEAD_SHAPES:
        scores, finite = rows[R]
        check(tuple(scores.shape) == (R, C), f"k-head rows {scores.shape} "
              f"are not {R} x {C}")
        r = time_head(torch, scores, finite, k,
                      rounds=R == 1 and k <= ROUNDS_MAX_K)
        log_time(f"k-head ({r['kernel']})", r, f"{R} x {C}, k={k}")
        out[(R, C, k)] = r
    return out


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


def dense_densify(np, state, deltas):
    """The host step of the tick the pair path replaced: ids resolved and
    prices checked with a Python step per delta, then the whole (1, C)
    price vector and a dense changed vector built on the host."""
    table = dict(deltas)
    cols = np.asarray([state._pos[c] for c in table], dtype=np.int32)
    prices = np.asarray(list(table.values()), dtype=np.float64)
    check(bool((np.isfinite(prices) & (prices > 0)).all()),
          "dense tick: a price is not positive and finite")
    newp = state._host_prices.copy()
    newp[0, cols] = prices.astype(np.float32)
    changed = np.zeros_like(newp)
    changed[0, cols] = 1.0
    return newp, changed


def pairs_host_step(state, deltas) -> None:
    """The host step of the pair path: the deltas validated into pairs,
    and the checks ``scatter_prices`` makes of them before its launch."""
    from repro_torch.kernels import rank_delta as rd
    rd._check_pairs(*state._pairs(deltas), len(state.config_ids))


def dense_tick(torch, np, state, deltas) -> int:
    """One tick of ``state`` through the dense path (the yardstick): the
    densify, both (1, C) vectors uploaded from pageable memory, the two
    kernels and the handoff count read back."""
    from repro_torch.kernels import rank_delta as rd
    newp, changed = dense_densify(np, state, deltas)
    d_newp = torch.tensor(newp, device=state.device)
    state.d_scores, state.d_row_best, moved = rd.fused_reprice(
        state.d_hours, state.d_mask, state.d_prices, d_newp,
        torch.tensor(changed, device=state.device), state.d_row_best,
        state.d_row_masks, state.d_scores)
    state.d_prices, state._host_prices = d_newp, newp
    return int(moved.item())


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
    # the pair path against the dense path it replaced, on the same deltas
    # from the same state: scores, row minima, prices and moved bit for bit
    before = (state.d_scores, state.d_row_best, state.d_prices,
              state._host_prices.copy())
    d = next_deltas()[0]
    m_pairs = state.reprice(d)
    pairs = (state.d_scores, state.d_row_best, state.d_prices)
    (state.d_scores, state.d_row_best, state.d_prices,
     state._host_prices) = before
    m_dense = dense_tick(torch, np, state, d)
    check(m_pairs == m_dense and all(
        bitwise(torch, a, b) for a, b in zip(pairs, (
            state.d_scores, state.d_row_best, state.d_prices))),
        f"{label}: the pair tick differs from the dense tick")
    # the tick's time, after warm-up, through each path in turns (dense,
    # pairs, pairs, dense; 25 ticks a turn): the host step + the upload and
    # scatter + the two kernels + the handoff count read back
    batches = [next_deltas()[0] for _ in range(120)]
    for d in batches[:10]:
        state.reprice(d)
        dense_tick(torch, np, state, d)
    ticks_by = {"pairs": state.reprice,
                "dense": lambda d: dense_tick(torch, np, state, d)}
    host_ms, dev_ms = {"pairs": 0.0, "dense": 0.0}, {"pairs": 0.0,
                                                      "dense": 0.0}
    for turn, path in enumerate(("dense", "pairs", "pairs", "dense")):
        part = batches[10 + 25 * turn:35 + 25 * turn]
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for d in part:
            ticks_by[path](d)
        stop.record()
        torch.cuda.synchronize()
        host_ms[path] += (time.perf_counter() - t0) * 1e3 / 50
        dev_ms[path] += start.elapsed_time(stop) / 50
    tick_bytes = (J * C * 5 + C * 4 + J * 8) + (
        J * C * 5 + 3 * C * 4 + 2 * J * 4 + S * J * 4 + 2 * S * C * 4)
    log(f"[fleet] {label}: {ticks} ticks, one dispatch each; per tick "
        f"{dev_ms['pairs']:.4f} ms (CUDA events) / {host_ms['pairs']:.4f} "
        f"ms (host), bound {tick_bytes / HBM_BYTES_PER_S * 1e3:.5f} ms "
        f"({tick_bytes} bytes at 3.35 TB/s) on {card}")
    # where the tick's time goes: the host step alone (validation and
    # checks; for the dense path the densify), and the two kernels alone
    # on the fleet's own tensors, replayed from a CUDA graph (the card's
    # time); the rest is the upload and scatter, the launches' host work
    # and the handoff count read back
    host_step = {"pairs": lambda d: pairs_host_step(state, d),
                 "dense": lambda d: dense_densify(np, state, d)}
    step_ms = {"pairs": 0.0, "dense": 0.0}
    for path in ("dense", "pairs", "pairs", "dense"):
        t0 = time.perf_counter()
        for d in batches[10:60]:
            host_step[path](d)
        step_ms[path] += (time.perf_counter() - t0) * 1e3 / 100
    kernels_ms = graph_ms(torch, lambda: rd.fused_reprice(
        state.d_hours, state.d_mask, state.d_prices, state.d_prices, zeros,
        state.d_row_best, state.d_row_masks, state.d_scores))
    for path in ("pairs", "dense"):
        log(f"[fleet] {label}: {path} path, per tick {host_ms[path]:.4f} ms "
            f"(host; {dev_ms[path]:.4f} by CUDA events): densify "
            f"{step_ms[path]:.4f} ms (host), rowmin+fold {kernels_ms:.4f} "
            f"ms (card, CUDA graph), rest "
            f"{host_ms[path] - step_ms[path] - kernels_ms:.4f} ms; the "
            f"kernels' card time is {kernels_ms / host_ms[path]:.1%} of the "
            f"tick")


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


# --- phase 10 (first half): the profiled daemon; phase 4's kernels -----------

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


def fleet_tick(torch, np, rng, fleet):
    """A tick of 1% of the prices (one at least) on a fleet's own tensors
    (S = its slot capacity): what :func:`check_kernels` takes."""
    C = len(fleet.config_ids)
    newp = fleet._host_prices.copy()
    cols = rng.choice(C, max(1, C // 100), replace=False)
    newp[0, cols] = (newp[0, cols] * rng.uniform(0.7, 1.3, cols.size)
                     ).astype(np.float32)
    changed = np.zeros_like(newp)
    changed[0, cols] = 1.0
    return dict(hours=fleet.d_hours, mask=fleet.d_mask, oldp=fleet.d_prices,
                newp=torch.from_numpy(newp).to(fleet.device),
                changed=torch.from_numpy(changed).to(fleet.device),
                rb=fleet.d_row_best, rm=fleet.d_row_masks,
                scores=fleet.d_scores, finite=fleet._d_finite)


def phase_main_path_kernels(torch, np, seed, fleet, errs, k=10):
    """The kernels at the shapes the main path gave them: the service
    fleet's own tensors with a 1% tick, and, for ``select``, one member's
    score row as the service's ``top_k`` serves it.  Held against the
    plain versions, then timed."""
    t = fleet_tick(torch, np, np.random.default_rng(seed + 2), fleet)
    check_kernels(torch, t, "main path 1%", k, errs)
    slot = min(fleet._slots.values())
    row = (fleet.d_scores[slot:slot + 1], fleet._d_finite[slot:slot + 1])
    check_select(torch, *row, k, "main path top_k row", errs)
    return time_kernels(torch, t, k, heads=row), row


# --- phase 5: the serving front-end --------------------------------------------

#: the modelled client reply per served decision, as the reference's
#: serving benchmark models it (``benchmarks/serve_bench.py``)
REPLY_S = 0.001
#: the reference benchmark's own claims for 4 workers over the daemon
FRONTEND_CLAIMS = {"speedup": 3.0, "efficiency": 0.7}


def _frontend_leg(torch, rd, make_service, store, market, subs, warm,
                  workers, label):
    """One threaded front-end run over the recorded market: warm, then
    the launch counts set to 0, the submissions served, the counts read.
    Returns ``(submissions/s, service, front-end, counts)``."""
    from repro_torch.market import (JournalReplayer, RecordedPriceFeed,
                                    ServeFrontend)
    svc = make_service()
    fe = ServeFrontend(svc, RecordedPriceFeed.loads(market),
                       workers=workers, queue_capacity=len(subs) + 1,
                       on_decision=lambda d: time.sleep(REPLY_S))
    fe.warm(warm)
    warm_snaps = fe.stats().snapshots
    torch.cuda.synchronize()
    rd.reset_launches()
    with fe:                        # shutdown raises any thread's death
        t0 = time.perf_counter()
        for sub in subs:
            fe.submit(sub)
        fe.drain(timeout=120.0)
        secs = time.perf_counter() - t0
        fe.await_ticks(timeout=120.0)
    counts = dict(rd.LAUNCHES)
    stats = fe.stats()
    published = stats.snapshots - warm_snaps
    check(stats.shed == 0 and stats.accounted
          and stats.decisions == len(subs),
          f"{label}: {stats} for {len(subs)} submissions")
    audit = JournalReplayer(store, fe.journal_dump()).audit()
    check(audit.ok, f"{label}: journal audit failed: "
          f"{audit.mismatches[:3]}")
    check(audit.decisions == stats.decisions, f"{label}: audit saw "
          f"{audit.decisions} of {stats.decisions} decisions")
    ticks = svc.reprice_dispatches
    check(counts["scatter"] == counts["rowmin"] == counts["fold"] == ticks
          > 0, f"{label}: {counts} for {ticks} fleet ticks")
    check(0 < counts["select"] <= published + stats.forwarded,
          f"{label}: {counts['select']} select launches for {published} "
          f"snapshots and {stats.forwarded} forwards")
    for name in ("rowmin_row", "fold_col", "select_rounds", "select_sort"):
        check(counts[name] == 0, f"{label}: {name} launched "
              f"{counts[name]} times")
    tput = len(subs) / secs
    log(f"[frontend] {label}: {len(subs)} submissions in {secs:.3f} s = "
        f"{tput:.1f} submissions/s; {stats.ticks} ticks, {ticks} fleet "
        f"ticks, {published} snapshots, {stats.forwarded} forwards; "
        f"launches scatter {counts['scatter']} rowmin {counts['rowmin']} "
        f"fold {counts['fold']} select {counts['select']} (routes "
        f"{len(fe.snapshot.entries)}); audit ok ({audit.decisions} "
        f"decisions, {len(audit.drift)} within-contract drift records)")
    return tput, svc, fe, counts


def snapshot_turns(svc, fe, turns=50):
    """The snapshot build's heads, two ways in turns on one fleet at one
    price epoch: every route through ``rank_heads`` (one ``select``
    launch) and route by route through ``rank_head`` (one launch each).
    The head cache is emptied before each build, so each one launches.
    Returns mean ms of each."""
    routes = list(fe.snapshot.entries)
    k = fe.top_k
    one = [[], []]
    for _ in range(turns):
        got = []
        for i, build in enumerate((
                lambda: svc.rank_heads(routes, k=k),
                lambda: [svc.rank_head(*r, k=k) for r in routes])):
            svc._head_cache.clear()
            t0 = time.perf_counter()
            got.append(build())
            one[i].append(time.perf_counter() - t0)
        check(got[0] == got[1],
              "snapshot turns: rank_heads differs from per-route rank_head")
    return tuple(sum(v) / len(v) * 1e3 for v in one), len(routes)


def phase_frontend(torch, np, seed, service, store, card, errs,
                   n_subs=1_000, n_ticks=100, device="cuda"):
    """Phase 4's store and catalog behind ``ServeFrontend`` at 1 and 4
    workers and behind the daemon, on one recorded market (100 ticks, 1%
    of prices a tick) and one list of submissions, each decision followed
    by a 1 ms modelled client reply.  Then ``select`` at the snapshot
    build's shape (the fleet's member rows), against its plain version
    and timed."""
    from repro_torch.kernels import rank_delta as rd
    from repro_torch.market import (JournalReplayer, RecordedPriceFeed,
                                    SelectionDaemon, SimulatedSpotFeed,
                                    Tick, record_feed, synthetic_stream)
    from repro_torch.selector import PriceTable, SelectionService
    base = dict(service.price_snapshot()[1])
    market = record_feed(SimulatedSpotFeed(base, seed=seed + 4,
                                           change_fraction=0.01), n_ticks)
    subs = list(synthetic_stream(store.job_ids, n_subs, seed=seed + 4,
                                 tick_fraction=0.0))
    warm = list(dict.fromkeys(subs))

    def make_service():
        return SelectionService(service.catalog, store, PriceTable(base),
                                backend="torch_fused", device=device,
                                serve_top_k=10)

    # what a modelled reply takes on this host
    naps = []
    for _ in range(200):
        t0 = time.perf_counter()
        time.sleep(REPLY_S)
        naps.append(time.perf_counter() - t0)
    reply_ms = sum(naps) / len(naps) * 1e3
    # the daemon: one thread ticks, serves and replies, a tick every
    # n_subs / n_ticks submissions
    svc = make_service()
    daemon = SelectionDaemon(svc, RecordedPriceFeed.loads(market))
    every = max(1, n_subs // n_ticks)
    ticked = 0
    t0 = time.perf_counter()
    for i, sub in enumerate(subs):
        if ticked < n_ticks and i % every == 0:
            daemon.handle(Tick())
            ticked += 1
        if daemon.handle(sub) is not None:
            time.sleep(REPLY_S)
    while ticked < n_ticks:
        daemon.handle(Tick())
        ticked += 1
    secs = time.perf_counter() - t0
    audit = JournalReplayer(store, daemon.journal_dump()).audit()
    check(audit.ok and audit.decisions == n_subs,
          f"frontend phase daemon: audit {audit.ok}, "
          f"{audit.decisions} decisions")
    daemon_tput = n_subs / secs
    h = svc.metrics.snapshot()["histograms"]
    log(f"[frontend] daemon: {n_subs} submissions in {secs:.3f} s = "
        f"{daemon_tput:.1f} submissions/s ({n_ticks} ticks, a "
        f"{REPLY_S * 1e3:g} ms reply sleeps {reply_ms:.4f} ms here); audit "
        f"ok; spans (count x mean ms): " + ", ".join(
            f"{name} {v['count']} x {v['sum'] * 1e3 / v['count']:.4f}"
            for name, v in h.items()
            if v["count"] and name in ("serve.submit", "tick.total",
                                       "rank.build")))
    tput1, _, _, _ = _frontend_leg(torch, rd, make_service, store, market,
                                   subs, warm, 1, "1 worker")
    tput4, svc4, fe4, counts = _frontend_leg(
        torch, rd, make_service, store, market, subs, warm, 4, "4 workers")
    speedup, eff = tput4 / daemon_tput, tput4 / (4 * tput1)
    log(f"[frontend] 4 workers: {speedup:.2f}x the daemon (the reference "
        f"benchmark claims >= {FRONTEND_CLAIMS['speedup']:g}x), scaling "
        f"efficiency 1 -> 4 workers {eff:.2f} (claims >= "
        f"{FRONTEND_CLAIMS['efficiency']:g}); recorded, not gated: both "
        f"are host-bound ({card})")
    h = svc4.metrics.snapshot()["histograms"]
    build = h["snapshot.build"]
    log(f"[frontend] 4 workers spans (count x mean ms): " + ", ".join(
        f"{name} {v['count']} x {v['sum'] * 1e3 / v['count']:.4f}"
        for name, v in h.items()
        if v["count"] and name in ("snapshot.build", "tick.total",
                                   "tick.poll", "tick.reprice",
                                   "reprice.dispatch", "serve.worker")))
    (batched_ms, per_route_ms), n_routes = snapshot_turns(svc4, fe4)
    log(f"[frontend] snapshot.build {build['count']} x "
        f"{build['sum'] * 1e3 / build['count']:.4f} ms in the run; heads "
        f"of {n_routes} routes in turns on one fleet: rank_heads (one "
        f"select) {batched_ms:.4f} ms, per-route rank_head ({n_routes} "
        f"selects) {per_route_ms:.4f} ms ({card})")
    # select at the snapshot build's shape: the member rows' span
    fleet = svc4._batched
    slots = sorted(fleet._slots.values())
    lo, hi = slots[0], slots[-1] + 1
    rows = (fleet.d_scores[lo:hi], fleet._d_finite[lo:hi])
    check_select(torch, *rows, fe4.top_k, "snapshot build rows", errs)
    head = time_head(torch, *rows, fe4.top_k)
    shape = f"{hi - lo} x {rows[0].shape[1]}, k={fe4.top_k}"
    log_time("select (snapshot build)", head, shape)
    return {"daemon": daemon_tput, "w1": tput1, "w4": tput4,
            "launches": counts, "head": head, "shape": (hi - lo,
                                                        rows[0].shape[1])}


# --- phase 6: Flora's core and the turbulence sweep ----------------------------

#: the reference turbulence benchmark's recorded calm-point figure
CALM_MAX_DEVIATION = 0.0645
FIXTURE = ROOT / "examples" / "data" / "gcp_spot_prices.csv"


#: how far a ``torch_fused`` point's deviations may sit from numpy's: the
#: CPU tests' bound (``tests/test_torch_turbulence.py``)
SWEEP_REL, SWEEP_ABS = 1e-4, 1e-12


def phase_turbulence(torch, np, rd, seed, errs, device="cuda",
                     n_events=400, stream_seed=3, market_seed=11):
    """The turbulence benchmark's universe (the paper's trace at seed 0,
    18 jobs x 10 configs), every preset on numpy and on ``torch_fused``,
    the B1 kernels and ``select`` held against their plain versions on
    each ``torch_fused`` fleet of the sweep, and the quickstart's outcome
    through the port's core."""
    from repro_torch.core import Flora, JobClass, costmodel, evaluate, \
        spark_sim
    from repro_torch.core.evaluate import turbulence_curves
    from repro_torch.market import (PollingPriceFeed, RecordedPriceFeed,
                                    make_market, record_feed, run_point,
                                    run_sweep, synthetic_stream)
    from repro_torch.selector import (GcpVmCatalog, PriceTable,
                                      ProfilingStore, SelectionService)
    trace = spark_sim.generate_trace(seed=0)
    price = costmodel.LinearPriceModel()
    store = ProfilingStore.from_trace(trace)
    catalog = GcpVmCatalog(trace.configs, price)
    base = dict(PriceTable.from_catalog(catalog).items())
    events = list(synthetic_stream([j.name for j in trace.jobs], n_events,
                                   seed=stream_seed, tick_fraction=0.15))
    services = []

    def factory(backend):
        svc = SelectionService(catalog, store,
                               PriceTable.from_catalog(catalog),
                               backend=backend, device=device)
        services.append(svc)
        return svc

    regen = record_feed(make_market("calm", base, seed=market_seed,
                                    ticks=40).raw, 40)
    check(regen == FIXTURE.read_text(),
          "calm preset does not regenerate gcp_spot_prices.csv")
    log(f"[turbulence] calm preset regenerates {FIXTURE.name} byte for "
        f"byte ({len(regen)} bytes)")
    for backend in ("numpy", "torch_fused"):
        point = run_point(factory(backend), RecordedPriceFeed.load(FIXTURE),
                          events, preset_name="calm",
                          truth=RecordedPriceFeed.load(FIXTURE))
        check(point.audit_ok, f"calm fixture on {backend}: audit failed")
        check(point.mean_deviation <= CALM_MAX_DEVIATION,
              f"calm fixture on {backend}: mean deviation "
              f"{point.mean_deviation} > {CALM_MAX_DEVIATION}")
        log(f"[turbulence] calm fixture on {backend}: mean deviation "
            f"{point.mean_deviation!r} (<= {CALM_MAX_DEVIATION}), "
            f"{point.decisions} decisions, {point.epochs} epochs, audit ok")
    del services[:]
    rd.reset_launches()
    t0 = time.perf_counter()
    points = run_sweep(factory, base, events,
                       backends=("numpy", "torch_fused"), seed=market_seed)
    secs = time.perf_counter() - t0
    counts = dict(rd.LAUNCHES)
    fused = [s for s in services if s.backend == "torch_fused"]
    ticks = sum(s.reprice_dispatches for s in fused)
    for p in points:
        check(p.audit_ok, f"turbulence {p.preset} on {p.backend}: audit "
              f"failed ({p.audit_mismatches} mismatches)")
    check(counts["scatter"] == counts["rowmin"] == counts["fold"] == ticks
          > 0, f"turbulence: {counts} for {ticks} fleet ticks")
    for name in ("rowmin_row", "fold_col", "select_rounds"):
        check(counts[name] == 0, f"turbulence: {name} launched")
    for backend, curve in turbulence_curves(points).items():
        log(f"[turbulence] curve {backend}: " + ", ".join(
            f"{p.preset} {p.mean_deviation!r} (truth "
            f"{p.truth_mean_deviation!r})" for p in curve))
    by = {(p.preset, p.backend): p for p in points}
    worst = 0.0
    for name in {n for n, _ in by}:
        for attr in ("mean_deviation", "truth_mean_deviation"):
            got = getattr(by[name, "torch_fused"], attr)
            want = getattr(by[name, "numpy"], attr)
            check(abs(got - want) <= max(SWEEP_REL * abs(want), SWEEP_ABS),
                  f"turbulence {name}: torch_fused {attr} {got!r} vs numpy "
                  f"{want!r} beyond rel {SWEEP_REL}")
            worst = max(worst, abs(got - want) / max(abs(want), 1e-300))
    # the kernels at the sweep's own shape, on each fleet it ticked
    rng = np.random.default_rng(seed + 6)
    fleets = [s._batched for s in fused if s._batched is not None]
    check(fleets, "turbulence: no torch_fused fleet was built")
    for i, fleet in enumerate(fleets):
        J, C = fleet.d_hours.shape
        check_kernels(torch, fleet_tick(torch, np, rng, fleet),
                      f"turbulence {J}x{C} fleet {i}", 10, errs)
    log(f"[turbulence] {len(points)} points in {secs:.3f} s, every audit "
        f"ok; torch_fused vs numpy mean deviation: worst relative "
        f"difference {worst:.3g} (<= {SWEEP_REL}); {len(fleets)} fleets' "
        f"kernels against their plain versions ok; B1 on the card: scatter "
        f"{counts['scatter']}, rowmin {counts['rowmin']}, fold "
        f"{counts['fold']} launches for {ticks} fleet ticks (1 each a "
        f"tick) over {sum(s.price_epoch for s in fused)} price epochs; "
        f"select {counts['select']}")
    # one quote stream, two transports, on the card's backend
    market = make_market("eviction_storm", base, seed=market_seed,
                         ticks=sum(1 for e in events
                                   if type(e).__name__ == "Tick"))
    text = record_feed(market.raw, market.ticks)
    recorded = run_point(factory("torch_fused"),
                         RecordedPriceFeed.loads(text), events,
                         preset_name="eviction_storm",
                         truth=RecordedPriceFeed.loads(text))
    replay = RecordedPriceFeed.loads(text)
    polled = run_point(factory("torch_fused"), PollingPriceFeed(
        lambda t: {"quotes": [{"config_id": d.config_id, "price": d.price}
                              for d in replay.poll(t)]}), events,
        preset_name="eviction_storm", feed_kind="polled",
        truth=RecordedPriceFeed.loads(text))
    check(recorded.evaluation.summary() == polled.evaluation.summary()
          and recorded.decisions == polled.decisions
          and recorded.epochs == polled.epochs
          and recorded.audit_ok and polled.audit_ok,
          "torch_fused: the polled feed's evaluation differs from the "
          "recorded feed's")
    log(f"[turbulence] torch_fused polled == recorded: mean deviation "
        f"{polled.mean_deviation!r}, {polled.decisions} decisions")
    # the quickstart through the port's core
    flora = Flora(trace, price)
    picks = {k: flora.select(k).index for k in (JobClass.A, JobClass.B)}
    check(picks == {JobClass.A: 9, JobClass.B: 1},
          f"quickstart picks {picks}, expected A -> #9, B -> #1")
    rows = {r.name: r for r in evaluate.table4(trace, price)}
    check(all(rows["Flora"].mean_norm_cost < r.mean_norm_cost
              for n, r in rows.items() if n != "Flora"),
          "Table IV: Flora is not the best row")
    log(f"[core] quickstart through the port: class A -> #"
        f"{picks[JobClass.A]}, class B -> #{picks[JobClass.B]}; Table IV "
        f"Flora mean normalized cost {rows['Flora'].mean_norm_cost!r} "
        f"(best of {len(rows)} rows)")
    return counts


# --- phase 7: the LM kernels against their plain versions ---------------------

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
    # D = 80: stablelm-3b's prefill (MHA), GQA, ragged T = 100, a window
    # over T = 1,000, T = 1 and T = 129 (one past a 128-row tile)
    (4, 1024, 32, 32, 80, True, None),
    (2, 256, 8, 2, 80, True, None),
    (1, 100, 4, 4, 80, True, None),
    (1, 1000, 4, 2, 80, True, 300),
    (2, 1, 4, 4, 80, True, None),
    (1, 129, 4, 2, 80, False, None),
]
#: (B, T, H, N): a decode step, ragged T, both model head sizes, and one
#: step past the split kernel's 16-step chunk
WKV_CASES = [(2, 1, 3, 64), (4, 1, 40, 64), (1, 37, 2, 64), (2, 100, 2, 16),
             (1, 64, 4, 32), (2, 17, 3, 64)]
#: (B, T, H, N) with RWKV-6's own decay range, w = exp(-exp(x)) for x
#: uniform in [-8, 2] (w from about 6e-4 to just below 1)
WKV_STRONG_CASES = [(2, 17, 3, 64), (1, 1025, 2, 64), (2, 50, 2, 16)]
#: the end-to-end bound on kernel vs plain prefill logits in bf16 (relative
#: L2; the reason is at its check in ``phase_serve``)
REL_L2_TOL = 0.1
#: the reference kernel tests' tolerances
ATTN_TOL = {"float32": (2e-5, 1e-2), "bfloat16": (2e-2, 1e-2)}
WKV_TOL = (1e-4, 1e-3)
#: the record's LM entries: ``flash_attention`` is the tensor-core kernel
#: at qwen3-1.7b's D = 128, ``flash_attention_d80`` the same kernel at
#: stablelm-3b's D = 80, ``flash_attention_scalar`` the scalar kernel
#: (fp32) at qwen3-1.7b's shape
_ATTN = dict(op="flash_attention",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:28")
LM_KERNELS = {
    "flash_attention": _ATTN,
    "flash_attention_d80": _ATTN,
    "flash_attention_scalar": _ATTN,
    "wkv6": dict(op="wkv6", source="src/repro_torch/csrc/wkv6_scan.cu",
                 replaces="src/repro/kernels/rwkv6_scan.py:25"),
}
#: (model, record entry of the kernel its path runs), in serving order
SERVED = [("qwen3-1.7b", "flash_attention"),
          ("stablelm-3b", "flash_attention_d80"),
          ("rwkv6-3b", "wkv6")]


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
               dev="cuda", strong=False):
    gen = torch.Generator(device=dev).manual_seed(seed)
    r, k, v = (torch.randn((B, T, H, N), generator=gen, device=dev
                           ).to(dtype) for _ in range(3))
    if strong:      # RWKV-6's decay: w = exp(-exp(x)), x in [-8, 2]
        x = torch.rand((B, T, H, N), generator=gen, device=dev) * 10 - 8
        w = torch.exp(-torch.exp(x))
    else:
        w = torch.sigmoid(torch.randn((B, T, H, N), generator=gen,
                                      device=dev)) * 0.5 + 0.45
    u = torch.randn((H, N), generator=gen, device=dev) * 0.5
    s0 = torch.randn((B, H, N, N), generator=gen, device=dev) \
        * float(random_state)
    return r, k, v, w, u, s0


def check_attention(torch, q, k, v, causal, window, label, errs=None,
                    name=None):
    """The kernel :func:`flash_attention.variant` names against the plain
    version; the error goes to ``errs`` under the record entry ``name``
    (default: the variant's entry at qwen3-1.7b's shape)."""
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
        name = name or ("flash_attention" if kind == "tc"
                        else "flash_attention_scalar")
        errs[name] = max(errs[name], err)
    return err


def check_wkv(torch, args, label, errs=None):
    """The split kernel (one launch) against the plain version; returns
    the larger max |err| of y and s_T."""
    from repro_torch.kernels import rwkv6_scan as wk
    before = dict(wk.LAUNCHES)
    y, sT = wk.wkv6(*args)
    check({n: wk.LAUNCHES[n] - before[n] for n in before}
          == {"wkv6": 1, "wkv6_seq": 0},
          f"{label}: wkv6 did not launch the split kernel once")
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
        for case in WKV_STRONG_CASES:
            args = wkv_inputs(torch, *case, dtype, sum(case), dev=dev,
                              strong=True)
            err = check_wkv(torch, args, f"wkv strong decay {case} {name}")
            log(f"[lm-parity] wkv6 {name} strong decays (w from "
                f"{float(args[3].min()):.2g} to {float(args[3].max()):.6f}) "
                f"B,T,H,N={case}: max |err| {err:.3g} ok")
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


# --- phase 8: decode-fleet placement ------------------------------------------

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


# --- phase 9: LM serving at full width; phase 10's model profiles -------------

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
                  "flash_attention_scalar": 0, "wkv6": 0, "wkv6_seq": 0}
    else:
        # every model call launches the split kernel, never the
        # sequential one
        expect = {"flash_attention": 0, "flash_attention_tc": 0,
                  "flash_attention_scalar": 0,
                  "wkv6": L * (eng.prefills + eng.decode_steps),
                  "wkv6_seq": 0}
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
    # themselves are held to the reference tolerances in phase 7 and at
    # the path's shapes in ``time_lm_kernel``; this check covers the
    # path's own activations.
    check(rel < REL_L2_TOL, f"{name}: kernel vs plain prefill logits "
          f"relative error {rel:.3g} >= {REL_L2_TOL}")
    log(f"[serve] {name}: first-wave prefill logits, kernel vs plain "
        f"{kernel}: relative L2 error {rel:.3g} (< {REL_L2_TOL}, bf16 over "
        f"{L} layers), max |err| {float((a - b).abs().max()):.3g} of max "
        f"|logit| {float(b.abs().max()):.3g}, argmax agreement "
        f"{agree:.0%}; all finite")

    waves = None
    if kernel == "flash_attention":
        waves = prefill_turns(torch, model, first, slots,
                              prompt_len + max_new, dev)
        log(f"[serve] {name}: first-wave prefill ({slots} x {prompt_len} "
            f"tokens) in turns: tensor-core kernel {waves['tc'] * 1e3:.3f} "
            f"ms = {slots * prompt_len / waves['tc']:.1f} tokens/s, scalar "
            f"kernel (the one it replaced) {waves['scalar'] * 1e3:.3f} ms = "
            f"{slots * prompt_len / waves['scalar']:.1f} tokens/s")
    shapes = dict(B=slots, T=prompt_len, d=cfg.d_model, H=cfg.num_heads,
                  G=cfg.num_kv_heads, D=cfg.head_dim,
                  N=cfg.rwkv_head_dim, dtype=cfg.compute_dtype)
    del model, eng, logits, logits_p, first
    free_card(torch, dev)
    return dict(kernel=kernel, launches=launches, shapes=shapes,
                waves=waves, layers=L)


def prefill_turns(torch, model, batch, slots, max_len, dev="cuda"):
    """Seconds of one prefill of ``batch`` with the path's attention
    kernel (``"tc"``) and with the scalar kernel on the same bf16 inputs
    (``"scalar"``), each the mean of two runs taken in turns (tc, scalar,
    scalar, tc) on the host clock around work that ends in a
    synchronize: what the tensor-core kernel changes end to end."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    def scalar(q, k, v, *, causal=True, window=None):
        return fa._launch(q, k, v, causal, window, "scalar")
    path = ops.flash_attention
    secs = {"tc": [], "scalar": []}
    try:
        for which in ("tc", "scalar", "scalar", "tc"):
            ops.flash_attention = path if which == "tc" else scalar
            with torch.inference_mode():
                state = model.init_state(slots, max_len)
                sync(torch, dev)
                t0 = time.perf_counter()
                model.prefill(batch, state)
                sync(torch, dev)
                secs[which].append(time.perf_counter() - t0)
            del state
    finally:
        ops.flash_attention = path
    return {w: sum(v) / len(v) for w, v in secs.items()}


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


def time_lm_kernel(torch, kernel, shapes, errs, seed, dev="cuda",
                   name=None, scalar_entry=False):
    """The kernel at the shapes its path gave it: held against its plain
    version, then timed beside the plain version, the library call (SDPA
    for attention, none for WKV6) and its bound; ``name`` is its record
    entry (default ``kernel``).  For attention, also the scalar kernel on
    the same bf16 inputs (the kernel this path ran before the tensor-core
    one: ``earlier_ms``) and, with ``scalar_entry``, as its own entry
    under ``"scalar"``, on fp32 inputs of the same shape, its dtype."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rwkv6_scan as wk
    name = name or kernel
    sh = shapes
    B, T, dt = sh["B"], sh["T"], sh["dtype"]
    if kernel == "flash_attention":
        H, G, D = sh["H"], sh["G"], sh["D"]
        q, k, v = attn_inputs(torch, B, T, H, G, D, dt, seed, dev)
        err = check_attention(torch, q, k, v, True, None,
                              f"path shape {(B, T, H, G, D)}", errs, name)
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
        what = f"B={B} T={T} H={H} G={G} D={D} causal bf16"
    if kernel == "flash_attention" and scalar_entry:
        q32, k32, v32 = (x.float() for x in (q, k, v))
        err = check_attention(torch, q32, k32, v32, True, None,
                              f"path shape {(B, T, H, G, D)} fp32", errs)
        log(f"[lm-parity] flash attention float32 (scalar) at the path "
            f"shape: max |err| {err:.3g} ok")
        # the scalar kernel's fp32 FMAs: the fp32 peak off the tensor cores
        r["scalar"] = timed(q32, k32, v32, "scalar", FP32_FLOPS_PER_S)
        del q32, k32, v32
        sc = r["scalar"]
        log(f"[time] flash_attention_scalar: kernel {sc['ms']:.4f} ms, "
            f"plain {sc['plain_ms']:.4f} ms, library "
            f"{sc['library_ms']:.4f} ms, bound {sc['bound'][0]:.5f} ms "
            f"({sc['bound'][1]}) at B={B} T={T} H={H} G={G} D={D} causal "
            f"fp32")
    if kernel == "wkv6":
        H, N = sh["d"] // sh["N"], sh["N"]
        args = wkv_inputs(torch, B, T, H, N, dt, seed, random_state=False,
                          dev=dev)
        check_wkv(torch, args, f"path shape {(B, T, H, N)}", errs)
        dec = wkv_inputs(torch, B, 1, H, N, dt, seed + 1, dev=dev)
        check_wkv(torch, dec, f"decode shape {(B, 1, H, N)}", errs)
        # the sequential kernel (the one this path ran before), held
        # against the plain version on the same inputs before it is timed
        for label, inputs in (("path", args), ("decode", dec)):
            got = wk._launch(*inputs, variant="seq")
            sync(torch, dev)
            check(all(allclose(torch, a, b, *WKV_TOL)
                      for a, b in zip(got, wk.wkv6_scan_ref(*inputs))),
                  f"wkv6: the sequential kernel at the {label} shape "
                  f"differs from the plain version")
        del got

        def split(inputs):
            return lambda: wk.wkv6(*inputs)

        def seq(inputs):
            return lambda: wk._launch(*inputs, variant="seq")
        r = dict(
            ms=time_ms(torch, split(args), iters=20, warmup=3),
            earlier_ms=time_ms(torch, seq(args), iters=10, warmup=2),
            plain_ms=time_ms(torch, lambda: wk.wkv6_scan_ref(*args),
                             iters=3, warmup=1),
            library_ms=None,
            decode_ms=time_ms(torch, split(dec), iters=200),
            decode_graph_ms=graph_ms(torch, split(dec)),
            decode_earlier_ms=time_ms(torch, seq(dec), iters=200),
            decode_earlier_graph_ms=graph_ms(torch, seq(dec)))

        def wkv_bound(steps):
            n_bytes = (3 * 2 + 4 + 4) * B * steps * H * N + 4 * H * N \
                + 2 * 4 * B * H * N * N
            return bound_ms(n_bytes, 5 * N * N * B * H * steps)
        r["bound"] = wkv_bound(T)
        r["decode_bound"] = wkv_bound(1)
        what = f"B={B} T={T} H={H} N={N} bf16 r/k/v"
        del args, dec
    lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
    earlier = f", {'sequential' if kernel == 'wkv6' else 'scalar'} kernel " \
        f"{r['earlier_ms']:.4f} ms" if "earlier_ms" in r else ""
    log(f"[time] {name}: kernel {r['ms']:.4f} ms{earlier}, plain "
        f"{r['plain_ms']:.4f} ms, library {lib} ms, bound "
        f"{r['bound'][0]:.5f} ms ({r['bound'][1]}) at {what}")
    if "decode_ms" in r:
        log(f"[time] {kernel}: decode step (T=1) kernel "
            f"{r['decode_ms']:.4f} ms back to back, "
            f"{r['decode_graph_ms']:.5f} ms from a CUDA graph; sequential "
            f"kernel {r['decode_earlier_ms']:.4f} ms back to back, "
            f"{r['decode_earlier_graph_ms']:.5f} ms from a CUDA graph; "
            f"bound {r['decode_bound'][0]:.6f} ms ({r['decode_bound'][1]})")
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
    # the fleet heads tick's k-head: every member row of 64 x 100k x 16;
    # the fold at 16 members on both fleet shapes
    heads_times = time_kernels(torch, big_shape)
    fleet_times = time_kernels(torch, main_shape)
    scatter_rng = np.random.default_rng(args.seed + 3)
    scatter_times = {C: time_scatter(torch, np, scatter_rng, C)
                     for C in (10_000, 100_000)}
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
    for name in set(KERNELS) - set(PATH_KERNELS):
        check(launches[name] == 0, f"kernel {name} was launched "
              f"{launches[name]} times on the main path")
    check(launches["scatter"] == launches["rowmin"] == launches["fold"]
          == service.reprice_dispatches, f"main path: {launches} for "
          f"{service.reprice_dispatches} fleet ticks")
    times, row = phase_main_path_kernels(torch, np, args.seed,
                                         service._batched, errs)
    head_times = time_heads(torch, row, (big_shape["scores"],
                                         big_shape["finite"]))
    # select_sort's record: its first k, on the service's member row;
    # scatter's: the service's C and a 1% tick
    times["select_sort"] = head_times[(1, 10_000, rd.SELECT_CAP + 1)]
    times["scatter"] = scatter_times[10_000]
    done("main-path kernels")
    frontend = phase_frontend(torch, np, args.seed, service, store, card,
                              errs)
    done("frontend")
    turbulence = phase_turbulence(torch, np, rd, args.seed, errs)
    done("turbulence")
    phase_lm_parity(torch)
    done("lm-parity")
    placement = phase_placement()
    done("placement")
    from repro_torch import configs
    lm_errs = {name: 0.0 for name in LM_KERNELS}
    lm_runs = {}
    for arch, name in SERVED:
        cfg = configs.get(arch)
        op = LM_KERNELS[name]["op"]
        run = phase_serve(torch, np, cfg, args.seed, card, placement)
        check(run["kernel"] == op, f"{cfg.name} ran {run['kernel']}")
        phase_parity_4_layers(torch, cfg, args.seed)
        r = time_lm_kernel(torch, op, run["shapes"], lm_errs, args.seed,
                           name=name, scalar_entry=name == "flash_attention")
        run["times"] = r
        if run["waves"] is not None:
            # the kernel's share of a prefill wave, with each kernel
            w = run["waves"]
            r.update(wave_ms=w["tc"] * 1e3, wave_earlier_ms=w["scalar"] * 1e3)
            log(f"[serve] {cfg.name}: attention {run['layers']} x "
                f"{r['ms']:.4f} ms = {run['layers'] * r['ms'] / r['wave_ms']:.1%} "
                f"of a {r['wave_ms']:.3f} ms prefill wave (scalar kernel: "
                f"{run['layers']} x {r['earlier_ms']:.4f} ms = "
                f"{run['layers'] * r['earlier_ms'] / r['wave_earlier_ms']:.1%}"
                f" of {r['wave_earlier_ms']:.3f} ms)")
        lm_runs[name] = run
        done(f"serve {cfg.name}")
    # the profiled phases come last: a profiler session may slow the
    # host's launches for the rest of the process (phase_lm_profile reads
    # whether it did), and the serving phases time those launches
    phase_busy(torch, args.seed, service, store, table)
    done("busy")
    del service, store, table
    for arch, _ in SERVED:
        phase_lm_profile(torch, np, configs.get(arch), args.seed)
    done("profile")

    def entry(name, source, replaces, n_launches, err, r):
        e = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": n_launches,
             "max_abs_err": err, "ms": r["ms"],
             "earlier_ms": r.get("earlier_ms"), "plain_ms": r["plain_ms"],
             "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
             "library_ms": r["library_ms"]}
        for key in ("device_ms", "earlier_device_ms", "library_device_ms",
                    "kernel"):
            if key in r:
                e[key] = r[key]
        if "wave_ms" in r:
            e.update(wave_ms=r["wave_ms"], wave_earlier_ms=r["wave_earlier_ms"])
        return e

    kernels = []
    for name in KERNELS:
        kernels.append(entry(f"rank_delta_{name}", SOURCE, REPLACES[name],
                             launches[name], errs[name], times[name]))
        if name in ALSO_REPLACES:
            kernels[-1]["also_replaces"] = ALSO_REPLACES[name]
        # the 4-worker front-end's run and the turbulence sweep's
        if name in ("scatter", "rowmin", "fold", "select"):
            kernels[-1]["frontend_launches"] = \
                frontend["launches"][name]
            kernels[-1]["turbulence_launches"] = turbulence[name]
    # the same select kernel at the fleet heads tick's shape (B2)
    kernels.append(entry("rank_delta_select_heads_64x100000x16", SOURCE,
                         ALSO_REPLACES["select"], launches["select"],
                         errs["select"], heads_times["select"]))
    kernels[-1]["fleet_launches"] = fleet_heads_launches
    # the same select at the front-end snapshot build's member rows (B2's
    # serving path): one launch a published snapshot
    R, C = frontend["shape"]
    kernels.append(entry(f"rank_delta_select_snapshot_{R}x{C}", SOURCE,
                         ALSO_REPLACES["select"],
                         frontend["launches"]["select"], errs["select"],
                         frontend["head"]))
    kernels[-1]["frontend_launches"] = frontend["launches"]["select"]
    kernels.append(entry("rank_delta_scatter_100000", SOURCE,
                         REPLACES["scatter"], launches["scatter"],
                         errs["scatter"], scatter_times[100_000]))
    # rowmin and the fold at 16 members on the two fleet shapes
    # (rowmin_row and fold_col: earlier_ms)
    for shape, r in (("64x10000", fleet_times["rowmin"]),
                     ("64x100000", heads_times["rowmin"])):
        kernels.append(entry(f"rank_delta_rowmin_{shape}", SOURCE,
                             REPLACES["rowmin"], launches["rowmin"],
                             errs["rowmin"], r))
    for shape, r in (("64x10000x16", fleet_times["fold"]),
                     ("64x100000x16", heads_times["fold"])):
        kernels.append(entry(f"rank_delta_fold_{shape}", SOURCE,
                             REPLACES["fold"], launches["fold"],
                             errs["fold"], r))
    # the k-head at each timed (rows, columns, k), by the kernel k takes
    for (R, C, k), r in head_times.items():
        kernels.append(entry(f"rank_delta_khead_{R}x{C}_k{k}", SOURCE,
                             REPLACES[r["kernel"]], launches[r["kernel"]],
                             errs[r["kernel"]], r))
    qwen, rwkv = lm_runs["flash_attention"], lm_runs["wkv6"]
    stablelm = lm_runs["flash_attention_d80"]
    runs = {"flash_attention": (qwen["launches"]["flash_attention_tc"],
                                qwen["times"]),
            "flash_attention_d80": (
                stablelm["launches"]["flash_attention_tc"],
                stablelm["times"]),
            "flash_attention_scalar": (
                qwen["launches"]["flash_attention_scalar"],
                qwen["times"]["scalar"]),
            "wkv6": (rwkv["launches"]["wkv6"], rwkv["times"])}
    for name, spec in LM_KERNELS.items():
        n_launches, r = runs[name]
        kernels.append(entry(name, spec["source"], spec["replaces"],
                             n_launches, lm_errs[name], r))
        if "decode_ms" in r:
            kernels[-1].update(
                decode_ms=r["decode_ms"],
                decode_graph_ms=r["decode_graph_ms"],
                decode_earlier_ms=r["decode_earlier_ms"],
                decode_earlier_graph_ms=r["decode_earlier_graph_ms"],
                decode_bound_ms=r["decode_bound"][0])
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
