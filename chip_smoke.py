#!/usr/bin/env python3
"""Run the port's live-market selection path, its LM serving path and its
LM training path on one CUDA card and check them.

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
3b. the sharded fleet (``torch_sharded``) with every shard on the one
   card: a 1% tick at 64 x 100,000 x 16 and at 64 x 100,003 split by
   columns 2, 3 and 4 ways (``row_minima`` a block, the min across
   blocks, ``fold_scores`` a block), bitwise against one
   ``fused_reprice``; :class:`TorchShardedRankState` at 1, 2 and 4 shards
   beside a :class:`TorchFusedRankState` for 10 ticks of 1% at 64 x
   100,000 x 16 — the same handoff counts, scores within the contract,
   the 10-heads naming the fused fleet's configs, one ``scatter``,
   ``rowmin`` and ``fold`` a shard a tick and one ``select`` a shard a
   ``heads`` call, every member within the contract of ``rank_dense``'s
   float64 scores on two ticks, the 1,000-head ``ranking()[:1000]`` —
   the tick timed in turns with the fused fleet's (host clock) with the
   combine's share (where the machine has several cards, a fleet with one
   shard a card joins every check and the turns); then phase 4's
   service and daemon on ``torch_sharded`` at 2 shards (1,000 events,
   audit-clean) read through the launch counters, and the kernels held
   against their plain versions on a shard of its fleet;
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
   row, the k-round kernel; and the kernels' device guard: its host cost
   around a no-op beside ``torch.cuda.device``'s, and ``select`` on the
   member row in turns with the guard and without it;
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
   mean deviation stays <= 0.0645 on numpy, on ``torch_fused`` and on
   ``torch_sharded`` at 2 shards (there equal to numpy's), every preset's
   point on the three backends audits clean (``scatter``, ``rowmin`` and
   ``fold`` once a fleet tick, once a shard on ``torch_sharded``, at
   C = 10), a stubbed
   ``PollingPriceFeed`` evaluates as the recorded feed on ``torch_fused``,
   and the quickstart's picks through the port's Flora (class A -> #9,
   class B -> #1, Flora the best row of Table IV);
7. hold both flash-attention kernels and the WKV6 kernel against their
   plain versions: the tensor-core kernel (bf16) and the scalar one
   (fp32); causal, windowed and bidirectional; GQA and MQA; ragged T;
   head sizes 16 to 256, with D = 80 (a 64-column block and a 16-column
   tail) also at stablelm-3b's prefill shape, GQA, T = 1, 100, 129 and a
   windowed T = 1,000, and D = 256 (its own block shape) at
   recurrentgemma-9b's prefill shape (MQA), its 4,096-token prompt past
   the 2,048 window, GQA, T = 1, 100, 129 and a windowed T = 1,000, and
   bidirectional calls with Tq != Tk at seamless-m4t-large-v2's encoder
   (4 x 4,096 over 4,096), cross prefill (1,024 over 4,096) and cross
   decode (1 over 4,096) shapes, a ragged source (7 over 1,000), Tk < Tq
   (100 over 37), one token at D = 256 and 129 over 300 at D = 80, and
   D = 160 (the 64-row block, two 64-column blocks and a 32-column tail)
   at pixtral-12b's prefill shape (4 x 2,048, 32 over 8), GQA, T = 1,
   65, 100, a windowed T = 1,000 and 129 over 300 bidirectional; for
   WKV6 a decode step,
   ragged T, one step past the split kernel's chunk, RWKV-6's strong
   decays (w = exp(-exp(x)), x in [-8, 2]) and a two-call state carry;
8. plan the decode fleet's mesh through the port's selection service from
   a hand-made dry-run report;
9. serve ``qwen3-1.7b``, ``stablelm-3b``, ``rwkv6-3b``, ``deepseek-7b``,
   ``granite-20b``, ``qwen3-moe-30b-a3b``, ``recurrentgemma-9b``,
   ``seamless-m4t-large-v2`` and ``pixtral-12b`` at full width and depth
   (random bf16 weights, and for seamless random bf16 source frames, for
   pixtral random bf16 patch embeddings, from the seed; each model freed
   before the next is drawn): 8 requests of 1,024-token prompts over 4
   slots, 32 new tokens each, seamless's each with 4,096 source frames,
   pixtral's each after 1,024 patches — the LM path, read through the
   kernels' launch counters (28, 32, 30, 52, 48, 12 and 40
   flash-attention launches per prefill, one an attention layer, every
   one the tensor-core kernel, also counted by (Tq, Tk, causal): pixtral's
   causal over 2,048 positions;
   for seamless 72 a prefill, 24 bidirectional over the frames, 24
   causal and 24 cross, and 24 a decode step, cross decode, counted by
   (Tq, Tk, causal) too; 32 WKV6 launches per prefill and per decode
   step) — after a warm-up at the traffic's shapes, and once more for
   the spread.  Then: all logits finite; the first wave's prefill
   logits against a pass whose kernel is swapped for its plain version
   (for the MoE model also the share of (token, k) routes the two passes
   agree on, layer by layer); for attention, the first wave's prefill
   timed in turns with the tensor-core kernel and with the scalar one it
   replaced; prefill + decode against ``forward`` at full width, 4
   layers, fp32 (the scalar attention kernel; MoE at capacity factor
   64; recurrentgemma-9b's rec, rec, attn, rec with a 2,100-token
   prompt and 8 steps past its window; seamless at 2 encoder and 2
   decoder layers, 100 source frames, a 6-token prompt and 8 steps;
   pixtral with 100 patches ahead of a 6-token prompt, decoding at 100 +
   t); for recurrentgemma-9b a 1 x
   4,096-token prefill past its window and 8 decode steps, through the
   kernel and the plain version (``[window]``); and the kernels at the shapes the path gave them, against their
   plain versions and timed beside their bounds, the kernel they
   replaced (the scalar attention kernel, bf16; the sequential WKV6
   kernel) and, for attention, ``scaled_dot_product_attention``; for
   WKV6 also the decode step back to back and from a CUDA graph.  Then
   ``llama4-maverick-400b-a17b`` at full width over 2 layers (one dense,
   one MoE; the whole model does not fit one card): a 2 x 1,024-token
   prefill through the kernel and the plain version (relative L2 < 0.1,
   finite, one tensor-core launch a layer, the routes' agreement), 4
   decode steps, finite, and the kernel at its prefill shape;
9b. train (before the profiled phases): the attention backward kernel
   (``flash_attention_bwd.cu``) against ``attention_bwd_ref`` at every
   head size in bf16 and fp32 (``BWD_CASES``: causal, a window,
   bidirectional with Tq != Tk and fully masked rows, GQA R = 1, 2, 4,
   48, ragged T, Tq = 1; each of dq, dk, dv within relative L2 1e-5 in
   fp32 and 1e-2 in bf16), with a planted fault (the last 64 keys'
   contribution dropped) that the check must refuse; held the same way
   at the path's shapes (seamless-m4t-large-v2's three in bf16 and fp32,
   qwen3-1.7b's in fp32, and in bf16 where it is timed beside its plain
   version, SDPA's backward and its bound); qwen3-1.7b at full width and depth for 10 steps of
   4 x 1,024 tokens through ``make_train_step`` and ``train_loop``
   (AdamW, the reference's ``TrainConfig`` defaults, remat, vocab chunks
   of 16,384; batches from the port's ``TokenStream``): finite losses,
   the last below the first, 56 forward and 28 backward launches every
   step (none in the serving phases), step time, tokens/s, TFLOP/s, peak
   memory and the backward's share of a step; a checkpoint after step 5
   restored into a new model and optimizer, whose steps 6 and 7 equal
   the uninterrupted run within relative 1e-5; one step's gradients with
   the kernels against plain attention, bf16 over all 28 layers within
   relative L2 0.1 over the whole gradient and 0.05 on each leaf, and
   with the planted fault in the last layer, which the leaf limit must
   refuse; fp32 over 4 layers within 1e-3 and 1e-4; seamless-m4t-large-v2
   at 2 + 2 layers, full width, one bf16 step over 2 x 4,096 frames and
   2 x 512 tokens (the backward bidirectional, causal and in cross mode,
   counted by shape), its gradients held the same way; and rwkv6-3b's
   loss with gradients on the card raising ``NotPortedError`` (WKV6 has
   no backward yet);
10. last, the profiled phases: a second 1,000-event daemon on phase 4's
    service under ``torch.profiler`` (the card's busy share), then each
    served model's first-wave prefill and 8 decode steps (device time by
    kernel, busy share), and for recurrentgemma-9b the RG-LRU scan's and
    its fp32 gate products' share of a prefill wave; then one qwen3-1.7b
    training step (device time by kernel and by group: the backward
    kernel, the forward attention kernel, matrix products, the rest) and
    its AdamW update alone.

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
``frontend_launches`` (phase 5's 4-worker front-end run),
``turbulence_launches`` (phase 6's sweep, its ``torch_sharded`` fleets'
shards included) and ``sharded_launches`` (phase 3b's 2-shard service).
``rank_delta_scatter`` is the price scatter at the service's C = 10,000
(``rank_delta_scatter_100000`` at 100,000), a 1% tick;
``rank_delta_rowmin_64x*`` and ``rank_delta_fold_64x*`` are
``rowmin`` and the fold at 16 members on the two fleet shapes;
``rank_delta_khead_<rows>x<columns>_k<k>`` the k-head at each timed
shape, with the ``kernel`` that k takes.
``wkv6`` adds the decode step's times (``decode_ms`` back to back,
``decode_graph_ms`` from a CUDA graph, ``decode_earlier_ms`` and
``decode_earlier_graph_ms`` the sequential kernel) and its bound.
``flash_attention`` (qwen3-1.7b, D = 128), ``flash_attention_d80``
(stablelm-3b, D = 80), ``flash_attention_mha128`` (deepseek-7b),
``flash_attention_mqa`` (granite-20b), ``flash_attention_d64``
(qwen3-moe-30b-a3b), ``flash_attention_d256`` (recurrentgemma-9b) and
``flash_attention_d160`` (pixtral-12b, D = 160, 2,048 positions a
sequence) add ``wave_ms`` and ``wave_earlier_ms``: the first wave's
prefill with the tensor-core kernel and with the scalar one.
``flash_attention_scalar``, ``flash_attention_scalar_d256`` and
``flash_attention_scalar_d160`` are the scalar kernel in fp32 at
qwen3-1.7b's, recurrentgemma-9b's and pixtral-12b's shapes.
``flash_attention_enc``, ``flash_attention_dec``, ``flash_attention_cross``
and ``flash_attention_xdec`` are the tensor-core kernel at
seamless-m4t-large-v2's encoder (bidirectional, 4 x 4,096 over 4,096),
decoder self-attention (causal, 4 x 1,024), cross prefill (1,024 over
4,096) and cross decode (1 over 4,096) shapes, each with its own
launches on the path (``library_ms`` SDPA with ``is_causal`` as the
call's); ``flash_attention_enc`` adds the first wave's ``wave_ms``.
``flash_attention_llama4`` is the kernel at the llama4 check's shape,
its launches that check's one prefill.  ``flash_attention_bwd`` is the
attention backward at qwen3-1.7b's training shape (bf16, 4 x 1,024, 16
heads over 8, D = 128, causal), its launches the 10-step run's, its
``library_ms`` SDPA's backward alone; it adds the run's median
``step_ms`` and the kernel's ``step_share``.
Without a CUDA device the script exits non-zero before printing any
result.  It
imports ``torch``, ``numpy``, the standard library and the port
(``src/repro_torch``), nothing else.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
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
SOURCES = ("rank_delta", "flash_attention", "flash_attention_bwd",
           "wkv6_scan")
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


def fleet_universe(np, seed, J, C, S):
    """A fleet's universe from the seed: ``(rng, hours, mask, prices, ids,
    members)`` with S members ("all" and S - 1 random row subsets)."""
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
    return rng, hours, mask, prices, ids, members


def phase_fleet(torch, np, seed, J, C, S, ticks, check_every, label,
                card="", device="cuda"):
    from repro_torch.kernels import rank_delta as rd
    from repro_torch.selector import (TorchFusedRankState, rank_dense,
                                      score_contract)
    rng, hours, mask, prices, ids, members = fleet_universe(np, seed, J, C,
                                                            S)
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


# --- phase 3b: the sharded fleet -----------------------------------------------

#: the state-level check's shard counts, every shard on the one card
SHARD_COUNTS = (1, 2, 4)
#: the kernels a sharded tick launches, once a shard
TICK_KERNELS = ("scatter", "rowmin", "fold")


def split_tick(torch, rd, t, D):
    """``t``'s tick split by columns into D blocks as the sharded fleet
    runs it: ``row_minima`` on each block, the elementwise min of the
    blocks' minima, ``fold_scores`` on each block against it.  Returns
    ``(scores, row minima, moved)``."""
    C = t["hours"].shape[1]
    width = -(-C // D)
    blocks = [slice(lo, min(lo + width, C)) for lo in range(0, C, width)]

    def part(name, b):
        return t[name][:, b].contiguous()

    partial = [rd.row_minima(part("hours", b), part("mask", b),
                             part("newp", b), t["rb"])[0] for b in blocks]
    rb = partial[0]
    for p in partial[1:]:
        rb = torch.minimum(rb, p)
    out = torch.cat([rd.fold_scores(
        part("hours", b), part("mask", b), part("oldp", b), part("newp", b),
        part("changed", b), t["rb"], rb, t["rm"], part("scores", b))
        for b in blocks], dim=1)
    return out, rb, int((rb != t["rb"]).sum())


def check_against_cold(np, fleet, key, cold, contract, label) -> None:
    """A member against ``rank_dense``'s float64 scores (``cold``, ``inf``
    where unprofiled), vectorized: every score within the contract, the
    winner the cold winner or tied with it, and the 10-head the
    (score, catalog position) order of the member's own scores, which is
    ``ranking()[:10]``."""
    got = np.where(fleet.counts(key) > 0, fleet.scores(key), np.inf)
    with np.errstate(invalid="ignore"):
        tol = contract.abs_tol + contract.rel_tol * np.maximum(
            np.abs(got), np.abs(cold))
        ok = (got == cold) | (np.abs(got - cold) <= tol)
    check(bool(ok.all()), f"{label}: member {key}: {int((~ok).sum())} "
          f"scores outside the contract of rank_dense")
    head = fleet.top_k(key, 10)
    order = np.lexsort((np.arange(got.size), got))[:10]
    check([r.config_id for r in head] == [fleet.config_ids[i]
                                          for i in order]
          and [r.score for r in head] == [float(got[i]) for i in order],
          f"{label}: member {key}: head is not ranking()[:10]")
    win = fleet._pos[head[0].config_id]
    check(contract.scores_match(cold[win], cold.min()),
          f"{label}: member {key}: winner {head[0]} is not the cold winner "
          f"or tied with it")


def same_heads(contract, got, want) -> bool:
    """Two lists of heads name the same configs in the same order, each
    score within the contract of the other's (a member's first
    accumulators, a matmul at the shard's width, may round apart)."""
    return all([r.config_id for r in a] == [r.config_id for r in b]
               and all(contract.scores_match(x.score, y.score)
                       for x, y in zip(a, b))
               for a, b in zip(got, want)) and len(got) == len(want)


def shard_scores(torch, fleet, device):
    """A sharded fleet's (S, C) member scores on ``device``, its shards'
    blocks side by side."""
    return torch.cat([sh.scores.to(device) for sh in fleet._shards], dim=1)


def shard_tick(torch, np, rng, fleet, shard=0):
    """A 1% tick on one shard's own tensors: what :func:`check_kernels`
    takes, at the shapes the sharded path gives the kernels."""
    sh = fleet._shards[shard]
    C = sh.width
    newp = fleet._host_prices[:, sh.lo:sh.hi].copy()
    cols = rng.choice(C, max(1, C // 100), replace=False)
    newp[0, cols] = (newp[0, cols] * rng.uniform(0.7, 1.3, cols.size)
                     ).astype(np.float32)
    changed = np.zeros_like(newp)
    changed[0, cols] = 1.0
    return dict(hours=sh.hours, mask=sh.mask, oldp=sh.prices,
                newp=torch.from_numpy(newp).to(sh.device),
                changed=torch.from_numpy(changed).to(sh.device),
                rb=sh.row_best, rm=sh.row_masks, scores=sh.scores,
                finite=sh.finite)


def sync_cards(torch) -> None:
    """Wait for every local card (a sharded tick reads back the moved count
    on its first shard's card alone)."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def phase_sharded(torch, np, rd, seed, card, J=64, C=100_000, S=16,
                  ticks=10, turn_ticks=20, device="cuda:0"):
    """The sharded fleet: the split tick bitwise against the whole one;
    ``TorchShardedRankState`` at 1, 2 and 4 shards on one card (and, where
    there are several cards, one shard a card) against the fused fleet and
    the float64 cold rank, tick by tick; the tick timed in turns with the
    fused fleet's, and the combine's share of it."""
    from repro_torch.selector import (TorchFusedRankState,
                                      TorchShardedRankState, score_contract)
    from repro_torch.selector.rank import _scores_numpy
    contract = score_contract("torch_sharded")
    dev = torch.device(device)
    # the split tick against the whole tick on the same inputs, bit for bit
    rng = np.random.default_rng(seed + 7)
    for width in (C, C + 3):
        t = make_universe(torch, np, rng, J, width, S, 0.01, dev=dev,
                          masked_rows=(5,))
        whole, rb, moved = rd.fused_reprice(
            t["hours"], t["mask"], t["oldp"], t["newp"], t["changed"],
            t["rb"], t["rm"], t["scores"])
        for D in (2, 3, 4):
            out, rb_s, moved_s = split_tick(torch, rd, t, D)
            check(bitwise(torch, out, whole) and bitwise(torch, rb_s, rb)
                  and moved_s == int(moved), f"sharded: the tick split {D} "
                  f"ways at {J}x{width}x{S} differs from the whole tick")
        log(f"[sharded] the tick split 2, 3 and 4 ways by columns at "
            f"{J}x{width}x{S}: scores, row minima and moved ({int(moved)}) "
            f"bitwise the whole tick's")
        del t, whole
    # the state at 1, 2 and 4 shards on the card (one shard a card where
    # there are several) against the fused fleet, tick by tick
    layouts = {f"D={D}": [dev] * D for D in SHARD_COUNTS}
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n_cards > 1:
        layouts[f"{n_cards} cards"] = [torch.device("cuda", i)
                                       for i in range(n_cards)]
    rng, hours, mask, prices, ids, members = fleet_universe(np, seed + 8, J,
                                                            C, S)
    fused = TorchFusedRankState(hours, mask, prices, ids, capacity=S,
                                device=dev)
    fleets = {name: TorchShardedRankState(hours, mask, prices, ids,
                                          capacity=S, devices=devices)
              for name, devices in layouts.items()}
    for fleet in (fused, *fleets.values()):
        for key, rows in members.items():
            fleet.add_state(key, rows=rows)
    keys = list(members)

    def not_bitwise(fleet):
        """Cells of the fleet's scores that are not the fused fleet's."""
        scores = shard_scores(torch, fleet, dev)
        return int((scores.view(torch.int32) !=
                    fused.d_scores.view(torch.int32)).sum())

    # a member's first accumulators are a matmul at the shard's width: the
    # cells where it rounds apart from the fused fleet's, before any tick
    seeded_cells = {name: not_bitwise(f) for name, f in fleets.items()}
    live = fused.prices.copy()
    n_chg = max(1, C // 100)

    def next_deltas():
        cols = rng.choice(C, n_chg, replace=False)
        new = (live[cols] * rng.uniform(0.7, 1.3, n_chg)).astype(np.float32)
        return {ids[c]: float(p) for c, p in zip(cols, new)}, cols, new

    for tick in range(1, ticks + 1):
        deltas, cols, new = next_deltas()
        want = fused.reprice(deltas)
        want_heads = fused.heads(keys, 10)
        for name, fleet in fleets.items():
            D = len(fleet._shards)
            rd.reset_launches()
            got = fleet.reprice(deltas)
            counts = dict(rd.LAUNCHES)
            check(got == want, f"sharded {name} tick {tick}: moved {got} != "
                  f"the fused fleet's {want}")
            check(counts == {n: D * (n in TICK_KERNELS) for n in counts},
                  f"sharded {name} tick {tick}: launches {counts}")
            check(within(torch, shard_scores(torch, fleet, dev),
                         fused.d_scores),
                  f"sharded {name} tick {tick}: scores outside the contract "
                  f"of the fused fleet's")
            rd.reset_launches()
            heads = fleet.heads(keys, 10)
            check(dict(rd.LAUNCHES) == {n: D * (n == "select")
                                        for n in rd.LAUNCHES},
                  f"sharded {name}: heads launched {dict(rd.LAUNCHES)}")
            check(same_heads(contract, heads, want_heads),
                  f"sharded {name} tick {tick}: heads differ from the fused "
                  f"fleet's")
        live[cols] = new
        if tick in (ticks // 2, ticks):       # the float64 cold rank
            for key, rows in members.items():
                cold, counts = _scores_numpy(hours[rows], mask[rows], live)
                cold = np.where(counts > 0, cold, np.inf)
                for name, fleet in fleets.items():
                    check_against_cold(np, fleet, key, cold, contract,
                                       f"sharded {name} tick {tick}")
            log(f"[sharded] tick {tick}: every member of every fleet within "
                f"the contract of rank_dense, heads = ranking()[:10]")
    for name, fleet in fleets.items():
        full = fleet.ranking("all")
        for k in (10, 1_000):
            head = fleet.top_k("all", k)
            check(head == full[:k] and same_heads(
                contract, [head], [fused.top_k("all", k)]),
                f"sharded {name}: the {k}-head is not ranking()[:{k}] or "
                f"the fused fleet's")
        check(fleet.dispatches == fleet.reprices == ticks,
              f"sharded {name}: {fleet.dispatches} dispatches")
    log(f"[sharded] {J}x{C}x{S} at {', '.join(layouts)}: {ticks} ticks of "
        f"{n_chg} prices, moved and 10-heads' configs equal to the fused "
        f"fleet's every tick, scores within the contract (of {S * C} "
        f"cells, not bitwise the fused fleet's after seeding / after the "
        f"last tick: " + ", ".join(
            f"{name} {seeded_cells[name]} / {not_bitwise(f)}"
            for name, f in fleets.items())
        + "), one scatter, rowmin and fold a shard a tick, one select a "
        "shard a heads call; the 1,000-head = ranking()[:1000] and the "
        "fused fleet's configs")
    # the tick in turns with the fused fleet's (host clock: the pairs'
    # validation, D scatters, rowmins and folds, the combine and the moved
    # count read back; every card waited for at the end of a turn)
    paths = {"fused": fused.reprice}
    paths.update({name: fleet.reprice for name, fleet in fleets.items()})
    order = list(paths) + list(paths)[::-1]
    batches = [next_deltas()[0] for _ in range(len(order) * turn_ticks)]
    for d in batches[:turn_ticks]:                   # warm-up
        for tick_fn in paths.values():
            tick_fn(d)
    tick_ms = dict.fromkeys(paths, 0.0)
    for turn, name in enumerate(order):
        part = batches[turn * turn_ticks:(turn + 1) * turn_ticks]
        sync_cards(torch)
        t0 = time.perf_counter()
        for d in part:
            paths[name](d)
        sync_cards(torch)
        tick_ms[name] += (time.perf_counter() - t0) * 1e3 / (2 * turn_ticks)
    # the combine alone on each fleet's own minima (host clock; the moved
    # count's readback belongs to every fleet's tick and is left out)
    combine_ms = {}
    for name, fleet in fleets.items():
        partial = [sh.row_best for sh in fleet._shards]
        base = fleet._shards[0].row_best
        sync_cards(torch)
        t0 = time.perf_counter()
        for _ in range(200):
            rb = fleet._combine(partial)
            (rb != base).sum()
            fleet._replicas(rb)
        sync_cards(torch)
        combine_ms[name] = (time.perf_counter() - t0) * 1e3 / 200
    log(f"[sharded] tick at {J}x{C}x{S}, 1% of prices, in turns (host "
        f"clock, ms): " + ", ".join(f"{n} {v:.4f}" for n, v in
                                    tick_ms.items())
        + "; the combine (min of the shards' minima, the moved count, the "
        "copies back): " + ", ".join(
            f"{name} {combine_ms[name]:.4f} ms = "
            f"{combine_ms[name] / tick_ms[name]:.1%}" for name in fleets)
        + f" of the tick; on {card}")
    return {"tick_ms": tick_ms, "combine_ms": combine_ms}


def phase_sharded_service(torch, np, rd, seed, errs, n_events=1_000,
                          device="cuda:0"):
    """The sharded main path: phase 4's service and daemon on
    ``torch_sharded`` at 2 shards on one card, read through the launch
    counters, then the kernels held against their plain versions at the
    shapes it gave them (a shard of its fleet, a 1% tick)."""
    dev = torch.device(device)
    rd.reset_launches()
    service, _, _ = phase_service(np, seed, n_events=n_events,
                                  device=[dev] * 2, backend="torch_sharded",
                                  label="sharded service")
    launches = dict(rd.LAUNCHES)
    ticks_run = service.reprice_dispatches
    check(all(launches[n] == 2 * ticks_run > 0 for n in TICK_KERNELS),
          f"sharded service: {launches} for {ticks_run} fleet ticks at 2 "
          f"shards")
    check(launches["select"] > 0 and launches["select"] % 2 == 0,
          f"sharded service: {launches['select']} select launches")
    for name in set(KERNELS) - set(PATH_KERNELS):
        check(launches[name] == 0, f"sharded service: {name} launched")
    log(f"[sharded service] launches: " + ", ".join(
        f"{n} {launches[n]}" for n in PATH_KERNELS)
        + f" for {ticks_run} fleet ticks at 2 shards")
    check_kernels(torch, shard_tick(torch, np, np.random.default_rng(
        seed + 9), service._batched), "sharded service shard 0 1%", 10, errs)
    return launches


# --- phase 4 --------------------------------------------------------------------

def phase_service(np, seed, n_jobs=64, n_cfgs=10_000, n_events=1_000,
                  device="cuda", backend="torch_fused", label="service"):
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
                               backend=backend, device=device,
                               serve_top_k=10)
    feed = SimulatedSpotFeed(dict(table.items()), seed=seed,
                             change_fraction=0.01)
    daemon = SelectionDaemon(service, feed)
    t0 = time.perf_counter()
    stats = daemon.run(synthetic_stream(store.job_ids, n_events, seed=seed))
    secs = time.perf_counter() - t0
    fleet = service._batched
    check(fleet is not None and 0 < fleet.dispatches <= stats.epochs,
          f"{label}: fleet dispatches {getattr(fleet, 'dispatches', None)} "
          f"for {stats.epochs} price epochs")
    check(service.reprice_dispatches == fleet.dispatches,
          f"{label}: more than one dispatch per tick")
    t0 = time.perf_counter()
    audit = JournalReplayer(store, daemon.journal_dump()).audit()
    audit_secs = time.perf_counter() - t0
    check(audit.ok, f"{label}: journal audit failed: {audit.mismatches[:3]}")
    check(audit.decisions == stats.decisions > 0,
          f"{label}: audit saw no decisions")
    log(f"[{label}] {n_events} events in {secs:.3f} s "
        f"({n_events / secs:.1f} events/s): {stats.decisions} decisions, "
        f"{stats.ticks} ticks, {stats.epochs} epochs, {fleet.n_active} "
        f"members; audit ok in {audit_secs:.3f} s ({audit.decisions} "
        f"decisions, {len(audit.drift)} within-contract drift records)")
    # the service's own spans (host clock): where the daemon's time went
    spans = service.metrics.snapshot()["histograms"]
    log(f"[{label}] spans (count x mean ms): " + ", ".join(
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


def phase_guard(torch, rd, row, k=10, n=100_000):
    """What the kernels' device guard (``_build.launch_on``) costs the
    host: around a no-op (on this machine's card count), beside the two
    device exchanges it makes where there are several cards and
    ``torch.cuda.device``'s context manager (microseconds a call beyond
    the bare call, host clock), and on the service's one-row ``select``
    (CUDA events, back to back) in turns with the guard and with a bare
    call in its place."""
    from repro_torch.kernels import _build
    t = row[0]

    def noop(*args):
        return 0

    def bare():
        for _ in range(n):
            noop(1, 2, 3)

    def guard():
        for _ in range(n):
            _build.launch_on(t, noop, 1, 2, 3)

    def exchange():
        for _ in range(n):
            prev = torch.cuda._exchange_device(t.device.index)
            try:
                noop(1, 2, 3)
            finally:
                torch.cuda._maybe_exchange_device(prev)

    def context():
        for _ in range(n):
            with torch.cuda.device(t.device):
                noop(1, 2, 3)

    us = {}
    turns = (("bare", bare), ("guard", guard), ("exchange", exchange),
             ("context", context))
    for name, fn in turns + turns[::-1]:
        t0 = time.perf_counter()
        fn()
        us[name] = us.get(name, 0.0) + (time.perf_counter() - t0) * 1e6 / (
            2 * n)
    guarded = _build.launch_on

    def unguarded(t, entry, *args):
        return entry(*args)

    select_ms = {"guarded": [], "bare": []}
    for name in ("guarded", "bare", "bare", "guarded") * 2:
        _build.launch_on = guarded if name == "guarded" else unguarded
        try:
            select_ms[name].append(time_ms(
                torch, lambda: rd.select_heads(*row, k)))
        finally:
            _build.launch_on = guarded
    log(f"[guard] the device guard around a call, {torch.cuda.device_count()}"
        f" card(s): {us['guard'] - us['bare']:.3f} us (its two exchanges, "
        f"as with several cards: {us['exchange'] - us['bare']:.3f} us; "
        f"torch.cuda.device's context manager: "
        f"{us['context'] - us['bare']:.3f} us), host clock; select "
        f"on the service's member row ({row[0].shape[0]} x "
        f"{row[0].shape[1]}, k = {k}) back to back, 8 turns: " + "; ".join(
            f"{name} median {sorted(v)[len(v) // 2]:.4f} ms ("
            + ", ".join(f"{x:.4f}" for x in v) + ")"
            for name, v in select_ms.items()))


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


#: how far a ``torch_fused`` or ``torch_sharded`` point's deviations may sit
#: from numpy's: the CPU tests' bound (``tests/test_torch_turbulence.py``)
SWEEP_REL, SWEEP_ABS = 1e-4, 1e-12
#: the sweep's backends, and the shards ``torch_sharded`` takes on the card
SWEEP_BACKENDS = ("numpy", "torch_fused", "torch_sharded")
SWEEP_SHARDS = 2


def phase_turbulence(torch, np, rd, seed, errs, device="cuda",
                     n_events=400, stream_seed=3, market_seed=11):
    """The turbulence benchmark's universe (the paper's trace at seed 0,
    18 jobs x 10 configs), every preset on numpy, on ``torch_fused`` and
    on ``torch_sharded`` at 2 shards on the card, the B1 kernels and
    ``select`` held against their plain versions on each ``torch_fused``
    fleet of the sweep, and the quickstart's outcome through the port's
    core."""
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
        on = [device] * SWEEP_SHARDS if backend == "torch_sharded" \
            else device
        svc = SelectionService(catalog, store,
                               PriceTable.from_catalog(catalog),
                               backend=backend, device=on)
        services.append(svc)
        return svc

    regen = record_feed(make_market("calm", base, seed=market_seed,
                                    ticks=40).raw, 40)
    check(regen == FIXTURE.read_text(),
          "calm preset does not regenerate gcp_spot_prices.csv")
    log(f"[turbulence] calm preset regenerates {FIXTURE.name} byte for "
        f"byte ({len(regen)} bytes)")
    calm = {}
    for backend in SWEEP_BACKENDS:
        point = run_point(factory(backend), RecordedPriceFeed.load(FIXTURE),
                          events, preset_name="calm",
                          truth=RecordedPriceFeed.load(FIXTURE))
        calm[backend] = point.mean_deviation
        check(point.audit_ok, f"calm fixture on {backend}: audit failed")
        check(point.mean_deviation <= CALM_MAX_DEVIATION,
              f"calm fixture on {backend}: mean deviation "
              f"{point.mean_deviation} > {CALM_MAX_DEVIATION}")
        check(backend != "torch_sharded" or calm[backend] == calm["numpy"],
              f"calm fixture on torch_sharded: mean deviation "
              f"{calm[backend]!r} != numpy's {calm['numpy']!r}")
        log(f"[turbulence] calm fixture on {backend}: mean deviation "
            f"{point.mean_deviation!r} (<= {CALM_MAX_DEVIATION}), "
            f"{point.decisions} decisions, {point.epochs} epochs, audit ok")
    del services[:]
    rd.reset_launches()
    t0 = time.perf_counter()
    points = run_sweep(factory, base, events, backends=SWEEP_BACKENDS,
                       seed=market_seed)
    secs = time.perf_counter() - t0
    counts = dict(rd.LAUNCHES)
    fused = [s for s in services if s.backend == "torch_fused"]
    sharded = [s for s in services if s.backend == "torch_sharded"]
    # one scatter, rowmin and fold a fleet tick, a shard on torch_sharded
    ticks = sum(s.reprice_dispatches for s in fused) + SWEEP_SHARDS * sum(
        s.reprice_dispatches for s in sharded)
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
    for name, backend in {(n, b) for n, b in by if b != "numpy"}:
        for attr in ("mean_deviation", "truth_mean_deviation"):
            got = getattr(by[name, backend], attr)
            want = getattr(by[name, "numpy"], attr)
            check(abs(got - want) <= max(SWEEP_REL * abs(want), SWEEP_ABS),
                  f"turbulence {name}: {backend} {attr} {got!r} vs numpy "
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
        f"ok; torch_fused and torch_sharded vs numpy mean deviation: worst "
        f"relative difference {worst:.3g} (<= {SWEEP_REL}); {len(fleets)} "
        f"fleets' kernels against their plain versions ok; B1 on the card: "
        f"scatter {counts['scatter']}, rowmin {counts['rowmin']}, fold "
        f"{counts['fold']} launches for {ticks} fleet ticks and shard ticks "
        f"(1 each; torch_sharded {SWEEP_SHARDS} shards) over "
        f"{sum(s.price_epoch for s in fused + sharded)} price epochs; "
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

#: (B, Tq, Tk, H, G, D, causal, window): GQA, MQA, bidirectional,
#: windowed, ragged T (the engine's 12-token prompts, 100, 130), every head
#: size the kernel is built for, and bidirectional calls with Tq != Tk
ATTN_CASES = [
    (2, 128, 128, 4, 2, 64, True, None),
    (2, 64, 64, 8, 1, 32, True, None),
    (1, 96, 96, 2, 2, 16, False, None),
    (1, 256, 256, 4, 4, 32, True, 64),
    (2, 12, 12, 16, 8, 128, True, None),
    (1, 100, 100, 4, 2, 80, True, 16),
    (1, 130, 130, 2, 1, 128, False, None),
    (1, 200, 200, 4, 4, 64, True, 48),
    (1, 100, 100, 4, 1, 64, True, None),
    (1, 1000, 1000, 4, 2, 128, True, 300),
    # D = 80: stablelm-3b's prefill (MHA), GQA, ragged T = 100, a window
    # over T = 1,000, T = 1 and T = 129 (one past a 128-row tile)
    (4, 1024, 1024, 32, 32, 80, True, None),
    (2, 256, 256, 8, 2, 80, True, None),
    (1, 100, 100, 4, 4, 80, True, None),
    (1, 1000, 1000, 4, 2, 80, True, 300),
    (2, 1, 1, 4, 4, 80, True, None),
    (1, 129, 129, 4, 2, 80, False, None),
    # D = 256 (its own block shape: 64-row tiles): recurrentgemma-9b's
    # prefill (MQA), its 4,096-token prompt past the 2,048 window, GQA,
    # T = 1, 100, 129 (bidirectional) and a window over T = 1,000
    (4, 1024, 1024, 16, 1, 256, True, None),
    (1, 4096, 4096, 16, 1, 256, True, 2048),
    (2, 256, 256, 8, 2, 256, True, None),
    (2, 1, 1, 4, 1, 256, True, None),
    (1, 100, 100, 4, 1, 256, True, None),
    (1, 129, 129, 4, 2, 256, False, None),
    (1, 1000, 1000, 4, 1, 256, True, 300),
    # bidirectional with Tq != Tk: seamless-m4t-large-v2's encoder over
    # 4,096 frames, its decoder's 1,024-token prompt over them (cross
    # prefill) and one decode token over them (cross decode); a ragged
    # source, Tk < Tq, one token at D = 256 and one past a tile at D = 80
    (4, 4096, 4096, 16, 16, 64, False, None),
    (4, 1024, 4096, 16, 16, 64, False, None),
    (4, 1, 4096, 16, 16, 64, False, None),
    (2, 7, 1000, 16, 16, 64, False, None),
    (1, 100, 37, 4, 2, 128, False, None),
    (2, 1, 130, 4, 1, 256, False, None),
    (1, 129, 300, 4, 4, 80, False, None),
    # D = 160 (the wide block's 64-row tiles; two 64-column blocks and a
    # 32-column tail): pixtral-12b's prefill (1,024 patches and 1,024
    # tokens, GQA 32 over 8), GQA at T = 256, ragged T = 100, a window
    # over T = 1,000, T = 1, T = 65 (one past a 64-row tile) and a
    # bidirectional call with Tq != Tk
    (4, 2048, 2048, 32, 8, 160, True, None),
    (2, 256, 256, 8, 2, 160, True, None),
    (1, 100, 100, 4, 4, 160, True, None),
    (1, 1000, 1000, 4, 2, 160, True, 300),
    (2, 1, 1, 4, 4, 160, True, None),
    (1, 65, 65, 4, 2, 160, True, None),
    (1, 129, 300, 4, 4, 160, False, None),
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
#: a bidirectional bf16 case is also held to this relative L2 error over
#: its whole output.  With random q, k and v an output row averages about
#: Tk values of v, so |o| is about sqrt(e / Tk): at Tk = 4,096 near
#: 0.026, on the scale of ATTN_TOL's bf16 atol, which alone would pass a
#: kernel that skipped a key tile.  bf16 rounding of the output costs
#: about 2^-9 of it; a skipped tile of n keys about sqrt(n / Tk)
ATTN_REL_L2 = {"bfloat16": 1e-2}
#: the planted fault that shows ``ATTN_REL_L2`` has the power to fail a
#: kernel: the plain version with its last this many keys dropped (the
#: smallest key tile of any head size, D = 256's) must fail it
DROPPED_KEYS = 64
WKV_TOL = (1e-4, 1e-3)
#: the record's LM entries: ``flash_attention`` is the tensor-core kernel
#: at qwen3-1.7b's D = 128, ``flash_attention_d80`` the same kernel at
#: stablelm-3b's D = 80, ``flash_attention_mha128`` at deepseek-7b's (MHA,
#: D = 128), ``flash_attention_mqa`` at granite-20b's (48 query heads on
#: one KV head), ``flash_attention_d64`` at qwen3-moe-30b-a3b's (D = 64),
#: ``flash_attention_llama4`` at the llama4 check's (2 x 1,024, 40 heads
#: over 8), ``flash_attention_d256`` at recurrentgemma-9b's (D = 256, 16
#: query heads on one KV head), ``flash_attention_scalar`` the scalar
#: kernel (fp32) at qwen3-1.7b's shape and ``flash_attention_scalar_d256``
#: at recurrentgemma-9b's; ``flash_attention_enc``, ``_dec``, ``_cross``
#: and ``_xdec`` the tensor-core kernel at seamless-m4t-large-v2's four
#: shapes (``ENCDEC_MODES``); ``flash_attention_d160`` the tensor-core
#: kernel and ``flash_attention_scalar_d160`` the scalar one (fp32) at
#: pixtral-12b's (D = 160, 32 query heads on 8 KV heads, 1,024 patches
#: and 1,024 tokens a sequence)
_ATTN = dict(op="flash_attention",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:28")
LM_KERNELS = {
    "flash_attention": _ATTN,
    "flash_attention_d80": _ATTN,
    "flash_attention_mha128": _ATTN,
    "flash_attention_mqa": _ATTN,
    "flash_attention_d64": _ATTN,
    "flash_attention_llama4": _ATTN,
    "flash_attention_d256": _ATTN,
    "flash_attention_scalar": _ATTN,
    "flash_attention_scalar_d256": _ATTN,
    "flash_attention_enc": _ATTN,
    "flash_attention_dec": _ATTN,
    "flash_attention_cross": _ATTN,
    "flash_attention_xdec": _ATTN,
    "flash_attention_d160": _ATTN,
    "flash_attention_scalar_d160": _ATTN,
    "wkv6": dict(op="wkv6", source="src/repro_torch/csrc/wkv6_scan.cu",
                 replaces="src/repro/kernels/rwkv6_scan.py:25"),
}
#: (model, record entry of the kernel its path runs), in serving order
SERVED = [("qwen3-1.7b", "flash_attention"),
          ("stablelm-3b", "flash_attention_d80"),
          ("rwkv6-3b", "wkv6"),
          ("deepseek-7b", "flash_attention_mha128"),
          ("granite-20b", "flash_attention_mqa"),
          ("qwen3-moe-30b-a3b", "flash_attention_d64"),
          ("recurrentgemma-9b", "flash_attention_d256"),
          ("seamless-m4t-large-v2", "flash_attention_enc"),
          ("pixtral-12b", "flash_attention_d160")]
#: the encoder-decoder's attention calls, one record entry each: (Tq, Tk,
#: causal) as functions of the prompt length T and the source length F,
#: and the calls a prefill ("prefill") or a decode step ("decode") makes
#: of each, one a layer of its stack
ENCDEC_MODES = {
    "flash_attention_enc": (lambda T, F: (F, F, False), "prefill"),
    "flash_attention_dec": (lambda T, F: (T, T, True), "prefill"),
    "flash_attention_cross": (lambda T, F: (T, F, False), "prefill"),
    "flash_attention_xdec": (lambda T, F: (1, F, False), "decode"),
}
#: the encoder-decoder's fp32 check: 2 encoder and 2 decoder layers at
#: full width, a source ragged against every tile, 6 prompt tokens and 8
#: decode steps
ENCDEC_PARITY_LAYERS, ENCDEC_PARITY_FRAMES = 2, 100
ENCDEC_PARITY_STEPS = 8
#: the record entries whose ``time_lm_kernel`` also times the scalar
#: kernel in fp32 at their path's shape (its entry's name)
SCALAR_ENTRIES = {"flash_attention": "flash_attention_scalar",
                  "flash_attention_d256": "flash_attention_scalar_d256",
                  "flash_attention_d160": "flash_attention_scalar_d160"}
#: the vision-language model's fp32 check: patches a sequence ahead of
#: its prompt, ragged against the 64-row tile
VLM_PARITY_PATCHES = 100
#: the windowed model's long-prompt check: a prompt past its window (the
#: ring write with T > S), then decode steps (the ring wraps); and the
#: fp32 4-layer check's prompt and steps there
WINDOW_PROMPT, WINDOW_STEPS = 4096, 8
WINDOW_PARITY_PROMPT, WINDOW_PARITY_STEPS = 2100, 8
#: the llama4 check: full width, this many layers (one dense, one MoE)
LLAMA4 = "llama4-maverick-400b-a17b"
LLAMA4_LAYERS = 2
#: the capacity factor of the 4-layer fp32 check on MoE models (the
#: reference's decode-parity test's; the reason is at the check)
MOE_PARITY_CAPACITY = 64.0
#: the depths of the MoE kernel-vs-plain account (``moe_account``), and
#: the depth held to ``REL_L2_TOL`` with the routes free (the reason is at
#: the check in ``phase_serve``)
MOE_DEPTHS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48)
MOE_CHECK_LAYERS = 1


def allclose(torch, a, b, atol, rtol) -> bool:
    a, b = a.float(), b.float()
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all())


def sync(torch, dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def attn_inputs(torch, B, T, H, G, D, dtype, seed, dev="cuda", Tk=None):
    """q (B, T, H, D) and k, v (B, Tk, G, D), Tk = T unless given."""
    Tk = T if Tk is None else Tk
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                 for shape in ((B, T, H, D), (B, Tk, G, D), (B, Tk, G, D)))


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
    limit = ATTN_REL_L2.get(str(q.dtype).split(".")[-1])
    if limit is not None and not causal:
        check_rel_l2(torch, q, k, v, got, want, limit, label)
    if errs is not None:
        name = name or ("flash_attention" if kind == "tc"
                        else "flash_attention_scalar")
        errs[name] = max(errs[name], err)
    return err


def check_rel_l2(torch, q, k, v, got, want, limit, label) -> None:
    """A bidirectional call's output within ``limit`` relative L2 of the
    plain version's; where there are more than :data:`DROPPED_KEYS` keys,
    also the plain version with its last :data:`DROPPED_KEYS` keys dropped,
    which must fail the limit (and the log says whether it would pass
    ``ATTN_TOL`` alone)."""
    from repro_torch.kernels import flash_attention as fa
    rel = rel_l2(got, want)
    check(rel < limit, f"{label}: flash attention relative L2 {rel:.3g} "
          f">= {limit}")
    Tk = k.shape[1]
    if Tk <= DROPPED_KEYS:
        log(f"[lm-parity] {label}: relative L2 {rel:.3g} < {limit} ok")
        return
    cut = Tk - DROPPED_KEYS
    fault = fa.attention_ref(q, k[:, :cut], v[:, :cut], causal=False)
    rel_fault = rel_l2(fault, want)
    check(rel_fault >= limit, f"{label}: {DROPPED_KEYS} dropped keys move "
          f"the output by {rel_fault:.3g} relative L2, under {limit}")
    atol, rtol = ATTN_TOL[str(q.dtype).split(".")[-1]]
    log(f"[lm-parity] {label}: relative L2 {rel:.3g} < {limit} ok; the last "
        f"{DROPPED_KEYS} of {Tk} keys dropped: {rel_fault:.3g} (fails it; "
        f"max |err| {max_err(torch, fault.float(), want.float()):.3g}, "
        f"within atol {atol} rtol {rtol}: "
        f"{allclose(torch, fault, want, atol, rtol)})")
    del fault


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


def with_routes(torch, fn, replay=None):
    """``fn()`` with every MoE layer's router call recorded: returns (fn's
    result, [expert ids (B, T, K) of each MoE layer, in depth order]).
    With ``replay`` (such a list from another pass) each layer takes those
    experts in place of its own top K, at its own gates for them, so the
    pass differs from the one recorded in its continuous values alone."""
    from repro_torch.models import layers as L
    routes, route = [], L.moe_route

    def recording(p, cfg, x):
        logits, gates, idx = route(p, cfg, x)
        if replay is not None:
            idx = replay[len(routes)]
            K = cfg.experts_per_token
            probs = torch.sigmoid(logits) if K == 1 \
                else torch.softmax(logits, -1)
            gates = probs.gather(-1, idx)
            if K > 1:
                gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        routes.append(idx)
        return logits, gates, idx
    L.moe_route = recording
    try:
        return fn(), routes
    finally:
        L.moe_route = route


@contextlib.contextmanager
def first_layers(model, n):
    """``model`` cut to its first ``n`` layers for the ``with`` block (the
    same weights; the state it makes has ``n`` layers too)."""
    plans, blocks = model.plans, model.blocks
    model.plans, model.blocks = plans[:n], blocks[:n]
    try:
        yield model
    finally:
        model.plans, model.blocks = plans, blocks


def phase_lm_parity(torch, dev="cuda"):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rwkv6_scan as wk
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for case in ATTN_CASES:
            B, Tq, Tk, H, G, D, causal, window = case
            q, k, v = attn_inputs(torch, B, Tq, H, G, D, dtype,
                                  B + Tq + H + G + D, dev, Tk=Tk)
            err = check_attention(torch, q, k, v, causal, window,
                                  f"attn {case} {name}")
            log(f"[lm-parity] flash attention {name} "
                f"({fa.variant(dtype, D)}) B={B} Tq={Tq} Tk={Tk} H={H} G={G} "
                f"D={D} causal={causal} window={window}: max |err| "
                f"{err:.3g} ok")
            del q, k, v
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


def phase_parity_4_layers(torch, cfg, seed, dev="cuda", prompt=6, steps=6,
                          frames=0):
    """``cfg``'s width, 4 layers, fp32: a ``prompt``-token prefill and
    ``steps`` decode steps against ``forward`` over all ``prompt + steps``
    tokens, within the reference's decode-parity tolerance 2e-3.  A
    windowed model takes a prompt past its window, so that the prefill
    writes its ring with T > S and decode wraps it.  An encoder-decoder
    model takes ``ENCDEC_PARITY_LAYERS`` encoder and decoder layers and a
    source of ``frames`` frames; a vision-language model ``frames``
    patches ahead of its prompt (decode at ``frames + t``)."""
    from repro_torch.models import build_model
    name = cfg.name
    vlm = cfg.frontend == "vision"
    if cfg.is_encdec:
        cfg = dataclasses.replace(cfg, num_layers=ENCDEC_PARITY_LAYERS,
                                  encoder_layers=ENCDEC_PARITY_LAYERS,
                                  dtype="float32")
    else:
        cfg = dataclasses.replace(cfg, num_layers=4, dtype="float32")
    if cfg.num_experts:
        # capacity is per call: the forward's 12 tokens get C = ceil(12 K /
        # E * 1.25) slots an expert, the prefill's 6 and each decode step's
        # 1 their own, so at 1.25 the forward drops tokens that prefill and
        # decode keep and the two differ by design; with capacity to spare
        # (the reference's decode-parity test) nothing is dropped
        cfg = dataclasses.replace(cfg, capacity_factor=MOE_PARITY_CAPACITY)
        log(f"[serve] {name} 4 layers fp32: capacity factor "
            f"{MOE_PARITY_CAPACITY:g}, no drops (at 1.25 the forward's longer "
            f"call drops tokens that prefill and decode keep)")
    model = build_model(cfg, device=dev, seed=seed)
    plans = model.dec_plans if cfg.is_encdec else model.plans
    kinds = ", ".join(plan.kind for plan in plans)
    total = prompt + steps
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (2, total), generator=gen,
                           device=dev)
    extra = {}
    if cfg.is_encdec or vlm:
        extra["frontend_embeds"] = torch.randn(
            (2, frames, cfg.d_model), generator=gen, device=dev)
    if cfg.is_encdec:
        kinds = f"{cfg.encoder_layers} encoder + {kinds} with cross"
    F = frames if vlm else 0      # patches ahead of the prompt
    with torch.inference_mode():
        full = model({"tokens": tokens, **extra})
        state = new_state(model, 2, F + total, extra)
        slots = sorted({st["k"].shape[1] for st in state if "k" in st})
        logits, state = model.prefill({"tokens": tokens[:, :prompt],
                                       **extra}, state)
        errs = [float((logits - full[:, F + prompt - 1]).abs().max())]
        for t in range(prompt, total):
            logits, state = model.decode_step(tokens[:, t], F + t, state)
            errs.append(float((logits - full[:, F + t]).abs().max()))
    label = f"{cfg.num_layers} layers" if not cfg.is_encdec else \
        f"{cfg.encoder_layers} + {cfg.num_layers} layers"
    check(max(errs) < 2e-3, f"{name} {label} fp32: prefill/decode vs "
          f"forward max |err| {max(errs):.3g} >= 2e-3")
    source = f", {frames} source frames" if cfg.is_encdec else \
        f", {frames} patches ahead of the prompt" if vlm else ""
    log(f"[serve] {name} {label} fp32 at d_model {cfg.d_model} ({kinds}; "
        f"KV cache slots {slots}{source}): {prompt}-token prefill + {steps} "
        f"decode steps vs forward over {total} max |err| {max(errs):.3g} "
        f"(< 2e-3) ok")
    del model, full, state
    free_card(torch, dev)


def new_state(model, B, max_len, batch):
    """A zeroed decode state for ``batch``; an encoder-decoder model's also
    holds the cross caches of the batch's frames.  A vision-language
    model's patches take slots of the self caches: ``max_len`` counts
    them."""
    if model.cfg.is_encdec:
        return model.init_state(B, max_len,
                                batch["frontend_embeds"].shape[1])
    return model.init_state(B, max_len)


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
    from repro_torch.models import build_model, count_params
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serve import Engine, Request
    name = cfg.name
    kernel = "wkv6" if "rwkv" in cfg.block_pattern else "flash_attention"
    encdec = cfg.is_encdec
    vlm = cfg.frontend == "vision"
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
    # an encoder-decoder model's requests carry their source, a
    # vision-language model's its image's patch embeddings: random, in
    # the compute dtype, the config's frontend_len each
    F = cfg.frontend_len if encdec or vlm else 0
    frames = [None] * n_requests
    if F:
        gen = torch.Generator(device=dev).manual_seed(seed)
        frames = torch.randn((n_requests, F, cfg.d_model), generator=gen,
                             device=dev).to(cfg.compute_dtype)
    reqs = [Request(uid=i, prompt=prompts[i], max_new_tokens=max_new,
                    frames=frames[i])
            for i in range(n_requests)]
    # the patches come first in the self caches; a source has its own
    P = F if vlm else 0
    max_len = P + prompt_len + max_new
    enc_len = F if encdec else 0
    # warm-up at the traffic's shapes (library loads, cuBLAS handles and
    # heuristics, the allocator's blocks), outside the counted run
    Engine(model, slots=slots, max_len=max_len, enc_len=enc_len,
           device=dev).generate_batch([dataclasses.replace(
               reqs[0], max_new_tokens=2)])
    metrics = MetricsRegistry()
    eng = Engine(model, slots=slots, max_len=max_len, enc_len=enc_len,
                 placement=placement, metrics=metrics, device=dev)
    sync(torch, dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    comps = eng.serve(reqs)
    sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = ops.launches()
    by_shape = dict(fa.SHAPE_LAUNCHES)
    check(sorted(c.uid for c in comps) == list(range(n_requests))
          and all(len(c.tokens) == max_new for c in comps),
          f"{name}: served {len(comps)} completions")
    waves = -(-n_requests // slots)
    check(eng.prefills == waves and eng.decode_steps == waves
          * (max_new - 1), f"{name}: {eng.prefills} prefills, "
          f"{eng.decode_steps} decode steps")
    L = cfg.num_layers
    modes = None
    if encdec:
        # a prefill: one launch an encoder layer (bidirectional over the
        # frames), and two a decoder layer (causal over the prompt, then
        # cross over the frames); a decode step: one a decoder layer
        # (cross decode); every one the tensor-core kernel
        L = cfg.encoder_layers + cfg.num_layers
        n_kernel = cfg.encoder_layers + 2 * cfg.num_layers
        n = n_kernel * eng.prefills + cfg.num_layers * eng.decode_steps
        expect = {"flash_attention": n, "flash_attention_tc": n,
                  "flash_attention_scalar": 0, "flash_attention_bwd": 0,
                  "wkv6": 0, "wkv6_seq": 0}
        # each entry's launches are its shape's, as the wrapper counted
        # them where it launched
        modes, want_shapes = {}, {}
        for entry, (shape_of, per) in ENCDEC_MODES.items():
            Tq, Tk, causal = shape_of(prompt_len, F)
            layers = cfg.encoder_layers if entry == "flash_attention_enc" \
                else cfg.num_layers
            want_shapes[("tc", Tq, Tk, causal)] = layers * (
                eng.prefills if per == "prefill" else eng.decode_steps)
            modes[entry] = (dict(B=slots, T=Tq, Tk=Tk, causal=causal,
                                 d=cfg.d_model, H=cfg.num_heads,
                                 G=cfg.num_kv_heads, D=cfg.head_dim,
                                 N=cfg.rwkv_head_dim,
                                 dtype=cfg.compute_dtype),
                            by_shape.get(("tc", Tq, Tk, causal), 0))
        check(by_shape == want_shapes, f"{name}: launches by (variant, Tq, "
              f"Tk, causal) {by_shape}, expected {want_shapes}")
        log(f"[serve] {name}: launches by (variant, Tq, Tk, causal): "
            f"{by_shape}")
    else:
        # the layers that run the path's kernel: the attention layers (12
        # of recurrentgemma-9b's 38), or every RWKV-6 layer
        n_kernel = sum(plan.kind == ("attn" if kernel == "flash_attention"
                                     else "rwkv") for plan in model.plans)
        if kernel == "flash_attention":
            # every prefill launch the tensor-core kernel, one an
            # attention layer, causal over the patches and the prompt
            n = n_kernel * eng.prefills
            expect = {"flash_attention": n, "flash_attention_tc": n,
                      "flash_attention_scalar": 0, "flash_attention_bwd": 0,
                      "wkv6": 0, "wkv6_seq": 0}
            T = P + prompt_len
            want_shapes = {("tc", T, T, True): n}
            check(by_shape == want_shapes, f"{name}: launches by (variant, "
                  f"Tq, Tk, causal) {by_shape}, expected {want_shapes}")
        else:
            # every model call launches the split kernel, never the
            # sequential one
            expect = {"flash_attention": 0, "flash_attention_tc": 0,
                      "flash_attention_scalar": 0, "flash_attention_bwd": 0,
                      "wkv6": n_kernel * (eng.prefills + eng.decode_steps),
                      "wkv6_seq": 0}
    check(launches == expect, f"{name}: kernel launches {launches}, "
          f"expected {expect} for {n_kernel} of {L} layers")
    hist = metrics.snapshot()["histograms"]
    pre_s, dec_s = hist["serve.prefill"]["sum"], hist["serve.decode"]["sum"]
    pre_tok = n_requests * prompt_len
    dec_tok = eng.decode_steps * slots
    if encdec:
        per = (f"{cfg.encoder_layers} encoder + 2 x {cfg.num_layers} decoder "
               f"launches a prefill, {cfg.num_layers} a decode step")
        source = (f"; source {n_requests * F} frames in {pre_s:.4f} s = "
                  f"{n_requests * F / pre_s:.1f} frames/s")
    elif vlm:
        per = (f"{n_kernel} of {L} layers x prefills, each over {P} "
               f"patches and {prompt_len} tokens; by shape {by_shape}")
        source = (f"; patches {n_requests * P} in {pre_s:.4f} s = "
                  f"{n_requests * P / pre_s:.1f} patches/s")
    else:
        calls_of = "prefills" if kernel == "flash_attention" \
            else "model calls"
        per = f"{n_kernel} of {L} layers x {calls_of}"
        source = ""
    ahead = f" and {F}-frame sources" if encdec else \
        f" after {F} patches each" if vlm else ""
    log(f"[serve] {name}: {n_requests} requests x {prompt_len}-token "
        f"prompts{ahead} over {slots} "
        f"slots, {max_new} new tokens each, in {wall:.3f} s; launches "
        f"{launches} (= {per})")
    log(f"[serve] {name}: prefill {pre_tok} {'text ' if vlm else ''}"
        f"tokens in {pre_s:.4f} s = "
        f"{pre_tok / pre_s:.1f} tokens/s{source}; decode "
        f"{eng.decode_steps} steps x {slots} slots in {dec_s:.4f} s = "
        f"{dec_tok / dec_s:.1f} tokens/s ({dec_s / eng.decode_steps * 1e3:.3f}"
        f" ms a step); peak {card_gib(torch, dev, peak=True):.2f} GiB on "
        f"{card}")
    # the same traffic again on the warm engine: the spread within a call
    again = MetricsRegistry()
    Engine(model, slots=slots, max_len=max_len, enc_len=enc_len,
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
    if F:
        first["frontend_embeds"] = frames[:slots]
    logits, logits_p, routes = kernel_vs_plain(
        torch, model, first, kernel, max_len)
    check(bool(torch.isfinite(logits.float()).all()),
          f"{name}: non-finite prefill logits")
    a, b = logits.float(), logits_p.float()
    rel = rel_l2(a, b)
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    if agree < 1:
        # where the passes pick different tokens: how close the plain
        # pass's top two logits lie, against the logits' max |err|
        flips = a.argmax(-1) != b.argmax(-1)
        top2 = b.topk(2, dim=-1).values[flips]
        log(f"[serve] {name}: argmax differs on {int(flips.sum())} of "
            f"{flips.numel()} rows, where the plain pass's top two logits "
            f"lie {[round(float(g), 4) for g in top2[:, 0] - top2[:, 1]]} "
            f"apart")
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
    if not routes:
        check(rel < REL_L2_TOL, f"{name}: kernel vs plain prefill logits "
              f"relative error {rel:.3g} >= {REL_L2_TOL}")
        log(f"[serve] {name}: first-wave prefill logits, kernel vs plain "
            f"{kernel}: relative L2 error {rel:.3g} (< {REL_L2_TOL}, bf16 "
            f"over {L} layers), max |err| {float((a - b).abs().max()):.3g} "
            f"of max |logit| {float(b.abs().max()):.3g}, argmax agreement "
            f"{agree:.0%}; all finite")
    else:
        # a MoE router's top K is a step function of its bf16 logits:
        # where a token's K-th and (K+1)-th logits lie within one bf16
        # step, the other pass's rounding picks the other expert, and the
        # token's output changes by one expert's contribution, not by a
        # rounding; every later layer's routes drift further apart.  On
        # an H100 qwen3-moe-30b-a3b's routes agreed on 98.7% of layer 0's
        # (token, k) slots and on 3.5% of layer 46's, and its logits with
        # the routes free stayed within the bound over its first layer
        # alone (0.0052; 0.115 over two).  So the bound holds that depth,
        # and the account shows the rest: with the plain pass on the
        # kernel pass's experts the gap is the bf16 drift alone.
        log_routes(name, routes)
        acct = moe_account(torch, model, first, kernel, max_len)
        log(f"[serve] {name}: kernel vs plain prefill logits over the first "
            f"n layers, relative L2 with the routes free / on the kernel "
            f"pass's experts: " + ", ".join(
                f"n = {n} {free:.3g} / {pinned:.3g}"
                for n, (free, pinned) in acct.items()))
        held = acct[MOE_CHECK_LAYERS][0]
        check(held < REL_L2_TOL, f"{name}: kernel vs plain prefill logits "
              f"over {MOE_CHECK_LAYERS} layer(s), routes free, relative "
              f"error {held:.3g} >= {REL_L2_TOL}")
        log(f"[serve] {name}: first-wave prefill logits, kernel vs plain "
            f"{kernel}: relative L2 error {held:.3g} over the first "
            f"{MOE_CHECK_LAYERS} layer(s) (< {REL_L2_TOL}, routes free); "
            f"over all {L}: {rel:.3g} with the routes free (argmax "
            f"agreement {agree:.0%}), {acct[L][1]:.3g} on the same "
            f"experts; all finite")

    waves = None
    if kernel == "flash_attention":
        waves = prefill_turns(torch, model, first, slots, max_len, dev)
        log(f"[serve] {name}: first-wave prefill ({slots} x {prompt_len} "
            f"tokens{f' after {P} patches' if P else ''}) in turns: "
            f"tensor-core kernel {waves['tc'] * 1e3:.3f} "
            f"ms = {slots * prompt_len / waves['tc']:.1f} tokens/s, scalar "
            f"kernel (the one it replaced) {waves['scalar'] * 1e3:.3f} ms = "
            f"{slots * prompt_len / waves['scalar']:.1f} tokens/s")
    if cfg.window:
        phase_window(torch, np, model, seed, card, dev=dev)
    shapes = dict(B=slots, T=P + prompt_len, d=cfg.d_model, H=cfg.num_heads,
                  G=cfg.num_kv_heads, D=cfg.head_dim,
                  N=cfg.rwkv_head_dim, dtype=cfg.compute_dtype)
    prefills = eng.prefills
    del model, eng, logits, logits_p, first, frames, reqs
    free_card(torch, dev)
    return dict(kernel=kernel, launches=launches, shapes=shapes,
                waves=waves, layers=n_kernel, modes=modes,
                prefills=prefills)


def phase_window(torch, np, model, seed, card, prompt_len=WINDOW_PROMPT,
                 steps=WINDOW_STEPS, dev="cuda"):
    """A windowed model past its window, at full width in bf16: one
    ``prompt_len``-token prefill (longer than the window: each attention
    layer's ring cache of ``window`` slots is written with T > S) and
    ``steps`` decode steps (the ring wraps), once through the kernel and
    once with the plain version; the prefill's and every step's logits
    finite and within ``REL_L2_TOL`` relative L2 of the plain pass's, and
    one tensor-core launch an attention layer in the kernel pass."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    cfg = model.cfg
    name = cfg.name
    rng = np.random.default_rng(seed + 1)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (1, prompt_len + steps)),
                             device=dev)
    n_attn = sum(plan.kind == "attn" for plan in model.plans)

    def run():
        out = []
        with torch.inference_mode():
            state = model.init_state(1, prompt_len + steps)
            logits, state = model.prefill(
                {"tokens": tokens[:, :prompt_len]}, state)
            out.append(logits)
            for t in range(prompt_len, prompt_len + steps):
                logits, state = model.decode_step(tokens[:, t], t, state)
                out.append(logits)
        slots = sorted({st["k"].shape[1] for st in state if "k" in st})
        return out, slots

    sync(torch, dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    got, slots = run()
    sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = ops.launches()
    check(launches["flash_attention_tc"] == launches["flash_attention"]
          == n_attn, f"{name} long prompt: launches {launches}, expected "
          f"{n_attn} tensor-core launches (one prefill)")
    check(slots == [cfg.window] and prompt_len > cfg.window,
          f"{name} long prompt: KV cache slots {slots}, window {cfg.window}")
    original = ops.flash_attention
    ops.flash_attention = fa.attention_ref
    try:
        want, _ = run()
    finally:
        ops.flash_attention = original
    rels = [rel_l2(a, b) for a, b in zip(got, want)]
    check(all(bool(torch.isfinite(a.float()).all()) for a in got),
          f"{name} long prompt: non-finite logits")
    check(max(rels) < REL_L2_TOL, f"{name} long prompt: kernel vs plain "
          f"logits relative error {max(rels):.3g} >= {REL_L2_TOL}")
    log(f"[window] {name}: 1 x {prompt_len}-token prefill past the window "
        f"{cfg.window} (ring caches of {slots[0]} slots written with T > S) "
        f"+ {steps} decode steps (the ring wraps) in {wall:.3f} s, "
        f"launches {launches}; kernel vs plain attention logits relative "
        f"L2 prefill {rels[0]:.3g}, decode steps "
        f"{' '.join(f'{r:.3g}' for r in rels[1:])} (< {REL_L2_TOL}); all "
        f"finite; on {card}")
    del got, want, tokens
    free_card(torch, dev)


def phase_llama4(torch, np, seed, card, batch=2, prompt_len=1024, steps=4,
                 dev="cuda", cfg=None):
    """``llama4-maverick-400b-a17b`` at full width over ``LLAMA4_LAYERS``
    layers (one dense, one MoE with its 128 experts, top-1 sigmoid routing
    and the shared expert) in bf16: one prefill of ``batch`` x ``prompt_len``
    tokens through the kernel and one through the plain version (relative
    L2 of the logits < ``REL_L2_TOL``, all finite, the MoE routes' share
    that agree), one ``flash_attention_tc`` launch a layer, then ``steps``
    decode steps (C = 1), all finite.  No fp32 check at this width (one
    fp32 MoE layer's experts alone are 3 x 128 x 5120 x 8192 x 4 bytes);
    the CPU tests hold the architecture to the reference at reduced
    width.  ``cfg`` replaces the config (a reduced one for a CPU
    rehearsal).  Returns what ``time_lm_kernel`` needs."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, count_params
    cfg = cfg or dataclasses.replace(configs.get(LLAMA4),
                                     num_layers=LLAMA4_LAYERS)
    name = f"{cfg.name} ({cfg.num_layers} layers)"
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=seed)
    sync(torch, dev)
    log(f"[llama4] {name}: {count_params(model.param_specs()) / 1e9:.3f} B "
        f"params ({cfg.dtype}) drawn on {dev} in "
        f"{time.perf_counter() - t0:.2f} s, {card_gib(torch, dev):.2f} GiB "
        f"(peak {card_gib(torch, dev, peak=True):.2f})")
    rng = np.random.default_rng(seed)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (batch, prompt_len)), device=dev)
    kernel_vs_plain(torch, model, {"tokens": tokens}, "flash_attention",
                    prompt_len + steps)                     # warm-up
    sync(torch, dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    logits, logits_p, routes = kernel_vs_plain(
        torch, model, {"tokens": tokens}, "flash_attention",
        prompt_len + steps)
    sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = ops.launches()
    L = cfg.num_layers
    expect = {"flash_attention": L, "flash_attention_tc": L,
              "flash_attention_scalar": 0, "flash_attention_bwd": 0,
              "wkv6": 0, "wkv6_seq": 0}
    check(launches == expect, f"{name}: kernel launches {launches}, "
          f"expected {expect} (one prefill through the kernel)")
    check(len(routes) == sum(cfg.is_moe_layer(i) for i in range(L)) >= 1,
          f"{name}: {len(routes)} MoE layers ran")
    a, b = logits.float(), logits_p.float()
    check(bool(torch.isfinite(a).all() and torch.isfinite(b).all()),
          f"{name}: non-finite prefill logits")
    rel = rel_l2(a, b)
    log_routes(name, routes)
    check(rel < REL_L2_TOL, f"{name}: kernel vs plain prefill logits "
          f"relative error {rel:.3g} >= {REL_L2_TOL}")
    log(f"[llama4] {name}: prefill {batch} x {prompt_len} tokens, kernel "
        f"and plain passes in {wall:.3f} s; launches {launches} (= {L} "
        f"layers x 1 prefill); kernel vs plain logits relative L2 error "
        f"{rel:.3g} (< {REL_L2_TOL}), max |err| "
        f"{float((a - b).abs().max()):.3g} of max |logit| "
        f"{float(b.abs().max()):.3g}; all finite")
    with torch.inference_mode():
        state = model.init_state(batch, prompt_len + steps)
        logits, state = model.prefill({"tokens": tokens}, state)
        tok = logits.argmax(-1)
        sync(torch, dev)
        t0 = time.perf_counter()
        for step in range(steps):
            logits, state = model.decode_step(tok, prompt_len + step, state)
            check(bool(torch.isfinite(logits.float()).all()),
                  f"{name}: non-finite logits at decode step {step}")
            tok = logits.argmax(-1)
        sync(torch, dev)
        step_ms = (time.perf_counter() - t0) / steps * 1e3
    log(f"[llama4] {name}: {steps} decode steps (C = 1: every expert's "
        f"weights read a step) finite, {step_ms:.3f} ms a step; peak "
        f"{card_gib(torch, dev, peak=True):.2f} GiB on {card}")
    shapes = dict(B=batch, T=prompt_len, d=cfg.d_model, H=cfg.num_heads,
                  G=cfg.num_kv_heads, D=cfg.head_dim, N=cfg.rwkv_head_dim,
                  dtype=cfg.compute_dtype)
    del model, state, logits, logits_p, tokens, routes
    free_card(torch, dev)
    return dict(kernel="flash_attention", launches=launches, shapes=shapes)


def kernel_vs_plain(torch, model, batch, kernel, max_len, pin=False):
    """One prefill of ``batch`` through the path's kernel and one with the
    model-side entry point swapped for the plain version (the package has
    no switch for it): (logits, plain logits, per-MoE-layer pairs of
    expert ids, empty for a dense model).  With ``pin`` the plain pass
    takes the kernel pass's experts (``with_routes``)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rwkv6_scan as wk
    B = batch["tokens"].shape[0]
    plain = fa.attention_ref if kernel == "flash_attention" \
        else wk.wkv6_scan_ref
    with torch.inference_mode():
        (logits, _), ids = with_routes(torch, lambda: model.prefill(
            batch, new_state(model, B, max_len, batch)))
        original = getattr(ops, kernel)
        setattr(ops, kernel, plain)
        try:
            (logits_p, _), ids_p = with_routes(
                torch, lambda: model.prefill(
                    batch, new_state(model, B, max_len, batch)),
                replay=ids if pin else None)
        finally:
            setattr(ops, kernel, original)
    return logits, logits_p, list(zip(ids, ids_p))


def rel_l2(a, b) -> float:
    """Relative L2 error of ``a`` against ``b``, in float32."""
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def moe_account(torch, model, batch, kernel, max_len):
    """Kernel vs plain prefill logits of a MoE model over its first n
    layers (the same weights), for each n in ``MOE_DEPTHS`` it has and its
    full depth: {n: (relative L2 with the routes free, relative L2 with
    the plain pass on the kernel pass's experts)}."""
    out = {}
    L = len(model.plans)
    for n in sorted({n for n in MOE_DEPTHS if n < L} | {L}):
        with first_layers(model, n):
            out[n] = tuple(rel_l2(*kernel_vs_plain(
                torch, model, batch, kernel, max_len, pin=pin)[:2])
                for pin in (False, True))
    return out


def log_routes(name, routes):
    """Logs the share of (token, k) routes the kernel's pass and the plain
    pass agree on: the first MoE layer's, the least, and every layer's."""
    shares = [float((a == b).float().mean()) for a, b in routes]
    worst = min(range(len(shares)), key=shares.__getitem__)
    log(f"[serve] {name}: MoE routes, kernel vs plain pass: first MoE "
        f"layer {shares[0]:.4%} of {routes[0][0].numel()} (token, k) "
        f"routes agree; least {shares[worst]:.4%} at MoE layer {worst}; "
        f"all {len(shares)} layers "
        f"{' '.join(f'{x:.3f}' for x in shares)}")


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
                state = new_state(model, slots, max_len, batch)
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
    if cfg.frontend:
        gen = torch.Generator(device=dev).manual_seed(seed)
        first["frontend_embeds"] = torch.randn(
            (slots, cfg.frontend_len, cfg.d_model), generator=gen,
            device=dev).to(cfg.compute_dtype)
    # a vision-language model's patches come first in the self caches
    start = prompt_len + (cfg.frontend_len if cfg.frontend == "vision"
                          else 0)

    def window():
        with torch.inference_mode():
            st = new_state(model, slots, start + steps, first)
            lg, st = model.prefill(first, st)
            tok = lg.argmax(-1)
            sync(torch, dev)
            t0 = time.perf_counter()
            for step in range(steps):
                lg, st = model.decode_step(tok, start + step, st)
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
    if "rec" in cfg.block_pattern:
        rec_shares(torch, model, first, dev)
    del model, first
    free_card(torch, dev)


def rec_shares(torch, model, batch, dev="cuda"):
    """The RG-LRU scan's and the float32 gate products' share of a prefill
    wave of ``batch``: each timed alone (CUDA events) at the wave's shapes
    on the first RG-LRU layer's weights, times the RG-LRU layers, over
    the wave's time (host clock around a synchronized prefill, the mean
    of three).  The scan's and the products' kernels are PyTorch's own
    (elementwise and fp32 GEMM), which the profile's names do not tell
    apart from the rest of the model's."""
    from repro_torch.models import recurrent as R
    cfg = model.cfg
    B, T = batch["tokens"].shape
    rec = [i for i, plan in enumerate(model.plans) if plan.kind == "rec"]
    p = model.blocks[rec[0]]["rec"]
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((B, T, cfg.lru_width), generator=gen, device=dev)
    with torch.inference_mode():
        log_a, gated = R._rglru_gates(p, x)
        scan_ms = time_ms(torch, lambda: R.rglru_scan(log_a, gated, None),
                          iters=10, warmup=2)
        gate_ms = time_ms(torch, lambda: (x @ p["w_a"], x @ p["w_x"]),
                          iters=10, warmup=2)
        secs = []
        for _ in range(3):
            state = model.init_state(B, T)
            sync(torch, dev)
            t0 = time.perf_counter()
            model.prefill(batch, state)
            sync(torch, dev)
            secs.append(time.perf_counter() - t0)
            del state
    wave_ms = sum(secs) / len(secs) * 1e3
    # the scan as training runs it: inputs that want a gradient make its
    # rounds write new tensors (torch.cat) in place of in-place updates
    with torch.inference_mode(False), torch.enable_grad():
        with torch.no_grad():
            log_a_g, gated_g = (t.clone() for t in R._rglru_gates(p, x))
        log_a_g.requires_grad_()
        gated_g.requires_grad_()
        grad_scan_ms = time_ms(torch, lambda: R.rglru_scan(
            log_a_g, gated_g, None), iters=10, warmup=2)
    del log_a_g, gated_g
    flops = 2 * 2 * B * T * cfg.lru_width ** 2
    log(f"[profile] {cfg.name}: prefill wave {B} x {T} {wave_ms:.3f} ms; "
        f"RG-LRU scan {scan_ms:.4f} ms a layer x {len(rec)} layers = "
        f"{len(rec) * scan_ms / wave_ms:.1%} of it; fp32 gate products "
        f"(x @ w_a, x @ w_x; {flops:.3g} flops, "
        f"{flops / gate_ms / 1e9:.1f} TFLOP/s) {gate_ms:.4f} ms a layer x "
        f"{len(rec)} = {len(rec) * gate_ms / wave_ms:.1%} of it")
    log(f"[profile] {cfg.name}: the RG-LRU scan at the wave's shape, "
        f"in-place rounds (serving) {scan_ms:.4f} ms, new tensors a round "
        f"with autograd recording (training) {grad_scan_ms:.4f} ms: "
        f"{len(rec) * (grad_scan_ms - scan_ms) / wave_ms:+.1%} of the wave "
        f"if serving took the training rounds")
    del x, log_a, gated
    return dict(wave_ms=wave_ms, scan_ms=scan_ms, gate_ms=gate_ms,
                grad_scan_ms=grad_scan_ms, layers=len(rec))


def time_lm_kernel(torch, kernel, shapes, errs, seed, dev="cuda",
                   name=None, scalar_entry=None):
    """The kernel at the shapes its path gave it: held against its plain
    version, then timed beside the plain version, the library call (SDPA
    for attention, none for WKV6) and its bound; ``name`` is its record
    entry (default ``kernel``).  For attention, also the scalar kernel on
    the same bf16 inputs (the kernel this path ran before the tensor-core
    one: ``earlier_ms``) and, with ``scalar_entry`` (the name of its
    record entry), as its own entry under ``"scalar"``, on fp32 inputs of
    the same shape, its dtype."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rwkv6_scan as wk
    name = name or kernel
    sh = shapes
    B, T, dt = sh["B"], sh["T"], sh["dtype"]
    if kernel == "flash_attention":
        # a causal call covers one sequence (Tk = T); a bidirectional one
        # may read another (the encoder-decoder's cross attention)
        H, G, D = sh["H"], sh["G"], sh["D"]
        Tk, causal = sh.get("Tk", T), sh.get("causal", True)
        shape = (B, T, Tk, H, G, D)
        q, k, v = attn_inputs(torch, B, T, H, G, D, dt, seed, dev, Tk=Tk)
        err = check_attention(torch, q, k, v, causal, None,
                              f"path shape {shape}", errs, name)
        log(f"[lm-parity] flash attention bfloat16 (tc) at the path shape "
            f"B={B} Tq={T} Tk={Tk} H={H} G={G} D={D} causal={causal}: "
            f"max |err| {err:.3g} ok")
        sdpa = torch.nn.functional.scaled_dot_product_attention
        # the (query, key) pairs the mask lets through
        pairs = B * H * T * (T + 1) // 2 if causal else B * H * T * Tk
        n_elems = 2 * B * T * H * D + 2 * B * Tk * G * D

        def timed(q, k, v, kind, ops_per_s):
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            out = dict(
                ms=time_ms(torch, lambda: fa._launch(q, k, v, causal, None,
                                                     kind),
                           iters=50 if kind == "tc" else 10, warmup=3),
                plain_ms=time_ms(torch, lambda: fa.attention_ref(
                    q, k, v, causal=causal), iters=5, warmup=1),
                library_ms=time_ms(torch, lambda: sdpa(
                    qt, kt, vt, is_causal=causal, enable_gqa=True),
                    iters=50, warmup=3),
                bound=bound_ms(q.element_size() * n_elems, 4 * D * pairs,
                               ops_per_s))
            del qt, kt, vt
            return out

        r = timed(q, k, v, "tc", BF16_FLOPS_PER_S)
        r["earlier_ms"] = time_ms(torch, lambda: fa._launch(
            q, k, v, causal, None, "scalar"), iters=10, warmup=2)
        what = (f"B={B} Tq={T} Tk={Tk} H={H} G={G} D={D} "
                f"{'causal' if causal else 'bidirectional'} bf16")
    if kernel == "flash_attention" and scalar_entry:
        q32, k32, v32 = (x.float() for x in (q, k, v))
        err = check_attention(torch, q32, k32, v32, causal, None,
                              f"path shape {shape} fp32", errs,
                              scalar_entry)
        log(f"[lm-parity] flash attention float32 (scalar) at the path "
            f"shape: max |err| {err:.3g} ok")
        # the scalar kernel's fp32 FMAs: the fp32 peak off the tensor cores
        r["scalar"] = timed(q32, k32, v32, "scalar", FP32_FLOPS_PER_S)
        del q32, k32, v32
        sc = r["scalar"]
        log(f"[time] {scalar_entry}: kernel {sc['ms']:.4f} ms, "
            f"plain {sc['plain_ms']:.4f} ms, library "
            f"{sc['library_ms']:.4f} ms, bound {sc['bound'][0]:.5f} ms "
            f"({sc['bound'][1]}) at {what.replace('bf16', 'fp32')}")
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


def time_encdec_kernels(torch, cfg, run, errs, seed, dev="cuda"):
    """The encoder-decoder's kernel at each of its four shapes
    (``ENCDEC_MODES``), timed by ``time_lm_kernel``; each entry keeps its
    shape's launches on the served path, the encoder's entry the first
    wave's prefill in turns, and the log the kernel's share of that wave.
    Returns {record entry: run}."""
    out = {}
    for entry, (shapes, n) in run["modes"].items():
        out[entry] = dict(run, entry_launches=n, times=time_lm_kernel(
            torch, run["kernel"], shapes, errs, seed, dev=dev, name=entry))
    w = run["waves"]
    out["flash_attention_enc"]["times"].update(
        wave_ms=w["tc"] * 1e3, wave_earlier_ms=w["scalar"] * 1e3)
    per_wave = {e: n // run["prefills"] for e, (_, n) in run["modes"].items()
                if ENCDEC_MODES[e][1] == "prefill"}
    ms = sum(k * out[e]["times"]["ms"] for e, k in per_wave.items())
    ms_earlier = sum(k * out[e]["times"]["earlier_ms"]
                     for e, k in per_wave.items())
    log(f"[serve] {cfg.name}: attention " + " + ".join(
        f"{k} x {out[e]['times']['ms']:.4f} ms ({e})"
        for e, k in per_wave.items())
        + f" = {ms / (w['tc'] * 1e3):.1%} of a {w['tc'] * 1e3:.3f} ms "
        f"prefill wave (scalar kernel: "
        f"{ms_earlier / (w['scalar'] * 1e3):.1%} of "
        f"{w['scalar'] * 1e3:.3f} ms)")
    return out


# --- phase 9: training --------------------------------------------------------

#: what the backward kernel replaces: XLA's autodiff of the reference's
#: chunked jnp attention in the train step (no Pallas kernel)
TRAIN_REPLACES = "src/repro/models/layers.py:132"
#: the training run: qwen3-1.7b at full width and depth, the serving cells'
#: batch of 4 x 1,024 tokens, the reference's TrainConfig defaults (AdamW,
#: remat), the head over vocabulary chunks of 16,384 (151,936 is no
#: multiple: the last chunk is padded), a checkpoint after step 5
TRAIN_ARCH, TRAIN_B, TRAIN_T, TRAIN_STEPS = "qwen3-1.7b", 4, 1024, 10
TRAIN_VOCAB_CHUNK, TRAIN_CKPT_STEP, TRAIN_RESUMED = 16_384, 5, 2
#: the backward kernel's checks: (B, Tq, Tk, H, G, causal, window) at
#: every head size, both dtypes: causal, a window, bidirectional with
#: Tq != Tk (Tq > Tk with a window leaves rows fully masked), GQA R = 1,
#: 2, 4 and 48, ragged T, Tq = 1 and Tq = Tk = 1
BWD_CASES = [(2, 128, 128, 4, 4, True, None), (2, 130, 130, 4, 2, True, None),
             (1, 100, 100, 8, 2, True, 16), (2, 37, 53, 4, 4, False, None),
             (1, 100, 37, 4, 2, False, 8), (2, 1, 130, 4, 1, False, None),
             (1, 70, 70, 48, 1, True, None), (1, 1, 1, 4, 4, True, None)]
#: each of dq, dk and dv within this relative L2 of the plain version
BWD_LIMIT = {"float32": 1e-5, "bfloat16": 1e-2}
#: the planted fault: the plain version with the last key block's
#: contribution dropped (64 keys, the kernel's tile up to D = 160), which
#: the check above must refuse
BWD_FAULT_KEYS = 64
#: full-width kernel-vs-plain gradients over the whole gradient: bf16 over
#: every layer, fp32 over 4
TRAIN_GRAD_L2 = {"bfloat16": 0.1, "float32": 1e-3}
#: and each leaf's own relative L2 (a leaf whose plain gradient is zero
#: is held to zero).  The whole gradient cannot see a fault in one layer
#: of 28: with the last layer's last key tile dropped it moves by 0.0149
#: against 0.0089 of bf16 rounding, while that layer's worst leaf moves
#: by 0.11 against at most 0.023 (NVIDIA H100 80GB HBM3, 700 W)
TRAIN_LEAF_L2 = {"bfloat16": 0.05, "float32": 1e-4}
#: the backward's shapes on seamless-m4t-large-v2's training step (B, Tq,
#: Tk, H, G, D, causal): the encoder over the frames, the decoder's
#: self-attention, its cross-attention over the frames
ENCDEC_BWD_SHAPES = [(2, 4096, 4096, 16, 16, 64, False),
                     (2, 512, 512, 16, 16, 64, True),
                     (2, 512, 4096, 16, 16, 64, False)]
#: the encoder-decoder's one training step: 2 + 2 layers at full width,
#: 4,096 source frames, 512 target tokens a sequence
ENCDEC_TRAIN = dict(layers=2, B=2, T=512, frames=4096)


def bwd_rel(torch, got, want, floor):
    """Relative L2 of a gradient; where the true gradient vanishes (dq
    and dk at Tq = Tk = 1, where the softmax is constant) against
    ``floor``, dv's norm."""
    got, want = got.double(), want.double()
    denom = float(want.norm())
    if denom < 1e-6 * floor:
        denom = floor
    return float((got - want).norm()) / denom


def planted_fault(torch, bwd, q, k, v, o, do, causal, window):
    """``bwd`` (the plain version or the kernel's launch) with the last
    :data:`BWD_FAULT_KEYS` keys' contribution dropped: dk and dv of those
    keys left zero, and for a causal call the rows that see them too."""
    cut = k.shape[1] - BWD_FAULT_KEYS
    if causal:
        f = list(bwd(*(t[:, :cut].contiguous() for t in (q, k, v, o, do)),
                     causal, window))
        f[0] = torch.cat([f[0], torch.zeros_like(q[:, cut:])], 1)
    else:
        f = list(bwd(q, k[:, :cut].contiguous(), v[:, :cut].contiguous(),
                     o, do, causal, window))
    for j in (1, 2):
        f[j] = torch.cat([f[j], torch.zeros_like(k[:, cut:])], 1)
    return f


def plain_bwd(q, k, v, o, do, causal, window):
    from repro_torch.kernels import flash_attention as fa
    return fa.attention_bwd_ref(q, k, v, o, do, causal=causal, window=window)


def hold_bwd(torch, got, want, dtype, label):
    """(dq, dk, dv) against the plain version's, each within
    :data:`BWD_LIMIT`: returns the largest relative L2 and max |err|."""
    name = str(dtype).split(".")[-1]
    limit, floor = BWD_LIMIT[name], float(want[2].double().norm())
    worst = worst_abs = 0.0
    for gname, g, w in zip(("dq", "dk", "dv"), got, want):
        check(g.dtype == dtype and g.shape == w.shape,
              f"backward {name} {label}: {gname} {g.dtype} "
              f"{tuple(g.shape)}")
        rel = bwd_rel(torch, g, w, floor)
        check(rel < limit, f"backward {name} {label}: {gname} relative L2 "
              f"{rel:.3g} >= {limit}")
        worst = max(worst, rel)
        worst_abs = max(worst_abs, max_err(torch, g.float(), w.float()))
    return worst, worst_abs


def check_attention_bwd(torch, seed, dev="cuda"):
    """The backward kernel against ``attention_bwd_ref`` at every head size
    and case of :data:`BWD_CASES`, in fp32 and bf16, with a planted fault
    the check must catch.  Returns the largest max |err|."""
    from repro_torch.kernels import flash_attention as fa
    worst_abs, worst = 0.0, {}
    n_caught = 0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        limit = BWD_LIMIT[name]
        for D in fa.HEAD_DIMS:
            for i, (B, Tq, Tk, H, G, causal, window) in enumerate(BWD_CASES):
                gen = torch.Generator(device=dev).manual_seed(seed + D + i)
                q, do = (torch.randn((B, Tq, H, D), generator=gen,
                                     device=dev).to(dtype)
                         for _ in range(2))
                k, v = (torch.randn((B, Tk, G, D), generator=gen,
                                    device=dev).to(dtype) for _ in range(2))
                o = fa.attention_ref(q, k, v, causal=causal,
                                     window=window).contiguous()
                before = fa.LAUNCHES["flash_attention_bwd"]
                got = fa._launch_bwd(q, k, v, o, do, causal, window)
                check(fa.LAUNCHES["flash_attention_bwd"] == before + 1,
                      "the backward kernel did not launch once")
                want = plain_bwd(q, k, v, o, do, causal, window)
                sync(torch, dev)
                case = (B, Tq, Tk, H, G, D, causal, window)
                rel, err = hold_bwd(torch, got, want, dtype, case)
                worst[name] = max(worst.get(name, 0.0), rel)
                worst_abs = max(worst_abs, err)
                if Tk > 2 * BWD_FAULT_KEYS and D in (64, 128):
                    floor = float(want[2].double().norm())
                    f = planted_fault(torch, plain_bwd, q, k, v, o, do,
                                      causal, window)
                    rels = [bwd_rel(torch, a, w, floor)
                            for a, w in zip(f, want)]
                    check(max(rels) >= limit, f"backward {name} {case}: "
                          f"the planted fault passes the check ({rels})")
                    n_caught += 1
                    log(f"[train] planted fault {name} {case}: the last "
                        f"{BWD_FAULT_KEYS} keys dropped -> relative L2 "
                        f"dq {rels[0]:.3g} dk {rels[1]:.3g} dv "
                        f"{rels[2]:.3g} (caught: >= {limit})")
        log(f"[train] backward kernel {name}: {len(BWD_CASES)} cases x "
            f"{len(fa.HEAD_DIMS)} head sizes within relative L2 {limit} "
            f"(worst {worst[name]:.3g})")
    check(n_caught > 0, "no planted fault was checked")
    return worst_abs


def check_attention_bwd_path_shapes(torch, seed, dev="cuda"):
    """The backward kernel against its plain version at the shapes the
    training path gives it beyond :func:`time_attention_bwd`'s:
    seamless-m4t-large-v2's three (:data:`ENCDEC_BWD_SHAPES`) in bf16 and
    fp32, and qwen3-1.7b's in fp32.  Returns the largest max |err|."""
    from repro_torch.kernels import flash_attention as fa
    shapes = [(dt, s) for s in ENCDEC_BWD_SHAPES
              for dt in (torch.bfloat16, torch.float32)]
    shapes.append((torch.float32, (TRAIN_B, TRAIN_T, TRAIN_T, 16, 8, 128,
                                   True)))
    worst_abs = 0.0
    for dtype, (B, Tq, Tk, H, G, D, causal) in shapes:
        q, k, v = attn_inputs(torch, B, Tq, H, G, D, dtype, seed, dev, Tk=Tk)
        o = fa._launch(q, k, v, causal, None)
        do = torch.randn_like(q)
        got = fa._launch_bwd(q, k, v, o, do, causal, None)
        want = plain_bwd(q, k, v, o, do, causal, None)
        sync(torch, dev)
        label = (B, Tq, Tk, H, G, D, causal)
        rel, err = hold_bwd(torch, got, want, dtype, label)
        worst_abs = max(worst_abs, err)
        log(f"[train] backward at the path's shape {label} "
            f"{str(dtype).split('.')[-1]}: relative L2 {rel:.3g} (limit "
            f"{BWD_LIMIT[str(dtype).split('.')[-1]]}), max |err| {err:.3g}")
        del q, k, v, o, do, got, want
    return worst_abs


def time_attention_bwd(torch, seed, dev="cuda"):
    """The backward kernel at qwen3-1.7b's training shape (bf16), held
    against its plain version on the same inputs: its time, the plain
    version's, SDPA's backward alone (``enable_gqa``, the forward outside
    the timed region) and the bound."""
    from repro_torch.kernels import flash_attention as fa
    cfg_B, T, H, G, D = TRAIN_B, TRAIN_T, 16, 8, 128
    q, k, v = attn_inputs(torch, cfg_B, T, H, G, D, torch.bfloat16, seed,
                          dev)
    o = fa._launch(q, k, v, True, None)
    do = torch.randn_like(q)
    rel, err = hold_bwd(torch, fa._launch_bwd(q, k, v, o, do, True, None),
                        plain_bwd(q, k, v, o, do, True, None),
                        torch.bfloat16, (cfg_B, T, T, H, G, D, True))
    ms = time_ms(torch, lambda: fa._launch_bwd(q, k, v, o, do, True, None),
                 iters=50, warmup=3)
    plain_ms = time_ms(torch, lambda: fa.attention_bwd_ref(
        q, k, v, o, do, causal=True), iters=10, warmup=2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    out = sdpa(qs, ks, vs, is_causal=True, enable_gqa=True)
    dos = do.transpose(1, 2)
    library_ms = time_ms(torch, lambda: torch.autograd.grad(
        out, (qs, ks, vs), dos, retain_graph=True), iters=50, warmup=3)
    del out
    # five products of 2 B H T T D, halved by the causal mask; q, k, v, o
    # and dO read once, dq, dk, dv written once
    flops = 5 * 2 * cfg_B * H * T * T * D / 2
    n_bytes = 2 * (4 * cfg_B * T * H * D + 4 * cfg_B * T * G * D)
    bound = bound_ms(n_bytes, flops, BF16_FLOPS_PER_S)
    log(f"[time] flash_attention_bwd (B={cfg_B} T={T} H={H} G={G} D={D} "
        f"causal, bf16): {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
        f"backward {library_ms:.4f} ms, bound {bound[0]:.5f} ms "
        f"({bound[1]}); {ms / bound[0]:.1f} x the bound; against the "
        f"plain version relative L2 {rel:.3g}, max |err| {err:.3g}")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound": bound, "err": err}


def train_flops(cfg, B, T) -> float:
    """A training step's model FLOPs: 6 per weight of every matrix product
    a token passes (the layers' projections and the head) and three
    times the causal attention's forward products (remat's recompute not
    counted)."""
    d, H, G, D = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    per_layer = d * (H + 2 * G) * D + H * D * d + 3 * d * cfg.d_ff
    n_mm = cfg.num_layers * per_layer + d * cfg.vocab_size
    attn = 3 * cfg.num_layers * 4 * B * H * T * T * D / 2
    return 6 * n_mm * B * T + attn


@contextlib.contextmanager
def plain_attention():
    """The model-side attention swapped for its plain version (the package
    has no switch for it): autograd then differentiates
    ``attention_ref``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    original = ops.flash_attention
    ops.flash_attention = fa.attention_ref
    try:
        yield
    finally:
        ops.flash_attention = original


@contextlib.contextmanager
def faulty_backward(torch, layer_call=0):
    """The backward kernel with :func:`planted_fault` in one layer: the
    ``layer_call``-th launch of a backward pass (0: the last layer's)
    drops its last key tile."""
    from repro_torch.kernels import flash_attention as fa
    original, calls = fa._launch_bwd, [0]

    def launch(q, k, v, o, do, causal, window):
        calls[0] += 1
        if calls[0] - 1 != layer_call:
            return original(q, k, v, o, do, causal, window)
        return tuple(planted_fault(torch, original, q, k, v, o, do, causal,
                                   window))
    fa._launch_bwd = launch
    try:
        yield calls
    finally:
        fa._launch_bwd = original


def grads_kernel_vs_plain(torch, model, params, batch, label, limit,
                          leaf_limit, fault=False):
    """One step's gradients with the kernels and with plain attention on
    the same weights and batch: relative L2 over the whole gradient
    (checked against ``limit``) and each leaf's (against ``leaf_limit``).
    With ``fault`` the kernels' gradients are taken once more with
    :func:`faulty_backward`, and the check must refuse them.  Returns the
    whole gradient's relative L2."""
    names = list(params)

    def grads():
        loss, _ = model.loss(batch)
        return torch.autograd.grad(loss, [params[n] for n in names])

    def gaps(g_a, g_b):
        num = sum(float((a.float() - b.float()).square().sum())
                  for a, b in zip(g_a, g_b))
        den = sum(float(b.float().square().sum()) for b in g_b)
        leaf = max(((rel_l2(a, b) if float(b.float().norm()) > 0 else
                     float(a.float().norm()), n)
                    for n, a, b in zip(names, g_a, g_b)))
        return (num / den) ** 0.5, leaf
    with plain_attention():
        g_plain = grads()
    g_kernel = grads()
    rel, leaf = gaps(g_kernel, g_plain)
    del g_kernel
    log(f"[train] {label}: kernel vs plain gradients relative L2 {rel:.4g} "
        f"over the whole gradient (limit {limit}); worst leaf {leaf[1]} "
        f"{leaf[0]:.4g} (limit {leaf_limit})")
    check(rel < limit, f"{label}: gradients relative L2 {rel:.4g} >= "
          f"{limit}")
    check(leaf[0] < leaf_limit, f"{label}: leaf {leaf[1]} relative L2 "
          f"{leaf[0]:.4g} >= {leaf_limit}")
    if fault:
        with faulty_backward(torch) as calls:
            g_fault = grads()
        check(calls[0] > 1, f"{label}: the backward launched {calls[0]} "
              f"times under the planted fault")
        f_rel, f_leaf = gaps(g_fault, g_plain)
        del g_fault
        caught = f_rel >= limit or f_leaf[0] >= leaf_limit
        log(f"[train] {label}, planted fault (the last layer's last "
            f"{BWD_FAULT_KEYS} keys dropped): relative L2 {f_rel:.4g} over "
            f"the whole gradient ({'caught' if f_rel >= limit else 'passes'}"
            f" at {limit}); worst leaf {f_leaf[1]} {f_leaf[0]:.4g} "
            f"({'caught' if f_leaf[0] >= leaf_limit else 'passes'} at "
            f"{leaf_limit})")
        check(caught, f"{label}: the planted fault passes the gradient "
              f"checks")
    del g_plain
    return rel


def phase_train(torch, np, seed, card, dev="cuda", cfg=None, B=TRAIN_B,
                T=TRAIN_T, steps=TRAIN_STEPS, ckpt_step=TRAIN_CKPT_STEP,
                vocab_chunk=TRAIN_VOCAB_CHUNK, encdec_cfg=None,
                encdec=ENCDEC_TRAIN, rwkv_cfg=None):
    """Training on the card: the backward kernel against its plain
    version; qwen3-1.7b for ``steps`` steps through ``make_train_step``
    and ``train_loop`` (falling loss, exact launch counts each step, step
    time, tokens/s, TFLOP/s, peak memory, the backward's share), with a
    checkpoint after ``ckpt_step`` that a new model and optimizer restore
    and continue from; full-width kernel-vs-plain gradients in bf16 and
    in fp32 over 4 layers; seamless-m4t-large-v2's step over its
    bidirectional and cross attention; rwkv6-3b's refusal.  Returns the
    record entry's numbers."""
    import shutil
    from repro_torch import configs
    from repro_torch.data import pipeline
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import NotPortedError, build_model
    from repro_torch.models import settings as msettings
    from repro_torch.models.types import ShapeSpec
    from repro_torch.obs import MetricsRegistry
    from repro_torch.train.checkpoint import Checkpointer
    from repro_torch.train.train_loop import (TrainConfig, make_train_step,
                                              to_device, train_loop,
                                              trainable_params)
    on_card = torch.device(dev).type == "cuda"
    check(fa.LAUNCHES["flash_attention_bwd"] == 0,
          "the backward kernel launched before the training phase")
    err = check_attention_bwd(torch, seed, dev)
    times = None
    if on_card:
        err = max(err, check_attention_bwd_path_shapes(torch, seed, dev))
        times = time_attention_bwd(torch, seed, dev)
        err = max(err, times.pop("err"))
    cfg = cfg or configs.get(TRAIN_ARCH)
    L = cfg.num_layers
    stream = pipeline.for_model(cfg, ShapeSpec("train", T, B, "train"),
                                seed=seed)
    tcfg = TrainConfig()
    ckpt_dir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ck = Checkpointer(str(ckpt_dir), keep=1)

    def trainer(model):
        params = trainable_params(model)
        step_fn, opt = make_train_step(model, tcfg)
        counted = []

        def counting_step(p, s, batch):
            fa.reset_launches()
            out = step_fn(p, s, batch)
            counted.append((fa.LAUNCHES["flash_attention"],
                            fa.LAUNCHES["flash_attention_bwd"]))
            return out
        return params, opt.init(params), counting_step, counted

    def loop(model, params, state, step_fn, start, stop, **kw):
        batches = pipeline.PrefetchIterator(stream, start_step=start,
                                            device=model.device)
        try:
            with msettings.use(vocab_chunk=vocab_chunk):
                return train_loop(model, tcfg, params, state, batches,
                                  steps=stop, log_every=0, start_step=start,
                                  train_step=step_fn, **kw)
        finally:
            batches.close()

    # the uninterrupted run: a checkpoint after step ckpt_step
    free_card(torch, dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=seed)
    sync(torch, dev)
    t_init = time.perf_counter() - t0
    params, state, step_fn, counted = trainer(model)
    reg = MetricsRegistry()
    params, state, hist_a = loop(model, params, state, step_fn, 0,
                                 ckpt_step, checkpointer=ck,
                                 checkpoint_every=ckpt_step, obs=reg)
    t0 = time.perf_counter()
    ck.wait()
    t_save = time.perf_counter() - t0
    params, state, hist_b = loop(model, params, state, step_fn, ckpt_step,
                                 steps, obs=reg)
    losses = hist_a["loss"] + hist_b["loss"]
    step_s = hist_a["step_time"] + hist_b["step_time"]
    peak = card_gib(torch, dev, peak=True)
    check(len(losses) == steps and reg.histogram("train.step").count
          == steps, f"{len(losses)} steps recorded of {steps}")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    if on_card:
        check(counted == [(2 * L, L)] * steps, f"launches (forward, "
              f"backward) a step {counted}, expected {(2 * L, L)}: {L} "
              f"layers and their recompute, {L} backward")
    n_bwd = sum(c[1] for c in counted)
    med_s = sorted(step_s[1:])[len(step_s[1:]) // 2]
    flops = train_flops(cfg, B, T)
    log(f"[train] {cfg.name} ({L} layers, d_model {cfg.d_model}, "
        f"{sum(p.numel() for p in params.values()) / 1e9:.3f} B params, "
        f"{cfg.dtype}) on {card}: {steps} steps of {B} x {T} tokens, "
        f"AdamW (TrainConfig defaults), remat, vocab_chunk {vocab_chunk}; "
        f"init {t_init:.2f} s")
    log(f"[train] loss by step {[round(x, 4) for x in losses]}")
    log(f"[train] step ms {[round(s * 1e3, 2) for s in step_s]} (the "
        f"first builds and warms up); median after the first "
        f"{med_s * 1e3:.3f} ms, {B * T / med_s:,.1f} tokens/s, "
        f"{flops / med_s / 1e12:.1f} TFLOP/s (6 N + attention: "
        f"{flops / 1e12:.2f} TFLOP a step), peak {peak:.2f} GiB; "
        f"launches a step: forward {counted[0][0]}, backward "
        f"{counted[0][1]}; the checkpoint's write waited {t_save:.2f} s")
    share = None
    if times is not None:
        share = L * times["ms"] / (med_s * 1e3)
        log(f"[train] the backward kernel's share of a step: {L} x "
            f"{times['ms']:.4f} ms = {share:.1%} of {med_s * 1e3:.3f} ms")
    # full-width gradients, kernel against plain, on the trained weights
    batch = to_device(stream.batch_at(steps), model.device)
    with msettings.use(vocab_chunk=vocab_chunk):
        rel_bf16 = grads_kernel_vs_plain(
            torch, model, params, batch, f"{cfg.name} {cfg.dtype} {L} "
            f"layers", TRAIN_GRAD_L2[cfg.dtype], TRAIN_LEAF_L2[cfg.dtype],
            fault=on_card)
    del model, params, state, step_fn
    free_card(torch, dev)

    # a new model and optimizer from the checkpoint: the next steps
    model = build_model(cfg, device=dev, seed=seed + 1)
    params, state, step_fn, _ = trainer(model)
    check(ck.restore_into(params, state) == ckpt_step,
          "the checkpoint restored another step")
    n_more = min(TRAIN_RESUMED, steps - ckpt_step)
    _, _, hist_c = loop(model, params, state, step_fn, ckpt_step,
                        ckpt_step + n_more)
    resumed = hist_c["loss"]
    want = losses[ckpt_step:ckpt_step + n_more]
    rels = [abs(a - b) / abs(b) for a, b in zip(resumed, want)]
    check(max(rels) <= 1e-5, f"resumed losses {resumed} against {want}")
    log(f"[train] restored step {ckpt_step} into a new model and "
        f"optimizer: losses {resumed} against {want} (relative "
        f"{max(rels):.3g}; bitwise: {resumed == want})")
    del model, params, state, step_fn
    free_card(torch, dev)
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    # fp32 over 4 layers
    cfg4 = dataclasses.replace(cfg, num_layers=min(4, L), dtype="float32")
    model = build_model(cfg4, device=dev, seed=seed)
    params = trainable_params(model)
    batch = to_device(stream.batch_at(0), model.device)
    with msettings.use(vocab_chunk=vocab_chunk):
        rel_fp32 = grads_kernel_vs_plain(
            torch, model, params, batch, f"{cfg.name} float32 "
            f"{cfg4.num_layers} layers", TRAIN_GRAD_L2["float32"],
            TRAIN_LEAF_L2["float32"])
    del model, params
    free_card(torch, dev)

    # the encoder-decoder: bidirectional and cross backward on its path
    ecfg = encdec_cfg or configs.get("seamless-m4t-large-v2")
    ecfg = dataclasses.replace(ecfg, num_layers=encdec["layers"],
                               encoder_layers=encdec["layers"])
    eB, eT, eF = encdec["B"], encdec["T"], encdec["frames"]
    rng = np.random.default_rng(seed + 9)
    ebatch = {"tokens": rng.integers(0, ecfg.vocab_size, (eB, eT)).astype(
                  np.int32),
              "labels": rng.integers(0, ecfg.vocab_size, (eB, eT)).astype(
                  np.int32),
              "frontend_embeds": rng.standard_normal(
                  (eB, eF, ecfg.d_model)).astype(np.float32)}
    model = build_model(ecfg, device=dev, seed=seed)
    params = trainable_params(model)
    step_fn, opt = make_train_step(model, tcfg)
    fa.reset_launches()
    _, _, m = step_fn(params, opt.init(params), ebatch)
    e_loss = float(m["loss"])
    shapes = {key: n for key, n in fa.SHAPE_LAUNCHES.items()
              if key[0] == "bwd"}
    check(math.isfinite(e_loss), f"{ecfg.name}: loss {e_loss}")
    if on_card:
        n = encdec["layers"]
        want_shapes = {("bwd", eF, eF, False): n, ("bwd", eT, eT, True): n,
                       ("bwd", eT, eF, False): n}
        check(shapes == want_shapes, f"{ecfg.name}: backward launches "
              f"{shapes}, expected {want_shapes}")
    log(f"[train] {ecfg.name} ({encdec['layers']} + {encdec['layers']} "
        f"layers, full width, {ecfg.dtype}): one step over {eB} x {eF} "
        f"frames and {eB} x {eT} tokens, loss {e_loss:.4f}; backward "
        f"launches by (variant, Tq, Tk, causal) {shapes}")
    ebatch = to_device(ebatch, model.device)
    rel_encdec = grads_kernel_vs_plain(
        torch, model, params, ebatch, f"{ecfg.name} {ecfg.dtype} "
        f"{encdec['layers']} + {encdec['layers']} layers",
        TRAIN_GRAD_L2[ecfg.dtype], TRAIN_LEAF_L2[ecfg.dtype])
    del model, params, step_fn, opt
    free_card(torch, dev)

    # RWKV-6: no WKV6 backward yet
    rcfg = dataclasses.replace(rwkv_cfg or configs.get("rwkv6-3b"),
                               num_layers=1)
    model = build_model(rcfg, device=dev, seed=seed)
    params = trainable_params(model)
    rbatch = to_device({k: v[:1, :64] for k, v in
                        stream.batch_at(0).items()}, model.device)
    rbatch = {k: v.clamp_max(rcfg.vocab_size - 1) for k, v in rbatch.items()}
    try:
        model.loss(rbatch)[0].backward()
        refused = None
    except NotPortedError as e:
        refused = str(e)
    if on_card:
        check(refused is not None, f"{rcfg.name}: the loss's backward on "
              f"the card did not raise NotPortedError")
    log(f"[train] {rcfg.name} on {dev}: the loss with gradients raises "
        f"NotPortedError: {refused!r}")
    del model, params
    free_card(torch, dev)
    out = {"launches": n_bwd, "err": err, "losses": losses,
           "step_ms": med_s * 1e3, "share": share,
           "rel": (rel_bf16, rel_fp32, rel_encdec)}
    if times is not None:
        out.update(times)
    return out


def phase_train_profile(torch, np, seed, dev="cuda", cfg=None, B=TRAIN_B,
                        T=TRAIN_T, vocab_chunk=TRAIN_VOCAB_CHUNK):
    """Where a training step's time goes: qwen3-1.7b rebuilt from the seed
    takes two warm-up steps, then one step under ``torch.profiler``
    (device time by kernel, grouped as the backward kernel, the forward
    attention kernel, matrix products and the rest, and the busy share);
    then the optimizer's update alone on the same parameters, by the
    host clock around a synchronised call.  Last of the profiled phases,
    as the training phase's step times are taken without a profiler."""
    from repro_torch import configs
    from repro_torch.data import pipeline
    from repro_torch.models import build_model
    from repro_torch.models import settings as msettings
    from repro_torch.models.types import ShapeSpec
    from repro_torch.train.train_loop import (TrainConfig, make_train_step,
                                              to_device, trainable_params)
    cfg = cfg or configs.get(TRAIN_ARCH)
    model = build_model(cfg, device=dev, seed=seed)
    params = trainable_params(model)
    step_fn, opt = make_train_step(model, TrainConfig())
    state = opt.init(params)
    stream = pipeline.for_model(cfg, ShapeSpec("train", T, B, "train"),
                                seed=seed)
    batches = [to_device(stream.batch_at(i), model.device) for i in range(3)]

    def step(i):
        with msettings.use(vocab_chunk=vocab_chunk):
            step_fn(params, state, batches[i])
        sync(torch, dev)
    step(0)
    step(1)
    wall, busy_us, by_name = profile_window(torch, lambda: step(2), dev)
    total = sum(t for t, _, _ in by_name) or 1.0
    groups = {"backward attention": 0.0, "forward attention": 0.0,
              "matrix products": 0.0, "the rest": 0.0}
    for t_us, key, _ in by_name:
        k = key.lower()
        if "bwd_" in k:
            groups["backward attention"] += t_us
        elif "flash_fwd" in k:
            groups["forward attention"] += t_us
        elif any(w in k for w in ("gemm", "xmma", "cutlass", "nvjet",
                                  "sm90_")):
            groups["matrix products"] += t_us
        else:
            groups["the rest"] += t_us
    log(f"[profile] {cfg.name} train step ({B} x {T} tokens) under the "
        f"profiler: {wall * 1e3:.3f} ms wall, card busy "
        f"{busy_us / 1e3:.3f} ms = {busy_us / 1e6 / wall:.1%}; device time "
        + ", ".join(f"{name} {t / 1e3:.3f} ms ({t / total:.1%})"
                    for name, t in groups.items()))
    for t_us, key, count in by_name[:12]:
        log(f"[profile]   {t_us / 1e3:9.3f} ms {t_us / total:6.1%} "
            f"x{count} {key[:90]}")
    grads = {k: torch.zeros_like(p) for k, p in params.items()}
    sync(torch, dev)
    t0 = time.perf_counter()
    opt.update(grads, state, params)
    sync(torch, dev)
    opt_ms = (time.perf_counter() - t0) * 1e3
    log(f"[profile] {cfg.name}: the AdamW update alone (clip, moments, "
        f"{sum(p.numel() for p in params.values()) / 1e9:.3f} B weights): "
        f"{opt_ms:.3f} ms (host clock, synchronised)")
    del model, params, state, step_fn, opt, grads, batches
    free_card(torch, dev)


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
    phase_sharded(torch, np, rd, args.seed, card)
    sharded_launches = phase_sharded_service(torch, np, rd, args.seed, errs)
    done("sharded")
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
    phase_guard(torch, rd, row)
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
    from repro_torch.kernels import flash_attention as fa
    lm_errs = {name: 0.0 for name in LM_KERNELS}
    lm_runs = {}
    for arch, name in SERVED:
        cfg = configs.get(arch)
        op = LM_KERNELS[name]["op"]
        run = phase_serve(torch, np, cfg, args.seed, card, placement)
        check(run["kernel"] == op, f"{cfg.name} ran {run['kernel']}")
        check(fa.LAUNCHES["flash_attention_bwd"] == 0,
              f"serving {cfg.name} launched the backward kernel")
        if cfg.window:
            phase_parity_4_layers(torch, cfg, args.seed,
                                  prompt=WINDOW_PARITY_PROMPT,
                                  steps=WINDOW_PARITY_STEPS)
        elif cfg.is_encdec:
            phase_parity_4_layers(torch, cfg, args.seed,
                                  steps=ENCDEC_PARITY_STEPS,
                                  frames=ENCDEC_PARITY_FRAMES)
        elif cfg.frontend == "vision":
            phase_parity_4_layers(torch, cfg, args.seed,
                                  frames=VLM_PARITY_PATCHES)
        else:
            phase_parity_4_layers(torch, cfg, args.seed)
        if run["modes"] is not None:
            lm_runs.update(time_encdec_kernels(torch, cfg, run, lm_errs,
                                               args.seed))
            done(f"serve {cfg.name}")
            continue
        r = time_lm_kernel(torch, op, run["shapes"], lm_errs, args.seed,
                           name=name, scalar_entry=SCALAR_ENTRIES.get(name))
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
    run = phase_llama4(torch, np, args.seed, card)
    run["times"] = time_lm_kernel(torch, "flash_attention", run["shapes"],
                                  lm_errs, args.seed,
                                  name="flash_attention_llama4")
    lm_runs["flash_attention_llama4"] = run
    done("llama4")
    # serving runs under inference_mode: no backward launch anywhere yet
    check(fa.LAUNCHES["flash_attention_bwd"] == 0,
          "the serving phases launched the backward kernel")
    train = phase_train(torch, np, args.seed, card)
    done("train")
    # the profiled phases come last: a profiler session may slow the
    # host's launches for the rest of the process (phase_lm_profile reads
    # whether it did), and the serving phases time those launches
    phase_busy(torch, args.seed, service, store, table)
    done("busy")
    del service, store, table
    for arch, _ in SERVED:
        phase_lm_profile(torch, np, configs.get(arch), args.seed)
    phase_train_profile(torch, np, args.seed)
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
        # the 4-worker front-end's run, the turbulence sweep's and the
        # sharded service's (2 shards)
        if name in ("scatter", "rowmin", "fold", "select"):
            kernels[-1]["frontend_launches"] = \
                frontend["launches"][name]
            kernels[-1]["turbulence_launches"] = turbulence[name]
            kernels[-1]["sharded_launches"] = sharded_launches[name]
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
    # each entry's launches: its own path's (the llama4 check's one
    # prefill for its entry); the scalar kernel's on the path of the
    # entry it was timed beside
    runs = {name: (run["entry_launches"] if "entry_launches" in run
                   else run["launches"]["flash_attention_tc" if
                                        run["kernel"] == "flash_attention"
                                        else "wkv6"], run["times"])
            for name, run in lm_runs.items()}
    for name, scalar_name in SCALAR_ENTRIES.items():
        run = lm_runs[name]
        runs[scalar_name] = (run["launches"]["flash_attention_scalar"],
                             run["times"]["scalar"])
    for name, spec in LM_KERNELS.items():
        n_launches, r = runs[name]
        kernels.append(entry(name, spec["source"], spec["replaces"],
                             n_launches, lm_errs[name], r))
        if name == "flash_attention_llama4":
            kernels.append(entry(
                "flash_attention_bwd",
                "src/repro_torch/csrc/flash_attention_bwd.cu",
                TRAIN_REPLACES, train["launches"], train["err"], train))
            kernels[-1].update(step_ms=train["step_ms"],
                               step_share=train["share"])
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
