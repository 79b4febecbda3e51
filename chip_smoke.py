#!/usr/bin/env python3
"""Run the port's live-market selection path on one CUDA card and check it.

    python3 chip_smoke.py [--seed N]

Phases:

1. build the CUDA kernels from ``src/repro_torch/csrc`` with ``nvcc``
   (``-Xptxas -v`` registers and shared memory printed);
2. hold every kernel against its plain PyTorch version on the card:
   ragged shapes, fully masked rows, a member with fewer profiled configs
   than k, an identity tick (bitwise), 1% and 30% changed columns, and
   the fleet's own shapes — then time each kernel, its plain version and,
   where one exists, the one PyTorch call that computes the same thing;
3. run :class:`TorchFusedRankState` at 64 jobs x 10,000 configs x 16
   members for 100 ticks (1% of prices per tick) and at 64 x 100,000 for
   20, holding every member against the float64 ``rank_dense`` under the
   score contract, the fused heads against ``ranking()[:10]``, and
   timing the tick;
4. serve a ``SelectionService(backend="torch_fused")`` over a 64 x 10,000
   store through a ``SelectionDaemon`` for 1,000 events and audit its
   journal with ``JournalReplayer`` — the main path, read through the
   kernels' launch counters — then hold each kernel against its plain
   version at the shapes that path gave it (the service fleet's own
   tensors; one member row for ``select``, as ``top_k`` serves it) and
   time it there: those are the numbers of the ``kernels`` record;
5. run a second 1,000-event daemon on the same service under
   ``torch.profiler`` and report the card's busy share: the union of its
   kernel and copy intervals over the run's wall time.

Every phase runs on every call.  Every check that fails exits non-zero.
The last three lines are the ``{"kernels": [...]}`` record, the card's
name and power limit, and ``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
non-zero before printing any result.  It imports ``torch``, ``numpy``, the
standard library and the port (``src/repro_torch``), nothing else.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: published H100 SXM peaks (NVIDIA data sheet) for the bounds
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
REL_TOL, ABS_TOL = 1e-4, 1e-6
SOURCE = "src/repro_torch/csrc/rank_delta.cu"
#: what each CUDA kernel replaces on the main path: the fused Pallas body
#: (``_make_kernel``) for ``rowmin`` and ``fold``; for ``select``, the
#: ``jax.lax.top_k`` that the reference fleet's ``top_k`` serves from
#: (the service calls ``top_k``, never ``reprice_with_heads``)
REPLACES = {"rowmin": "src/repro/kernels/rank_delta.py:69",
            "fold": "src/repro/kernels/rank_delta.py:69",
            "select": "src/repro/selector/rank.py:1218"}
#: ``select`` also ports the Pallas kernel's in-kernel top-k tail, which
#: only ``fused_reprice_heads`` runs (phases 2 and 3, not the service)
ALSO_REPLACES = {"select": "src/repro/kernels/rank_delta.py:157"}
KERNELS = ("rowmin", "fold", "select")


class CheckFailed(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def log(*parts) -> None:
    print(*parts, flush=True)


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_FLOPS_PER_S * 1e3
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


# --- phase 1 --------------------------------------------------------------------

def phase_build(torch) -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _, text = _build.build("rank_delta")
    log(f"[build] nvcc rank_delta.cu: {time.perf_counter() - t0:.2f} s "
        f"-> {_build.BUILD_DIR}")
    for line in text.splitlines():
        if "ptxas info" in line and ("registers" in line
                                     or "Compiling entry" in line
                                     or "smem" in line):
            log(f"[build] {line.strip()}")
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


def check_select(torch, scores, finite, k, label, errs) -> None:
    """The ``select`` kernel against the plain stable sort: the same
    indices and values, and every head k distinct configs."""
    from repro_torch.kernels import rank_delta as rd
    ti_k, tv_k = rd._launch_select(scores, finite, k)
    ti_p, tv_p = rd.select_heads_plain(scores, finite, k)
    check(torch.equal(ti_k, ti_p), f"{label}: select indices differ from "
          f"the stable sort")
    check(torch.equal(tv_k, tv_p), f"{label}: select values differ")
    rows = ti_k.cpu().numpy()
    check(all(len(set(r)) == len(r) for r in rows),
          f"{label}: a head repeats a config")
    errs["select"] = max(errs["select"], max_err(torch, tv_k, tv_p))


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
            plain_ms=time_ms(torch, lambda: rd.select_heads_plain(
                sel_scores, sel_finite, k)),
            library_ms=time_ms(torch, lambda: torch.topk(
                masked, k, dim=1, largest=False))),
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
    for name, r in res.items():
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"[time] {name}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {lib} ms, bound "
            f"{r['bound'][0]:.5f} ms ({r['bound'][1]}) at J={J} C={C} "
            f"S={R if name == 'select' else S} k={k}")
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


# --- phase 5 --------------------------------------------------------------------

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
    time_kernels(torch, big_shape)
    time_kernels(torch, main_shape)
    done("parity")
    phase_fleet(torch, np, args.seed, 64, 10_000, 16, 100, 10,
                "64x10000x16", card)
    phase_fleet(torch, np, args.seed + 1, 64, 100_000, 16, 20, 10,
                "64x100000x16", card)
    done("fleet")
    rd.reset_launches()
    service, store, table = phase_service(np, args.seed)
    launches = dict(rd.LAUNCHES)
    done("service")
    for name in KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched on "
              f"the main path")
    times = phase_main_path_kernels(torch, np, args.seed, service._batched,
                                    errs)
    done("main-path kernels")
    phase_busy(torch, args.seed, service, store, table)
    done("busy")
    kernels = []
    for name in KERNELS:
        r = times[name]
        kernels.append({
            "name": f"rank_delta_{name}", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"]})
        if name in ALSO_REPLACES:
            kernels[-1]["also_replaces"] = ALSO_REPLACES[name]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
