"""The port's dry run (``repro_torch.launch.dryrun``, ``roofline``) against
the reference's arithmetic, and its counts against analytic ones.

* ``_active_params``, ``_cycle_info``, ``_depth_variant``, ``_extrapolate``
  and ``model_flops_per_step`` equal the reference's for every
  architecture; the ``Roofline`` terms, on the H100's rates, and its keys.
* The per-device counting rule on products whose shares are known by hand
  (split rows, a split contraction, replicated, a partial-sum input).
* A reduced qwen3-1.7b cell on a fake 2 x 2 world within 2% of the
  analytic count stated below; a reduced rwkv6-3b cell data-parallel over
  the same 4 ranks within 2% of its own, and on the 2 x 2 mesh between the
  fully split and the model-replicated counts.
* A reduced qwen3-moe-30b-a3b cell on 2 x 2 and 4 x 1 traces, and one
  MoE layer's forward counts the analytic FLOPs exactly (its router and
  its experts' three products over every capacity slot, split by the
  mesh).
* The CLI's ``--append``, and a port-written report through both
  packages' ``records_from_dryrun_report`` (equal records) and
  ``service_from_dryrun_report`` (the same mesh).

The reference's own dry run compiles full configs over 512 host devices
with XLA, far too slow for these tests, so no test holds the port's FLOPs
against XLA's cost analysis; the analytic counts stand in for it.  The
reference's dry-run module sets ``XLA_FLAGS`` when imported; the flags are
put back at once, before any JAX backend starts.
"""
import dataclasses
import json
import math
import os

import pytest
import torch

_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as ref_dryrun          # noqa: E402
if _FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _FLAGS

import repro.configs as RC                              # noqa: E402
from repro.core import tpu_flora as ref_flora          # noqa: E402
from repro.core.costmodel import TpuPriceModel as RefPrice  # noqa: E402
from repro.launch import roofline as ref_roof          # noqa: E402
from repro_torch import configs as TC                  # noqa: E402
from repro_torch.core import tpu_flora as t_flora      # noqa: E402
from repro_torch.core.costmodel import TpuPriceModel   # noqa: E402
from repro_torch.launch import dryrun                  # noqa: E402
from repro_torch.launch import mesh as mesh_lib        # noqa: E402
from repro_torch.launch import roofline                # noqa: E402


@pytest.mark.parametrize("arch", RC.ARCH_NAMES)
def test_dryrun_arithmetic_matches_reference(arch):
    rcfg, tcfg = RC.get(arch), TC.get(arch)
    assert dryrun._active_params(tcfg) == ref_dryrun._active_params(rcfg)
    assert dryrun._cycle_info(tcfg) == ref_dryrun._cycle_info(rcfg)
    for n in (1, 2):
        r, t = ref_dryrun._depth_variant(rcfg, n), \
            dryrun._depth_variant(tcfg, n)
        assert (t.num_layers, t.encoder_layers) == \
            (r.num_layers, r.encoder_layers)
    for training in (True, False):
        assert roofline.model_flops_per_step(
            dryrun._active_params(tcfg), 4096 * 256, training=training) == \
            ref_roof.model_flops_per_step(ref_dryrun._active_params(rcfg),
                                          4096 * 256, training=training)
    assert dryrun.TRAIN_CFGS.keys() == ref_dryrun.TRAIN_CFGS.keys()
    for name, r in ref_dryrun.TRAIN_CFGS.items():
        assert dataclasses.asdict(dryrun.TRAIN_CFGS[name]) == \
            dataclasses.asdict(r)


def test_extrapolate_matches_reference():
    a = dict(flops=3e12, hbm_bytes=2e10, wire_bytes=7e8,
             collectives={"all-reduce": 5e8, "all-gather": 2e8})
    b = dict(flops=5e12, hbm_bytes=3.5e10, wire_bytes=1.1e9,
             collectives={"all-reduce": 8e8, "all-gather": 3e8,
                          "all-to-all": 1})
    for n in (1, 2, 28, 38):
        r = ref_dryrun._extrapolate(ref_roof.Roofline(**a),
                                    ref_roof.Roofline(**b), n)
        t = dryrun._extrapolate(roofline.Roofline(**a),
                                roofline.Roofline(**b), n)
        assert (t.flops, t.hbm_bytes, t.wire_bytes) == \
            (r.flops, r.hbm_bytes, r.wire_bytes)
        assert dict(t.collectives) == dict(r.collectives)


def test_roofline_terms_on_the_cards_rates():
    r = roofline.Roofline(flops=989e12, hbm_bytes=2 * 3.35e12,
                          wire_bytes=50e9 / 4,
                          collectives={"all-reduce": 1})
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(2.0)
    assert r.collective_s == pytest.approx(0.25)
    assert (r.dominant, r.step_s) == ("memory", r.memory_s)
    ref = ref_roof.Roofline(flops=1.0, hbm_bytes=1.0, wire_bytes=1.0,
                            collectives={})
    assert list(r.as_dict()) == list(ref.as_dict())
    assert (roofline.PEAK_FLOPS_BF16, roofline.HBM_BW, roofline.LINK_BW,
            roofline.FP32_FLOPS) == (989e12, 3.35e12, 50e9, 67e12)
    counts = roofline.Counts(flops=5.0, hbm_bytes=7.0)
    counts.collectives["all-gather"] = 3
    counts.collectives["all-reduce"] = 4
    a = roofline.analyze(counts)
    assert (a.flops, a.hbm_bytes, a.wire_bytes) == (5.0, 7.0, 7.0)
    assert set(a.collectives) == set(roofline.COLLECTIVES)


# --- the per-device counting rule on toys ------------------------------------

def _dt(mesh, shape, placements):
    """A meta DTensor of global ``shape`` (local shards of a 2 x 2 mesh)."""
    from torch.distributed.tensor import DTensor
    local = list(shape)
    for p in placements:
        if p.is_shard():
            local[p.dim] //= 2
    return DTensor.from_local(torch.empty(local, device="meta"), mesh,
                              placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def test_per_device_counting_rule():
    """x (8, 4) @ w (4, 6) is 384 FLOPs whole: rows split over data and
    columns over model leave 96 a device; a contraction split over data
    192 (a partial sum); a replicated product 384 on every device, and
    so does a partial-sum input (its local product is whole); the batch
    split over both axes 96."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    R, S = Replicate(), Shard
    cases = [((S(0), R), (R, S(1)), 96), ((S(1), R), (S(0), R), 192),
             ((R, R), (R, R), 384), ((Partial(), R), (R, R), 384),
             ((S(0), S(0)), (R, R), 96)]
    with mesh_lib.fake_world(4), dryrun._meta_mesh():
        mesh = mesh_lib.make_mesh((2, 2), ("data", "model"),
                                  device_type="meta")
        for px, pw, want in cases:
            x, w = _dt(mesh, (8, 4), px), _dt(mesh, (4, 6), pw)
            with roofline.count() as c:
                x @ w
            assert c.flops == want, (px, pw)
            assert sum(c.collectives.values()) == 0
        # w split on data's rows too: its slices are gathered first
        x, w = _dt(mesh, (8, 4), (S(0), R)), _dt(mesh, (4, 6), (S(0), S(1)))
        with roofline.count() as c:
            x @ w
        assert c.flops == 96
        assert c.collectives["all-gather"] == 4 * 3 * 4   # (4, 3) fp32
        # bytes: each op's inputs and outputs at local size (x's (4, 4)
        # fp32 shard), views free: the add reads 16 and writes 16 floats,
        # the sum reads 16 and writes 1
        with roofline.count() as c:
            (x.t().t() + 1.0).sum()
        assert c.hbm_bytes == (16 + 16) * 4 + (16 + 1) * 4


# --- reduced cells ---------------------------------------------------------------

B, T = 256, 4096            # train_4k
TOKENS = B * T


def _pairs(Bs, H):
    return Bs * H * T * (T + 1) // 2


def qwen3_reduced_flops():
    """Analytic per-device FLOPs of a reduced qwen3-1.7b train_4k step on
    2 x 2 (every product split four ways: batch over data, heads, MLP and
    vocabulary over model).  A layer's products are 2 (d H D + 2 d G D +
    H D d + 3 d f) a token forward and twice that backward; remat
    recomputes each layer up to the last tensor its backward saves, so
    the down projection (2 d f a token), whose output only feeds the
    residual add, is not recomputed; attention is 4 D a (query, key) pair
    forward and again recomputed, 10 D backward; the head 2 d V a token,
    three times."""
    d, H, G, D, f, V, L = 64, 4, 2, 16, 256, 512, 2
    fwd = 2 * (d * H * D + 2 * d * G * D + H * D * d + 3 * d * f)
    layers = L * TOKENS * (4 * fwd - 2 * d * f)
    attn = L * 18 * D * _pairs(B, H)
    head = 3 * 2 * d * V * TOKENS
    return (layers + attn + head) / 4


def rwkv_reduced_flops(model_split: bool):
    """Analytic per-device FLOPs of a reduced rwkv6-3b train_4k step: the
    time mix's products (ddlerp's two, r, k, v, g, the decay's two, the
    output) and the channel mix's three, each 4 times (forward, remat's
    recompute, backward twice: every product feeds a tensor the backward
    saves); WKV 5 N^2 a step of a stream forward, again recomputed, 14
    backward; the head three times.  Over 4 ranks data-parallel everything
    is a quarter; on 2 x 2 with the time mix kept whole over the model
    axis (``heads_flat`` is replicated) it is at most half there."""
    d, N, H, r, f, V, L = 64, 16, 4, 32, 256, 512, 2
    tm = 2 * (d * 5 * r + 5 * r * d + 4 * d * d + 2 * d * 64 + d * d)
    cm = 2 * (d * f + f * d + d * d)
    wkv = 24 * N * N * H
    head = 3 * 2 * d * V * TOKENS
    if not model_split:
        return (L * TOKENS * (4 * (tm + cm) + wkv) + head) / 4
    return L * TOKENS * ((4 * tm + wkv) / 2 + 4 * cm / 4) + head / 4


@pytest.fixture(scope="module")
def reduced_cells():
    out = {}
    for arch, meshes in (("qwen3-1.7b", [(2, 2), (4, 1), (1, 4)]),
                         ("rwkv6-3b", [(2, 2), (4, 1)])):
        cfg = TC.reduced(TC.get(arch))
        for ms in meshes:
            for shape in ("train_4k", "decode_32k"):
                out[arch, ms, shape] = dryrun.lower_cell(
                    arch, shape, multi_pod=False, mesh_shape=ms, cfg=cfg,
                    quiet=True)
    return out


def test_reduced_cells_count_within_two_percent(reduced_cells):
    for cell in reduced_cells.values():
        assert cell["ok"], cell
        assert set(cell["roofline"]) == set(ref_roof.Roofline(
            0.0, 0.0, 0.0, {}).as_dict())
        assert cell["trace_s"] >= 0 and "memory" not in cell
    q = reduced_cells["qwen3-1.7b", (2, 2), "train_4k"]
    assert q["mesh"] == "dp2xtp2"
    assert q["roofline"]["flops_per_device"] == \
        pytest.approx(qwen3_reduced_flops(), rel=0.02)
    assert q["model_flops_per_device"] == pytest.approx(
        6 * q["params_active"] * TOKENS / 4)
    r = reduced_cells["rwkv6-3b", (4, 1), "train_4k"]
    assert r["roofline"]["flops_per_device"] == \
        pytest.approx(rwkv_reduced_flops(False), rel=0.02)
    r22 = reduced_cells["rwkv6-3b", (2, 2), "train_4k"]
    assert rwkv_reduced_flops(False) * 0.98 <= \
        r22["roofline"]["flops_per_device"] <= \
        rwkv_reduced_flops(True) * 1.02
    # split over the model axis the batch is not: more collectives
    assert q["roofline"]["wire_bytes_per_device"] > 0


def _head_alone(cfg, dims, chunk):
    """One step of the head alone (``fused_xent`` at ``chunk``, or the
    plain head at 0) over train_4k's batch, counted on a meta mesh of
    ``dims`` with the weights and the hidden states placed as in the
    cell.  Returns (counts, the placements of x's gradient)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.configs import shapes as TS
    from repro_torch.models import layers as L
    from repro_torch.models import lm as lm_lib
    from repro_torch.sharding import ctx
    from repro_torch.sharding import rules as R
    shape = TS.SHAPES["train_4k"]
    with mesh_lib.fake_world(math.prod(dims)), dryrun._meta_mesh():
        mesh = mesh_lib.make_mesh(dims, ("data", "model"), device_type="meta")
        rules = R.production_rules().with_overrides(
            **R.arch_overrides(cfg, dims[1]))
        embed = {k: dryrun._placed(s.shape, torch.float32, R.sharding_for_spec(
            s, rules, mesh)).requires_grad_(True)
            for k, s in lm_lib.param_specs(cfg)["embed"].items()}
        rows = [Shard(0), Replicate()]
        B, T = shape.global_batch, shape.seq_len
        x = distribute_tensor(torch.empty(B, T, cfg.d_model, device="meta"),
                              mesh, rows).requires_grad_(True)
        labels = distribute_tensor(torch.empty(B, T, dtype=torch.long,
                                               device="meta"), mesh, rows)
        with ctx.use(rules, mesh), roofline.count() as counts:
            if chunk:
                lse, ll = lm_lib.fused_xent(embed, cfg, x, labels, chunk)
            else:
                lse, ll = lm_lib.plain_xent(L.head_apply(embed, cfg, x),
                                            labels)
            (lse - ll).sum().backward()
        return counts, x.grad.placements


def test_chunked_head_cell_on_a_split_vocabulary(reduced_cells):
    """A reduced qwen3-1.7b train_4k cell on 2 x 2 with ``vocab_chunk``
    100 (each rank's 256 ids in two chunks of 100 and one of 56) against
    the plain head's cell.  FLOPs a device: the plain cell's plus one
    recompute of the rank's head products in the backward, 2 (B / 2) T d
    (V / 2), exactly (the last chunk is ragged, not padded).  The head
    alone moves, besides the FSDP gather of its slice of the table over
    data, (V / 2) d float32 (the plain head's too), the forward's two
    all-reduces over model: the ranks' maxima, (B / 2, T) float32, and
    their rescaled sums and picks, (2, B / 2, T); dx comes back a
    partial sum over model, as the plain head's, for the stack's
    constraint to reduce.  The plain head alone moves the logits through
    DTensor's all-to-alls and reduce-scatters; the cells differ by the
    two heads' collectives, less three scalar all-reduces over model
    (the plain head leaves the loss's terms a partial sum over model)."""
    cfg = TC.reduced(TC.get("qwen3-1.7b"))
    plain = reduced_cells["qwen3-1.7b", (2, 2), "train_4k"]
    cell = dryrun.lower_cell("qwen3-1.7b", "train_4k", multi_pod=False,
                             mesh_shape=(2, 2), cfg=cfg, quiet=True,
                             settings_extra={"vocab_chunk": 100})
    assert cell["ok"]
    rows, d, Vm = B // 2 * T, cfg.d_model, cfg.vocab_size // 2
    recompute = 2 * rows * d * Vm
    assert cell["roofline"]["flops_per_device"] == pytest.approx(
        plain["roofline"]["flops_per_device"] + recompute, rel=1e-9)
    from torch.distributed.tensor import Partial
    chunked, dx = _head_alone(cfg, (2, 2), 100)
    assert dx[1] == Partial()
    assert chunked.flops == 4 * recompute
    want = dict.fromkeys(roofline.COLLECTIVES, 0)
    want["all-reduce"] = 2 * (4 * rows + 4 * 2 * rows)
    want["all-gather"] = Vm * d * 4
    assert chunked.collectives == want
    head, _ = _head_alone(cfg, (2, 2), 0)
    scalars = 3 * 2 * 4
    for kind in roofline.COLLECTIVES:
        added = chunked.collectives[kind] - head.collectives[kind]
        if kind == "all-reduce":
            added -= scalars
        assert cell["roofline"]["collectives"][kind] == \
            plain["roofline"]["collectives"][kind] + added, kind


def moe_layer_flops(cfg, B, T, dims):
    """Analytic per-device FLOPs of one MoE layer's forward on a (data,
    model) mesh: the router 2 B T d E with the batch split over data
    (replicated over model), and three expert products over all E C
    capacity slots, 3 x 2 B E C d f, the batch split over data and the
    experts over model."""
    d, E, K = cfg.d_model, cfg.num_experts, cfg.experts_per_token
    f = cfg.moe_d_ff or cfg.d_ff
    C = max(1, math.ceil(T * K / E * cfg.capacity_factor))
    data, model = dims
    return 2 * (B // data) * T * d * E \
        + 3 * 2 * (B // data) * (E // model) * C * d * f


@pytest.mark.parametrize("dims", [(2, 2), (4, 1)],
                         ids=lambda d: f"{d[0]}x{d[1]}")
def test_moe_cell_traces_and_its_layer_counts_analytic_flops(dims):
    """A reduced qwen3-moe-30b-a3b ``train_4k`` cell traces on the mesh,
    and one MoE layer's forward on meta DTensors counts exactly the
    analytic FLOPs (expert parallelism: each rank's experts only)."""
    from repro_torch.models import layers as L
    from repro_torch.sharding import ctx as ctx_lib
    from repro_torch.sharding import rules as rules_lib
    cfg = TC.reduced(TC.get("qwen3-moe-30b-a3b"))
    cell = dryrun.lower_cell("qwen3-moe-30b-a3b", "train_4k",
                             multi_pod=False, mesh_shape=dims, cfg=cfg,
                             quiet=True)
    assert cell["ok"] and cell["roofline"]["flops_per_device"] > 0
    Bs, Ts = 8, 64
    with mesh_lib.fake_world(4), dryrun._meta_mesh():
        mesh = mesh_lib.make_mesh(dims, ("data", "model"),
                                  device_type="meta")
        rules = rules_lib.production_rules().with_overrides(
            **rules_lib.arch_overrides(cfg, dims[1]))
        p = dryrun._placed_tree(L.moe_specs(cfg), rules, mesh,
                                cfg.compute_dtype)
        shape = (Bs, Ts, cfg.d_model)
        x = dryrun._placed(shape, cfg.compute_dtype, rules_lib.NamedSharding(
            mesh, rules_lib.spec_for(shape, ("batch", "seq", None), rules,
                                     mesh)))
        with ctx_lib.use(rules, mesh), ctx_lib.spmd(), \
                roofline.count() as c:
            y, aux = L.moe_apply(p, cfg, x)
        assert tuple(y.shape) == shape and aux.shape == ()
    assert c.flops == moe_layer_flops(cfg, Bs, Ts, dims)


def test_remat_recompute_keeps_the_sharding_context_on_another_thread():
    """On a card autograd runs the backward, and remat's recompute, on its
    own device thread, where the thread-local sharding context is not
    set.  A reduced qwen3-moe-30b-a3b step on meta DTensors over 2 x 2,
    its backward taken on another thread, recomputes each layer under
    the forward's context: the MoE layer's local experts keep their
    shapes (else ``torch.utils.checkpoint`` refuses the recompute)."""
    import threading
    from repro_torch.models import lm as lm_lib
    from repro_torch.models.types import ShapeSpec
    from repro_torch.configs import shapes as shapes_lib
    from repro_torch.sharding import ctx as ctx_lib
    from repro_torch.sharding import rules as rules_lib
    from repro_torch.train.train_loop import trainable_params
    cfg = TC.reduced(TC.get("qwen3-moe-30b-a3b"))
    with mesh_lib.fake_world(4), dryrun._meta_mesh():
        mesh = mesh_lib.make_mesh((2, 2), ("data", "model"),
                                  device_type="meta")
        rules = rules_lib.production_rules().with_overrides(
            **rules_lib.arch_overrides(cfg, 2))
        model = lm_lib.LM(cfg, device="meta", params=dryrun._placed_tree(
            lm_lib.param_specs(cfg), rules, mesh, cfg.compute_dtype))
        params = trainable_params(model)
        batch = dryrun._placed_batch(shapes_lib.batch_specs(
            cfg, ShapeSpec("t", 32, 4, "train"), with_labels=True), rules,
            mesh)
        with ctx_lib.use(rules, mesh), ctx_lib.spmd():
            loss, _ = model.loss(batch, remat=True)
        out = {}

        def backward():
            try:
                with ctx_lib.spmd():
                    out["grads"] = torch.autograd.grad(
                        loss, list(params.values()))
            except Exception as e:     # reported below
                out["error"] = e
        worker = threading.Thread(target=backward)
        worker.start()
        worker.join()
    assert "error" not in out, out.get("error")
    assert len(out["grads"]) == len(params)


def test_lower_cell_refuses_a_live_group():
    import torch.distributed as dist
    with mesh_lib.fake_world(1):
        with pytest.raises(RuntimeError, match="already open"):
            dryrun.lower_cell("qwen3-1.7b", "decode_32k", multi_pod=False,
                              mesh_shape=(1, 1),
                              cfg=TC.reduced(TC.get("qwen3-1.7b")))
    assert not dist.is_initialized()


def test_cli_append(tmp_path, capsys):
    out = tmp_path / "r.json"
    dryrun.main(["--arch", "qwen3-1.7b,rwkv6-3b", "--shape", "long_500k",
                 "--mesh", "single", "--out", str(out)])
    first = json.loads(out.read_text())["cells"]
    assert [(c["arch"], c["ok"], "skipped" in c) for c in first] == \
        [("qwen3-1.7b", False, True), ("rwkv6-3b", True, False)]
    assert first[0]["skipped"] == ref_dryrun.shapes_lib.skip_reason(
        RC.get("qwen3-1.7b"), ref_dryrun.shapes_lib.SHAPES["long_500k"])
    dryrun.main(["--arch", "rwkv6-3b,stablelm-3b", "--shape", "long_500k",
                 "--mesh", "single", "--out", str(out), "--append"])
    second = json.loads(out.read_text())["cells"]
    assert second[:2] == first              # done cells kept as they were
    assert [c["arch"] for c in second] == ["qwen3-1.7b", "rwkv6-3b",
                                           "stablelm-3b"]
    assert "=== rwkv6-3b" not in capsys.readouterr().out.split(
        "dry-run complete")[1]
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "no-such-arch", "--shape", "long_500k",
                     "--mesh", "single", "--out", str(out), "--append"])
    assert e.value.code == 1
    assert "error" in json.loads(out.read_text())["cells"][-1]


def test_port_report_through_both_selections(reduced_cells):
    cells = [dict(c, arch=arch) for (arch, _, _), c in reduced_cells.items()]
    report = {"cells": cells + [{"arch": "x", "shape": "train_4k",
                                 "mesh": "dp4xtp1", "ok": False,
                                 "error": "RuntimeError: no rule"}]}
    ref_recs = ref_flora.records_from_dryrun_report(report)
    port_recs = t_flora.records_from_dryrun_report(report)
    assert len(port_recs) == len(cells)
    assert [dataclasses.astuple(r) for r in port_recs] == \
        [dataclasses.astuple(r) for r in ref_recs]
    for market in ("ondemand", "spot"):
        ref_service = ref_flora.service_from_dryrun_report(
            report, RefPrice(market))
        port_service = t_flora.service_from_dryrun_report(
            report, TpuPriceModel(market), backend="numpy", device="cpu")
        for shape in ("train_4k", "decode_32k"):
            for exclude in ((), ("qwen3-1.7b",)):
                r = ref_service.submit(shape, exclude_groups=exclude)
                t = port_service.submit(shape, exclude_groups=exclude)
                assert t.config_id == r.config_id
                assert t.hourly_cost == pytest.approx(r.hourly_cost)


def test_card_cell_equals_flop_counter_around_a_real_step(monkeypatch):
    """The chip script's check of the card cell, at a reduced size on the
    CPU: the dry run's count of a step on a (1, 1) mesh equals
    ``FlopCounterMode`` around a real step of the same model, batch and
    vocabulary chunks, with the attention kernels reached through their
    counting form (whose CPU kernels are the plain versions)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import shapes as TS
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models import settings as msettings
    from repro_torch.models.types import ShapeSpec
    from repro_torch.train.train_loop import (TrainConfig, make_train_step,
                                              trainable_params)
    cfg = TC.reduced(TC.get("qwen3-1.7b"))
    shape = ShapeSpec("chip", 48, 2, "train")
    cell = dryrun.lower_cell("qwen3-1.7b", "chip", multi_pod=False,
                             mesh_shape=(1, 1), cfg=cfg, shape=shape,
                             settings_extra={"vocab_chunk": 100}, quiet=True)
    assert cell["mesh"] == "dp1xtp1" and cell["ok"]

    def routed(q, k, v, *, causal=True, window=None):
        if torch.is_grad_enabled() and q.requires_grad:
            return fa.FlashAttentionFn.apply(q, k, v, causal, window)
        return torch.ops.repro_torch.flash_attention(q, k, v, causal,
                                                     window)
    monkeypatch.setattr(ops, "flash_attention", routed)
    model = build_model(cfg, device="cpu")
    step_fn, opt = make_train_step(model, TrainConfig())
    params = trainable_params(model)
    state = opt.init(params)
    batch = TS.make_batch(cfg, shape, torch.Generator().manual_seed(0))
    with msettings.use(vocab_chunk=100), \
            FlopCounterMode(display=False) as counter:
        step_fn(params, state, batch)
    real = counter.get_total_flops()
    assert cell["roofline"]["flops_per_device"] == pytest.approx(real,
                                                                 rel=1e-9)


def test_decode_attention_operators_match_the_plain_path():
    """Decode attention takes the two operators DTensor can split
    (``decode_scores``, ``decode_out``); on a one-device mesh of real CPU
    tensors a DTensor gets a plain tensor's output exactly, and their FLOP
    formulas are the two products'."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.models import layers as L
    g = torch.Generator().manual_seed(5)
    B, S, H, G, D = 2, 9, 4, 2, 16
    q = torch.randn(B, 1, H, D, generator=g)
    k, v = (torch.randn(B, S, G, D, generator=g) for _ in range(2))
    valid = torch.arange(S) < 7
    want = L.sdpa_decode(q, k, v, valid)
    with mesh_lib.fake_world(1):
        mesh = mesh_lib.make_mesh((1, 1), ("data", "model"),
                                  device_type="cpu")
        dt = [distribute_tensor(t, mesh, [Replicate(), Replicate()])
              for t in (q, k, v, valid)]
        got = L.sdpa_decode(*dt).to_local()
    assert torch.equal(got, want)
    with FlopCounterMode(display=False) as counter:
        p = torch.ops.repro_torch.decode_scores(q, k)
        torch.ops.repro_torch.decode_out(torch.softmax(p, -1), v)
    assert counter.get_total_flops() == 2 * (2 * B * H * S * D)


def test_cpu_dtensors_reach_the_kernels_plain_versions():
    """A DTensor whose shards lie on the CPU reaches the kernels'
    operators (a plain CPU tensor is routed to the plain version before
    them); their CPU kernels are the plain versions, so the forward and
    the backward of attention and WKV6 on a one-device CPU mesh equal the
    plain tensors', and no launch is made.  The forwards are the same
    functions; the DTensor's gradients come from the explicit backward
    formulas and the plain tensors' from autograd of the forward, which
    sum in other orders in float32: 1e-4 holds them."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rwkv6_scan as rs
    g = torch.Generator().manual_seed(7)
    B, T, H, G, D, N = 2, 12, 4, 2, 16, 8
    att = [torch.randn(B, T, n, D, generator=g) for n in (H, G, G)]
    wkv = [torch.randn(B, T, H, N, generator=g) for _ in range(3)] + [
        torch.rand(B, T, H, N, generator=g) * 0.5 + 0.4,
        torch.randn(H, N, generator=g), torch.randn(B, H, N, N, generator=g)]

    def run(fn, inputs, wrap):
        leaves = [wrap(t).requires_grad_() for t in inputs]
        outs = fn(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        sum((o * o).sum() for o in outs).backward()
        local = (lambda t: t.to_local() if hasattr(t, "to_local") else t)
        return [local(o).detach() for o in outs] + \
            [local(t.grad) for t in leaves]

    fa.reset_launches()
    rs.reset_launches()
    cases = ((lambda q, k, v: fa.flash_attention(q, k, v, causal=True,
                                                 window=5), att),
             (rs.wkv6, wkv))
    with mesh_lib.fake_world(1):
        mesh = mesh_lib.make_mesh((1, 1), ("data", "model"),
                                  device_type="cpu")
        placed = (lambda t: distribute_tensor(t, mesh,
                                              [Replicate(), Replicate()]))
        for fn, inputs in cases:
            want = run(fn, inputs, lambda t: t.clone())
            got = run(fn, inputs, placed)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    assert not any(fa.LAUNCHES.values()) and not any(rs.LAUNCHES.values())


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_serve_steps_rehearses_on_the_cpu():
    """``chip_smoke.serve_steps`` (the decode reading of the parent
    against the change) on a reduced rwkv6-3b on the CPU: two positive
    decode times a step."""
    cs = _chip_smoke()
    cfg = TC.reduced(TC.get("rwkv6-3b"))
    got = cs.serve_steps(torch, arch="rwkv6-3b", n_requests=2,
                         prompt_len=8, slots=2, max_new=3, dev="cpu",
                         cfg=cfg)
    assert len(got) == 2 and all(x > 0 for x in got)


def test_use_tree_imports_the_other_trees_port(tmp_path):
    """``chip_smoke.use_tree`` drops the port the script imported and
    puts the other tree's first: a process then imports that one."""
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    (tmp_path / "repro_torch").mkdir()
    (tmp_path / "repro_torch" / "__init__.py").write_text("TREE = 'other'\n")
    code = (f"import sys; sys.path.insert(0, {str(root)!r}); "
            f"import chip_smoke as cs; import repro_torch; "
            f"assert not hasattr(repro_torch, 'TREE'); "
            f"cs.use_tree({str(tmp_path)!r}); import repro_torch; "
            f"print(repro_torch.TREE)")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    assert done.stdout.strip() == "other"


def test_a_skipped_split_cell_carries_its_split():
    """A skipped cell of a split names the split, as a traced one does,
    so that ``--append`` finds it."""
    cell = dryrun.lower_cell("qwen3-1.7b", "long_500k", multi_pod=False,
                             mesh_shape=(64, 4), quiet=True)
    assert cell["mesh"] == "dp64xtp4" and "skipped" in cell
    cell = dryrun.lower_cell("qwen3-1.7b", "long_500k", multi_pod=False,
                             quiet=True)
    assert cell["mesh"] == "16x16" and "skipped" in cell
