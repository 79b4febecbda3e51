"""The dry run: count each (architecture x shape x mesh) cell's step per
device, with no card, and write the report the mesh selection ranks (the
port's own copy of ``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \
        --shape train_4k --mesh single --out R.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \
        --shape train_4k,decode_32k --mesh splits --out R.json

``--mesh`` also takes one split's name (``--mesh dp64xtp4``).

The reference compiles each cell with XLA over 512 fake host devices and
reads the compiler's cost analysis.  The port traces the step instead, on
the CPU, over a world of fake ranks (:func:`repro_torch.launch.mesh.
fake_world`), on a mesh of the ``meta`` device: the parameters, the
optimizer's moments, the batch and the decode state are DTensors of meta
tensors (no memory is taken), placed by :mod:`repro_torch.sharding.rules`,
the activations held where the rules put them by the model's
annotations (:func:`repro_torch.sharding.ctx.constrain`), and the step
runs once under
:func:`repro_torch.launch.roofline.count`: the loss, its backward and the
AdamW update for ``train`` (remat as training runs it), ``prefill`` for
prefill, ``decode_step`` for decode.  The kernels are reached through
their counting forms (:mod:`repro_torch.kernels.flash_attention`,
:mod:`repro_torch.kernels.rwkv6_scan`), never through their plain
versions.

As the reference, a cell first traces the true config (its time is
``trace_s``: the proof that every op of the deployment has a sharding
rule), then counts the step at one and two layer cycles and extrapolates
affinely to the real depth (:func:`_extrapolate`).  A cell that cannot be
traced (an op DTensor has no rule for) is recorded ``ok: false`` with its
error, and ``main`` exits 1.  A cell given ``mesh_shape=(d, m)`` is named
``dp{d}xtp{m}``, which :func:`repro_torch.core.tpu_flora._mesh_topology`
parses; the report feeds ``python -m repro_torch.launch.train --auto-mesh
--report R.json`` and ``python -m repro_torch.serve --report R.json``.
No compiler gives the port a memory analysis, so a cell has no
``memory`` key.

The fake world belongs to the whole process: :func:`lower_cell` opens its
own and destroys it on the way out, and refuses to start while any
process group is open.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
import time
import traceback
from typing import Any, Dict, Iterator, Optional

import torch

from repro_torch import configs
from repro_torch.configs import shapes as shapes_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import roofline as roof_lib
from repro_torch.models import count_params
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import lm as lm_lib
from repro_torch.models import settings as settings_lib
from repro_torch.models.types import ModelConfig, ShapeSpec, map_specs
from repro_torch.sharding import ctx as ctx_lib
from repro_torch.sharding import rules as rules_lib
from repro_torch.train.train_loop import (TrainConfig, make_train_step,
                                          trainable_params)

__all__ = ["DEFAULT_TRAIN_CFG", "TRAIN_CFGS", "build_lowered", "lower_cell",
           "main"]

# per-arch training memory policy: bf16 moments for the 400B-class config
TRAIN_CFGS: Dict[str, TrainConfig] = {
    "llama4-maverick-400b-a17b": TrainConfig(moment_dtype="bfloat16"),
}
DEFAULT_TRAIN_CFG = TrainConfig()


def _param_specs(cfg: ModelConfig):
    return (encdec_lib if cfg.is_encdec else lm_lib).param_specs(cfg)


def _active_params(cfg) -> float:
    """Active parameters per token (MoE: routed experts only)."""
    total = count_params(_param_specs(cfg))
    if not cfg.num_experts:
        return float(total)
    f = cfg.moe_d_ff if cfg.moe_d_ff is not None else cfg.d_ff
    per_expert = 3 * cfg.d_model * f
    n_moe_layers = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    inactive = n_moe_layers * (cfg.num_experts - cfg.experts_per_token) \
        * per_expert
    return float(total - inactive)


def _cycle_info(cfg):
    period = cfg.moe_period if cfg.num_experts else 1
    cyc = math.lcm(len(cfg.block_pattern), period)
    n_cycles, rem = divmod(cfg.num_layers, cyc)
    return cyc, n_cycles, rem


def _depth_variant(cfg, n_cycles_target: int):
    """Same config with only n_cycles_target layer cycles (+ remainder)."""
    cyc, _, rem = _cycle_info(cfg)
    changes = {"num_layers": n_cycles_target * cyc + rem}
    if cfg.encoder_layers:
        enc_cyc, enc_n, enc_rem = 1, cfg.encoder_layers, 0
        changes["encoder_layers"] = n_cycles_target * enc_cyc + enc_rem
    return dataclasses.replace(cfg, **changes)


def _placed(shape, dtype, sharding: rules_lib.NamedSharding):
    """A DTensor on the meta device (no storage): this rank's slice of
    ``shape`` under ``sharding``, placed on its mesh."""
    from torch.distributed.tensor import DTensor
    local = torch.empty(rules_lib.local_shape(shape, sharding.spec,
                                              sharding.mesh), dtype=dtype,
                        device="meta")
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def _placed_tree(specs, rules, mesh, compute_dtype):
    return map_specs(lambda s: _placed(
        s.shape, s.storage_dtype(compute_dtype),
        rules_lib.sharding_for_spec(s, rules, mesh)), specs)


def _placed_batch(specs: Dict[str, torch.Tensor], rules, mesh):
    sh = rules_lib.batch_shardings(specs, rules, mesh)
    return {k: _placed(tuple(s.shape), s.dtype, sh[k])
            for k, s in specs.items()}


def build_lowered(cfg: ModelConfig, shape: ShapeSpec, mesh,
                  rules: rules_lib.Rules, tcfg: TrainConfig, *,
                  settings_kwargs: Dict[str, Any]) -> roof_lib.Counts:
    """Trace one step of ``shape`` (a :class:`ShapeSpec`: its kind picks
    the step) on ``mesh`` (a mesh of the ``meta`` device in an open fake
    world, inside :func:`_meta_mesh`), placed by ``rules``, and return
    what it did per device.  ``settings_kwargs`` are the model's
    settings (``vocab_chunk``)."""
    model_cls = encdec_lib.EncDec if cfg.is_encdec else lm_lib.LM
    params = _placed_tree(_param_specs(cfg), rules, mesh, cfg.compute_dtype)
    model = model_cls(cfg, device="meta", params=params)
    B, T = shape.global_batch, shape.seq_len
    with settings_lib.use(**settings_kwargs), ctx_lib.use(rules, mesh):
        if shape.kind == "train":
            step_fn, opt = make_train_step(model, tcfg)
            p = trainable_params(model)
            state = opt.init(p)
            batch = _placed_batch(shapes_lib.batch_specs(
                cfg, shape, with_labels=True), rules, mesh)
            with roof_lib.count() as counts:
                step_fn(p, state, batch)
            return counts
        with torch.no_grad():
            if shape.kind == "prefill":
                b_specs = shapes_lib.batch_specs(cfg, shape,
                                                 with_labels=False)
                if cfg.is_encdec:
                    s_specs = model.state_specs(
                        B, b_specs["tokens"].shape[1],
                        b_specs["frontend_embeds"].shape[1])
                else:
                    s_specs = model.state_specs(B, T)
                batch = _placed_batch(b_specs, rules, mesh)
                state = _placed_tree(s_specs, rules, mesh, cfg.compute_dtype)
                with roof_lib.count() as counts:
                    model.prefill(batch, state)
                return counts
            extra = (cfg.frontend_len,) if cfg.is_encdec else ()
            state = _placed_tree(model.state_specs(B, T, *extra), rules,
                                 mesh, cfg.compute_dtype)
            token = _placed_batch({"token": shapes_lib.decode_specs(
                cfg, shape)["token"]}, rules, mesh)["token"]
            with roof_lib.count() as counts:
                # the last slot: a full cache, the step the cell costs
                model.decode_step(token, T - 1, state)
            return counts


def _extrapolate(a: roof_lib.Roofline, b: roof_lib.Roofline,
                 n_cycles: int) -> roof_lib.Roofline:
    """total(n) = A + (n-1) * (B - A): A = 1-cycle step, B = 2-cycle."""
    k = n_cycles - 1
    coll = {key: int(a.collectives.get(key, 0)
                     + k * (b.collectives.get(key, 0)
                            - a.collectives.get(key, 0)))
            for key in set(a.collectives) | set(b.collectives)}
    return roof_lib.Roofline(
        flops=a.flops + k * (b.flops - a.flops),
        hbm_bytes=a.hbm_bytes + k * (b.hbm_bytes - a.hbm_bytes),
        wire_bytes=a.wire_bytes + k * (b.wire_bytes - a.wire_bytes),
        collectives=coll)


#: cards a host on the deployments the cells stand for (H100 nodes of 8)
CARDS_PER_HOST = 8


@contextlib.contextmanager
def _meta_mesh() -> Iterator[None]:
    """DTensor's redistribution costs ask how many devices a host holds
    of the mesh's device type, through that type's device module, which
    the ``meta`` device has none of: while a cell traces the answer is
    :data:`CARDS_PER_HOST` (a mesh axis longer than a host crosses the
    network)."""
    from torch.distributed.device_mesh import _mesh_resources
    orig = _mesh_resources.num_devices_per_host
    _mesh_resources.num_devices_per_host = (
        lambda device_type: CARDS_PER_HOST if device_type == "meta"
        else orig(device_type))
    try:
        yield
    finally:
        del _mesh_resources.num_devices_per_host


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               analyze: Optional[bool] = None,
               rule_overrides: Optional[Dict[str, Any]] = None,
               tcfg_override: Optional[TrainConfig] = None,
               mesh_shape: Optional[tuple] = None,
               settings_extra: Optional[Dict[str, Any]] = None,
               quiet: bool = False, cfg: Optional[ModelConfig] = None,
               shape: Optional[ShapeSpec] = None) -> Dict[str, Any]:
    """Trace one (arch x shape x mesh) cell and report.

    The TRUE config is traced once (the deployment proof: every op has a
    sharding rule at full depth; ``trace_s``).  FLOPs, bytes and
    collectives come from two cheap depth-reduced traces (1 and 2
    cycles) extrapolated affinely to the real depth, as the reference
    does.  ``cfg`` and ``shape`` replace the named config and shape
    (a reduced model, the card's own step); the cell keeps the names.
    """
    cfg = cfg or configs.get(arch)
    shape = shape or shapes_lib.SHAPES[shape_name]
    # a split's cell carries its name, a skipped one too (the reference
    # names a skipped split's cell 16x16, which --append never finds)
    mesh_name = f"dp{mesh_shape[0]}xtp{mesh_shape[1]}" if mesh_shape \
        else "2x16x16" if multi_pod else "16x16"
    cell: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                            "mesh": mesh_name, "ok": False}
    reason = shapes_lib.skip_reason(cfg, shape)
    if reason:
        cell["skipped"] = reason
        return cell
    if analyze is None:
        analyze = not multi_pod   # roofline table is single-pod
    if mesh_shape is not None:
        dims, axes = tuple(mesh_shape), ("data", "model")
    elif multi_pod:
        dims, axes = (2, 16, 16), ("pod", "data", "model")
    else:
        dims, axes = (16, 16), ("data", "model")
    chips = math.prod(dims)
    rules = rules_lib.production_rules(multi_pod=multi_pod)
    tp = dims[axes.index("model")]
    rules = rules.with_overrides(
        **rules_lib.arch_overrides(cfg, tp, kind=shape.kind))
    if rule_overrides:
        rules = rules.with_overrides(**rule_overrides)
    tcfg = tcfg_override or TRAIN_CFGS.get(arch, DEFAULT_TRAIN_CFG)
    settings_kwargs = dict(settings_extra or {})

    with mesh_lib.fake_world(chips), _meta_mesh():
        mesh = mesh_lib.make_mesh(dims, axes, device_type="meta")
        # --- 1. true-config trace: the deployment proof -------------------
        t0 = time.time()
        build_lowered(cfg, shape, mesh, rules, tcfg,
                      settings_kwargs=settings_kwargs)
        cell["trace_s"] = round(time.time() - t0, 1)
        cell["params_total"] = count_params(_param_specs(cfg))
        cell["params_active"] = _active_params(cfg)
        # --- 2. counts via the depth-reduced pair -------------------------
        if analyze:
            _, n_cycles, _ = _cycle_info(cfg)
            ra, rb = (roof_lib.analyze(build_lowered(
                _depth_variant(cfg, n), shape, mesh, rules, tcfg,
                settings_kwargs=settings_kwargs)) for n in (1, 2))
            roof = _extrapolate(ra, rb, n_cycles)
            cell["roofline"] = roof.as_dict()
            model_fl = roof_lib.model_flops_per_step(
                cell["params_active"], shape.tokens_per_step,
                training=(shape.kind == "train"))
            cell["model_flops"] = model_fl
            cell["model_flops_per_device"] = model_fl / chips
            cell["useful_flops_ratio"] = \
                (model_fl / chips) / roof.flops if roof.flops else None
            if not quiet:
                print(f"cost[{arch}/{shape_name}/{mesh_name}]: "
                      f"flops/dev={roof.flops:.3e} "
                      f"bytes/dev={roof.hbm_bytes:.3e} "
                      f"wire/dev={roof.wire_bytes:.3e} "
                      f"dominant={roof.dominant}", flush=True)
    cell["ok"] = True
    return cell


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="dry run over fake ranks")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    help="single: 16x16; multi: 2x16x16; both; splits: the "
                         "(data, model) splits of mesh_options(256), named "
                         "dp{d}xtp{m}, which the mesh selection ranks; or "
                         "one such name")
    ap.add_argument("--vocab-chunk", type=int, default=0,
                    help="train cells: the head over vocabulary chunks of "
                         "this many ids (the model setting vocab_chunk; 0: "
                         "the plain head)")
    ap.add_argument("--out", default="dryrun_report.json")
    ap.add_argument("--append", action="store_true",
                    help="merge results into an existing report")
    args = ap.parse_args(argv)

    archs = configs.ARCH_NAMES if args.arch == "all" else args.arch.split(",")
    shape_names = list(shapes_lib.SHAPES) if args.shape == "all" \
        else args.shape.split(",")
    # (mesh name, lower_cell's mesh arguments)
    meshes = {"single": [("16x16", {"multi_pod": False})],
              "multi": [("2x16x16", {"multi_pod": True})],
              "splits": [(name, {"multi_pod": False, "mesh_shape": dims})
                         for dims, name in mesh_lib.mesh_options(256)]}
    meshes["both"] = meshes["single"] + meshes["multi"]
    split = re.fullmatch(r"dp(\d+)xtp(\d+)", args.mesh)
    if split:
        meshes[args.mesh] = [(args.mesh, {"multi_pod": False, "mesh_shape":
                                          tuple(map(int, split.groups()))})]
    if args.mesh not in meshes:
        ap.error(f"--mesh {args.mesh!r}: expected one of {sorted(meshes)} "
                 f"or dp{{d}}xtp{{m}}")

    report = {"cells": []}
    if args.append and os.path.exists(args.out):
        with open(args.out) as f:
            report = json.load(f)
    done = {(c["arch"], c["shape"], c["mesh"]) for c in report["cells"]
            if c.get("ok") or c.get("skipped")}

    for mesh_name, mesh_kwargs in meshes[args.mesh]:
        for arch in archs:
            for shape_name in shape_names:
                key = (arch, shape_name, mesh_name)
                if key in done:
                    continue
                print(f"=== {arch} x {shape_name} x {mesh_name}", flush=True)
                try:
                    cell = lower_cell(arch, shape_name, settings_extra={
                        "vocab_chunk": args.vocab_chunk}, **mesh_kwargs)
                except Exception as e:
                    traceback.print_exc()
                    cell = {"arch": arch, "shape": shape_name,
                            "mesh": mesh_name, "ok": False,
                            "error": f"{type(e).__name__}: {e}"}
                report["cells"] = [c for c in report["cells"]
                                   if (c["arch"], c["shape"], c["mesh"])
                                   != key] + [cell]
                with open(args.out, "w") as f:
                    json.dump(report, f, indent=1)
    ok = sum(1 for c in report["cells"] if c.get("ok"))
    skip = sum(1 for c in report["cells"] if c.get("skipped"))
    err = sum(1 for c in report["cells"]
              if not c.get("ok") and not c.get("skipped"))
    print(f"dry-run complete: {ok} ok, {skip} skipped, {err} failed")
    if err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
