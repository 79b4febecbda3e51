"""Training launcher (counterpart of ``repro/launch/train.py``).

    python -m repro_torch.launch.train --arch qwen3-1.7b --reduced \
        --steps 3 --device cpu
    python -m repro_torch.launch.train --arch qwen3-1.7b --seq 1024 \
        --steps 10                                  # full width, the card

The reference's flags, plus ``--device`` (default ``cuda``; with no card
that raises ``BackendUnavailableError``).  ``--auto-mesh`` runs the paper's pipeline first:
classify the workload (training: class B), rank the dry-run report's
meshes under current chip prices through the port's selection service
(:func:`repro_torch.core.tpu_flora.service_from_dryrun_report`) and print
the winner.  Without ``--reduced`` the model runs at its published width
with random bf16 weights; ``--reduced`` trains the CPU tests' size.
``--ckpt-dir`` with ``--resume`` continues from the latest checkpoint.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch import configs
from repro_torch.core.costmodel import TpuPriceModel
from repro_torch.core.tpu_flora import service_from_dryrun_report
from repro_torch.data import pipeline as data_lib
from repro_torch.models import build_model, count_params
from repro_torch.models.types import ShapeSpec
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.train_loop import (StragglerWatchdog, TrainConfig,
                                          make_train_step, train_loop,
                                          trainable_params)


def select_mesh(report_path: str, market: str, device: str) -> str:
    """Rank the dry-run-profiled meshes via the selection service."""
    with open(report_path) as f:
        report = json.load(f)
    service = service_from_dryrun_report(report, TpuPriceModel(market),
                                         device=device)
    decision = service.submit("train_4k")
    print(f"[flora] class {decision.job_class.value} (streaming-compute) "
          f"-> mesh {decision.config_id} at {decision.hourly_cost:.2f} $/h")
    return str(decision.config_id)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced (CPU-sized) config")
    ap.add_argument("--d-model", type=int, default=None,
                    help="override reduced width (e.g. ~100M model)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--auto-mesh", action="store_true")
    ap.add_argument("--report", default="dryrun_single.json")
    ap.add_argument("--market", default="ondemand",
                    choices=["ondemand", "spot"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.auto_mesh and os.path.exists(args.report):
        select_mesh(args.report, args.market, args.device)

    cfg = configs.get(args.arch)
    if args.reduced:
        kw = {}
        if args.d_model:
            kw["d_model"] = args.d_model
        cfg = configs.reduced(cfg, **kw)
    model = build_model(cfg, device=args.device)
    n = count_params(model.param_specs())
    print(f"[train] {cfg.name}: {n / 1e6:.1f}M params, "
          f"{cfg.num_layers} layers, d_model={cfg.d_model} on "
          f"{model.device}")

    shape = ShapeSpec("cli", args.seq, args.batch, "train")
    stream = data_lib.for_model(cfg, shape)
    tcfg = TrainConfig(peak_lr=args.lr, warmup_steps=10,
                       total_steps=args.steps,
                       microbatches=args.microbatches)
    step_fn, opt = make_train_step(model, tcfg)

    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    params = trainable_params(model)
    opt_state = opt.init(params)
    if ckpt and args.resume and ckpt.latest_step() is not None:
        start = ckpt.restore_into(params, opt_state)
        print(f"[train] resumed from step {start}")

    watchdog = StragglerWatchdog()
    batches = data_lib.PrefetchIterator(stream, start_step=start,
                                        device=model.device)
    try:
        params, opt_state, hist = train_loop(
            model, tcfg, params, opt_state, batches, steps=args.steps,
            checkpointer=ckpt, checkpoint_every=args.ckpt_every,
            watchdog=watchdog, start_step=start, train_step=step_fn)
    finally:
        batches.close()
    if ckpt:
        ckpt.save(args.steps, params, opt_state, block=True)
    if hist["loss"]:
        print(f"[train] done: loss {hist['loss'][0]:.3f} -> "
              f"{hist['loss'][-1]:.3f} over {len(hist['loss'])} steps; "
              f"straggler events: {len(watchdog.events)}")
    else:
        print(f"[train] done: nothing to run past step {start}")


if __name__ == "__main__":
    main()
