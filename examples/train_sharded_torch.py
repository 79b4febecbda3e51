"""Train the PyTorch port's LM on a (data, model) mesh, one process a rank.

A decoder-only architecture (dense, MoE with its experts split over the
model axis, RWKV-6, RG-LRU, vision-language), e.g.
``--arch qwen3-moe-30b-a3b --optimizer adafactor``:

    PYTHONPATH=src torchrun --nproc-per-node 4 \
        examples/train_sharded_torch.py --reduced --mesh 2x2 --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 4 \
        examples/train_sharded_torch.py --mesh 4x1     # four cards, NCCL

Each rank draws the weights from ``--seed`` one whole leaf at a time and
keeps its slice (``sharding.place.init_placed``: the same weights as the
one-process ``LM(cfg, seed=...)``), takes its rows of each batch
(``PrefetchIterator(shardings=)``), and runs ``train_loop`` over the
sharded step inside ``sharding.ctx.use(rules, mesh)``: FSDP for the
weights and the optimizer's state over ``data``, the heads, MLP,
experts and vocabulary over ``model``
(``sharding.rules.production_rules`` with the architecture's overrides).  On the CPU the ranks are gloo processes and
the kernels' plain versions run; on cards each rank takes the card of
its ``LOCAL_RANK``.
"""
import argparse
import os

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.data import pipeline
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lm as lm_lib
from repro_torch.models.types import ShapeSpec
from repro_torch.sharding import ctx, place
from repro_torch.sharding import rules as R
from repro_torch.train.train_loop import (TrainConfig, make_train_step,
                                          train_loop, trainable_params)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh", default="2x2", help="data x model, e.g. 4x1")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--optimizer", default="adamw",
                    choices=("adamw", "adafactor"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    dims = tuple(int(n) for n in args.mesh.split("x"))
    if args.device == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    dist.init_process_group("nccl" if args.device == "cuda" else "gloo")
    try:
        cfg = configs.get(args.arch)
        cfg = configs.reduced(cfg) if args.reduced else cfg
        mesh = make_mesh(dims, ("data", "model"), device_type=device.type)
        rules = R.production_rules().with_overrides(
            **R.arch_overrides(cfg, dims[1]))
        model = lm_lib.LM(cfg, device=device, params=place.init_placed(
            lm_lib.param_specs(cfg), rules, mesh, seed=args.seed,
            compute_dtype=cfg.compute_dtype, device=device))
        tcfg = TrainConfig(optimizer=args.optimizer)
        params = trainable_params(model)
        step, opt = make_train_step(model, tcfg)
        stream = pipeline.for_model(cfg, ShapeSpec(
            "train", args.seq, args.batch, "train"), seed=args.seed)
        shardings = R.batch_shardings(
            {k: torch.from_numpy(v) for k, v in stream.batch_at(0).items()},
            rules, mesh)
        batches = pipeline.PrefetchIterator(stream, device=device,
                                            shardings=shardings)
        try:
            with ctx.use(rules, mesh):
                _, _, hist = train_loop(model, tcfg, params, opt.init(params),
                                        batches, steps=args.steps,
                                        log_every=0, train_step=step)
        finally:
            batches.close()
        if dist.get_rank() == 0:
            print(f"{cfg.name} on {dims[0]} x {dims[1]} ({device.type}): "
                  f"losses {[round(x, 4) for x in hist['loss']]}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
