"""Serve a model with batched requests through the engine.

    python -m repro_torch.serve --arch qwen3-1.7b            # full width, card
    python -m repro_torch.serve --arch rwkv6-3b --reduced --device cpu
    python -m repro_torch.serve --arch qwen3-moe-30b-a3b --reduced --device cpu
    python -m repro_torch.serve --arch recurrentgemma-9b --reduced --device cpu
    python -m repro_torch.serve --arch seamless-m4t-large-v2 --reduced --device cpu
    python -m repro_torch.serve --arch pixtral-12b --reduced --device cpu

``--arch`` takes every architecture the port serves (``configs.PORTED``):
the dense, MoE, RWKV-6, RG-LRU hybrid, encoder-decoder and
vision-language families.  At full width ``llama4-maverick-400b-a17b``
(398 B parameters) does not fit one card.  An encoder-decoder model's
requests each carry ``--frames`` source frame embeddings, a
vision-language model's ``--frames`` image patch embeddings ahead of the
prompt (default: the config's ``frontend_len``, 1,024 patches for
pixtral-12b, 8 reduced), drawn from ``--seed`` like the prompts.

The counterpart of the reference's ``examples/serve_lm.py``.  Without
``--reduced`` the model runs at the published width with random bf16
weights drawn from ``--seed`` on the card; ``--reduced --device cpu``
runs the reference example's small run on the CPU.  With ``--report
R.json`` (a dry-run report) the decode fleet's mesh is first planned
through the selection service (class A, state-resident), and the engine
records the placement.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.costmodel import TpuPriceModel
from repro_torch.core.tpu_flora import service_from_dryrun_report
from repro_torch.kernels import ops
from repro_torch.models import build_model, count_params
from repro_torch.serve.engine import Engine, Request, plan_decode_placement


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b", choices=configs.PORTED)
    ap.add_argument("--reduced", action="store_true",
                    help="the same-family shrunken config (CPU tests' size)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--frames", type=int, default=None,
                    help="source frames (encoder-decoder) or image patches "
                         "(vision-language) a request (default: the "
                         "config's frontend_len)")
    ap.add_argument("--max-len", type=int, default=None,
                    help="cache length (default: max(64, prompt + new), "
                         "plus the patches of a vision-language model)")
    ap.add_argument("--report", default=None,
                    help="dry-run report: plan the decode mesh via the "
                         "selection service before serving")
    ap.add_argument("--market", default="ondemand",
                    choices=["ondemand", "spot"])
    args = ap.parse_args(argv)

    placement = None
    if args.report and os.path.exists(args.report):
        with open(args.report) as f:
            service = service_from_dryrun_report(
                json.load(f), TpuPriceModel(args.market),
                device=args.device)
        placement = plan_decode_placement(service)
        print(f"[serve] placement: mesh {placement.config_id} "
              f"at {placement.hourly_cost:.2f} $/h "
              f"(class {placement.job_class.value})")

    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = configs.reduced(cfg)
    model = build_model(cfg, device=args.device, seed=args.seed)
    width = "reduced" if args.reduced else "full width"
    print(f"[serve] {cfg.name} ({width}, {cfg.dtype}) on {model.device}: "
          f"{count_params(model.param_specs()) / 1e6:.1f}M params, "
          f"{args.slots} decode slots")

    n_frames = 0
    if cfg.frontend:
        n_frames = args.frames or cfg.frontend_len
    # a vision-language model's patches share the self caches
    patches = n_frames if cfg.frontend == "vision" else 0
    max_len = args.max_len or patches + max(64, args.prompt_len
                                            + args.max_new)
    eng = Engine(model, slots=args.slots, max_len=max_len,
                 enc_len=n_frames if cfg.is_encdec else 0,
                 placement=placement, device=args.device)
    rng = np.random.default_rng(args.seed + 1)
    reqs = []
    for i in range(args.requests):
        frames = rng.standard_normal((n_frames, cfg.d_model)).astype(
            np.float32) if n_frames else None
        reqs.append(Request(uid=i, prompt=rng.integers(0, cfg.vocab_size,
                                                       args.prompt_len),
                            max_new_tokens=args.max_new, frames=frames))
    ops.reset_launches()
    t0 = time.perf_counter()
    comps = eng.serve(reqs)
    secs = time.perf_counter() - t0
    for c in sorted(comps, key=lambda c: c.uid):
        print(f"  req {c.uid}: {len(c.tokens)} tokens "
              f"(prefill {c.prefill_ms:.0f} ms, decode {c.decode_ms:.0f} ms)"
              f" -> {c.tokens[:8]}")
    new = sum(len(c.tokens) for c in comps)
    print(f"[serve] {len(comps)} requests, {new} new tokens in {secs:.3f} s "
          f"({eng.prefills} prefills, {eng.decode_steps} decode steps); "
          f"kernel launches {ops.launches()}")
    if torch.cuda.is_available() and model.device.type == "cuda":
        print(f"[serve] device {torch.cuda.get_device_name(model.device)}")


if __name__ == "__main__":
    main()
