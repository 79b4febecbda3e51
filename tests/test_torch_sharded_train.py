"""The port's sharded training on gloo CPU ranks (one process a rank)
against the one-process port step and the reference's jitted step on a
mesh of 4 XLA CPU devices.

The reference's sharded step runs on a mesh built with Auto axes
(``repro.launch.mesh.make_mesh`` builds Explicit axes on this JAX, on
which the step raises at the embedding gather); the port's on four gloo
ranks, its weights placed leaf by leaf from the reference's
``LM.init(PRNGKey(0))`` (``convert.lm_tree_from_reference``,
``place.place_tree``), the batch by ``batch_shardings``, the step inside
``ctx.use(rules, mesh)``.  Reduced configs in float32, 4 x 16 tokens
(labels of the first row masked in part):

* qwen3-1.7b and rwkv6-3b at 2 x 2, 4 x 1 and 1 x 4, 3 AdamW steps (the
  reference's ``TrainConfig`` defaults; the port with remat, the
  reference without: remat changes no value): each step's loss within
  relative 1e-5 of the one-process port's and of the reference's sharded
  step's (on 2 x 2); the first step's gradient leaves and the weights
  after 3 steps within relative L2 1e-4 a leaf (a first AdamW step moves
  an element whose gradient is near zero by about lr either way, so the
  weights are compared as leaves, not elementwise).  Where float32 itself
  errs by more than that on a gradient leaf (rwkv6-3b's first bonus
  ``tm.u`` on this batch: the one-process port's, the reference's and
  every mesh's float32 gradient lie 2e-4 to 3.3e-4 from a float64 run of
  the port, its sums cancelling), the leaf must lie no farther from the
  float64 gradient than the reference's float32 one;
* on 2 x 2, one step of AdamW with bf16 moments, of Adafactor and of
  ``microbatches=2``, against both, within the same limits;
* the int8 compressed all-reduce in the step (``make_compressed_allreduce``
  on the data axis): each gradient element within ``n * scale / 2`` of
  the exact sum; and ROADMAP.md §C entries 11 and 14 pinned on 2 gloo
  ranks (the data axis) and on a 2-device XLA CPU mesh; error feedback
  keeping one residual a rank;
* the head over vocabulary chunks (``vocab_chunk`` 100, ragged on every
  rank's slice) at 2 x 2, 4 x 1 and 1 x 4, on a batch whose labels
  include -1 and the ids on the slices' and chunks' edges: the loss
  within relative 1e-5 and each gradient leaf within relative L2 1e-4 of
  the one-process chunked head's, the same mesh's plain head's and, on 2
  x 2, the reference's chunked head's; and, at 2 x 2 over 64 tokens a
  sequence, every tensor ``LM.loss`` saves for its backward: none of
  the chunked head's a float32 tensor of a rank's (B / 2, T, V / 2)
  logits' size or more, as the plain head's exponentials are;
* elastic restore: saved at 2 x 2 after step 2, restored at 4 x 1 and in
  one process, steps 3-4 within the limits of the uninterrupted run;
* ``PrefetchIterator(shardings=)``: each rank's rows equal the shard the
  reference's iterator puts on the same device index;
* ``place.init_placed`` and ``place.place_tree``: each leaf's whole value
  equal to the one-process model's, bit for bit;
* the dry run's count of one step (reduced qwen3-1.7b at 2 x 2, this
  test's shape) on the gloo ranks equal to its count on meta tensors in
  a fake world: FLOPs, and collectives by kind.  The count holds only
  where DTensor plans as the dry run does: this launch alone takes the
  dry run's host of 8 devices and gloo's own all-to-all (see its
  comments); the steps run stock DTensor.

One launch of four ranks does the port's steps and one the count,
beside a JAX subprocess an architecture; all start together.
"""
import dataclasses
import os
import pickle
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import build_model as ref_build_model
from repro_torch import convert
from repro_torch.launch import dryrun
from repro_torch.models import lm as lm_lib
from repro_torch.models.types import ShapeSpec
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.train_loop import (TrainConfig, make_train_step,
                                          trainable_params)

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ("qwen3-1.7b", "rwkv6-3b")
MESHES = ((2, 2), (4, 1), (1, 4))
B, T, STEPS = 4, 16, 3
LOSS_RTOL, LEAF_L2 = 1e-5, 1e-4
#: one step each on 2 x 2, from the initial weights on the first batch
VARIANTS = {"adamw_bf16": {"moment_dtype": "bfloat16"},
            "adafactor": {"optimizer": "adafactor"},
            "micro2": {"microbatches": 2}}
#: the head's vocabulary chunks: 512 ids, 256, 512 and 128 a rank on
#: 2 x 2, 4 x 1 and 1 x 4, each rank's last chunk ragged
VOCAB_CHUNK = 100
#: labels on the edges of the ranks' slices and of the chunks
EDGE_LABELS = [0, 99, 100, 127, 128, 255, 256, 355, 356, 383, 384, 511]
#: the saved-tensor probe's tokens a sequence (2 x 64 x 256 elements a
#: rank's logits, more than its (256, 64) slice of the table)
PROBE_T = 64
#: the compression pins' two shards (ROADMAP.md §C entry 11)
SHARDS = ([1.0, -0.5, 0.25, 0.1], [0.01, 0.02, -0.01, 0.005])
REF_ENTRY_11 = [1.496, 0.496, -0.244, 0.354]
#: the reference's all-reduce of the first shard, replicated over 2
#: devices: the two copies summed, each quantised
REF_ENTRY_14 = [2.0, -1.0079, 0.5039, 0.2047]

JAX_CHILD = textwrap.dedent("""
    import pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.experimental.shard_map import shard_map
    from jax.sharding import AxisType, PartitionSpec as P
    from repro.data import pipeline
    from repro.models import build_model, settings
    from repro.sharding import ctx as ctx_lib, rules as rules_lib
    from repro.train import compression as comp
    from repro.train.train_loop import TrainConfig, make_train_step
    import repro.configs as RC
    with open(sys.argv[1], "rb") as f:
        inp = pickle.load(f)
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:4])
    out = {}
    for arch in sys.argv[3:]:
        case = inp["archs"][arch]
        cfg = RC.reduced(RC.get(arch))
        model = build_model(cfg)
        rules = rules_lib.production_rules().with_overrides(
            **rules_lib.arch_overrides(cfg, 2))
        specs = model.param_specs()
        p_sh = rules_lib.tree_shardings(specs, rules, mesh)
        bs = [{k: jnp.asarray(v) for k, v in b.items()}
              for b in case["batches"]]
        b_sh = rules_lib.batch_shardings(bs[0], rules, mesh)
        params = jax.device_put(case["params0"], p_sh)
        loss_fn = lambda p, b: model.loss(p, b, remat=False)
        step, opt = make_train_step(model, TrainConfig(remat=False))
        o_sh = rules_lib.tree_shardings(opt.state_specs(specs), rules, mesh)

        def main(p, s, b):   # the gradients and the step: one compile
            return jax.value_and_grad(loss_fn, has_aux=True)(p, b), \\
                step(p, s, b)
        r = {}
        with mesh, ctx_lib.use(rules, mesh):
            run = jax.jit(main, in_shardings=(p_sh, o_sh, b_sh))
            p, s, losses = params, jax.device_put(opt.init(params), o_sh), []
            for i, b in enumerate(bs[:inp["steps"]]):
                ((_, _), g), (p, s, m) = run(p, s, b)
                p, s = jax.device_put(p, p_sh), jax.device_put(s, o_sh)
                losses.append(float(m["loss"]))
                if i == 0:
                    r["grads"] = host(g)
            r["losses"], r["params"] = losses, host(p)
            # the chunked head on the head batch
            hb = {k: jnp.asarray(v) for k, v in case["head_batch"].items()}
            with settings.use(vocab_chunk=inp["vocab_chunk"]):
                (loss, _), g = jax.jit(
                    jax.value_and_grad(loss_fn, has_aux=True),
                    in_shardings=(p_sh, b_sh))(params, hb)
            r["chunked"] = {"loss": float(loss), "grads": host(g)}
            if arch == "qwen3-1.7b":
                steps = {n: make_train_step(model, TrainConfig(
                    remat=False, **kw)) for n, kw in inp["variants"].items()}
                states = {n: o.init(params) for n, (_, o) in steps.items()}
                s_sh = {n: rules_lib.tree_shardings(o.state_specs(specs),
                                                    rules, mesh)
                        for n, (_, o) in steps.items()}

                def variants(p, states, b):   # one compile for all
                    return {n: fn(p, states[n], b)
                            for n, (fn, _) in steps.items()}
                got = jax.jit(variants, in_shardings=(p_sh, s_sh, b_sh))(
                    params, states, bs[0])
                r["variants"] = {n: {"loss": float(m["loss"]),
                                     "params": host(p)}
                                 for n, (p, _, m) in got.items()}
                stream = pipeline.TokenStream(pipeline.DataConfig(
                    vocab_size=cfg.vocab_size, seq_len=inp["T"],
                    global_batch=inp["B"]))
                it = pipeline.PrefetchIterator(stream, shardings=b_sh)
                batch = next(it)
                it.close()
                out["prefetch"] = {
                    k: [np.asarray({s.device: s.data for s in
                                    v.addressable_shards}[d])
                        for d in mesh.devices.flat]
                    for k, v in batch.items()}
        out[arch] = r
    if "qwen3-1.7b" in sys.argv[3:]:
        m2 = jax.make_mesh((2,), ("data",), axis_types=(AxisType.Auto,),
                           devices=jax.devices()[:2])
        psum = shard_map(lambda x: comp.compressed_psum(x, "data"), mesh=m2,
                         in_specs=P("data"), out_specs=P(), check_rep=False)
        out["entry_11"] = np.asarray(psum(jnp.asarray(
            np.concatenate(inp["shards"]), jnp.float32)))
        with m2:
            out["entry_14"] = np.asarray(comp.make_compressed_allreduce(m2)(
                {"g": jnp.asarray(inp["shards"][0], jnp.float32)})["g"])
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
""")

RANK_CHILD = textwrap.dedent("""
    import os, pickle, sys, time
    import numpy as np, torch, torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from repro_torch import configs, convert
    from repro_torch.data import pipeline
    from repro_torch.launch import roofline
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm as lm_lib
    from repro_torch.sharding import ctx, place, rules as R
    from repro_torch.train.checkpoint import Checkpointer
    from repro_torch.models import settings as msettings
    from repro_torch.train.compression import (ErrorFeedback,
                                               compressed_psum,
                                               make_compressed_allreduce)
    from repro_torch.train.train_loop import (TrainConfig, make_train_step,
                                              trainable_params)
    # started before the inputs are written: the imports overlap the
    # reference's initialisation
    deadline = time.monotonic() + 300
    while not os.path.exists(sys.argv[1]):
        assert time.monotonic() < deadline, "no inputs"
        time.sleep(0.05)
    with open(sys.argv[1], "rb") as f:
        inp = pickle.load(f)
    out_dir, COUNT = sys.argv[2], sys.argv[3] == "count"
    if COUNT:
        # the count's launch alone plans the step as the dry run plans
        # it, the steps' launch runs stock DTensor: DTensor's cost model
        # takes a CPU for a host of one device (every mesh axis off the
        # host), the dry run a host of CARDS_PER_HOST (8) cards; and on a
        # CPU mesh DTensor runs an all-to-all as an all-gather and a
        # chunk (its note: gloo had none), where gloo has one, and a card
        # (and the meta mesh) runs it
        from torch.distributed.device_mesh import _mesh_resources
        from torch.distributed.tensor import placement_types
        _mesh_resources.num_devices_per_host = lambda device_type: 8
        placement_types.shard_dim_alltoall = \
            lambda input, gather_dim, shard_dim, mesh, mesh_dim: \
            torch.ops._dtensor.shard_dim_alltoall(
                input, gather_dim, shard_dim,
                mesh.get_group(mesh_dim).group_name)
    dist.init_process_group("gloo")
    rank, cpu = dist.get_rank(), torch.device("cpu")
    whole = lambda t: (t.full_tensor() if isinstance(t, DTensor) else t
                       ).detach().numpy().copy()
    out = {}

    def setup(arch, dims, tree=None, seed=0):
        cfg = configs.reduced(configs.get(arch))
        mesh = make_mesh(dims, ("data", "model"), device_type="cpu")
        rules = R.production_rules().with_overrides(
            **R.arch_overrides(cfg, dims[1]))
        specs = lm_lib.param_specs(cfg)
        if tree is None:
            placed = place.init_placed(specs, rules, mesh, seed=seed,
                                       compute_dtype=cfg.compute_dtype,
                                       device=cpu)
        else:
            placed = place.place_tree(tree, R.tree_shardings(specs, rules,
                                                             mesh))
        return cfg, mesh, rules, lm_lib.LM(cfg, device="cpu", params=placed)

    def recording(seen):
        # a compress_fn that records each gradient's whole value (its
        # partial sums reduced) and hands the gradients on unchanged: the
        # step then reduces them itself, as without one
        def hook(grads):
            if not seen:
                seen.update({k: whole(g) for k, g in grads.items()})
            return grads
        return hook

    if COUNT:
        # the dry run's count of one step on these ranks
        _, mesh, rules, model = setup("qwen3-1.7b", (2, 2), seed=0)
        step, opt = make_train_step(model, TrainConfig())
        p = trainable_params(model)
        s = opt.init(p)
        batch = place.place_batch(inp["archs"]["qwen3-1.7b"]["batches"][0],
                                  rules, mesh)
        with ctx.use(rules, mesh), roofline.count() as counts:
            step(p, s, batch)
        with open(os.path.join(out_dir, f"count{rank}.pkl"), "wb") as f:
            pickle.dump((counts.flops, dict(counts.collectives)), f)
        dist.destroy_process_group()
        sys.exit()

    def same(model, want):
        return all(np.array_equal(whole(v), want[k].detach().numpy())
                   for k, v in model.named_parameters())

    # the sliced initialiser on each mesh
    for arch in inp["archs"]:
        cfg = configs.reduced(configs.get(arch))
        one = dict(lm_lib.LM(cfg, device="cpu", seed=3).named_parameters())
        for dims in map(tuple, inp["meshes"]):
            out[("placed_equal", arch, dims)] = same(
                setup(arch, dims, seed=3)[3], one)

    # the steps on each mesh, from the placed tree (the placement
    # function); qwen3-1.7b's 2 x 2 run saves after step 2 and takes a
    # 4th step (the elastic restore's uninterrupted run)
    ck = Checkpointer(os.path.join(out_dir, "ckpt"), keep=2)
    for arch, case in inp["archs"].items():
        cfg = configs.reduced(configs.get(arch))
        tree = convert.lm_tree_from_reference(cfg, case["params0"])
        plain = dict(lm_lib.LM(cfg, device="cpu",
                               params=tree).named_parameters())
        for dims in map(tuple, inp["meshes"]):
            cfg, mesh, rules, model = setup(arch, dims, tree=tree)
            out[("placed_equal", arch, dims)] &= same(model, plain)
            r = {"grads": {}}
            step, opt = make_train_step(model, TrainConfig(),
                                        compress_fn=recording(r["grads"]))
            p = trainable_params(model)
            s = opt.init(p)
            elastic = arch == "qwen3-1.7b" and dims == (2, 2)
            losses = []
            with ctx.use(rules, mesh):
                for i, b in enumerate(case["batches"][:inp["steps"]]):
                    p, s, m = step(p, s, b)
                    losses.append(float(m["loss"]))
                    if elastic and i == 1:
                        ck.save(2, p, s)
                r["losses"] = losses
                r["params"] = {k: whole(v) for k, v in p.items()}
                if elastic:
                    p, s, m = step(p, s, case["batches"][3])
                    r["loss_4"] = float(m["loss"])
                    r["params_4"] = {k: whole(v) for k, v in p.items()}
            out[(arch, dims)] = r

    # qwen3-1.7b's variants on 2 x 2: one step each
    case = inp["archs"]["qwen3-1.7b"]
    tree = convert.lm_tree_from_reference(
        configs.reduced(configs.get("qwen3-1.7b")), case["params0"])
    for name, kw in list(inp["variants"].items()) + [("compressed", {})]:
        cfg, mesh, rules, model = setup("qwen3-1.7b", (2, 2), tree=tree)
        seen = {}
        reduce = make_compressed_allreduce(mesh)

        def compress(grads):
            got = reduce(grads)
            for k, g in grads.items():
                # n * scale / 2 a data group, the scale agreed over it
                bound = g.to_local().float().abs().max()
                dist.all_reduce(bound, op=dist.ReduceOp.MAX,
                                group=mesh.get_group("data"))
                bound = 2 * bound / 127 / 2
                # the whole leaf's: the model slices' summed where they
                # are partial sums, their largest where they are slices
                model = g.placements[1]
                if not model.is_replicate():
                    dist.all_reduce(bound, group=mesh.get_group("model"),
                                    op=dist.ReduceOp.SUM if
                                    model.is_partial() else
                                    dist.ReduceOp.MAX)
                seen[k] = (whole(got[k]), float(bound))
            return got
        step, opt = make_train_step(
            model, TrainConfig(**kw),
            compress_fn=compress if name == "compressed" else None)
        p = trainable_params(model)
        with ctx.use(rules, mesh):
            p, _, m = step(p, opt.init(p), case["batches"][0])
        out[("variant", name)] = {"loss": float(m["loss"]),
                                  "params": {k: whole(v)
                                             for k, v in p.items()},
                                  "compressed": seen}

    # the elastic restore at 4 x 1: steps 3 and 4 from the 2 x 2 save
    ck.wait()
    cfg, mesh, rules, model = setup("qwen3-1.7b", (4, 1), seed=7)
    step, opt = make_train_step(model, TrainConfig())
    p = trainable_params(model)
    s = opt.init(p)
    restored_at = ck.restore_into(p, s)
    # the reference's form: whole templates and a tree of NamedShardings
    specs = lm_lib.named_specs(cfg)
    shardings = {"params": {k: R.sharding_for_spec(specs[k], rules, mesh)
                            for k in p}}
    tree, _ = ck.restore({"params": {k: torch.empty(v.shape, dtype=v.dtype)
                                     for k, v in p.items()}},
                         shardings=shardings)
    out["restore_shardings_equal"] = all(
        t.placements == p[k].placements and
        torch.equal(t.to_local(), p[k].to_local().detach())
        for k, t in tree["params"].items())
    losses = []
    with ctx.use(rules, mesh):
        for b in case["batches"][2:4]:
            p, s, m = step(p, s, b)
            losses.append(float(m["loss"]))
    out["elastic"] = {"step": restored_at, "losses": losses,
                      "params": {k: whole(v) for k, v in p.items()}}

    # the sharded prefetch's rows at 2 x 2
    cfg, mesh, rules, model = setup("qwen3-1.7b", (2, 2), seed=0)
    stream = pipeline.TokenStream(pipeline.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=inp["T"], global_batch=inp["B"]))
    sh = R.batch_shardings({k: torch.empty(inp["B"], inp["T"])
                            for k in ("tokens", "labels")}, rules, mesh)
    it = pipeline.PrefetchIterator(stream, shardings=sh)
    out["prefetch"] = {k: v.to_local().numpy().copy()
                       for k, v in next(it).items()}
    it.close()

    # the compression pins on the data axis (2 ranks a group)
    data = mesh.get_coordinate()[0]
    x = torch.tensor(inp["shards"][data])
    out["entry_11"] = compressed_psum(x, mesh.get_group("data")).numpy()
    reduce = make_compressed_allreduce(mesh)
    rep = DTensor.from_local(torch.tensor(inp["shards"][0]), mesh,
                             [Replicate(), Replicate()], run_check=False)
    part = DTensor.from_local(x, mesh, [Partial(), Replicate()],
                              run_check=False)
    got = reduce({"rep": rep, "part": part})
    out["entry_14"] = whole(got["rep"])
    out["partial"] = (whole(got["part"]), got["part"].placements)
    # error feedback on a DTensor gradient: one residual a rank, its
    # local part's shape, and dequantised + residual = the local part
    ef = ErrorFeedback()
    res = ef.init({"part": part})["part"]
    deq, res = ef.compress({"part": part}, {"part": res})
    out["error_feedback"] = (
        deq["part"].placements == part.placements,
        tuple(res["part"].shape) == tuple(part.to_local().shape),
        torch.allclose(deq["part"].to_local() + res["part"],
                       part.to_local(), rtol=0, atol=1e-7))

    def head_grads(model, rules, mesh, batch, chunk):
        # the loss and its gradients, whole, through the head over chunks
        # of ``chunk`` ids (0: the plain head)
        p = trainable_params(model)
        with ctx.use(rules, mesh), ctx.spmd(), \
                msettings.use(vocab_chunk=chunk):
            loss, _ = model.loss(place.place_batch(batch, rules, mesh))
            g = torch.autograd.grad(loss, list(p.values()))
        return {"loss": float(whole(loss)),
                "grads": {k: whole(v) for k, v in zip(p, g)}}

    # the head over vocabulary chunks on each mesh, and the plain head
    for arch, case in inp["archs"].items():
        tree = convert.lm_tree_from_reference(
            configs.reduced(configs.get(arch)), case["params0"])
        for dims in map(tuple, inp["meshes"]):
            _, mesh, rules, model = setup(arch, dims, tree=tree)
            for chunk in (inp["vocab_chunk"], 0):
                out[("head", arch, dims, chunk)] = head_grads(
                    model, rules, mesh, case["head_batch"], chunk)

    # what LM.loss saves for its backward at 2 x 2, chunked and plain:
    # each saved tensor's dtype and size on this rank
    _, mesh, rules, model = setup("qwen3-1.7b", (2, 2), seed=0)
    trainable_params(model)
    for chunk in (inp["vocab_chunk"], 0):
        seen = out[("saved", chunk)] = []

        def pack(t):
            local = t._local_tensor if isinstance(t, DTensor) else t
            seen.append((local.dtype, local.numel()))
            return t
        with ctx.use(rules, mesh), ctx.spmd(), \
                msettings.use(vocab_chunk=chunk), \
                torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = model.loss(place.place_batch(inp["probe_batch"], rules,
                                                   mesh))
            loss.backward()

    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()
""")


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _batches(cfg, n, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        labels = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
        labels[0, :5] = -1
        out.append({"tokens": rng.integers(0, cfg.vocab_size, (B, T))
                    .astype(np.int32), "labels": labels})
    return out


def _head_batch(cfg, T, seed=2):
    """A batch whose labels hold -1 (the first row's first 5) and every
    id of ``EDGE_LABELS`` (the second row's first 12)."""
    rng = np.random.default_rng(seed)
    b = {k: rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
         for k in ("tokens", "labels")}
    b["labels"][0, :5] = -1
    b["labels"][1, :len(EDGE_LABELS)] = EDGE_LABELS
    return b


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _port_cfg(arch):
    return convert.model_config_from_reference(
        dataclasses.asdict(RC.reduced(RC.get(arch))))


def _one_process(arch, case, tcfg=None, batches=None, model=None):
    """The one-process port: the first batch's gradients, and the steps
    of ``tcfg`` over ``batches`` (default: AdamW over the first
    ``STEPS``)."""
    cfg = _port_cfg(arch)
    if model is None:
        model = lm_lib.LM(cfg, device="cpu", params=convert.
                          lm_tree_from_reference(cfg, case["params0"]))
    p = trainable_params(model)
    tb = {k: torch.from_numpy(v) for k, v in case["batches"][0].items()}
    loss, _ = model.loss(tb)
    grads = {k: g.numpy() for k, g in zip(p, torch.autograd.grad(
        loss, list(p.values())))}
    grads64 = _grads64(cfg, case) if tcfg is None else None
    step, opt = make_train_step(model, tcfg or TrainConfig())
    s, losses = opt.init(p), []
    for b in batches if batches is not None else case["batches"][:STEPS]:
        p, s, m = step(p, s, b)
        losses.append(float(m["loss"]))
    return {"grads": grads, "grads64": grads64, "losses": losses,
            "model": model,
            "params": {k: v.detach().numpy().copy() for k, v in p.items()}}


def _one_head(arch, case):
    """The one-process chunked head's loss and gradients on the head
    batch, from the initial weights."""
    from repro_torch.models import settings as psettings
    cfg = _port_cfg(arch)
    model = lm_lib.LM(cfg, device="cpu", params=convert.
                      lm_tree_from_reference(cfg, case["params0"]))
    p = trainable_params(model)
    with psettings.use(vocab_chunk=VOCAB_CHUNK):
        loss, _ = model.loss({k: torch.from_numpy(v)
                              for k, v in case["head_batch"].items()})
    g = torch.autograd.grad(loss, list(p.values()))
    return {"loss": float(loss.detach()),
            "grads": {k: v.numpy() for k, v in zip(p, g)}}


def _grads64(cfg, case):
    """The first batch's gradients of the one-process port in float64:
    its weights in float64, and ``Tensor.float`` (the model's float32
    internals) taken for ``Tensor.double``."""
    model = lm_lib.LM(cfg, device="cpu", params=convert.
                      lm_tree_from_reference(cfg, case["params0"]))
    model = model.to(torch.float64)
    p = trainable_params(model)
    tb = {k: torch.from_numpy(v) for k, v in case["batches"][0].items()}
    f32 = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double
    try:
        loss, _ = model.loss(tb)
        g = torch.autograd.grad(loss, list(p.values()))
    finally:
        torch.Tensor.float = f32
    return {k: v.numpy() for k, v in zip(p, g)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The reference's sharded steps (a JAX subprocess over 4 XLA CPU
    devices), the port's on 4 gloo ranks (started together), the
    one-process port's, and the dry run's meta count."""
    tmp = tmp_path_factory.mktemp("sharded")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    # the port: one launch of four ranks for the steps, one for the
    # count, started first (each waits for the inputs)
    ranks = []
    for mode in ("steps", "count"):
        port = _free_port()
        ranks += [subprocess.Popen(
            [sys.executable, "-c", RANK_CHILD, str(tmp / "inputs.pkl"),
             str(tmp), mode], env=dict(env, MASTER_ADDR="localhost",
                                       MASTER_PORT=str(port), RANK=str(r),
                                       WORLD_SIZE="4"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(4)]
    inp = {"archs": {}, "meshes": [list(m) for m in MESHES],
           "variants": VARIANTS, "steps": STEPS, "B": B, "T": T,
           "shards": [np.asarray(x, np.float32) for x in SHARDS],
           "vocab_chunk": VOCAB_CHUNK}
    try:
        for arch in ARCHS:
            rcfg = RC.reduced(RC.get(arch))
            params = ref_build_model(rcfg).init(jax.random.PRNGKey(0))
            inp["archs"][arch] = {
                "params0": jax.tree_util.tree_map(np.asarray, params),
                "batches": _batches(rcfg, STEPS + 1),
                "head_batch": _head_batch(rcfg, T)}
        inp["probe_batch"] = _head_batch(RC.reduced(RC.get("qwen3-1.7b")),
                                         PROBE_T)
        with open(tmp / "inputs.part", "wb") as f:
            pickle.dump(inp, f)
        os.replace(tmp / "inputs.part", tmp / "inputs.pkl")
    except BaseException:
        for p in ranks:
            p.kill()
        raise
    # the reference, one process an architecture
    refs = [subprocess.Popen([sys.executable, "-c", JAX_CHILD,
                              str(tmp / "inputs.pkl"),
                              str(tmp / f"ref-{arch}.pkl"), arch],
                             env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for arch in ARCHS]
    # meanwhile, in this process: the one-process port and the meta count
    one = {arch: _one_process(arch, inp["archs"][arch]) for arch in ARCHS}
    for arch in ARCHS:
        one[arch]["head"] = _one_head(arch, inp["archs"][arch])
    case = inp["archs"]["qwen3-1.7b"]
    one["variants"] = {n: _one_process("qwen3-1.7b", case, TrainConfig(**kw),
                                       case["batches"][:1])
                       for n, kw in VARIANTS.items()}
    cell = dryrun.lower_cell("qwen3-1.7b", "train_4k", multi_pod=False,
                             mesh_shape=(2, 2), cfg=_port_cfg("qwen3-1.7b"),
                             shape=ShapeSpec("train", T, B, "train"),
                             quiet=True)
    for p in ranks:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-4000:]
    want = {}
    for arch, ref in zip(ARCHS, refs):
        _, err = ref.communicate(timeout=600)
        assert ref.returncode == 0, err[-4000:]
        with open(tmp / f"ref-{arch}.pkl", "rb") as f:
            want.update(pickle.load(f))
    got = []
    for r in range(4):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
        with open(tmp / f"count{r}.pkl", "rb") as f:
            got[-1]["count"] = pickle.load(f)
    return {"inp": inp, "ref": want, "ranks": got, "one": one,
            "cell": cell, "ckpt": tmp / "ckpt"}


def _ref_by_name(arch, ref_tree, model):
    """The reference's cycle-stacked leaves unstacked by the port's
    parameter names."""
    out = {}
    for path, members in model.param_groups():
        leaf = ref_tree
        for k in path:
            leaf = leaf[k]
        leaf = np.asarray(leaf)
        if path[1:2] == ("cycles",):
            out.update({n: leaf[i] for i, n in enumerate(members)})
        else:
            out[members[0]] = leaf
    return out


def _within(got, want, limit=LEAF_L2, f64=None, ref=None):
    """Each leaf within relative L2 ``limit``; a gradient leaf whose
    float32 value errs by more than that (``f64``: the one-process
    port's gradients in float64) may instead lie no farther from the
    float64 gradient than the reference's float32 one (``ref``) does."""
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        rel = _rel(got[k], want[k])
        if rel > limit and f64 is not None:
            assert _rel(got[k], f64[k]) <= max(limit, _rel(ref[k], f64[k])),\
                (k, rel, _rel(got[k], f64[k]), _rel(ref[k], f64[k]))
            continue
        assert rel <= limit, (k, rel)


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: f"{d[0]}x{d[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_one_process_and_reference(run, arch, dims):
    got = run["ranks"][0][(arch, dims)]
    one, ref = run["one"][arch], run["ref"][arch]
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_RTOL)
    ref_grads = _ref_by_name(arch, ref["grads"], one["model"])
    _within(got["grads"], one["grads"], f64=one["grads64"], ref=ref_grads)
    _within(got["grads"], ref_grads, f64=one["grads64"], ref=ref_grads)
    _within(got["params"], one["params"])
    _within(got["params"], _ref_by_name(arch, ref["params"], one["model"]))


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_optimizer_variants_on_2x2(run, name):
    got = run["ranks"][0][("variant", name)]
    one = run["one"]["variants"][name]
    ref = run["ref"]["qwen3-1.7b"]["variants"][name]
    np.testing.assert_allclose(got["loss"], one["losses"][0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOSS_RTOL)
    _within(got["params"], one["params"])
    _within(got["params"], _ref_by_name("qwen3-1.7b", ref["params"],
                                        run["one"]["qwen3-1.7b"]["model"]))


def test_compressed_allreduce_in_the_step_within_quantisation(run):
    """Each gradient element the int8 all-reduce gives within n * scale
    / 2 of the exact gradient (the uncompressed 2 x 2 step's), and the
    step's loss the uncompressed step's."""
    got = run["ranks"][0][("variant", "compressed")]
    exact = run["ranks"][0][("qwen3-1.7b", (2, 2))]
    assert set(got["compressed"]) == set(exact["grads"])
    for k, (g, bound) in got["compressed"].items():
        assert np.abs(g - exact["grads"][k]).max() <= bound * (1 + 1e-4) \
            + 1e-7, k
    np.testing.assert_allclose(got["loss"], exact["losses"][0],
                               rtol=LOSS_RTOL)


def test_compression_faults_pinned(run):
    """ROADMAP.md §C entry 11: the reference quantises each shard with its
    own scale and rescales by the largest, far outside n * scale / 2 of
    the exact sum; the port's agrees on one scale first.  Entry 14: a
    replicated gradient through the reference's all-reduce comes back
    n_data times larger; the port's returns it, and sums a partial one."""
    from torch.distributed.tensor import Replicate
    exact = np.sum(SHARDS, axis=0)
    bound = 2 * (np.abs(SHARDS).max() / 127) / 2
    ref = run["ref"]
    np.testing.assert_allclose(ref["entry_11"], REF_ENTRY_11, atol=1e-3)
    assert np.abs(ref["entry_11"] - exact).max() > bound
    np.testing.assert_allclose(ref["entry_14"], REF_ENTRY_14, atol=1e-3)
    assert np.all(np.abs(ref["entry_14"]) >= 1.9 * np.abs(SHARDS[0]))
    for r in run["ranks"]:
        assert np.abs(r["entry_11"] - exact).max() <= bound
        np.testing.assert_array_equal(r["entry_14"],
                                      np.asarray(SHARDS[0], np.float32))
        value, placements = r["partial"]
        assert placements[0] == Replicate()
        assert np.abs(value - exact).max() <= bound


def test_error_feedback_keeps_a_residual_a_rank(run):
    for r in run["ranks"]:
        assert r["error_feedback"] == (True, True, True)


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: f"{d[0]}x{d[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_vocab_chunks_over_a_split_vocabulary(run, arch, dims):
    """The head over chunks of ``VOCAB_CHUNK`` ids on the mesh (each
    rank's slice of the vocabulary on 2 x 2 and 1 x 4, the whole
    vocabulary on 4 x 1): its loss and gradients as the one-process
    chunked head's, the same mesh's plain head's and (on 2 x 2) the
    reference's chunked head's on its mesh."""
    r0 = run["ranks"][0]
    got = r0[("head", arch, dims, VOCAB_CHUNK)]
    wants = [run["one"][arch]["head"], r0[("head", arch, dims, 0)]]
    if dims == (2, 2):
        ref = run["ref"][arch]["chunked"]
        wants.append({"loss": ref["loss"], "grads": _ref_by_name(
            arch, ref["grads"], run["one"][arch]["model"])})
    for want in wants:
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
        _within(got["grads"], want["grads"])


def test_chunked_head_saves_no_rank_logits(run):
    """At 2 x 2 no tensor ``LM.loss`` saves for its backward through the
    chunked head is float32 with as many elements as a rank's (B / 2,
    PROBE_T, V / 2) logits; through the plain head one is (the
    probe sees what it must)."""
    V = RC.reduced(RC.get("qwen3-1.7b")).vocab_size
    logits = (B // 2) * PROBE_T * (V // 2)
    for r in run["ranks"]:
        def largest(chunk):
            return max(n for dtype, n in r[("saved", chunk)]
                       if dtype == torch.float32)
        assert largest(VOCAB_CHUNK) < logits
        assert largest(0) >= logits


def test_elastic_restore_continues_the_run(run):
    """Saved at 2 x 2 after step 2; steps 3-4 restored at 4 x 1 (into a
    model drawn from another seed) and in one process, against the
    uninterrupted 2 x 2 run."""
    r0 = run["ranks"][0]
    want = r0[("qwen3-1.7b", (2, 2))]
    want_losses = [want["losses"][2], want["loss_4"]]
    got = r0["elastic"]
    assert got["step"] == 2 and r0["restore_shardings_equal"]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=LOSS_RTOL)
    _within(got["params"], want["params_4"])
    # one process: the same checkpoint into a plain model
    case = run["inp"]["archs"]["qwen3-1.7b"]
    model = lm_lib.LM(_port_cfg("qwen3-1.7b"), device="cpu", seed=7)
    p = trainable_params(model)
    step, opt = make_train_step(model, TrainConfig())
    s = opt.init(p)
    assert Checkpointer(str(run["ckpt"])).restore_into(p, s) == 2
    losses = []
    for b in case["batches"][2:4]:
        p, s, m = step(p, s, b)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    _within({k: v.detach().numpy() for k, v in p.items()},
            want["params_4"])


def test_sharded_prefetch_gives_each_rank_jaxs_rows(run):
    want = run["ref"]["prefetch"]
    for rank, r in enumerate(run["ranks"]):
        for k, rows in r["prefetch"].items():
            np.testing.assert_array_equal(rows, want[k][rank])


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: f"{d[0]}x{d[1]}")
def test_placement_and_sliced_init_equal_the_one_process_model(run, dims):
    for arch in ARCHS:
        assert all(r[("placed_equal", arch, dims)] for r in run["ranks"])


def test_dry_run_count_equals_the_ranks_count(run):
    """The step counted on meta DTensors in a fake world (the dry run's
    cell at this test's shape) and on the gloo ranks: the same FLOPs and
    the same collectives by kind."""
    cell = run["cell"]["roofline"]
    for r in run["ranks"]:
        flops, collectives = r["count"]
        assert flops == pytest.approx(cell["flops_per_device"], rel=1e-9)
        assert collectives == cell["collectives"]


def test_only_a_dtensors_call_hands_the_launchers_dense_shards():
    """The kernels' CUDA registrations make their inputs dense only on a
    DTensor's call, whose local shards' layout DTensor picks: a plain
    strided tensor reaches the launcher as it came (which refuses it)."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.kernels import _shards
    from repro_torch.launch import mesh as mesh_lib

    def launcher_sees_dense(t):
        local = t if type(t) is torch.Tensor else t.to_local()
        return _shards.dense((local, 1))[0].is_contiguous()

    strided = torch.zeros(4, 6).t()
    assert not _shards.call(launcher_sees_dense, strided)
    with mesh_lib.fake_world(1):
        mesh = mesh_lib.make_mesh((1, 1), ("data", "model"),
                                  device_type="cpu")
        shard = DTensor.from_local(strided, mesh, [Replicate(), Replicate()],
                                   run_check=False)
        assert not shard.to_local().is_contiguous()
        assert _shards.call(launcher_sees_dense, shard)
    assert not _shards.call(launcher_sees_dense, strided)
