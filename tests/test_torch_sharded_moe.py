"""The port's sharded training of the MoE models and the encoder-decoder
on gloo CPU ranks (one process a rank) against the one-process port step
and the reference's jitted step on a mesh of 4 XLA CPU devices.

Reduced configs in float32, 4 x 16 tokens (labels of the first row
masked in part): qwen3-moe-30b-a3b (top-8 softmax router over 8
experts), llama4-maverick-400b-a17b (top-1 sigmoid router, a shared
expert, an MoE layer every second) and seamless-m4t-large-v2 (8 random
source frames a sequence; its vocabulary cut to 514 words, which, as the
full model's 256,206, divides 2 but not 4: split over the model axis on
2 x 2, replicated by the divisibility fallback on 1 x 4), each at 2 x 2,
4 x 1 and 1 x 4, 3 AdamW steps, and qwen3-moe-30b-a3b also 3 Adafactor
steps (the reference's ``TrainConfig`` defaults otherwise; the port with
remat, the reference without: remat changes no value).  The reference
runs on 2 x 2 with Auto axes, its weights ``init(PRNGKey(0))``; the
port's are placed leaf by leaf from them (``convert``, ``place_tree``):

* each step's loss and its load-balance term ``aux`` within relative
  1e-5 of the one-process port's and the reference's; the first step's
  gradient leaves and the weights after 3 steps within relative L2 1e-4
  a leaf (``aux`` multiplies two global batch means, each reduced over
  the batch's ranks first; a mean of per-rank products would differ).
  Where the one-process port's weight leaf is itself farther from the
  reference's (seamless's zero-initialised layer-norm biases, see
  ``_within``) the mesh's may be off by that plus 1e-4;
* each rank's rows of a placed batch, the frames included, are its rows
  of the whole batch; ``init_placed`` gives the one-process model's
  weights, bit for bit, the 3-D expert leaves among them;
* Adafactor's factored statistics ``vr``, ``vc`` of every leaf placed as
  the reference's ``state_specs`` axes resolve on the mesh;
* qwen3-moe-30b-a3b's head over vocabulary chunks (``vocab_chunk`` 100)
  at 1 x 4, each rank's 128 ids in a chunk of 100 and a ragged one of
  28, on a batch whose labels include -1 and the ids on the slices' and
  chunks' edges: the loss within relative 1e-5 and each gradient leaf
  within relative L2 1e-4 of the one-process chunked head's, the same
  mesh's plain head's and the reference's chunked head's on 2 x 2.

One launch of four ranks runs every port case, beside a JAX subprocess
an architecture; all start together.
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
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import lm as lm_lib
from repro_torch.train.train_loop import (TrainConfig, make_train_step,
                                          trainable_params)

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ("qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b",
         "seamless-m4t-large-v2")
MESHES = ((2, 2), (4, 1), (1, 4))
B, T, STEPS = 4, 16, 3
LOSS_RTOL, LEAF_L2 = 1e-5, 1e-4
#: the optimizers each architecture trains with
OPTIMIZERS = {"qwen3-moe-30b-a3b": ("adamw", "adafactor"),
              "llama4-maverick-400b-a17b": ("adamw",),
              "seamless-m4t-large-v2": ("adamw",)}
#: the encoder-decoder's vocabulary here: 2 x 257, as 256,206 = 2 x 128,103
ENCDEC_VOCAB = 514
CASES = [(a, o) for a in ARCHS for o in OPTIMIZERS[a]]
#: the head over vocabulary chunks: qwen3-moe-30b-a3b on this mesh
CHUNK_ARCH, CHUNK_MESH, VOCAB_CHUNK = "qwen3-moe-30b-a3b", (1, 4), 100
#: labels on the edges of the ranks' slices and of the chunks
EDGE_LABELS = [0, 99, 100, 127, 128, 255, 256, 355, 356, 383, 384, 511]


def _ref_cfg(arch):
    cfg = RC.reduced(RC.get(arch))
    if cfg.encoder_layers:
        cfg = dataclasses.replace(cfg, vocab_size=ENCDEC_VOCAB)
    return cfg


JAX_CHILD = textwrap.dedent("""
    import pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro.models import build_model, settings
    from repro.models.types import ModelConfig
    from repro.sharding import ctx as ctx_lib, rules as rules_lib
    from repro.train.train_loop import TrainConfig, make_train_step
    with open(sys.argv[1], "rb") as f:
        inp = pickle.load(f)
    arch = sys.argv[3]
    case = inp["archs"][arch]
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:4])
    cfg = ModelConfig(**case["cfg"])
    model = build_model(cfg)
    rules = rules_lib.production_rules().with_overrides(
        **rules_lib.arch_overrides(cfg, 2))
    specs = model.param_specs()
    p_sh = rules_lib.tree_shardings(specs, rules, mesh)
    bs = [{k: jnp.asarray(v) for k, v in b.items()} for b in case["batches"]]
    b_sh = rules_lib.batch_shardings(bs[0], rules, mesh)
    params = jax.device_put(case["params0"], p_sh)
    loss_fn = lambda p, b: model.loss(p, b, remat=False)
    out = {}
    with mesh, ctx_lib.use(rules, mesh):
        for opt_name in case["optimizers"]:
            step, opt = make_train_step(model, TrainConfig(
                remat=False, optimizer=opt_name))
            o_sh = rules_lib.tree_shardings(opt.state_specs(specs), rules,
                                            mesh)

            def main(p, s, b):   # the gradients and the step: one compile
                return jax.value_and_grad(loss_fn, has_aux=True)(p, b), \\
                    step(p, s, b)
            run = jax.jit(main, in_shardings=(p_sh, o_sh, b_sh))
            p, s = params, jax.device_put(opt.init(params), o_sh)
            r = {"losses": [], "aux": []}
            for i, b in enumerate(bs[:inp["steps"]]):
                ((_, _), g), (p, s, m) = run(p, s, b)
                p, s = jax.device_put(p, p_sh), jax.device_put(s, o_sh)
                r["losses"].append(float(m["loss"]))
                r["aux"].append(float(m["aux"]))
                if i == 0:
                    r["grads"] = host(g)
            r["params"] = host(p)
            out[opt_name] = r
        if "head_batch" in case:
            # the chunked head on the head batch
            hb = {k: jnp.asarray(v) for k, v in case["head_batch"].items()}
            with settings.use(vocab_chunk=inp["vocab_chunk"]):
                (loss, _), g = jax.jit(
                    jax.value_and_grad(loss_fn, has_aux=True),
                    in_shardings=(p_sh, b_sh))(params, hb)
            out["chunked"] = {"loss": float(loss), "grads": host(g)}
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
""")

RANK_CHILD = textwrap.dedent("""
    import os, pickle, sys, time
    import numpy as np, torch, torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch import convert
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import encdec as encdec_lib, lm as lm_lib
    from repro_torch.models import settings as msettings
    from repro_torch.sharding import ctx, place, rules as R
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
    out_dir = sys.argv[2]
    dist.init_process_group("gloo")
    rank, cpu = dist.get_rank(), torch.device("cpu")
    whole = lambda t: (t.full_tensor() if isinstance(t, DTensor) else t
                       ).detach().numpy().copy()
    out = {}

    def kind(cfg):
        return (encdec_lib, encdec_lib.EncDec) if cfg.is_encdec \\
            else (lm_lib, lm_lib.LM)

    def setup(cfg, dims, tree=None, seed=0):
        mod, cls = kind(cfg)
        mesh = make_mesh(dims, ("data", "model"), device_type="cpu")
        rules = R.production_rules().with_overrides(
            **R.arch_overrides(cfg, dims[1]))
        specs = mod.param_specs(cfg)
        if tree is None:
            placed = place.init_placed(specs, rules, mesh, seed=seed,
                                       compute_dtype=cfg.compute_dtype,
                                       device=cpu)
        else:
            placed = place.place_tree(tree, R.tree_shardings(specs, rules,
                                                             mesh))
        return mesh, rules, cls(cfg, device="cpu", params=placed)

    def recording(seen):
        # a compress_fn that records each gradient's whole value and hands
        # the gradients on unchanged: the step then reduces them itself
        def hook(grads):
            if not seen:
                seen.update({k: whole(g) for k, g in grads.items()})
            return grads
        return hook

    def state_placed_as_reference(opt, model, p, s, rules, mesh):
        # each factored leaf's vr and vc at the placements of the
        # reference's state_specs axes: (..., rows) and (..., columns) of
        # the leaf's axes, a leading None for a cycle-stacked leaf
        specs = lm_lib.named_specs(model.cfg)
        for (members, stacked), f in zip(opt.leaves(p), s["f"]):
            if "vr" not in f:
                continue
            axes = ((None,) if stacked else ()) + specs[members[0]].axes
            for key, ax in (("vr", axes[:-1]), ("vc", axes[:-2] + axes[-1:])):
                want = R.placements_for(R.spec_for(
                    tuple(f[key].shape), ax, rules, mesh), mesh)
                if tuple(f[key].placements) != tuple(want):
                    return (members[0], key, f[key].placements, want)
        return True

    for arch, case in inp["archs"].items():
        cfg = convert.model_config_from_reference(case["cfg"])
        mod, cls = kind(cfg)
        tree = (convert.encdec_tree_from_reference if cfg.is_encdec
                else convert.lm_tree_from_reference)(cfg, case["params0"])
        one = dict(cls(cfg, device="cpu", seed=3).named_parameters())
        for dims in map(tuple, inp["meshes"]):
            # the sliced initialiser, and each rank's rows of a batch
            _, rules, model = setup(cfg, dims, seed=3)
            out[("placed_equal", arch, dims)] = all(
                np.array_equal(whole(v), one[k].detach().numpy())
                for k, v in model.named_parameters())
            mesh = model.embed["embedding"].device_mesh
            b0 = case["batches"][0]
            got = place.place_batch(b0, rules, mesh)
            out[("rows", arch, dims)] = all(
                np.array_equal(whole(v), b0[k]) and
                v.to_local().shape[0] == len(v) // dims[0]
                for k, v in got.items())
            for opt_name in case["optimizers"]:
                mesh, rules, model = setup(cfg, dims, tree=tree)
                r = {"grads": {}, "losses": [], "aux": []}
                step, opt = make_train_step(
                    model, TrainConfig(optimizer=opt_name),
                    compress_fn=recording(r["grads"]))
                p = trainable_params(model)
                s = opt.init(p)
                if opt_name == "adafactor":
                    r["state_placed"] = state_placed_as_reference(
                        opt, model, p, s, rules, mesh)
                with ctx.use(rules, mesh):
                    for b in case["batches"][:inp["steps"]]:
                        p, s, m = step(p, s, b)
                        r["losses"].append(float(m["loss"]))
                        r["aux"].append(float(m["aux"]))
                r["params"] = {k: whole(v) for k, v in p.items()}
                out[(arch, opt_name, dims)] = r
        if "head_batch" in case:
            # the head over vocabulary chunks, and the plain head
            mesh, rules, model = setup(cfg, tuple(inp["chunk_mesh"]),
                                       tree=tree)
            p = trainable_params(model)
            for chunk in (inp["vocab_chunk"], 0):
                with ctx.use(rules, mesh), ctx.spmd(), \
                        msettings.use(vocab_chunk=chunk):
                    loss, _ = model.loss(place.place_batch(
                        case["head_batch"], rules, mesh))
                    g = torch.autograd.grad(loss, list(p.values()))
                out[("head", arch, chunk)] = {
                    "loss": float(whole(loss)),
                    "grads": {k: whole(v) for k, v in zip(p, g)}}
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
        b = {"tokens": rng.integers(0, cfg.vocab_size, (B, T))
             .astype(np.int32), "labels": labels}
        if cfg.encoder_layers:
            b["frontend_embeds"] = rng.standard_normal(
                (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def _head_batch(cfg, seed=2):
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


def _port_model(arch, case):
    cfg = convert.model_config_from_reference(case["cfg"])
    if cfg.is_encdec:
        return encdec_lib.EncDec(cfg, device="cpu", params=convert.
                                 encdec_tree_from_reference(
                                     cfg, case["params0"]))
    return lm_lib.LM(cfg, device="cpu", params=convert.
                     lm_tree_from_reference(cfg, case["params0"]))


def _one_process(arch, case, opt_name):
    """The one-process port: the first batch's gradients, and ``STEPS``
    steps of ``opt_name``."""
    model = _port_model(arch, case)
    p = trainable_params(model)
    tb = {k: torch.from_numpy(v) for k, v in case["batches"][0].items()}
    loss, _ = model.loss(tb)
    grads = {k: g.numpy() for k, g in zip(p, torch.autograd.grad(
        loss, list(p.values())))}
    step, opt = make_train_step(model, TrainConfig(optimizer=opt_name))
    s, losses, aux = opt.init(p), [], []
    for b in case["batches"][:STEPS]:
        p, s, m = step(p, s, b)
        losses.append(float(m["loss"]))
        aux.append(float(m["aux"]))
    return {"grads": grads, "losses": losses, "aux": aux, "model": model,
            "params": {k: v.detach().numpy().copy() for k, v in p.items()}}


def _one_head(arch, case):
    """The one-process chunked head's loss and gradients on the head
    batch, from the initial weights."""
    from repro_torch.models import settings as psettings
    model = _port_model(arch, case)
    p = trainable_params(model)
    with psettings.use(vocab_chunk=VOCAB_CHUNK):
        loss, _ = model.loss({k: torch.from_numpy(v)
                              for k, v in case["head_batch"].items()})
    g = torch.autograd.grad(loss, list(p.values()))
    return {"loss": float(loss.detach()),
            "grads": {k: v.numpy() for k, v in zip(p, g)}}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The reference's sharded steps (a JAX subprocess an architecture over
    4 XLA CPU devices), the port's on 4 gloo ranks (started first), and
    the one-process port's."""
    tmp = tmp_path_factory.mktemp("sharded_moe")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    port = _free_port()
    ranks = [subprocess.Popen(
        [sys.executable, "-c", RANK_CHILD, str(tmp / "inputs.pkl"),
         str(tmp)], env=dict(env, MASTER_ADDR="localhost",
                             MASTER_PORT=str(port), RANK=str(r),
                             WORLD_SIZE="4"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    inp = {"archs": {}, "meshes": [list(m) for m in MESHES], "steps": STEPS,
           "vocab_chunk": VOCAB_CHUNK, "chunk_mesh": list(CHUNK_MESH)}
    try:
        for arch in ARCHS:
            rcfg = _ref_cfg(arch)
            params = ref_build_model(rcfg).init(jax.random.PRNGKey(0))
            inp["archs"][arch] = {
                "cfg": dataclasses.asdict(rcfg),
                "params0": jax.tree_util.tree_map(np.asarray, params),
                "batches": _batches(rcfg, STEPS),
                "optimizers": OPTIMIZERS[arch]}
        inp["archs"][CHUNK_ARCH]["head_batch"] = _head_batch(
            _ref_cfg(CHUNK_ARCH))
        with open(tmp / "inputs.part", "wb") as f:
            pickle.dump(inp, f)
        os.replace(tmp / "inputs.part", tmp / "inputs.pkl")
    except BaseException:
        for p in ranks:
            p.kill()
        raise
    refs = [subprocess.Popen([sys.executable, "-c", JAX_CHILD,
                              str(tmp / "inputs.pkl"),
                              str(tmp / f"ref-{arch}.pkl"), arch],
                             env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for arch in ARCHS]
    one = {(a, o): _one_process(a, inp["archs"][a], o) for a, o in CASES}
    one["head"] = _one_head(CHUNK_ARCH, inp["archs"][CHUNK_ARCH])
    for p in ranks:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-4000:]
    ref = {}
    for arch, p in zip(ARCHS, refs):
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-4000:]
        with open(tmp / f"ref-{arch}.pkl", "rb") as f:
            ref[arch] = pickle.load(f)
    got = []
    for r in range(4):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    return {"inp": inp, "ref": ref, "ranks": got, "one": one}


def _ref_by_name(ref_tree, model):
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


def _within(got, want, own=None):
    """Each leaf within relative L2 ``LEAF_L2``.  Against the reference,
    a leaf where the one-process port (``own``) is itself farther than
    that may be off by its distance plus ``LEAF_L2``: seamless's
    layer-norm biases start at zero, so after 3 steps they are AdamW's
    steps alone, and an element whose gradient is near zero steps by
    about lr either way (the one-process port's biases lie 1.5e-4 to
    3.1e-4 from the reference's; ``tests/test_torch_train.py`` holds an
    update within 1e-2 for this reason)."""
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        limit = LEAF_L2
        if own is not None and _rel(own[k], want[k]) > LEAF_L2:
            limit += _rel(own[k], want[k])
        assert _rel(got[k], want[k]) <= limit, (k, _rel(got[k], want[k]))


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: f"{d[0]}x{d[1]}")
@pytest.mark.parametrize("arch,opt_name", CASES)
def test_sharded_step_matches_one_process_and_reference(run, arch, opt_name,
                                                        dims):
    got = run["ranks"][0][(arch, opt_name, dims)]
    one, ref = run["one"][arch, opt_name], run["ref"][arch][opt_name]
    for want in (one, ref):
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=LOSS_RTOL)
    ref_grads = _ref_by_name(ref["grads"], one["model"])
    _within(got["grads"], one["grads"])
    _within(got["grads"], ref_grads)
    _within(got["params"], one["params"])
    _within(got["params"], _ref_by_name(ref["params"], one["model"]),
            own=one["params"])


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: f"{d[0]}x{d[1]}")
@pytest.mark.parametrize("arch", ARCHS[:2])
def test_sharded_aux_equals_one_process_aux(run, arch, dims):
    """The load-balance term of every step: the product of the global
    batch means, as the one-process step and the reference take it."""
    got = run["ranks"][0][(arch, "adamw", dims)]["aux"]
    one = run["one"][arch, "adamw"]["aux"]
    assert min(one) > 0
    np.testing.assert_allclose(got, one, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got, run["ref"][arch]["adamw"]["aux"],
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: f"{d[0]}x{d[1]}")
def test_placement_batch_rows_and_sliced_init(run, dims):
    for arch in ARCHS:
        assert all(r[("placed_equal", arch, dims)] for r in run["ranks"])
        assert all(r[("rows", arch, dims)] for r in run["ranks"])


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: f"{d[0]}x{d[1]}")
def test_adafactor_state_placed_as_reference_state_specs(run, dims):
    for r in run["ranks"]:
        assert r[("qwen3-moe-30b-a3b", "adafactor", dims)]["state_placed"] \
            is True


def test_vocab_chunks_over_a_split_vocabulary(run):
    """qwen3-moe-30b-a3b's head over chunks of ``VOCAB_CHUNK`` ids at
    ``CHUNK_MESH`` (each rank's slice of the vocabulary): its loss and
    gradients as the one-process chunked head's, the same mesh's plain
    head's and the reference's chunked head's on its 2 x 2 mesh."""
    r0 = run["ranks"][0]
    got = r0[("head", CHUNK_ARCH, VOCAB_CHUNK)]
    ref = run["ref"][CHUNK_ARCH]["chunked"]
    model = run["one"][CHUNK_ARCH, "adamw"]["model"]
    for want in (run["one"]["head"], r0[("head", CHUNK_ARCH, 0)],
                 {"loss": ref["loss"],
                  "grads": _ref_by_name(ref["grads"], model)}):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
        _within(got["grads"], want["grads"])


def test_encdec_vocabulary_split_by_mesh():
    """The encoder-decoder's 514-word table is split over the model axis
    where 2 splits it and kept whole where 4 does not divide it, as the
    full model's 256,206 words (the divisibility fallback)."""
    from repro_torch.sharding import rules as R
    cfg = convert.model_config_from_reference(dataclasses.asdict(
        _ref_cfg("seamless-m4t-large-v2")))
    full = RC.get("seamless-m4t-large-v2").vocab_size
    spec = encdec_lib.param_specs(cfg)["embed"]["embedding"]
    for tp, split in ((2, True), (4, False)):
        rules = R.production_rules().with_overrides(
            **R.arch_overrides(cfg, tp))
        mesh = type("Mesh", (), {"shape": {"data": 4 // tp, "model": tp}})
        got = R.spec_for(spec.shape, spec.axes, rules, mesh)
        assert (got[:1] == ("model",)) == split
        assert (full % tp == 0) == split
