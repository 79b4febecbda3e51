"""The port's training loss, gradients and optimizer step against the
reference's, on the same weights and batches.

For reduced configs in float32 (qwen3-1.7b: dense, tied embeddings;
qwen3-moe-30b-a3b: the MoE aux term; recurrentgemma-9b: RG-LRU, its
remainder layer and window; rwkv6-3b: the RWKV-6 mixes; pixtral-12b:
patches whose labels are -1; and the encoder-decoder
seamless-m4t-large-v2) the reference's ``LM.init(PRNGKey(0))`` weights go
to the port through ``repro_torch.convert``, the same seeded numpy batch
to both, and:

* the loss and its metrics agree within relative 1e-5;
* each gradient leaf within relative L2 1e-4 (the port's per-layer
  gradients stacked in cycle order against the reference's stacked leaf);
  recurrentgemma-9b's within 5e-4: measured against the same port model
  run in float64, both packages' float32 gradients of its attention
  layers' q/k path are 2e-4 to 4e-4 away (the port's the closer), so
  1e-4 between the two is below float32's own error there;
* the parameters after one AdamW step of ``make_train_step`` (the
  reference's ``TrainConfig`` defaults, jitted) within rtol 1e-5, atol
  1e-6, and each leaf's update within relative L2 1e-2.

Also: the ``vocab_chunk`` path against the plain head with a chunk that
does not divide the vocabulary; Adafactor over 2 cycles with a 1-D leaf
and the update clip engaged against the reference's (its statistics span
the cycle-stacked leaves); a port step continuing a reference step
through ``convert`` against the reference's second step; and, at T = 100
over ``kv_chunk`` 32, the port's loss and gradients against the
reference computed exactly (one chunk) while the reference's chunked
sdpa misses them (ROADMAP.md §C, entry 2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import build_model as ref_build_model
from repro.models import settings as jsettings
from repro.train.train_loop import TrainConfig as RefTrainConfig
from repro.train.train_loop import make_train_step as ref_make_train_step
from repro_torch import convert
from repro_torch.models import settings as psettings
from repro_torch.train.train_loop import (TrainConfig, make_train_step,
                                          trainable_params)

ARCHS = ["qwen3-1.7b", "qwen3-moe-30b-a3b", "recurrentgemma-9b",
         "rwkv6-3b", "pixtral-12b", "seamless-m4t-large-v2"]
B, T, PATCHES = 2, 20, 8
LOSS_RTOL, GRAD_L2, P_RTOL, P_ATOL = 1e-5, 1e-4, 1e-5, 1e-6
#: the gradient bound where float32's own error is larger (see above)
GRAD_L2_ARCH = {"recurrentgemma-9b": 5e-4}
#: the update of one step within this relative L2 a leaf.  A first Adam
#: step is about lr times the sign of each gradient element, so the few
#: elements whose gradient is at rounding level (|g| near eps, 1e-8) may
#: step either way in either package
UPDATE_L2 = 1e-2
#: the reference's TrainConfig defaults (the first step's rate is
#: 3e-4 / 100)
STEP = dict()


def _batch(cfg, seed=0, T=T):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, T)).astype(
                 np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, T)).astype(
                 np.int32)}
    batch["labels"][0, :3] = -1
    if cfg.encoder_layers:
        batch["frontend_embeds"] = rng.standard_normal(
            (B, 12, cfg.d_model)).astype(np.float32)
    elif cfg.frontend:
        batch["frontend_embeds"] = rng.standard_normal(
            (B, PATCHES, cfg.d_model)).astype(np.float32)
        batch["labels"] = np.concatenate(
            [np.full((B, PATCHES), -1, np.int32), batch["labels"]], 1)
    return batch


def _port_model(cfg, params):
    host = jax.tree_util.tree_map(np.asarray, params)
    if cfg.is_encdec:
        return convert.encdec_params_from_reference(cfg, host, device="cpu")
    return convert.lm_params_from_reference(cfg, host, device="cpu")


def _setup(arch, **changes):
    rcfg = dataclasses.replace(RC.reduced(RC.get(arch)), **changes)
    ref = ref_build_model(rcfg)
    params = ref.init(jax.random.PRNGKey(0))
    cfg = convert.model_config_from_reference(dataclasses.asdict(rcfg))
    return rcfg, ref, params, cfg, _port_model(cfg, params)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def _stacked(path, members, values):
    """The port's per-member values as the reference leaf at ``path``."""
    if path[1:2] == ("cycles",):
        return np.stack([values[n] for n in members])
    return values[members[0]]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    """Both packages' loss, gradients and one AdamW step on one batch."""
    rcfg, ref, params, cfg, model = _setup(request.param)
    batch = _batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    step, opt = ref_make_train_step(ref, RefTrainConfig(**STEP))

    @jax.jit        # one compile for both
    def reference(p, state, b):
        return (jax.value_and_grad(ref.loss, has_aux=True)(p, b),
                step(p, state, b))
    ((loss, metrics), grads), (new_params, _, ref_m) = reference(
        params, opt.init(params), jbatch)

    tparams = trainable_params(model)
    t_params0 = {k: p.detach().numpy().copy() for k, p in tparams.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    t_loss, t_metrics = model.loss(tbatch)
    t_grads = dict(zip(tparams, torch.autograd.grad(
        t_loss, list(tparams.values()))))
    t_step, t_opt = make_train_step(model, TrainConfig(**STEP))
    _, _, t_m = t_step(tparams, t_opt.init(tparams), batch)
    return dict(arch=request.param, model=model, params=params,
                t_params0=t_params0, loss=(loss, metrics, ref_m),
                t_loss=(t_loss, t_metrics, t_m), grads=grads,
                t_grads={k: g.numpy() for k, g in t_grads.items()},
                new_params=new_params,
                t_params={k: p.detach().numpy() for k, p in tparams.items()})


def test_loss_matches_reference(run):
    loss, metrics, _ = run["loss"]
    t_loss, t_metrics, _ = run["t_loss"]
    np.testing.assert_allclose(float(t_loss), float(loss), rtol=LOSS_RTOL)
    for k in ("xent", "z_loss", "aux", "tokens"):
        np.testing.assert_allclose(float(t_metrics[k]), float(metrics[k]),
                                   rtol=LOSS_RTOL, atol=1e-7)


def test_gradients_match_reference(run):
    groups = run["model"].param_groups()
    assert len(groups) == len(jax.tree_util.tree_leaves(run["grads"]))
    limit = GRAD_L2_ARCH.get(run["arch"], GRAD_L2)
    for path, members in groups:
        want = _leaf(run["grads"], path)
        got = _stacked(path, members, run["t_grads"])
        assert got.shape == want.shape, path
        assert _rel(got, want) <= limit, (path, _rel(got, want))


def test_adamw_step_matches_reference(run):
    _, _, ref_m = run["loss"]
    _, _, t_m = run["t_loss"]
    np.testing.assert_allclose(float(t_m["loss"]), float(ref_m["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(t_m["grad_norm"]),
                               float(ref_m["grad_norm"]), rtol=1e-4)
    for path, members in run["model"].param_groups():
        got = _stacked(path, members, run["t_params"])
        want = _leaf(run["new_params"], path)
        np.testing.assert_allclose(got, want, rtol=P_RTOL, atol=P_ATOL,
                                   err_msg=str(path))
        old = _leaf(run["params"], path)
        assert _rel(got - old, want - old) <= UPDATE_L2, path


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "pixtral-12b"])
def test_vocab_chunk_matches_plain_head(arch):
    """``fused_xent`` over chunks of 100 (the vocabulary of 512 is not a
    multiple): the loss and every gradient as the plain head's, and the
    reference's chunked loss."""
    rcfg, ref, params, cfg, model = _setup(arch)
    batch = _batch(cfg, seed=3)
    tparams = trainable_params(model)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    plain, _ = model.loss(tbatch)
    g_plain = torch.autograd.grad(plain, list(tparams.values()))
    with psettings.use(vocab_chunk=100):
        fused, _ = model.loss(tbatch)
    g_fused = torch.autograd.grad(fused, list(tparams.values()))
    np.testing.assert_allclose(float(fused), float(plain), rtol=1e-6)
    for a, b in zip(g_fused, g_plain):
        assert _rel(a.numpy(), b.numpy()) <= 1e-5
    with jsettings.use(vocab_chunk=100):
        ref_loss, _ = ref.loss(params, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    np.testing.assert_allclose(float(fused), float(ref_loss),
                               rtol=LOSS_RTOL)


def test_adafactor_groups_follow_reference_leaves():
    """Adafactor over reduced recurrentgemma-9b (2 cycles of 3 layers and
    a remainder layer, 1-D norm scales and biases), two steps: the
    parameters, each leaf's update and the statistics against the
    reference's.  The update clip is engaged on every leaf (a first step
    is about 10 times the sign of the gradient, RMS 10): without weight
    decay each leaf's update then has RMS lr exactly, in both packages,
    which it would not if a leaf's RMS were taken over one layer of a
    stacked leaf (or without the clip: 10 lr).  Within 5%: an update of a
    weight near 1 is rounded to float32's spacing there, 1.2e-7, and the
    first step's lr is 3e-6."""
    rcfg, ref, params, cfg, model = _setup("recurrentgemma-9b")
    tc = dict(optimizer="adafactor", weight_decay=0.0)
    step, opt = ref_make_train_step(ref, RefTrainConfig(**tc))
    step = jax.jit(step)
    state = opt.init(params)
    tparams = trainable_params(model)
    t_step, t_opt = make_train_step(model, TrainConfig(**tc))
    t_state = t_opt.init(tparams)
    assert len(t_state["f"]) == len(state["f"])
    for s in (0, 1):
        old = {k: p.detach().numpy().copy() for k, p in tparams.items()}
        old_ref = params
        batch = _batch(cfg, seed=10 + s)
        params, state, m = step(params, state, {k: jnp.asarray(v)
                                                for k, v in batch.items()})
        _, t_state, t_m = t_step(tparams, t_state, batch)
        new = {k: p.detach().numpy() for k, p in tparams.items()}
        lr = float(m["lr"])
        np.testing.assert_allclose(float(t_m["lr"]), lr, rtol=1e-6)
        for path, members in model.param_groups():
            got = _stacked(path, members, new)
            want = _leaf(params, path)
            np.testing.assert_allclose(got, want, rtol=P_RTOL, atol=P_ATOL,
                                       err_msg=str(path))
            d_got = got - _stacked(path, members, old)
            d_want = want - _leaf(old_ref, path)
            assert _rel(d_got, d_want) <= UPDATE_L2, path
            if s == 0:      # the clip: every leaf's update has RMS lr
                for d in (d_got, d_want):
                    np.testing.assert_allclose(
                        np.sqrt(np.mean(np.square(d, dtype=np.float64))),
                        lr, rtol=0.05, err_msg=str(path))
    for f, tf in zip(state["f"], t_state["f"]):
        assert set(f) == set(tf)
        for k in f:
            np.testing.assert_allclose(tf[k].numpy(), np.asarray(f[k]),
                                       rtol=1e-4, atol=1e-12)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_port_step_continues_reference_step(kind):
    """A reference step, its state carried over by ``convert``, then one
    port step: the reference's second step."""
    rcfg, ref, params, cfg, _ = _setup("qwen3-moe-30b-a3b")
    tc = dict(optimizer=kind)
    step, opt = ref_make_train_step(ref, RefTrainConfig(**tc))
    step = jax.jit(step)
    b0, b1 = _batch(cfg, seed=20), _batch(cfg, seed=21)
    p1, s1, _ = step(params, opt.init(params),
                     {k: jnp.asarray(v) for k, v in b0.items()})
    p2, _, m2 = step(p1, s1, {k: jnp.asarray(v) for k, v in b1.items()})
    model = _port_model(cfg, p1)
    host = jax.tree_util.tree_map(np.asarray, s1)
    t_state = (convert.adamw_state_from_reference(cfg, host, device="cpu")
               if kind == "adamw" else
               convert.adafactor_state_from_reference(cfg, host,
                                                      device="cpu"))
    tparams = trainable_params(model)
    t_step, _ = make_train_step(model, TrainConfig(**tc))
    _, t_state, t_m = t_step(tparams, t_state, b1)
    assert int(t_state["count"]) == 2
    np.testing.assert_allclose(float(t_m["loss"]), float(m2["loss"]),
                               rtol=LOSS_RTOL)
    for path, members in model.param_groups():
        np.testing.assert_allclose(
            _stacked(path, members, {k: p.detach().numpy()
                                     for k, p in tparams.items()}),
            _leaf(p2, path), rtol=P_RTOL, atol=P_ATOL, err_msg=str(path))


def test_ragged_kv_chunk_training_is_exact_on_the_port():
    """T = 100 over kv_chunk 32: the port's loss and gradients (which no
    chunk size touches) equal the reference's with one exact chunk; the
    reference's own at kv_chunk 32 differ from both."""
    rcfg, ref, params, cfg, model = _setup("qwen3-1.7b")
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg, seed=5,
                                                  T=100).items()}
    def vg():       # a new function each time: jit's cache ignores settings
        return jax.jit(jax.value_and_grad(lambda p, b: ref.loss(p, b),
                                          has_aux=True))
    (exact, _), g_exact = vg()(params, batch)
    with jsettings.use(kv_chunk=32, q_chunk=32):
        (chunked, _), g_chunked = vg()(params, batch)
    tparams = trainable_params(model)
    t_loss, _ = model.loss({k: torch.from_numpy(np.asarray(v))
                            for k, v in batch.items()})
    t_grads = dict(zip(tparams, (g.numpy() for g in torch.autograd.grad(
        t_loss, list(tparams.values())))))
    np.testing.assert_allclose(float(t_loss), float(exact), rtol=LOSS_RTOL)
    worst_port, worst_ref = 0.0, 0.0
    for path, members in model.param_groups():
        got = _stacked(path, members, t_grads)
        worst_port = max(worst_port, _rel(got, _leaf(g_exact, path)))
        worst_ref = max(worst_ref, _rel(_leaf(g_chunked, path),
                                        _leaf(g_exact, path)))
    assert worst_port <= GRAD_L2
    assert abs(float(chunked) - float(exact)) > 1e-4 * abs(float(exact))
    assert worst_ref > 1e-2


@pytest.mark.parametrize("remat", [False, True])
def test_rglru_scan_gradient_matches_reference(remat):
    """The RG-LRU scan's gradient (ROADMAP.md §C, entry 8): its in-place
    rounds, kept for serving, overwrote what autograd had saved, which
    plain autograd refuses and a non-reentrant checkpoint read back
    overwritten; with a gradient wanted the rounds write new tensors."""
    from repro.models import recurrent as jrec
    from repro_torch.models import recurrent as prec
    rng = np.random.default_rng(4)
    log_a = -np.abs(rng.standard_normal((2, 37, 8))).astype(np.float32)
    gated = rng.standard_normal((2, 37, 8)).astype(np.float32)
    cot = rng.standard_normal((2, 37, 8)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, g: jrec.rglru_scan(a, g, None)[0],
                     jnp.asarray(log_a), jnp.asarray(gated))
    want = [np.asarray(x) for x in vjp(jnp.asarray(cot))]
    leaves = [torch.from_numpy(x).requires_grad_() for x in (log_a, gated)]

    def scan(a, g):
        return prec.rglru_scan(a, g, None)[0]
    h = torch.utils.checkpoint.checkpoint(
        scan, *leaves, use_reentrant=False) if remat else scan(*leaves)
    got = torch.autograd.grad(h, leaves, torch.from_numpy(cot))
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= 1e-5
