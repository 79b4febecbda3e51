"""The gradients of the port's WKV6 recurrence against the reference's.

``wkv6_bwd_ref`` (the plain version of the backward kernel, from the
explicit formulas) is held, within relative L2 1e-5 for each of dr, dk,
dv, dw, du and ds0, against PyTorch's autograd of the port's
``wkv6_scan_ref``, and against ``jax.vjp`` of the reference's oracle
``repro.models.recurrent.wkv6_scan_ref`` and of its chunked form
``wkv6_scan_chunked`` (a chunk that divides T, and one that does not, which
the reference then runs as one chunk).  Everything computes in float32
(both plain versions cast their inputs).  The cases: head sizes 16, 32
and 64; T = 1, 17 and 40; a nonzero s0 and a nonzero cotangent of s_T;
RWKV-6's own decays, w = exp(-exp(x)) for x in [-8, 2], with some w
exactly 0.

``WKV6Fn`` (what ``wkv6`` takes on CUDA tensors that want a gradient) is
wired here on the CPU with its two launchers replaced by the plain
versions; ``_launch_bwd``'s refusals come before any build, so they are
checked here too.  The CUDA kernel is held to ``wkv6_bwd_ref`` on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import recurrent as jrec
from repro_torch import configs
from repro_torch.kernels import _build, ops
from repro_torch.kernels import rwkv6_scan as wk
from repro_torch.models import LM
from repro_torch.train.train_loop import trainable_params

#: (B, T, H, N)
CASES = [(2, 1, 3, 16), (1, 17, 2, 16), (2, 40, 2, 16), (1, 17, 2, 32),
         (2, 40, 1, 32), (2, 1, 2, 64), (1, 17, 2, 64), (1, 40, 2, 64)]
#: chunks of the reference's chunked scan a T: one that divides it, one
#: that does not
CHUNKS = {1: (1, 128), 17: (1, 4), 40: (8, 16)}
LIMIT = 1e-5
NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")


def _inputs(case, seed=0, zeros=True):
    """r, k, v, u, s0, dy, dsT from a normal law; w RWKV-6's decay with
    (where ``zeros``) every seventh entry exactly 0."""
    B, T, H, N = case
    rng = np.random.default_rng(seed + 31 * T + N)
    r, k, v, dy = (rng.standard_normal((B, T, H, N)).astype(np.float32)
                   for _ in range(4))
    w = np.exp(-np.exp(rng.uniform(-8.0, 2.0, (B, T, H, N)))).astype(
        np.float32)
    if zeros:
        w.reshape(-1)[::7] = 0.0
    u = (rng.standard_normal((H, N)) * 0.5).astype(np.float32)
    s0, dsT = (rng.standard_normal((B, H, N, N)).astype(np.float32)
               for _ in range(2))
    return r, k, v, w, u, s0, dy, dsT


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _close(got, want, limit=LIMIT):
    for name, g, w in zip(NAMES, got, want):
        assert np.asarray(g).shape == np.asarray(w).shape, name
        assert _rel(g, w) <= limit, (name, _rel(g, w))


def _port_bwd(arrays, dtype=torch.float32):
    r, k, v, w, u, s0, dy, dsT = (None if a is None else torch.from_numpy(a)
                                  for a in arrays)
    r, k, v = (t.to(dtype) for t in (r, k, v))
    return wk.wkv6_bwd_ref(r, k, v, w, u, s0, dy, dsT)


def _np(grads):
    return [g.float().numpy() for g in grads]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_bwd_ref_matches_autograd(case):
    arrays = _inputs(case)
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays[:6]]
    y, sT = wk.wkv6_scan_ref(*leaves)
    want = torch.autograd.grad((y, sT), leaves, (
        torch.from_numpy(arrays[6]), torch.from_numpy(arrays[7])))
    _close(_np(_port_bwd(arrays)), _np(want))


def _reference_vjp(fn, arrays, **kw):
    """(dr, dk, dv, dw, du, ds0) of the reference's ``fn`` by
    ``jax.vjp``, jitted."""
    @jax.jit
    def grads(*a):
        _, pull = jax.vjp(lambda *x: fn(*x, **kw), *a[:6])
        return pull((a[6], a[7]))
    return [np.asarray(g) for g in grads(*(jnp.asarray(a) for a in arrays))]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_bwd_ref_matches_reference_vjp(case):
    """Against ``jax.vjp`` of the reference's oracle and of its chunked
    scan at a chunk that divides T and one that does not."""
    arrays = _inputs(case)
    got = _np(_port_bwd(arrays))
    _close(got, _reference_vjp(jrec.wkv6_scan_ref, arrays))
    for chunk in CHUNKS[case[1]]:
        _close(got, _reference_vjp(jrec.wkv6_scan_chunked, arrays,
                                   chunk=chunk))


@pytest.mark.parametrize("case", CASES[:3], ids=str)
def test_bwd_ref_without_a_state_cotangent(case):
    """``dsT`` None is a zero cotangent of s_T, as training's (which drops
    s_T) is."""
    arrays = list(_inputs(case, seed=2))
    got = _np(_port_bwd(arrays[:7] + [None]))
    arrays[7] = np.zeros_like(arrays[7])
    _close(got, _reference_vjp(jrec.wkv6_scan_ref, arrays))


def test_decays_of_zero_are_exact():
    """w = 0 everywhere cuts the state after every step: dS_{t-1} is r_t
    dy_t^T alone, so ds0 is r_0 dy_0^T and dw_t = s_{t-1} . dS_t."""
    arrays = list(_inputs((1, 5, 2, 16), seed=3))
    arrays[3] = np.zeros_like(arrays[3])
    dr, dk, dv, dw, du, ds0 = _np(_port_bwd(arrays))
    r, dy = arrays[0], arrays[6]
    np.testing.assert_allclose(ds0, r[:, 0, :, :, None] * dy[:, 0, :, None],
                               rtol=1e-6)
    _close([dr, dk, dv, dw, du, ds0],
           _reference_vjp(jrec.wkv6_scan_ref, arrays))


def test_bwd_ref_keeps_the_dtype():
    """bf16 r, k, v: dr, dk and dv in bf16 (computed in fp32, rounded
    once), dw, du and ds0 in fp32; each within bf16 rounding of the fp32
    gradients on the same (rounded) inputs."""
    case = CASES[4]
    arrays = list(_inputs(case, seed=4))
    for i in range(3):
        arrays[i] = torch.from_numpy(arrays[i]).bfloat16().float().numpy()
    got = _port_bwd(arrays, torch.bfloat16)
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 + \
        [torch.float32] * 3
    want = _np(_port_bwd(arrays))
    for name, g, w in zip(NAMES, _np(got), want):
        assert _rel(g, w) <= (2 ** -8 if name in NAMES[:3] else LIMIT), name


@pytest.mark.parametrize("case", [(2, 40, 2, 16), (1, 17, 2, 32),
                                  (1, 1, 2, 64)], ids=str)
def test_fwd_ref_checkpoints_are_the_states(case):
    """``wkv6_fwd_ref``'s y and s_T are ``wkv6_scan_ref``'s, and its
    checkpoint c the state after the first 16 c steps."""
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in _inputs(case)[:6])
    y, sT, ckpt = wk.wkv6_fwd_ref(r, k, v, w, u, s0)
    y_ref, s_ref = wk.wkv6_scan_ref(r, k, v, w, u, s0)
    torch.testing.assert_close(y, y_ref, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(sT, s_ref, rtol=1e-6, atol=1e-6)
    T = case[1]
    assert ckpt.shape == (case[0], case[2], -(-T // wk.CKPT_STEPS),
                          case[3], case[3])
    for c in range(ckpt.shape[2]):
        t = c * wk.CKPT_STEPS
        want = wk.wkv6_scan_ref(r[:, :t], k[:, :t], v[:, :t], w[:, :t], u,
                                s0)[1] if t else s0
        torch.testing.assert_close(ckpt[:, :, c], want, rtol=1e-6,
                                   atol=1e-6)


@pytest.fixture
def plain_launchers(monkeypatch):
    """The CPU kernels of ``WKV6Fn``'s operators (``_launch_plain``,
    ``_launch_bwd_plain``, which take the launchers' arguments) replaced
    by the plain versions, counting their calls as the kernels' would."""
    calls = {"fwd": 0, "bwd": 0, "dsT": []}

    def launch(r, k, v, w, u, s0, variant="split", ckpt=False):
        assert variant == "split" and ckpt
        calls["fwd"] += 1
        return wk.wkv6_fwd_ref(r, k, v, w, u, s0)

    def launch_bwd(r, k, v, w, u, ckpt, dy, dsT, want_ds0):
        calls["bwd"] += 1
        calls["dsT"].append(dsT is not None)
        assert dy.dtype == torch.float32 and dy.is_contiguous()
        assert dsT is None or dsT.dtype == torch.float32
        grads = wk.wkv6_bwd_ref(r, k, v, w, u, ckpt[:, :, 0], dy, dsT)
        return (*grads[:5], grads[5] if want_ds0 else None)
    monkeypatch.setattr(wk, "_launch_plain", launch)
    monkeypatch.setattr(wk, "_launch_bwd_plain", launch_bwd)
    return calls


@pytest.mark.parametrize("use_sT", [False, True])
@pytest.mark.parametrize("s0_grad", [False, True])
def test_wkv6fn_wiring(plain_launchers, use_sT, s0_grad):
    """Each gradient in its slot, against autograd of the plain version:
    a loss of y alone hands the backward ``dsT = None``; s0 without
    grad gets none, and its gradient is not computed."""
    case = (2, 40, 2, 16)
    arrays = _inputs(case, seed=6)
    loss_w = [torch.from_numpy(a) for a in arrays[6:]]
    out = []
    for fn in (wk.WKV6Fn.apply, wk.wkv6_scan_ref):
        leaves = [torch.from_numpy(a).requires_grad_(i < 5 or s0_grad)
                  for i, a in enumerate(arrays[:6])]
        y, sT = fn(*leaves)
        loss = (y * loss_w[0]).sum() + \
            ((sT * loss_w[1]).sum() if use_sT else 0.0)
        loss.backward()
        out.append([t.grad for t in leaves])
    for name, g, w in zip(NAMES, *out):
        if name == "ds0" and not s0_grad:
            assert g is None and w is None
            continue
        assert _rel(g.numpy(), w.numpy()) <= LIMIT, name
    assert plain_launchers == {"fwd": 1, "bwd": 1, "dsT": [use_sT]}


def test_wkv6fn_takes_bf16_and_keeps_the_dtypes(plain_launchers):
    case = (1, 17, 2, 32)
    arrays = _inputs(case, seed=8)
    leaves = [torch.from_numpy(a) for a in arrays[:6]]
    leaves[:3] = [t.bfloat16() for t in leaves[:3]]
    leaves = [t.requires_grad_() for t in leaves]
    y, _ = wk.WKV6Fn.apply(*leaves)
    y.backward(torch.from_numpy(arrays[6]))
    assert [t.grad.dtype for t in leaves] == [torch.bfloat16] * 3 + \
        [torch.float32] * 3


def test_rwkv_model_gradients_through_wkv6fn(plain_launchers, monkeypatch):
    """The slice as a whole on the CPU: a reduced rwkv6-3b's loss with
    remat, its time mixes through ``WKV6Fn`` (the launchers plain), gives
    autograd's gradients of the plain recurrence: each layer's forward
    twice (the recompute), its backward once."""
    cfg = configs.reduced(configs.get("rwkv6-3b"))
    rng = np.random.default_rng(0)
    batch = {key: torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 20)).astype(np.int64)) for key in
        ("tokens", "labels")}
    model = LM(cfg, device="cpu", seed=0)
    params = trainable_params(model)
    names = list(params)
    want = torch.autograd.grad(model.loss(batch)[0],
                               [params[n] for n in names])
    monkeypatch.setattr(ops, "wkv6", wk.WKV6Fn.apply)
    got = torch.autograd.grad(model.loss(batch)[0],
                              [params[n] for n in names])
    for n, g, w in zip(names, got, want):
        assert _rel(g.float().numpy(), w.float().numpy()) <= 1e-5, n
    L = cfg.num_layers
    assert plain_launchers == {"fwd": 2 * L, "bwd": L, "dsT": [False] * L}


@pytest.mark.parametrize("bad", ["fp16", "dy_bf16", "head_size", "ckpt",
                                 "dy_shape", "dsT_shape", "not_contiguous"])
def test_launch_bwd_refuses_before_it_builds(bad, monkeypatch):
    """``_launch_bwd`` refuses a dtype, head size, shape or layout the
    kernel does not take before it builds, launches or counts anything."""
    def no_build(*a, **kw):
        raise AssertionError("built")
    monkeypatch.setattr(_build, "load", no_build)
    B, T, H, N = 1, 20, 2, 16
    arrays = _inputs((B, T, H, N), seed=9)
    r, k, v, w, u, s0, dy, dsT = (torch.from_numpy(a) for a in arrays)
    ckpt = wk.wkv6_fwd_ref(r, k, v, w, u, s0)[2]
    err = ValueError
    if bad == "fp16":
        r, k, v = (a.half() for a in (r, k, v))
        err = TypeError
    elif bad == "dy_bf16":
        dy = dy.bfloat16()
        err = TypeError
    elif bad == "head_size":
        r, k, v, w, dy = (a[..., :8].contiguous() for a in (r, k, v, w, dy))
        u, dsT = u[:, :8].contiguous(), dsT[..., :8, :8].contiguous()
        ckpt = ckpt[..., :8, :8].contiguous()
    elif bad == "ckpt":
        ckpt = ckpt[:, :, :1].contiguous()
    elif bad == "dy_shape":
        dy = dy[:, :-1]
    elif bad == "dsT_shape":
        dsT = dsT[0]
    else:
        dy = dy.transpose(1, 2).contiguous().transpose(1, 2)
    before = dict(wk.LAUNCHES)
    with pytest.raises(err):
        wk._launch_bwd(r, k, v, w, u, ckpt, dy, dsT, True)
    assert wk.LAUNCHES == before


@pytest.mark.parametrize("variant", ["split", "seq", "tc", "", "CLUSTER",
                                     None])
def test_launch_bwd_accepts_only_known_variants(variant, monkeypatch):
    """``_launch_bwd`` names the backward kernels ``"cluster"`` (the
    default) and ``"block"`` (the yardstick) and refuses any other name
    before it builds anything or counts a launch; so does
    ``bwd_occupancy``."""
    def no_build(*a, **kw):
        raise AssertionError("built")
    monkeypatch.setattr(_build, "load", no_build)
    assert wk.BWD_VARIANTS == ("cluster", "block")
    arrays = _inputs((1, 20, 2, 16), seed=12)
    r, k, v, w, u, s0, dy, dsT = (torch.from_numpy(a) for a in arrays)
    ckpt = wk.wkv6_fwd_ref(r, k, v, w, u, s0)[2]
    before = dict(wk.LAUNCHES)
    with pytest.raises(ValueError, match="variant"):
        wk._launch_bwd(r, k, v, w, u, ckpt, dy, dsT, True, variant=variant)
    with pytest.raises(ValueError, match="variant"):
        wk.bwd_occupancy(16, torch.float32, variant)
    assert wk.LAUNCHES == before


def test_wkv6fn_takes_the_cluster_kernel(monkeypatch):
    """``WKV6Fn``'s backward names no variant: ``_launch_bwd``'s default,
    the cluster kernel, with no fallback to the yardstick (the operator
    hands its CPU kernel, stubbed here, what it hands the launcher)."""
    import inspect
    assert inspect.signature(wk._launch_bwd).parameters["variant"].default \
        == "cluster"
    seen = []

    def launch_bwd(*args, **kw):
        seen.append(kw)
        grads = wk.wkv6_bwd_ref(*args[:5], args[5][:, :, 0], *args[6:8])
        return (*grads[:5], None)
    monkeypatch.setattr(wk, "_launch_plain", lambda *a, **kw:
                        wk.wkv6_fwd_ref(*a[:6]))
    monkeypatch.setattr(wk, "_launch_bwd_plain", launch_bwd)
    leaves = [torch.from_numpy(a).requires_grad_(i < 5)
              for i, a in enumerate(_inputs((1, 17, 2, 16), seed=13)[:6])]
    y, _ = wk.WKV6Fn.apply(*leaves)
    y.sum().backward()
    assert seen == [{}]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", wk.HEAD_SIZES)
def test_bwd_occupancy_refuses_what_no_kernel_takes(N, dtype, monkeypatch):
    """``bwd_occupancy`` refuses a head size or dtype the kernels are not
    built for before it builds anything; the ones they are built for go
    on to the build."""
    class Built(Exception):
        pass

    def no_build(*a, **kw):
        raise Built
    monkeypatch.setattr(_build, "load", no_build)
    with pytest.raises(ValueError, match="no backward kernel"):
        wk.bwd_occupancy(N + 8, dtype)
    with pytest.raises(ValueError, match="no backward kernel"):
        wk.bwd_occupancy(N, torch.float16)
    with pytest.raises(Built):
        wk.bwd_occupancy(N, dtype, "block")


def test_launch_saves_checkpoints_only_from_the_split_kernel():
    tens = [torch.from_numpy(a) for a in _inputs((1, 4, 2, 16))[:6]]
    before = dict(wk.LAUNCHES)
    with pytest.raises(ValueError, match="checkpoints"):
        wk._launch(*tens, variant="seq", ckpt=True)
    assert wk.LAUNCHES == before


def test_cpu_gradients_launch_nothing():
    """On the CPU ``wkv6`` with gradients is autograd of the plain
    version: no launch of any kernel."""
    arrays = _inputs((1, 17, 2, 16), seed=10)
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays[:6]]
    wk.reset_launches()
    y, sT = ops.wkv6(*leaves)
    (y.sum() + sT.sum()).backward()
    assert wk.LAUNCHES == {"wkv6": 0, "wkv6_seq": 0, "wkv6_bwd": 0,
                           "wkv6_bwd_block": 0}


def test_checkpoint_steps_are_the_kernels_chunk():
    """``CKPT_STEPS`` (the checkpoints' spacing the Python side allocates
    and slices by) is the kernel source's ``kChunk``."""
    src = (Path(wk.__file__).resolve().parents[1] / "csrc" /
           "wkv6_scan.cu").read_text()
    found = re.findall(r"constexpr int kChunk = (\d+);", src)
    assert found == [str(wk.CKPT_STEPS)]


def test_rwkv_gradients_at_depth_match_reference(monkeypatch):
    """A reduced rwkv6-3b at 8 layers, float32, over 256 steps (two of the
    reference's 128-step remat chunks): each gradient leaf of the port's
    loss (autograd through ``wkv6_scan_ref`` on the CPU) within relative
    L2 1e-4 of ``jax.grad`` of the reference's (the bound
    ``tests/test_torch_train.py`` holds every architecture to at 2
    layers), or within the reference's own distance from the float64
    gradient, where that is the larger.  The float64 gradient is the
    port's on the same weights with every float32 cast (``.float()``)
    made float64.  At this depth the leaf u's float32 gradients of both
    packages sit 1.7e-4 (the port's) and 4.5e-4 (the reference's) from
    it: float32's own error there, which 1e-4 cannot hold."""
    import dataclasses

    import repro.configs as RC
    from repro.models import build_model as ref_build_model
    from repro_torch import convert
    rcfg = dataclasses.replace(RC.reduced(RC.get("rwkv6-3b")), num_layers=8)
    ref = ref_build_model(rcfg)
    params = ref.init(jax.random.PRNGKey(0))
    cfg = convert.model_config_from_reference(dataclasses.asdict(rcfg))
    model = convert.lm_params_from_reference(
        cfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    rng = np.random.default_rng(3)
    batch = {n: rng.integers(0, cfg.vocab_size, (2, 256)).astype(np.int32)
             for n in ("tokens", "labels")}
    grads = jax.jit(jax.grad(lambda p: ref.loss(
        p, {n: jnp.asarray(a) for n, a in batch.items()})[0]))(params)
    tparams = trainable_params(model)
    tbatch = {n: torch.from_numpy(a) for n, a in batch.items()}

    def port_grads():
        loss, _ = model.loss(tbatch)
        return dict(zip(tparams, (g.double().numpy() for g in
                                  torch.autograd.grad(
                                      loss, list(tparams.values())))))
    t_grads = port_grads()
    for p in tparams.values():
        p.data = p.data.double()
    monkeypatch.setattr(torch.Tensor, "float", torch.Tensor.double)
    exact = port_grads()
    monkeypatch.undo()
    groups = model.param_groups()
    assert len(groups) == len(jax.tree_util.tree_leaves(grads))
    wider = []
    for path, members in groups:
        want = grads
        for key in path:
            want = want[key]
        got, ex = (np.stack([g[n] for n in members])
                   if path[1:2] == ("cycles",) else g[members[0]]
                   for g in (t_grads, exact))
        assert got.shape == want.shape, path
        limit = max(1e-4, _rel(want, ex))
        assert _rel(got, want) <= limit, (path, _rel(got, want), limit)
        if limit > 1e-4:
            wider.append(path)
    assert [p[-1] for p in wider] == ["u"]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_gradient_witness_rehearses_on_the_cpu():
    """``chip_smoke.rwkv_grad_witness`` (run alone on the card) on a
    reduced rwkv6-3b on the CPU, where ``wkv6`` is the plain version: the
    "kernel" and plain gradients agree bit for bit, both sit near the
    float64 run in float32, the perturbed float64 run moves, and
    ``float64_math`` puts the parameters and ``Tensor.float`` back."""
    cs = _chip_smoke()
    cfg = configs.reduced(configs.get("rwkv6-3b"))
    (row,) = cs.rwkv_grad_witness(torch, depths=(2,), dtypes=("float32",),
                                  B=2, T=20, vocab_chunk=100, dev="cpu",
                                  cfg=cfg)
    assert row["kernel_vs_plain"][0] == 0.0
    assert row["kernel"][0] == row["plain"][0] < 1e-4
    assert 0.0 < row["moved"][0] < 1e-4
    model = LM(cfg, device="cpu", seed=0)
    params = trainable_params(model)
    original = torch.Tensor.float
    with cs.float64_math(torch, params):
        assert all(p.dtype == torch.float64 for p in params.values())
        assert torch.ones(1).float().dtype == torch.float64
    assert torch.Tensor.float is original
    assert all(p.dtype == torch.float32 for p in params.values())


def test_train_steps_rehearses_on_the_cpu():
    """``chip_smoke.train_steps`` (the parent-against-change step timing)
    on a reduced qwen3-1.7b on the CPU: a positive median step."""
    cs = _chip_smoke()
    cfg = configs.reduced(configs.get("qwen3-1.7b"))
    assert cs.train_steps(torch, steps=3, B=2, T=16, vocab_chunk=100,
                          dev="cpu", cfg=cfg) > 0
