"""The gradients of the port's attention against the reference's.

``attention_bwd_ref`` (the plain version of the backward kernel, from the
explicit formulas) is held three ways, within relative L2 1e-5 for each
of dq, dk and dv: against PyTorch's autograd of the port's
``attention_ref``, and against ``jax.vjp`` of the reference's oracle
``repro.kernels.ref.attention_ref`` and of its model attention
``repro.models.layers.sdpa`` (at T below ``kv_chunk``, where the chunked
sdpa is exact).  The cases: causal, windowed, bidirectional with Tq !=
Tk (fully masked rows included), GQA with R in {1, 2, 4}, and Tq = 1.
On the CPU the port's ``flash_attention`` is the autograd of
``attention_ref``, so it too is held here.  The rows that a
bidirectional window leaves no key (the card tests' ``(1, 100, 37, 4, 2,
False, 8)``, rows 44 and up) are held against ``jax.vjp`` of the
oracle on their own.  ``bwd_variant``'s routing and ``_launch_bwd``'s
refusals, which come before any build, are checked here too.

The reference's ragged-chunk fault (ROADMAP.md §C, entry 2) bears on
training whenever T > ``kv_chunk`` and T is not a multiple of it: its
chunked sdpa then misreads the last key chunk, forward and backward.  At
T = 100 and ``kv_chunk`` 32 the port's gradients equal the oracle's and
the reference sdpa's do not (the whole model's loss and gradients:
``tests/test_torch_train.py``).  The CUDA kernel is held to
``attention_bwd_ref`` on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import settings as jsettings
from repro.models.layers import sdpa as jax_sdpa
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

#: (B, Tq, Tk, H, G, D, causal, window)
CASES = [
    (2, 33, 33, 4, 4, 16, True, None),       # R = 1
    (2, 40, 40, 4, 2, 16, True, None),       # R = 2
    (1, 37, 37, 8, 2, 32, True, None),       # R = 4
    (1, 50, 50, 4, 2, 16, True, 7),          # window
    (2, 9, 21, 4, 2, 16, False, None),       # bidirectional, Tq < Tk
    (1, 30, 10, 4, 1, 16, False, 4),         # Tq > Tk: fully masked rows
    (2, 1, 17, 4, 4, 32, False, None),       # Tq = 1 (cross decode)
    (1, 1, 1, 4, 2, 16, True, None),         # Tq = Tk = 1
    (1, 40, 40, 4, 2, 160, True, None),      # D = 160, GQA (pixtral-12b)
    (1, 50, 50, 4, 1, 256, True, 7),         # D = 256, MQA, a window
    (2, 9, 21, 4, 1, 256, False, None),      # D = 256, Tq < Tk
]
LIMIT = 1e-5


def _inputs(case, seed=0):
    B, Tq, Tk, H, G, D, _, _ = case
    rng = np.random.default_rng(seed + Tq + 7 * Tk)
    return (rng.standard_normal((B, Tq, H, D)).astype(np.float32),
            rng.standard_normal((B, Tk, G, D)).astype(np.float32),
            rng.standard_normal((B, Tk, G, D)).astype(np.float32),
            rng.standard_normal((B, Tq, H, D)).astype(np.float32))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _close(got, want, limit=LIMIT):
    """Each gradient within ``limit`` relative L2; a gradient that
    vanishes (dq and dk at Tq = Tk = 1, where the softmax is constant) is
    held to ``limit`` of dv's norm instead."""
    scale = np.linalg.norm(np.asarray(want[2], np.float64))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w, np.float64)
        err = np.linalg.norm(np.asarray(g, np.float64) - w)
        denom = np.linalg.norm(w)
        if denom < 1e-6 * scale:
            denom = scale
        assert err <= limit * denom, (name, err / denom)


def _reference_vjp(fn, q, k, v, do, **kw):
    """(dq, dk, dv) of the reference's ``fn`` by ``jax.vjp``, jitted (one
    compile, not one a primitive)."""
    @jax.jit
    def grads(a, b, c, g):
        return jax.vjp(lambda x, y, z: fn(x, y, z, **kw), a, b, c)[1](g)
    return [np.asarray(x) for x in grads(*(jnp.asarray(a)
                                           for a in (q, k, v, do)))]


def _port_bwd(q, k, v, do, causal, window):
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o = fa.attention_ref(tq, tk, tv, causal=causal, window=window)
    return [g.numpy() for g in fa.attention_bwd_ref(
        tq, tk, tv, o, tdo, causal=causal, window=window)]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_bwd_ref_matches_autograd(case):
    *_, causal, window = case
    q, k, v, do = _inputs(case)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = fa.attention_ref(*leaves, causal=causal, window=window)
    want = torch.autograd.grad(o, leaves, torch.from_numpy(do))
    _close(_port_bwd(q, k, v, do, causal, window),
           [w.numpy() for w in want])


@pytest.mark.parametrize("case", CASES, ids=str)
def test_bwd_ref_matches_reference_vjp(case):
    """Against ``jax.vjp`` of the reference's oracle and of its sdpa (T
    below the default kv_chunk 512: one exact chunk)."""
    *_, causal, window = case
    q, k, v, do = _inputs(case)
    got = _port_bwd(q, k, v, do, causal, window)
    for fn in (jref.attention_ref, jax_sdpa):
        _close(got, _reference_vjp(fn, q, k, v, do, causal=causal,
                                   window=window))


@pytest.mark.parametrize("case", CASES[:5], ids=str)
def test_flash_attention_gradients_on_the_cpu(case):
    """The port's ``flash_attention`` on CPU tensors is the autograd of
    ``attention_ref``; it launches nothing."""
    *_, causal, window = case
    q, k, v, do = _inputs(case, seed=1)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    ops.reset_launches()
    o = ops.flash_attention(*leaves, causal=causal, window=window)
    got = torch.autograd.grad(o, leaves, torch.from_numpy(do))
    assert ops.launches()["flash_attention_bwd"] == 0
    assert ops.launches()["flash_attention"] == 0
    _close([g.numpy() for g in got],
           _port_bwd(q, k, v, do, causal, window))


def test_bwd_ref_keeps_the_dtype():
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs(CASES[1]))
    o = fa.attention_ref(q, k, v)
    grads = fa.attention_bwd_ref(q, k, v, o, do)
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]


def test_reference_ragged_chunk_fault_reaches_the_gradients():
    """T = 100 over kv_chunk 32 (ragged): the reference's chunked sdpa's
    gradients differ from its own oracle's, the port's agree with it."""
    case = (1, 100, 100, 4, 2, 16, True, None)
    q, k, v, do = _inputs(case)
    got = _port_bwd(q, k, v, do, True, None)
    oracle = _reference_vjp(jref.attention_ref, q, k, v, do)
    _close(got, oracle)
    with jsettings.use(kv_chunk=32, q_chunk=32):    # read when traced
        chunked = _reference_vjp(jax_sdpa, q, k, v, do, causal=True)
    assert max(_rel(c, o) for c, o in zip(chunked, oracle)) > 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
@pytest.mark.parametrize("D", fa.HEAD_DIMS)
def test_bwd_variant_routes_by_dtype_and_head_size(dtype, D):
    """bf16 at every head size takes the tensor-core backward, fp32 at
    every head size the split one (three bf16 pieces an operand on the
    tensor cores; column pairs at D = 160 and 256), everything else the
    scalar one; a fixed choice by dtype and head size."""
    if dtype == torch.bfloat16:
        want = "tc"
    elif dtype == torch.float32:
        want = "split"
    else:
        want = "scalar"
    assert fa.bwd_variant(dtype, D) == want
    assert D in fa.BWD_TC_HEAD_DIMS
    assert D in fa.BWD_SPLIT_HEAD_DIMS


def test_training_paths_take_the_tensor_core_backward():
    """qwen3-1.7b (D = 128), seamless-m4t-large-v2 (D = 64), pixtral-12b
    (D = 160) and recurrentgemma-9b (D = 256) train on the tensor-core
    backward."""
    from repro_torch import configs
    for name in ("qwen3-1.7b", "seamless-m4t-large-v2", "pixtral-12b",
                 "recurrentgemma-9b"):
        cfg = configs.get(name)
        assert fa.bwd_variant(cfg.compute_dtype, cfg.head_dim) == "tc", name


@pytest.mark.parametrize("dtype,D,kind", [
    (torch.float32, 128, "tc"), (torch.float32, 160, "tc"),
    (torch.float32, 256, "tc"), (torch.float32, 16, "tc"),
    (torch.bfloat16, 128, "fast"), (torch.bfloat16, 128, "split"),
    (torch.bfloat16, 160, "split"), (torch.bfloat16, 256, "split")],
    ids=str)
def test_launch_bwd_refuses_what_the_variant_does_not_take(dtype, D, kind):
    """``_launch_bwd(kind="tc")`` raises where ``bwd_variant`` names
    another kernel, ``kind="split"`` likewise (bf16 at every head size,
    the column pair's 160 and 256 too), and an unknown variant raises,
    before anything is built or launched (so on the CPU too)."""
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in _inputs(
        (1, 8, 8, 2, 1, D, True, None)))
    o = torch.zeros_like(q)
    before = dict(fa.LAUNCHES)
    match = {"tc": "takes bf16 at head sizes",
             "split": "takes float32 at head sizes"}.get(kind, "unknown")
    with pytest.raises(ValueError, match=match):
        fa._launch_bwd(q, k, v, o, do, True, None, kind=kind)
    assert fa.LAUNCHES == before


@pytest.mark.parametrize("D", [16, 32])
def test_bwd_ref_on_rows_with_no_key_matches_reference_vjp(D):
    """Bidirectional, Tq = 100 over Tk = 37 keys, window 8: rows 44 and up
    see no key, and the oracle's softmax spreads them uniformly over the
    Tk keys.  ``attention_bwd_ref`` gives them dq = 0 and their 1 / Tk
    share of dv, as ``jax.vjp`` of the reference's oracle does; their
    output is the mean of v."""
    case = (1, 100, 37, 4, 2, D, False, 8)
    q, k, v, do = _inputs(case, seed=5)
    got = _port_bwd(q, k, v, do, False, 8)
    want = _reference_vjp(jref.attention_ref, q, k, v, do, causal=False,
                          window=8)
    _close(got, want)
    np.testing.assert_array_equal(got[0][:, 44:], 0.0)
    np.testing.assert_allclose(want[0][:, 44:], 0.0, atol=1e-6)
    # the keyless rows alone: each KV head's dv is its R heads' summed dO
    # over those rows, 1 / Tk of it on every key; no dk
    do2 = do.copy()
    do2[:, :44] = 0.0
    got2 = _port_bwd(q, k, v, do2, False, 8)
    _close(got2, _reference_vjp(jref.attention_ref, q, k, v, do2,
                                causal=False, window=8))
    share = do2[:, 44:].reshape(1, 56, 2, 2, D).sum(axis=(1, 3)) / 37
    np.testing.assert_allclose(got2[2], np.broadcast_to(
        share[:, None], got2[2].shape), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got2[1], 0.0, atol=1e-6)
    o = fa.attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                         causal=False, window=8).numpy()
    mean_v = v.mean(axis=1, keepdims=True).repeat(2, axis=2)
    np.testing.assert_allclose(o[:, 44:], np.broadcast_to(
        mean_v, o[:, 44:].shape), rtol=1e-5, atol=1e-6)


def test_library_name_follows_the_shared_header(tmp_path, monkeypatch):
    """Both attention sources include ``csrc/sm90.cuh``: its contents are
    part of every library's name, so an edited header never loads a
    library built from the old one."""
    from repro_torch.kernels import _build
    assert (_build.CSRC / "sm90.cuh").exists()
    for name in ("flash_attention", "flash_attention_bwd"):
        assert '#include "sm90.cuh"' in (_build.CSRC / f"{name}.cu"
                                         ).read_text()
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._target("k")
    assert first == _build._target("k")
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build._target("k") != first


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_cut_training_phase_rehearses_on_the_cpu():
    """``chip_smoke.phase_train_cut`` (recurrentgemma-9b's and
    pixtral-12b's training at cut depth) on reduced configs on the CPU,
    through ``train_kit``'s trainer and loop: one cycle of rec, rec, attn
    and 2 layers with 8 patches a sequence, a finite loss that falls, and
    no kernel launch (the CPU runs the plain versions).  The rate is one
    the 64-wide models learn from in 6 steps: the defaults' 100-step
    warmup moves them by less than the batches' own spread of the loss
    (measured with the defaults: recurrentgemma-9b's cycle from 6.2733 to
    6.2803 in 6 steps, and up and down by 0.05 over 16)."""
    from repro_torch import configs
    from repro_torch.train.train_loop import TrainConfig
    cs = _chip_smoke()
    trainer, loop = cs.train_kit(TrainConfig(peak_lr=1e-2, warmup_steps=1),
                                 vocab_chunk=100)
    cfgs = {arch: configs.reduced(configs.get(arch)) for arch in cs.CUT_TRAIN}
    models = {"recurrentgemma-9b": (3, 16, 0, 3), "pixtral-12b": (2, 12, 8, 2)}
    assert set(models) == set(cs.CUT_TRAIN)
    ops.reset_launches()
    runs = cs.phase_train_cut(torch, 0, "cpu", trainer, loop, dev="cpu",
                              models=models, cfgs=cfgs, B=2, steps=6)
    assert set(runs) == set(models)
    for arch, run in runs.items():
        assert len(run["losses"]) == 6, arch
        assert all(np.isfinite(run["losses"])), arch
        assert run["losses"][-1] < run["losses"][0], arch
        assert run["launches"] == 0 and run["step_ms"] > 0, arch
        assert run["rel"] < cs.TRAIN_GRAD_L2["float32"], arch
    assert all(n == 0 for n in ops.launches().values())


def test_moe_training_phase_rehearses_on_the_cpu():
    """``chip_smoke.phase_train_moe`` (qwen3-moe-30b-a3b's training at cut
    depth with Adafactor) on the reduced config in bf16 on the CPU: 2
    layers, 4 steps, a finite loss that falls, no kernel launch, and the
    gradient checks' two passes: bf16 with the routes pinned to the
    first pass's (``with_routes``' replay across the forward and remat's
    recompute), fp32 with them free; on the CPU both passes are the plain
    version, so their gradients agree exactly."""
    import dataclasses
    from repro_torch import configs
    cs = _chip_smoke()
    cfg = dataclasses.replace(configs.reduced(configs.get(cs.MOE_ARCH)),
                              dtype="bfloat16")
    ops.reset_launches()
    run = cs.phase_train_moe(torch, 0, "cpu", dev="cpu", cfg=cfg,
                             shape=(2, 4, 2), B=2, T=32, vocab_chunk=100)
    assert len(run["losses"]) == 4 and all(np.isfinite(run["losses"]))
    assert run["losses"][-1] < run["losses"][0]
    assert run["launches"] == run["fwd_launches"] == 0
    assert run["rel"] == 0 and run["rel_fp32"] == 0
    assert all(n == 0 for n in ops.launches().values())


_PTXAS_HEAD = ("ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__"
               "733d37c0_22_flash_attention_bwd_cu_2b1a21a5{}' for 'sm_90a'\n"
               "ptxas info    : Function properties for _ZN55_GLOBAL__N__"
               "733d37c0_22_flash_attention_bwd_cu_2b1a21a5{}\n")
_PTXAS_SPILL = ("    {} bytes stack frame, {} bytes spill stores, {} bytes "
                "spill loads\nptxas info    : Used 168 registers\n")


def _ptxas(functions):
    """``-Xptxas -v`` output of mangled backward kernels, each with (stack
    frame, spill stores, spill loads) bytes."""
    return "".join(_PTXAS_HEAD.format(fn, fn) + _PTXAS_SPILL.format(*n)
                   for fn, n in functions)


@pytest.mark.parametrize("functions,spills,refused", [
    # the scalar kernels' spills are logged and allowed
    ([("8bwd_dkdvI13__nv_bfloat16Li16EEEvPKT_S4_S4_S4_PKfS6_S6_PS2_S7_NS_"
       "5ShapeE", (16, 12, 28)),
      ("6bwd_dqIfLi32EEEvPKT_S3_S3_S3_PKfS5_S5_PS1_NS_5ShapeE", (24, 20, 20)),
      ("11bwd_dkdv_tcILi128EEEvNS_4MapsEP13__nv_bfloat16S3_NS_4ArgsE",
       (0, 0, 0))],
     {"bwd_dkdv<bf16, 16>": (12, 28), "bwd_dq<fp32, 32>": (20, 20)}, False),
    # a tensor-core pass that spills fails the check, its wide forms too
    ([("10bwd_dq_tc2ILi256EEEvNS_4MapsEPKfP13__nv_bfloat16NS_4ArgsE",
       (8, 4, 4))], {"bwd_dq_tc2<256>": (4, 4)}, True),
    ([("12bwd_stats_tcILi64EEEvNS_4MapsEPK13__nv_bfloat16S4_PfNS_4ArgsE",
       (0, 0, 8))], {"bwd_stats_tc<64>": (0, 8)}, True),
    # the passes by head size and operand pieces: an fp32 (three-piece)
    # pass that spills fails it, its bf16 form beside it named apart
    ([("11bwd_dkdv_tcILi128ELi3EEEvNS_4MapsEPfS3_NS_4ArgsE", (8, 4, 4)),
      ("11bwd_dkdv_tcILi128ELi1EEEvNS_4MapsEP13__nv_bfloat16S4_NS_4ArgsE",
       (0, 0, 0))], {"bwd_dkdv_tc<128, 3>": (4, 4)}, True),
    # an fp32 column pair's pass (D = 160 or 256 over two blocks) that
    # spills fails it, named by head size, pieces and blocks
    ([("9bwd_dq_tcILi160ELi3ELi2EEEvNS_4MapsEPKfPfNS_4ArgsE", (0, 0, 0)),
      ("11bwd_dkdv_tcILi256ELi3ELi2EEEvNS_4MapsEPfS3_NS_4ArgsE",
       (16, 8, 12))], {"bwd_dkdv_tc<256, 3, 2>": (8, 12)}, True),
])
def test_build_spill_check_reads_ptxas(functions, spills, refused):
    """``chip_smoke.bwd_spills`` reads the spill lines of ptxas's verbose
    output by function: the scalar kernels may spill, a tensor-core pass
    of the backward may not."""
    cs = _chip_smoke()
    text = _ptxas(functions)
    assert cs.ptxas_spills(text) == spills
    if refused:
        with pytest.raises(cs.CheckFailed, match="spill to local memory"):
            cs.bwd_spills(text)
    else:
        assert cs.bwd_spills(text) == spills
