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
``attention_ref``, so it too is held here.

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
