"""The port's WKV6 plain version against the reference.

The same seeded numpy inputs go to the reference's exact recurrence
``repro.models.recurrent.wkv6_scan_ref`` and its chunked form
``wkv6_scan_chunked``, and to the port's ``wkv6_scan_ref``,
``wkv6_scan_chunked`` and CPU dispatch (``repro_torch.kernels.ops.wkv6``).
The reference Pallas kernel does not trace on this jax; its oracle does.
Tolerance is the reference kernel tests' own: atol 1e-4, rtol 1e-3.  The
CUDA kernel is held to the same plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import recurrent as jrec
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6_scan as wk
from repro_torch.models import recurrent as trec

ATOL, RTOL = 1e-4, 1e-3

#: the reference kernel tests' cases (B, T, H, N, chunk), then a decode
#: step at both model head sizes and ragged lengths
WKV_CASES = [
    (2, 64, 2, 16, 16),
    (1, 128, 4, 32, 64),
    (2, 32, 1, 64, 32),
    (1, 96, 3, 16, 32),
    (3, 1, 2, 16, 1),
    (2, 1, 2, 64, 1),
    (1, 37, 2, 64, 37),
    (2, 100, 1, 16, 25),
]


def _inputs(seed, B, T, H, N, random_state=False):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, N)).astype(np.float32)
               for _ in range(3))
    w = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, T, H, N)))) * 0.5
         + 0.45).astype(np.float32)
    u = (rng.standard_normal((H, N)) * 0.5).astype(np.float32)
    s0 = (rng.standard_normal((B, H, N, N)) * random_state).astype(
        np.float32)
    return r, k, v, w, u, s0


def _real_decay_inputs(seed, B, T, H, N, random_state):
    """RWKV-6's own decay range: w = exp(-exp(x)), x uniform in [-8, 2],
    so w runs from about 6e-4 to just below 1."""
    r, k, v, _, u, s0 = _inputs(seed, B, T, H, N, random_state)
    x = np.random.default_rng(seed + 1).uniform(-8.0, 2.0, (B, T, H, N))
    w = np.exp(-np.exp(x)).astype(np.float32)
    return r, k, v, w, u, s0


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("case", WKV_CASES, ids=str)
@pytest.mark.parametrize("random_state", [False, True])
def test_plain_matches_reference_recurrence(case, random_state):
    B, T, H, N, _ = case
    arrays = _inputs(sum(case), B, T, H, N, random_state)
    y_ref, s_ref = jrec.wkv6_scan_ref(*(jnp.asarray(a) for a in arrays))
    before = dict(wk.LAUNCHES)
    y, s = ops.wkv6(*(torch.from_numpy(a) for a in arrays))
    assert wk.LAUNCHES == before          # the CPU never counts a launch
    assert y.dtype == s.dtype == torch.float32
    _close(y, y_ref)
    _close(s, s_ref)


@pytest.mark.parametrize("case", WKV_CASES, ids=str)
def test_chunked_forms_agree(case):
    """The port's chunked form against the reference's, and the kernel's
    plain version against both."""
    B, T, H, N, chunk = case
    arrays = _inputs(3, B, T, H, N)
    y_ref, s_ref = jrec.wkv6_scan_chunked(*(jnp.asarray(a) for a in arrays),
                                          chunk=chunk)
    tens = [torch.from_numpy(a) for a in arrays]
    y_c, s_c = trec.wkv6_scan_chunked(*tens, chunk=chunk)
    _close(y_c, y_ref)
    _close(s_c, s_ref)
    y_p, s_p = wk.wkv6_scan_ref(*tens)
    _close(y_p, y_ref)
    _close(s_p, s_ref)


def test_bf16_inputs_match_reference():
    """r, k and v in bf16 (the model's compute dtype), w, u and s0 in
    fp32: both packages widen to fp32 the same values."""
    arrays = _inputs(9, 2, 24, 2, 64)
    jx = [jnp.asarray(a) for a in arrays]
    th = [torch.from_numpy(a) for a in arrays]
    for i in range(3):
        jx[i] = jx[i].astype(jnp.bfloat16)
        th[i] = th[i].to(torch.bfloat16)
    y_ref, s_ref = jrec.wkv6_scan_ref(*jx)
    y, s = ops.wkv6(*th)
    _close(y, y_ref)
    _close(s, s_ref)


@pytest.mark.parametrize("split", [1, 32, 63])
def test_state_carry_across_calls(split):
    """Splitting a sequence across two calls carries the state exactly
    (the reference's two-call state-carry case, at several splits)."""
    B, T, H, N = 1, 64, 2, 16
    arrays = _inputs(11, B, T, H, N)
    y_full, s_full = jrec.wkv6_scan_ref(*(jnp.asarray(a) for a in arrays))
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in arrays)
    y1, s_mid = ops.wkv6(r[:, :split], k[:, :split], v[:, :split],
                         w[:, :split], u, s0)
    y2, s_T = ops.wkv6(r[:, split:], k[:, split:], v[:, split:],
                       w[:, split:], u, s_mid)
    _close(torch.cat([y1, y2], dim=1), y_full)
    _close(s_T, s_full)


@pytest.mark.parametrize("bad", ["shape", "u", "s0", "empty"])
def test_wrapper_rejects_bad_shapes(bad):
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in _inputs(1, 1, 4, 2, 16))
    if bad == "shape":
        k = k[:, :3]
    elif bad == "u":
        u = u[:1]
    elif bad == "s0":
        s0 = s0[..., :8]
    else:
        r, k, v, w = (a[:, :0] for a in (r, k, v, w))
    with pytest.raises(ValueError):
        wk.wkv6(r, k, v, w, u, s0)


@pytest.mark.parametrize("T", [3, 1025])
@pytest.mark.parametrize("random_state", [False, True])
def test_real_decay_range_matches_reference(T, random_state):
    """Strong and weak decays together, at T = 3 and at T = 1025 (one past
    a power-of-two chunk), from a zero and from a random state."""
    B, H, N = 1, 2, 16
    arrays = _real_decay_inputs(T + random_state, B, T, H, N, random_state)
    w = arrays[3]
    assert 5e-4 < w.min() and w.max() < 1.0
    assert T < 1000 or (w.min() < 1e-3 and w.max() > 0.999)
    y_ref, s_ref = jrec.wkv6_scan_ref(*(jnp.asarray(a) for a in arrays))
    y, s = ops.wkv6(*(torch.from_numpy(a) for a in arrays))
    _close(y, y_ref)
    _close(s, s_ref)


def test_cpu_counts_no_launch():
    """On the CPU the wrapper takes the plain version and counts no
    kernel."""
    arrays = _real_decay_inputs(4, 2, 5, 2, 32, True)
    wk.reset_launches()
    ops.wkv6(*(torch.from_numpy(a) for a in arrays))
    assert wk.LAUNCHES == {"wkv6": 0, "wkv6_seq": 0, "wkv6_bwd": 0,
                           "wkv6_bwd_block": 0}


@pytest.mark.parametrize("variant", ["scalar", "tc", "", "SEQ", None])
def test_launch_accepts_only_known_variants(variant):
    """``_launch`` names its kernels ``"split"`` and ``"seq"`` and refuses
    any other name before it touches a device or counts a launch."""
    assert wk.VARIANTS == ("split", "seq")
    tens = [torch.from_numpy(a) for a in _inputs(2, 1, 3, 2, 16)]
    before = dict(wk.LAUNCHES)
    with pytest.raises(ValueError, match="variant"):
        wk._launch(*tens, variant=variant)
    assert wk.LAUNCHES == before


@pytest.mark.parametrize("bad", ["fp16", "w_bf16", "head_size",
                                 "not_contiguous"])
def test_launch_checks_before_it_launches(bad):
    """``_launch`` refuses a dtype, head size or layout the kernels do not
    take before it builds, launches or counts anything."""
    r, k, v, w, u, s0 = (torch.from_numpy(a)
                         for a in _inputs(2, 1, 3, 2, 16))
    err = TypeError
    if bad == "fp16":
        r, k, v = (a.half() for a in (r, k, v))
    elif bad == "w_bf16":
        w = w.bfloat16()
    elif bad == "head_size":
        r, k, v, w = (a[..., :8].contiguous() for a in (r, k, v, w))
        u, s0 = u[:, :8].contiguous(), s0[..., :8, :8].contiguous()
        err = ValueError
    else:
        r = r.transpose(1, 2).contiguous().transpose(1, 2)
        err = ValueError
    before = dict(wk.LAUNCHES)
    with pytest.raises(err):
        wk._launch(r, k, v, w, u, s0)
    assert wk.LAUNCHES == before
