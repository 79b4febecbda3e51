"""The RWKV-6 WKV recurrence, as hand-written CUDA.

Counterpart of the reference's Pallas kernel
``repro/kernels/rwkv6_scan.py::wkv6_pallas`` (body ``_kernel``).  Per
``(b, h)`` stream, with an ``(N, N)`` float32 state ``s``::

    y_t = r_t^T (s + (u * k_t) outer v_t)
    s   = diag(w_t) s + k_t outer v_t

``r``, ``k``, ``v`` and ``w`` are ``(B, T, H, N)``, ``u`` is ``(H, N)``,
``s0`` is ``(B, H, N, N)``; the result is ``(y (B, T, H, N) float32, s_T
(B, H, N, N) float32)``.  The kernel lives in ``csrc/wkv6_scan.cu`` (see
its header for the work split and what bounds it on the card).

:func:`wkv6_scan_ref` is the plain PyTorch version, a sequential loop over
T in float32, the counterpart of the reference's oracle
``repro.models.recurrent.wkv6_scan_ref``.  :func:`wkv6` takes it for
tensors on the CPU (autograd differentiates it there); for CUDA tensors
it launches the kernel or raises, and never falls back.

The gradient.  On CUDA tensors that require grad (with grad mode on)
:func:`wkv6` goes through :class:`WKV6Fn`: its forward launches the split
kernel, which also saves the state before every :data:`CKPT_STEPS`-th
step, and its backward launches ``wkv6_bwd_cluster``, which recomputes
each chunk's states from those and walks the chunk back, a stream's state
columns split over a thread-block cluster (the header of
``csrc/wkv6_scan.cu`` has the design).  :func:`wkv6_bwd_ref` is the plain
version of the backward, from the explicit formulas, and
:func:`wkv6_fwd_ref` that of the forward with its checkpoints.

Kernels, all in ``csrc/wkv6_scan.cu``: ``wkv6_split`` (variant
``"split"``), which :func:`wkv6` launches, the sequential ``wkv6_seq`` it
replaced (variant ``"seq"``), kept as the yardstick and reached only
through ``_launch(..., variant="seq")``; the backward's
``wkv6_bwd_cluster`` (variant ``"cluster"``), which :class:`WKV6Fn`
launches, and the one-block-a-stream ``wkv6_bwd_block`` it replaced
(variant ``"block"``), the yardstick, reached only through
``_launch_bwd(..., variant="block")``.  :data:`LAUNCHES` counts kernel
launches and nothing else: ``wkv6`` every forward launch of either,
``wkv6_seq`` the sequential kernel's, ``wkv6_bwd`` every backward launch
of either, ``wkv6_bwd_block`` the yardstick's.

The counting form.  On the card the kernels are reached through three
operators, ``torch.ops.repro_torch.wkv6`` (the forward), ``wkv6_ckpt``
(the forward with its checkpoints) and ``wkv6_bwd``: their CUDA kernel is
the launch above (one a call, counted as above), their CPU kernel the
plain version (a plain CPU tensor takes it before the operator; a
DTensor's CPU shards reach it through the operator), their fake kernel
empty results of the right shapes, and their FLOPs (:func:`wkv6_flops`: 5 N^2 a step of each (b, h) stream
forward, 14 N^2 backward, PERF.md's bounds) are registered with
:mod:`torch.utils.flop_counter`.  Tensors that hold no data (fake, meta,
DTensors: the dry run) take the operators, never the plain Python loop
over T; the first such call gives DTensor their rules
(:func:`register_sharding`: split over the batch, or over the heads).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build, _shards

__all__ = ["BWD_VARIANTS", "CKPT_STEPS", "HEAD_SIZES", "LAUNCHES",
           "VARIANTS", "WKV6Fn", "bwd_occupancy", "register_sharding",
           "reset_launches", "wkv6", "wkv6_bwd_ref", "wkv6_flops",
           "wkv6_fwd_ref", "wkv6_scan_ref"]

#: kernel launches since the last :func:`reset_launches`: ``wkv6`` counts
#: both forward variants, ``wkv6_seq`` the sequential one alone,
#: ``wkv6_bwd`` both backward variants, ``wkv6_bwd_block`` the yardstick
#: alone
LAUNCHES: Dict[str, int] = {"wkv6": 0, "wkv6_seq": 0, "wkv6_bwd": 0,
                            "wkv6_bwd_block": 0}
#: the forward saves the state before every this many steps for the
#: backward (the split kernel's chunk)
CKPT_STEPS = 16
#: the kernels ``_launch`` takes by name: the column- and row-split kernel
#: and the sequential one it replaced
VARIANTS = ("split", "seq")
#: the backward kernels ``_launch_bwd`` takes by name: the cluster kernel
#: and the one-block-a-stream kernel it replaced
BWD_VARIANTS = ("cluster", "block")
#: the head sizes the kernel is built for: rwkv6-3b's 64, the reduced
#: configs' 16 and the reference kernel tests' 32
HEAD_SIZES = (16, 32, 64)

_SOURCE = "wkv6_scan"
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"wkv6_fwd": [_P] * 9 + [_I] * 6 + [_P],
               "wkv6_bwd": [_P] * 15 + [_I] * 5 + [_P],
               "wkv6_bwd_yardstick": [_P] * 15 + [_I] * 5 + [_P],
               "wkv6_bwd_occupancy": [_I] * 3 + [_P]}
#: the C entry of each backward variant
_BWD_ENTRIES = {"cluster": "wkv6_bwd", "block": "wkv6_bwd_yardstick"}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def wkv6_scan_ref(r, k, v, w, u, s0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact sequential recurrence in float32: ``(y, s_T)``."""
    r, k, v, w = (a.float() for a in (r, k, v, w))
    u = u.float()[None, :, :, None]
    s = s0.float()
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]        # (B,H,N,N)
        ys.append(torch.einsum("bhn,bhnm->bhm", r[:, t], s + u * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(ys, dim=1), s


def wkv6_fwd_ref(r, k, v, w, u, s0):
    """The plain version of the forward kernel with its checkpoints: (y,
    s_T, ckpt), ckpt (B, H, ceil(T / CKPT_STEPS), N, N) float32 the state
    before steps 0, CKPT_STEPS, 2 CKPT_STEPS, ..."""
    T = r.shape[1]
    s, ys, ckpt = s0.float(), [], []
    for t0 in range(0, T, CKPT_STEPS):
        ckpt.append(s)
        sl = slice(t0, t0 + CKPT_STEPS)
        y, s = wkv6_scan_ref(r[:, sl], k[:, sl], v[:, sl], w[:, sl], u, s)
        ys.append(y)
    return torch.cat(ys, dim=1), s, torch.stack(ckpt, dim=2)


def wkv6_bwd_ref(r, k, v, w, u, s0, dy, dsT=None):
    """The exact backward of :func:`wkv6_scan_ref`, a loop back over T in
    float32 from the explicit formulas (it recomputes and stores every
    s_{t-1} itself): ``(dr, dk, dv, dw, du, ds0)``, dr, dk and dv in r's
    dtype, the rest float32.  ``dsT`` None is zero.  With dS the gradient
    of s_t, walking back from dS_T = dsT and a_t = v_t . dy_t::

        dr_t = s_{t-1} dy_t + u k_t a_t     dk_t = dS_t v_t + u r_t a_t
        dv_t = dS_t^T k_t + (r_t . u k_t) dy_t
        dw_t[i] = sum_j s_{t-1}[i, j] dS_t[i, j]
        du = sum over b and t of r_t k_t a_t
        dS_{t-1} = w_t dS_t + r_t outer dy_t;  ds0 = dS_0
    """
    dtype = r.dtype
    r, k, v, w, dy = (a.float() for a in (r, k, v, w, dy))
    uf = u.float()
    T = r.shape[1]
    s = s0.float()
    states = []
    for t in range(T):
        states.append(s)
        s = w[:, t, :, :, None] * s + k[:, t, :, :, None] * v[:, t, :, None, :]
    dS = torch.zeros_like(s) if dsT is None else dsT.float()
    grads = [torch.empty_like(r) for _ in range(4)]
    dr, dk, dv, dw = grads
    du = torch.zeros_like(uf)
    for t in range(T - 1, -1, -1):
        sp = states[t]
        rt, kt, vt, wt, gy = r[:, t], k[:, t], v[:, t], w[:, t], dy[:, t]
        a = (vt * gy).sum(-1, keepdim=True)                 # (B, H, 1)
        c = (rt * uf * kt).sum(-1, keepdim=True)
        dr[:, t] = torch.einsum("bhij,bhj->bhi", sp, gy) + uf * kt * a
        dk[:, t] = torch.einsum("bhij,bhj->bhi", dS, vt) + uf * rt * a
        dv[:, t] = torch.einsum("bhij,bhi->bhj", dS, kt) + c * gy
        dw[:, t] = (sp * dS).sum(-1)
        du += (rt * kt * a).sum(0)
        dS = wt[..., None] * dS + rt[..., None] * gy[..., None, :]
    return (dr.to(dtype), dk.to(dtype), dv.to(dtype), dw, du, dS)


def _check_like(r, name, t, shape) -> None:
    if not isinstance(t, torch.Tensor) or tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(getattr(t, 'shape', ()))}")
    if t.device != r.device:
        raise ValueError(f"{name} is on {t.device}, expected {r.device}")


def _check_inputs(r, k, v, w, u) -> Tuple[int, int, int, int]:
    if not isinstance(r, torch.Tensor) or r.dim() != 4:
        raise ValueError("r must be a (B, T, H, N) tensor")
    B, T, H, N = r.shape
    if T < 1:
        raise ValueError("the sequence must hold at least one step")
    for name, t in (("k", k), ("v", v), ("w", w)):
        _check_like(r, name, t, (B, T, H, N))
    _check_like(r, "u", u, (H, N))
    return B, T, H, N


def _check(r, k, v, w, u, s0) -> Tuple[int, int, int, int]:
    B, T, H, N = _check_inputs(r, k, v, w, u)
    _check_like(r, "s0", s0, (B, H, N, N))
    return B, T, H, N


def _check_bwd(r, k, v, w, u, ckpt, dy, dsT) -> Tuple[int, int, int, int]:
    """The backward's shapes and devices (``dsT`` may be None)."""
    B, T, H, N = _check_inputs(r, k, v, w, u)
    _check_like(r, "ckpt", ckpt, (B, H, -(-T // CKPT_STEPS), N, N))
    _check_like(r, "dy", dy, (B, T, H, N))
    if dsT is not None:
        _check_like(r, "dsT", dsT, (B, H, N, N))
    return B, T, H, N


def _check_bwd_variant(variant) -> None:
    if variant not in BWD_VARIANTS:
        raise ValueError(f"unknown backward variant {variant!r}; "
                         f"expected one of {BWD_VARIANTS}")


def _check_operands(r, k, v, w, u, named):
    """The kernels' rules for their operands: r, k and v of one of the
    kernels' dtypes, the rest (w, u and ``named``) float32, N a built head
    size, every tensor contiguous and 16-byte aligned."""
    N = r.shape[-1]
    if r.dtype not in _DTYPE_CODES or k.dtype != r.dtype or \
            v.dtype != r.dtype:
        raise TypeError(f"r, k and v must share float32 or bfloat16, got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    floats = (("w", w), ("u", u), *named)
    for name, t in floats:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if N not in HEAD_SIZES:
        raise ValueError(f"the kernel takes head sizes {HEAD_SIZES}, got {N}")
    for name, t in (("r", r), ("k", k), ("v", v), *floats):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             f"copies 16 bytes at a time)")


def _launch(r, k, v, w, u, s0, variant: str = "split", ckpt: bool = False):
    """Launch ``variant`` on CUDA tensors: ``"split"`` (the default, what
    :func:`wkv6` runs) or ``"seq"``.  y and s_T are allocated apart: the
    state a prefill hands on would otherwise keep the prefill's y alive.
    With ``ckpt`` (the split kernel only) it returns ``(y, s_T, ckpt)``,
    ckpt the states :func:`wkv6_fwd_ref` names."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown kernel variant {variant!r}; "
                         f"expected one of {VARIANTS}")
    if ckpt and variant != "split":
        raise ValueError("only the split kernel saves checkpoints")
    B, T, H, N = r.shape
    _check_operands(r, k, v, w, u, (("s0", s0),))
    y = torch.empty((B, T, H, N), dtype=torch.float32, device=r.device)
    sT = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    cp = torch.empty((B, H, -(-T // CKPT_STEPS), N, N), dtype=torch.float32,
                     device=r.device) if ckpt else None
    lib = _build.load(_SOURCE, _SIGNATURES)
    _build.check(_build.launch_on(
        r, lib.wkv6_fwd, r.data_ptr(), k.data_ptr(), v.data_ptr(),
        w.data_ptr(), u.data_ptr(), s0.data_ptr(), y.data_ptr(),
        sT.data_ptr(), None if cp is None else cp.data_ptr(), B, T, H, N,
        _DTYPE_CODES[r.dtype], VARIANTS.index(variant),
        _build.current_stream(r)), f"wkv6_{variant}")
    LAUNCHES["wkv6"] += 1
    if variant == "seq":
        LAUNCHES["wkv6_seq"] += 1
    return (y, sT, cp) if ckpt else (y, sT)


def _launch_bwd(r, k, v, w, u, ckpt, dy, dsT: Optional[torch.Tensor],
                want_ds0: bool, variant: str = "cluster"):
    """Launch the backward ``variant`` on CUDA tensors: ``"cluster"`` (the
    default, what :class:`WKV6Fn` runs) or ``"block"``.  Returns ``(dr,
    dk, dv, dw, du, ds0)`` as :func:`wkv6_bwd_ref` gives them from
    ``_launch(..., ckpt=True)``'s checkpoints (ds0 None unless
    ``want_ds0``; ``dsT`` None is zero).  Refuses what the kernels do not
    take before it builds anything."""
    _check_bwd_variant(variant)
    B, T, H, N = _check_bwd(r, k, v, w, u, ckpt, dy, dsT)
    named = (("ckpt", ckpt), ("dy", dy)) + \
        ((("dsT", dsT),) if dsT is not None else ())
    _check_operands(r, k, v, w, u, named)
    grads = [torch.empty_like(r) for _ in range(3)]
    dw = torch.empty_like(w)
    du_part = torch.empty((B, H, N), dtype=torch.float32, device=r.device)
    du = torch.empty_like(u)
    ds0 = torch.empty((B, H, N, N), dtype=torch.float32,
                      device=r.device) if want_ds0 else None
    lib = _build.load(_SOURCE, _SIGNATURES)
    ptr = (lambda t: None if t is None else t.data_ptr())
    _build.check(_build.launch_on(
        r, getattr(lib, _BWD_ENTRIES[variant]), r.data_ptr(), k.data_ptr(),
        v.data_ptr(), w.data_ptr(), u.data_ptr(), dy.data_ptr(), ptr(dsT),
        ckpt.data_ptr(), *(g.data_ptr() for g in grads), dw.data_ptr(),
        du_part.data_ptr(), du.data_ptr(), ptr(ds0), B, T, H, N,
        _DTYPE_CODES[r.dtype], _build.current_stream(r)),
        f"wkv6_bwd_{variant}")
    LAUNCHES["wkv6_bwd"] += 1
    if variant == "block":
        LAUNCHES["wkv6_bwd_block"] += 1
    return (*grads, dw, du, ds0)


def bwd_occupancy(N: int, dtype: torch.dtype,
                  variant: str = "cluster") -> Dict[str, int]:
    """What the current card gives the backward ``variant``'s walk at head
    size ``N`` and ``dtype``: ``blocks_per_sm`` and ``clusters`` resident at
    once (the CUDA occupancy calls; 0 clusters for ``"block"``), and the
    block's ``threads``, ``smem`` bytes, ``registers`` a thread, ``spill``
    bytes a thread and ``blocks_per_stream``.  Builds the kernels; needs a
    card."""
    _check_bwd_variant(variant)
    if dtype not in _DTYPE_CODES or N not in HEAD_SIZES:
        raise ValueError(f"no backward kernel for {dtype} at N = {N}")
    out = (ctypes.c_int * 7)()
    lib = _build.load(_SOURCE, _SIGNATURES)
    _build.check(lib.wkv6_bwd_occupancy(N, _DTYPE_CODES[dtype],
                                        BWD_VARIANTS.index(variant),
                                        ctypes.addressof(out)),
                 f"the occupancy of wkv6_bwd_{variant}")
    return dict(zip(("blocks_per_sm", "clusters", "threads", "smem",
                     "registers", "spill", "blocks_per_stream"), out))


class WKV6Fn(torch.autograd.Function):
    """The recurrence on CUDA tensors with its gradient: the split kernel
    saving its checkpoints, and the backward kernel.  Reached through
    :func:`wkv6` when a gradient is wanted; takes what :func:`_launch`
    takes and raises on the rest (no fallback)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        y, sT, ckpt = _shards.call(torch.ops.repro_torch.wkv6_ckpt,
                                   r, k, v, w, u, s0)
        ctx.save_for_backward(r, k, v, w, u, ckpt)
        ctx.set_materialize_grads(False)
        return y, sT

    @staticmethod
    def backward(ctx, dy, dsT):
        r, k, v, w, u, ckpt = ctx.saved_tensors
        dy = torch.zeros(r.shape, dtype=torch.float32, device=r.device) \
            if dy is None else dy.float().contiguous()
        if dsT is not None:
            dsT = dsT.float().contiguous()
        want_ds0 = ctx.needs_input_grad[5]
        *grads, ds0 = _shards.call(torch.ops.repro_torch.wkv6_bwd,
                                   r, k, v, w, u, ckpt, dy, dsT, want_ds0)
        return (*grads, ds0 if want_ds0 else None)


def wkv6(r, k, v, w, u, s0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence over all T steps from state ``s0``: ``(y, s_T)``,
    both float32.  CUDA tensors run the kernel (r/k/v bf16 or fp32, w, u
    and s0 fp32, contiguous, ``N`` in :data:`HEAD_SIZES`, any ``T``); CPU
    tensors the plain version.  With a gradient wanted, CUDA tensors go
    through :class:`WKV6Fn` (the backward kernel), CPU tensors through
    autograd of the plain version."""
    _check(r, k, v, w, u, s0)
    if type(r) is torch.Tensor and r.device.type == "cpu":
        return wkv6_scan_ref(r, k, v, w, u, s0)
    if r.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {r.device}")
    if type(r) is not torch.Tensor:
        register_sharding()
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (r, k, v, w, u, s0)):
        return WKV6Fn.apply(r, k, v, w, u, s0)
    return _shards.call(torch.ops.repro_torch.wkv6, r, k, v, w, u, s0)


# --- the counting form (see the module's note) -----------------------------

def wkv6_flops(r_shape, backward: bool = False) -> int:
    """The recurrence's work: 5 N^2 a step of each (b, h) stream forward
    (the bonus term, the read-out, the decay and the update of the (N, N)
    state), 14 N^2 backward (the chunk's states recomputed, then the
    walk back)."""
    B, T, H, N = r_shape
    return (14 if backward else 5) * N * N * B * H * T


def _n_ckpt(T: int) -> int:
    return -(-T // CKPT_STEPS)


def _launch_plain(r, k, v, w, u, s0, variant: str = "split",
                  ckpt: bool = False):
    """The operators' CPU kernel, with :func:`_launch`'s signature: the
    plain version (with its checkpoints under ``ckpt``)."""
    return wkv6_fwd_ref(r, k, v, w, u, s0) if ckpt else \
        wkv6_scan_ref(r, k, v, w, u, s0)


def _launch_bwd_plain(r, k, v, w, u, ckpt, dy, dsT, want_ds0):
    """The backward operator's CPU kernel, with :func:`_launch_bwd`'s
    signature: the plain version from the first checkpoint, s0."""
    *grads, ds0 = wkv6_bwd_ref(r, k, v, w, u, ckpt[:, :, 0], dy, dsT)
    return (*grads, ds0 if want_ds0 else None)


def _bwd(launch, r, k, v, w, u, ckpt, dy, dsT, want_ds0):
    # the operator returns an empty ds0 where none was asked for
    *grads, ds0 = launch(r, k, v, w, u, ckpt, dy, dsT, want_ds0)
    return (*grads, ds0 if want_ds0 else
            torch.empty(0, dtype=torch.float32, device=r.device))


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("wkv6(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, "
            "Tensor s0) -> (Tensor, Tensor)")
_LIB.define("wkv6_ckpt(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, "
            "Tensor s0) -> (Tensor, Tensor, Tensor)")
_LIB.define("wkv6_bwd(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, "
            "Tensor ckpt, Tensor dy, Tensor? dsT, bool want_ds0) -> "
            "(Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)")
# the launchers on the card, the plain versions on the CPU (a CPU tensor
# inside a DTensor reaches the operator), each by name at call time; a
# DTensor's shards dense (see ``_shards``), a plain tensor as it came
_LIB.impl("wkv6", lambda *a: _launch(*_shards.dense(a)), "CUDA")
_LIB.impl("wkv6_ckpt", lambda *a: _launch(*_shards.dense(a), ckpt=True),
          "CUDA")
_LIB.impl("wkv6_bwd", lambda *a: _bwd(_launch_bwd, *_shards.dense(a)),
          "CUDA")
_LIB.impl("wkv6", lambda *a: _launch_plain(*a), "CPU")
_LIB.impl("wkv6_ckpt", lambda *a: _launch_plain(*a, ckpt=True), "CPU")
_LIB.impl("wkv6_bwd", lambda *a: _bwd(_launch_bwd_plain, *a), "CPU")


def _state(r):
    B, T, H, N = r.shape
    return r.new_empty((B, H, N, N), dtype=torch.float32)


@torch.library.register_fake("repro_torch::wkv6", lib=_LIB)
def _fake_fwd(r, k, v, w, u, s0):
    return r.new_empty(r.shape, dtype=torch.float32), _state(r)


@torch.library.register_fake("repro_torch::wkv6_ckpt", lib=_LIB)
def _fake_ckpt(r, k, v, w, u, s0):
    B, T, H, N = r.shape
    return (r.new_empty(r.shape, dtype=torch.float32), _state(r),
            r.new_empty((B, H, _n_ckpt(T), N, N), dtype=torch.float32))


@torch.library.register_fake("repro_torch::wkv6_bwd", lib=_LIB)
def _fake_bwd(r, k, v, w, u, ckpt, dy, dsT, want_ds0):
    return (r.new_empty(r.shape), r.new_empty(r.shape), r.new_empty(r.shape),
            w.new_empty(w.shape), u.new_empty(u.shape),
            _state(r) if want_ds0 else r.new_empty(0, dtype=torch.float32))


@register_flop_formula([torch.ops.repro_torch.wkv6,
                        torch.ops.repro_torch.wkv6_ckpt])
def _fwd_flop_formula(r_shape, *args, **kwargs) -> int:
    return wkv6_flops(r_shape)


@register_flop_formula(torch.ops.repro_torch.wkv6_bwd)
def _bwd_flop_formula(r_shape, *args, **kwargs) -> int:
    return wkv6_flops(r_shape, backward=True)


@functools.cache
def register_sharding() -> None:
    """Give DTensor the operators' rules (once a process): every tensor
    replicated, or split over the batch (``u`` replicated; its gradient a
    partial sum), or over the heads."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding as reg
    R, S = Replicate(), Shard

    def forward(n_out):
        # outputs y, s_T[, ckpt]; inputs r, k, v, w, u, s0
        return [([R] * n_out, [R] * 6),
                ([S(0)] * n_out, [S(0)] * 4 + [R, S(0)]),
                ([S(2), S(1), S(1)][:n_out], [S(2)] * 4 + [S(0), S(1)])]

    def backward(r, k, v, w, u, ckpt, dy, dsT, want_ds0):
        # outputs dr, dk, dv, dw, du, ds0; inputs r, k, v, w, u, ckpt, dy,
        # dsT, want_ds0
        opt = (lambda p: p if dsT is not None else None)
        ds0 = (lambda p: p if want_ds0 else R)
        return [([R] * 6, [R] * 7 + [opt(R), None]),
                ([S(0)] * 4 + [Partial(), ds0(S(0))],
                 [S(0)] * 4 + [R, S(0), S(0), opt(S(0)), None]),
                ([S(2)] * 4 + [S(0), ds0(S(1))],
                 [S(2)] * 4 + [S(0), S(1), S(2), opt(S(1)), None])]

    reg(torch.ops.repro_torch.wkv6.default)(lambda *a: forward(2))
    reg(torch.ops.repro_torch.wkv6_ckpt.default)(lambda *a: forward(3))
    reg(torch.ops.repro_torch.wkv6_bwd.default)(backward)
