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
tensors on the CPU; for CUDA tensors it launches the kernel or raises,
and never falls back.  The kernel has no backward yet: on CUDA tensors
that require grad (with grad mode on) :func:`wkv6` raises
:class:`~repro_torch.models.NotPortedError`, so RWKV-6 trains on the CPU
only (autograd through the plain version there).

Two kernels, both in ``csrc/wkv6_scan.cu``: ``wkv6_split`` (variant
``"split"``), which :func:`wkv6` launches, and the sequential
``wkv6_seq`` it replaced (variant ``"seq"``), kept as the yardstick and
reached only through ``_launch(..., variant="seq")``.  :data:`LAUNCHES`
counts kernel launches and nothing else: ``wkv6`` every launch of either,
``wkv6_seq`` the sequential kernel's.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

__all__ = ["HEAD_SIZES", "LAUNCHES", "VARIANTS", "reset_launches", "wkv6",
           "wkv6_scan_ref"]

#: kernel launches since the last :func:`reset_launches`: ``wkv6`` counts
#: both variants, ``wkv6_seq`` the sequential one alone
LAUNCHES: Dict[str, int] = {"wkv6": 0, "wkv6_seq": 0}
#: the kernels ``_launch`` takes by name: the column- and row-split kernel
#: and the sequential one it replaced
VARIANTS = ("split", "seq")
#: the head sizes the kernel is built for: rwkv6-3b's 64, the reduced
#: configs' 16 and the reference kernel tests' 32
HEAD_SIZES = (16, 32, 64)

_SOURCE = "wkv6_scan"
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"wkv6_fwd": [_P] * 8 + [_I] * 6 + [_P]}
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


def _check(r, k, v, w, u, s0) -> Tuple[int, int, int, int]:
    if not isinstance(r, torch.Tensor) or r.dim() != 4:
        raise ValueError("r must be a (B, T, H, N) tensor")
    B, T, H, N = r.shape
    if T < 1:
        raise ValueError("the sequence must hold at least one step")
    for name, t, shape in (("k", k, (B, T, H, N)), ("v", v, (B, T, H, N)),
                           ("w", w, (B, T, H, N)), ("u", u, (H, N)),
                           ("s0", s0, (B, H, N, N))):
        if not isinstance(t, torch.Tensor) or tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(getattr(t, 'shape', ()))}")
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, expected {r.device}")
    return B, T, H, N


def _launch(r, k, v, w, u, s0, variant: str = "split"):
    """Launch ``variant`` on CUDA tensors: ``"split"`` (the default, what
    :func:`wkv6` runs) or ``"seq"``.  y and s_T are allocated apart: the
    state a prefill hands on would otherwise keep the prefill's y alive."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown kernel variant {variant!r}; "
                         f"expected one of {VARIANTS}")
    B, T, H, N = r.shape
    if r.dtype not in _DTYPE_CODES or k.dtype != r.dtype or \
            v.dtype != r.dtype:
        raise TypeError(f"r, k and v must share float32 or bfloat16, got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("w", w), ("u", u), ("s0", s0)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if N not in HEAD_SIZES:
        raise ValueError(f"the kernel takes head sizes {HEAD_SIZES}, got {N}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("s0", s0)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             f"copies 16 bytes at a time)")
    y = torch.empty((B, T, H, N), dtype=torch.float32, device=r.device)
    sT = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    lib = _build.load(_SOURCE, _SIGNATURES)
    _build.check(_build.launch_on(
        r, lib.wkv6_fwd, r.data_ptr(), k.data_ptr(), v.data_ptr(),
        w.data_ptr(), u.data_ptr(), s0.data_ptr(), y.data_ptr(),
        sT.data_ptr(), B, T, H, N, _DTYPE_CODES[r.dtype],
        VARIANTS.index(variant), _build.current_stream(r)),
        f"wkv6_{variant}")
    LAUNCHES["wkv6"] += 1
    if variant == "seq":
        LAUNCHES["wkv6_seq"] += 1
    return y, sT


def wkv6(r, k, v, w, u, s0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence over all T steps from state ``s0``: ``(y, s_T)``,
    both float32.  CUDA tensors run the kernel (r/k/v bf16 or fp32, w, u
    and s0 fp32, contiguous, ``N`` in :data:`HEAD_SIZES`, any ``T``); CPU
    tensors the plain version."""
    _check(r, k, v, w, u, s0)
    if r.device.type == "cpu":
        return wkv6_scan_ref(r, k, v, w, u, s0)
    if r.device.type != "cuda":
        raise ValueError(f"unsupported device {r.device}")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (r, k, v, w, u, s0)):
        from repro_torch.models.types import NotPortedError
        raise NotPortedError("the WKV6 kernel has no backward yet: RWKV-6 "
                             "trains on the CPU only (ROADMAP.md §A)")
    return _launch(r, k, v, w, u, s0)
