"""RWKV-6 ("Finch") sequence mixing (counterpart of the RWKV-6 half of
``repro/models/recurrent.py``).

The time mix's WKV recurrence goes to the hand-written CUDA kernel through
:func:`repro_torch.kernels.ops.wkv6` for every T, prefill and decode alike
(the reference uses ``wkv6_scan_chunked`` for T > 1 and ``wkv6_scan_ref``
for T = 1, both the same function).  :func:`wkv6_scan_chunked` stays here
as the plain chunked form the tests hold the kernel's plain version to.

Not ported yet: the RG-LRU block of RecurrentGemma (ROADMAP.md §A).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.rwkv6_scan import wkv6_scan_ref
from repro_torch.models.types import ModelConfig, ParamSpec

__all__ = ["rwkv_channel_mix_apply", "rwkv_channel_mix_specs",
           "rwkv_state_shapes", "rwkv_time_mix_apply", "rwkv_time_mix_specs",
           "wkv6_scan_chunked", "wkv6_scan_ref"]

#: the reference's default chunk (``models.settings.Settings.wkv_chunk``)
WKV_CHUNK = 128

Params = Dict[str, torch.Tensor]


def rwkv_time_mix_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    N = cfg.rwkv_head_dim
    H = d // N
    lora = 32
    f32 = torch.float32
    return {
        # data-dependent token-shift (ddlerp) parameters
        "maa_x": ParamSpec((d,), (None,), init="zeros"),
        "maa_wkvrg": ParamSpec((5, d), (None, None), init="zeros"),
        "tm_w1": ParamSpec((d, 5 * lora), ("embed", None), scale=0.02),
        "tm_w2": ParamSpec((5, lora, d), (None, None, "embed"), scale=0.02),
        # data-dependent decay (read in float32)
        "decay_base": ParamSpec((d,), (None,), init="uniform", dtype=f32),
        "td_w1": ParamSpec((d, 64), ("embed", None), scale=0.02),
        "td_w2": ParamSpec((64, d), (None, "embed"), scale=0.02),
        # per-(head,channel) bonus for the current token (read in float32)
        "u": ParamSpec((H, N), ("heads", None), scale=0.5, dtype=f32),
        "wr": ParamSpec((d, d), ("embed", "heads_flat")),
        "wk": ParamSpec((d, d), ("embed", "heads_flat")),
        "wv": ParamSpec((d, d), ("embed", "heads_flat")),
        "wg": ParamSpec((d, d), ("embed", "heads_flat")),
        "wo": ParamSpec((d, d), ("heads_flat", "embed")),
        "ln_scale": ParamSpec((d,), (None,), init="ones", dtype=f32),
        "ln_bias": ParamSpec((d,), (None,), init="zeros", dtype=f32),
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """x_{t-1} per position; ``prev`` is the carried last token
    (decode)."""
    B, T, d = x.shape
    if prev is None:
        prev = torch.zeros((B, d), dtype=x.dtype, device=x.device)
    return torch.cat([prev[:, None, :].to(x.dtype), x[:, :-1]], dim=1)


def _ddlerp(p: Params, x: torch.Tensor, x_prev: torch.Tensor
            ) -> torch.Tensor:
    """RWKV-6 data-dependent interpolation producing 5 mixed inputs."""
    diff = x_prev - x
    xx = x + diff * p["maa_x"]
    B, T, _ = x.shape
    lora = torch.tanh((xx @ p["tm_w1"]).reshape(B, T, 5, -1))
    mix = torch.einsum("btfk,fkd->btfd", lora, p["tm_w2"])
    mix = mix + p["maa_wkvrg"][None, None]
    return x[:, :, None, :] + diff[:, :, None, :] * mix   # (B,T,5,d)


def wkv6_scan_chunked(r, k, v, w, u, s0, *, chunk: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's chunked form: the exact recurrence chunk by chunk,
    carrying the state (a ragged T runs as one chunk, as there)."""
    T = r.shape[1]
    c = min(chunk if chunk is not None else WKV_CHUNK, T)
    if T % c:
        c = T
    s = s0.float()
    ys = []
    for t0 in range(0, T, c):
        sl = slice(t0, t0 + c)
        y, s = wkv6_scan_ref(r[:, sl], k[:, sl], v[:, sl], w[:, sl], u, s)
        ys.append(y)
    return torch.cat(ys, dim=1), s


def rwkv_time_mix_apply(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
                        state: Optional[Dict[str, torch.Tensor]] = None,
                        ) -> Tuple[torch.Tensor,
                                   Optional[Dict[str, torch.Tensor]]]:
    """RWKV-6 time mix.  state = {"shift": (B,d), "wkv": (B,H,N,N)}."""
    B, T, d = x.shape
    N = cfg.rwkv_head_dim
    H = d // N
    prev = state["shift"] if state is not None else None
    mixed = _ddlerp(p, x, _token_shift(x, prev))         # (B,T,5,d)
    xw, xk, xv, xr, xg = (mixed[:, :, i] for i in range(5))

    r = xr @ p["wr"]
    k = xk @ p["wk"]
    v = xv @ p["wv"]
    g = xg @ p["wg"]

    dd = torch.tanh(xw @ p["td_w1"]) @ p["td_w2"]
    log_w = -torch.exp((p["decay_base"].float() - 4.0) + dd.float())
    w = torch.exp(log_w)                                  # decay in (0,1)

    shp = (B, T, H, N)
    s0 = state["wkv"] if state is not None else torch.zeros(
        (B, H, N, N), dtype=torch.float32, device=x.device)
    y, sT = ops.wkv6(r.reshape(shp), k.reshape(shp), v.reshape(shp),
                     w.reshape(shp), p["u"], s0)

    # per-head group norm, then output gate + projection
    y = y.reshape(B, T, H, N).float()
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) ** 2).mean(-1, keepdim=True)
    y = (y - mu) * torch.rsqrt(var + 64e-5)
    y = y.reshape(B, T, d) * p["ln_scale"].float() + p["ln_bias"].float()
    y = y.to(x.dtype) * F.silu(g)
    y = y @ p["wo"]

    new_state = None
    if state is not None:
        new_state = {"shift": x[:, -1], "wkv": sT}
    return y, new_state


def rwkv_channel_mix_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": ParamSpec((d,), (None,), init="zeros"),
        "mu_r": ParamSpec((d,), (None,), init="zeros"),
        "wk": ParamSpec((d, f), ("embed", "mlp")),
        "wv": ParamSpec((f, d), ("mlp", "embed")),
        "wr": ParamSpec((d, d), ("embed", None)),
    }


def rwkv_channel_mix_apply(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
                           state: Optional[Dict[str, torch.Tensor]] = None
                           ) -> Tuple[torch.Tensor, Optional[Dict]]:
    prev = state["shift"] if state is not None else None
    diff = _token_shift(x, prev) - x
    xk = x + diff * p["mu_k"]
    xr = x + diff * p["mu_r"]
    kk = torch.square(torch.relu(xk @ p["wk"]))
    kv = kk @ p["wv"]
    rr = torch.sigmoid(xr @ p["wr"])
    new_state = {"shift": x[:, -1]} if state is not None else None
    return rr * kv, new_state


def rwkv_state_shapes(cfg: ModelConfig, batch: int) -> Dict[str, Tuple]:
    """Shape, logical axes and dtype (None: the compute dtype) of each
    piece of an RWKV-6 layer's decode state."""
    d = cfg.d_model
    N = cfg.rwkv_head_dim
    H = d // N
    return {
        "tm_shift": ((batch, d), ("batch", None), None),
        "wkv": ((batch, H, N, N), ("batch", "heads", None, None),
                torch.float32),
        "cm_shift": ((batch, d), ("batch", None), None),
    }
