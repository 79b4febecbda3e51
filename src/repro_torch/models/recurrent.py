"""Recurrent sequence mixing: the RG-LRU block of RecurrentGemma and
RWKV-6 ("Finch") (counterpart of ``repro/models/recurrent.py``).

RG-LRU.  The reference runs the whole block as XLA code, with no Pallas
kernel, so here it is plain PyTorch on whatever device its input lies.
Its gate products ``x @ w_a`` and ``x @ w_x`` are float32, as the
reference takes them (the gate weights and biases, the conv taps and
``lam`` are stored in float32, the dtype their uses read; a float32
product on the card is full float32, TF32 is off).  The linear recurrence
``h_t = a_t h_{t-1} + sqrt(1 - a_t^2) g_t`` runs as a log-depth scan over
T with the reference's ``combine`` (:func:`rglru_scan`): ceil(log2 T)
rounds of a few elementwise ops, and no Python step per token.

RWKV-6.  The time mix's WKV recurrence goes to the hand-written CUDA
kernel through :func:`repro_torch.kernels.ops.wkv6` for every T, prefill
and decode alike (the reference uses ``wkv6_scan_chunked`` for T > 1 and
``wkv6_scan_ref`` for T = 1, both the same function), and in training
its gradient to the WKV6 backward kernel (the reference differentiates
``wkv6_scan_chunked`` with XLA).
:func:`wkv6_scan_chunked` stays here as the plain chunked form the tests
hold the kernel's plain version to.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.rwkv6_scan import wkv6_scan_ref
from repro_torch.models.layers import _act
from repro_torch.models.types import ModelConfig, ParamSpec
from repro_torch.sharding.ctx import constrain, constrain_merged

__all__ = ["RGLRU_C", "rglru_block_apply", "rglru_block_specs", "rglru_scan",
           "rglru_state_shapes", "rwkv_channel_mix_apply",
           "rwkv_channel_mix_specs", "rwkv_state_shapes",
           "rwkv_time_mix_apply", "rwkv_time_mix_specs", "wkv6_scan_chunked",
           "wkv6_scan_ref"]

#: the reference's default chunk (``models.settings.Settings.wkv_chunk``)
WKV_CHUNK = 128

Params = Dict[str, torch.Tensor]

# ---------------------------------------------------------------------------
# RG-LRU (Griffin / RecurrentGemma recurrent block)
# ---------------------------------------------------------------------------

RGLRU_C = 8.0


def rglru_block_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, w = cfg.d_model, cfg.lru_width
    f32 = torch.float32
    return {
        # two input branches: gate (gelu) and recurrent
        "w_in_gate": ParamSpec((d, w), ("embed", "mlp")),
        "w_in_rec": ParamSpec((d, w), ("embed", "mlp")),
        # temporal conv over the recurrent branch (depthwise; read in
        # float32)
        "conv_w": ParamSpec((cfg.conv_width, w), (None, "mlp"), scale=0.1,
                            dtype=f32),
        "conv_b": ParamSpec((w,), ("mlp",), init="zeros", dtype=f32),
        # RG-LRU gates (read in float32)
        "w_a": ParamSpec((w, w), ("mlp", None), dtype=f32),
        "b_a": ParamSpec((w,), (None,), init="zeros", dtype=f32),
        "w_x": ParamSpec((w, w), ("mlp", None), dtype=f32),
        "b_x": ParamSpec((w,), (None,), init="zeros", dtype=f32),
        "lam": ParamSpec((w,), (None,), init="uniform", dtype=f32),
        "w_out": ParamSpec((w, d), ("mlp", "embed")),
    }


def _rglru_gates(p: Params, xc: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """log a_t (per channel) and the gated input, both float32."""
    x32 = xc.float()
    r = torch.sigmoid(x32 @ p["w_a"] + p["b_a"])
    i = torch.sigmoid(x32 @ p["w_x"] + p["b_x"])
    log_a = -RGLRU_C * F.softplus(p["lam"]) * r
    return log_a, i * x32


def _depthwise_conv(p: Params, x: torch.Tensor,
                    state: Optional[torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal depthwise temporal conv of width W over x (B, T, w).

    ``state``: (B, W-1, w) past inputs (decode), or None (zero history).
    Returns (y, new state: the last W-1 inputs)."""
    W = p["conv_w"].shape[0]
    B, T, w = x.shape
    if state is None:
        state = x.new_zeros((B, W - 1, w))
    xp = torch.cat([state.to(x.dtype), x], dim=1)      # (B, T+W-1, w)
    y = torch.zeros((B, T, w), dtype=torch.float32, device=x.device)
    for i in range(W):
        y = y + xp[:, i:i + T].float() * p["conv_w"][i]
    y = (y + p["conv_b"]).to(x.dtype)
    # a copy: a view would keep the whole (B, T+W-1, w) input alive
    return y, xp[:, T:].clone()


def rglru_scan(log_a: torch.Tensor, gated: torch.Tensor,
               h0: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t h_{t-1} + sqrt(1 - a_t^2) gated_t over T.

    log_a, gated: (B, T, w) float32; h0: (B, w) initial state or None,
    folded into the first step as the reference folds it.  Returns (h (B,
    T, w), final state (B, w)).

    The reference's ``lax.associative_scan`` with its ``combine((a1, b1),
    (a2, b2)) = (a1 a2, a2 b1 + b2)``, as a Hillis-Steele scan: in the
    round of stride s each step t >= s takes in the prefix ending at
    t - s, so ceil(log2 T) rounds leave every step's whole prefix.  Each
    round's right-hand side is computed before it is written, so the
    in-place updates read the last round's values.  No cumulative product
    or sum in log space: ``log_a`` reaches -8 softplus(lam) a step, and a
    running sum of it underflows.

    When a gradient is wanted the rounds write new tensors instead: an
    in-place round overwrites what the last round's products saved for
    the backward, which plain autograd refuses and a non-reentrant
    checkpoint's recompute would silently read back overwritten.  Serving
    keeps the in-place rounds: at a prefill wave's shape they are
    measurably faster (``chip_smoke.py``'s ``rec_shares``, PERF.md §5)."""
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * gated
    if h0 is not None:
        b[:, 0] += a[:, 0] * h0
    T = a.shape[1]
    grad = torch.is_grad_enabled() and (log_a.requires_grad
                                        or gated.requires_grad)
    s = 1
    while s < T:
        if grad:
            b = torch.cat([b[:, :s], b[:, s:] + a[:, s:] * b[:, :-s]], 1)
        else:
            b[:, s:] += a[:, s:] * b[:, :-s]
        if 2 * s < T:                   # the last round needs no a
            if grad:
                a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], 1)
            else:
                a[:, s:] = a[:, s:] * a[:, :-s]
        s *= 2
    # a copy: a view would keep the whole (B, T, w) scan alive in the state
    return b, b[:, -1].clone()


def rglru_block_apply(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
                      state: Optional[Dict[str, torch.Tensor]] = None
                      ) -> Tuple[torch.Tensor,
                                 Optional[Dict[str, torch.Tensor]]]:
    """The RecurrentGemma recurrent block.  x: (B, T, d).

    state = {"h": (B, w) float32, "conv": (B, conv_width-1, w)} for
    prefill and decode, else None."""
    gate = constrain(_act(x @ p["w_in_gate"], "gelu"),
                     ("batch", "seq", "mlp"))
    rec = constrain(x @ p["w_in_rec"], ("batch", "seq", "mlp"))
    rec, new_conv = _depthwise_conv(
        p, rec, state["conv"] if state is not None else None)
    log_a, gated = _rglru_gates(p, rec)
    h, h_last = rglru_scan(log_a, gated,
                           state["h"] if state is not None else None)
    y = (h.to(x.dtype) * gate) @ p["w_out"]
    new_state = {"h": h_last, "conv": new_conv} if state is not None \
        else None
    return y, new_state


def rglru_state_shapes(cfg: ModelConfig, batch: int) -> Dict[str, Tuple]:
    """Shape, logical axes and dtype (None: the compute dtype) of each
    piece of an RG-LRU layer's decode state."""
    w = cfg.lru_width
    return {
        "h": ((batch, w), ("batch", "mlp"), torch.float32),
        "conv": ((batch, cfg.conv_width - 1, w), ("batch", None, "mlp"),
                 None),
    }


# ---------------------------------------------------------------------------
# RWKV-6 ("Finch"): data-dependent decay linear attention
# ---------------------------------------------------------------------------


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
    lora = constrain_merged(xx @ p["tm_w1"], ("batch", "seq", None, None),
                            (5, p["tm_w1"].shape[1] // 5))
    lora = torch.tanh(lora.reshape(B, T, 5, -1))
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
    r, k, v, w = (constrain_merged(t, ("batch", "seq", "heads_flat", None),
                                   (H, N)).reshape(shp)
                  for t in (r, k, v, w))
    y, sT = ops.wkv6(r, k, v, w, p["u"], s0)

    # per-head group norm, then output gate + projection
    y = y.reshape(B, T, H, N).float()
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) ** 2).mean(-1, keepdim=True)
    y = (y - mu) * torch.rsqrt(var + 64e-5)
    # held whole over the model axis, as the heads were: its gradient
    # splits back into (H, N), which DTensor takes only unsplit there
    y = constrain_merged(y.reshape(B, T, d), ("batch", "seq", "heads_flat",
                                              None), (H, N))
    y = y * p["ln_scale"].float() + p["ln_bias"].float()
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
    kk = torch.square(torch.relu(constrain(xk @ p["wk"],
                                           ("batch", "seq", "mlp"))))
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
