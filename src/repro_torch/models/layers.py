"""Core neural layers of the dense family: norms, embedding and head, RoPE,
attention, MLP (counterpart of ``repro/models/layers.py``).

Functions over explicit parameter dicts, as in the reference, with the
reference's layouts (``wq`` (d, H, D), ``wo`` (H, D, d), ...).  Weights
arrive in the dtype their uses read (:mod:`repro_torch.models.types`), so
the reference's per-use casts to the compute dtype have no counterpart.  Causal
prefill attention goes to the hand-written flash-attention kernel through
:func:`repro_torch.kernels.ops.flash_attention`; single-token decode
attention (:func:`sdpa_decode`) stays plain PyTorch, as it is an XLA op
and not a Pallas kernel in the reference.

Not ported yet: MoE (``moe_apply``) and the ``full``, ``cross`` and
``cross_decode`` attention modes (ROADMAP.md §A).  The reference's
``sharding.ctx.constrain`` calls have no counterpart on one card and are
dropped.  Caches are written in place (the reference returns new
arrays); the functions still return the cache they wrote.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.types import ModelConfig, NotPortedError, ParamSpec

Params = Mapping[str, torch.Tensor]

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def norm_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    specs = {"scale": ParamSpec((d,), (None,), init="ones",
                                dtype=torch.float32)}
    if cfg.norm == "layernorm":
        specs["bias"] = ParamSpec((d,), (None,), init="zeros",
                                  dtype=torch.float32)
    return specs


def norm_apply(p: Params, x: torch.Tensor, kind: str = "rmsnorm",
               eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    if kind == "layernorm":
        x = x - x.mean(-1, keepdim=True)
    var = (x * x).mean(-1, keepdim=True)
    x = x * torch.rsqrt(var + eps) * p["scale"].float()
    if kind == "layernorm":
        x = x + p["bias"].float()
    return x.to(dtype)


def rms_norm_1d(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """Headwise RMS norm (qk-norm), f32 internals."""
    dtype = x.dtype
    x = x.float()
    var = (x * x).mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dtype)


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def embed_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    specs = {"embedding": ParamSpec((cfg.vocab_size, cfg.d_model),
                                    ("vocab", "embed"), scale=0.02)}
    if not cfg.tie_embeddings:
        specs["head"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                  ("embed", "vocab"))
    return specs


def embed_apply(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, p["embedding"])


def head_apply(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return x @ (p["embedding"].t() if cfg.tie_embeddings else p["head"])


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float,
         fraction: float = 1.0) -> torch.Tensor:
    """Rotary embedding on the last dim.  x: (B, T, H, D), positions:
    (B, T)."""
    d = x.shape[-1]
    rot = int(d * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    half = rot // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[:, :, None].float() * freqs          # (B, T, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                    dim=-1).to(x.dtype)
    return torch.cat([out, x_pass], dim=-1) if rot < d else out


# ---------------------------------------------------------------------------
# scaled-dot-product attention
# ---------------------------------------------------------------------------

def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
         window: Optional[int] = None) -> torch.Tensor:
    """Attention over whole sequences.  q: (B,Tq,H,D); k,v: (B,Tk,G,D)
    with H = G*R.  The reference's chunked online softmax in jnp; here
    the flash-attention kernel (its plain version on the CPU)."""
    return ops.flash_attention(q, k, v, causal=causal, window=window)


def sdpa_decode(q: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Single-token attention over a cache.

    q: (B,1,H,D); caches: (B,S,G,D); valid: (S,) bool mask of live
    entries.  Scores and softmax in float32, as the reference."""
    B, _, H, D = q.shape
    S, G = k_cache.shape[1], k_cache.shape[2]
    R = H // G
    qg = (q * (1.0 / math.sqrt(D))).reshape(B, 1, G, R, D)
    s = torch.einsum("btgrd,bsgd->bgrts", qg.float(), k_cache.float())
    s = torch.where(valid[None, None, None, None, :], s,
                    torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrts,bsgd->btgrd", p.to(v_cache.dtype), v_cache)
    return o.reshape(B, 1, H, D)


def _cache_write_prefill(cache: torch.Tensor, k: torch.Tensor
                         ) -> torch.Tensor:
    """Write a T-token prefill into a cache of S slots, in place.

    S >= T: plain write at offset 0.  S < T (ring/window cache): keep the
    last S tokens at their ring slots (slot = position % S)."""
    S, T = cache.shape[1], k.shape[1]
    k = k.to(cache.dtype)
    if T <= S:
        cache[:, :T] = k
        return cache
    slots = torch.arange(T - S, T, device=cache.device) % S
    cache[:, slots] = k[:, T - S:]
    return cache


# ---------------------------------------------------------------------------
# attention layer (projections + rope + qk-norm + cache plumbing)
# ---------------------------------------------------------------------------

def attn_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, H, G, D = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    specs = {
        "wq": ParamSpec((d, H, D), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, G, D), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, G, D), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((H, D, d), ("heads", "head_dim", "embed"),
                        scale=1.0 / math.sqrt(H * D)),
    }
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((D,), (None,), init="ones",
                                    dtype=torch.float32)
        specs["k_norm"] = ParamSpec((D,), (None,), init="ones",
                                    dtype=torch.float32)
    return specs


def _proj_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("btd,dhk->bthk")`` as one matmul over the flattened heads."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def _project_q(p, cfg, x, positions):
    q = _proj_heads(x, p["wq"])
    if cfg.qk_norm:
        q = rms_norm_1d(q, p["q_norm"])
    return rope(q, positions, theta=cfg.rope_theta,
                fraction=cfg.rope_fraction)


def _project_kv(p, cfg, x, positions):
    k = _proj_heads(x, p["wk"])
    v = _proj_heads(x, p["wv"])
    if cfg.qk_norm:
        k = rms_norm_1d(k, p["k_norm"])
    return rope(k, positions, theta=cfg.rope_theta,
                fraction=cfg.rope_fraction), v


def attn_apply(p: Params, cfg: ModelConfig, x: torch.Tensor, *, mode: str,
               positions: Optional[torch.Tensor] = None,
               window: Optional[int] = None,
               cache: Optional[Dict[str, torch.Tensor]] = None,
               pos: Optional[int] = None,
               ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Attention layer in mode ``"causal"`` (train/prefill; with a cache,
    the prefill writes it) or ``"decode"`` (one token against the cache,
    written at index ``pos``).  Returns (output, cache)."""
    if mode == "causal":
        q = _project_q(p, cfg, x, positions)
        k, v = _project_kv(p, cfg, x, positions)
        o = sdpa(q.contiguous(), k.contiguous(), v.contiguous(), causal=True,
                 window=window)
        new_cache = None
        if cache is not None:
            new_cache = {"k": _cache_write_prefill(cache["k"], k),
                         "v": _cache_write_prefill(cache["v"], v)}
    elif mode == "decode":
        q = _project_q(p, cfg, x, positions)
        k, v = _project_kv(p, cfg, x, positions)
        # one token at slot pos % S (window caches are rings of S slots)
        k_cache, v_cache = cache["k"], cache["v"]
        S = k_cache.shape[1]
        write_idx = pos % S
        k_cache[:, write_idx] = k[:, 0].to(k_cache.dtype)
        v_cache[:, write_idx] = v[:, 0].to(v_cache.dtype)
        kpos = torch.arange(S, device=x.device)
        # ring: slot s last written at pos - ((pos - s) mod S); valid if
        # >= 0.  linear (S covers the sequence): valid iff s <= pos.
        valid = (pos - (pos - kpos) % S) >= 0
        if window is not None:
            valid &= (pos - kpos) % S < window
        o = sdpa_decode(q, k_cache, v_cache, valid)
        new_cache = {"k": k_cache, "v": v_cache}
    elif mode in ("full", "cross", "cross_decode"):
        raise NotPortedError(f"attention mode {mode!r} is not ported yet")
    else:
        raise ValueError(mode)
    H, D, d = p["wo"].shape
    y = o.reshape(*o.shape[:2], H * D) @ p["wo"].reshape(H * D, d)
    return y, new_cache


def kv_cache_shape(cfg: ModelConfig, batch: int, max_len: int
                   ) -> Tuple[Tuple[int, ...], Tuple[Optional[str], ...]]:
    """Shape + logical axes of one direction (k or v) of a layer cache."""
    eff = min(max_len, cfg.window) if cfg.window else max_len
    return ((batch, eff, cfg.num_kv_heads, cfg.head_dim),
            ("batch", None, "kv_heads", "head_dim"))


# ---------------------------------------------------------------------------
# MLP (gated / classic)
# ---------------------------------------------------------------------------

def mlp_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    specs = {
        "w_up": ParamSpec((d, f), ("embed", "mlp")),
        "w_down": ParamSpec((f, d), ("mlp", "embed")),
    }
    if cfg.gated_mlp:
        specs["w_gate"] = ParamSpec((d, f), ("embed", "mlp"))
    return specs


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if kind == "silu" else F.gelu(x, approximate="tanh")


def mlp_apply(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    h = x @ p["w_up"]
    if "w_gate" in p:
        h = _act(x @ p["w_gate"], cfg.act) * h
    else:
        h = _act(h, cfg.act)
    return h @ p["w_down"]
