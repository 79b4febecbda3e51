"""Core neural layers of the dense and MoE families: norms, embedding and
head, RoPE, attention, MLP, the sort-based MoE dispatch (counterpart of
``repro/models/layers.py``).

Functions over explicit parameter dicts, as in the reference, with the
reference's layouts (``wq`` (d, H, D), ``wo`` (H, D, d), ...).  Weights
arrive in the dtype their uses read (:mod:`repro_torch.models.types`), so
the reference's per-use casts to the compute dtype have no counterpart.
Every attention mode that calls the reference's ``sdpa`` goes to the
hand-written flash-attention kernel through
:func:`repro_torch.kernels.ops.flash_attention`: causal prefill, the
encoder's bidirectional ``full``, the decoder's ``cross`` over the
encoder output and its one-token ``cross_decode`` over the cross cache.
Single-token self-attention decode (:func:`sdpa_decode`) stays plain
PyTorch, as it is an XLA op and not a Pallas kernel in the reference.

The MoE layer (:func:`moe_apply`) computes the reference's dispatch step
by step in plain PyTorch, on whatever device its input lies: the
reference runs it as XLA code, not as a Pallas kernel, and its expert
products are batched matrix products.  Activations carry the
reference's logical-axis annotations
(:func:`repro_torch.sharding.ctx.constrain`), which return their input
outside a sharding context (one card) and place DTensors inside one (the
dry run).  Caches are written in place (the reference returns new
arrays); the functions still return the cache they wrote.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import ops
from repro_torch.models.types import ModelConfig, ParamSpec
from repro_torch.sharding.ctx import constrain, constrain_merged, placed

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
    """The token embeddings; a table split over the vocabulary (a
    DTensor) is looked up shard by shard (:func:`vocab_lookup`)."""
    table = p["embedding"]
    x = vocab_lookup(table, tokens) if vocab_dims(table, 0) \
        else F.embedding(tokens, table)
    return constrain(x, ("batch", "seq", None))


# --- vocabulary-parallel lookups (a DTensor split over the vocabulary) ------
#
# DTensor's own rules for an embedding or a gather over a split vocabulary
# keep a mask beside a partial sum, which breaks once the ids are split
# over another mesh axis (the batch over data): the mask keeps the ids'
# local shape and the output is redistributed at another.  These two do
# the Megatron lookups on the local shards instead: each rank reads the
# ids that fall in its slice of the vocabulary, zeros the rest, and the
# result is a partial sum over the vocabulary's mesh axes.

def vocab_dims(t: torch.Tensor, dim: int) -> List[int]:
    """The mesh dimensions over which DTensor ``t`` splits ``dim``
    (none for a plain tensor)."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(t, DTensor):
        return []
    dim = dim % t.dim()
    return [i for i, p in enumerate(t.placements)
            if isinstance(p, Shard) and p.dim == dim]


def _vocab_offset(mesh, dims: List[int], n_local: int) -> int:
    """The first vocabulary id of this rank's slice (the dimension cut in
    mesh order over ``dims``, the first the major)."""
    coord, idx = mesh.get_coordinate(), 0
    for i in dims:
        idx = idx * mesh.size(i) + coord[i]
    return idx * n_local


def _placed_ids(ids: torch.Tensor, mesh, placements) -> torch.Tensor:
    """Integer ids as a DTensor at ``placements`` (plain ids are the same
    on every rank)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    return ids.redistribute(mesh, placements)


def vocab_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``F.embedding(ids, table)`` for a DTensor ``table`` (V, d) split
    over the vocabulary: any other split (an FSDP split of d) gathered
    first, the ids' rows kept as the ids are split, and the result a
    partial sum over the vocabulary's mesh axes."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = table.device_mesh
    vdims = vocab_dims(table, 0)
    table = placed(table, [Shard(0) if i in vdims else Replicate()
                           for i in range(mesh.ndim)], weight=True)
    ids = _placed_ids(ids, mesh, [Replicate() if i in vdims else p
                                  for i, p in enumerate(
                                      getattr(ids, "placements", [])
                                      or [Replicate()] * mesh.ndim)])
    # the table's gradient: each rank's rows exact, a partial sum over the
    # axes that split the ids
    grad_pl = [Shard(0) if i in vdims else
               Partial() if isinstance(p, Shard) else Replicate()
               for i, p in enumerate(ids.placements)]
    local = table.to_local(grad_placements=grad_pl)
    n = local.shape[0]
    rel = ids.to_local().long() - _vocab_offset(mesh, vdims, n)
    hit = (rel >= 0) & (rel < n)
    out = F.embedding(rel.clamp(0, n - 1), local) * \
        hit[..., None].to(local.dtype)
    shape = tuple(ids.shape) + (local.shape[1],)
    return DTensor.from_local(
        out, mesh, [Partial() if i in vdims else p
                    for i, p in enumerate(ids.placements)],
        run_check=False, shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


def vocab_pick(logits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``logits[..., ids]`` (one id a row, ``ids`` of ``logits``'s
    leading shape) for a DTensor ``logits`` split over its last
    dimension, the vocabulary: replicated over the vocabulary's mesh axes
    (an all-reduce of the partial picks), split as ``logits``'s rows."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = logits.device_mesh
    vdims = vocab_dims(logits, -1)
    rows = [Replicate() if i in vdims else p
            for i, p in enumerate(logits.placements)]
    ids = _placed_ids(ids, mesh, rows)
    local = logits.to_local()
    n = local.shape[-1]
    rel = ids.to_local().long() - _vocab_offset(mesh, vdims, n)
    hit = (rel >= 0) & (rel < n)
    picked = local.gather(-1, rel.clamp(0, n - 1)[..., None])[..., 0] * hit
    shape = tuple(ids.shape)
    out = DTensor.from_local(
        picked, mesh, [Partial() if i in vdims else p
                       for i, p in enumerate(rows)],
        run_check=False, shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())
    return out.redistribute(mesh, rows)


def head_apply(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    logits = x @ (p["embedding"].t() if cfg.tie_embeddings else p["head"])
    return constrain(logits, ("batch", "seq", "vocab"))


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


def _decode_scores(q: torch.Tensor, k_cache: torch.Tensor) -> torch.Tensor:
    """One token's scaled scores over a cache, float32: (B, G, R, 1, S)."""
    B, _, H, D = q.shape
    G = k_cache.shape[2]
    qg = (q * (1.0 / math.sqrt(D))).reshape(B, 1, G, H // G, D)
    return torch.einsum("btgrd,bsgd->bgrts", qg.float(), k_cache.float())


def _decode_out(p: torch.Tensor, v_cache: torch.Tensor) -> torch.Tensor:
    """The probabilities (B, G, R, 1, S) over the values: (B, 1, H, D)."""
    B, G, R = p.shape[:3]
    o = torch.einsum("bgrts,bsgd->btgrd", p.to(v_cache.dtype), v_cache)
    return o.reshape(B, 1, G * R, v_cache.shape[3])


def sdpa_decode(q: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Single-token attention over a cache.

    q: (B,1,H,D); caches: (B,S,G,D); valid: (S,) bool mask of live
    entries.  Scores and softmax in float32, as the reference.  The two
    products are the operators ``repro_torch::decode_scores`` and
    ``decode_out``, which DTensor (the dry run) splits over the batch,
    the heads or the head size (the scores then a partial sum, reduced
    before the softmax) without merging two split dimensions into a
    batched product's one."""
    if type(q) is not torch.Tensor:
        register_sharding()
    s = torch.where(valid[None, None, None, None, :],
                    torch.ops.repro_torch.decode_scores(q, k_cache),
                    torch.full((), NEG_INF, device=q.device))
    return torch.ops.repro_torch.decode_out(torch.softmax(s, dim=-1),
                                            v_cache)


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("decode_scores(Tensor q, Tensor k_cache) -> Tensor")
_LIB.define("decode_out(Tensor p, Tensor v_cache) -> Tensor")
_LIB.impl("decode_scores", _decode_scores, "CompositeExplicitAutograd")
_LIB.impl("decode_out", _decode_out, "CompositeExplicitAutograd")


@torch.library.register_fake("repro_torch::decode_scores", lib=_LIB)
def _fake_scores(q, k_cache):
    B, _, H, _ = q.shape
    S, G = k_cache.shape[1], k_cache.shape[2]
    return q.new_empty((B, G, H // G, 1, S), dtype=torch.float32)


@torch.library.register_fake("repro_torch::decode_out", lib=_LIB)
def _fake_out(p, v_cache):
    B, G, R = p.shape[:3]
    return v_cache.new_empty((B, 1, G * R, v_cache.shape[3]))


@register_flop_formula(torch.ops.repro_torch.decode_scores)
def _scores_flops(q_shape, k_shape, *args, **kwargs) -> int:
    B, _, H, D = q_shape
    return 2 * B * H * k_shape[1] * D


@register_flop_formula(torch.ops.repro_torch.decode_out)
def _out_flops(p_shape, v_shape, *args, **kwargs) -> int:
    B, G, R, _, S = p_shape
    return 2 * B * G * R * S * v_shape[3]


@functools.cache
def register_sharding() -> None:
    """Give DTensor the decode operators' rules (once a process): every
    tensor replicated, or split over the batch, over the heads (where the
    query and KV heads divide every mesh axis), or over the head size
    (the scores a partial sum; the probabilities replicated)."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor import Shard as S
    from torch.distributed.tensor.experimental import register_sharding as reg
    R = Replicate()

    def heads_divide(H, G, mesh) -> bool:
        return all(H % n == 0 and G % n == 0 for n in mesh.shape)

    def scores(q, k):
        out = [([R], [R, R]), ([S(0)], [S(0), S(0)]),
               ([Partial()], [S(3), S(3)])]
        if heads_divide(q.shape[2], k.shape[2], q.mesh):
            out.append(([S(1)], [S(2), S(2)]))
        return out

    def values(p, v):
        out = [([R], [R, R]), ([S(0)], [S(0), S(0)]), ([S(3)], [R, S(3)])]
        if heads_divide(p.shape[1] * p.shape[2], v.shape[2], p.mesh):
            out.append(([S(2)], [S(1), S(2)]))
        return out

    reg(torch.ops.repro_torch.decode_scores.default)(scores)
    reg(torch.ops.repro_torch.decode_out.default)(values)


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

def attn_specs(cfg: ModelConfig, *, cross: bool = False
               ) -> Dict[str, ParamSpec]:
    """A layer's attention weights; a cross-attention layer (``cross``)
    has no q/k norm, as in the reference."""
    d, H, G, D = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    specs = {
        "wq": ParamSpec((d, H, D), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, G, D), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, G, D), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((H, D, d), ("heads", "head_dim", "embed"),
                        scale=1.0 / math.sqrt(H * D)),
    }
    if cfg.qk_norm and not cross:
        specs["q_norm"] = ParamSpec((D,), (None,), init="ones",
                                    dtype=torch.float32)
        specs["k_norm"] = ParamSpec((D,), (None,), init="ones",
                                    dtype=torch.float32)
    return specs


def _proj_heads(x: torch.Tensor, w: torch.Tensor, axes) -> torch.Tensor:
    """``einsum("btd,dhk->bthk")`` as one matmul over the flattened heads
    (``axes``: the logical axes of the result).  Under a sharding context
    a split of the head size (decode's head_dim scheme) is gathered
    before the heads merge, and the result split again after: DTensor
    cannot merge a dimension whose later part is split (PyTorch 2.11)."""
    d, h, k = w.shape
    w = constrain(w, ("embed", axes[2], None), weight=True)
    wm = constrain_merged(w.reshape(d, h * k), ("embed",) + axes[2:], (h, k),
                          weight=True)
    y = constrain_merged(x @ wm, axes, (h, k))
    return constrain(y.unflatten(-1, (h, k)), axes)


_Q_AXES = ("batch", "seq", "heads", "head_dim")
_KV_AXES = ("batch", "seq", "kv_heads", "head_dim")


def _project_q(p, cfg, x, positions, *, use_rope=True):
    q = _proj_heads(x, p["wq"], _Q_AXES)
    if cfg.qk_norm and "q_norm" in p:
        q = rms_norm_1d(q, p["q_norm"])
    if use_rope and positions is not None:
        q = constrain(rope(q, positions, theta=cfg.rope_theta,
                           fraction=cfg.rope_fraction), _Q_AXES)
    return q


def _project_kv(p, cfg, x, positions, *, use_rope=True):
    k = _proj_heads(x, p["wk"], _KV_AXES)
    v = _proj_heads(x, p["wv"], _KV_AXES)
    if cfg.qk_norm and "k_norm" in p:
        k = rms_norm_1d(k, p["k_norm"])
    if use_rope and positions is not None:
        k = constrain(rope(k, positions, theta=cfg.rope_theta,
                           fraction=cfg.rope_fraction), _KV_AXES)
    return k, v


def attn_apply(p: Params, cfg: ModelConfig, x: torch.Tensor, *, mode: str,
               positions: Optional[torch.Tensor] = None,
               window: Optional[int] = None,
               cache: Optional[Dict[str, torch.Tensor]] = None,
               pos: Optional[int] = None,
               kv_x: Optional[torch.Tensor] = None,
               use_rope: bool = True,
               ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Attention layer.

    mode: ``"causal"`` (train/prefill; with a cache, the prefill writes
    it), ``"full"`` (the encoder: bidirectional), ``"cross"`` (decoder to
    encoder: K and V projected from ``kv_x``, without RoPE, and returned
    as the cache ``{"k", "v"}``), ``"decode"`` (one token against the
    cache, written at index ``pos``) or ``"cross_decode"`` (one token
    against the cross cache, read only).  Returns (output, cache)."""
    if mode == "causal":
        q = _project_q(p, cfg, x, positions, use_rope=use_rope)
        k, v = _project_kv(p, cfg, x, positions, use_rope=use_rope)
        o = sdpa(q.contiguous(), k.contiguous(), v.contiguous(), causal=True,
                 window=window)
        new_cache = None
        if cache is not None:
            new_cache = {"k": _cache_write_prefill(cache["k"], k),
                         "v": _cache_write_prefill(cache["v"], v)}
    elif mode == "full":
        q = _project_q(p, cfg, x, positions, use_rope=use_rope)
        k, v = _project_kv(p, cfg, x, positions, use_rope=use_rope)
        o = sdpa(q.contiguous(), k.contiguous(), v.contiguous(),
                 causal=False)
        new_cache = None
    elif mode == "cross":
        q = _project_q(p, cfg, x, None, use_rope=False)
        k, v = _project_kv(p, cfg, kv_x, None, use_rope=False)
        k, v = k.contiguous(), v.contiguous()
        o = sdpa(q.contiguous(), k, v, causal=False)
        new_cache = {"k": k, "v": v}
    elif mode == "cross_decode":
        # one query against the whole cross cache (Tq = 1), through the
        # kernel as the reference's goes through its sdpa
        q = _project_q(p, cfg, x, None, use_rope=False)
        o = sdpa(q.contiguous(), cache["k"], cache["v"], causal=False)
        new_cache = cache
    elif mode == "decode":
        q = _project_q(p, cfg, x, positions, use_rope=use_rope)
        k, v = _project_kv(p, cfg, x, positions, use_rope=use_rope)
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
    else:
        raise ValueError(mode)
    # a split head size is gathered before the merge, as in _proj_heads
    o = constrain(o, _Q_AXES[:3] + (None,))
    H, D, d = p["wo"].shape
    o = constrain_merged(o.reshape(*o.shape[:2], H * D), _Q_AXES, (H, D))
    wo = constrain(p["wo"], ("heads", None, "embed"), weight=True)
    wo = constrain_merged(wo.reshape(H * D, d), _Q_AXES[2:] + ("embed",),
                          (H, D), dim=0, weight=True)
    return constrain(o @ wo, ("batch", "seq", None)), new_cache


def kv_cache_shape(cfg: ModelConfig, batch: int, max_len: int
                   ) -> Tuple[Tuple[int, ...], Tuple[Optional[str], ...]]:
    """Shape + logical axes of one direction (k or v) of a layer cache."""
    eff = min(max_len, cfg.window) if cfg.window else max_len
    return ((batch, eff, cfg.num_kv_heads, cfg.head_dim),
            ("batch", None, "kv_heads", "head_dim"))


# ---------------------------------------------------------------------------
# MLP (gated / classic)
# ---------------------------------------------------------------------------

def mlp_specs(cfg: ModelConfig, *, d_ff: Optional[int] = None,
              gated: bool = True) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    specs = {
        "w_up": ParamSpec((d, f), ("embed", "mlp")),
        "w_down": ParamSpec((f, d), ("mlp", "embed")),
    }
    if gated:
        specs["w_gate"] = ParamSpec((d, f), ("embed", "mlp"))
    return specs


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if kind == "silu" else F.gelu(x, approximate="tanh")


def mlp_apply(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    h = constrain(x @ p["w_up"], ("batch", "seq", "mlp"))
    if "w_gate" in p:
        g = constrain(x @ p["w_gate"], ("batch", "seq", "mlp"))
        h = _act(g, cfg.act) * h
    else:
        h = _act(h, cfg.act)
    return constrain(h @ p["w_down"], ("batch", "seq", None))


# ---------------------------------------------------------------------------
# Mixture of Experts (sort-based dispatch with capacity)
# ---------------------------------------------------------------------------

def moe_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    f = cfg.moe_d_ff if cfg.moe_d_ff is not None else cfg.d_ff
    E = cfg.num_experts
    specs = {
        "router": ParamSpec((d, E), ("embed", None), scale=0.02),
        "w_gate": ParamSpec((E, d, f), ("experts", "embed", "mlp")),
        "w_up": ParamSpec((E, d, f), ("experts", "embed", "mlp")),
        "w_down": ParamSpec((E, f, d), ("experts", "mlp", "embed")),
    }
    if cfg.shared_expert:
        specs["shared"] = mlp_specs(cfg, d_ff=f, gated=True)
    return specs


def _positions_in_expert(expert_flat: torch.Tensor) -> torch.Tensor:
    """Rank of each (token, k) slot within its expert's arrival order.

    expert_flat: (..., N) integer expert ids, one row per sequence.
    Returns (..., N) int32 positions: a stable argsort by expert, each
    run's start carried forward by a running max, and the offsets from it
    scattered back (the reference's argsort + segmented iota, batched
    over the leading axes in place of its ``vmap``)."""
    n = expert_flat.shape[-1]
    order = torch.argsort(expert_flat, dim=-1, stable=True)
    sorted_e = torch.gather(expert_flat, -1, order)
    iota = torch.arange(n, dtype=torch.int64, device=expert_flat.device
                        ).expand_as(order)
    seg_start = torch.ones_like(order, dtype=torch.bool)
    seg_start[..., 1:] = sorted_e[..., 1:] != sorted_e[..., :-1]
    run_start = torch.cummax(torch.where(seg_start, iota, 0), dim=-1).values
    pos = torch.empty_like(order)
    pos.scatter_(-1, order, iota - run_start)
    return pos.to(torch.int32)


def moe_route(p: Params, cfg: ModelConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The router: (float32 logits (B, T, E), gates (B, T, K), expert ids
    (B, T, K)).

    The logits are taken in the compute dtype, then cast to float32;
    gates are sigmoids for K = 1, otherwise softmax probabilities
    renormalised over the top K (:func:`_top_k`)."""
    logits = (x @ p["router"]).float()
    return (logits,) + _top_k(logits, cfg.experts_per_token)


def _top_k(logits: torch.Tensor, K: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gates and expert ids of the top K.  They break ties to the
    lower expert index, as ``lax.top_k`` does: a stable descending sort,
    since ``torch.topk`` promises no order for ties, and the order
    decides each slot's arrival and so which tokens a full expert
    drops."""
    probs = torch.sigmoid(logits) if K == 1 else torch.softmax(logits, -1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[..., :K], idx[..., :K]
    if K > 1:
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return gates, idx


def _capacity(cfg: ModelConfig, T: int) -> int:
    return max(1, int(math.ceil(T * cfg.experts_per_token
                                / cfg.num_experts * cfg.capacity_factor)))


def _dispatch(x: torch.Tensor, idx: torch.Tensor, E: int, C: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each sequence's (token, k) slots into its experts' capacity rows:
    (xe (B, E, C, d), the slots' flat rows (B T K,), keep (B, T K)).  A
    slot's arrival position in its expert below C keeps it, otherwise it
    goes to an overflow row, dropped; each kept row receives exactly one
    token, so the sum of ``index_add_`` is that token."""
    B, T, d = x.shape
    K = idx.shape[-1]
    idx_flat = idx.reshape(B, T * K)
    pos = _positions_in_expert(idx_flat)                    # (B, T*K)
    keep = pos < C
    slot = torch.where(keep, idx_flat * C + pos, E * C)     # overflow bucket
    rows = (slot + torch.arange(B, device=x.device)[:, None]
            * (E * C + 1)).reshape(-1)                      # (B*T*K,)
    x_tk = x.repeat_interleave(K, dim=1).reshape(B * T * K, d)
    xe = x.new_zeros(B * (E * C + 1), d).index_add_(0, rows, x_tk)
    xe = xe.view(B, E * C + 1, d)[:, :E * C]                # drop overflow
    return xe.reshape(B, E, C, d), rows, keep


def _experts(p: Params, cfg: ModelConfig, xe: torch.Tensor) -> torch.Tensor:
    """The expert products batched over experts: (B, E, C, d) in and
    out, ``p``'s weights the same E experts."""
    B, E, C, d = xe.shape
    xe = xe.transpose(0, 1).reshape(E, B * C, d)
    h = _act(torch.bmm(xe, p["w_gate"]), cfg.act) * torch.bmm(xe, p["w_up"])
    ye = torch.bmm(h, p["w_down"])                          # (E, B*C, d)
    return ye.reshape(E, B, C, d).transpose(0, 1)


def _combine(ye: torch.Tensor, rows: torch.Tensor, gates: torch.Tensor,
             keep: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The experts' rows (B, E, C, d) back to the tokens (B, T, d),
    weighted by the kept gates (B, T, K)."""
    B, E, C, d = ye.shape
    T, K = gates.shape[1:]
    ye_flat = torch.cat([ye.reshape(B, E * C, d), ye.new_zeros(B, 1, d)],
                        dim=1)                              # (B, E*C+1, d)
    y_tk = ye_flat.reshape(B * (E * C + 1), d).index_select(0, rows)
    w = (gates.reshape(B, T * K) * keep).to(dtype)
    return (y_tk.view(B, T * K, d) * w[..., None]).reshape(B, T, K, d).sum(2)


def _expert_counts(idx: torch.Tensor, E: int, n: int) -> torch.Tensor:
    """Each expert's share of the ``n`` (token, k) slots among ``idx``'s,
    float32 (E,)."""
    flat = idx.reshape(-1)
    return torch.zeros(E, dtype=torch.float32, device=idx.device).index_add_(
        0, flat, torch.full(flat.shape, 1.0 / n, dtype=torch.float32,
                            device=idx.device))


def moe_apply(p: Params, cfg: ModelConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k MoE with per-sequence capacity.  Returns (y, aux_loss).

    The reference's steps in its order: the router (:func:`moe_route`);
    each (token, k) slot's arrival position in its expert, kept below the
    capacity ``C = max(1, ceil(T K / E * capacity_factor))`` of the call's
    own T (a decode step gets C = 1) and otherwise sent to an overflow
    row; dispatch by adding the tokens into (B, E C + 1, d) zeros
    (:func:`_dispatch`); the expert products batched over experts; the
    gather back, weighted by the kept gates; the shared expert; the
    Switch load-balance loss.  No step reads a value back to the host.
    A DTensor ``x`` (a mesh) runs :func:`_moe_apply_placed`."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return _moe_apply_placed(p, cfg, x)
    B, T, d = x.shape
    E = cfg.num_experts
    C = _capacity(cfg, T)

    logits, gates, idx = moe_route(p, cfg, x)               # (B, T, K)
    xe, rows, keep = _dispatch(x, idx, E, C)
    xe = constrain(xe, ("batch", "experts", None, None))
    y = _combine(_experts(p, cfg, xe), rows, gates, keep, x.dtype)

    if cfg.shared_expert:
        y = y + mlp_apply(p["shared"], cfg, x)

    # Switch-style load-balance auxiliary loss
    me = torch.softmax(logits, dim=-1).mean(dim=(0, 1))     # (E,)
    ce = _expert_counts(idx, E, idx.numel())
    aux = E * torch.sum(me * ce)
    return y, aux


def _moe_apply_placed(p: Params, cfg: ModelConfig, x: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`moe_apply` over a mesh, with the experts split over the
    rules' ``experts`` axes (expert parallelism).

    A sequence's slots depend only on its own tokens and C is a
    per-sequence capacity, so each rank routes and dispatches its own
    rows of the batch (``x`` split over the batch only; any other split
    raises).  The dispatched ``xe`` is then a DTensor split as the batch
    and replicated elsewhere, constrained to ``("batch", "experts", None,
    None)``: a local slice.  The expert products run on each rank's
    experts, their weights gathered over the other axes (FSDP; their
    gradients partial sums over the batch's axes); ``ye`` is gathered
    over the experts' axes before the combine, as the reference's XLA
    gathers it after its constraint.  The load-balance term multiplies
    the two global batch means: the router's mean probabilities and the
    slots' shares, each reduced over the batch's axes first."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    B, T, d = x.shape
    E = cfg.num_experts
    C = _capacity(cfg, T)
    x = constrain(x, ("batch", "seq", None))
    mesh, rows_pl = x.device_mesh, tuple(x.placements)
    if not all(pl.is_replicate() or pl == Shard(0) for pl in rows_pl):
        raise NotImplementedError(
            f"MoE over a mesh routes each rank's own sequences: x must be "
            f"split over the batch alone, not {rows_pl}")
    R = Replicate()
    batch_split = [pl.is_shard() for pl in rows_pl]

    def as_dtensor(local, placements, shape):
        shape = torch.Size(shape)
        return DTensor.from_local(
            local, mesh, placements, run_check=False, shape=shape,
            stride=torch.empty(shape, device="meta").stride())

    router = placed(p["router"], [R] * mesh.ndim, weight=True)
    logits = constrain((x @ router).float(), ("batch", "seq", None))
    gates, idx = _top_k(logits.to_local(), cfg.experts_per_token)
    xe, rows, keep = _dispatch(x.to_local(), idx, E, C)
    xe = constrain(as_dtensor(xe, rows_pl, (B, E, C, d)),
                   ("batch", "experts", None, None))
    split = [pl == Shard(1) for pl in xe.placements]

    def local_weight(w):
        # this rank's experts, whole over the other axes
        w = placed(w, [Shard(0) if s else R for s in split], weight=True)
        return w.to_local(grad_placements=[
            Shard(0) if s else Partial() if b else R
            for s, b in zip(split, batch_split)])
    ye = _experts({k: local_weight(p[k])
                   for k in ("w_gate", "w_up", "w_down")}, cfg,
                  xe.to_local())
    ye = placed(as_dtensor(ye.contiguous(), xe.placements, (B, E, C, d)),
                rows_pl)                                    # all experts
    y = as_dtensor(_combine(ye.to_local(), rows, gates, keep, x.dtype),
                   rows_pl, (B, T, d))

    if cfg.shared_expert:
        y = y + mlp_apply(p["shared"], cfg, x)

    # the load-balance term of the global batch means
    me = placed(torch.softmax(logits, dim=-1).mean(dim=(0, 1)),
                [R] * mesh.ndim)
    ce = as_dtensor(_expert_counts(idx, E, B * T * idx.shape[-1]),
                    [Partial() if b else R for b in batch_split], (E,))
    aux = E * torch.sum(me * ce.redistribute(mesh, [R] * mesh.ndim))
    return y, aux
