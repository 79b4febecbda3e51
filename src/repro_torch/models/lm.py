"""Decoder-only language model: dense, MoE, RWKV-6, the RG-LRU hybrid and
the vision-language backbone (counterpart of ``repro/models/lm.py``).

* **A loop over layers.**  The reference stacks each layer cycle's
  parameters and runs one ``lax.scan``; here :class:`LM` is an
  :class:`torch.nn.Module` holding one :class:`Block` per layer, run by a
  Python loop.  :func:`repro_torch.convert.lm_params_from_reference`
  unstacks the reference's cycle-stacked leaves into it.
* **Entry modes**, as the reference: ``forward`` (causal, no cache; the
  logits), ``loss`` (the training loss and its metrics, through the plain
  head or :func:`fused_xent` over vocabulary chunks when
  ``settings.vocab_chunk`` is set, also on a head split over a mesh's
  model axis; with ``remat`` each layer runs under
  ``torch.utils.checkpoint``), ``prefill`` (causal, writes the
  KV/recurrent state) and ``decode_step`` (one token, reads and writes
  the state).  A state is a list with one dict per layer; KV caches are
  written in place.
* **Parameters** are stored in the dtype their uses read (see
  :mod:`repro_torch.models.types`) and are frozen (no gradients) for
  serving; the trainer (:mod:`repro_torch.train.train_loop`) turns
  gradients on for the model it trains.

A MoE layer (``cfg.is_moe_layer``) holds ``moe`` in place of ``mlp``, as
in the reference; :func:`block_apply` returns its load-balance term and
:func:`run_stack` sums it, which ``loss`` weighs and serving ignores.
A ``rec`` layer (the RG-LRU
block of RecurrentGemma) holds ``rec`` and an MLP; its attention layers
are local (``cfg.window``), with ring caches of ``min(max_len, window)``
slots.  The encoder-decoder model (:class:`repro_torch.models.encdec.
EncDec`) runs its stacks through the same :func:`block_apply` (mode
``encode``, and decoder layers with cross-attention) and
:func:`run_stack`.

A vision-language config (``cfg.frontend``, pixtral-12b) has a stub
vision tower, as in the reference: a batch may carry precomputed patch
embeddings ``frontend_embeds`` (B, F, d_model), which are cast to the
compute dtype and prepended, unscaled, to the scaled token embeddings.
The stack then runs causally over all F + T positions (RoPE positions
0 .. F + T - 1), so a prefill fills F + T cache entries and decoding
continues at ``pos = F + t``.  A batch without them is text only.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import recurrent as R
from repro_torch.models import settings as settings_lib
from repro_torch.models.types import (ModelConfig, ParamSpec, SpecTree,
                                      init_params, map_specs)
from repro_torch.selector.fused_rank import resolve_device
from repro_torch.sharding.ctx import constrain, remat_contexts

__all__ = ["AUX_LOSS_WEIGHT", "Block", "LM", "LayerPlan", "Z_LOSS_WEIGHT",
           "block_apply", "block_cache_specs", "block_specs", "fused_xent",
           "layer_plans", "model_groups", "named_specs", "param_groups",
           "param_specs", "sliced_xent", "xent_loss"]

State = List[Dict[str, torch.Tensor]]
#: a parameter group: the reference leaf's path in its tree and the port's
#: parameter names it stacks, in cycle order
Group = Tuple[Tuple[str, ...], List[str]]

AUX_LOSS_WEIGHT = 0.01
Z_LOSS_WEIGHT = 1e-4


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    kind: str                   # "attn" | "rec" | "rwkv"
    moe: bool = False
    window: Optional[int] = None
    cross: bool = False         # decoder layer with cross-attention


def layer_plans(cfg: ModelConfig, *, cross: bool = False) -> List[LayerPlan]:
    plans = []
    for i in range(cfg.num_layers):
        kind = cfg.block_kind(i)
        window = cfg.window if (kind == "attn" and cfg.window) else None
        plans.append(LayerPlan(kind=kind, moe=cfg.is_moe_layer(i),
                               window=window, cross=cross))
    return plans


def _check_plan(plan: LayerPlan) -> None:
    if plan.kind not in ("attn", "rec", "rwkv"):
        raise ValueError(plan.kind)


# ---------------------------------------------------------------------------
# per-layer specs / apply
# ---------------------------------------------------------------------------

def block_specs(cfg: ModelConfig, plan: LayerPlan) -> Dict[str, Any]:
    _check_plan(plan)
    s: Dict[str, Any] = {"ln1": L.norm_specs(cfg), "ln2": L.norm_specs(cfg)}
    if plan.kind == "rwkv":
        s["tm"] = R.rwkv_time_mix_specs(cfg)
        s["cm"] = R.rwkv_channel_mix_specs(cfg)
        return s
    if plan.kind == "attn":
        s["attn"] = L.attn_specs(cfg)
    else:
        s["rec"] = R.rglru_block_specs(cfg)
    if plan.cross:
        s["ln_cross"] = L.norm_specs(cfg)
        s["cross"] = L.attn_specs(cfg, cross=True)
    if plan.moe:
        s["moe"] = L.moe_specs(cfg)
    else:
        s["mlp"] = L.mlp_specs(cfg, gated=cfg.gated_mlp)
    return s


def block_cache_specs(cfg: ModelConfig, plan: LayerPlan, batch: int,
                      max_len: int, enc_len: int = 0
                      ) -> Dict[str, ParamSpec]:
    """ParamSpec tree for this layer's decode state; a cross-attention
    layer adds its cross cache ``xk``, ``xv`` of ``enc_len`` positions
    in the compute dtype."""
    _check_plan(plan)
    if plan.kind == "attn":
        shape, axes = L.kv_cache_shape(cfg, batch, max_len)
        s = {"k": ParamSpec(shape, axes, init="zeros"),
             "v": ParamSpec(shape, axes, init="zeros")}
    else:
        shapes = R.rglru_state_shapes if plan.kind == "rec" \
            else R.rwkv_state_shapes
        s = {name: ParamSpec(shape, axes, init="zeros", dtype=dtype)
             for name, (shape, axes, dtype) in shapes(cfg, batch).items()}
    if plan.cross:
        xshape = (batch, enc_len, cfg.num_kv_heads, cfg.head_dim)
        xaxes = ("batch", None, "kv_heads", "head_dim")
        s["xk"] = ParamSpec(xshape, xaxes, init="zeros")
        s["xv"] = ParamSpec(xshape, xaxes, init="zeros")
    return s


def block_apply(cfg: ModelConfig, plan: LayerPlan, p: Mapping, x, *,
                mode: str, positions=None, cache=None, pos=None,
                enc_out=None):
    """One layer in mode ``train``, ``prefill``, ``decode`` or ``encode``
    (an encoder layer: bidirectional attention, no cache).  A layer with
    cross-attention (``plan.cross``) attends to ``enc_out`` after its
    self-attention in ``train`` and ``prefill`` (the prefill writes the
    cross cache ``xk``, ``xv``) and to that cache in ``decode``.  Returns
    (x, aux, new_cache): ``aux`` the MoE layer's load-balance term (0.0
    elsewhere, no launch), ``new_cache`` ``{}`` without a cache."""
    aux = 0.0
    new_cache: Dict[str, torch.Tensor] = {}
    cache = cache or {}
    if mode not in ("train", "prefill", "decode", "encode"):
        raise ValueError(f"unknown mode {mode!r}")
    if plan.kind != "rwkv":
        h = L.norm_apply(p["ln1"], x, cfg.norm)
        if plan.kind == "rec":
            state = {"h": cache["h"], "conv": cache["conv"]} \
                if "h" in cache else None
            y, nc = R.rglru_block_apply(p["rec"], cfg, h, state=state)
        elif mode == "encode":
            y, nc = L.attn_apply(p["attn"], cfg, h, mode="full",
                                 positions=positions)
        elif mode == "decode":
            y, nc = L.attn_apply(p["attn"], cfg, h, mode="decode",
                                 positions=positions, window=plan.window,
                                 cache={"k": cache["k"], "v": cache["v"]},
                                 pos=pos)
        else:
            attn_cache = {"k": cache["k"], "v": cache["v"]} \
                if "k" in cache else None
            y, nc = L.attn_apply(p["attn"], cfg, h, mode="causal",
                                 positions=positions, window=plan.window,
                                 cache=attn_cache)
        if nc is not None:
            new_cache.update(nc)
        x = x + y
        if plan.cross:
            x = x + _cross_apply(cfg, p, x, mode, cache, new_cache, enc_out)
        h = L.norm_apply(p["ln2"], x, cfg.norm)
        if plan.moe:
            y, aux = L.moe_apply(p["moe"], cfg, h)
        else:
            y = L.mlp_apply(p["mlp"], cfg, h)
        return x + y, aux, new_cache
    # rwkv
    h = L.norm_apply(p["ln1"], x, "layernorm")
    st = {"shift": cache["tm_shift"], "wkv": cache["wkv"]} \
        if "wkv" in cache else None
    y, ns = R.rwkv_time_mix_apply(p["tm"], cfg, h, state=st)
    if ns is not None:
        new_cache["tm_shift"] = ns["shift"]
        new_cache["wkv"] = ns["wkv"]
    x = x + y
    h = L.norm_apply(p["ln2"], x, "layernorm")
    st = {"shift": cache["cm_shift"]} if "cm_shift" in cache else None
    y, ns = R.rwkv_channel_mix_apply(p["cm"], cfg, h, state=st)
    if ns is not None:
        new_cache["cm_shift"] = ns["shift"]
    return x + y, aux, new_cache


def _cross_apply(cfg, p, x, mode, cache, new_cache, enc_out):
    """The cross-attention sub-block's output: over ``enc_out`` in
    ``train`` and ``prefill`` (the prefill keeps the projected K and V as
    the cross cache), over the cross cache in ``decode``."""
    h = L.norm_apply(p["ln_cross"], x, cfg.norm)
    if mode == "decode":
        y, _ = L.attn_apply(p["cross"], cfg, h, mode="cross_decode",
                            cache={"k": cache["xk"], "v": cache["xv"]})
        new_cache["xk"], new_cache["xv"] = cache["xk"], cache["xv"]
        return y
    y, nc = L.attn_apply(p["cross"], cfg, h, mode="cross", kv_x=enc_out)
    if mode == "prefill":
        new_cache["xk"], new_cache["xv"] = nc["k"], nc["v"]
    return y


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def param_specs(cfg: ModelConfig) -> SpecTree:
    """The model's spec tree, ``{"embed", "final_norm", "layers": [one
    dict per layer]}``, without allocating anything."""
    return {"embed": L.embed_specs(cfg),
            "final_norm": L.norm_specs(cfg),
            "layers": [block_specs(cfg, plan) for plan in layer_plans(cfg)]}


def _parameter_dict(leaves: Mapping[str, Any]) -> nn.ParameterDict:
    """A group's leaves as frozen parameters; a nested group (the MoE
    layer's ``shared`` expert) becomes a sub-dict under its key."""
    return nn.ParameterDict({
        k: _parameter_dict(v) if isinstance(v, Mapping)
        else nn.Parameter(v, requires_grad=False) for k, v in leaves.items()})


class Block(nn.Module):
    """One layer's parameters: a :class:`torch.nn.ParameterDict` per group
    (``ln1``, ``attn`` or ``rec``, ``ln2``, ``mlp`` or ``moe``; or ``ln1``,
    ``tm``, ``ln2``, ``cm``), indexable like the reference's parameter
    dicts."""

    def __init__(self, groups: Mapping[str, Mapping[str, torch.Tensor]]):
        super().__init__()
        self.groups = nn.ModuleDict({k: _parameter_dict(v)
                                     for k, v in groups.items()})

    def __getitem__(self, name: str) -> nn.ParameterDict:
        return self.groups[name]

    def __contains__(self, name: str) -> bool:
        return name in self.groups


def _leaf_tensor(value, spec: ParamSpec, compute_dtype: torch.dtype,
                 device: torch.device, where: str) -> torch.Tensor:
    t = value if isinstance(value, torch.Tensor) else \
        torch.tensor(np.asarray(value))
    if tuple(t.shape) != tuple(spec.shape):
        raise ValueError(f"{where}: shape {tuple(t.shape)}, expected "
                         f"{spec.shape}")
    return t.to(device=device, dtype=spec.storage_dtype(compute_dtype))


def _load_tree(specs, values, compute_dtype, device, where=""):
    if isinstance(specs, ParamSpec):
        return _leaf_tensor(values, specs, compute_dtype, device, where)
    if isinstance(specs, dict):
        if set(values) != set(specs):
            raise ValueError(f"{where or 'params'}: keys {sorted(values)}, "
                             f"expected {sorted(specs)}")
        return {k: _load_tree(v, values[k], compute_dtype, device,
                              f"{where}/{k}") for k, v in specs.items()}
    if len(values) != len(specs):
        raise ValueError(f"{where}: {len(values)} entries, expected "
                         f"{len(specs)}")
    return [_load_tree(s, v, compute_dtype, device, f"{where}/{i}")
            for i, (s, v) in enumerate(zip(specs, values))]


def load_values(specs: SpecTree, cfg: ModelConfig, device: torch.device,
                seed: int, params: Optional[Mapping[str, Any]]) -> Any:
    """A model's parameter tree on ``device``: ``params`` (tensors or numpy
    arrays) checked against ``specs`` and cast to each leaf's storage
    dtype, or without it drawn from a generator seeded with ``seed``."""
    if params is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        return init_params(specs, gen, cfg.compute_dtype, device)
    return _load_tree(specs, params, cfg.compute_dtype, device)


def zeros_state(cfg: ModelConfig, specs, device: torch.device) -> State:
    """A zeroed decode state for a list of per-layer cache specs."""
    return map_specs(
        lambda s: torch.zeros(s.shape, device=device,
                              dtype=s.storage_dtype(cfg.compute_dtype)),
        specs)


def run_stack(cfg: ModelConfig, plans: List[LayerPlan], blocks, x, *,
              mode: str, positions, state: Optional[State],
              pos: Optional[int] = None, enc_out=None, remat: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor, Optional[State]]:
    """``x`` through ``blocks`` in depth order (the reference's
    ``_stack_apply``); returns (x, the layers' summed aux term, the new
    state or None without one).  With ``remat`` in mode ``train`` (the
    reference wraps each layer cycle in ``jax.checkpoint``) each layer
    runs under ``torch.utils.checkpoint`` (non-reentrant): the backward
    recomputes the layer from its input, under the forward's sharding
    context (:func:`repro_torch.sharding.ctx.remat_contexts`), and keeps
    nothing else of it.  Nothing in a layer draws random numbers, so no
    RNG state is kept."""
    new_state: Optional[State] = [] if state is not None else None
    aux = x.new_zeros((), dtype=torch.float32)
    for i, (plan, block) in enumerate(zip(plans, blocks)):
        cache = state[i] if state is not None else None
        if remat and mode == "train" and cache is None:
            x, aux_i = checkpoint(_train_layer, cfg, plan, block, x,
                                  positions, enc_out, use_reentrant=False,
                                  preserve_rng_state=False,
                                  context_fn=remat_contexts)
            nc = {}
        else:
            x, aux_i, nc = block_apply(cfg, plan, block, x, mode=mode,
                                       positions=positions, cache=cache,
                                       pos=pos, enc_out=enc_out)
        x = constrain(x, ("batch", "seq", None))
        aux = aux + aux_i
        if new_state is not None:
            new_state.append(nc)
    return x, aux, new_state


def _train_layer(cfg, plan, block, x, positions, enc_out):
    x, aux, _ = block_apply(cfg, plan, block, x, mode="train",
                            positions=positions, enc_out=enc_out)
    return x, aux


def _xent_chunk(x, w, labels, m, s, ll, c0: int, chunk: int, V: int,
                tied: bool):
    """One vocabulary chunk of :func:`fused_xent` over a whole head: the
    chunk's logits (the last chunk's padding scored -1e30), the running
    max and sum, and the label's logit where the label falls in the
    chunk."""
    pad = chunk - (w.shape[0] if tied else w.shape[1])
    if pad:
        w = torch.nn.functional.pad(w, (0, 0, 0, pad) if tied else (0, pad))
    logits = (x @ (w.t() if tied else w)).float()
    vpos = c0 + torch.arange(chunk, device=x.device)
    logits = torch.where(vpos < V, logits,
                         torch.full((), L.NEG_INF, device=x.device))
    m_new = torch.maximum(m, logits.amax(-1))
    s = s * torch.exp(m - m_new) \
        + torch.exp(logits - m_new[..., None]).sum(-1)
    in_chunk = (labels >= c0) & (labels < c0 + chunk)
    local = (labels - c0).clamp(0, chunk - 1)
    picked = logits.gather(-1, local[..., None])[..., 0]
    return m_new, s, torch.where(in_chunk, picked, ll)


def fused_xent(embed, cfg: ModelConfig, x: torch.Tensor,
               labels: torch.Tensor, chunk: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused head matmul and cross-entropy over vocabulary chunks (the
    reference's ``fused_xent``): per token (logsumexp, label logit), (B, T)
    float32 each, without the (B, T, V) float32 logits.  ``labels`` must
    be in [0, V).

    A whole head runs each chunk under ``torch.utils.checkpoint``, so its
    logits live only inside its step, forward and backward.  A head split
    over the vocabulary (a DTensor on a mesh's model axis) keeps the
    split, as the reference's constraints do: each rank runs its own
    slice chunk by chunk and the ranks combine their maxima, sums and
    picks (:func:`_split_xent`), so no rank holds its (B, T, V / m)
    float32 logits either."""
    tied = cfg.tie_embeddings
    w = embed["embedding"] if tied else embed["head"]
    vdims = L.vocab_dims(w, 0 if tied else 1)
    if vdims:
        return _split_xent(w, x, labels, chunk, tied, vdims)
    V = w.shape[0] if tied else w.shape[1]
    chunk = min(chunk, V)
    # views of one split: the backward assembles w's gradient once
    pieces = w.split(chunk, dim=0 if tied else 1)
    B, T = labels.shape
    m = torch.full((B, T), L.NEG_INF, dtype=torch.float32, device=x.device)
    s = torch.zeros((B, T), dtype=torch.float32, device=x.device)
    ll = torch.zeros((B, T), dtype=torch.float32, device=x.device)
    for i, w_c in enumerate(pieces):
        m, s, ll = checkpoint(_xent_chunk, x, w_c, labels, m, s, ll,
                              i * chunk, chunk, V, tied,
                              use_reentrant=False, preserve_rng_state=False)
    return m + torch.log(torch.clamp_min(s, 1e-30)), ll


# --- the head over a split vocabulary -----------------------------------------
#
# A slice of the head holds vocabulary ids v0 .. v0 + n - 1 (its rows when
# tied, (V, d); its columns when not, (d, V)).  The local pass runs one
# slice chunk by chunk, the last chunk ragged, and needs no process group;
# the combine joins slices: stacked on one device, and over the ranks of
# the vocabulary's mesh dimensions by all-reduces.


def _chunk_logits(x, w, c0: int, c1: int, tied: bool) -> torch.Tensor:
    """The float32 logits of the slice's ids ``c0 .. c1 - 1``."""
    w_c = w[c0:c1].t() if tied else w[:, c0:c1]
    return (x @ w_c).float()


def xent_slice_stats(x, w, labels, v0: int, chunk: int, tied: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The local pass over one slice of the head (ids from ``v0``), no
    gradient: per token the slice's max logit, its sum of exp(logit -
    max) and the label's logit where the label lies in the slice (0
    elsewhere), (B, T) float32 each."""
    n = w.shape[0 if tied else 1]
    m = torch.full(labels.shape, L.NEG_INF, dtype=torch.float32,
                   device=x.device)
    s = torch.zeros(labels.shape, dtype=torch.float32, device=x.device)
    ll = torch.zeros(labels.shape, dtype=torch.float32, device=x.device)
    rel = labels - v0
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        logits = _chunk_logits(x, w, c0, c1, tied)
        m_new = torch.maximum(m, logits.amax(-1))
        s = s * torch.exp(m - m_new) \
            + torch.exp(logits - m_new[..., None]).sum(-1)
        m = m_new
        hit = (rel >= c0) & (rel < c1)
        picked = logits.gather(-1, (rel - c0).clamp(0, c1 - c0 - 1)
                               [..., None])[..., 0]
        ll = torch.where(hit, picked, ll)
    return m, s, ll


def _all_reduce(t: torch.Tensor, op: str, groups) -> torch.Tensor:
    """``t`` reduced by ``op`` over each (mesh, dimension) of ``groups``
    (the functional collective, which the dry run's count sees)."""
    from torch.distributed import _functional_collectives as funcol
    for group in groups:
        t = funcol.all_reduce(t, op, group)
        if isinstance(t, funcol.AsyncCollectiveTensor):
            t = t.wait()
    return t


def xent_combine(m, s, ll, groups=()) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logsumexp, label logit) from slices' :func:`xent_slice_stats`
    stacked on dimension 0, and over the ranks of ``groups`` ((mesh,
    dimension) pairs, none on one device): the maxima's max, each sum
    rescaled to it and summed, the picks summed (one slice holds each
    label)."""
    top = _all_reduce(m.amax(0), "max", groups)
    s, ll = _all_reduce(torch.stack([(s * torch.exp(m - top)).sum(0),
                                     ll.sum(0)]), "sum", groups)
    return top + torch.log(torch.clamp_min(s, 1e-30)), ll


def _slice_grad(x, w, labels, v0: int, lse, dlse, dll, chunk: int,
                tied: bool, dx: torch.Tensor) -> torch.Tensor:
    """One slice's part of the backward: each chunk's logits recomputed,
    softmax * dlse + onehot * dll formed in their place; adds the
    slice's dx into ``dx`` (float32) and returns the slice's dw."""
    n = w.shape[0 if tied else 1]
    dw = torch.empty_like(w)
    x2 = x.reshape(-1, x.shape[-1])
    rel = labels - v0
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        g = _chunk_logits(x, w, c0, c1, tied)
        g.sub_(lse[..., None]).exp_().mul_(dlse[..., None])
        hit = (rel >= c0) & (rel < c1)
        g.scatter_add_(-1, (rel - c0).clamp(0, c1 - c0 - 1)[..., None],
                       (dll * hit)[..., None])
        g = g.to(x.dtype).reshape(-1, c1 - c0)
        if tied:
            dx.add_((g @ w[c0:c1]).view(dx.shape))
            dw[c0:c1] = g.t() @ x2
        else:
            dx.add_((g @ w[:, c0:c1].t()).view(dx.shape))
            dw[:, c0:c1] = x2.t() @ g
    return dw


class _SlicedXent(torch.autograd.Function):
    """(logsumexp, label logit) over the head slices ``ws`` (ids from
    ``offsets``) and the other ranks' slices over ``groups``.  The forward
    keeps x, the slices, the labels and the logsumexp; the backward
    recomputes each chunk's logits (the reference's per-chunk
    ``jax.checkpoint``) and returns dx over these slices alone (a partial
    sum over ``groups``) and each slice's dw."""

    @staticmethod
    def forward(ctx, x, labels, chunk, tied, offsets, groups, *ws):
        stats = [xent_slice_stats(x, w, labels, v0, chunk, tied)
                 for w, v0 in zip(ws, offsets)]
        lse, ll = xent_combine(*(torch.stack(t) for t in zip(*stats)),
                               groups=groups)
        ctx.save_for_backward(x, labels, lse, *ws)
        ctx.chunk, ctx.tied, ctx.offsets = chunk, tied, offsets
        return lse, ll

    @staticmethod
    def backward(ctx, dlse, dll):
        x, labels, lse, *ws = ctx.saved_tensors
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dws = [_slice_grad(x, w, labels, v0, lse, dlse, dll, ctx.chunk,
                           ctx.tied, dx) for w, v0 in zip(ws, ctx.offsets)]
        return (dx.to(x.dtype), None, None, None, None, None, *dws)


def sliced_xent(embed, cfg: ModelConfig, x: torch.Tensor,
                labels: torch.Tensor, chunk: int, parts: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`fused_xent`'s split path on one device, no process group:
    the head cut into ``parts`` equal slices of the vocabulary, each run
    through the local pass and combined as a model axis of ``parts``
    ranks combines them."""
    tied = cfg.tie_embeddings
    w = embed["embedding"] if tied else embed["head"]
    V = w.shape[0 if tied else 1]
    if V % parts:
        raise ValueError(f"a vocabulary of {V} does not split in {parts}")
    ws = w.split(V // parts, dim=0 if tied else 1)
    return _SlicedXent.apply(x, labels, chunk, tied,
                             tuple(range(0, V, V // parts)), (), *ws)


def _split_xent(w, x, labels, chunk: int, tied: bool, vdims: List[int]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`fused_xent` over a DTensor head ``w`` split over the
    vocabulary on the mesh dimensions ``vdims``: any other split of ``w``
    (FSDP's) gathered, ``x`` and the labels replicated over ``vdims``,
    and each rank's local slice through :class:`_SlicedXent`.  dx comes
    back a partial sum over ``vdims``; dw exact on each rank's slice, a
    partial sum over the axes that split the batch (as
    :func:`repro_torch.models.layers.vocab_lookup`'s).  (lse, ll) are
    DTensors split as the batch, replicated over ``vdims``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.sharding.ctx import placed
    mesh, vdim = w.device_mesh, 0 if tied else 1
    w = placed(w, [Shard(vdim) if i in vdims else Replicate()
                   for i in range(mesh.ndim)], weight=True)
    rows = [Replicate() if i in vdims else p
            for i, p in enumerate(x.placements)]
    if tuple(x.placements) != tuple(rows):
        x = placed(x, rows)
    labels = L._placed_ids(labels, mesh, rows)
    local_w = w.to_local(grad_placements=[
        Shard(vdim) if i in vdims else
        Partial() if isinstance(p, Shard) else Replicate()
        for i, p in enumerate(rows)])
    local_x = x.to_local(grad_placements=[
        Partial() if i in vdims else p for i, p in enumerate(rows)])
    v0 = L._vocab_offset(mesh, vdims, local_w.shape[vdim])
    lse, ll = _SlicedXent.apply(local_x, labels.to_local(), chunk, tied,
                                (v0,), tuple((mesh, i) for i in vdims),
                                local_w)
    shape = torch.Size(labels.shape)
    stride = torch.empty(shape, device="meta").stride()
    return tuple(DTensor.from_local(t, mesh, rows, run_check=False,
                                    shape=shape, stride=stride)
                 for t in (lse, ll))


def plain_xent(logits: torch.Tensor, labels: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logsumexp, label logit) per token from whole logits, in float32;
    ``labels`` must be in [0, V).  Written as a max, a sum and a gather
    over a flat row of tokens, which DTensor keeps split over the
    vocabulary (it gathers the whole logits for ``torch.logsumexp``); a
    vocabulary split over a mesh picks the labels' logits shard by shard
    (:func:`repro_torch.models.layers.vocab_pick`)."""
    logits = logits.float()
    m = logits.amax(-1, keepdim=True).detach()
    lse = (m + torch.log(torch.exp(logits - m).sum(-1, keepdim=True)))[..., 0]
    if L.vocab_dims(logits, -1):
        return lse, L.vocab_pick(logits, labels)
    ll = logits.flatten(0, -2).gather(-1, labels.reshape(-1, 1))
    return lse, ll.view(labels.shape)


def xent_loss(lse: torch.Tensor, ll: torch.Tensor, labels: torch.Tensor,
              aux: torch.Tensor, aux_weight: float
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's loss from per-token (logsumexp, label logit):
    the token mean of the cross-entropy over labels >= 0, the z-loss, and
    ``aux_weight`` times ``aux``.  Returns (total, {xent, z_loss, aux,
    tokens})."""
    mask = (labels >= 0).float()
    denom = torch.clamp_min(mask.sum(), 1.0)
    xent = ((lse - ll) * mask).sum() / denom
    z_loss = Z_LOSS_WEIGHT * (lse.square() * mask).sum() / denom
    total = xent + z_loss
    if aux_weight:
        total = total + aux_weight * aux
    return total, {"xent": xent, "z_loss": z_loss, "aux": aux,
                   "tokens": mask.sum()}


def _stack_groups(cfg: ModelConfig, prefix: str, ref_stack: str,
                  names: List[str]) -> Dict[Tuple[str, ...], List[str]]:
    """The reference leaves of one layer stack, each with the port's
    parameter names it stacks: layer ``c * cycle + i`` (``{prefix}.{layer}
    .groups. ...``) is cycle ``c`` of ``(ref_stack, "cycles", "b{i}",
    ...)``; a remainder layer's leaves are their own, ``(ref_stack,
    "rem", "r{j}", ...)``."""
    cyc = math.lcm(len(cfg.block_pattern),
                   cfg.moe_period if cfg.num_experts else 1)
    n_cyc = (cfg.num_layers // cyc) * cyc
    out: Dict[Tuple[str, ...], List[str]] = {}
    for name in names:
        parts = name.split(".")
        if parts[0] != prefix:
            continue
        i, leaf = int(parts[1]), tuple(parts[3:])     # after "groups"
        if i < n_cyc:
            path = (ref_stack, "cycles", f"b{i % cyc}") + leaf
        else:
            path = (ref_stack, "rem", f"r{i - n_cyc}") + leaf
        out.setdefault(path, []).append(name)
    for members in out.values():                     # cycle order
        members.sort(key=lambda n: int(n.split(".")[1]))
    return out


def _spec_names(tree, prefix: str) -> List[str]:
    """The parameter names a spec subtree gets in the module tree."""
    if isinstance(tree, Mapping):
        return [n for k, v in tree.items()
                for n in _spec_names(v, f"{prefix}.{k}")]
    return [prefix]


def param_groups(specs: Mapping[str, Any], stacks) -> List[Group]:
    """A model's parameters grouped as the reference's tree holds them, in
    the reference's flatten order (its dict keys sorted at every level).
    ``specs`` is the model's spec tree; ``stacks`` maps each of its layer
    lists to (module prefix, reference stack name, config), whose layer
    ``i`` is named ``{prefix}.{i}.groups. ...`` (:class:`Block`); every
    other parameter is a leaf of its own."""
    names: List[str] = []
    for key, sub in specs.items():
        if key in stacks:
            prefix = stacks[key][0]
            for i, layer in enumerate(sub):
                names += _spec_names(layer, f"{prefix}.{i}.groups")
        else:
            names += _spec_names(sub, key)
    groups: Dict[Tuple[str, ...], List[str]] = {}
    for prefix, ref_stack, cfg in stacks.values():
        groups.update(_stack_groups(cfg, prefix, ref_stack, names))
    grouped = {n for members in groups.values() for n in members}
    for name in names:
        if name not in grouped:
            groups[tuple(name.split("."))] = [name]
    return sorted(groups.items())


def named_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    """The model's ParamSpecs by parameter name (the names of
    ``LM.named_parameters``), in spec order: what places each parameter
    on a mesh (``sharding.rules.sharding_for_spec``)."""
    specs = param_specs(cfg)
    trees = [("embed", specs["embed"]), ("final_norm", specs["final_norm"])]
    trees += [(f"blocks.{i}.groups", layer)
              for i, layer in enumerate(specs["layers"])]
    out: Dict[str, ParamSpec] = {}
    for prefix, tree in trees:
        leaves: List[ParamSpec] = []
        map_specs(leaves.append, tree)
        out.update(zip(_spec_names(tree, prefix), leaves))
    return out


def model_groups(cfg: ModelConfig) -> List[Group]:
    """:meth:`LM.param_groups` for ``cfg``, without building the model."""
    return param_groups(param_specs(cfg),
                        {"layers": ("blocks", "stack", cfg)})


def seq_positions(B: int, T: int, start: int, device) -> torch.Tensor:
    """Positions ``start .. start + T - 1`` for each of ``B`` rows."""
    return torch.arange(start, start + T, dtype=torch.int32,
                        device=device).expand(B, T)


class LM(nn.Module):
    """Decoder-only LM (dense, MoE, RWKV-6, RG-LRU hybrid and VLM
    families) on one device.

    ``device`` defaults to the card; with no CUDA device that raises
    :class:`~repro_torch.selector.BackendUnavailableError`.  ``params``
    (``{"embed", "final_norm", "layers": [per-layer dicts]}``, tensors or
    numpy arrays) loads given weights; without it the weights are drawn
    from a :class:`torch.Generator` seeded with ``seed`` on ``device``.
    """

    def __init__(self, cfg: ModelConfig, *,
                 device: Union[str, torch.device] = "cuda", seed: int = 0,
                 params: Optional[Mapping[str, Any]] = None):
        super().__init__()
        if cfg.is_encdec:
            raise ValueError(f"{cfg.name} is an encoder-decoder model: "
                             f"build it as an EncDec "
                             f"(repro_torch.models.encdec), not an LM")
        self.cfg = cfg
        self.plans = layer_plans(cfg)
        self.device = resolve_device(device)
        values = load_values(self.param_specs(), cfg, self.device, seed,
                             params)
        self.embed = _parameter_dict(values["embed"])
        self.final_norm = _parameter_dict(values["final_norm"])
        self.blocks = nn.ModuleList(Block(v) for v in values["layers"])

    # -- specs -----------------------------------------------------------------
    def param_specs(self) -> SpecTree:
        return param_specs(self.cfg)

    def state_specs(self, batch: int, max_len: int) -> List[Dict]:
        return [block_cache_specs(self.cfg, plan, batch, max_len)
                for plan in self.plans]

    def init_state(self, batch: int, max_len: int) -> State:
        return zeros_state(self.cfg, self.state_specs(batch, max_len),
                           self.device)

    # -- the stack -------------------------------------------------------------
    def _embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        x = L.embed_apply(self.embed, tokens)
        return x * math.sqrt(self.cfg.d_model)

    def _embed(self, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """The token embeddings scaled by sqrt(d_model), with a VLM
        batch's ``frontend_embeds`` (B, F, d_model) prepended in the
        compute dtype, unscaled."""
        x = self._embed_tokens(batch["tokens"])
        if self.cfg.frontend and "frontend_embeds" in batch:
            fe = batch["frontend_embeds"].to(device=x.device, dtype=x.dtype)
            if fe.dim() != 3 or fe.shape[0] != x.shape[0] \
                    or fe.shape[2] != x.shape[2]:
                raise ValueError(f"frontend_embeds of shape "
                                 f"{tuple(fe.shape)} do not fit a batch of "
                                 f"{x.shape[0]} at d_model {x.shape[2]}")
            x = torch.cat([fe, x], dim=1)
        return x

    def _stack(self, x, *, mode: str, positions, state: Optional[State],
               pos: Optional[int] = None, remat: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor, Optional[State]]:
        return run_stack(self.cfg, self.plans, self.blocks, x, mode=mode,
                         positions=positions, state=state, pos=pos,
                         remat=remat)

    def _hidden(self, batch: Mapping[str, torch.Tensor], remat: bool
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The final-normed training-mode hidden states (B, F + T, d) and
        the stack's aux term."""
        x = self._embed(batch)
        B, T = x.shape[:2]
        x, aux, _ = self._stack(x, mode="train",
                                positions=seq_positions(B, T, 0, x.device),
                                state=None, remat=remat)
        return L.norm_apply(self.final_norm, x, self.cfg.norm), aux

    # -- forward and loss --------------------------------------------------------
    def forward(self, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """Training-mode logits (B, F + T, V) of ``batch["tokens"]`` after
        a VLM batch's F patch embeddings (F = 0 without them)."""
        x, _ = self._hidden(batch, remat=False)
        return L.head_apply(self.embed, self.cfg, x)

    def loss(self, batch: Mapping[str, torch.Tensor], *, remat: bool = True
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training loss of ``batch`` (the reference's ``LM.loss``):
        ``batch["labels"]`` (B, F + T) ints, -1 at masked positions (a VLM
        batch's F patches).  The cross-entropy is a token mean over the
        unmasked labels; the z-loss is ``Z_LOSS_WEIGHT`` times the mean
        square logsumexp; MoE layers add ``AUX_LOSS_WEIGHT`` times their
        summed load-balance term.  With ``settings.vocab_chunk`` set the
        head runs through :func:`fused_xent`.  Returns (total, {xent,
        z_loss, aux, tokens}), float32 scalars."""
        labels = batch["labels"]
        x, aux = self._hidden(batch, remat=remat)
        labels = labels.to(device=x.device, dtype=torch.long)
        chunk = settings_lib.get().vocab_chunk
        if chunk:
            lse, ll = fused_xent(self.embed, self.cfg, x,
                                 labels.clamp_min(0), chunk)
        else:
            lse, ll = plain_xent(L.head_apply(self.embed, self.cfg, x),
                                 labels.clamp_min(0))
        return xent_loss(lse, ll, labels, aux, AUX_LOSS_WEIGHT)

    def param_groups(self) -> List[Group]:
        """The parameters as the reference's leaves hold them (its
        cycle-stacked layers), in its flatten order: what Adafactor's
        factored statistics span (:mod:`repro_torch.train.optimizer`)."""
        return model_groups(self.cfg)

    # -- serving ------------------------------------------------------------------
    def prefill(self, batch: Mapping[str, torch.Tensor], state: State
                ) -> Tuple[torch.Tensor, State]:
        """Run the prompt (after a VLM batch's patches) through the
        stack, filling F + T entries of the state.  Returns
        (last-position logits (B, V), new state)."""
        x = self._embed(batch)
        B, T = x.shape[:2]
        x, _, new_state = self._stack(
            x, mode="prefill", positions=seq_positions(B, T, 0, x.device),
            state=state)
        x = L.norm_apply(self.final_norm, x[:, -1:], self.cfg.norm)
        return L.head_apply(self.embed, self.cfg, x)[:, 0], new_state

    def decode_step(self, token: torch.Tensor, pos: int, state: State
                    ) -> Tuple[torch.Tensor, State]:
        """One decode step.  token: (B,) ints; pos: the index at which the
        new token is written (cache entries [0, pos] valid; F + t after
        F patches and t text tokens)."""
        pos = int(pos)
        x = self._embed_tokens(token[:, None])
        x, _, new_state = self._stack(
            x, mode="decode",
            positions=seq_positions(x.shape[0], 1, pos, x.device),
            state=state, pos=pos)
        x = L.norm_apply(self.final_norm, x, self.cfg.norm)
        return L.head_apply(self.embed, self.cfg, x)[:, 0], new_state
