"""Decoder-only language model: dense, MoE, RWKV-6, the RG-LRU hybrid and
the vision-language backbone (counterpart of ``repro/models/lm.py``).

* **A loop over layers.**  The reference stacks each layer cycle's
  parameters and runs one ``lax.scan``; here :class:`LM` is an
  :class:`torch.nn.Module` holding one :class:`Block` per layer, run by a
  Python loop.  :func:`repro_torch.convert.lm_params_from_reference`
  unstacks the reference's cycle-stacked leaves into it.
* **Three entry modes**, as the reference: ``forward`` (causal, no cache;
  the logits only — ``loss`` and ``fused_xent`` wait for training),
  ``prefill`` (causal, writes the KV/recurrent state) and ``decode_step``
  (one token, reads and writes the state).  A state is a list with one
  dict per layer; KV caches are written in place.
* **Parameters** are stored in the dtype their uses read (see
  :mod:`repro_torch.models.types`) and never require gradients.

A MoE layer (``cfg.is_moe_layer``) holds ``moe`` in place of ``mlp``, as
in the reference.  Its load-balance term is not summed: serving does not
read it, and it comes back with ``loss``.  A ``rec`` layer (the RG-LRU
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

from repro_torch.models import layers as L
from repro_torch.models import recurrent as R
from repro_torch.models.types import (ModelConfig, ParamSpec, SpecTree,
                                      init_params, map_specs)
from repro_torch.selector.fused_rank import resolve_device

__all__ = ["Block", "LM", "LayerPlan", "block_apply", "block_cache_specs",
           "block_specs", "layer_plans", "param_specs"]

State = List[Dict[str, torch.Tensor]]


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
    (x, new_cache); ``new_cache`` is ``{}`` without a cache."""
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
            y, _ = L.moe_apply(p["moe"], cfg, h)
        else:
            y = L.mlp_apply(p["mlp"], cfg, h)
        return x + y, new_cache
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
    return x + y, new_cache


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
              pos: Optional[int] = None, enc_out=None
              ) -> Tuple[torch.Tensor, Optional[State]]:
    """``x`` through ``blocks`` in depth order (the reference's
    ``_stack_apply``); returns (x, the new state, or None without one)."""
    new_state: Optional[State] = [] if state is not None else None
    for i, (plan, block) in enumerate(zip(plans, blocks)):
        x, nc = block_apply(cfg, plan, block, x, mode=mode,
                            positions=positions,
                            cache=state[i] if state is not None else None,
                            pos=pos, enc_out=enc_out)
        if new_state is not None:
            new_state.append(nc)
    return x, new_state


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
               pos: Optional[int] = None) -> Tuple[torch.Tensor,
                                                   Optional[State]]:
        return run_stack(self.cfg, self.plans, self.blocks, x, mode=mode,
                         positions=positions, state=state, pos=pos)

    # -- forward ----------------------------------------------------------------
    def forward(self, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """Training-mode logits (B, F + T, V) of ``batch["tokens"]`` after
        a VLM batch's F patch embeddings (F = 0 without them)."""
        x = self._embed(batch)
        B, T = x.shape[:2]
        x, _ = self._stack(x, mode="train",
                           positions=seq_positions(B, T, 0, x.device),
                           state=None)
        x = L.norm_apply(self.final_norm, x, self.cfg.norm)
        return L.head_apply(self.embed, self.cfg, x)

    # -- serving ------------------------------------------------------------------
    def prefill(self, batch: Mapping[str, torch.Tensor], state: State
                ) -> Tuple[torch.Tensor, State]:
        """Run the prompt (after a VLM batch's patches) through the
        stack, filling F + T entries of the state.  Returns
        (last-position logits (B, V), new state)."""
        x = self._embed(batch)
        B, T = x.shape[:2]
        x, new_state = self._stack(
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
        x, new_state = self._stack(
            x, mode="decode",
            positions=seq_positions(x.shape[0], 1, pos, x.device),
            state=state, pos=pos)
        x = L.norm_apply(self.final_norm, x, self.cfg.norm)
        return L.head_apply(self.embed, self.cfg, x)[:, 0], new_state
