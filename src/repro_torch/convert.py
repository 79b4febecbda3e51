"""Carry state across from the reference package.

The port reads what the reference writes, without importing it:

* :func:`store_from_reference` — a profiling store as the reference's
  ``ProfilingStore.dump_jsonl`` writes it (the JSONL format is shared, so
  this is the port's own loader);
* :func:`fleet_state_from_reference` — a reference fused fleet
  (``PallasBatchedRankState``), handed over as numpy arrays, rebuilt as a
  :class:`~repro_torch.selector.TorchFusedRankState` that continues the
  same price stream mid-tick: its row minima and accumulators are taken
  as they are, not recomputed;
* :func:`model_config_from_reference` — a
  :class:`~repro_torch.models.ModelConfig` from ``dataclasses.asdict`` of
  a reference config;
* :func:`lm_params_from_reference` — the reference ``LM``'s parameter
  tree, handed over as numpy arrays, loaded into the port's
  :class:`~repro_torch.models.LM`; :func:`lm_state_from_reference` does
  the same for a decode state.  The reference stacks each layer cycle's
  leaves along a leading ``(n_cycles,)`` axis (``{"cycles": {"b{i}":
  ...}, "rem": {"r{j}": ...}}``); both are unstacked into the port's one
  dict per layer.  Leaf layouts stay the reference's (``wq`` (d, H, D),
  ``wo`` (H, D, d), ...), a MoE layer's ``moe`` group with its nested
  ``shared`` expert included.  The reference stores float32 weights and casts
  each use to the compute dtype; the port stores each weight in the dtype
  its uses read, which gives the same values;
* :func:`encdec_params_from_reference` and
  :func:`encdec_state_from_reference` — the same for the reference's
  ``EncDec`` (its ``enc_stack`` and ``dec_stack`` unstacked into the
  port's ``enc_layers`` and ``dec_layers``);
* :func:`adamw_state_from_reference` and
  :func:`adafactor_state_from_reference` — a reference optimizer state
  (``AdamW``'s moments unstacked per layer and keyed by the port's
  parameter names; Adafactor's per-leaf statistics kept whole, in the
  reference leaves that :meth:`LM.param_groups` reproduces), so that a
  port step taken after a reference step continues the reference's run.

Decision journals need no converter: both packages write and read the
same ``repro.market.decision-journal`` v2 format.
"""
from __future__ import annotations

import dataclasses
import math
from typing import (Any, Dict, Hashable, List, Mapping, Optional, Sequence,
                    Union)

import numpy as np
import torch

from repro_torch.models.encdec import EncDec, encoder_config
from repro_torch.models.encdec import model_groups as encdec_groups
from repro_torch.models.lm import LM, block_cache_specs, layer_plans
from repro_torch.models.lm import model_groups as lm_groups
from repro_torch.models.types import ModelConfig
from repro_torch.selector.fused_rank import TorchFusedRankState, \
    resolve_device
from repro_torch.selector.rank import _position_index
from repro_torch.selector.store import ProfilingStore

__all__ = ["FLEET_ARRAYS", "adafactor_state_from_reference",
           "adamw_state_from_reference", "encdec_params_from_reference",
           "encdec_state_from_reference", "encdec_tree_from_reference",
           "fleet_state_from_reference",
           "lm_params_from_reference", "lm_state_from_reference",
           "lm_tree_from_reference",
           "model_config_from_reference", "store_from_reference"]

#: the reference fleet's attributes a conversion reads, as numpy arrays
FLEET_ARRAYS = ("d_hours", "d_mask", "d_prices", "d_row_best",
                "d_row_masks", "d_scores", "_d_finite", "_counts")


def store_from_reference(jsonl: str) -> ProfilingStore:
    """A store from the reference's ``dump_jsonl`` text."""
    return ProfilingStore.loads_jsonl(jsonl)


def fleet_state_from_reference(
        arrays: Mapping[str, np.ndarray], config_ids: Sequence[Hashable],
        job_ids: Optional[Sequence[Hashable]], n_true_jobs: int,
        slots: Mapping[Hashable, int], *,
        device: Union[str, torch.device] = "cuda") -> TorchFusedRankState:
    """Rebuild a reference fused fleet on the port.

    ``arrays`` holds the reference state's :data:`FLEET_ARRAYS` as numpy
    (``np.asarray`` of each); ``n_true_jobs`` is its unpadded job count
    (the reference pads the job axis to its TPU tile with masked rows,
    which are dropped here); ``slots`` maps each live member key to its
    slot.  The returned state continues the stream: the next tick applies
    to exactly the prices, row minima and accumulators handed over.
    """
    missing = [k for k in FLEET_ARRAYS if k not in arrays]
    if missing:
        raise ValueError(f"missing fleet arrays: {missing}")
    a = {k: np.asarray(arrays[k]) for k in FLEET_ARRAYS}
    J, C = n_true_jobs, len(config_ids)
    if a["d_hours"].shape[0] < J or a["d_hours"].shape[1] != C:
        raise ValueError(f"hours {a['d_hours'].shape} do not fit "
                         f"{J} jobs x {C} configs")
    pad_mask = a["d_mask"][J:]
    if pad_mask.any():
        raise ValueError("rows beyond n_true_jobs are profiled: they are "
                         "not padding")
    cap = a["d_scores"].shape[0]
    if sorted(slots.values()) != sorted(set(slots.values())) or \
            any(not 0 <= s < cap for s in slots.values()):
        raise ValueError("member slots must be distinct and within the "
                         "reference capacity")
    state = TorchFusedRankState.__new__(TorchFusedRankState)
    state.device = resolve_device(device)
    state.config_ids = list(config_ids)
    state.job_ids = list(job_ids) if job_ids is not None else None
    state._pos = _position_index(state.config_ids)
    host_prices = a["d_prices"].astype(np.float32).reshape(1, C)
    state._init_universe(a["d_hours"][:J].astype(np.float64),
                         a["d_mask"][:J].astype(bool), host_prices, None)
    state._init_members(cap)

    def upload(x, dtype):
        return torch.tensor(np.ascontiguousarray(x), dtype=dtype,
                            device=state.device)

    state.d_row_best = upload(a["d_row_best"][:J].reshape(J, 1),
                              torch.float32)
    state.d_row_masks = upload(a["d_row_masks"][:, :J], torch.float32)
    state.d_scores = upload(a["d_scores"], torch.float32)
    state._d_finite = upload(a["_d_finite"], torch.bool)
    state._counts = a["_counts"].astype(np.int64).copy()
    state._slots = dict(slots)
    used = set(slots.values())
    state._free = [s for s in range(cap - 1, -1, -1) if s not in used]
    return state


# --- the LM substrate ---------------------------------------------------------

def model_config_from_reference(d: Mapping[str, Any]) -> ModelConfig:
    """A port config from ``dataclasses.asdict`` of a reference
    ``ModelConfig`` (the same fields; tuples may arrive as lists)."""
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    unknown = sorted(set(d) - names)
    if unknown:
        raise ValueError(f"fields the port's ModelConfig lacks: {unknown}")
    kw = dict(d)
    if "block_pattern" in kw:
        kw["block_pattern"] = tuple(kw["block_pattern"])
    return ModelConfig(**kw)


def _map_leaves(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def _unstack_layers(cfg: ModelConfig, stack: Mapping[str, Any]
                   ) -> List[Dict[str, Any]]:
    """The reference's cycle-stacked layer tree as one dict per layer, in
    depth order: cycle c's block i is layer ``c * cycle + i``, and the
    remainder layers follow."""
    cyc = math.lcm(len(cfg.block_pattern),
                   cfg.moe_period if cfg.num_experts else 1)
    n_cycles, rem = divmod(cfg.num_layers, cyc)
    cycles = stack.get("cycles", {}) or {}
    rems = stack.get("rem", {}) or {}
    if (n_cycles and len(cycles) != cyc) or len(rems) != rem:
        raise ValueError(f"{cfg.name}: a stack of {len(cycles)} cycle "
                         f"blocks and {len(rems)} remainder layers does not "
                         f"hold {cfg.num_layers} layers in cycles of {cyc}")
    layers = []
    for c in range(n_cycles):
        for i in range(cyc):
            layers.append(_map_leaves(lambda a, c=c: np.asarray(a)[c],
                                      cycles[f"b{i}"]))
    for j in range(rem):
        layers.append(_map_leaves(np.asarray, rems[f"r{j}"]))
    return layers


def lm_params_from_reference(cfg: ModelConfig, params: Mapping[str, Any], *,
                             device: Union[str, torch.device] = "cuda"
                             ) -> LM:
    """The reference ``LM.init`` tree (``{"embed", "final_norm",
    "stack"}``, leaves as numpy arrays) loaded into a port :class:`LM` on
    ``device``."""
    return LM(cfg, device=device, params=lm_tree_from_reference(cfg,
                                                                params))


def lm_tree_from_reference(cfg: ModelConfig, params: Mapping[str, Any]
                           ) -> Dict[str, Any]:
    """The reference ``LM.init`` tree as the port's parameter tree
    (``{"embed", "final_norm", "layers": [per-layer dicts]}``, numpy
    leaves), which ``LM(params=)`` loads and
    :func:`repro_torch.sharding.place.place_tree` places on a mesh."""
    return {"embed": _map_leaves(np.asarray, params["embed"]),
            "final_norm": _map_leaves(np.asarray, params["final_norm"]),
            "layers": _unstack_layers(cfg, params["stack"])}


def lm_state_from_reference(cfg: ModelConfig, state: Mapping[str, Any], *,
                            device: Union[str, torch.device] = "cuda"
                            ) -> List[Dict[str, torch.Tensor]]:
    """A reference decode state (``LM.init_state`` / ``prefill``'s
    stacked tree, leaves as numpy arrays) as the port's per-layer list.
    Each leaf takes the dtype of the port's state spec: the reference's
    bf16 leaves arrive as float32 numpy (numpy has no bf16) and are cast
    back to the compute dtype; the WKV state and RG-LRU's ``h`` stay
    float32."""
    return _state_from_reference(cfg, layer_plans(cfg), state, device)


def encdec_params_from_reference(cfg: ModelConfig,
                                 params: Mapping[str, Any], *,
                                 device: Union[str, torch.device] = "cuda"
                                 ) -> EncDec:
    """The reference ``EncDec.init`` tree (``{"embed", "enc_stack",
    "enc_norm", "dec_stack", "final_norm"}``, leaves as numpy arrays)
    loaded into a port :class:`EncDec` on ``device``.  The encoder stack
    is unstacked under the encoder's config (``num_layers`` the encoder's
    depth), as the reference builds it, and the decoder stack under
    ``cfg``."""
    return EncDec(cfg, device=device,
                  params=encdec_tree_from_reference(cfg, params))


def encdec_tree_from_reference(cfg: ModelConfig, params: Mapping[str, Any]
                               ) -> Dict[str, Any]:
    """The reference ``EncDec.init`` tree as the port's parameter tree
    (``{"embed", "enc_layers", "enc_norm", "dec_layers", "final_norm"}``,
    numpy leaves), which ``EncDec(params=)`` loads and
    :func:`repro_torch.sharding.place.place_tree` places on a mesh."""
    return {"embed": _map_leaves(np.asarray, params["embed"]),
            "enc_layers": _unstack_layers(encoder_config(cfg),
                                          params["enc_stack"]),
            "enc_norm": _map_leaves(np.asarray, params["enc_norm"]),
            "dec_layers": _unstack_layers(cfg, params["dec_stack"]),
            "final_norm": _map_leaves(np.asarray, params["final_norm"])}


def encdec_state_from_reference(cfg: ModelConfig, state: Mapping[str, Any],
                                *, device: Union[str, torch.device] = "cuda"
                                ) -> List[Dict[str, torch.Tensor]]:
    """A reference ``EncDec`` decode state (``init_state`` / ``prefill``'s
    stacked tree, leaves as numpy arrays) as the port's per-layer list:
    each decoder layer's ``k``, ``v`` and cross cache ``xk``, ``xv``, each
    leaf in the dtype of the port's state spec (the compute dtype)."""
    return _state_from_reference(cfg, layer_plans(cfg, cross=True), state,
                                 device)


def _state_from_reference(cfg, plans, state, device):
    dev = resolve_device(device)
    out = []
    for plan, layer in zip(plans, _unstack_layers(cfg, state)):
        specs = block_cache_specs(cfg, plan, 1, 1, 1)
        out.append({k: torch.tensor(np.asarray(v)).to(
            device=dev, dtype=specs[k].storage_dtype(cfg.compute_dtype))
            for k, v in layer.items()})
    return out


# --- optimizer state ------------------------------------------------------------

def _param_groups(cfg: ModelConfig):
    """The port model's ``param_groups()`` for ``cfg``."""
    return (encdec_groups if cfg.is_encdec else lm_groups)(cfg)


def _leaf_at(tree: Mapping, path) -> np.ndarray:
    for key in path:
        tree = tree[key]
    return np.asarray(tree, dtype=np.float32)


def adamw_state_from_reference(cfg: ModelConfig, opt_state: Mapping, *,
                               moment_dtype: torch.dtype = torch.float32,
                               device: Union[str, torch.device] = "cuda"
                               ) -> Dict[str, Any]:
    """A reference ``AdamW`` state (``{"m", "v", "count"}``, the moments
    shaped like the reference's parameter tree, leaves numpy) as the
    port's: each moment unstacked per layer as
    :func:`lm_params_from_reference` unstacks the weights and keyed by the
    port's parameter name, in ``moment_dtype``, and the int32 count."""
    dev = resolve_device(device)
    out: Dict[str, Any] = {"m": {}, "v": {}}
    for path, members in _param_groups(cfg):
        for key in ("m", "v"):
            leaf = _leaf_at(opt_state[key], path)
            for i, name in enumerate(members):
                a = leaf[i] if path[1:2] == ("cycles",) else leaf
                out[key][name] = torch.tensor(a).to(device=dev,
                                                    dtype=moment_dtype)
    out["count"] = torch.tensor(int(np.asarray(opt_state["count"])),
                                dtype=torch.int32, device=dev)
    return out


def adafactor_state_from_reference(cfg: ModelConfig, opt_state: Mapping, *,
                                   device: Union[str, torch.device] = "cuda"
                                   ) -> Dict[str, Any]:
    """A reference ``Adafactor`` state (``{"f": [per-leaf dicts], "count"}``
    in the reference's flatten order, leaves numpy) as the port's: the
    port's Adafactor keeps one statistics dict a reference leaf, in the
    same order (the model's ``param_groups()``), so each is taken whole."""
    dev = resolve_device(device)
    groups = _param_groups(cfg)
    f = opt_state["f"]
    if len(f) != len(groups):
        raise ValueError(f"{len(f)} reference leaves, the port groups "
                         f"{len(groups)}")
    return {"f": [{k: torch.tensor(np.asarray(v, dtype=np.float32),
                                   device=dev) for k, v in leaf.items()}
                  for leaf in f],
            "count": torch.tensor(int(np.asarray(opt_state["count"])),
                                  dtype=torch.int32, device=dev)}
