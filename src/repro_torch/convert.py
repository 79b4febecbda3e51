"""Carry state across from the reference package.

The port reads what the reference writes, without importing it:

* :func:`store_from_reference` — a profiling store as the reference's
  ``ProfilingStore.dump_jsonl`` writes it (the JSONL format is shared, so
  this is the port's own loader);
* :func:`fleet_state_from_reference` — a reference fused fleet
  (``PallasBatchedRankState``), handed over as numpy arrays, rebuilt as a
  :class:`~repro_torch.selector.TorchFusedRankState` that continues the
  same price stream mid-tick: its row minima and accumulators are taken
  as they are, not recomputed.

Decision journals need no converter: both packages write and read the
same ``repro.market.decision-journal`` v2 format.
"""
from __future__ import annotations

from typing import Hashable, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.selector.fused_rank import TorchFusedRankState, \
    resolve_device
from repro_torch.selector.rank import _position_index
from repro_torch.selector.store import ProfilingStore

__all__ = ["FLEET_ARRAYS", "fleet_state_from_reference",
           "store_from_reference"]

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
