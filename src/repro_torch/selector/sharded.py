"""The fleet with its config axis split across shards (the
``torch_sharded`` backend).

:class:`TorchShardedRankState` is the counterpart of the reference's
``ShardedBatchedRankState`` (DESIGN.md §13): catalogs of 100k+ configs
whose C-extent tensors need not fit one device.  Shard d holds the
contiguous block of global columns ``[d * C_loc, min((d + 1) * C_loc,
C))`` with ``C_loc = ceil(C / D)`` on its own device: ``hours`` and
``mask`` (J x C_d), the prices (1 x C_d), the member scores and finite
flags (S x C_d), and its own copy of the replicated member row masks
(S x J) and row minima (J x 1).  The host keeps the member counts and the
float32 price mirror.

One process drives every shard (the reference drives its devices from one
process through ``shard_map``), so the service, the daemon and the
front-end above it stay single processes.  A tick is the fused tick split
in two, with the reference's two collectives turned into an exact
combine on the host's orders:

1. the tick's (column, price) pairs are routed to their owners (owner =
   column // C_loc, local column = column - the owner's first column);
2. each shard scatters its pairs (``scatter``, an empty batch included)
   and takes its partial row minima (``rowmin``);
3. the elementwise min of the shards' (J, 1) minima, on the first shard's
   device, is copied to every shard — the reference's ``pmin``; the
   count of rows whose minimum changed is its ``psum`` of handoff flags;
4. each shard folds its member scores (``fold``) against the combined
   minima.  Every shard folds, changed or not: a moved row minimum
   changes the norms of every column.

A min of minima is the min of the row, so the combined minima are bitwise
those of one ``rowmin`` over all C; the fold is column-local with each
column's sums in an order fixed by J alone, so a split tick gives the bits
of the whole one on the same inputs.  Only a member's first accumulators,
a matmul at the shard's width, may round differently from the unsplit
fleet's; the score contract covers it.

**Serving**: each shard runs one ``select`` over the requested members'
rows at depth ``min(k, C_d)``; the local indices are lifted to global
ones by the shard's first column, and the host merges the candidates by
``(score, global index)``.  Within a shard the kernel's order is already
the global (score, catalog position) order, so the merged head equals
``ranking(key)[:k]``, ties included.

Importing the module touches no device.
"""
from __future__ import annotations

import numbers
from typing import (Dict, Hashable, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from repro_torch.kernels.rank_delta import (fold_scores, row_minima,
                                            scatter_prices, select_heads)
from repro_torch.obs import MetricsRegistry, maybe_span
from repro_torch.selector.fused_rank import (Deltas, FleetMembers,
                                             _cold_row_best, _grown,
                                             _member_rows, _member_scores,
                                             _upload, resolve_device)
from repro_torch.selector.rank import (SCORE_CONTRACTS, RankedConfig,
                                       _canonicalize_universe, _check_k,
                                       _position_index)

__all__ = ["MERGE_SPAN", "STEP_SPAN", "TorchShardedRankState",
           "resolve_devices"]

#: span names the sharded tick and serving emit when a MetricsRegistry is
#: wired in (the reference's names)
STEP_SPAN = "shard.step"
MERGE_SPAN = "shard.merge"

Devices = Union[None, int, str, torch.device,
                Sequence[Union[str, torch.device]]]


def resolve_devices(devices: Devices = None) -> Tuple[torch.device, ...]:
    """The shards' devices, one shard each.  ``None`` or ``"cuda"``:
    every local CUDA device (the reference's default, every local
    device).  An int n: ``cuda:0`` to ``cuda:n-1``.  One device (a string
    or :class:`torch.device`): one shard there.  A sequence of devices:
    one shard each, repeats allowed (several shards on one card, or on
    the CPU, where the kernels' plain versions run).  CUDA asked for with
    none present raises :class:`BackendUnavailableError`; a count or an
    index outside the local devices raises ``ValueError``."""
    if devices is None or (isinstance(devices, (str, torch.device)) and
                           torch.device(devices) == torch.device("cuda")):
        resolve_device("cuda")
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    if isinstance(devices, numbers.Integral):
        n = int(devices)
        if n >= 1:
            resolve_device("cuda")
        avail = torch.cuda.device_count()
        if not 1 <= n <= avail:
            raise ValueError(f"devices={devices!r} not in [1, {avail}] "
                             f"(local CUDA device count)")
        return tuple(torch.device("cuda", i) for i in range(n))
    if isinstance(devices, (str, torch.device)):
        devices = [devices]
    out = []
    for d in devices:
        d = resolve_device(d)
        if d.type == "cuda":
            if d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            if d.index >= torch.cuda.device_count():
                raise ValueError(f"devices= names {d}, but there are "
                                 f"{torch.cuda.device_count()} local CUDA "
                                 f"devices")
        out.append(d)
    if not out:
        raise ValueError("devices= names no device")
    return tuple(out)


class _Shard:
    """One block of the config axis, global columns ``[lo, hi)``, and its
    tensors on ``device``."""

    __slots__ = ("index", "device", "lo", "hi", "hours", "mask", "prices",
                 "row_best", "row_masks", "scores", "finite")

    def __init__(self, index: int, device: torch.device, lo: int, hi: int):
        self.index, self.device, self.lo, self.hi = index, device, lo, hi

    @property
    def width(self) -> int:
        return self.hi - self.lo


class TorchShardedRankState(FleetMembers):
    """:class:`~repro_torch.selector.fused_rank.TorchFusedRankState` with
    its config axis split across shards, one a device — one tick refreshes
    every member on every shard (one ``scatter``, one ``rowmin`` and one
    ``fold`` a shard, counted as one dispatch, as the reference counts its
    one collective dispatch).

    The member API is the fused fleet's: :meth:`add_state` /
    :meth:`retire_state` over slots with doubling capacity and slot
    reuse, :meth:`reprice` applying one delta batch fleet-wide,
    :meth:`ranking` / :meth:`top_k` / :meth:`heads` / :meth:`winner`
    serving per member.  ``devices`` is read by :func:`resolve_devices`;
    ``n_devices`` is the number of shards asked for.  A shard left with
    no column (C < D x C_loc) holds nothing and takes no launch.

    **Contract** (:data:`SCORE_CONTRACTS` ``["torch_sharded"]``): the
    ``torch_fused`` float32 envelope — the combine is exact, so sharding
    relocates arithmetic without changing it.
    """

    backend = "torch_sharded"
    contract = SCORE_CONTRACTS["torch_sharded"]

    def __init__(self, hours: np.ndarray, mask: np.ndarray,
                 prices: np.ndarray, config_ids: Sequence[Hashable],
                 job_ids: Optional[Sequence[Hashable]] = None,
                 capacity: Optional[int] = None,
                 devices: Devices = None,
                 metrics: Optional[MetricsRegistry] = None):
        self.devices = resolve_devices(devices)
        self.n_devices = len(self.devices)
        self.config_ids = list(config_ids)
        self.job_ids = list(job_ids) if job_ids is not None else None
        hours, mask, prices = _canonicalize_universe(hours, mask, prices,
                                                     self.job_ids)
        self._pos = _position_index(self.config_ids)
        host_prices = np.asarray(prices, dtype=np.float32).reshape(1, -1)
        self._init_host(hours, mask, host_prices, metrics)
        n_cfgs = len(self.config_ids)
        self._c_loc = -(-n_cfgs // self.n_devices)
        hours32 = hours.astype(np.float32)
        self._shards: List[_Shard] = []
        for d, dev in enumerate(self.devices):
            lo, hi = d * self._c_loc, min((d + 1) * self._c_loc, n_cfgs)
            if lo >= hi:
                continue
            sh = _Shard(d, dev, lo, hi)
            sh.hours = _upload(hours32[:, lo:hi], dev)
            sh.mask = _upload(mask[:, lo:hi], dev)
            sh.prices = _upload(host_prices[:, lo:hi], dev)
            self._shards.append(sh)
        self._set_row_best(self._combine([
            _cold_row_best(sh.hours, sh.mask, sh.prices)
            for sh in self._shards]))
        cap = self._CAPACITY_BASE if capacity is None else max(1, capacity)
        self._init_slots(cap)
        for sh in self._shards:
            sh.row_masks = torch.zeros((cap, self._n_jobs),
                                       dtype=torch.float32, device=sh.device)
            sh.scores = torch.zeros((cap, sh.width), dtype=torch.float32,
                                    device=sh.device)
            sh.finite = torch.zeros((cap, sh.width), dtype=torch.bool,
                                    device=sh.device)

    def _grow_tensors(self, old: int, cap: int) -> None:
        for sh in self._shards:
            sh.row_masks = _grown(sh.row_masks, old, cap)
            sh.scores = _grown(sh.scores, old, cap)
            sh.finite = _grown(sh.finite, old, cap)

    # -- the combine ------------------------------------------------------------
    def _combine(self, partial: Sequence[torch.Tensor]) -> torch.Tensor:
        """The elementwise min of the shards' (J, 1) row minima, on the
        first shard's device (exact: the min of the whole row)."""
        first = self._shards[0].device
        row_best = partial[0]
        for part in partial[1:]:
            row_best = torch.minimum(row_best, part.to(first))
        return row_best

    def _replicas(self, row_best: torch.Tensor
                  ) -> Dict[torch.device, torch.Tensor]:
        """``row_best`` on every shard's device, one copy a device."""
        return {dev: row_best.to(dev)
                for dev in {sh.device for sh in self._shards}}

    def _set_row_best(self, row_best: torch.Tensor) -> None:
        copies = self._replicas(row_best)
        for sh in self._shards:
            sh.row_best = copies[sh.device]

    # -- member management ----------------------------------------------------
    def add_state(self, key: Hashable, *,
                  rows: Optional[Sequence[int]] = None,
                  jobs: Optional[Sequence[Hashable]] = None) -> None:
        """Register a member ranking over a subset of the job axis; each
        shard seeds its accumulators from its implied current norm, so a
        member added mid-stream is in sync with every tick so far.
        Retired slots are reused before capacity grows."""
        slot, row_mask, counts = self._new_member(key, rows, jobs)
        finite = counts > 0
        for sh in self._shards:
            d_row = _upload(row_mask, sh.device)
            sh.row_masks[slot] = d_row
            sh.scores[slot] = _member_scores(sh.hours, sh.mask, sh.prices,
                                             sh.row_best, d_row)
            sh.finite[slot] = _upload(finite[sh.lo:sh.hi], sh.device)
        self._slots[key] = slot

    def retire_state(self, key: Hashable) -> None:
        """Drop a member: its slot is zeroed on every shard and reused by
        the next :meth:`add_state`; serving it afterwards raises
        :class:`~repro_torch.selector.NothingRankableError`."""
        slot = self._drop_member(key)
        for sh in self._shards:
            sh.row_masks[slot] = 0.0
            sh.scores[slot] = 0.0
            sh.finite[slot] = False

    # -- the tick -------------------------------------------------------------
    def scores(self, key: Hashable) -> np.ndarray:
        """A member's score accumulators on the host, the shards' blocks
        in catalog order (float64 lift)."""
        slot = self._slot_of(key)
        return torch.cat([sh.scores[slot].cpu() for sh in self._shards]
                         ).numpy().astype(np.float64)

    def reprice(self, deltas: Deltas) -> int:
        """Apply ``{config_id: new $/h}`` deltas to every shard and refresh
        every member (one dispatch); returns #rows whose masked row
        minimum handed off (read back to the host once, after every
        shard's fold is queued)."""
        pairs = self._pairs(deltas)
        if pairs is None:
            return 0
        cols, prices = pairs
        with maybe_span(self._metrics, STEP_SPAN):
            owner = cols // self._c_loc
            halves = []
            for sh in self._shards:
                mine = owner == sh.index
                newp, changed = scatter_prices(cols[mine] - sh.lo,
                                               prices[mine], sh.prices)
                partial, _ = row_minima(sh.hours, sh.mask, newp,
                                        sh.row_best)
                halves.append((newp, changed, partial))
            row_best = self._combine([h[2] for h in halves])
            moved = (row_best != self._shards[0].row_best).sum()
            copies = self._replicas(row_best)
            for sh, (newp, changed, _) in zip(self._shards, halves):
                rb_new = copies[sh.device]
                sh.scores = fold_scores(sh.hours, sh.mask, sh.prices, newp,
                                        changed, sh.row_best, rb_new,
                                        sh.row_masks, sh.scores)
                sh.prices, sh.row_best = newp, rb_new
            moved = int(moved.item())
        self._commit(cols, prices)
        return moved

    # -- per-member serving -------------------------------------------------------
    def heads(self, keys: Sequence[Hashable], k: int
              ) -> List[List[RankedConfig]]:
        """Several members' heads from ONE ``select`` launch a shard over
        the requested members' rows (a view where their slots are
        contiguous, else one gather), merged on the host by (score,
        global index).  Element ``i`` is ``top_k(keys[i], k)`` and equals
        ``ranking(keys[i])[:k]``; ``k`` is clamped to C first, and each
        shard's depth to its width, which still leaves at least ``k``
        candidates."""
        slots = [self._slot_of(key) for key in keys]
        k = _check_k(k, len(self.config_ids))
        if not slots:
            return []
        rows = sorted(set(slots))
        local = [select_heads(*_member_rows(sh.scores, sh.finite, rows),
                              min(k, sh.width)) for sh in self._shards]
        with maybe_span(self._metrics, MERGE_SPAN):
            gidx = np.concatenate([ti.cpu().numpy() + sh.lo for sh, (ti, _)
                                   in zip(self._shards, local)], axis=1)
            vals = np.concatenate([tv.cpu().numpy() for _, tv in local],
                                  axis=1).astype(np.float64)
            at = {s: r for r, s in enumerate(rows)}
            out = []
            for s in slots:
                r = at[s]
                order = np.lexsort((gidx[r], vals[r]))[:k]
                out.append(self._head(s, gidx[r, order], vals[r, order]))
        return out
