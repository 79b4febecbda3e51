"""Substrate-agnostic resource selection on the port (the Flora pipeline).

  catalog    -- :class:`ResourceCatalog` implementations and the live
                :class:`PriceTable`;
  store      -- :class:`ProfilingStore`: dense (job x config) runtime
                matrices with the reference's JSONL format;
  rank       -- the float64 numpy ranking (:func:`rank_dense`,
                :class:`RankState`) and the :class:`ScoreContract` table;
  fused_rank -- :class:`TorchFusedRankState`: the fleet of live rankings
                whose tick runs the fused CUDA reprice kernels;
  sharded    -- :class:`TorchShardedRankState`: that fleet with its
                config axis split across devices, one shard each;
  service    -- :class:`SelectionService`: ``submit(job) -> Decision``
                with ranking caches and ``reprice(deltas)``.
"""
from repro_torch.selector.catalog import (BaseCatalog, GcpVmCatalog,
                                          IdentityCatalog, PriceTable,
                                          ResourceCatalog, TpuSliceCatalog)
from repro_torch.selector.rank import (BACKENDS, FLEET_BACKENDS,
                                       BackendUnavailableError,
                                       NothingRankableError, RankedConfig,
                                       RankState, SCORE_CONTRACTS,
                                       ScoreContract, rank_dense, rank_pairs,
                                       score_contract)
from repro_torch.selector.fused_rank import TorchFusedRankState
from repro_torch.selector.sharded import TorchShardedRankState
from repro_torch.selector.store import ProfilingStore
from repro_torch.selector.service import Decision, SelectionService

__all__ = [
    "BACKENDS", "BackendUnavailableError", "BaseCatalog", "Decision",
    "FLEET_BACKENDS", "GcpVmCatalog", "IdentityCatalog",
    "NothingRankableError", "PriceTable", "ProfilingStore", "RankState",
    "RankedConfig", "ResourceCatalog", "SCORE_CONTRACTS", "ScoreContract",
    "SelectionService", "TorchFusedRankState", "TorchShardedRankState",
    "TpuSliceCatalog",
    "rank_dense", "rank_pairs", "score_contract",
]
