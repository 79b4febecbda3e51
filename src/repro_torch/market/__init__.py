"""The live price market on the port: feeds, the tick loop, the selection
daemon and journal replay (DESIGN.md §6, §8).

  feed      -- :class:`PriceFeed` / :class:`SimulatedSpotFeed`: a
               deterministic spot market emitting :class:`PriceDelta`
               batches per tick;
  ticker    -- :class:`PriceTicker`: applies each batch to the service's
               :class:`~repro_torch.selector.PriceTable` and drives price
               epochs through ``SelectionService.reprice``;
  daemon    -- :class:`SelectionDaemon`: consumes an interleaved stream
               of submissions and price ticks and journals every
               :class:`~repro_torch.selector.Decision` to versioned JSONL
               (the reference's journal format, byte for byte);
  replay    -- :class:`RecordedPriceFeed` / :func:`record_feed` and
               :class:`JournalReplayer`: audit a decision journal against
               cold re-ranks at each reconstructed price epoch;
  migration -- :func:`should_migrate`: the hysteresis advisor that gates
               moving a running fleet (the LM decode fleet's placement);
  frontend  -- :class:`ServeFrontend`: the concurrent serving layer —
               one tick thread owns the repricing (and every CUDA call)
               and publishes an immutable :class:`Snapshot` of per-
               selection top-k heads per tick, all from one ``select``
               launch on ``torch_fused``; N workers serve
               :class:`~repro_torch.selector.Decision`\\ s lock-free off
               the latest snapshot, with bounded queues, explicit shed,
               and worker-sharded journals merged into one deterministic,
               audit-clean journal (DESIGN.md §11);
  polling   -- :class:`PollingPriceFeed`: the live billing-API adapter —
               any ``poller(tick) -> payload`` callable behind the typed
               :class:`FeedError`/backoff path (DESIGN.md §15);
  turbulence-- adversarial market generators, the named
               :data:`TURBULENCE_PRESETS`, and the deviation-vs-turbulence
               sweep driver (:func:`run_point` / :func:`run_sweep`,
               DESIGN.md §15).
"""
from repro_torch.market.daemon import (DaemonStats, SelectionDaemon,
                                       Submission, Tick, metrics_record,
                                       synthetic_stream)
from repro_torch.market.feed import (FeedError, MarketEvent, PriceDelta,
                                     PriceFeed, SimulatedSpotFeed)
from repro_torch.market.frontend import (FrontendStats, ServeFrontend,
                                         Snapshot, SnapshotEntry,
                                         merge_shards)
from repro_torch.market.migration import MigrationAdvice, should_migrate
from repro_torch.market.polling import PollingPriceFeed
from repro_torch.market.replay import (JournalReplayer, RecordedPriceFeed,
                                       ReplayAudit, ReplayMismatch,
                                       ReplayedDecision, record_feed)
from repro_torch.market.ticker import PriceTicker
from repro_torch.market.turbulence import (LaggedPriceFeed,
                                           TURBULENCE_PRESETS,
                                           TurbulencePreset,
                                           TurbulentMarket,
                                           correlated_spike_events,
                                           eviction_storm_events,
                                           flash_crash_events, make_market,
                                           run_point, run_sweep)

__all__ = [
    "DaemonStats", "FeedError", "FrontendStats", "JournalReplayer",
    "LaggedPriceFeed", "MarketEvent", "MigrationAdvice", "PollingPriceFeed",
    "PriceDelta", "PriceFeed", "PriceTicker", "RecordedPriceFeed",
    "ReplayAudit", "ReplayMismatch", "ReplayedDecision", "SelectionDaemon",
    "ServeFrontend", "SimulatedSpotFeed", "Snapshot", "SnapshotEntry",
    "Submission", "TURBULENCE_PRESETS", "Tick", "TurbulencePreset",
    "TurbulentMarket", "correlated_spike_events", "eviction_storm_events",
    "flash_crash_events", "make_market", "merge_shards", "metrics_record",
    "record_feed", "run_point", "run_sweep", "should_migrate",
    "synthetic_stream",
]
