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
               moving a running fleet (the LM decode fleet's placement).

The reference's serving front-end, polling feed and turbulence sweeps are
not ported yet.
"""
from repro_torch.market.daemon import (DaemonStats, SelectionDaemon,
                                       Submission, Tick, metrics_record,
                                       synthetic_stream)
from repro_torch.market.feed import (FeedError, MarketEvent, PriceDelta,
                                     PriceFeed, SimulatedSpotFeed)
from repro_torch.market.replay import (JournalReplayer, RecordedPriceFeed,
                                       ReplayAudit, ReplayMismatch,
                                       ReplayedDecision, record_feed)
from repro_torch.market.migration import MigrationAdvice, should_migrate
from repro_torch.market.ticker import PriceTicker

__all__ = [
    "DaemonStats", "FeedError", "JournalReplayer", "MarketEvent",
    "MigrationAdvice", "PriceDelta", "PriceFeed", "PriceTicker",
    "RecordedPriceFeed", "ReplayAudit", "ReplayMismatch",
    "ReplayedDecision", "SelectionDaemon",
    "SimulatedSpotFeed", "Submission", "Tick", "metrics_record",
    "record_feed", "should_migrate", "synthetic_stream",
]
