"""PriceTicker: the loop that turns a feed into service price epochs.

One tick = one ``feed.poll`` batch pushed through
``SelectionService.reprice``: the service applies the deltas to its
:class:`~repro_torch.selector.PriceTable` (the single source of truth for cold
recomputes), bumps the price epoch, and refreshes every live ranking
through the incremental :class:`~repro_torch.selector.RankState` path
(DESIGN.md §6).  An empty batch is a no-op — no epoch bump, caches stay
hot — so quiet markets cost nothing.
"""
from __future__ import annotations

from typing import Dict, Hashable, Optional, Tuple

from repro_torch.obs import MetricsRegistry
from repro_torch.selector import PriceTable, SelectionService
from repro_torch.market.feed import FeedError, PriceDelta, PriceFeed


class PriceTicker:
    """Applies feed batches to a service's live price table."""

    def __init__(self, feed: PriceFeed, service: SelectionService,
                 metrics: Optional[MetricsRegistry] = None):
        if not isinstance(service.price_source, PriceTable):
            raise ValueError(
                "PriceTicker needs a service with a PriceTable price "
                "source (use PriceTable.from_catalog to snapshot one)")
        self.feed = feed
        self.service = service
        #: telemetry: defaults to the service's registry so tick spans
        #: land next to the reprice/serve counters (DESIGN.md §12).
        self.metrics = metrics if metrics is not None else service.metrics
        self._c_ticks = self.metrics.counter("tick.count")
        self._c_deltas = self.metrics.counter("tick.deltas")
        #: next tick index handed to ``feed.poll``.
        self.tick_count = 0
        self.deltas_applied = 0
        self.epochs_driven = 0

    def tick(self) -> Tuple[PriceDelta, ...]:
        """Poll one batch and apply it; returns the batch.

        A ``feed.poll`` that raises surfaces as a typed
        :class:`~repro_torch.market.FeedError` (original exception as
        ``__cause__``) **before** the tick index is consumed, so the
        next :meth:`tick` retries the same tick — prices stay at the
        last good epoch, never half-applied.  Errors from applying a
        successfully polled batch (``reprice``) are service
        misconfiguration and propagate untyped.
        """
        try:
            with self.metrics.span("tick.poll"):
                deltas = self.feed.poll(self.tick_count)
        except Exception as exc:
            raise FeedError(
                f"feed.poll failed at tick {self.tick_count}: "
                f"{type(exc).__name__}: {exc}", self.tick_count) from exc
        self.tick_count += 1
        self._c_ticks.inc()
        if deltas:
            table: Dict[Hashable, float] = {d.config_id: d.price
                                            for d in deltas}
            with self.metrics.span("tick.reprice"):
                self.service.reprice(table)
            self._c_deltas.inc(len(deltas))
            self.deltas_applied += len(deltas)
            self.epochs_driven += 1
        return deltas

    def run(self, ticks: int) -> int:
        """Drive ``ticks`` ticks; returns total deltas applied."""
        applied = 0
        for _ in range(ticks):
            applied += len(self.tick())
        return applied
