"""repro_torch.obs — unified low-overhead telemetry (DESIGN.md §12).

One :class:`MetricsRegistry` carries every counter, gauge and span
histogram in the system — market ticks, serving workers, training steps
and decode engines all export through the same three paths:

  * :meth:`MetricsRegistry.render` — Prometheus text or JSON dump;
  * periodic additive ``"metrics"`` journal records (schema-v2
    amendment, DESIGN.md §8) that :class:`repro_torch.market.JournalReplayer`
    accounts and recovers tick-latency percentiles from;
  * the ``BENCH_obs.json`` overhead-gate artifact
    (``benchmarks/obs_bench.py``).

Metrics are sharded per writer thread with single-writer cells, so the
serve hot path never takes a lock; merges are exact integer sums and
therefore deterministic regardless of shard count (the property pinned
by ``tests/test_obs.py``).
"""
from repro_torch.obs.clock import FakeClock, SYSTEM_CLOCK
from repro_torch.obs.registry import (Counter, DEFAULT_LATENCY_BUCKETS, Gauge,
                                Histogram, MetricsRegistry, NULL_SPAN,
                                histogram_quantile, maybe_span)

#: Histogram fed by the whole-tick span; the name the journal metrics
#: records (and ReplayAudit.tick_latency) key their percentiles on.
TICK_SPAN = "tick.total"

#: Histogram fed by one turbulence-sweep point (daemon run + journal
#: audit + dynamic eval, DESIGN.md §15); the ``sweep.points`` /
#: ``sweep.decisions`` counters ride the same registry.
SWEEP_SPAN = "sweep.point"

__all__ = [
    "Counter", "DEFAULT_LATENCY_BUCKETS", "FakeClock", "Gauge", "Histogram",
    "MetricsRegistry", "NULL_SPAN", "SWEEP_SPAN", "SYSTEM_CLOCK",
    "TICK_SPAN", "histogram_quantile", "maybe_span",
]
