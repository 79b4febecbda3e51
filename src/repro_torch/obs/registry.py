"""Lock-free sharded metrics: counters, gauges, histograms, spans.

The registry follows the same single-writer discipline as the serving
front-end's worker shards (DESIGN.md §11/§12): every metric is a bag of
*cells*, one per writer thread, created lazily on first write.  A cell
is only ever mutated by the thread that owns it, so the hot path is a
plain attribute increment — no locks, no atomics, no contention.  Reads
merge all cells; because counter values and histogram bucket counts are
integers (histogram sums are quantized to integer nanoseconds before
accumulation), the merge is exact integer addition and therefore
independent of shard count and merge order: recording the same samples
through 1 cell or N cells renders byte-identical output.

Locks appear in exactly two cold places: metric/cell creation (once per
name per thread) and merge-on-read snapshots (which copy the cell list
under the lock, then sum without it).
"""
from __future__ import annotations

import json
import re
import threading
from bisect import bisect_left
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.obs.clock import SYSTEM_CLOCK

_NAME_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_.]*$")

#: Default span buckets: geometric ~1 us .. 10 s upper bounds (seconds).
#: The implicit +Inf overflow bucket is always appended.
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    1e-6, 2.5e-6, 5e-6,
    1e-5, 2.5e-5, 5e-5,
    1e-4, 2.5e-4, 5e-4,
    1e-3, 2.5e-3, 5e-3,
    1e-2, 2.5e-2, 5e-2,
    1e-1, 2.5e-1, 5e-1,
    1.0, 2.5, 5.0, 10.0,
)


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name):
        raise ValueError(f"invalid metric name {name!r}")
    return name


def _prom_name(name: str) -> str:
    return name.replace(".", "_")


class _CounterCell:
    """Single-writer tally; ``n`` is mutated only by the owning thread."""

    __slots__ = ("n",)

    def __init__(self) -> None:
        self.n = 0

    def inc(self, n: int = 1) -> None:
        self.n += n


class _HistCell:
    """Single-writer histogram shard: integer bucket counts + ns sum."""

    __slots__ = ("counts", "total_ns", "_bounds")

    def __init__(self, bounds: Tuple[float, ...]) -> None:
        self.counts = [0] * (len(bounds) + 1)
        self.total_ns = 0
        self._bounds = bounds

    def observe(self, v: float) -> None:
        # ``le`` semantics: v lands in the first bucket whose upper
        # bound is >= v; beyond the last bound it lands in +Inf.
        self.counts[bisect_left(self._bounds, v)] += 1
        self.total_ns += int(round(v * 1e9))


class _Sharded:
    """Cell bag shared by Counter/Histogram: lock-free get, locked create."""

    def __init__(self) -> None:
        self._cells: Dict[int, object] = {}
        self._lock = threading.Lock()

    def _new_cell(self) -> object:  # pragma: no cover - overridden
        raise NotImplementedError

    def cell(self, key: Optional[int] = None):
        """The calling thread's cell (or the cell for explicit ``key``).

        Single-writer rule: a cell must only ever be written by the one
        thread (or the one logical shard, for explicit keys) it was
        created for.  Hot paths cache the returned cell and mutate it
        directly, skipping the per-call dict lookup.
        """
        k = threading.get_ident() if key is None else key
        c = self._cells.get(k)
        if c is None:
            with self._lock:
                c = self._cells.setdefault(k, self._new_cell())
        return c

    def _merged_cells(self) -> List[object]:
        with self._lock:
            return list(self._cells.values())


class Counter(_Sharded):
    def __init__(self, name: str) -> None:
        super().__init__()
        self.name = _check_name(name)

    def _new_cell(self) -> _CounterCell:
        return _CounterCell()

    def inc(self, n: int = 1) -> None:
        self.cell().inc(n)

    @property
    def value(self) -> int:
        return sum(c.n for c in self._merged_cells())

    def set(self, value: int) -> None:
        """Force the merged value to ``value`` by adjusting the calling
        thread's cell.  Compatibility shim for legacy attribute writes
        (``svc.cache_hits += 100``); only safe while other writers are
        quiescent."""
        self.cell().inc(int(value) - self.value)


class Gauge:
    """Last-written value; not sharded (one logical writer, atomic set)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = _check_name(name)
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram(_Sharded):
    def __init__(self, name: str,
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS) -> None:
        super().__init__()
        self.name = _check_name(name)
        bounds = tuple(float(b) for b in buckets)
        if not bounds or any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
            raise ValueError(f"histogram {name!r}: buckets must be "
                             f"non-empty and strictly increasing")
        self.bounds = bounds

    def _new_cell(self) -> _HistCell:
        return _HistCell(self.bounds)

    def observe(self, v: float) -> None:
        self.cell().observe(v)

    def merged(self) -> Tuple[List[int], int]:
        """(per-bucket counts incl. +Inf, total nanoseconds) over cells."""
        counts = [0] * (len(self.bounds) + 1)
        total_ns = 0
        for c in self._merged_cells():
            for i, n in enumerate(c.counts):
                counts[i] += n
            total_ns += c.total_ns
        return counts, total_ns

    @property
    def count(self) -> int:
        return sum(self.merged()[0])

    @property
    def sum(self) -> float:
        return self.merged()[1] / 1e9

    def quantile(self, q: float) -> Optional[float]:
        counts, _ = self.merged()
        return histogram_quantile(self.bounds, counts, q)

    def dump(self) -> Dict[str, object]:
        counts, total_ns = self.merged()
        return {"le": list(self.bounds), "counts": counts,
                "sum": total_ns / 1e9, "count": sum(counts)}


def histogram_quantile(bounds: Sequence[float], counts: Sequence[int],
                       q: float) -> Optional[float]:
    """Prometheus-style quantile from cumulative-by-bucket counts.

    ``counts`` is per-bucket (not cumulative) with the +Inf overflow
    last.  Linear interpolation within the winning bucket; samples in
    the overflow bucket clamp to the last finite bound.  Pure integer
    walk + one float interpolation, so the result is deterministic for
    a given (bounds, counts, q).  Returns None for an empty histogram.
    """
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile {q} outside [0, 1]")
    total = sum(counts)
    if total == 0:
        return None
    rank = q * total
    cum = 0
    for i, n in enumerate(counts):
        prev = cum
        cum += n
        if cum >= rank and n > 0:
            if i >= len(bounds):  # overflow bucket
                return float(bounds[-1])
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i]
            return lo + (hi - lo) * ((rank - prev) / n)
    return float(bounds[-1])  # pragma: no cover - rank <= total always hits


class _Span:
    """Context manager timing one block into a histogram."""

    __slots__ = ("_hist", "_clock", "_t0")

    def __init__(self, hist: Histogram, clock: Callable[[], float]) -> None:
        self._hist = hist
        self._clock = clock

    def __enter__(self) -> "_Span":
        self._t0 = self._clock()
        return self

    def __exit__(self, *exc) -> bool:
        self._hist.observe(self._clock() - self._t0)
        return False


class _NullSpan:
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NULL_SPAN = _NullSpan()


def maybe_span(registry: Optional["MetricsRegistry"], name: str):
    """``registry.span(name)`` when a registry is wired, else a no-op."""
    return NULL_SPAN if registry is None else registry.span(name)


class MetricsRegistry:
    """Named counters/gauges/histograms plus the ``span`` timing API.

    ``spans_enabled=False`` turns every ``span()`` into a shared no-op
    object — no clock reads, no histogram writes — which is the
    uninstrumented leg of the overhead gate (``benchmarks/obs_bench.py``).
    Counters stay live in both modes; they are the accounting the rest
    of the system reads back (cache hits, shed, reallocs, ...).
    """

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 spans_enabled: bool = True) -> None:
        self.clock = SYSTEM_CLOCK if clock is None else clock
        self.spans_enabled = spans_enabled
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, name: str, cls, factory):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = factory()
                    self._metrics[name] = m
        if not isinstance(m, cls):
            raise TypeError(f"metric {name!r} is {type(m).__name__}, "
                            f"not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter, lambda: Counter(name))

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge, lambda: Gauge(name))

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS
                  ) -> Histogram:
        return self._get_or_create(name, Histogram,
                                   lambda: Histogram(name, buckets))

    def span(self, name: str,
             buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        """Time a ``with`` block into histogram ``name`` (no-op when
        spans are disabled).  Hot paths that cannot afford the context
        manager read ``clock``/``spans_enabled`` and observe into a
        cached ``histogram(name).cell()`` directly."""
        if not self.spans_enabled:
            return NULL_SPAN
        return _Span(self.histogram(name, buckets), self.clock)

    # -- merge-on-read export ------------------------------------------

    def _sorted_metrics(self) -> List[Tuple[str, object]]:
        with self._lock:
            items = list(self._metrics.items())
        return sorted(items)

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """Deterministic merged dump: sorted names, integer-exact counts."""
        out: Dict[str, Dict[str, object]] = {
            "counters": {}, "gauges": {}, "histograms": {}}
        for name, m in self._sorted_metrics():
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            else:
                out["histograms"][name] = m.dump()
        return out

    def render(self, fmt: str = "prom") -> str:
        """Export the registry: Prometheus text (default) or JSON."""
        if fmt == "json":
            return json.dumps(self.snapshot(), sort_keys=True)
        if fmt != "prom":
            raise ValueError(f"unknown metrics format {fmt!r}")
        lines: List[str] = []
        for name, m in self._sorted_metrics():
            p = _prom_name(name)
            if isinstance(m, Counter):
                lines.append(f"# TYPE {p} counter")
                lines.append(f"{p} {m.value}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {p} gauge")
                lines.append(f"{p} {m.value}")
            else:
                counts, total_ns = m.merged()
                lines.append(f"# TYPE {p} histogram")
                cum = 0
                for bound, n in zip(m.bounds, counts):
                    cum += n
                    lines.append(f'{p}_bucket{{le="{bound}"}} {cum}')
                cum += counts[-1]
                lines.append(f'{p}_bucket{{le="+Inf"}} {cum}')
                lines.append(f"{p}_sum {total_ns / 1e9}")
                lines.append(f"{p}_count {cum}")
        return "\n".join(lines) + "\n"
