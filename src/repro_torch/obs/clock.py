"""Injectable monotonic clocks for the telemetry layer (DESIGN.md §12).

Every timing site in the pipeline reads time through its registry's
``clock`` attribute instead of calling :func:`time.perf_counter`
directly.  Production registries default to ``perf_counter``; tests and
golden-journal runs inject a :class:`FakeClock` so span durations — and
therefore the ``"metrics"`` journal records built from them — are
byte-reproducible, exactly like the decision journals themselves.
"""
from __future__ import annotations

import time

#: The production clock: monotonic, float seconds, ~tens of ns per call.
SYSTEM_CLOCK = time.perf_counter


class FakeClock:
    """Deterministic monotonic clock: every call advances by ``step``.

    The advance-on-read convention means a ``t1 - t0`` span measured
    across k intervening clock reads is exactly ``(k + 1) * step`` —
    fully determined by the code path, never by the wall clock.  Use
    :meth:`advance` to model explicit elapsed time between reads.
    """

    def __init__(self, start: float = 0.0, step: float = 0.001) -> None:
        self.now = float(start)
        self.step = float(step)

    def __call__(self) -> float:
        self.now += self.step
        return self.now

    def advance(self, dt: float) -> None:
        """Move the clock forward by ``dt`` seconds without a read."""
        self.now += float(dt)
