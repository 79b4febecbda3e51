"""Streaming price feeds: the market side of live selection (DESIGN.md §6).

A :class:`PriceFeed` emits batches of :class:`PriceDelta` — absolute
re-quotes, never relative adjustments, so replaying a batch is idempotent
and a dropped batch cannot silently skew later prices.

:class:`SimulatedSpotFeed` is the deterministic reference market used by
the benchmarks, tests and examples.  It follows the repo's hash-seeding
discipline (:mod:`repro_torch.core.spark_sim`): every random draw is a pure function of ``(seed, purpose, config, tick)``
through md5.  The walk
itself is stateful (each quote reverts from the *current* price), so
determinism means: two independently constructed feeds with the same
seed, polled with the same in-order tick sequence from fresh state,
agree batch-for-batch — which is what the ticker does and the daemon
benchmark enforces.  Polling out of order or resuming mid-stream is
path-dependent and yields different quotes.  The dynamics:

  * **mean-reverting log walks** — each config's log-price reverts to its
    (event-adjusted) target with rate ``reversion`` under per-tick
    ``volatility`` shocks, clamped to a band around base — the standard
    spot-market shape: wanders, occasionally spikes, never runs away;
  * **regional multipliers** — configs hash into regions; scheduled
    :class:`MarketEvent` windows (``discount`` or ``eviction`` spikes)
    shift a whole region's reversion target for their duration, and every
    config of the region re-quotes at the window boundaries so the shift
    lands immediately;
  * **sparse ticks** — outside event boundaries only ``change_fraction``
    of configs re-quote per tick (hash-selected), which is exactly the
    regime the incremental ``reprice`` path is built for.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import (Dict, Hashable, Iterator, Mapping, Protocol, Sequence,
                    Tuple, runtime_checkable)


def hash_digest(seed: int, *key: object) -> int:
    """64-bit digest of ``seed|key`` — the repo's hash-seeding discipline
    (:mod:`repro_torch.core.spark_sim`): every draw is a pure function of
    its key, shared by the feed and the daemon's
    synthetic stream so their determinism contracts can never drift
    apart."""
    raw = "|".join(str(k) for k in (seed,) + key).encode()
    return int.from_bytes(hashlib.md5(raw).digest()[:8], "big")


def hash_uniform(seed: int, *key: object) -> float:
    """Deterministic uniform draw in (0, 1) from :func:`hash_digest`."""
    return (hash_digest(seed, *key) + 1) / (2 ** 64 + 2)


class FeedError(RuntimeError):
    """A feed failed to produce its batch for a tick.

    Raised by :class:`~repro_torch.market.PriceTicker` when ``feed.poll``
    raises (a live billing API timing out, a recording truncated
    mid-read); the original exception rides along as ``__cause__`` and
    :attr:`tick` names the tick that failed.  Typed so serving layers
    can journal a ``feed-error`` record and keep serving off the last
    good price epoch — the failed tick index was *not* consumed, so the
    next poll retries the same tick — instead of dying mid-stream.
    """

    def __init__(self, message: str, tick: int):
        super().__init__(message)
        #: the tick index whose poll failed (and will be retried).
        self.tick = tick


@dataclasses.dataclass(frozen=True)
class PriceDelta:
    """One absolute re-quote: ``config_id`` now costs ``price`` $/h."""

    config_id: Hashable
    price: float


@runtime_checkable
class PriceFeed(Protocol):
    """A source of per-tick price-delta batches."""

    def poll(self, tick: int) -> Tuple[PriceDelta, ...]:
        """The (possibly empty) batch of re-quotes at ``tick``."""
        ...


@dataclasses.dataclass(frozen=True)
class MarketEvent:
    """A scheduled regional price regime: discount window or eviction spike.

    For ``start_tick <= tick < start_tick + duration`` the region's
    reversion target is ``base * factor`` (``factor`` < 1 models a
    committed-use / off-peak discount, > 1 a spot eviction-pressure
    spike).
    """

    region: str
    start_tick: int
    duration: int
    factor: float
    kind: str = "discount"      # "discount" | "eviction" (labeling only)

    def active(self, tick: int) -> bool:
        return self.start_tick <= tick < self.start_tick + self.duration

    def boundary(self, tick: int) -> bool:
        return tick == self.start_tick or tick == self.start_tick + \
            self.duration


DEFAULT_REGIONS = ("us-central1", "europe-west3", "asia-east1")


class SimulatedSpotFeed:
    """Deterministic seeded spot market over a fixed config universe."""

    def __init__(self, base_prices: Mapping[Hashable, float], *,
                 seed: int = 0, change_fraction: float = 0.01,
                 reversion: float = 0.15, volatility: float = 0.06,
                 band: float = 8.0,
                 regions: Sequence[str] = DEFAULT_REGIONS,
                 events: Sequence[MarketEvent] = ()):
        if not 0.0 <= change_fraction <= 1.0:
            raise ValueError(f"change_fraction {change_fraction} not in "
                             f"[0, 1]")
        if band <= 1.0:
            raise ValueError("band must exceed 1 (price clamp base*[1/b, b])")
        self.seed = seed
        self.change_fraction = change_fraction
        self.reversion = reversion
        self.volatility = volatility
        self.band = band
        self.events = tuple(events)
        self._base: Dict[Hashable, float] = {}
        self._price: Dict[Hashable, float] = {}
        self._region: Dict[Hashable, str] = {}
        for cid, price in base_prices.items():
            if not price > 0:
                raise ValueError(f"non-positive base price for {cid!r}")
            self._base[cid] = float(price)
            self._price[cid] = float(price)
            self._region[cid] = regions[self._digest("region", cid)
                                        % len(regions)]

    # -- deterministic randomness (spark_sim hash-seeding style) ------------
    def _digest(self, *key: object) -> int:
        return hash_digest(self.seed, *key)

    def _uniform(self, *key: object) -> float:
        return hash_uniform(self.seed, *key)

    def _gauss(self, *key: object) -> float:
        u1 = self._uniform(*key, "u1")
        u2 = self._uniform(*key, "u2")
        return math.sqrt(-2.0 * math.log(u1)) * math.cos(2 * math.pi * u2)

    # -- market state -------------------------------------------------------
    def region_of(self, config_id: Hashable) -> str:
        return self._region[config_id]

    def price_of(self, config_id: Hashable) -> float:
        """The feed's current quote (last emitted, or base)."""
        return self._price[config_id]

    def _region_factor(self, region: str, tick: int) -> float:
        factor = 1.0
        for ev in self.events:
            if ev.region == region and ev.active(tick):
                factor *= ev.factor
        return factor

    def _boundary_regions(self, tick: int) -> Tuple[str, ...]:
        return tuple(ev.region for ev in self.events if ev.boundary(tick))

    # -- the feed protocol --------------------------------------------------
    def poll(self, tick: int) -> Tuple[PriceDelta, ...]:
        """Re-quotes at ``tick`` (insertion-ordered, deterministic)."""
        boundary = set(self._boundary_regions(tick))
        deltas = []
        for cid, current in self._price.items():
            region = self._region[cid]
            forced = region in boundary
            if not forced and \
                    self._uniform("sel", cid, tick) >= self.change_fraction:
                continue
            target = self._base[cid] * self._region_factor(region, tick)
            if forced:
                # regime change: snap to the new target (plus shock) so the
                # discount/eviction lands at the boundary, not 1/reversion
                # ticks later
                new = target * math.exp(
                    self.volatility * self._gauss("walk", cid, tick))
            else:
                step = self.reversion * (math.log(target)
                                         - math.log(current)) \
                    + self.volatility * self._gauss("walk", cid, tick)
                new = current * math.exp(step)
            lo = self._base[cid] / self.band
            hi = self._base[cid] * self.band
            new = min(max(new, lo), hi)
            if new != current:
                self._price[cid] = new
                deltas.append(PriceDelta(cid, new))
        return tuple(deltas)

    def stream(self, ticks: int, start: int = 0
               ) -> Iterator[Tuple[PriceDelta, ...]]:
        """Convenience: successive ``poll`` batches for ``ticks`` ticks."""
        for t in range(start, start + ticks):
            yield self.poll(t)
