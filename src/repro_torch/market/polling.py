"""PollingPriceFeed: the live billing-API adapter shape (DESIGN.md §15).

A real deployment gets quotes by polling a cloud billing API.  That
call can time out, return garbage, or return a page with half the
fields missing — and none of those may kill the serving loop or move
the price table.  :class:`PollingPriceFeed` wraps any billing-API-style
callable behind the market's existing typed failure path: every
failure mode raises :class:`~repro_torch.market.FeedError`, which the ticker
surfaces *before* the tick index is consumed, so the daemon/front-end
journal a ``feed-error`` record, keep serving off the last good epoch,
and retry the same tick with capped backoff (DESIGN.md §6/§11).

The network is the caller's problem by design: the adapter takes a
``poller(tick) -> payload`` callable, so tests stub it with canned
payloads and production wraps an HTTP client.  Payloads accepted:

  * an iterable of quote mappings — ``{"config_id": ..., "price": ...}``
    (the REST-page shape); extra keys are ignored;
  * an iterable of ``(config_id, price)`` pairs or
    :class:`~repro_torch.market.PriceDelta`\\ s;
  * a mapping with a ``"quotes"`` key holding either of the above
    (the enveloped-response shape).

Everything else — a string, a non-iterable, an entry that is neither
mapping nor pair — is *malformed* and raises.  A quote entry whose
``price`` is absent or ``None`` is a *partial* response (the API
answered but the page is incomplete) and raises.  A quote that parses
but could never be recorded — non-positive, non-finite, duplicate
config in one batch, unhashable id — raises, because
:func:`~repro_torch.market.record_feed` would refuse it at capture time and
a feed that cannot be recorded cannot be replayed or audited.

A successful poll is exactly a :class:`~repro_torch.market.PriceDelta` batch,
so :func:`~repro_torch.market.record_feed` turns any poll into a replayable
CSV fixture and the identical sweep code path
(:func:`repro_torch.market.turbulence.run_point`) runs over recorded and
polled feeds, producing identical curves for identical quote streams.
"""
from __future__ import annotations

import time
from typing import (Any, Callable, Hashable, Mapping, Optional, Set, Tuple)

import numpy as np

from repro_torch.market.feed import FeedError, PriceDelta


def _fail(tick: int, kind: str, detail: str) -> "FeedError":
    return FeedError(f"{kind} poll response at tick {tick}: {detail}",
                     tick)


def _parse_entry(entry: Any, tick: int) -> PriceDelta:
    """One quote entry -> PriceDelta; typed FeedError on anything else."""
    if isinstance(entry, PriceDelta):
        config_id, price = entry.config_id, entry.price
    elif isinstance(entry, Mapping):
        if "config_id" not in entry:
            raise _fail(tick, "malformed",
                        f"quote entry without config_id: {entry!r}")
        if "price" not in entry or entry["price"] is None:
            # the API answered, but this quote is incomplete — a
            # partial page must be retried whole, never half-applied
            raise _fail(tick, "partial",
                        f"quote for {entry['config_id']!r} has no price")
        config_id, price = entry["config_id"], entry["price"]
    elif isinstance(entry, (tuple, list)) and len(entry) == 2:
        config_id, price = entry
        if price is None:
            raise _fail(tick, "partial",
                        f"quote for {config_id!r} has no price")
    else:
        raise _fail(tick, "malformed",
                    f"quote entry is not a mapping or pair: {entry!r}")
    if isinstance(config_id, (list, dict, set)):
        raise _fail(tick, "malformed",
                    f"config_id {config_id!r} is not hashable")
    if isinstance(price, bool) or not isinstance(price, (int, float)):
        raise _fail(tick, "malformed",
                    f"price {price!r} for {config_id!r} is not a number")
    price = float(price)
    if not np.isfinite(price) or not price > 0:
        raise _fail(tick, "malformed",
                    f"non-positive or non-finite price {price!r} for "
                    f"{config_id!r}")
    return PriceDelta(config_id, price)


class PollingPriceFeed:
    """A :class:`~repro_torch.market.PriceFeed` over a billing-API callable.

    ``poller(tick)`` produces the raw response for one tick; this class
    owns validation and the typed failure contract.  An optional
    ``timeout_s`` budget turns slow responses into the timeout failure
    mode (measured on ``clock``, injectable so tests need no real
    waiting) — the response is *discarded* even though it arrived:
    a quote slower than the tick cadence is stale by definition.

    Failures never advance anything: the tick index lives in the
    ticker, which only consumes it after a successful poll, and this
    adapter's own :attr:`polls`/:attr:`batches` accounting moves only
    on success (:attr:`failures` counts the raises).  Retrying the same
    tick after a transient outage is therefore exactly a fresh call.
    """

    def __init__(self, poller: Callable[[int], Any], *,
                 timeout_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        if timeout_s is not None and not timeout_s > 0:
            raise ValueError(f"timeout_s must be positive, got {timeout_s}")
        self._poller = poller
        self.timeout_s = timeout_s
        self._clock = clock
        #: successful polls (and how many returned a non-empty batch).
        self.polls = 0
        self.batches = 0
        #: polls that raised a FeedError (timeout/malformed/partial/...).
        self.failures = 0

    def poll(self, tick: int) -> Tuple[PriceDelta, ...]:
        t0 = self._clock()
        try:
            payload = self._poller(tick)
        except FeedError:
            self.failures += 1
            raise
        except Exception as exc:
            self.failures += 1
            raise FeedError(
                f"poll failed at tick {tick}: "
                f"{type(exc).__name__}: {exc}", tick) from exc
        if self.timeout_s is not None and \
                self._clock() - t0 > self.timeout_s:
            self.failures += 1
            raise _fail(tick, "timed-out",
                        f"response exceeded the {self.timeout_s:g}s "
                        f"budget (stale by definition)")
        try:
            deltas = self._validate(payload, tick)
        except FeedError:
            self.failures += 1
            raise
        self.polls += 1
        if deltas:
            self.batches += 1
        return deltas

    @staticmethod
    def _validate(payload: Any, tick: int) -> Tuple[PriceDelta, ...]:
        if isinstance(payload, Mapping):
            if "quotes" not in payload:
                raise _fail(tick, "malformed",
                            f"response object without 'quotes': "
                            f"{sorted(payload)!r}")
            payload = payload["quotes"]
        if payload is None or isinstance(payload, (str, bytes)):
            raise _fail(tick, "malformed",
                        f"response is not a quote list: {payload!r}")
        try:
            entries = list(payload)
        except TypeError:
            raise _fail(tick, "malformed",
                        f"response is not iterable: {payload!r}")
        deltas = []
        seen: Set[Hashable] = set()
        for entry in entries:
            d = _parse_entry(entry, tick)
            if d.config_id in seen:
                # ambiguous: which quote is "the" price depends on
                # application order, which replay must not guess
                # (mirrors RecordedPriceFeed.loads)
                raise _fail(tick, "malformed",
                            f"duplicate quote for {d.config_id!r}")
            seen.add(d.config_id)
            deltas.append(d)
        return tuple(deltas)
