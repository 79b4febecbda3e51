"""The port's polling price feed against the reference package.

Every payload shape a billing API can return either parses to the same
``PriceDelta`` batch in both packages or raises the same typed
``FeedError`` (timeout / malformed / partial, same message, same tick);
failures never advance the tick index, and the backoff counter resets
after recovery, over the port's daemon and front-end.
"""
import pytest

from repro.market import FeedError as RefFeedError
from repro.market import PollingPriceFeed as RefPolling
from repro_torch.core.trace import JobClass
from repro_torch.market import (FeedError, PollingPriceFeed, PriceDelta,
                                RecordedPriceFeed, SelectionDaemon,
                                ServeFrontend, SimulatedSpotFeed,
                                Submission, Tick, record_feed)
from repro_torch.selector import (IdentityCatalog, PriceTable,
                                  ProfilingStore, SelectionService)


def _universe():
    ids = [f"c{i}" for i in range(8)]
    store = ProfilingStore(config_ids=ids)
    for j in range(6):
        klass = JobClass.A if j % 2 else JobClass.B
        for i, c in enumerate(ids):
            store.add(f"j{j}", c,
                      0.2 + ((j * 7 + i * 5) % 13) / 6.0
                      + (0.4 if klass is JobClass.A and i % 2 == 0
                         else 0.0),
                      job_class=klass, group=f"g{j % 3}")
    base = {c: 1.0 + (i * 5 % 11) for i, c in enumerate(ids)}
    return store, ids, base


def _service(store, ids, base, backend="numpy"):
    return SelectionService(IdentityCatalog(ids), store, PriceTable(base),
                            backend=backend, device="cpu")


def _as_pairs(batch):
    return [(d.config_id, d.price) for d in batch]


@pytest.mark.parametrize("payload", [
    [{"config_id": "c0", "price": 2.0, "currency": "USD"},
     {"config_id": "c1", "price": 3.5}],
    [("c0", 2.0), ("c1", 3.5)],
    [PriceDelta("c0", 2.0), PriceDelta("c1", 3.5)],
    {"quotes": [("c0", 2.0), ("c1", 3.5)], "next_page": None},
    [["c0", 2], ("c1", 3.5)],
])
def test_polling_feed_accepts_every_documented_payload_shape(payload):
    feed = PollingPriceFeed(lambda t: payload)
    got = feed.poll(0)
    assert got == (PriceDelta("c0", 2.0), PriceDelta("c1", 3.5))
    assert all(type(d.price) is float for d in got)
    assert (feed.polls, feed.batches, feed.failures) == (1, 1, 0)
    if not any(isinstance(e, PriceDelta) for e in payload):
        assert _as_pairs(RefPolling(lambda t: payload).poll(0)) == \
            _as_pairs(got)


def test_empty_poll_is_a_success_without_a_batch():
    empty = PollingPriceFeed(lambda t: [])
    assert empty.poll(0) == ()
    assert (empty.polls, empty.batches, empty.failures) == (1, 0, 0)


@pytest.mark.parametrize("payload,kind", [
    ("c0,2.0", "malformed"),
    (b"c0,2.0", "malformed"),
    (None, "malformed"),
    (42, "malformed"),
    ({"prices": []}, "malformed"),
    ([{"price": 2.0}], "malformed"),
    ([("c0", 2.0, "extra")], "malformed"),
    ([(["c0"], 2.0)], "malformed"),
    ([("c0", "2.0")], "malformed"),
    ([("c0", True)], "malformed"),
    ([("c0", float("nan"))], "malformed"),
    ([("c0", float("inf"))], "malformed"),
    ([("c0", -1.0)], "malformed"),
    ([("c0", 0)], "malformed"),
    ([("c0", 2.0), ("c0", 3.0)], "malformed"),
    ([{"config_id": "c0"}], "partial"),
    ([{"config_id": "c0", "price": None}], "partial"),
    ([("c0", None)], "partial"),
])
def test_polling_feed_failure_modes_raise_typed_feed_errors(payload, kind):
    feed = PollingPriceFeed(lambda t: payload)
    with pytest.raises(FeedError, match=kind) as exc:
        feed.poll(5)
    assert exc.value.tick == 5
    assert (feed.polls, feed.batches, feed.failures) == (0, 0, 1)
    with pytest.raises(RefFeedError) as ref_exc:
        RefPolling(lambda t: payload).poll(5)
    assert str(exc.value) == str(ref_exc.value)


def test_polling_feed_wraps_poller_exceptions_and_times_out():
    def boom(tick):
        raise ConnectionError("socket reset")
    feed = PollingPriceFeed(boom)
    with pytest.raises(FeedError, match="ConnectionError") as exc:
        feed.poll(0)
    assert isinstance(exc.value.__cause__, ConnectionError)
    assert feed.failures == 1

    def typed(tick):
        raise FeedError("already typed", tick)
    passthrough = PollingPriceFeed(typed)
    with pytest.raises(FeedError, match="^already typed$"):
        passthrough.poll(3)
    assert passthrough.failures == 1

    clock = iter([0.0, 10.0, 20.0, 20.1]).__next__
    slow = PollingPriceFeed(lambda t: [("c0", 2.0)], timeout_s=5.0,
                            clock=clock)
    with pytest.raises(FeedError, match="timed-out"):
        slow.poll(0)
    assert slow.poll(1) == (PriceDelta("c0", 2.0),)
    assert (slow.polls, slow.failures) == (1, 1)
    for bad in (0.0, -1.0):
        with pytest.raises(ValueError):
            PollingPriceFeed(lambda t: [], timeout_s=bad)


@pytest.mark.parametrize("backend", ["numpy", "torch_fused"])
def test_polling_failures_never_advance_the_tick_index(backend):
    store, ids, base = _universe()
    replay = RecordedPriceFeed.loads(record_feed(
        SimulatedSpotFeed(base, seed=4, change_fraction=0.9), 6))
    outages = {2: 2}

    def poller(tick):
        if outages.get(tick, 0) > 0:
            outages[tick] -= 1
            raise ConnectionError("transient outage")
        return replay.poll(tick)

    daemon = SelectionDaemon(_service(store, ids, base, backend),
                             PollingPriceFeed(poller))
    daemon.handle(Tick())
    daemon.handle(Tick())
    assert daemon.ticker.tick_count == 2
    for _ in range(2):
        assert daemon.handle(Tick()) is None
        assert daemon.ticker.tick_count == 2
    daemon.handle(Tick())
    assert daemon.ticker.tick_count == 3
    assert daemon.stats.feed_errors == 2
    records = [r for r in daemon.journal_dump().splitlines()
               if '"feed-error"' in r]
    assert len(records) == 2


@pytest.mark.parametrize("backend", ["numpy", "torch_fused"])
def test_polling_backoff_resets_after_recovery(backend):
    store, ids, base = _universe()
    replay = RecordedPriceFeed.loads(record_feed(
        SimulatedSpotFeed(base, seed=4, change_fraction=0.9), 5))
    outages = {1: 2, 3: 1}

    def poller(tick):
        if outages.get(tick, 0) > 0:
            outages[tick] -= 1
            raise TimeoutError("billing API stalled")
        return replay.poll(tick)

    fe = ServeFrontend(_service(store, ids, base, backend),
                       PollingPriceFeed(poller), workers=1,
                       backoff_base=0.01, backoff_cap=0.5)
    assert fe.step_tick() == "tick"
    delays = []
    while fe.step_tick() == "feed-error":
        delays.append(fe.backoff_delay())
    assert delays == [pytest.approx(0.01), pytest.approx(0.02)]
    assert fe.backoff_delay() == pytest.approx(0.01)
    assert fe.ticker.tick_count == 2
    fe.step_tick()
    assert fe.step_tick() == "feed-error"
    assert fe.backoff_delay() == pytest.approx(0.01)
    assert fe.step_tick() == "tick"
    assert fe.ticker.tick_count == 4
    fe.close()


def test_recorded_and_polled_daemon_journals_are_byte_identical():
    """A recorded feed and a polled feed serving the same quotes through
    the port's daemon write the same bytes."""
    store, ids, base = _universe()
    text = record_feed(SimulatedSpotFeed(base, seed=6, change_fraction=0.6),
                       20)
    stream = []
    for t in range(20):
        stream.append(Tick())
        if t % 2 == 0:
            stream.append(Submission(f"j{(t // 2) % 6}"))

    def run(feed):
        daemon = SelectionDaemon(_service(store, ids, base), feed)
        daemon.run(stream)
        return daemon.journal_dump()

    replay = RecordedPriceFeed.loads(text)
    assert run(RecordedPriceFeed.loads(text)) == run(PollingPriceFeed(
        lambda t: {"quotes": [{"config_id": d.config_id, "price": d.price}
                              for d in replay.poll(t)]}))
