"""Event broker: the cluster's change feed.

Reference behavior: nomad/stream/ -- an in-memory ring buffer of typed
events (event_buffer.go) with per-subscriber cursors and topic/key
filters (event_broker.go:30-260), feeding the ``/v1/event/stream``
NDJSON endpoint. Events are published by the FSM as applies commit.

This module builds the broker on the reference's actual shape: a
SHARED ring of immutable event batches (one batch per FSM apply, the
eventBuffer analog) with per-subscriber cursors, instead of the seed's
per-subscriber bounded queues. The difference is the serving-plane
scaling story:

- **Publish is O(1) in subscriber count.** One append + one condition
  broadcast, whatever the fan-out. The seed published
  O(subscribers x events) queue puts from inside the FSM-apply path —
  at fleet scale (10k+ watchers) every state commit paid the whole
  fan-out.
- **Filtering runs at the consumer.** Topic/key/namespace predicates
  are evaluated on the subscriber's own thread when it drains its
  cursor, so an expensive filter slows only its owner.
- **Slow consumers get explicit semantics.** A subscriber whose cursor
  falls off the retained ring receives a ``LostEvents`` marker carrying
  the lost-event count and the resume index — never a silent
  drop-oldest (the seed's queue overwrote without telling anyone).
- **Delivery lag is measured.** Each batch carries its FSM-apply
  stamp; consumer hand-off records the lag into the always-on
  ``stream_deliver`` streaming histogram (the real Prometheus
  histogram series; docs/TELEMETRY.md "Event stream").

Locking: one witness-checked lock + a same-lock Condition (the
graftcheck R2 whitelisted wiring). Histogram/tracer recording happens
OUTSIDE the lock — nothing foreign is acquired under it.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Set, Tuple

from nomad_tpu_torch.telemetry.histogram import STREAM_DELIVER, histograms
from nomad_tpu_torch.telemetry.trace import tracer
from nomad_tpu_torch.utils.faultpoints import FaultError, fault
from nomad_tpu_torch.utils.witness import witness_lock

TOPIC_ALL = "*"
TOPIC_NODE = "Node"
TOPIC_JOB = "Job"
TOPIC_EVAL = "Evaluation"
TOPIC_ALLOC = "Allocation"
TOPIC_DEPLOYMENT = "Deployment"
#: marker topic for explicit slow-consumer semantics: delivered when a
#: subscriber's cursor fell off the retained ring; payload carries the
#: lost-event count and the index to resume from
TOPIC_LOST = "LostEvents"


@dataclass
class Event:
    topic: str
    type: str            # e.g. NodeRegistration, JobRegistered, AllocationUpdated
    key: str             # entity id
    index: int
    payload: object = None
    namespace: str = ""


class _Batch:
    """One published batch: the immutable ring slot. ``cum0`` is the
    count of events published before this batch (the lost-event
    accounting base); ``stamp`` the FSM-apply monotonic stamp the
    delivery-lag histogram measures from."""

    __slots__ = ("seq", "events", "stamp", "cum0")

    def __init__(self, seq: int, events: Tuple[Event, ...], stamp: float,
                 cum0: int) -> None:
        self.seq = seq
        self.events = events
        self.stamp = stamp
        self.cum0 = cum0


class Subscription:
    """A cursor into the broker's shared ring.

    Holds NO event storage of its own — just the next-batch sequence
    number plus its filters, so 10k subscriptions cost 10k small
    objects, not 10k bounded queues. All cursor state is read/written
    under the broker lock.
    """

    def __init__(self, broker: "EventBroker", topics: Dict[str, List[str]],
                 namespaces: Optional[Set[str]] = None,
                 from_index: int = 0) -> None:
        self._broker = broker
        # topic -> keys ("*" for all); {"*": ["*"]} subscribes to everything
        self.topics = topics
        #: optional namespace allow-set (consumer-side filter; None = all).
        #: Namespace-less events (Node topic, markers) always pass.
        self.namespaces = namespaces
        self.from_index = from_index
        # cursor fields are owned by the broker (under its lock)
        self._cursor = 0          # next batch seq to read
        self._offset = 0          # next event position WITHIN that batch
        self._cum = 0             # published-event count at the cursor
        #: events lost before the cursor, marker due at next drain.
        #: -1 = unknown count (resume past a trimmed span: the broker
        #: cannot know how many trimmed events matched the filter)
        self._pending_lost = 0
        self.lost_events = 0      # total known-lost over this subscription
        self.closed = False

    def _matches(self, event: Event) -> bool:
        if event.topic == TOPIC_LOST:
            return True           # markers bypass filters: they ARE the signal
        if self.namespaces is not None and event.namespace \
                and event.namespace not in self.namespaces:
            return False
        for topic, keys in self.topics.items():
            if topic not in (TOPIC_ALL, event.topic):
                continue
            if TOPIC_ALL in keys or event.key in keys:
                return True
        return False

    def next_events(self, timeout: float = 1.0,
                    max_events: int = 64) -> List[Event]:
        """Drain matching events from the cursor; blocks (bounded by
        ``timeout``) while nothing matches. The cursor advances past
        non-matching batches even when nothing is returned, so a
        narrow filter on a busy stream never lags the ring."""
        return self._broker._next_events(self, timeout, max_events)

    def close(self) -> None:
        self.closed = True
        self._broker.unsubscribe(self)


class EventBroker:
    """Shared-ring event fan-out (event_broker.go analog).

    ``buffer_size`` bounds RETAINED EVENTS across the ring; trimming
    drops whole batches from the front (oldest first) and records the
    highest trimmed index so late resumes can be told exactly whether
    they missed anything.
    """

    def __init__(self, buffer_size: int = 4096) -> None:
        self.buffer_size = buffer_size
        self._lock = witness_lock("EventBroker._lock")
        self._cond = threading.Condition(self._lock)
        self._batches: Deque[_Batch] = deque()
        self._base_seq = 0        # seq of _batches[0]
        self._next_seq = 0
        self._retained_events = 0
        self._published_events = 0
        self._published_origin = 0        # reset_stats window base
        self._published_batches = 0
        self._trimmed_events = 0          # cum0 of the oldest retained batch
        self._trimmed_latest_index = 0    # highest index ever trimmed
        self._subs: Set[Subscription] = set()
        self.latest_index = 0
        # delivery-side counters (the exporter's gauge sources)
        self._delivered_events = 0
        self._delivered_batches = 0
        self._delivered_bytes = 0         # fed by the NDJSON endpoint
        self._lost_events = 0
        # batches the publish seam dropped (chaos plane): each one was
        # converted into per-subscriber LostEvents markers above
        self._publish_failures = 0

    # --- publish ---------------------------------------------------------

    def publish(self, events: List[Event], stamp: Optional[float] = None) -> None:
        """One ring append + one broadcast — no per-subscriber work.
        ``stamp`` is the FSM-apply monotonic time (defaults to now);
        it anchors the ``stream_deliver`` lag histogram."""
        if not events:
            return
        try:
            # publish seam (chaos plane): the ring append failing (or
            # stalling, with kind="latency") between FSM commit and
            # fan-out. The contract survives it: a failed publish
            # becomes an EXPLICIT LostEvents marker for every live
            # cursor — never a silent gap the subscriber cannot see.
            fault("stream.publish")
        except FaultError:
            with self._cond:
                self._publish_failures += 1
                # live cursors get an exact-count marker; FUTURE
                # resumes must see the gap too — record the dropped
                # indexes in the trimmed-history watermark so a later
                # subscribe(from_index <= dropped) gets the unknown-
                # size LostEvents marker instead of a silent gap
                top = max(e.index for e in events)
                if top > self._trimmed_latest_index:
                    self._trimmed_latest_index = top
                for sub in self._subs:
                    if sub._pending_lost >= 0:
                        sub._pending_lost += len(events)
                self._cond.notify_all()
            return
        with tracer.span("stream.publish"):
            batch_stamp = stamp if stamp is not None else time.monotonic()
            with self._cond:
                batch = _Batch(self._next_seq, tuple(events), batch_stamp,
                               self._published_events)
                self._batches.append(batch)
                self._next_seq += 1
                self._published_events += len(events)
                self._published_batches += 1
                self._retained_events += len(events)
                if events[-1].index > self.latest_index:
                    self.latest_index = events[-1].index
                # trim oldest whole batches past the retention bound;
                # always keep the newest batch
                while self._retained_events > self.buffer_size \
                        and len(self._batches) > 1:
                    old = self._batches.popleft()
                    self._base_seq += 1
                    self._retained_events -= len(old.events)
                    self._trimmed_events = old.cum0 + len(old.events)
                    if old.events[-1].index > self._trimmed_latest_index:
                        self._trimmed_latest_index = old.events[-1].index
                self._cond.notify_all()

    def note_trimmed_through(self, index: int) -> None:
        """Declare everything at or below ``index`` trimmed history
       : a restarted server's fresh ring holds none of the
        events its restored snapshot covers, so a client resuming
        ``?index=`` below the boot index must get the explicit
        unknown-size ``LostEvents`` marker — never a silent gap."""
        with self._lock:
            if index > self._trimmed_latest_index:
                self._trimmed_latest_index = index
            if index > self.latest_index:
                self.latest_index = index

    # --- subscribe / drain -----------------------------------------------

    def subscribe(
        self,
        topics: Optional[Dict[str, List[str]]] = None,
        from_index: int = 0,
        namespaces: Optional[Set[str]] = None,
    ) -> Subscription:
        """``from_index=0`` tails the live stream; ``from_index>0``
        resumes: retained events with ``index > from_index`` replay
        from the ring, and if events past ``from_index`` were already
        trimmed the first drain delivers a ``LostEvents`` marker with
        the resume index instead of a silent gap."""
        sub = Subscription(self, topics or {TOPIC_ALL: [TOPIC_ALL]},
                           namespaces=namespaces, from_index=from_index)
        with self._lock:
            if from_index <= 0:
                sub._cursor = self._next_seq
                sub._cum = self._published_events
            else:
                sub._cursor = self._base_seq
                sub._cum = self._trimmed_events
                if self._trimmed_latest_index > from_index:
                    # events past from_index were already trimmed: the
                    # resume has a gap of UNKNOWN size (marker count -1)
                    sub._pending_lost = -1
            self._subs.add(sub)
        return sub

    def unsubscribe(self, sub: Subscription) -> None:
        with self._cond:
            self._subs.discard(sub)
            # wake any reader parked in next_events on this (or any)
            # subscription so close() returns it immediately instead of
            # sleeping out its poll timeout
            self._cond.notify_all()

    def _lost_marker_locked(self, lost: int) -> Event:
        """``lost`` -1 means an unknown-size gap (resume past trimmed
        history); >=1 is the exact count of events that fell off the
        ring past this subscriber's cursor."""
        resume = self._batches[0].events[0].index if self._batches \
            else self.latest_index
        return Event(
            topic=TOPIC_LOST, type="EventsLost", key="",
            index=self.latest_index,
            payload={"LostEvents": lost, "ResumeIndex": resume},
        )

    def _collect_locked(self, sub: Subscription,
                        max_events: int) -> Tuple[List[Event], float]:
        """Advance the cursor, applying the subscriber's filters.
        Returns (events, oldest stamp among returned batches)."""
        out: List[Event] = []
        first_stamp = 0.0
        if sub._cursor < self._base_seq:
            # fell off the ring: account the trimmed span, emit marker
            lost = max(self._trimmed_events - sub._cum, 1)
            sub._pending_lost = lost if sub._pending_lost >= 0 else -1
            sub._cursor = self._base_seq
            sub._offset = 0
            sub._cum = self._trimmed_events
        if sub._pending_lost:
            lost = sub._pending_lost
            sub._pending_lost = 0
            known = max(lost, 1)
            sub.lost_events += known
            self._lost_events += known
            out.append(self._lost_marker_locked(lost))
        start = sub._cursor - self._base_seq
        offset = sub._offset
        taken = 0
        for batch in itertools.islice(self._batches, start, None):
            events = batch.events
            partial = False
            for pos in range(offset, len(events)):
                ev = events[pos]
                if sub.from_index and ev.index <= sub.from_index:
                    continue
                if sub._matches(ev):
                    if not taken:
                        first_stamp = batch.stamp
                    out.append(ev)
                    taken += 1
                    if len(out) >= max_events and pos + 1 < len(events):
                        # cap hit mid-batch: park the cursor INSIDE the
                        # batch so a giant group-committed batch cannot
                        # overshoot the caller's max_events
                        sub._cursor = batch.seq
                        sub._offset = pos + 1
                        sub._cum = batch.cum0 + pos + 1
                        partial = True
                        break
            if partial:
                break
            offset = 0
            sub._cursor = batch.seq + 1
            sub._offset = 0
            sub._cum = batch.cum0 + len(events)
            if len(out) >= max_events:
                break
        if out:
            self._delivered_events += taken
            self._delivered_batches += 1
        return out, first_stamp

    def _next_events(self, sub: Subscription, timeout: float,
                     max_events: int) -> List[Event]:
        deadline = time.monotonic() + max(timeout, 0.0)
        t0 = time.monotonic() if tracer.enabled else 0.0
        out: List[Event] = []
        first_stamp = 0.0
        with self._cond:
            while True:
                out, first_stamp = self._collect_locked(sub, max_events)
                if out or sub.closed:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
        # recording happens OUTSIDE the broker lock (R2: nothing
        # foreign acquired under it)
        if out:
            now = time.monotonic()
            if first_stamp > 0.0:
                histograms.get(STREAM_DELIVER).record(now - first_stamp)
            if t0:
                tracer.record("stream.deliver", now - t0)
        return out

    # --- introspection ---------------------------------------------------

    def num_subscribers(self) -> int:
        with self._lock:
            return len(self._subs)

    def note_delivered_bytes(self, n: int) -> None:
        """Wire-byte meter, fed by the NDJSON endpoint as it writes."""
        with self._lock:
            self._delivered_bytes += n

    def max_lag_events(self) -> int:
        with self._lock:
            return self._max_lag_locked()

    def _max_lag_locked(self) -> int:
        return max(
            (self._published_events - s._cum for s in self._subs),
            default=0)

    def snapshot(self) -> Dict:
        """Stats for /v1/operator/stream-health, the exporter's
        ``nomad_tpu_stream_*`` series, and the TRACE_DECOMP ``serving``
        section. ``published_events`` is windowed by ``reset_stats``
        (like every other bench-windowed stats source); the ring's
        internal accounting keeps its own lifetime origin."""
        with self._lock:
            return {
                "subscribers": len(self._subs),
                "published_events":
                    self._published_events - self._published_origin,
                "published_batches": self._published_batches,
                "delivered_events": self._delivered_events,
                "delivered_batches": self._delivered_batches,
                "delivered_bytes": self._delivered_bytes,
                "lost_events": self._lost_events,
                "publish_failures": self._publish_failures,
                "retained_events": self._retained_events,
                "retained_batches": len(self._batches),
                "max_lag_events": self._max_lag_locked(),
                "latest_index": self.latest_index,
            }

    def reset_stats(self) -> None:
        """Counters only — the ring, cursors, and subscriptions stay
        (bench bursts window their serving stats like every other
        telemetry source). ``_published_events`` itself is the
        lost-accounting base shared with batches/cursors — rebasing it
        would corrupt them, so the window keeps its own origin."""
        with self._lock:
            self._delivered_events = 0
            self._delivered_batches = 0
            self._delivered_bytes = 0
            self._lost_events = 0
            self._publish_failures = 0
            self._published_batches = 0
            self._published_origin = self._published_events
