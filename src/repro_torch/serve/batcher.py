"""Query batching: pack independent BFS sources into lane-word batches.

A batch is up to ``width`` sources; query q of a batch rides lane q of the
msBFS lane word. Partial batches are legal -- unseeded lanes start with an
all-INF level column and never generate work -- so the batcher never waits:
``drain`` flushes whatever is queued, full batches first.

:class:`LaneScheduler` is the continuous-queue sibling used by the refill
engine: instead of retiring whole batches it tracks per-lane occupancy and
a per-lane *generation* counter, so a lane can be retired and reseeded
mid-flight without ambiguity about which query its unpacked levels belong
to. Host-side bookkeeping only (numpy).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np

from repro_torch.obs import NULL_OBS


def pack_sources(sources, width: int):
    """Split a flat source list into lane batches of at most ``width``.

    Returns a list of int64 arrays; every array but possibly the last has
    exactly ``width`` entries (the last may be a partial batch).
    """
    sources = np.asarray(sources, dtype=np.int64)
    if sources.ndim != 1:
        raise ValueError("sources must be a flat sequence of vertex ids")
    return [sources[i : i + width] for i in range(0, sources.size, width)]


@dataclass
class QueryBatcher:
    """FIFO source queue with ticketed retrieval.

    ``submit`` returns a monotonically increasing ticket; ``next_batch``
    pops up to ``width`` queued queries in submission order as
    (tickets, sources).
    """

    width: int = 32
    _queue: deque = field(default_factory=deque)
    _next_ticket: int = 0

    def submit(self, source: int) -> int:
        ticket = self._next_ticket
        self._next_ticket += 1
        self._queue.append((ticket, int(source)))
        return ticket

    def __len__(self) -> int:
        return len(self._queue)

    @property
    def pending(self) -> int:
        return len(self._queue)

    def next_batch(self):
        """Pop up to ``width`` queries: (tickets [k], sources [k] int64)."""
        k = min(self.width, len(self._queue))
        items = [self._queue.popleft() for _ in range(k)]
        tickets = [t for t, _ in items]
        sources = np.asarray([s for _, s in items], dtype=np.int64)
        return tickets, sources

    def drain(self):
        """Yield (tickets, sources) batches until the queue is empty."""
        while self._queue:
            yield self.next_batch()


@dataclass(frozen=True)
class LaneAssignment:
    """One (re)seeding decision: the query on ``source`` occupies ``lane``
    as its ``generation``-th tenant. ``item`` is the queued descriptor --
    a typed :class:`~repro_torch.serve.queries.Query` carrying per-kind
    parameters (depth cap, targets), or the raw source id for classic
    untyped submissions."""

    lane: int
    source: int
    generation: int
    item: object = None


class LaneScheduler:
    """Continuous lane assignment for mid-flight refill.

    Tracks which query occupies each of the ``width`` msBFS lanes. Every
    (re)seed bumps the lane's generation counter, and :meth:`retire` returns
    the (item, generation) pair the lane was serving -- the unpacking side
    keys results by that pair, so a lane reused for a new query can never
    leak levels across tenants even if retirement processing is deferred.

    Queue items are raw source vertex ids or typed query descriptors
    (anything with a ``.source`` attribute); the full descriptor comes back
    through :class:`LaneAssignment` so the engine can seed per-kind lane
    parameters. The scheduler is pure bookkeeping (no device state): the
    engine asks :meth:`fill_idle` for assignments at a sweep boundary,
    performs the reseed on the device, and reports convergence back through
    :meth:`retire`.

    ``obs`` (an :class:`repro_torch.obs.Observability`) mirrors the
    occupancy into metrics -- ``serve.lanes_busy`` / ``serve.queue_depth``
    gauges, ``lane.fill`` / ``lane.retire`` trace instants -- and is the
    free disabled plane by default.
    """

    def __init__(self, width: int, pending=(), obs=None):
        if width <= 0:
            raise ValueError(f"width must be positive, got {width}")
        self.width = int(width)
        self.obs = obs if obs is not None else NULL_OBS
        self.pending: deque = deque(pending)
        self.lane_item: list = [None] * self.width
        self.lane_source = np.full(self.width, -1, dtype=np.int64)
        self.lane_generation = np.zeros(self.width, dtype=np.int64)
        self.busy = np.zeros(self.width, dtype=bool)

    def _note_occupancy(self) -> None:
        m = self.obs.metrics
        m.gauge("serve.lanes_busy").set(self.n_busy)
        m.gauge("serve.queue_depth").set(len(self.pending))

    def submit(self, item) -> None:
        """Queue a source vertex id or a typed query descriptor."""
        self.pending.append(item)

    def submit_stream(self, items, front: bool = False) -> int:
        """Queue many items at once (the streaming feed API); returns the
        number enqueued. Items become lane tenants at the next
        :meth:`fill_idle` boundary -- submission never touches lanes.

        ``front=True`` queues the batch *ahead* of everything already
        pending while preserving the batch's own order."""
        items = list(items)
        if front:
            self.pending.extendleft(reversed(items))
        else:
            self.pending.extend(items)
        return len(items)

    def poll(self) -> dict:
        """Snapshot of the in-flight lanes: {lane: (item, generation)}."""
        return {int(lane): (self.lane_item[lane],
                            int(self.lane_generation[lane]))
                for lane in np.nonzero(self.busy)[0]}

    @property
    def n_busy(self) -> int:
        return int(self.busy.sum())

    @property
    def n_pending(self) -> int:
        return len(self.pending)

    def fill_idle(self) -> list[LaneAssignment]:
        """Assign pending queries to idle lanes (lowest lane first); bumps
        each assigned lane's generation. Returns the assignments made."""
        out: list[LaneAssignment] = []
        for lane in range(self.width):
            if self.busy[lane] or not self.pending:
                continue
            item = self.pending.popleft()
            source = int(getattr(item, "source", item))
            self.lane_generation[lane] += 1
            self.lane_item[lane] = item
            self.lane_source[lane] = source
            self.busy[lane] = True
            out.append(LaneAssignment(lane, source,
                                      int(self.lane_generation[lane]), item))
        if out and self.obs.enabled:
            self.obs.trace.instant("lane.fill", lanes=len(out))
            self._note_occupancy()
        return out

    def retire(self, lane: int):
        """Mark a converged lane idle; returns its (item, generation) --
        ``item`` is exactly what was submitted (a raw source id round-trips
        as the int it was)."""
        if not self.busy[lane]:
            raise ValueError(f"lane {lane} is not busy")
        self.busy[lane] = False
        if self.obs.enabled:
            self.obs.trace.instant(
                "lane.retire", lane=int(lane),
                generation=int(self.lane_generation[lane]))
            self._note_occupancy()
        return self.lane_item[lane], int(self.lane_generation[lane])
