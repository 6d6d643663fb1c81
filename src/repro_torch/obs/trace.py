"""Low-overhead structured tracing for the serving stack.

A :class:`Tracer` records timestamped *spans* (named intervals with
attributes: sweep blocks, host boundaries, reseeds, gathers) and *instant*
events (cache/component/dedup resolutions) into a fixed-capacity ring
buffer.  Design constraints, in order:

* **Zero cost when disabled.** A disabled tracer's ``span()`` returns one
  shared no-op context manager and ``instant()`` returns immediately --
  no clock reads, no allocation.  Hot loops additionally guard on
  ``tracer.enabled`` so even argument construction is skipped.
* **Never perturb the schedule.** The tracer only reads a host clock; it
  never touches device arrays, so a traced serving run executes the exact
  same sweeps (and ``ServeStats`` counters) as an untraced one -- pinned
  by ``tests/test_torch_obs.py``.
* **Bounded memory.** Events land in a ring buffer (``capacity`` events);
  when full, the oldest events are overwritten and counted in
  ``dropped`` -- a long-lived serving process can leave tracing on.
* **Deterministic in tests.** The clock is injectable (same pattern as
  ``serve/cache.py``): pass a fake ``clock`` and every timestamp --
  and therefore every exported trace -- is reproducible.

The export format is Chrome ``trace_event`` JSON (the subset Perfetto and
``chrome://tracing`` both read): complete events (``"ph": "X"``) for
spans, instant events (``"ph": "i"``) for point occurrences, metadata
(``"ph": "M"``) for naming.  ``export(path)`` writes a file you can drop
straight into https://ui.perfetto.dev. The serving engine's events are
listed in :mod:`repro_torch.obs`.
"""
from __future__ import annotations

import json
import time
from collections import deque
from dataclasses import dataclass, field


@dataclass(frozen=True)
class TraceEvent:
    """One recorded event. ``ts``/``dur`` are seconds on the tracer's
    clock (exported as microseconds, the trace_event convention);
    ``depth`` is the span-nesting depth at record time (0 = top level),
    ``dur`` is None for instant events."""

    name: str
    ts: float
    dur: float | None = None
    depth: int = 0
    args: dict = field(default_factory=dict)

    @property
    def is_span(self) -> bool:
        return self.dur is not None


class _NullSpan:
    """Shared no-op context manager handed out by disabled tracers."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args) -> None:
        """No-op attribute update (mirror of :meth:`_Span.set`)."""


NULL_SPAN = _NullSpan()


class _Span:
    """Context manager recording one complete ("X") event on exit."""

    __slots__ = ("_tracer", "name", "args", "_t0", "_depth")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.args = args

    def set(self, **args) -> None:
        """Attach/overwrite attributes mid-span (e.g. how many lanes a
        boundary retired -- known only after the work ran)."""
        self.args.update(args)

    def __enter__(self):
        self._depth = self._tracer._depth
        self._tracer._depth += 1
        self._t0 = self._tracer._clock()
        return self

    def __exit__(self, *exc):
        t1 = self._tracer._clock()
        self._tracer._depth = self._depth
        self._tracer._record(TraceEvent(
            name=self.name, ts=self._t0, dur=t1 - self._t0,
            depth=self._depth, args=self.args))
        return False


class Tracer:
    """Ring-buffered span/instant recorder with an injectable clock.

    Parameters
    ----------
    capacity : ring-buffer size in events; the oldest events are
        overwritten (and counted in ``dropped``) once full.
    clock : seconds-returning callable (default ``time.perf_counter``);
        inject a fake for deterministic tests.
    enabled : a disabled tracer records nothing and hands out the shared
        :data:`NULL_SPAN` -- construct-once, toggle-never, so callers can
        keep one code path.
    """

    def __init__(self, capacity: int = 65536, clock=time.perf_counter,
                 enabled: bool = True):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.enabled = bool(enabled)
        self._clock = clock
        self._events: deque[TraceEvent] = deque(maxlen=self.capacity)
        self._depth = 0
        self.dropped = 0

    def __len__(self) -> int:
        return len(self._events)

    def _record(self, ev: TraceEvent) -> None:
        if len(self._events) == self.capacity:
            self.dropped += 1
        self._events.append(ev)

    # -- recording API ------------------------------------------------------
    def span(self, name: str, **args):
        """Context manager timing a named interval; nesting is tracked so
        exported traces reconstruct the call structure."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, args)

    def instant(self, name: str, **args) -> None:
        """Record a point event (cache hit, dedup drop, ...)."""
        if not self.enabled:
            return
        self._record(TraceEvent(name=name, ts=self._clock(),
                                depth=self._depth, args=args))

    # -- introspection / export ---------------------------------------------
    def events(self) -> list[TraceEvent]:
        """Snapshot of the buffered events in record order (spans appear
        at their *end* time order, the trace_event convention for X
        events; viewers sort by ``ts``)."""
        return list(self._events)

    def clear(self) -> None:
        self._events.clear()
        self.dropped = 0

    def to_chrome(self, process_name: str = "repro_torch.serve") -> dict:
        """The buffered events as a Chrome ``trace_event`` JSON object
        (also what Perfetto's UI opens). Timestamps are microseconds."""
        us = 1e6
        trace: list[dict] = [{
            "ph": "M", "name": "process_name", "pid": 0, "tid": 0,
            "args": {"name": process_name},
        }]
        for ev in self._events:
            rec = {
                "name": ev.name, "pid": 0, "tid": 0,
                "ts": ev.ts * us,
                "cat": ev.name.split(".", 1)[0],
                "args": dict(ev.args),
            }
            if ev.is_span:
                rec["ph"] = "X"
                rec["dur"] = ev.dur * us
            else:
                rec["ph"] = "i"
                rec["s"] = "t"      # thread-scoped instant
            trace.append(rec)
        if self.dropped:
            trace[0]["args"]["dropped_events"] = self.dropped
        return {"traceEvents": sorted(
            (t for t in trace), key=lambda t: t.get("ts", -1.0)),
            "displayTimeUnit": "ms"}

    def export(self, path: str, process_name: str = "repro_torch.serve") -> None:
        """Write the Chrome/Perfetto trace JSON to ``path``."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(process_name), f)
