"""Serving observability plane: structured tracing + metrics.

One :class:`Observability` object bundles the two sensors every serving
component shares:

* ``obs.trace`` -- a ring-buffered structured
  :class:`~repro_torch.obs.trace.Tracer` exporting Chrome/Perfetto
  ``trace_event`` JSON.
* ``obs.metrics`` -- a :class:`~repro_torch.obs.metrics.MetricsRegistry`
  of counters, gauges, and fixed-bucket histograms (per-kind
  submit->deliver latency, sweep duration, wire bytes, lane utilization)
  with deterministic p50/p95/p99 summaries.

Pass one to the engine -- ``BFSServeEngine(..., obs=Observability())`` --
and every pipeline stage becomes a span and every ``ServeStats`` counter a
metric. The engine's traversal schedule is identical with observability
on or off (the tracer reads a host clock and never touches a tensor), and
the default :data:`NULL_OBS` is free: disabled tracer + disabled
registry, both handing out shared no-op objects. Both clocks are
injectable (``Observability(clock=...)``) so tests drive deterministic
timestamps.

The serving engine's events (spans unless marked instant):

* ``engine.init`` (instant), ``serve.warmup``;
* batch mode: ``serve.submit_many`` (instant), ``serve.batch`` >
  ``serve.gather``;
* refill, overlap and stream sessions: ``serve.dedup`` (instant),
  ``serve.refill_drain``, ``serve.session.open``, ``serve.reseed``,
  ``lane.fill`` / ``lane.retire`` (instants of the lane scheduler),
  ``serve.sweep`` (per-sweep driver), ``serve.block.dispatch`` /
  ``serve.block.speculate`` (instants) and ``serve.block.wait``
  (overlapped driver), ``serve.boundary`` > ``serve.gather``,
  ``serve.gather.deferred``, ``serve.component.cut`` (instant),
  ``serve.session.close`` (instant);
* stream API: ``serve.submit_stream`` (instant), ``serve.poll``;
* memo hits: ``serve.cache.hit``, ``serve.component.hit`` (instants);
* the multi-tenant frontend: ``frontend.*`` instants.

Two device-plane companions live alongside the host-plane pair:
``obs/device.py`` harvests the sweeps' ``tm_*`` telemetry leaves into
``device.shard.<i>.*`` imbalance metrics, and ``obs/profile.py`` samples
dispatch->ready latencies (``BFSServeEngine(profile=...)``) and captures
``torch.profiler`` traces.
"""
from __future__ import annotations

import time

from .device import (SweepTelemetry, export_shard_metrics, harvest_telemetry,
                     skew)
from .metrics import (BYTES_BUCKETS, LATENCY_BUCKETS, NULL_INSTRUMENT,
                      RATIO_BUCKETS, Counter, Gauge, Histogram,
                      MetricsRegistry, exp_buckets, sanitize_label,
                      shard_metric, tenant_metric)
from .profile import NULL_PROFILER, DispatchProfiler, as_profiler
from .trace import NULL_SPAN, TraceEvent, Tracer


class Observability:
    """The tracer + metrics pair threaded through the serving stack.

    ``enabled=False`` (what :data:`NULL_OBS` is) builds disabled members:
    every ``span``/``instant``/``counter``/``histogram`` call degenerates
    to a shared no-op, so unconditionally-instrumented code costs nothing.
    """

    def __init__(self, *, enabled: bool = True, trace_capacity: int = 65536,
                 clock=time.perf_counter):
        self.enabled = bool(enabled)
        self.clock = clock
        self.trace = Tracer(capacity=trace_capacity, clock=clock,
                            enabled=self.enabled)
        self.metrics = MetricsRegistry(enabled=self.enabled)

    def export(self, trace_path: str | None = None,
               metrics_path: str | None = None) -> None:
        """Write the Perfetto trace and/or the metrics snapshot JSON."""
        if trace_path is not None:
            self.trace.export(trace_path)
        if metrics_path is not None:
            self.metrics.export_json(metrics_path)


#: the shared disabled plane (what an engine without ``obs=`` runs on)
NULL_OBS = Observability(enabled=False)


__all__ = [
    "BYTES_BUCKETS", "Counter", "DispatchProfiler", "Gauge", "Histogram",
    "LATENCY_BUCKETS", "MetricsRegistry", "NULL_INSTRUMENT", "NULL_OBS",
    "NULL_PROFILER", "NULL_SPAN", "Observability", "RATIO_BUCKETS",
    "SweepTelemetry", "TraceEvent", "Tracer", "as_profiler", "exp_buckets",
    "export_shard_metrics", "harvest_telemetry", "sanitize_label",
    "shard_metric", "skew", "tenant_metric",
]
