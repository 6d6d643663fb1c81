"""Metrics registry: counters, gauges, fixed-bucket histograms.

The aggregate sibling of ``obs/trace.py``: where the tracer answers
"what happened when", the registry answers "what are the distributions" --
per-kind submit->deliver latency, sweep duration, wire bytes per sweep,
lane utilization -- cheaply enough to leave on in production serving.
Framework-free (the reference package's module, copied).

Histograms use **fixed bucket boundaries** chosen at construction, so

* recording is O(log #buckets) with no per-sample storage,
* percentile summaries are deterministic functions of the bucket counts
  (linear interpolation inside the covering bucket, clamped to the
  observed min/max) -- two runs recording the same samples report
  byte-identical p50/p95/p99, which is what lets tests pin them.

``MetricsRegistry.snapshot()`` returns a plain JSON-serializable dict
(counters, gauges, histogram summaries); ``render_text()`` is the human
one-metric-per-line form and ``export_json(path)`` writes the snapshot --
the artifact a benchmark run keeps.

A disabled registry (``enabled=False``) hands out shared no-op
instruments: the serving engine constructs its metric handles
unconditionally and pays nothing when observability is off.
"""
from __future__ import annotations

import bisect
import json
import math
import re


def exp_buckets(lo: float, hi: float, per_decade: int = 3) -> tuple:
    """Exponential bucket upper bounds from ``lo`` to >= ``hi``
    (``per_decade`` buckets per power of ten) -- the default shape for
    latency- and byte-valued histograms, whose interesting range spans
    decades."""
    if not (0 < lo < hi):
        raise ValueError(f"need 0 < lo < hi, got {lo}, {hi}")
    step = 10.0 ** (1.0 / per_decade)
    out, b = [], lo
    while b < hi * (1 + 1e-12):
        out.append(b)
        b *= step
    return tuple(out)


#: default bounds: seconds, 1us .. ~1000s (latency, sweep durations)
LATENCY_BUCKETS = exp_buckets(1e-6, 1e3, per_decade=3)
#: default bounds: bytes, 1B .. ~1GiB (wire volume per sweep/traversal)
BYTES_BUCKETS = exp_buckets(1.0, 2.0 ** 30, per_decade=2)
#: default bounds: dimensionless small ratios/counts (utilization, fusion)
RATIO_BUCKETS = tuple(x / 20.0 for x in range(1, 21)) + tuple(
    float(x) for x in (2, 4, 8, 16, 32, 64))


class Counter:
    """Monotonic counter."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n=1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v) -> None:
        self.value = v


class Histogram:
    """Fixed-bucket histogram with exact count/sum/min/max.

    ``bounds`` are the inclusive upper bounds of the finite buckets; one
    implicit overflow bucket catches everything beyond ``bounds[-1]``.
    """

    __slots__ = ("bounds", "counts", "count", "sum", "min", "max")

    def __init__(self, bounds=LATENCY_BUCKETS):
        bounds = tuple(float(b) for b in bounds)
        if not bounds or any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
            raise ValueError("bounds must be non-empty and increasing")
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)    # +1: overflow bucket
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def record(self, v) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def percentile(self, p: float) -> float:
        """Deterministic bucket-interpolated percentile (p in [0, 100]).

        The rank ``p/100 * count`` is located in the cumulative bucket
        counts; the estimate interpolates linearly across the covering
        bucket's width and is clamped to the observed [min, max] (which
        also gives the overflow bucket a finite answer)."""
        if self.count == 0:
            return 0.0
        rank = (p / 100.0) * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= rank:
                lo = 0.0 if i == 0 else self.bounds[i - 1]
                hi = self.bounds[i] if i < len(self.bounds) else self.max
                frac = (rank - cum) / c
                est = lo + (hi - lo) * max(0.0, min(1.0, frac))
                return max(self.min, min(self.max, est))
            cum += c
        return self.max

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def summary(self) -> dict:
        return {
            "count": self.count, "sum": self.sum, "mean": self.mean,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "p50": self.percentile(50), "p95": self.percentile(95),
            "p99": self.percentile(99),
        }


class _NullInstrument:
    """Shared no-op counter/gauge/histogram for disabled registries."""

    __slots__ = ()
    value = 0
    count = 0

    def inc(self, n=1) -> None: pass
    def set(self, v) -> None: pass
    def record(self, v) -> None: pass
    def summary(self) -> dict: return {}


NULL_INSTRUMENT = _NullInstrument()


class MetricsRegistry:
    """Name -> instrument registry with a plain-dict snapshot exporter.

    Instruments are created on first use and shared thereafter
    (re-requesting a histogram ignores ``bounds``); names are free-form
    but the serving stack uses dotted paths (``serve.latency_s.levels``)
    so snapshots group naturally. A per-kind family is just a name
    suffix: ``registry.histogram(f"serve.latency_s.{kind}")``.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        if not self.enabled:
            return NULL_INSTRUMENT
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        if not self.enabled:
            return NULL_INSTRUMENT
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str, bounds=None) -> Histogram:
        if not self.enabled:
            return NULL_INSTRUMENT
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(
                bounds if bounds is not None else LATENCY_BUCKETS)
        return h

    # -- export -------------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-serializable view: {counters, gauges, histograms} with
        p50/p95/p99 summaries per histogram."""
        return {
            "counters": {k: c.value
                         for k, c in sorted(self._counters.items())},
            "gauges": {k: g.value for k, g in sorted(self._gauges.items())},
            "histograms": {k: h.summary()
                           for k, h in sorted(self._histograms.items())},
        }

    def render_text(self) -> str:
        """One metric per line (counters/gauges: ``name value``;
        histograms: name + count/mean/percentiles)."""
        snap = self.snapshot()
        lines = []
        for k, v in snap["counters"].items():
            lines.append(f"{k} {v}")
        for k, v in snap["gauges"].items():
            lines.append(f"{k} {v:g}")
        for k, s in snap["histograms"].items():
            lines.append(
                f"{k} count={s['count']} mean={s['mean']:g} "
                f"p50={s['p50']:g} p95={s['p95']:g} p99={s['p99']:g} "
                f"max={s['max']:g}")
        return "\n".join(lines)

    def export_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2)


# -- per-tenant metric naming ------------------------------------------------
# Metric names are dot-separated hierarchies (``serve.cache.hits``); tenant
# and graph names come from callers and may contain anything, so they are
# sanitized into one path segment before being embedded -- a tenant named
# ``"acme.eu"`` must not silently fork the hierarchy.
_LABEL_UNSAFE = re.compile(r"[^0-9A-Za-z_\-]")


def sanitize_label(label) -> str:
    """Metric-segment-safe form of a free-form label: every character
    outside ``[0-9A-Za-z_-]`` (dots included -- they are the hierarchy
    separator) becomes ``_``; empty labels become ``_``."""
    return _LABEL_UNSAFE.sub("_", str(label)) or "_"


def tenant_metric(tenant, suffix: str) -> str:
    """The canonical per-tenant metric name: ``serve.tenant.<tenant>.
    <suffix>`` with the tenant label sanitized. One naming choke point so
    dashboards can glob ``serve.tenant.*`` and every frontend counter,
    gauge, and histogram for a tenant lands under one subtree."""
    return f"serve.tenant.{sanitize_label(tenant)}.{suffix}"


def shard_metric(shard, suffix: str) -> str:
    """The canonical per-shard (mesh-device) metric name:
    ``device.shard.<shard>.<suffix>`` -- the device-plane sibling of
    :func:`tenant_metric` (obs/device.py feeds these from harvested sweep
    telemetry; dashboards glob ``device.shard.*``)."""
    return f"device.shard.{sanitize_label(shard)}.{suffix}"
