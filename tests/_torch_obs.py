"""Shared helpers of the observability parity tests: a deterministic
clock, reference <-> port query conversion, and the comparison of two
observability planes (the reference's and the port's) after the same run.

Imported only by ``tests/test_torch_*.py`` files, which skip without
torch before they import it."""
import collections
import re

from repro.serve import Query as RQ, QueryKind as RK
from repro_torch.serve import Query, QueryKind

#: histograms of seconds: their samples are clock readings, so only their
#: sample counts are compared across packages
TIME_HIST = re.compile(r"(latency_s|duration_s|wait_s|dispatch_s)")


class FakeClock:
    """Deterministic clock: every call advances by ``step`` seconds."""

    def __init__(self, step=1.0, t0=100.0):
        self.t = t0
        self.step = step

    def __call__(self):
        self.t += self.step
        return self.t


class ManualClock:
    """Settable clock: deterministic TTL and latency control."""

    def __init__(self, t0: float = 100.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t


def to_ref(q: Query) -> RQ:
    return RQ(q.source, RK(q.kind.value), max_depth=q.max_depth,
              targets=q.targets)


def to_port(q: RQ) -> Query:
    return Query(q.source, QueryKind(q.kind.value), max_depth=q.max_depth,
                 targets=q.targets)


def event_counts(obs) -> collections.Counter:
    return collections.Counter(e.name for e in obs.trace.events())


def assert_planes_equal(ref_obs, port_obs) -> None:
    """The same run observed by both packages: equal trace event names and
    counts, equal counters and gauges, and equal histograms -- whole
    summaries for value histograms, sample counts for time histograms."""
    assert event_counts(port_obs) == event_counts(ref_obs)
    a, b = ref_obs.metrics.snapshot(), port_obs.metrics.snapshot()
    assert b["counters"] == a["counters"]
    assert b["gauges"] == a["gauges"]
    assert set(b["histograms"]) == set(a["histograms"])
    for name, h in a["histograms"].items():
        if TIME_HIST.search(name):
            assert b["histograms"][name]["count"] == h["count"], name
        else:
            assert b["histograms"][name] == h, name


def assert_result_equal(a, b) -> None:
    import numpy as np

    if isinstance(b, dict):
        assert a == b
    else:
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
