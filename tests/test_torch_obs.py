"""The port's observability plane (``repro_torch.obs``) against the
reference's (``repro.obs``), and the engine hooks that report into it.

* Tracer and metrics unit pins (injectable clock, ring overflow,
  deterministic percentiles -- equal to the reference's on the same
  samples -- Chrome export validity), the cache's counter mirror and
  ``ServeStats.as_dict`` exactness.
* The plane's central invariant: attaching tracing, metrics and the
  dispatch profiler to the engine never changes the traversal schedule --
  every ``ServeStats`` field, every answer and the fused blocks' sweep
  counts are equal on and off -- in batch, refill, overlap and stream
  modes; and the port's run, observed with a fake clock, gives the
  reference's trace (event names and counts) and metrics (every counter
  and gauge, every value histogram whole, every time histogram's count).

rmat scale 8, W = 4, the reference tests' fixtures. Exact equality
throughout (the histogram percentiles are computed by the same code on
the same samples)."""
import dataclasses
import json

import pytest
pytest.importorskip("torch")

import _torch_obs as TO
from repro.core import msbfs as RM
from repro.core.partition import partition_graph
from repro.graphs.rmat import pick_sources, rmat_graph
from repro.obs import Histogram as RefHistogram, Observability as RefObs
from repro.serve import BFSServeEngine as RefEngine
from repro_torch.core import convert, msbfs as TM
from repro_torch.obs import (LATENCY_BUCKETS, NULL_INSTRUMENT, NULL_OBS,
                             NULL_SPAN, Histogram, MetricsRegistry,
                             Observability, Tracer, exp_buckets,
                             shard_metric)
from repro_torch.serve import (BFSServeEngine, Query, QueryKind,
                               oracle_check)
from repro_torch.serve.cache import LRUCache
from repro_torch.serve.engine import ServeStats


# ------------------------------------------------------------------ tracer
def test_span_nesting_depth_and_duration():
    tr = Tracer(clock=TO.FakeClock(step=1.0))
    with tr.span("outer"):
        with tr.span("inner", k=3):
            tr.instant("mark", v=7)
    by_name = {e.name: e for e in tr.events()}
    assert set(by_name) == {"outer", "inner", "mark"}
    assert by_name["outer"].depth == 0 and by_name["inner"].depth == 1
    assert by_name["mark"].dur is None and by_name["mark"].depth == 2
    assert by_name["inner"].args == {"k": 3}
    assert by_name["inner"].dur < by_name["outer"].dur
    assert by_name["outer"].ts < by_name["inner"].ts


def test_span_set_attaches_args_inside_block():
    tr = Tracer(clock=TO.FakeClock())
    with tr.span("work") as sp:
        sp.set(sweeps=12)
    (ev,) = tr.events()
    assert ev.args["sweeps"] == 12


def test_ring_buffer_overflow_counts_dropped():
    tr = Tracer(capacity=4, clock=TO.FakeClock())
    for i in range(10):
        tr.instant(f"e{i}")
    assert [e.name for e in tr.events()] == ["e6", "e7", "e8", "e9"]
    assert tr.dropped == 6 and len(tr) == 4
    assert tr.to_chrome()["traceEvents"][0]["args"]["dropped_events"] == 6
    tr.clear()
    assert tr.events() == [] and tr.dropped == 0
    with pytest.raises(ValueError):
        Tracer(capacity=0)


def test_disabled_tracer_is_free():
    tr = Tracer(enabled=False, clock=TO.FakeClock())
    assert tr.span("x") is NULL_SPAN
    tr.instant("y")
    assert tr.events() == []
    with NULL_SPAN as sp:
        sp.set(anything=1)


def test_chrome_export_is_valid(tmp_path):
    tr = Tracer(clock=TO.FakeClock(step=0.5))
    with tr.span("serve.batch", n=2):
        tr.instant("serve.cache.hit")
    path = tmp_path / "trace.json"
    tr.export(str(path))
    doc = json.loads(path.read_text())
    evs = doc["traceEvents"]
    assert {e["ph"] for e in evs} == {"M", "X", "i"}
    meta = [e for e in evs if e["ph"] == "M"]
    assert meta[0]["args"]["name"] == "repro_torch.serve"
    for e in evs:
        if e["ph"] == "M":
            continue
        assert e["ts"] >= 0 and e["pid"] == 0 and "tid" in e
        assert e["cat"] == "serve"
        if e["ph"] == "X":
            assert e["dur"] > 0
        else:
            assert e["s"] == "t"
    ts = [e["ts"] for e in evs if e["ph"] != "M"]
    assert ts == sorted(ts)


# ----------------------------------------------------------------- metrics
SAMPLES = [0.001, 0.01, 0.01, 0.1, 1.0, 10.0]


def test_histogram_percentiles_equal_reference():
    """Deterministic bucket-interpolated percentiles, clamped to the
    observed extremes, and the same numbers as the reference's histogram
    on the same samples."""
    bounds = exp_buckets(1e-3, 1e3, 3)
    h, r = Histogram(bounds=bounds), RefHistogram(bounds=bounds)
    for v in SAMPLES:
        h.record(v)
        r.record(v)
    assert h.summary() == r.summary()
    s = h.summary()
    assert s["count"] == 6 and s["min"] == pytest.approx(0.001)
    assert s["max"] == pytest.approx(10.0)
    assert s["mean"] == pytest.approx(sum(SAMPLES) / 6)
    for p in (0, 50, 95, 99, 100):
        assert h.percentile(p) == r.percentile(p)
        assert 0.001 <= h.percentile(p) <= 10.0
    assert h.percentile(50) <= h.percentile(95) <= h.percentile(99)
    with pytest.raises(ValueError):
        Histogram(bounds=(2.0, 1.0))
    with pytest.raises(ValueError):
        exp_buckets(1.0, 1.0)


def test_histogram_empty_single_and_extremes():
    h = Histogram(bounds=LATENCY_BUCKETS)
    assert h.percentile(50) == 0.0 and h.percentile(100) == 0.0
    assert h.summary()["count"] == 0
    h.record(0.25)
    assert h.percentile(50) == pytest.approx(0.25)
    assert h.percentile(99) == pytest.approx(0.25)
    for v in (0.002, 0.02):
        h.record(v)
    h.record(1e6)                               # overflow bucket
    assert h.percentile(0) == pytest.approx(0.002)
    assert h.percentile(100) == pytest.approx(1e6)


def test_shard_labeled_histogram_round_trip(tmp_path):
    reg = MetricsRegistry()
    for shard in range(2):
        h = reg.histogram(shard_metric(shard, "frontier_per_sweep"))
        for v in (4.0, 8.0, 8.0):
            h.record(v)
        reg.gauge(shard_metric(shard, "wire_bytes")).set(1024 * (shard + 1))
    snap = reg.snapshot()
    assert snap["histograms"]["device.shard.0.frontier_per_sweep"][
        "count"] == 3
    assert snap["gauges"]["device.shard.1.wire_bytes"] == 2048
    path = tmp_path / "metrics.json"
    reg.export_json(str(path))
    doc = json.loads(path.read_text())
    assert doc["histograms"]["device.shard.1.frontier_per_sweep"][
        "max"] == pytest.approx(8.0)
    text = reg.render_text()
    assert "device.shard.0.frontier_per_sweep" in text
    assert "device.shard.1.wire_bytes" in text
    assert shard_metric("a.b", "x") == "device.shard.a_b.x"


def test_registry_instruments_and_snapshot(tmp_path):
    reg = MetricsRegistry()
    reg.counter("a.hits").inc()
    reg.counter("a.hits").inc(2)
    reg.gauge("a.depth").set(7)
    reg.histogram("a.lat").record(0.5)
    snap = reg.snapshot()
    assert snap["counters"]["a.hits"] == 3
    assert snap["gauges"]["a.depth"] == 7
    assert snap["histograms"]["a.lat"]["count"] == 1
    text = reg.render_text()
    assert "a.hits 3" in text and "a.lat count=1" in text
    path = tmp_path / "metrics.json"
    reg.export_json(str(path))
    assert json.loads(path.read_text())["counters"]["a.hits"] == 3


def test_disabled_registry_is_free():
    reg = MetricsRegistry(enabled=False)
    assert reg.counter("x") is NULL_INSTRUMENT
    assert reg.gauge("y") is NULL_INSTRUMENT
    assert reg.histogram("z") is NULL_INSTRUMENT
    NULL_INSTRUMENT.inc()
    NULL_INSTRUMENT.set(3)
    NULL_INSTRUMENT.record(1.0)
    assert reg.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}
    assert not NULL_OBS.enabled


def test_cache_counters_mirror_into_metrics():
    clk = TO.FakeClock(step=1.0)
    obs = Observability(clock=clk)
    c = LRUCache(capacity=1, ttl=None, clock=clk, obs=obs)
    assert c.get("k") is None                   # miss
    c.put("k", 1)
    assert c.get("k") == 1                      # hit
    c.put("k2", 2)                              # evicts k
    c.put("k3", 3, ttl=0.5)                     # expires at the next read
    assert "k3" not in c
    snap = obs.metrics.snapshot()["counters"]
    assert snap == {"serve.cache.misses": 1, "serve.cache.hits": 1,
                    "serve.cache.evictions": 2, "serve.cache.expired": 1}
    assert (c.hits, c.misses, c.evictions, c.expired) == (1, 1, 2, 1)


def test_servestats_as_dict_exact():
    st = ServeStats()
    d = st.as_dict()
    expected = {f.name for f in dataclasses.fields(ServeStats)}
    assert set(d) == expected | {"wire_bytes_total"}
    assert d["wire_bytes_total"] == st.wire_bytes_total
    for f in dataclasses.fields(ServeStats):
        if isinstance(getattr(st, f.name), dict):
            d[f.name]["__probe__"] = 1
            assert "__probe__" not in getattr(st, f.name)


# --------------------------------------------- schedule stays the same
GRAPH = rmat_graph(8, seed=11)


@pytest.fixture(scope="module")
def parts():
    rpg = partition_graph(GRAPH, th=32, p_rank=2, p_gpu=2)
    return rpg, convert.partition_from_arrays(
        *convert.partition_to_arrays(rpg))


def mixed_queries(srcs):
    tg = tuple(int(s) for s in srcs[:2])
    kinds = [lambda s: Query(s),
             lambda s: Query(s, QueryKind.REACHABILITY),
             lambda s: Query(s, QueryKind.DISTANCE_LIMITED, max_depth=2),
             lambda s: Query(s, QueryKind.MULTI_TARGET, targets=tg)]
    return [kinds[i % 4](int(s)) for i, s in enumerate(srcs)]


MODES = {"batch": {}, "refill": dict(refill=True),
         "overlap": dict(refill=True, overlap=True),
         "stream": dict(refill=True, overlap=True, sweep_block=4)}


def serve(eng, mode, qs):
    """Answers in query order: ``submit_many``, or (stream) four chunks
    with a ``poll()`` after each, then ``drain_stream()``."""
    if mode != "stream":
        return eng.submit_many(qs)
    got = {}
    for i in range(0, len(qs), 2):
        eng.submit_stream(qs[i:i + 2])
        got.update(eng.poll())
    got.update(eng.drain_stream())
    return [got[q] for q in qs]


def block_sweeps(eng) -> dict:
    return {key: (b.runner.sweeps, b.runner.gated)
            for key, b in eng.blocks.items() if b.runner is not None}


@pytest.mark.parametrize("mode", list(MODES))
def test_obs_never_changes_schedule_and_matches_reference(parts, mode):
    """Obs + profiler on against off, and against the reference engine
    observed the same way: every ServeStats field and answer equal (and
    oracle-exact), the blocks' dispatched and gated sweeps equal, and the
    two planes equal under the same fake clock."""
    rpg, pg = parts
    qs = mixed_queries(pick_sources(GRAPH, 8, seed=3))
    cfg = TM.MSBFSConfig(n_queries=4, max_iters=96)
    on, off = [BFSServeEngine(pg=pg, cfg=cfg, cache_capacity=0,
                              device="cpu", **kw, **MODES[mode])
               for kw in (dict(obs=Observability(clock=TO.FakeClock()),
                               profile=True), {})]
    ref = RefEngine(pg=rpg, cfg=RM.MSBFSConfig(n_queries=4, max_iters=96),
                    cache_capacity=0, obs=RefObs(clock=TO.FakeClock()),
                    profile=True, **MODES[mode])
    a_on, a_off = serve(on, mode, qs), serve(off, mode, qs)
    a_ref = serve(ref, mode, [TO.to_ref(q) for q in qs])
    assert on.stats.as_dict() == off.stats.as_dict() == ref.stats.as_dict()
    assert block_sweeps(on) == block_sweeps(off)
    for q, a, b, c in zip(qs, a_on, a_off, a_ref):
        TO.assert_result_equal(a, b)
        TO.assert_result_equal(a, c)
        oracle_check(GRAPH, q, a)
    TO.assert_planes_equal(ref.obs, on.obs)
    assert on.profiler.sampled == on.profiler.dispatches == \
        ref.profiler.dispatches > 0
    assert on.profiler.summary()["dispatch_latency_s"].keys() == \
        ref.profiler.summary()["dispatch_latency_s"].keys()
    hists = on.obs.metrics.snapshot()["histograms"]
    assert any(k.startswith("serve.latency_s.") for k in hists)


def test_engine_trace_and_metrics_export(parts, tmp_path):
    """A traced serving run exports a valid Chrome trace and a metrics
    snapshot with per-kind latency percentiles and the stats gauges."""
    _, pg = parts
    obs = Observability()
    eng = BFSServeEngine(pg=pg, cfg=TM.MSBFSConfig(n_queries=4, max_iters=96),
                         cache_capacity=0, refill=True, obs=obs,
                         device="cpu")
    eng.submit_many(mixed_queries(pick_sources(GRAPH, 8, seed=5)))
    tpath, mpath = tmp_path / "trace.json", tmp_path / "metrics.json"
    obs.export(str(tpath), str(mpath))
    names = {e["name"] for e in json.loads(tpath.read_text())["traceEvents"]}
    assert {"engine.init", "serve.submit_many", "serve.refill_drain",
            "serve.session.open", "serve.reseed", "serve.sweep",
            "serve.boundary", "serve.gather", "lane.fill", "lane.retire",
            "serve.session.close"} <= names
    snap = json.loads(mpath.read_text())
    for kind in ("levels", "reachability", "distance_limited",
                 "multi_target"):
        h = snap["histograms"][f"serve.latency_s.{kind}"]
        assert h["count"] == 2 and 0 <= h["p50"] <= h["p99"]
    assert snap["gauges"]["serve.stats.sweeps"] == eng.stats.sweeps
    assert snap["gauges"]["serve.lane_utilization"] == pytest.approx(
        eng.stats.lane_utilization)
    assert snap["histograms"]["serve.session_sweeps"]["count"] == 1
