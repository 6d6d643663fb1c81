"""The port's multi-tenant serving frontend (``repro_torch.serve.
ServeFrontend``) and the engine behaviour it leans on, against the
reference's ``repro.serve.ServeFrontend``.

* ``BENCH_serving.json`` ``frontend`` is reproduced exactly at scale 7
  (its tailed graphs, four tenants, W = 32, chunks of 4 with a blocking
  poll between): sweeps, sweep blocks, kind counts and ``lanes_used`` of
  both engines; every answer, ``TenantStats`` and ``ServeStats`` field,
  the trace's event names and counts and the non-time metrics equal the
  reference frontend's on the same partitions.
* The analogs of ``tests/test_serve_frontend.py``: the content digest
  ``graph_id``, the LRU's TTL on the obs clock, single non-blocking polls
  delivering memo hits, SLO preemption, mixed tenants equal to
  back-to-back runs (and oracle-exact), one traversal for a query shared
  by two sessions, atomic quota rejection, the shared ``runner_cache``
  (the graph memory pool on a card), traffic-skew warming and the
  per-tenant metrics.
* ``examples/torch_frontend_serving.py`` runs on the CPU.

Two same-shape different-content graphs are built by relabelling
``v -> (v + p) % n`` (the reference tests' construction). Exact equality
throughout."""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
pytest.importorskip("torch")

import _torch_obs as TO
from repro.core import msbfs as RM
from repro.core.partition import partition_graph as ref_partition
from repro.graphs.rmat import rmat_graph as ref_rmat
from repro.obs import Observability as RefObs
from repro.serve import ServeFrontend as RefFrontend
from repro_torch.core import convert, msbfs as M
from repro_torch.core.types import COOGraph
from repro_torch.graphs.rmat import rmat_graph
from repro_torch.graphs.synthetic import with_tails
from repro_torch.obs import Observability, sanitize_label, tenant_metric
from repro_torch.serve import (BFSServeEngine, LRUCache, LaneScheduler,
                               Query, QueryKind, QuotaExceeded, SLO_LATENCY,
                               SLO_THROUGHPUT, ServeFrontend,
                               default_graph_id, oracle_check, warm_queries)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = 4  # p_rank * p_gpu everywhere below
_ENG = dict(th=32, p_rank=2, p_gpu=2, device="cpu",
            cfg=M.MSBFSConfig(n_queries=4, max_iters=80))


def _shifted(g: COOGraph, shift: int) -> COOGraph:
    """Relabel ``v -> (v + shift) % n``: same degree multiset, different
    edges; partition-shape-preserving when ``shift == p`` and p | n."""
    return COOGraph(g.n, (np.asarray(g.src) + shift) % g.n,
                    (np.asarray(g.dst) + shift) % g.n)


@pytest.fixture(scope="module")
def graphs():
    g1 = rmat_graph(7, seed=3)
    return g1, _shifted(g1, P)


# -- BENCH_serving.json ``frontend``, and the reference frontend ---------
BENCH_ENGINES = {"g1": (135, 29), "g2": (137, 27)}   # sweeps, sweep_blocks
BENCH_KINDS = {"levels": 10, "reachability": 10, "distance_limited": 10,
               "multi_target": 2}
TENANT_KINDS = {"levels": 5, "reachability": 5, "distance_limited": 5,
                "multi_target": 1}


@pytest.fixture(scope="module")
def bench():
    """The section's workload (``benchmarks/serving_frontend.py`` at scale
    7): two tailed graphs (8 tails of 64), four tenants of 16 queries,
    W = 32, ``max_iters`` 176, caches and component reuse off."""
    from benchmarks import serving_frontend as BF

    graphs = {"g1": BF._make_graph(7, 3, 8, 64),
              "g2": BF._make_graph(7, 11, 8, 64)}
    tenants = {}
    for gi, (gname, (core, _, tips)) in enumerate(graphs.items()):
        for half, slo in enumerate((SLO_LATENCY, SLO_THROUGHPUT)):
            qs = BF._tenant_queries(core, tips[half * 4:(half + 1) * 4], 16,
                                    half, seed=17 + gi, max_depth=3)
            tenants[f"tenant{2 * gi + half}"] = (gname, slo, qs)
    rpgs = {n: ref_partition(g, th=64, p_rank=2, p_gpu=2)
            for n, (_, g, _) in graphs.items()}
    pgs = {n: convert.partition_from_arrays(*convert.partition_to_arrays(r))
           for n, r in rpgs.items()}
    return BF, graphs, tenants, rpgs, pgs


def test_bench_frontend_section_reproduced_and_equal_reference(bench):
    BF, graphs, tenants, rpgs, pgs = bench
    port_tenants = {t: (g, slo, [TO.to_port(q) for q in qs])
                    for t, (g, slo, qs) in tenants.items()}
    ref = RefFrontend(obs=RefObs(clock=TO.FakeClock()), cache_capacity=0,
                      reuse_components=False)
    ft = ServeFrontend(obs=Observability(clock=TO.FakeClock()),
                       cache_capacity=0, reuse_components=False,
                       device="cpu")
    for n in graphs:
        ref.register_graph(n, pg=rpgs[n],
                           cfg=RM.MSBFSConfig(n_queries=32, max_iters=176))
        ft.register_graph(n, pg=pgs[n],
                          cfg=M.MSBFSConfig(n_queries=32, max_iters=176))
    want = BF._run_mux(ref, tenants, 4)
    got = BF._run_mux(ft, port_tenants, 4)
    for n, (sweeps, blocks) in BENCH_ENGINES.items():
        s = ft.engines[n].stats
        assert (s.sweeps, s.sweep_blocks, s.lanes_used) == (sweeps, blocks,
                                                            32)
        assert s.kind_counts == BENCH_KINDS
        assert s.as_dict() == ref.engines[n].stats.as_dict()
        assert ft.engines[n].graph_id == ref.engines[n].graph_id
    for t, (gname, _, qs) in port_tenants.items():
        ts = ft.tenant_stats(t)
        assert ts.as_dict() == ref.tenant_stats(t).as_dict()
        assert (ts.submitted, ts.delivered) == (16, 16)
        assert ts.kind_counts == TENANT_KINDS
        assert set(got[t]) == set(qs)
        for q in qs:
            TO.assert_result_equal(got[t][q], want[t][TO.to_ref(q)])
        for q in qs[:4]:
            oracle_check(graphs[gname][1], q, got[t][q])
    TO.assert_planes_equal(ref.obs, ft.obs)


# -- content-hashed default graph_id, LRU clock ---------------------------
def test_default_graph_id_hashes_content(graphs):
    g1, g2 = graphs
    e1 = BFSServeEngine(g1, cache_capacity=0, **_ENG)
    e2 = BFSServeEngine(g2, cache_capacity=0, **_ENG)
    pre1, pre2 = (eid.rsplit("-", 1)[0] for eid in (e1.graph_id,
                                                     e2.graph_id))
    assert pre1 == pre2 and e1.graph_id != e2.graph_id
    assert BFSServeEngine(g1, cache_capacity=0, **_ENG).graph_id == \
        e1.graph_id
    assert BFSServeEngine(g1, graph_id="epoch-7", cache_capacity=0,
                          **_ENG).graph_id == "epoch-7"
    assert default_graph_id(e1.pg) == e1.graph_id


def test_same_shape_graphs_cannot_share_cache(graphs):
    g1, g2 = graphs
    q = Query(3)
    e1 = BFSServeEngine(g1, **_ENG)
    a1 = e1.submit(q)
    e2 = BFSServeEngine(g2, **_ENG)
    e2.cache = e1.cache          # a cache outliving engine 1
    before = e2.cache.misses
    a2 = e2.submit(q)
    assert e2.cache.misses == before + 1
    oracle_check(g2, q, a2)
    assert not np.array_equal(a1, a2)
    assert q.key(e1.graph_id) in e1.cache and q.key(e2.graph_id) in e1.cache


def test_lru_ttl_follows_obs_clock():
    clk = TO.ManualClock(t0=50.0)
    obs = Observability(clock=clk)
    cache = LRUCache(8, ttl=5.0, obs=obs)
    cache.put("k", "v")
    clk.t = 54.9
    assert cache.get("k") == "v"
    clk.t = 55.0
    obs.trace.instant("at_expiry")
    assert cache.get("k") is None and cache.expired == 1
    assert obs.trace.events()[-1].ts == pytest.approx(55.0)
    other = TO.ManualClock(t0=0.0)               # an explicit clock wins
    c2 = LRUCache(8, ttl=5.0, clock=other, obs=obs)
    c2.put("k", "v")
    clk.t = 1e9
    assert c2.get("k") == "v"
    c3 = LRUCache(4, ttl=3600.0)
    assert c3._clock is time.monotonic


def test_engine_threads_obs_clock_into_cache(graphs):
    g1, _ = graphs
    clk = TO.ManualClock()
    eng = BFSServeEngine(g1, cache_ttl=10.0, obs=Observability(clock=clk),
                         **_ENG)
    assert eng.cache._clock is clk
    q = Query(2)
    a = eng.submit(q)
    clk.t += 9.9
    assert eng.cache.get(q.key(eng.graph_id)) is not None
    clk.t += 0.2
    assert eng.cache.get(q.key(eng.graph_id)) is None
    oracle_check(g1, q, a)


# -- single non-blocking polls deliver memo hits --------------------------
@pytest.fixture(scope="module")
def hits_engine(graphs):
    g1, _ = graphs
    return g1, BFSServeEngine(g1, refill=True, overlap=True,
                              specialize_reachability=False, **_ENG)


def test_single_nonblocking_poll_delivers_memo_hits(hits_engine):
    """Cache hits, then component hits, then dedup hits: each set is
    resolved at submit and handed out by one ``poll(wait=False)``."""
    g, eng = hits_engine
    qs = [Query(1), Query(2), Query(3)]
    eng.submit_many(qs)                      # warm the LRU
    assert eng.submit_stream(qs) == 0
    out = eng.poll(wait=False)
    assert set(out) == set(qs)
    for q in qs:
        oracle_check(g, q, out[q])
    assert eng.stream_status()["undelivered"] == 0
    mask = eng.submit(Query(4, QueryKind.REACHABILITY))
    others = [int(v) for v in np.nonzero(mask)[0] if v != 4][:3]
    rq = [Query(s, QueryKind.REACHABILITY) for s in others]
    pre = eng.stats.component_hits
    assert eng.submit_stream(rq) == 0
    assert eng.stats.component_hits == pre + len(rq)
    out = eng.poll(wait=False)
    assert set(out) == set(rq)
    for q in rq:
        oracle_check(g, q, out[q])
    pre = eng.stats.dedup_hits
    eng.submit_stream([qs[0]])               # seen before: dedup + LRU hit
    eng.submit_stream([qs[0]])               # completed, undelivered twin
    assert eng.stats.dedup_hits == pre + 2
    assert set(eng.poll(wait=False)) == {qs[0]}


def test_nonblocking_poll_hits_bypass_busy_lanes(graphs):
    g1, _ = graphs
    g, tips = with_tails(g1, n_tails=1, length=60, seed=0)
    eng = BFSServeEngine(g, th=32, p_rank=2, p_gpu=2, device="cpu",
                         cfg=M.MSBFSConfig(n_queries=4, max_iters=160),
                         refill=True, overlap=True,
                         specialize_reachability=False)
    fast = [Query(1), Query(2)]
    eng.submit_many(fast)
    deep = Query(int(tips[0]))
    eng.submit_stream([deep])
    eng.poll(wait=False)
    assert eng.submit_stream(fast) == 0
    out = eng.poll(wait=False)
    assert set(fast) <= set(out)
    out = eng.drain_stream() | out
    oracle_check(g, deep, out[deep])


# -- SLO preemption, mixed tenants ----------------------------------------
def test_front_submit_preserves_batch_order():
    s = LaneScheduler(4, pending=["a", "b"])
    s.submit_stream(["c", "d"])
    s.submit_stream(["x", "y"], front=True)
    assert list(s.pending) == ["x", "y", "a", "b", "c", "d"]


def test_latency_class_preempts_queued_throughput(graphs):
    g1, _ = graphs
    ft = ServeFrontend()
    eng = ft.register_graph("g", g1, cache_capacity=0,
                            reuse_components=False, **_ENG)
    batch = ft.open_session("batch", "g", slo=SLO_THROUGHPUT)
    inter = ft.open_session("inter", "g", slo=SLO_LATENCY)
    ft.submit(batch, [Query(s) for s in range(10, 22)])
    assert eng.stream_status()["pending"] == 4      # the W=4 headroom
    assert len(ft._adm["g"][SLO_THROUGHPUT]) == 8
    lqs = [Query(2), Query(3)]
    ft.submit(inter, lqs)
    assert list(eng._stream.sched.pending)[:2] == lqs
    out = ft.drain()
    assert len(out[inter.sid]) == 2 and len(out[batch.sid]) == 12
    for q, a in (out[inter.sid] | out[batch.sid]).items():
        oracle_check(g1, q, a)


def _tenant_traces():
    """4 tenants over 2 graphs, mixed kinds and SLOs, disjoint sources."""
    return [
        ("acme", "g1", SLO_LATENCY,
         [Query(1), Query(2, QueryKind.REACHABILITY),
          Query(3, QueryKind.DISTANCE_LIMITED, max_depth=2)]),
        ("beta", "g1", SLO_THROUGHPUT,
         [Query(20), Query(21), Query(22, QueryKind.MULTI_TARGET,
                                      targets=(5, 9))]),
        ("gama", "g2", SLO_LATENCY,
         [Query(40, QueryKind.REACHABILITY), Query(41), Query(42)]),
        ("dlta", "g2", SLO_THROUGHPUT,
         [Query(60), Query(61, QueryKind.DISTANCE_LIMITED, max_depth=3),
          Query(62)]),
    ]


def _run_trace(ft, interleaved: bool, conv=lambda q: q):
    """Round-robin chunks of 1 with a blocking poll between rounds, or
    each tenant drained before the next; {tenant: {query: result}} and
    {tenant: TenantStats dict}."""
    traces = _tenant_traces()
    sessions = {t: ft.open_session(t, g, slo=slo) for t, g, slo, _ in traces}
    results = {t: {} for t, *_ in traces}

    def take(out):
        for sid, res in out.items():
            results[sid.split(":", 1)[0]].update(res)

    if interleaved:
        for i in range(max(len(qs) for *_, qs in traces)):
            for t, _, _, qs in traces:
                if i < len(qs):
                    ft.submit(sessions[t], [conv(qs[i])])
            take(ft.poll(wait=True))
    else:
        for t, _, _, qs in traces:
            ft.submit(sessions[t], [conv(q) for q in qs])
            take(ft.drain())
    take(ft.drain())
    return results, {t: ft.tenant_stats(t).as_dict() for t, *_ in traces}


def test_mixed_tenants_equal_back_to_back_and_reference():
    """Interleaved tenants equal back-to-back ones (answers and every
    TenantStats field but ``peak_in_flight``) and are oracle-exact; the
    interleaved run equals the reference frontend's (answers, every
    TenantStats and ServeStats field, trace and metrics)."""
    g1 = ref_rmat(7, seed=3)
    g2 = _shifted(g1, P)
    rpgs = {n: ref_partition(g, th=32, p_rank=2, p_gpu=2)
            for n, g in (("g1", g1), ("g2", g2))}
    port = []
    for interleaved in (True, False):
        ft = ServeFrontend(obs=Observability(clock=TO.FakeClock()))
        for n, rpg in rpgs.items():
            ft.register_graph(n, pg=convert.partition_from_arrays(
                *convert.partition_to_arrays(rpg)), cache_capacity=0,
                reuse_components=False, **_ENG)
        port.append((ft, *_run_trace(ft, interleaved)))
    ref = RefFrontend(obs=RefObs(clock=TO.FakeClock()))
    for n, rpg in rpgs.items():
        ref.register_graph(n, pg=rpg, cache_capacity=0,
                           reuse_components=False, th=32, p_rank=2, p_gpu=2,
                           cfg=RM.MSBFSConfig(n_queries=4, max_iters=80))
    ref_res, ref_stats = _run_trace(ref, True, TO.to_ref)
    (ft, mux_res, mux_stats), (_, seq_res, seq_stats) = port
    oracle = {"acme": g1, "beta": g1, "gama": g2, "dlta": g2}
    for t, _, _, qs in _tenant_traces():
        assert set(mux_res[t]) == set(qs) == set(seq_res[t])
        for q in qs:
            oracle_check(oracle[t], q, mux_res[t][q])
            TO.assert_result_equal(mux_res[t][q], seq_res[t][q])
            TO.assert_result_equal(mux_res[t][q], ref_res[t][TO.to_ref(q)])
        a = {k: v for k, v in mux_stats[t].items() if k != "peak_in_flight"}
        b = {k: v for k, v in seq_stats[t].items() if k != "peak_in_flight"}
        assert a == b
        assert a["in_flight"] == 0 and a["delivered"] == a["submitted"]
        assert mux_stats[t] == ref_stats[t]
    for n in rpgs:
        assert ft.engines[n].stats.as_dict() == \
            ref.engines[n].stats.as_dict()
    TO.assert_planes_equal(ref.obs, ft.obs)


def test_shared_query_across_sessions_traversed_once(graphs):
    g1, _ = graphs
    ft = ServeFrontend()
    eng = ft.register_graph("g", g1, cache_capacity=0,
                            reuse_components=False, **_ENG)
    s1, s2 = ft.open_session("a", "g"), ft.open_session("b", "g")
    q = Query(7)
    ft.submit(s1, [q])
    ft.submit(s2, [q])
    out = ft.drain()
    assert eng.stats.lanes_used == 1
    a1, a2 = out[s1.sid][q], out[s2.sid][q]
    np.testing.assert_array_equal(a1, a2)
    assert a1 is not a2
    oracle_check(g1, q, a1)
    assert ft.tenant_stats("b").dedup_hits == 1


# -- quotas ---------------------------------------------------------------
def test_quota_max_inflight_rejects_atomically(graphs):
    g1, _ = graphs
    ft = ServeFrontend(obs=Observability())
    eng = ft.register_graph("g", g1, cache_capacity=0, **_ENG)
    sess = ft.open_session("acme", "g", max_inflight=3)
    ft.submit(sess, [Query(1), Query(2)])
    pre_queries = eng.stats.queries
    with pytest.raises(QuotaExceeded):
        ft.submit(sess, [Query(3), Query(4)])   # 2 + 2 > 3
    ts = ft.tenant_stats("acme")
    assert ts.rejected == 2 and ts.in_flight == 2
    assert eng.stats.queries == pre_queries     # nothing reached the engine
    assert ft.obs.metrics.snapshot()["counters"][
        "serve.tenant.acme.rejected"] == 2
    assert ft.submit(sess, [Query(3)]) == 1
    ft.drain()
    assert ft.tenant_stats("acme").in_flight == 0
    assert ft.submit(sess, [Query(4), Query(5)]) == 2
    assert len(ft.drain()[sess.sid]) == 2


def test_quota_max_queries_lifetime_cap(graphs):
    g1, _ = graphs
    ft = ServeFrontend()
    ft.register_graph("g", g1, cache_capacity=0, **_ENG)
    sess = ft.open_session("acme", "g", max_queries=3)
    ft.submit(sess, [Query(1), Query(2)])
    with pytest.raises(QuotaExceeded):
        ft.submit(sess, [Query(3), Query(4)])
    assert ft.submit(sess, [Query(3)]) == 1
    ft.drain()
    ts = ft.tenant_stats("acme")
    assert (ts.submitted, ts.delivered, ts.rejected) == (3, 3, 2)
    with pytest.raises(ValueError):
        ft.submit(sess, [Query(10 ** 6)])        # out of range: whole reject


# -- the shared runner cache ----------------------------------------------
def test_engines_share_the_frontend_runner_cache(graphs):
    """Every engine a frontend builds holds the frontend's ``runner_cache``
    (on a card: the one graph memory pool of their captures); the blocks
    stay per engine, and same-shape graphs still answer for themselves."""
    g1, g2 = graphs
    ft = ServeFrontend()
    kw = dict(_ENG, th=10 ** 6, cache_capacity=0)
    e1 = ft.register_graph("g1", g1, **kw)
    e2 = ft.register_graph("g2", g2, **kw)
    assert e1._runners is e2._runners is ft.runner_cache
    assert e1.graph_id != e2.graph_id
    s1, s2 = ft.open_session("a", "g1"), ft.open_session("b", "g2")
    q = Query(3)
    ft.submit(s1, [q])
    ft.submit(s2, [q])
    out = ft.drain()
    oracle_check(g1, q, out[s1.sid][q])
    oracle_check(g2, q, out[s2.sid][q])
    assert not np.array_equal(out[s1.sid][q], out[s2.sid][q])
    assert set(e1.blocks) == set(e2.blocks) and len(e1.blocks) == 1
    assert all(e1.blocks[k] is not e2.blocks[k] for k in e1.blocks)
    assert ft.runner_cache == {}                 # no pool on the CPU
    with pytest.raises(ValueError):
        ft.register_graph("g1", g1, **kw)
    shared: dict = {}
    other = ServeFrontend(runner_cache=shared)
    assert other.register_graph("g", g1, **kw)._runners is shared


def test_different_shape_graphs_do_not_collide(graphs):
    g1, _ = graphs
    g3 = rmat_graph(8, seed=5)
    ft = ServeFrontend()
    ft.register_graph("g1", g1, cache_capacity=0, **_ENG)
    ft.register_graph("g3", g3, cache_capacity=0, **_ENG)
    s1, s3 = ft.open_session("a", "g1"), ft.open_session("b", "g3")
    ft.submit(s1, [Query(1)])
    ft.submit(s3, [Query(1)])
    out = ft.drain()
    oracle_check(g1, Query(1), out[s1.sid][Query(1)])
    oracle_check(g3, Query(1), out[s3.sid][Query(1)])
    with pytest.raises(KeyError):
        ft.open_session("c", "nope")
    with pytest.raises(ValueError):
        ft.open_session("c", "g1", slo="bulk")


# -- traffic-skew warming -------------------------------------------------
def test_warm_precomputes_hottest_uncached_sources(graphs):
    g1, _ = graphs
    ft = ServeFrontend()
    eng = ft.register_graph("g", g1, **_ENG)
    sess = ft.open_session("acme", "g")
    dl = lambda s: Query(s, QueryKind.DISTANCE_LIMITED, max_depth=2)
    ft.submit(sess, [dl(5)] * 3 + [dl(9)] * 2 + [dl(11)])
    ft.drain()
    assert ft.warm(budget=2)["g"] == [5, 9]
    assert ft.warmed["g"] == 4
    for s in (5, 9):
        for q in warm_queries([s]):
            assert q.key(eng.graph_id) in eng.cache
    pre = ft.tenant_stats("acme").cache_hits
    ft.submit(sess, [Query(5)])
    out = ft.drain()
    assert ft.tenant_stats("acme").cache_hits == pre + 1
    oracle_check(g1, Query(5), out[sess.sid][Query(5)])
    assert ft.warm(budget=8)["g"] == [11]
    assert ft.warm(budget=8)["g"] == []


def test_warm_queries_rejects_parameterized_kinds():
    for kind in (QueryKind.DISTANCE_LIMITED, QueryKind.MULTI_TARGET,
                 QueryKind.KHOP_SAMPLE):
        with pytest.raises(ValueError):
            warm_queries([1], kinds=(kind,))
    qs = warm_queries([1, 2])
    assert [(q.source, q.kind) for q in qs] == [
        (1, QueryKind.LEVELS), (1, QueryKind.REACHABILITY),
        (2, QueryKind.LEVELS), (2, QueryKind.REACHABILITY)]


# -- per-tenant observability ---------------------------------------------
def test_tenant_metric_naming():
    assert tenant_metric("acme", "latency_s.levels") == \
        "serve.tenant.acme.latency_s.levels"
    assert tenant_metric("acme.eu/west", "stats.delivered") == \
        "serve.tenant.acme_eu_west.stats.delivered"
    assert sanitize_label("") == "_"


def test_per_tenant_latency_and_stats_surface_in_metrics(graphs):
    g1, _ = graphs
    obs = Observability(clock=TO.ManualClock())
    ft = ServeFrontend(obs=obs, profile=True)
    eng = ft.register_graph("g", g1, cache_capacity=0, **_ENG)
    assert eng.profiler is ft.profiler and eng.obs is obs
    sess = ft.open_session("acme", "g", slo=SLO_LATENCY)
    ft.submit(sess, [Query(1), Query(2, QueryKind.REACHABILITY)])
    ft.drain()
    snap = obs.metrics.snapshot()
    h = snap["histograms"]["serve.tenant.acme.latency_s.levels"]
    assert h["count"] == 1 and h["max"] >= 0.0
    assert "serve.tenant.acme.latency_s.reachability" in snap["histograms"]
    g = snap["gauges"]
    assert g["serve.tenant.acme.stats.delivered"] == 2
    assert g["serve.tenant.acme.stats.in_flight"] == 0
    assert g["serve.tenant.acme.stats.kind_counts.levels"] == 1
    assert g["serve.frontend.sessions"] == 1
    assert ft.profiler.sampled > 0
    assert "profile.dispatch_s.block" in snap["histograms"]


def test_close_session_detaches_waiters(graphs):
    g1, _ = graphs
    ft = ServeFrontend()
    ft.register_graph("g", g1, cache_capacity=0, **_ENG)
    s1, s2 = ft.open_session("a", "g"), ft.open_session("b", "g")
    q = Query(8)
    ft.submit(s1, [q])
    ft.submit(s2, [q])
    assert ft.close_session(s1) == {}
    assert ft.close_session(s1) == {}
    assert ft.tenant_stats("a").in_flight == 0
    out = ft.drain()
    assert s1.sid not in out and set(out[s2.sid]) == {q}
    assert set(ft.results(s2)) == {q} and ft.results(s2) == {}
    with pytest.raises(ValueError):
        ft.submit(s1, [Query(9)])


# -- the example ----------------------------------------------------------
def test_frontend_example_runs_on_cpu(tmp_path):
    """``examples/torch_frontend_serving.py --scale 7 --device cpu
    --trace`` exits 0 and writes its exports."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    trace, metrics = tmp_path / "t.json", tmp_path / "m.json"
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples",
                                      "torch_frontend_serving.py"),
         "--scale", "7", "--device", "cpu", "--per-tenant", "12",
         "--trace", "--trace-out", str(trace), "--metrics-out",
         str(metrics)],
        capture_output=True, text=True, timeout=240, env=env, cwd=tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "OK" in r.stdout and trace.exists() and metrics.exists()


def test_frontend_engines_default_to_the_card(graphs, monkeypatch):
    """Like every entry point, the engines a frontend builds run on the
    card unless the caller asks for the CPU: without one they raise."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g1, _ = graphs
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeFrontend().register_graph("g", g1)
    assert ServeFrontend(device="cpu").register_graph("g", g1).device.type \
        == "cpu"
