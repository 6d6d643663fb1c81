"""The port's batch serving engine against the reference engine: the same
partition and the same mixed stream of the four bit kinds -- duplicates,
cache hits, component reuse, a levels-free reachability batch and more
misses than lanes -- must give equal answers and an equal
``ServeStats.as_dict()`` after every call."""
import numpy as np
import pytest
pytest.importorskip("torch")

from repro.core import msbfs as RM
from repro.core.partition import partition_graph
from repro.graphs.rmat import pick_sources, rmat_graph
from repro.serve import BFSServeEngine as RefEngine, LRUCache as RefLRU
from repro.serve import Query as RQ, QueryKind as RK
from repro_torch.core import bfs as TB, convert, msbfs as TM
from repro_torch.core.oracle import bfs_levels, reachable_mask
from repro_torch.core.types import COOGraph
from repro_torch.serve import BFSServeEngine, LRUCache, Query, QueryKind

W = 4


@pytest.fixture(scope="module")
def setup():
    g = rmat_graph(9, seed=5)
    rpg = partition_graph(g, th=32, p_rank=2, p_gpu=2)
    pg = convert.partition_from_arrays(*convert.partition_to_arrays(rpg))
    return g, rpg, pg


def engines(setup, **kw):
    g, rpg, pg = setup
    ref = RefEngine(pg=rpg, cfg=RM.MSBFSConfig(n_queries=W, max_iters=48), **kw)
    port = BFSServeEngine(pg=pg, cfg=TM.MSBFSConfig(n_queries=W, max_iters=48),
                          device="cpu", **kw)
    return ref, port


def to_ref(q: Query):
    return RQ(q.source, RK(q.kind.value), max_depth=q.max_depth,
              targets=q.targets)


def stream(g, pg):
    srcs = [int(s) for s in pick_sources(g, 8, seed=3)]
    dv = [int(v) for v in np.asarray(pg.delegate_vids)[:2]]
    lev = bfs_levels(g, srcs[0])
    near = [int(v) for v in np.nonzero((lev > 0) & (lev <= 3))[0][:3]]
    K = QueryKind
    return [
        Query(srcs[0]), Query(srcs[1], K.REACHABILITY),
        Query(srcs[2], K.DISTANCE_LIMITED, max_depth=2),
        Query(srcs[0], K.MULTI_TARGET, targets=tuple(near)),
        Query(dv[0]), Query(dv[0], K.REACHABILITY),
        Query(dv[1], K.MULTI_TARGET, targets=(srcs[0], dv[0])),
        Query(srcs[3], K.DISTANCE_LIMITED, max_depth=0),
        Query(srcs[0]),                                    # duplicate
        Query(srcs[4], K.REACHABILITY),                    # component reuse
        Query(srcs[5], K.DISTANCE_LIMITED, max_depth=1),
        Query(srcs[6]), Query(srcs[7], K.MULTI_TARGET, targets=(srcs[1],)),
        srcs[2],                                           # raw id: LEVELS
    ]


def assert_same(port_out, ref_out):
    assert len(port_out) == len(ref_out)
    for a, b in zip(port_out, ref_out):
        if isinstance(b, dict):
            assert a == b
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_mixed_stream_answers_and_stats_equal(setup):
    g, rpg, pg = setup
    ref, port = engines(setup)
    assert port.graph_id == ref.graph_id
    qs = stream(g, pg)
    rqs = [to_ref(q) if isinstance(q, Query) else q for q in qs]
    assert_same(port.submit_many(qs), ref.submit_many(rqs))
    assert port.stats.as_dict() == ref.stats.as_dict()
    assert port.stats.batches >= 3                   # > W misses
    # second pass: all cache hits, plus reachability from isolated vertices
    # (their own components: one levels-free batch)
    iso = [int(v) for v in np.nonzero(np.bincount(g.src, minlength=g.n) == 0)[0][:3]]
    more = qs[:5] + [Query(v, QueryKind.REACHABILITY) for v in iso]
    rmore = rqs[:5] + [RQ(v, RK.REACHABILITY) for v in iso]
    assert_same(port.submit_many(more), ref.submit_many(rmore))
    assert port.stats.as_dict() == ref.stats.as_dict()
    s = port.stats
    assert s.cache_hits >= 5 and s.component_hits >= 1
    assert s.reach_fast_batches >= 1 and s.early_stops >= 2
    assert s.wire_delegate_bytes > 0 and s.wire_nn_bytes > 0
    assert port.traversal_sweeps > 0


def test_answers_match_oracle_and_classic_api(setup):
    g, _, pg = setup
    _, port = engines(setup, cache_capacity=0)
    srcs = [int(s) for s in pick_sources(g, 5, seed=8)]
    levels = port.query(srcs)
    for q, s in enumerate(srcs):
        np.testing.assert_array_equal(levels[q], bfs_levels(g, s))
    np.testing.assert_array_equal(port.query_one(srcs[0]), levels[0])
    np.testing.assert_array_equal(port.run_batch(srcs[:2]), levels[:2])
    np.testing.assert_array_equal(
        port.submit(Query(srcs[1], QueryKind.REACHABILITY)),
        reachable_mask(g, srcs[1]))
    port.warmup(reachability=True, targets=True)


@pytest.mark.parametrize("kind,kw", [
    (QueryKind.WEIGHTED_SSSP, {}), (QueryKind.COMPONENTS, {}),
    (QueryKind.KHOP_SAMPLE, {"max_depth": 2})])
def test_deferred_kinds_raise_at_submit(setup, kind, kw):
    """The three kinds deferred by earlier slices are served now: a batch
    of one beside a LEVELS query, and its cache hit, equal to the
    reference engine's answers and stats."""
    g, _, _ = setup
    ref, port = engines(setup)
    src = int(pick_sources(g, 1, seed=4)[0])
    qs = [Query(src, kind, **kw), Query(1)]
    for _ in range(2):
        assert_same(port.submit_many(qs),
                    ref.submit_many([to_ref(q) for q in qs]))
        assert port.stats.as_dict() == ref.stats.as_dict()
    assert port.stats.queries == 4 and port.stats.cache_hits == 2


def test_engine_needs_device_cpu_without_a_card(monkeypatch, setup):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    _, _, pg = setup
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BFSServeEngine(pg=pg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TB.device_view(pg)


def test_lru_ttl_matches_reference():
    now = [0.0]
    clock = lambda: now[0]
    caches = (LRUCache(2, ttl=5.0, clock=clock), RefLRU(2, ttl=5.0, clock=clock))
    for c in caches:
        c.put("a", 1)
        c.put("b", 2, ttl=None)
        assert c.get("a") == 1
        now[0] += 3
        c.put("c", 3)                       # evicts b (a was refreshed)
        now[0] += 3                         # a expires, c lives
        assert c.get("a") is None and "c" in c and len(c) == 1
        now[0] = 0.0
    counters = [(c.hits, c.misses, c.evictions, c.expired) for c in caches]
    assert counters[0] == counters[1] == (1, 1, 1, 1)


def test_coo_graph_helpers():
    g = COOGraph(4, np.array([0, 1, 1, 2]), np.array([1, 1, 2, 3]))
    assert g.without_self_loops().m == 3
    assert g.symmetrized().m == 8
    np.testing.assert_array_equal(g.out_degrees(), [1, 2, 1, 0])
