"""The port's payload plane against the reference package, in one process:
the synthetic edge weights, the payload sweep (every ``MSBFSState`` leaf
after every sweep, under every delegate strategy and nn format), payload
lane reseeds, the engine serving all seven query kinds in every mode
(answers and every ``ServeStats`` field equal to the reference engine's),
the COMPONENTS memo, ``sample_khop`` into the neighbor sampler, the float
``"sum"`` combine and the lane fold, and ``BENCH_queries.json``'s
``payload_kinds`` counters reproduced from the port alone. The graph is
the reference tests' (``rmat_graph(8, seed=11)``, ``p_rank=2, p_gpu=2``,
``th=32``; ``th=16`` for the delegate-rich mixed case). Exact equality
throughout: every payload quantity is an integer."""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import bfs as RB, comm as RC, engine as RE, msbfs as RM
from repro.core.partition import partition_graph
from repro.core.weights import edge_weights as ref_edge_weights
from repro.graphs.rmat import pick_sources, rmat_graph
from repro.graphs.sampler import NeighborSampler as RefSampler
from repro.serve import BFSServeEngine as RefEngine
from repro.serve import Query as RQ, QueryKind as RK
from repro_torch.core import bfs as TB, comm as TC, convert, engine as TE
from repro_torch.core import msbfs as TM
from repro_torch.core.oracle import (component_labels, dijkstra_levels,
                                     khop_nodes)
from repro_torch.core.types import COOGraph
from repro_torch.core.weights import SSSP_WMAX, edge_weights
from repro_torch.graphs.sampler import NeighborSampler
from repro_torch.serve import BFSServeEngine, Query, QueryKind as K

ROOT = Path(__file__).resolve().parents[1]
W = 4
GRAPH = rmat_graph(8, seed=11)


@pytest.fixture(scope="module")
def parts():
    """``{th: (reference pg, reference plan, port pg, port view, port
    plan)}`` on the (2, 2) partition, plus ``th`` 32 on one partition."""
    out = {}
    for th, pr, pgpu in ((32, 2, 2), (16, 2, 2), (32, 1, 1)):
        rpg = partition_graph(GRAPH, th=th, p_rank=pr, p_gpu=pgpu)
        rplan = RE.build_exchange_plan(rpg)
        pg = convert.partition_from_arrays(*convert.partition_to_arrays(rpg))
        plan = convert.plan_from_arrays(*convert.plan_to_arrays(rplan))
        out[th, pr * pgpu] = (rpg, rplan, pg, TB.device_view(pg, "cpu"),
                              TE.device_plan(plan, "cpu"))
    return out


#: one runner cache shared by every reference engine of this module: same
#: shapes and variants compile once
RUNNERS: dict = {}


def to_ref(q: Query) -> RQ:
    return RQ(q.source, RK(q.kind.value), max_depth=q.max_depth,
              targets=q.targets)


def assert_state_equal(rs, ts, where=""):
    leaves = convert.state_to_numpy(ts)
    for k in TM.STATE_LEAVES:
        want, got = np.asarray(getattr(rs, k)), leaves[k]
        if want.dtype == np.uint32:
            got = got.view(np.uint32)
        assert got.shape == want.shape and got.dtype == want.dtype, (k, where)
        np.testing.assert_array_equal(got, want, err_msg=f"{k} {where}")


def assert_answers_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(b, dict):
            assert a == b
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------- weights
def test_edge_weights_equal_reference():
    """Random ids and the edge cases (0, 2^31 - 1, pairs whose products
    wrap), as numpy arrays and as int64 and int32 tensors: equal to the
    reference's hash, symmetric, in [1, SSSP_WMAX]."""
    rng = np.random.default_rng(0)
    u = rng.integers(0, 2**31 - 1, 4096)
    v = rng.integers(0, 2**31 - 1, 4096)
    edge = np.array([0, 2**31 - 1, 2**31 - 1, 0, 1, 0x7FFF0000, 123456789])
    u = np.concatenate([u, edge, edge[::-1]])
    v = np.concatenate([v, edge[::-1], edge])
    want = np.asarray(ref_edge_weights(jnp.asarray(u.astype(np.int32)),
                                       jnp.asarray(v.astype(np.int32))))
    np.testing.assert_array_equal(want, ref_edge_weights(u, v))
    for got in (edge_weights(u, v),
                edge_weights(torch.from_numpy(u), torch.from_numpy(v)).numpy(),
                edge_weights(torch.from_numpy(u.astype(np.int32)),
                             torch.from_numpy(v.astype(np.int32))).numpy()):
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(edge_weights(v, u), want)
    assert want.min() >= 1 and want.max() <= SSSP_WMAX


# ------------------------------------------------------ the payload sweep
STEP_CASES = {
    # name: (th, p, comm, payload modes, enable_targets)
    "p4-auto-dense-mixed": (32, 4, {}, ["sssp", None, "components", "sssp"],
                            True),
    "p4-auto-dense-sssp": (32, 4, {}, ["sssp"] * 4, False),
    "p1-components": (32, 1, {}, ["components", None, "components", None],
                      False),
    "p4-allgather-mixed": (16, 4, dict(delegate="allgather"),
                           ["sssp", None, "components", "sssp"], True),
    "p4-ring-sparse-overflow": (16, 4, dict(delegate="ring", nn="sparse",
                                            sparse_cap=2),
                                ["sssp", "components", None, "sssp"], False),
    "p4-hier-sparse-fits": (16, 4, dict(delegate="hier", nn="sparse",
                                        sparse_cap=10**6),
                            ["sssp", None, "components", "sssp"], True),
    "p4-auto-adaptive": (16, 4, dict(nn="adaptive"),
                         ["components", "sssp", None, "sssp"], False),
}


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_payload_step_every_leaf_every_sweep(parts, name):
    th, p, comm, modes, targets = STEP_CASES[name]
    rpg, rplan, pg, pgv, plan = parts[th, p]
    srcs = [int(s) for s in pick_sources(GRAPH, 3, seed=1)]
    srcs.append(int(np.asarray(rpg.delegate_vids).reshape(-1)[0]))
    tg = [None, (srcs[0], srcs[3]), None, None] if targets else None
    kw = dict(n_queries=W, max_iters=96, payload=True,
              enable_targets=targets)
    rcfg = RM.MSBFSConfig(**kw, comm=RC.CommConfig(**comm))
    tcfg = TM.MSBFSConfig(**kw, comm=TC.CommConfig(**comm))
    rs = RM.init_multi_state(rpg, srcs, rcfg, payload_modes=modes,
                             targets=tg)
    ts = TM.init_multi_state(pg, srcs, tcfg, payload_modes=modes, targets=tg,
                             device="cpu")
    assert_state_equal(rs, ts, "init")
    step = jax.jit(lambda s: RM.msbfs_step_emulated(RB.device_view(rpg),
                                                    rplan, s, rcfg))
    sweep = 0
    while not bool(np.all(np.asarray(rs.done))) and sweep < 96:
        rs, ts = step(rs), TM.msbfs_step_emulated(pgv, plan, ts, tcfg)
        sweep += 1
        assert_state_equal(rs, ts, f"sweep {sweep}")
    assert sweep >= 4 and bool(ts.done.all())
    assert int(ts.wire_pay_nn.sum()) > 0 or p == 1
    if name.endswith("overflow"):
        assert int(ts.nn_overflow.sum()) > 0
    else:
        assert int(ts.nn_overflow.sum()) == 0
    pay = TM.gather_payload_multi(pg, ts)
    np.testing.assert_array_equal(pay, RM.gather_payload_multi(rpg, rs))
    if not name.endswith("overflow"):
        for q, mode in enumerate(modes):
            if mode == "sssp":
                np.testing.assert_array_equal(pay[q],
                                              dijkstra_levels(GRAPH, srcs[q]))
            elif mode == "components":
                np.testing.assert_array_equal(pay[q], component_labels(GRAPH))


def test_payload_modes_need_a_payload_cfg(parts):
    pg = parts[32, 4][2]
    with pytest.raises(ValueError, match="payload"):
        TM.init_multi_state(pg, [0], TM.MSBFSConfig(n_queries=W),
                            payload_modes=["sssp"], device="cpu")
    # the memory and telemetry modes are ported: they configure with the
    # payload plane, and the telemetry leaves get their width
    st = TM.init_multi_state(
        pg, [0], TM.MSBFSConfig(n_queries=W, max_iters=9, payload=True,
                                edge_chunk=64, telemetry=True),
        payload_modes=["sssp"], device="cpu")
    assert tuple(st.tm_backward.shape) == (pg.p, 9, 3, 1)
    assert tuple(st.payload_n.shape[-1:]) == (W,)


def test_payload_reseed_every_leaf_equal(parts):
    """Reseed lanes of a mid-traversal mixed state -- an SSSP lane at a
    delegate source onto a former bit lane, a components lane onto a
    former SSSP lane, a bit lane onto a former components lane -- through
    both packages: every leaf equal, the untouched lane bit-identical."""
    rpg, rplan, pg, pgv, plan = parts[16, 4]
    kw = dict(n_queries=W, max_iters=96, payload=True, enable_targets=False)
    rcfg, tcfg = RM.MSBFSConfig(**kw), TM.MSBFSConfig(**kw)
    srcs = [int(s) for s in pick_sources(GRAPH, 4, seed=2)]
    modes = ["sssp", None, "components", "sssp"]
    rs = RM.init_multi_state(rpg, srcs, rcfg, payload_modes=modes)
    ts = TM.init_multi_state(pg, srcs, tcfg, payload_modes=modes,
                             device="cpu")
    rpgv = RB.device_view(rpg)
    for _ in range(3):
        rs = RM.msbfs_step_emulated(rpgv, rplan, rs, rcfg)
        ts = TM.msbfs_step_emulated(pgv, plan, ts, tcfg)
    dv = int(np.asarray(rpg.delegate_vids).reshape(-1)[1])
    lanes, new = [1, 0, 2], [dv, srcs[2], srcs[1]]
    desc = TM.lane_descriptors(pg, W, lanes, new, n_targets=0)
    pay = TM.payload_descriptors(W, lanes, ["sssp", "components", None])
    gids = TM.gid_planes(pg)
    rout = RM.reseed_lanes(rs, *map(jnp.asarray, desc + pay + gids))
    tout = TM.reseed_lanes(ts, *(desc + pay + gids))
    assert_state_equal(rout, tout, "reseed")
    before, after = convert.state_to_numpy(ts), convert.state_to_numpy(tout)
    for k in ("payload_n", "payload_d", "pay_pending_n", "pay_bucket",
              "level_n", "base_it", "lane_active"):
        np.testing.assert_array_equal(before[k][..., 3], after[k][..., 3],
                                      err_msg=k)
    for _ in range(2):                         # and the sweeps after it
        rout = RM.msbfs_step_emulated(rpgv, rplan, rout, rcfg)
        tout = TM.msbfs_step_emulated(pgv, plan, tout, tcfg)
    assert_state_equal(rout, tout, "after the reseed")
    # without payload arguments the payload leaves stay as they were
    assert_state_equal(RM.reseed_lanes(rs, *map(jnp.asarray, desc)),
                       TM.reseed_lanes(ts, *desc), "bit reseed")
    with pytest.raises(ValueError, match="all-or-none"):
        TM.reseed_lanes(ts, *desc, pay_lane=pay[0])


def test_gid_planes_equal_the_reference_engine(parts):
    rpg, _, pg = parts[16, 4][:3]
    ref = RefEngine(pg=rpg, cfg=RM.MSBFSConfig(n_queries=W),
                    runner_cache=RUNNERS)
    for a, b in zip(TM.gid_planes(pg), ref._pay_gids()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ the engine
def seven_kinds(srcs):
    return [
        Query(srcs[0]),
        Query(srcs[1], K.REACHABILITY),
        Query(srcs[2], K.DISTANCE_LIMITED, max_depth=2),
        Query(srcs[3], K.MULTI_TARGET, targets=(srcs[0], srcs[1])),
        Query(srcs[4], K.WEIGHTED_SSSP),
        Query(srcs[5], K.COMPONENTS),
        Query(srcs[0], K.KHOP_SAMPLE, max_depth=2),
        Query(srcs[2], K.WEIGHTED_SSSP),
    ]


def engines(parts, mode="refill", th=32, **kw):
    rpg, _, pg = parts[th, 4][:3]
    kw.setdefault("cache_capacity", 0)
    if mode != "batch":
        kw.update(refill=True)
    if mode in ("overlap", "stream"):
        kw.setdefault("overlap", True)
    ref = RefEngine(pg=rpg, cfg=RM.MSBFSConfig(n_queries=W, max_iters=80),
                    runner_cache=RUNNERS, **kw)
    port = BFSServeEngine(pg=pg, cfg=TM.MSBFSConfig(n_queries=W,
                                                    max_iters=80),
                          device="cpu", **kw)
    return ref, port


def serve(eng, mode, qs, conv=lambda q: q):
    if mode != "stream":
        return eng.submit_many([conv(q) for q in qs])
    got = {}
    for i in range(0, len(qs), 3):
        eng.submit_stream([conv(q) for q in qs[i:i + 3]])
        got.update(eng.poll())
    got.update(eng.drain_stream())
    return [got[conv(q)] for q in qs]


@pytest.mark.parametrize("mode,kw", [
    ("batch", {}), ("refill", {}), ("overlap", dict(sweep_block=1)),
    ("overlap", dict(sweep_block=4)), ("stream", dict(sweep_block=4))])
def test_seven_kinds_equal_reference(parts, mode, kw):
    """All seven kinds in one lane word, through each driver: answers and
    every ``ServeStats`` field equal to the reference engine's, payload
    wire counters live; the payload answers oracle-exact."""
    srcs = [int(s) for s in pick_sources(GRAPH, 6, seed=3)]
    qs = seven_kinds(srcs)
    if mode == "stream":           # the opening chunk asks for the payload
        qs = qs[4:] + qs[:4]
    ref, port = engines(parts, mode, reuse_components=False, **kw)
    got = serve(port, mode, qs)
    assert_answers_equal(got, serve(ref, mode, qs, to_ref))
    assert port.stats.as_dict() == ref.stats.as_dict()
    assert port.stats.wire_pay_nn_bytes > 0
    assert port.stats.wire_pay_delegate_bytes > 0
    ans = dict(zip(qs, got))
    np.testing.assert_array_equal(ans[Query(srcs[4], K.WEIGHTED_SSSP)],
                                  dijkstra_levels(GRAPH, srcs[4]))
    np.testing.assert_array_equal(ans[Query(srcs[5], K.COMPONENTS)],
                                  component_labels(GRAPH))
    np.testing.assert_array_equal(
        ans[Query(srcs[0], K.KHOP_SAMPLE, max_depth=2)],
        khop_nodes(GRAPH, srcs[0], 2))
    if mode != "batch":
        assert port.stats.refills > 0


def test_stream_payload_guard_and_component_memo(parts):
    """A bit-only stream session refuses payload kinds until drained; a
    COMPONENTS answer then serves later COMPONENTS and REACHABILITY
    queries without a traversal -- every stat equal to the reference's."""
    srcs = [int(s) for s in pick_sources(GRAPH, 6, seed=5)]
    ref, port = engines(parts, "stream", reuse_components=True)
    for eng, conv in ((ref, to_ref), (port, lambda q: q)):
        eng.submit_stream([conv(Query(srcs[0]))])
        with pytest.raises(ValueError, match="payload"):
            eng.submit_stream([conv(Query(srcs[1], K.WEIGHTED_SSSP))])
        eng.drain_stream()
    qs = [Query(srcs[2], K.COMPONENTS), Query(srcs[3], K.REACHABILITY),
          Query(srcs[4], K.COMPONENTS), Query(srcs[5], K.WEIGHTED_SSSP)]
    for q in qs:
        a, b = port.submit(q), ref.submit(to_ref(q))
        assert_answers_equal([a], [b])
    assert port.stats.as_dict() == ref.stats.as_dict()
    assert port.stats.component_hits >= 2


def test_sample_khop_feeds_the_neighbor_sampler(parts):
    src = int(pick_sources(GRAPH, 1, seed=7)[0])
    ref, port = engines(parts, "batch", cache_capacity=8)
    g = COOGraph(GRAPH.n, GRAPH.src, GRAPH.dst)
    (batch, ids), (rbatch, rids) = (
        port.sample_khop(src, 2, NeighborSampler(g, fanouts=(3, 2), seed=4)),
        ref.sample_khop(src, 2, RefSampler(GRAPH, fanouts=(3, 2), seed=4)))
    np.testing.assert_array_equal(ids, rids)
    for f in ("nodes", "senders", "receivers", "node_mask", "edge_mask"):
        a, b = getattr(batch, f), getattr(rbatch, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    pool = khop_nodes(GRAPH, src, 2)
    np.testing.assert_array_equal(ids[: len(pool)], pool)
    assert port.stats.as_dict() == ref.stats.as_dict()


def test_bit_only_config_ships_no_payload_bytes(parts):
    """A bit-only session keeps zero-width payload leaves and ships no
    payload byte; warmup(payload=True) builds the payload variant and
    leaves the stats untouched."""
    pg = parts[32, 4][2]
    st = TM.init_multi_state(pg, [0, 5], TM.MSBFSConfig(n_queries=W),
                             device="cpu")
    assert st.payload_n.shape[-1] == st.pay_bucket.shape[-1] == 0
    assert st.wire_pay_delegate.shape[-1] == 0
    ref, port = engines(parts, "overlap", sweep_block=2)
    qs = [Query(int(s)) for s in pick_sources(GRAPH, 6, seed=1)]
    port.warmup(payload=True, targets=True)
    assert port.stats.as_dict() == ref.stats.as_dict()
    assert_answers_equal(port.submit_many(qs),
                         ref.submit_many([to_ref(q) for q in qs]))
    assert port.stats.as_dict() == ref.stats.as_dict()
    assert port.stats.wire_pay_delegate_bytes == 0
    assert port.stats.wire_pay_nn_bytes == 0


def test_bench_queries_payload_kinds_counts():
    """``BENCH_queries.json``'s ``payload_kinds`` section from the port
    alone: every sweeps, wire and overflow count of the five refill runs,
    and the mixed run's kind counts and early stops."""
    want = json.loads((ROOT / "BENCH_queries.json").read_text())[
        "benchmarks"]["payload_kinds"]
    g = rmat_graph(9, seed=7)
    rpg = partition_graph(g, th=64, p_rank=2, p_gpu=2)
    pg = convert.partition_from_arrays(*convert.partition_to_arrays(rpg))
    srcs = [int(s) for s in pick_sources(g, want["requests"], seed=1)]
    cfg = TM.MSBFSConfig(n_queries=want["n_queries"], max_iters=48)
    tpool = tuple(srcs[:2])
    kinds = [lambda s: Query(s), lambda s: Query(s, K.REACHABILITY),
             lambda s: Query(s, K.DISTANCE_LIMITED, max_depth=3),
             lambda s: Query(s, K.MULTI_TARGET, targets=tpool),
             lambda s: Query(s, K.WEIGHTED_SSSP),
             lambda s: Query(s, K.COMPONENTS),
             lambda s: Query(s, K.KHOP_SAMPLE, max_depth=2)]
    runs = {
        "levels": [Query(s) for s in srcs],
        "weighted_sssp": [Query(s, K.WEIGHTED_SSSP) for s in srcs],
        "components": [Query(s, K.COMPONENTS) for s in srcs],
        "khop_sample": [Query(s, K.KHOP_SAMPLE, max_depth=3) for s in srcs],
        "mixed": [kinds[i % 7](s) for i, s in enumerate(srcs)],
    }
    keys = ("sweeps", "wire_delegate_bytes", "wire_nn_bytes",
            "wire_pay_delegate_bytes", "wire_pay_nn_bytes", "nn_overflow")
    for name, qs in runs.items():
        eng = BFSServeEngine(pg=pg, cfg=cfg, cache_capacity=0, refill=True,
                             reuse_components=False, device="cpu")
        answers = eng.submit_many(qs)
        st = eng.stats.as_dict()
        assert {k: st[k] for k in keys} == {k: want[name][k] for k in keys}, \
            name
        if name == "mixed":
            assert st["kind_counts"] == want["mixed"]["kind_counts"]
            assert st["early_stops"] == want["mixed"]["early_stops"]
        if name == "weighted_sssp":
            np.testing.assert_array_equal(answers[0],
                                          dijkstra_levels(g, srcs[0]))


# ------------------------------------------- the float sum, the lane fold
@pytest.mark.parametrize("delegate", ["auto", "allgather", "ring", "hier"])
def test_float_sum_and_lane_fold_match_reference(delegate):
    """The ``"sum"`` combine on float32 (integer-valued, so every fold
    order gives the same sums) and the lane fold (``lane_fold_reduce``,
    and ``lane_any_reduce`` on it) against the reference on one emulated
    axis of 4 and the two-axis (2, 2) mesh."""
    rng = np.random.default_rng(len(delegate))
    x = rng.integers(-2**20, 2**20, (4, 13)).astype(np.float32)
    lanes = rng.integers(-2**30, 2**30, (4, 3, 8)).astype(np.int32)
    cfg = dict(delegate=delegate)
    for axes, sizes in ((("p",), (4,)), (("outer", "inner"), (2, 2))):
        seen = {}

        def ref(v, lv):
            out, seen["bytes"] = RC.delegate_combine(
                RC.plan_for(RC.CommConfig(**cfg), axes), v, "sum")
            return out, RC.lane_fold_reduce(lv, axes), RC.lane_any_reduce(
                lv > 0, axes)

        fn = ref
        for a in reversed(axes):
            fn = jax.vmap(fn, axis_name=a)
        want = [np.asarray(t).reshape((4,) + t.shape[len(axes):])
                for t in fn(jnp.asarray(x.reshape(sizes + (13,))),
                            jnp.asarray(lanes.reshape(sizes + (3, 8))))]
        plan = TC.CommPlan(TC.CommConfig(**cfg), axes, sizes)
        got, nbytes = TC.delegate_combine(plan, torch.from_numpy(x), "sum")
        np.testing.assert_array_equal(got.numpy(), want[0])
        assert nbytes == seen["bytes"]
        lt = torch.from_numpy(lanes)
        np.testing.assert_array_equal(TC.lane_fold_reduce(lt).numpy(),
                                      want[1])
        np.testing.assert_array_equal(TC.lane_any_reduce(lt > 0).numpy(),
                                      want[2])
    np.testing.assert_array_equal(
        TC.delegate_allreduce_sum(torch.from_numpy(x), 4).numpy(),
        np.broadcast_to(x.sum(0), x.shape))
