"""The port's per-sweep telemetry leaves (``telemetry=True``: ``tm_*`` of
``MSBFSState`` and ``BFSState``) against the reference package.

* Off, the leaves are zero-width, as the reference keeps them.
* On, every ``tm_*`` leaf (and every other leaf) equals the reference's
  after every sweep, for msBFS (levels, reachability-only and payload
  batches) and for the single-source BFS; the reference stores the packed
  directions as uint32, the port as int32, so bit patterns are compared.
* Telemetry changes no answer, schedule or counter: the engine with and
  without it, in batch, refill and overlap modes, equal each other and
  the reference engine; a fused block with it equals the per-sweep run.
* The single-source frontier counts agree with the oracle's levels.

Harvesting the leaves (``SweepTelemetry``, the engine's
``last_telemetry``) belongs to the observability port and is not tested
here. Exact equality throughout.
"""
import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import bfs as RB, comm as RC, engine as RE, msbfs as RM
from repro.core.partition import partition_graph
from repro.graphs.rmat import pick_sources, rmat_graph
from repro.serve import BFSServeEngine as RefEngine
from repro.serve import Query as RQ, QueryKind as RK
from repro_torch.core import bfs as TB, comm as TC, convert, engine as TE
from repro_torch.core import msbfs as TM
from repro_torch.core.oracle import bfs_levels
from repro_torch.serve import BFSServeEngine, Query, QueryKind

GRAPH = rmat_graph(8, seed=11)       # the reference's telemetry-test graph
TM_LEAVES = ("tm_frontier_n", "tm_frontier_d", "tm_backward")


@pytest.fixture(scope="module")
def parts():
    rpg = partition_graph(GRAPH, th=32, p_rank=2, p_gpu=2)
    rplan = RE.build_exchange_plan(rpg)
    pg = convert.partition_from_arrays(*convert.partition_to_arrays(rpg))
    plan = convert.plan_from_arrays(*convert.plan_to_arrays(rplan))
    return rpg, rplan, pg, TB.device_view(pg, "cpu"), TE.device_plan(plan,
                                                                     "cpu")


def leaves_equal(want: dict, got: dict, where: str = "") -> None:
    for k, w in want.items():
        g = got[k]
        if w.dtype == np.uint32:        # packed words: int32 bit patterns
            g = g.view(np.uint32)
        assert g.shape == w.shape and g.dtype == w.dtype, (k, where)
        np.testing.assert_array_equal(g, w, err_msg=f"{k} {where}")


def test_disabled_leaves_are_zero_width(parts):
    rpg, _, pg, _, _ = parts
    srcs = [int(s) for s in pick_sources(GRAPH, 4, seed=1)]
    for tel, mi in ((False, 0), (True, 64)):
        kw = dict(n_queries=4, max_iters=64, telemetry=tel)
        ts = TM.init_multi_state(pg, srcs, TM.MSBFSConfig(**kw),
                                 device="cpu")
        rs = RM.init_multi_state(rpg, srcs, RM.MSBFSConfig(**kw))
        assert tuple(ts.tm_frontier_n.shape) == (pg.p, mi)
        assert tuple(ts.tm_backward.shape) == (pg.p, mi, 3, 1)
        leaves_equal({k: np.asarray(getattr(rs, k)) for k in TM_LEAVES},
                     convert.state_to_numpy(ts))
        bkw = dict(max_iters=48, telemetry=tel)
        bs = TB.init_state(pg, srcs[0], TB.BFSConfig(**bkw), device="cpu")
        rb = RB.init_state(rpg, srcs[0], RB.BFSConfig(**bkw))
        assert tuple(bs.tm_frontier_n.shape) == (pg.p, 48 if tel else 0)
        leaves_equal({k: np.asarray(getattr(rb, k)) for k in TM_LEAVES},
                     convert.bfs_state_to_numpy(bs))


MS_CASES = {
    # name: config keywords, payload modes
    "levels-targets": (dict(), None),
    "reach-only": (dict(track_levels=False, enable_targets=False), None),
    "payload-chunked-compressed": (dict(edge_chunk=40, nn="compressed"),
                                   ["sssp", None, "components", None]),
}


@pytest.mark.parametrize("name", list(MS_CASES))
def test_msbfs_telemetry_every_leaf_every_sweep(parts, name):
    """Every leaf, the ``tm_*`` ones included, equals the reference's
    after every sweep; every other leaf equals the port's run without
    telemetry."""
    kw, modes = MS_CASES[name]
    kw = dict(kw)
    rpg, rplan, pg, pgv, plan = parts
    srcs = [int(s) for s in pick_sources(GRAPH, 3, seed=2)]
    srcs.append(int(np.asarray(rpg.delegate_vids)[0]))
    nn = kw.pop("nn", "dense")
    base = dict(n_queries=4, max_iters=96 if modes else 32,
                payload=modes is not None, **kw)
    rcfg = RM.MSBFSConfig(**base, telemetry=True, comm=RC.CommConfig(nn=nn))
    tcfg = TM.MSBFSConfig(**base, telemetry=True, comm=TC.CommConfig(nn=nn))
    off = TM.MSBFSConfig(**base, comm=TC.CommConfig(nn=nn))
    caps = [None, 2, None, None] if modes is None else None
    tg = ([None, None, (srcs[0], srcs[3]), None]
          if base.get("enable_targets", True) and modes is None else None)
    init = dict(depth_caps=caps, targets=tg, payload_modes=modes)
    rs = RM.init_multi_state(rpg, srcs, rcfg, **init)
    ts = TM.init_multi_state(pg, srcs, tcfg, device="cpu", **init)
    os_ = TM.init_multi_state(pg, srcs, off, device="cpu", **init)
    step = jax.jit(lambda s: RM.msbfs_step_emulated(RB.device_view(rpg),
                                                    rplan, s, rcfg))
    sweep = 0
    while not bool(np.all(np.asarray(rs.done))) and sweep < base["max_iters"]:
        rs = step(rs)
        ts = TM.msbfs_step_emulated(pgv, plan, ts, tcfg)
        os_ = TM.msbfs_step_emulated(pgv, plan, os_, off)
        sweep += 1
        got = convert.state_to_numpy(ts)
        leaves_equal({k: np.asarray(getattr(rs, k))
                      for k in TM.STATE_LEAVES}, got, f"sweep {sweep}")
        leaves_equal({k: v for k, v in convert.state_to_numpy(os_).items()
                      if k not in TM_LEAVES}, got, f"off {sweep}")
    assert sweep >= 3
    assert int(ts.tm_frontier_n[:, :sweep].sum()) > 0
    assert int(ts.tm_frontier_n[:, sweep:].sum()) == 0
    if modes is None:
        assert int(ts.tm_backward.abs().sum()) > 0       # some lane pulled


@pytest.mark.parametrize("static_exchange", [True, False])
def test_bfs_telemetry_every_leaf_every_sweep(parts, static_exchange):
    rpg, rplan, pg, pgv, plan = parts
    src = int(pick_sources(GRAPH, 1, seed=2)[0])
    kw = dict(max_iters=32, static_exchange=static_exchange, telemetry=True)
    rcfg, tcfg = RB.BFSConfig(**kw), TB.BFSConfig(**kw)
    rpgv = RB.device_view(rpg)
    if static_exchange:
        step = jax.jit(lambda s: jax.vmap(
            lambda pv, pl, st: RB.bfs_step(pv, st, rcfg, "p", plan=pl),
            axis_name="p")(rpgv, rplan, s))
    else:
        step = jax.jit(lambda s: jax.vmap(
            lambda pv, st: RB.bfs_step(pv, st, rcfg, "p"),
            axis_name="p")(rpgv, s))
    rs = RB.init_state(rpg, src, rcfg)
    ts = TB.init_state(pg, src, tcfg, device="cpu")
    sweep = 0
    while not bool(np.all(np.asarray(rs.done))):
        rs = step(rs)
        ts = TB.bfs_step(pgv, ts, tcfg, plan if static_exchange else None)
        sweep += 1
        leaves_equal({k: np.asarray(getattr(rs, k))
                      for k in convert.BFS_STATE_LEAVES},
                     convert.bfs_state_to_numpy(ts), f"sweep {sweep}")
    assert sweep >= 3 and int(ts.tm_backward.max()) > 0


def test_bfs_frontier_telemetry_matches_oracle_levels(parts):
    """For every executed sweep t, the partitions' normal-frontier counts
    plus the (replicated) delegate-frontier count equal the oracle's
    number of level-t vertices; nothing accumulates past the last sweep;
    the direction record stays a 3-bit mask."""
    _, _, pg, pgv, _ = parts
    src = int(pick_sources(GRAPH, 1, seed=2)[0])
    cfg = TB.BFSConfig(max_iters=48, enable_do=True, telemetry=True)
    out = TB.run_bfs_emulated(pgv, TB.init_state(pg, src, cfg, device="cpu"),
                              cfg)
    levels = bfs_levels(GRAPH, src)
    np.testing.assert_array_equal(TB.gather_levels(pg, out), levels)
    fn, fd = out.tm_frontier_n.numpy(), out.tm_frontier_d.numpy()
    sweeps = int(out.it[0])
    for t in range(sweeps):
        assert int(fn[:, t].sum()) + int(fd[0, t]) == int(np.sum(levels == t))
    np.testing.assert_array_equal(fd, np.broadcast_to(fd[:1], fd.shape))
    assert int(fn[:, sweeps:].sum()) == 0
    bw = out.tm_backward.numpy()
    assert 0 <= bw.min() <= bw.max() <= 7


def test_block_with_telemetry_equals_per_sweep_run(parts):
    """A fused block (``SweepBlock``, eager on the CPU) of a telemetry
    config leaves every leaf as the per-sweep driver does."""
    _, _, pg, pgv, plan = parts
    srcs = [int(s) for s in pick_sources(GRAPH, 4, seed=5)]
    cfg = TM.MSBFSConfig(n_queries=4, max_iters=32, telemetry=True)
    st = TM.init_multi_state(pg, srcs, cfg, device="cpu")
    run = TM.make_msbfs_block_emulated(cfg, 3)(pgv, plan, st,
                                               np.zeros(4, bool))
    run.wait()
    want = st
    for _ in range(3):
        want = TM.msbfs_step_emulated(pgv, plan, want, cfg)
    leaves_equal(convert.state_to_numpy(want), convert.state_to_numpy(run.out))
    assert int(run.out.tm_frontier_n.sum()) > 0


@pytest.mark.parametrize("mode", ["batch", "refill", "overlap"])
def test_telemetry_never_changes_schedule(parts, mode):
    """Answers and every ``ServeStats`` field are the same with telemetry
    on and off, and equal to the reference engine's with it on."""
    rpg, _, pg, _, _ = parts
    srcs = [int(s) for s in pick_sources(GRAPH, 8, seed=3)]
    qs = [Query(s, k) for s, k in zip(srcs, [QueryKind.LEVELS,
                                             QueryKind.REACHABILITY] * 4)]
    qs[5] = Query(srcs[5], QueryKind.MULTI_TARGET, targets=(srcs[0],))
    kw = {"batch": {}, "refill": dict(refill=True),
          "overlap": dict(refill=True, overlap=True, sweep_block=4)}[mode]
    ref = RefEngine(pg=rpg, cfg=RM.MSBFSConfig(n_queries=4, max_iters=96,
                                               telemetry=True),
                    cache_capacity=0, **kw)
    want = ref.submit_many([RQ(q.source, RK(q.kind.value),
                               max_depth=q.max_depth, targets=q.targets)
                            for q in qs])
    stats = {}
    for tel in (True, False):
        eng = BFSServeEngine(pg=pg, cfg=TM.MSBFSConfig(
            n_queries=4, max_iters=96, telemetry=tel), cache_capacity=0,
            device="cpu", **kw)
        got = eng.submit_many(qs)
        for a, b in zip(got, want):
            if isinstance(b, dict):
                assert a == b
            else:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        stats[tel] = eng.stats.as_dict()
    assert stats[True] == stats[False] == ref.stats.as_dict()
    assert stats[True]["queries"] == len(qs)
