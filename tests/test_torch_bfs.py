"""The port's single-source direction-optimized BFS against the reference
package: one partition (carried over with ``repro_torch.core.convert``)
and the same source go through both, and every ``BFSState`` leaf must be
equal after every sweep -- levels, directions and all exact counters
(work, nn_sent, overflow, delegate rounds, wire bytes). The committed
``options_ablation`` counters of ``BENCH_comm.json`` must reproduce, and
converged runs must equal the numpy oracle. Exact equality throughout:
every leaf is an integer or a bool."""
import json
from pathlib import Path

import jax
import numpy as np
import pytest
pytest.importorskip("torch")

from repro.core import bfs as RB, comm as RC, engine as RE
from repro.core.partition import partition_graph
from repro.graphs.rmat import pick_sources, rmat_graph
from repro_torch.core import bfs as TB, comm as TC, convert, engine as TE
from repro_torch.core.oracle import bfs_levels, traversed_edges
from repro_torch.core.types import COOGraph, INF_LEVEL

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def graph():
    return rmat_graph(10, seed=7)


def both(graph, th, p_rank, p_gpu):
    """The reference partition/plan and the port's copies of the same."""
    rpg = partition_graph(graph, th=th, p_rank=p_rank, p_gpu=p_gpu)
    rplan = RE.build_exchange_plan(rpg)
    pg = convert.partition_from_arrays(*convert.partition_to_arrays(rpg))
    plan = convert.plan_from_arrays(*convert.plan_to_arrays(rplan))
    return (rpg, rplan), (pg, TB.device_view(pg, "cpu"),
                          TE.device_plan(plan, "cpu"))


def assert_state_equal(rs, ts, where=""):
    leaves = convert.bfs_state_to_numpy(ts)
    assert set(leaves) == set(convert.BFS_STATE_LEAVES)
    for k in convert.BFS_STATE_LEAVES:
        want, got = np.asarray(getattr(rs, k)), leaves[k]
        assert got.shape == want.shape and got.dtype == want.dtype, (k, where)
        np.testing.assert_array_equal(got, want, err_msg=f"{k} {where}")


# the six configurations of the every-sweep parity test
CONFIGS = {
    "plain": dict(enable_do=False),
    "DO": dict(enable_do=True),
    "DO+uniquify": dict(enable_do=True, uniquify=True),
    "cap-4+u8": dict(cap_nn=-4, delegate_u8=True),
    "static+u8": dict(static_exchange=True, delegate_u8=True),
    "allgather": dict(comm="allgather"),
}


def configs(name):
    kw = dict(CONFIGS[name], max_iters=24, pull_chunk=16)
    rkw, tkw = dict(kw), dict(kw)
    if kw.get("comm"):
        rkw["comm"] = RC.CommConfig(delegate=kw["comm"])
        tkw["comm"] = TC.CommConfig(delegate=kw["comm"])
    return RB.BFSConfig(**rkw), TB.BFSConfig(**tkw)


def ref_step(rcfg, with_plan):
    if with_plan:
        return jax.jit(jax.vmap(
            lambda pg, pl, st: RB.bfs_step(pg, st, rcfg, "p", plan=pl),
            axis_name="p"))
    step = jax.jit(jax.vmap(lambda pg, st: RB.bfs_step(pg, st, rcfg, "p"),
                            axis_name="p"))
    return lambda pg, pl, st: step(pg, st)


@pytest.mark.parametrize("p_rank,p_gpu", [(1, 1), (2, 2)])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_every_leaf_equal_after_every_sweep(graph, name, p_rank, p_gpu):
    (rpg, rplan), (pg, pgv, plan) = both(graph, 32, p_rank, p_gpu)
    rcfg, tcfg = configs(name)
    src = int(pick_sources(graph, 1, seed=1)[0])
    rs, ts = RB.init_state(rpg, src, rcfg), TB.init_state(pg, src, tcfg,
                                                         device="cpu")
    assert_state_equal(rs, ts, "init")
    step, rpgv = ref_step(rcfg, tcfg.static_exchange), RB.device_view(rpg)
    sweep = 0
    while not bool(np.all(np.asarray(rs.done))):
        rs = step(rpgv, rplan, rs)
        ts = TB.bfs_step(pgv, ts, tcfg, plan)
        sweep += 1
        assert_state_equal(rs, ts, f"sweep {sweep}")
    assert sweep >= 4
    if tcfg.enable_do:                    # the pull kernel's path ran
        assert int(ts.work_bwd.sum()) > 0
    np.testing.assert_array_equal(TB.gather_levels(pg, ts),
                                  bfs_levels(graph, src))


def test_options_ablation_counters_reproduce():
    """``BENCH_comm.json`` options_ablation: the same graph, partition and
    sources through the port give the committed work / nn_sent / delegate
    round counters exactly."""
    bench = json.loads((ROOT / "BENCH_comm.json").read_text())
    want = bench["benchmarks"]["options_ablation"]
    gp = want["graph"]
    g = rmat_graph(gp["scale"], seed=gp["seed"])
    pg = partition_graph(g, th=gp["th"], p_rank=gp["p_rank"],
                         p_gpu=gp["p_gpu"])
    pg = convert.partition_from_arrays(*convert.partition_to_arrays(pg))
    pgv = TB.device_view(pg, "cpu")
    variants = {"plain": dict(enable_do=False), "DO": dict(enable_do=True),
                "DO+U": dict(enable_do=True, uniquify=True)}
    for name, kw in variants.items():
        cfg = TB.BFSConfig(max_iters=48, **kw)
        work = sent = rounds = 0
        for src in pick_sources(g, 2, seed=5):
            out = TB.run_bfs_emulated(
                pgv, TB.init_state(pg, int(src), cfg, device="cpu"), cfg)
            if int(out.it[0]) <= 1:
                continue               # the benchmark's Graph500 rule
            work += int(out.work_fwd.sum() + out.work_bwd.sum())
            sent += int(out.nn_sent.sum())
            rounds += int(out.delegate_round[0].sum())
            assert int(out.nn_overflow.sum()) == 0
        exp = want["variants"][name]
        assert (work, sent, rounds) == (exp["work"], exp["sent"],
                                        exp["delegate_rounds"]), name


def run(g, pg, src, **kw):
    kw.setdefault("max_iters", 40)
    cfg = TB.BFSConfig(**kw)
    out = TB.run_bfs_emulated(TB.device_view(pg, "cpu"),
                              TB.init_state(pg, src, cfg, device="cpu"), cfg)
    return TB.gather_levels(pg, out), out


def port_partition(g, **kw):
    return convert.partition_from_arrays(
        *convert.partition_to_arrays(partition_graph(g, **kw)))


def test_delegate_source(graph):
    pg = port_partition(graph, th=16, p_rank=2, p_gpu=2)
    dvid = int(np.asarray(pg.delegate_vids).reshape(-1)[0])
    levels, out = run(graph, pg, dvid)
    np.testing.assert_array_equal(levels, bfs_levels(graph, dvid))
    assert int(out.level_d[0].min()) == 0


def test_isolated_source():
    g = COOGraph(16, np.array([0, 1], dtype=np.int64),
                 np.array([1, 0], dtype=np.int64))
    pg = port_partition(g, th=4, p_rank=2, p_gpu=1)
    levels, out = run(g, pg, 5)
    assert levels[5] == 0
    assert (levels[np.arange(16) != 5] == INF_LEVEL).all()
    assert int(out.it[0]) <= 2


def test_line_graph_levels():
    n = 33
    src = np.arange(n - 1, dtype=np.int64)
    g = COOGraph(n, src, src + 1).symmetrized()
    pg = port_partition(g, th=1000, p_rank=2, p_gpu=2)  # all normal
    assert pg.d == 0
    levels, _ = run(g, pg, 0, max_iters=40)
    np.testing.assert_array_equal(levels, np.arange(n))


def test_plain_bfs_work_equals_component_edges(graph):
    """Forward-only BFS examines each edge of the reached component once;
    ``traversed_edges`` (the TEPS numerator) is half of that."""
    pg = port_partition(graph, th=64, p_rank=2, p_gpu=2)
    src = int(pick_sources(graph, 1, seed=5)[0])
    ref = bfs_levels(graph, src)
    levels, out = run(graph, pg, src, enable_do=False)
    np.testing.assert_array_equal(levels, ref)
    expected = int((ref[graph.src] != INF_LEVEL).sum())
    assert int(out.work_fwd.sum()) == expected
    assert traversed_edges(graph, levels) == expected // 2


def test_static_exchange_needs_a_plan_and_unported_modes_raise(graph):
    pg = port_partition(graph, th=64, p_rank=1, p_gpu=2)
    cfg = TB.BFSConfig(static_exchange=True)
    with pytest.raises(ValueError, match="plan"):
        TB.run_bfs_emulated(TB.device_view(pg, "cpu"),
                            TB.init_state(pg, 0, cfg, device="cpu"), cfg)
    with pytest.raises(ValueError):
        TB.init_state(pg, pg.n, cfg, device="cpu")
    # the memory and telemetry modes are ported: they configure, and the
    # telemetry leaves get their [p, max_iters] width
    for kw in (dict(edge_chunk=64), dict(telemetry=True)):
        st = TB.init_state(pg, 0, TB.BFSConfig(max_iters=12, **kw),
                           device="cpu")
        width = 12 if kw.get("telemetry") else 0
        assert tuple(st.tm_backward.shape) == (pg.p, width)
