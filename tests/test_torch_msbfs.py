"""The port's msBFS bit plane against the reference package: one partition
(carried over with ``repro_torch.core.convert``) and the same seeds go
through both, and every ``MSBFSState`` leaf must be equal after every
sweep -- levels, directions, convergence words and all exact counters
(work, nn_sent, wire bytes). Converged runs must equal the reference and
the numpy oracle. Exact equality throughout: every leaf is an integer or
a bool."""
import numpy as np
import pytest
pytest.importorskip("torch")

from repro.core import bfs as RB, engine as RE, msbfs as RM
from repro.core.oracle import bfs_levels
from repro.core.partition import partition_graph
from repro.graphs.rmat import pick_sources, rmat_graph
from repro_torch.core import bfs as TB, convert, engine as TE, msbfs as TM


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
    leaves = convert.state_to_numpy(ts)
    for k in TM.STATE_LEAVES:
        want, got = np.asarray(getattr(rs, k)), leaves[k]
        if want.dtype == np.uint32:        # lane words: int32 bit patterns
            got = got.view(np.uint32)
        assert got.shape == want.shape and got.dtype == want.dtype, (k, where)
        np.testing.assert_array_equal(got, want, err_msg=f"{k} {where}")


def seeds(graph, rpg, with_targets):
    srcs = [int(s) for s in pick_sources(graph, 6, seed=1)]
    if rpg.d:      # a delegate source and a delegate target
        srcs.append(int(np.asarray(rpg.delegate_vids)[0]))
    caps = [None, 2, None, 0, None, 3, None][: len(srcs)]
    tgts = None
    if with_targets:
        tgts = [None, None, (srcs[0], srcs[3]), None,
                (int(np.asarray(rpg.delegate_vids)[1]),), None, (5,)]
        tgts = tgts[: len(srcs)]
    return srcs, caps, tgts


@pytest.mark.parametrize("p_rank,p_gpu", [(1, 1), (2, 2)])
@pytest.mark.parametrize("track_levels", [True, False])
@pytest.mark.parametrize("enable_targets", [True, False])
def test_every_leaf_equal_after_every_sweep(graph, p_rank, p_gpu,
                                            track_levels, enable_targets):
    (rpg, rplan), (pg, pgv, plan) = both(graph, 32, p_rank, p_gpu)
    kw = dict(max_iters=24, track_levels=track_levels,
              enable_targets=enable_targets)
    rcfg, tcfg = RM.MSBFSConfig(**kw), TM.MSBFSConfig(**kw)
    srcs, caps, tgts = seeds(graph, rpg, enable_targets)
    rs = RM.init_multi_state(rpg, srcs, rcfg, depth_caps=caps, targets=tgts)
    ts = TM.init_multi_state(pg, srcs, tcfg, depth_caps=caps, targets=tgts,
                             device="cpu")
    rpgv = RB.device_view(rpg)
    assert_state_equal(rs, ts, "init")
    sweep = 0
    while not bool(np.all(np.asarray(rs.done))) and sweep < kw["max_iters"]:
        rs = RM.msbfs_step_emulated(rpgv, rplan, rs, rcfg)
        ts = TM.msbfs_step_emulated(pgv, plan, ts, tcfg)
        sweep += 1
        assert_state_equal(rs, ts, f"sweep {sweep}")
    assert sweep >= 3
    assert int(ts.work_bwd.sum()) > 0 or not track_levels  # pulls ran


@pytest.mark.parametrize("p_rank,p_gpu,th,w,enable_do", [
    (1, 2, 64, 32, True), (2, 2, 32, 64, True), (2, 2, 32, 32, False),
    (1, 2, 10**6, 32, True)])
def test_converged_run_equals_reference_and_oracle(graph, p_rank, p_gpu, th,
                                                   w, enable_do):
    (rpg, rplan), (pg, pgv, plan) = both(graph, th, p_rank, p_gpu)
    kw = dict(n_queries=w, max_iters=40, enable_do=enable_do)
    rcfg, tcfg = RM.MSBFSConfig(**kw), TM.MSBFSConfig(**kw)
    srcs = [int(s) for s in pick_sources(graph, w - 3, seed=9)]
    srcs.append(int(np.asarray(rpg.delegate_vids)[0]))
    rs = RM.run_msbfs_emulated(RB.device_view(rpg), rplan,
                               RM.init_multi_state(rpg, srcs, rcfg), rcfg)
    ts = TM.run_msbfs_emulated(pgv, plan, TM.init_multi_state(
        pg, srcs, tcfg, device="cpu"), tcfg)
    assert_state_equal(rs, ts, "converged")
    levels = TM.gather_levels_multi(pg, ts)
    np.testing.assert_array_equal(levels, RM.gather_levels_multi(rpg, rs))
    for q in (0, len(srcs) // 2, len(srcs) - 1):      # sampled lanes
        np.testing.assert_array_equal(levels[q], bfs_levels(graph, srcs[q]))


def test_reachability_gather_equals_reference(graph):
    (rpg, rplan), (pg, pgv, plan) = both(graph, 32, 2, 2)
    kw = dict(max_iters=40, track_levels=False, enable_targets=False)
    rcfg, tcfg = RM.MSBFSConfig(**kw), TM.MSBFSConfig(**kw)
    srcs = [int(s) for s in pick_sources(graph, 5, seed=4)]
    rs = RM.run_msbfs_emulated(RB.device_view(rpg), rplan,
                               RM.init_multi_state(rpg, srcs, rcfg), rcfg)
    ts = TM.run_msbfs_emulated(pgv, plan, TM.init_multi_state(
        pg, srcs, tcfg, device="cpu"), tcfg)
    lanes = np.array([4, 0, 2])
    np.testing.assert_array_equal(
        TM.gather_reachable_multi(pg, ts, lanes=lanes),
        RM.gather_reachable_multi(rpg, rs, lanes=lanes))


def test_rejects_oversized_batch_and_bad_sources(graph):
    (_, _), (pg, _, _) = both(graph, 32, 1, 2)
    with pytest.raises(ValueError):
        TM.init_multi_state(pg, list(range(5)), TM.MSBFSConfig(n_queries=4),
                            device="cpu")
    with pytest.raises(ValueError):
        TM.init_multi_state(pg, [pg.n], TM.MSBFSConfig(), device="cpu")
    with pytest.raises(ValueError):
        TM.init_multi_state(pg, [1], TM.MSBFSConfig(enable_targets=False),
                            targets=[(2,)], device="cpu")
