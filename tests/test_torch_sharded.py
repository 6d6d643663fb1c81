"""The port's sharded drivers and engine on a ``torch.distributed`` world
of 4 CPU processes (``gloo``, a ``("rank", "gpu")`` mesh of (2, 2), one
partition per rank, ``file://`` rendezvous, hard timeout), against the
emulated port and the JAX reference on the same graph (rmat scale 10).

One world runs every case (``tests/_torch_world.py``); this process
computes what it is held against. Every state leaf, gathered over the
ranks, must equal the emulated run's -- but ``wire_delegate``, which must
equal the reference ``CommPlan`` formula for axes (2, 2): ring and hier
reduce per mesh axis there, over one axis of 4 when emulated -- and the
emulated run must equal the reference's. Each rank's tensors hold its own
partition only. Engine answers and every ``ServeStats`` field equal the
emulated engine's. Exact equality throughout."""
import numpy as np
import pytest
pytest.importorskip("torch")

import _torch_world as TW
from repro.core import bfs as RB, comm as RC, engine as RE, msbfs as RM
from repro.core.partition import partition_graph as ref_partition
from repro.graphs.rmat import rmat_graph as ref_rmat
from repro_torch.core import bfs as TB, comm as TC, convert, engine as TE
from repro_torch.core import msbfs as TM, oracle as O
from repro_torch.serve import BFSServeEngine, QueryKind

WORLD_TIMEOUT = 300.0
SPEC = TW.default_spec("cpu")


def ref_plan(comm: dict, axes, sizes):
    """The reference's plan: its byte formulas hold the wire counters."""
    return RC.CommPlan(RC.CommConfig(**comm), axes, sizes)


@pytest.fixture(scope="module")
def world():
    return TC.dist.spawn(TW.sharded_world, 4, (SPEC,), timeout=WORLD_TIMEOUT)


@pytest.fixture(scope="module")
def graphs():
    g = ref_rmat(10, seed=7)
    rpg = ref_partition(g, th=32, p_rank=2, p_gpu=2)
    pg = convert.partition_from_arrays(*convert.partition_to_arrays(rpg))
    plan = TE.device_plan(TE.build_exchange_plan(pg), "cpu")
    return (g, rpg, RE.build_exchange_plan(rpg), pg,
            TB.device_view(pg, "cpu"), plan)


@pytest.mark.parametrize("name", list(SPEC["msbfs"]))
def test_sharded_msbfs_matches_emulated(world, graphs, name):
    case = SPEC["msbfs"][name]
    pg, pgv, plan = graphs[3:]
    emu = TW.run_msbfs(pg, pgv, plan, case, "cpu")
    got = TW.check_state_case(world, "msbfs", name, case, pg, emu, ref_plan)
    assert int(got["it"][0]) >= (2 if case["driver"] == "step" else 3)


@pytest.mark.parametrize("name", [n for n in SPEC["msbfs"]
                                  if n.startswith("run-")])
def test_sharded_msbfs_matches_reference(world, graphs, name):
    """Through the emulated port to the reference: the gathered sharded
    state equals the reference's emulated run (its ``wire_delegate`` in
    the (2, 2) plan's formula)."""
    case = SPEC["msbfs"][name]
    g, rpg, rplan, pg = graphs[:4]
    cfg = RM.MSBFSConfig(n_queries=case["w"], max_iters=case["max_iters"],
                         pull_chunk=16, comm=RC.CommConfig(**case["comm"]))
    rs = RM.run_msbfs_emulated(
        RB.device_view(rpg), rplan,
        RM.init_multi_state(rpg, case["sources"], cfg,
                            depth_caps=case["caps"], targets=case["targets"]),
        cfg)
    got = TW.gathered(world, "msbfs", name)
    want = {k: np.asarray(getattr(rs, k)) for k in TM.STATE_LEAVES}
    want = {k: w.view(np.int32) if w.dtype == np.uint32 else w
            for k, w in want.items()}
    TW.assert_leaves(got, want, skip=("wire_delegate",))
    TW.check_wire_delegate(got["wire_delegate"], want["wire_delegate"],
                           TW.delegate_bytes_pair(ref_plan, case["comm"],
                                                  max(pg.d, 1), 4, "or"))
    assert bool(got["done"].all())


@pytest.mark.parametrize("name", list(SPEC["bfs"]))
def test_sharded_bfs_matches_emulated_and_reference(world, graphs, name):
    case = SPEC["bfs"][name]
    g, rpg, rplan, pg, pgv, plan = graphs
    emu = TW.run_bfs(pg, pgv, plan, case, "cpu")
    rcfg = RB.BFSConfig(max_iters=32, pull_chunk=16,
                        static_exchange=case["with_plan"],
                        delegate_u8=case["u8"],
                        comm=RC.CommConfig(**case["comm"]))
    rs = RB.run_bfs_emulated(RB.device_view(rpg),
                             RB.init_state(rpg, case["source"], rcfg), rcfg,
                             plan=rplan if case["with_plan"] else None)
    TW.assert_leaves(convert.bfs_state_to_numpy(emu),
                     {k: np.asarray(getattr(rs, k))
                      for k in convert.BFS_STATE_LEAVES})
    TW.check_state_case(world, "bfs", name, case, pg, emu, ref_plan)


@pytest.mark.parametrize("name", list(SPEC["engine"]) + ["batch-local"])
def test_sharded_engine_matches_emulated(world, graphs, name):
    """Every mode of the engine with ``mesh=`` (and one built on a rank's
    own partition and plan rows, ``batch-local``): every rank's answers
    and ``ServeStats`` fields equal the emulated engine's."""
    case = SPEC["engine"]["batch" if name == "batch-local" else name]
    pg = graphs[3]
    want = TW.serve(TW.make_engine(pg, case, "cpu"), case["mode"],
                    TW.queries(SPEC["queries"]))
    assert want["stats"]["queries"] == len(SPEC["queries"])
    TW.check_engine_case(world, name, case, want, pg, ref_plan)
    if case["mode"] != "batch":
        assert want["stats"]["refills"] > 0
    if case["mode"] in ("overlap", "stream"):
        assert want["stats"]["sweep_blocks"] > 0


@pytest.mark.parametrize("name", list(SPEC["payload"]["cases"]))
def test_sharded_payload_kinds_match_emulated(world, name):
    """The reference's sharded payload cases (a batch of SSSP, COMPONENTS
    and LEVELS; all seven kinds through one refill session), and all
    seven through overlap blocks under allgather and a stream under ring /
    adaptive: every rank's answers and
    stats equal the emulated engine's (payload delegate bytes in the (2,
    2) plan's formula), whose answers are oracle-exact."""
    spec = SPEC["payload"]
    case = spec["cases"][name]
    g, pg = TW.graph(spec)
    qs = TW.queries(case["queries"])
    want = TW.serve(TW.make_engine(pg, case, "cpu"), case["mode"], qs)
    csr = O.csr_from_coo(g)
    for q, a in zip(qs, want["answers"]):
        oracle_check(g, q, a, csr)
    assert want["stats"]["wire_pay_delegate_bytes"] > 0
    TW.check_engine_case(world, name, case, want, pg, ref_plan, "payload")


def oracle_check(g, q, a, csr) -> None:
    K = QueryKind
    if q.kind is K.WEIGHTED_SSSP:
        np.testing.assert_array_equal(a, O.dijkstra_levels(g, q.source, csr))
    elif q.kind is K.COMPONENTS:
        np.testing.assert_array_equal(a, O.component_labels(g))
    elif q.kind is K.KHOP_SAMPLE:
        np.testing.assert_array_equal(a, O.khop_nodes(g, q.source,
                                                      q.max_depth, csr))
    elif q.kind is K.REACHABILITY:
        np.testing.assert_array_equal(a, O.reachable_mask(g, q.source, csr))
    elif q.kind is K.MULTI_TARGET:
        assert a == O.target_depths(g, q.source, q.targets, csr)
    else:
        np.testing.assert_array_equal(a, O.bfs_levels_limited(
            g, q.source, q.max_depth if q.max_depth is not None else 2**30,
            csr))


def test_each_rank_holds_its_partition_and_a_bad_mesh_raises(world):
    for r in world:
        assert r["rows"] == {(True, 1)}
        assert r["mismatch"] is not None and "p=2" in r["mismatch"]


def test_one_rank_mesh_keeps_the_emulated_path(graphs):
    spec = dict(scale=10, seed=7, th=32, sizes=(1, 2),
                queries=SPEC["queries"][:6])
    (res,) = TC.dist.spawn(TW.one_rank_world, 1, (spec,),
                           timeout=WORLD_TIMEOUT)
    assert res["sharded"] is False and res["rows"] == 2
    pg = convert.partition_from_arrays(*convert.partition_to_arrays(
        ref_partition(graphs[0], th=32, p_rank=1, p_gpu=2)))
    want = TW.serve(BFSServeEngine(pg=pg, cfg=TM.MSBFSConfig(n_queries=8,
                                                             max_iters=48),
                                   device="cpu"),
                    "batch", TW.queries(spec["queries"]))
    assert res["stats"] == want["stats"]
    for a, b in zip(res["answers"], want["answers"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
