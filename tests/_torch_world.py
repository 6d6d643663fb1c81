"""World functions of the sharded parity tests, and the JAX-free checks
that hold a world's results against the emulated port.

The world functions run on every rank of a spawned world
(``repro_torch.core.comm.dist.spawn``) and import only the port (a spawned
rank imports no JAX). Every rank builds the same graph and runs the same
cases in the same order (the multi-controller contract), holding its own
partition only. The parent test process computes what they are held
against: ``tests/test_torch_sharded.py`` on a gloo world of CPU processes
(also against the reference), ``tests/test_torch_cuda.py`` on NCCL worlds
of cards."""
import numpy as np

from repro_torch.core import bfs as B, comm as C, convert, engine as E
from repro_torch.core import msbfs as M
from repro_torch.core.partition import partition_graph
from repro_torch.core.types import COOGraph
from repro_torch.graphs.rmat import pick_sources, rmat_graph
from repro_torch.obs import Observability
from repro_torch.serve import (BFSServeEngine, Query, QueryKind,
                               ServeFrontend)

AXES = ("rank", "gpu")
SIZES = (2, 2)
STRATS = [(d, nn) for d in ("allgather", "ring", "hier")
          for nn in ("dense", "adaptive")]


def graph(spec: dict):
    g = rmat_graph(spec["scale"], seed=spec["seed"])
    return g, partition_graph(g, th=spec["th"], p_rank=spec["sizes"][0],
                              p_gpu=spec["sizes"][1])


def default_spec(device: str = "cpu") -> dict:
    """Every case of one sharded world on rmat scale 10 (seed 7), th = 32,
    the (2, 2) mesh: the sharded msBFS run under allgather / ring / hier x
    dense / adaptive, a step and a block; the sharded BFS with the static
    plan under the same six, binned under auto / ring / hier, and the
    uint8 combine; the engine in batch (twice), refill, overlap
    (``sweep_block`` 1 and 4) and stream modes, on mixed typed queries,
    and in batch and refill modes with ``edge_chunk`` under the compressed
    nn format;
    and the payload kinds on rmat scale 8 (seed 11): a batch of SSSP,
    COMPONENTS and LEVELS queries and all seven kinds through refill,
    overlap and stream sessions; and the multi-tenant frontend over two
    same-shape graphs (rmat scale 7, seed 3, and its ``v -> (v + 4) % n``
    relabelling), a latency-class tenant on one and a throughput-class
    tenant on the other, with telemetry and an obs plane on."""
    g, pg = graph(dict(scale=10, seed=7, th=32, sizes=SIZES))
    srcs = [int(s) for s in pick_sources(g, 10, seed=3)]
    dv = [int(v) for v in np.asarray(pg.delegate_vids)[:2]]
    sources = srcs[:6] + dv[:1]
    caps = [None, 2, None, 0, None, 3, None]
    targets = [None, None, (srcs[0], srcs[3]), None, (dv[1],), None, (5,)]
    msbfs = {f"run-{d}-{nn}": dict(driver="run", comm=dict(delegate=d, nn=nn))
             for d, nn in STRATS}
    msbfs["step-ring-adaptive"] = dict(driver="step", sweeps=2,
                                       comm=dict(delegate="ring",
                                                 nn="adaptive"))
    # the block watches lane 0 (no cap, no targets): it runs all k sweeps
    msbfs["block-hier-dense"] = dict(driver="block", k=3, watch=[0],
                                     comm=dict(delegate="hier", nn="dense"))
    for case in msbfs.values():
        case.update(w=32, max_iters=32, sources=sources, caps=caps,
                    targets=targets)
    bfs = {f"plan-{d}-{nn}": dict(with_plan=True, u8=False,
                                  comm=dict(delegate=d, nn=nn))
           for d, nn in STRATS}
    bfs.update({f"binned-{d}": dict(with_plan=False, u8=False,
                                    comm=dict(delegate=d))
                for d in ("auto", "ring", "hier")})
    bfs["plan-u8-auto"] = dict(with_plan=True, u8=True, comm=dict())
    for case in bfs.values():
        case["source"] = srcs[0]
    kinds = [("levels", None, None), ("reachability", None, None),
             ("distance_limited", 2, None),
             ("multi_target", None, (srcs[1], srcs[2]))]
    qs = [(s, *kinds[i % 4]) for i, s in enumerate(srcs + dv + srcs[:2])]
    # the reference's sharded payload cases, on its graph (rmat 8, seed 11)
    g8, _ = graph(dict(scale=8, seed=11, th=32, sizes=SIZES))
    s9 = [int(s) for s in pick_sources(g8, 4, seed=9)]
    s3 = [int(s) for s in pick_sources(g8, 6, seed=3)]
    seven = [(s3[0], "levels", None, None), (s3[1], "reachability", None, None),
             (s3[2], "distance_limited", 2, None),
             (s3[3], "multi_target", None, (s3[0], s3[1])),
             (s3[4], "weighted_sssp", None, None),
             (s3[5], "components", None, None),
             (s3[0], "khop_sample", 2, None), (s3[2], "weighted_sssp", None,
                                               None)]
    payload = dict(scale=8, seed=11, th=32, sizes=SIZES, cases={
        "payload-batch": dict(
            mode="batch", k=1, w=4, max_iters=80, comm=dict(),
            queries=[(s9[0], "weighted_sssp", None, None),
                     (s9[1], "components", None, None),
                     (s9[2], "levels", None, None),
                     (s9[3], "weighted_sssp", None, None)]),
        "payload-refill": dict(mode="refill", k=1, w=4, max_iters=80,
                               comm=dict(), queries=seven),
        "payload-overlap-allgather": dict(
            mode="overlap", k=4, w=4, max_iters=80,
            comm=dict(delegate="allgather"), queries=seven),
        "payload-stream-ring-adaptive": dict(
            mode="stream", k=2, w=4, max_iters=80,
            comm=dict(delegate="ring", nn="adaptive"),
            queries=seven[4:] + seven[:4]),
    })
    engine = {
        "batch": dict(mode="batch", k=1, w=8, comm=dict()),
        "batch-hier-adaptive": dict(mode="batch", k=1, w=8,
                                    comm=dict(delegate="hier",
                                              nn="adaptive")),
        "refill": dict(mode="refill", k=1, w=4, comm=dict()),
        "overlap-1": dict(mode="overlap", k=1, w=4, comm=dict()),
        "overlap-4": dict(mode="overlap", k=4, w=4, comm=dict()),
        "stream": dict(mode="stream", k=4, w=4, comm=dict()),
        "batch-chunked-compressed": dict(mode="batch", k=1, w=8,
                                         comm=dict(nn="compressed"),
                                         edge_chunk=64),
        "refill-chunked-compressed": dict(mode="refill", k=1, w=4,
                                          comm=dict(nn="compressed"),
                                          edge_chunk=37),
    }
    frontend = dict(scale=7, seed=3, shift=4, w=4, max_iters=80, tenants=[
        ("acme", "g1", "latency",
         [(1, "levels", None, None), (2, "reachability", None, None),
          (3, "distance_limited", 2, None)]),
        ("beta", "g2", "throughput",
         [(4, "levels", None, None), (5, "multi_target", None, (1, 2)),
          (6, "levels", None, None)])])
    return dict(scale=10, seed=7, th=32, sizes=SIZES, msbfs=msbfs, bfs=bfs,
                frontend=frontend,
                engine=engine, queries=qs, payload=payload, device=device)


def queries(spec: list) -> list:
    """Typed queries from ``(source, kind, max_depth, targets)`` tuples."""
    return [Query(s, QueryKind(k), max_depth=d, targets=t)
            for s, k, d, t in spec]


def run_msbfs(pg, pgv, plan, case: dict, device, mesh=None):
    """One msBFS case, sharded over ``mesh`` or emulated (None)."""
    cfg = M.MSBFSConfig(n_queries=case["w"], max_iters=case["max_iters"],
                        pull_chunk=16, comm=C.CommConfig(**case["comm"]))
    st = M.init_multi_state(pg, case["sources"], cfg,
                            depth_caps=case["caps"], targets=case["targets"],
                            device=device, mesh=mesh)
    driver = case["driver"]
    if driver == "run":
        if mesh is None:
            return M.run_msbfs_emulated(pgv, plan, st, cfg)
        return M.make_sharded_msbfs(mesh, AXES, cfg)(pgv, plan, st)
    if driver == "step":
        for _ in range(case["sweeps"]):
            st = (M.msbfs_step_emulated(pgv, plan, st, cfg) if mesh is None
                  else M.make_sharded_msbfs_step(mesh, AXES, cfg)(pgv, plan,
                                                                  st))
        return st
    block = (M.make_msbfs_block_emulated(cfg, case["k"]) if mesh is None
             else M.make_sharded_msbfs_block(mesh, AXES, cfg, case["k"]))
    run = block(pgv, plan, st, np.isin(np.arange(case["w"]), case["watch"]))
    run.wait()
    block.runner.drain()
    return run.out


def run_bfs(pg, pgv, plan, case: dict, device, mesh=None):
    """One single-source case, sharded over ``mesh`` or emulated."""
    cfg = B.BFSConfig(max_iters=32, pull_chunk=16,
                      static_exchange=case["with_plan"],
                      delegate_u8=case["u8"],
                      comm=C.CommConfig(**case["comm"]))
    st = B.init_state(pg, case["source"], cfg, device=device, mesh=mesh)
    if mesh is None:
        return B.run_bfs_emulated(pgv, st, cfg,
                                  plan if case["with_plan"] else None)
    run = B.make_sharded_bfs(mesh, AXES, cfg, with_plan=case["with_plan"])
    return run(pgv, plan, st) if case["with_plan"] else run(pgv, st)


def serve(eng, mode: str, qs: list) -> dict:
    """Drive an engine: ``"batch"`` / ``"refill"`` / ``"overlap"`` serve
    ``submit_many``; ``"stream"`` feeds four chunks with a ``poll()``
    after each, then drains. Returns ``{"answers": [...], "stats": ...}``
    with the answers in query order."""
    if mode == "stream":
        got: dict = {}
        step = -(-len(qs) // 4)
        for i in range(0, len(qs), step):
            eng.submit_stream(qs[i:i + step])
            got.update(eng.poll())
        got.update(eng.drain_stream())
        answers = [got[q] for q in qs]
    else:
        answers = eng.submit_many(qs)
    return {"answers": answers, "stats": eng.stats.as_dict()}


def make_engine(pg, case: dict, device, **kw) -> BFSServeEngine:
    mode = case["mode"]
    if mode != "batch":
        kw.update(refill=True, overlap=mode in ("overlap", "stream"),
                  sweep_block=case["k"])
    return BFSServeEngine(
        pg=pg, cfg=M.MSBFSConfig(n_queries=case["w"],
                                 max_iters=case.get("max_iters", 48)),
        comm=C.CommConfig(**case["comm"]),
        edge_chunk=case.get("edge_chunk", 0), device=device, **kw)


def frontend_graphs(spec: dict) -> dict:
    """The frontend case's two same-shape graphs, by name."""
    g1 = rmat_graph(spec["scale"], seed=spec["seed"])
    g2 = COOGraph(g1.n, (g1.src + spec["shift"]) % g1.n,
                  (g1.dst + spec["shift"]) % g1.n)
    return {"g1": g1, "g2": g2}


def run_frontend(spec: dict, device, mesh=None) -> dict:
    """The frontend case: each tenant's queries submitted at once, one
    drain, then each engine's stream session closed; returns each tenant's answers (in query order) and
    ``TenantStats``, each engine's ``ServeStats`` and harvested telemetry,
    and the trace's event names."""
    obs = Observability()
    ft = ServeFrontend(obs=obs, device=device, cache_capacity=0,
                       reuse_components=False)
    kw = dict(th=32, p_rank=SIZES[0], p_gpu=SIZES[1],
              cfg=M.MSBFSConfig(n_queries=spec["w"],
                                max_iters=spec["max_iters"], telemetry=True))
    if mesh is not None:
        kw.update(mesh=mesh, partition_axes=AXES)
    for name, g in frontend_graphs(spec).items():
        ft.register_graph(name, g, **kw)
    sessions = {t: (ft.open_session(t, g, slo=slo), queries(qs))
                for t, g, slo, qs in spec["tenants"]}
    for sess, qs in sessions.values():
        ft.submit(sess, qs)
    got = {}
    for res in ft.drain().values():
        got.update(res)
    for e in ft.engines.values():
        # a frontend leaves its engines' stream sessions open: closing one
        # harvests its telemetry
        assert e.drain_stream() == {}
    tel = {n: {k: getattr(e.last_telemetry, k) for k in (
        "sweeps", "frontier_n", "frontier_d", "dir_backward", "wire_nn",
        "nn_sparse", "nn_overflow")} for n, e in ft.engines.items()}
    return {"answers": {t: [got[q] for q in qs]
                        for t, (_, qs) in sessions.items()},
            "tenants": {t: ft.tenant_stats(t).as_dict() for t in sessions},
            "stats": {n: e.stats.as_dict() for n, e in ft.engines.items()},
            "sharded": [e.sharded for e in ft.engines.values()],
            "telemetry": tel,
            "events": sorted({e.name for e in obs.trace.events()})}


def sharded_world(rank: int, world: int, spec: dict) -> dict:
    """All cases of ``spec``, on this rank's partition (on card ``rank``
    where ``spec["device"]`` is ``"cuda"``)."""
    dev = "cpu" if spec["device"] == "cpu" else f"cuda:{rank}"
    mesh = C.dist.PartitionMesh(AXES, spec["sizes"])
    g, pg = graph(spec)
    host_plan = E.build_exchange_plan(pg)
    pgv = B.device_view(B.local_partition(pg, mesh.rank), dev)
    plan = E.device_plan(E.local_plan(host_plan, mesh.rank), dev)
    out = {"msbfs": {}, "bfs": {}, "engine": {}, "rows": set()}
    for name, case in spec["msbfs"].items():
        st = run_msbfs(pg, pgv, plan, case, dev, mesh)
        out["msbfs"][name] = {"leaves": convert.state_to_numpy(st),
                              "levels": M.gather_levels_multi(pg, st,
                                                              mesh=mesh)}
    for name, case in spec["bfs"].items():
        st = run_bfs(pg, pgv, plan, case, dev, mesh)
        out["bfs"][name] = {"leaves": convert.bfs_state_to_numpy(st),
                            "levels": B.gather_levels(pg, st, mesh=mesh)}
    qs = queries(spec["queries"])
    for name, case in spec["engine"].items():
        eng = make_engine(pg, case, dev, mesh=mesh, partition_axes=AXES)
        out["rows"].add((eng.sharded, int(eng.pgv.normal_valid.shape[0])))
        out["engine"][name] = serve(eng, case["mode"], qs)
    # this rank's own partition and plan rows alone serve as well
    eng = make_engine(B.local_partition(pg, mesh.rank),
                      spec["engine"]["batch"], dev, mesh=mesh,
                      plan=E.local_plan(host_plan, mesh.rank))
    out["rows"].add((eng.sharded, int(eng.pgv.normal_valid.shape[0])))
    out["engine"]["batch-local"] = serve(eng, "batch", qs)
    _, pg8 = graph(spec["payload"])
    out["payload"] = {}
    for name, case in spec["payload"]["cases"].items():
        eng = make_engine(pg8, case, dev, mesh=mesh, partition_axes=AXES)
        out["payload"][name] = serve(eng, case["mode"],
                                     queries(case["queries"]))
    out["frontend"] = run_frontend(spec["frontend"], dev, mesh)
    # a mesh that does not span the graph's partitions is refused
    g2 = partition_graph(g, th=spec["th"], p_rank=1, p_gpu=2)
    try:
        BFSServeEngine(pg=g2, device=dev, mesh=mesh)
        out["mismatch"] = None
    except ValueError as e:
        out["mismatch"] = str(e)
    return out


def one_rank_world(rank: int, world: int, spec: dict) -> dict:
    """A mesh of one rank keeps the emulated path."""
    mesh = C.dist.PartitionMesh(("p",), (1,))
    g, pg = graph(spec)
    eng = BFSServeEngine(pg=pg, cfg=M.MSBFSConfig(n_queries=8, max_iters=48),
                         device="cpu", mesh=mesh)
    res = serve(eng, "batch", queries(spec["queries"]))
    res["sharded"] = eng.sharded
    res["rows"] = int(eng.pgv.normal_valid.shape[0])
    return res


def nccl_world(rank: int, world: int, spec: dict) -> dict:
    """The sharded msBFS on the card over NCCL (a world of one rank, one
    partition): the run, two steps and a captured block, each against the
    emulated run on the same views; returns which leaves differ."""
    import torch

    torch.cuda.set_device(0)
    mesh = C.dist.PartitionMesh(("p",), (1,))
    g = rmat_graph(spec["scale"], seed=spec["seed"])
    pg = partition_graph(g, th=spec["th"], p_rank=1, p_gpu=1)
    pgv = B.device_view(pg, "cuda")
    plan = E.device_plan(E.build_exchange_plan(pg), "cuda")
    cfg = M.MSBFSConfig(n_queries=32, max_iters=48,
                        comm=C.CommConfig(**spec["comm"]))
    init = lambda m: M.init_multi_state(pg, spec["sources"], cfg,
                                        device="cuda", mesh=m)
    diff = lambda a, b: [k for k in M.STATE_LEAVES
                         if not torch.equal(getattr(a, k), getattr(b, k))]
    out = {}
    out["run"] = diff(M.make_sharded_msbfs(mesh, None, cfg)(pgv, plan,
                                                           init(mesh)),
                      M.run_msbfs_emulated(pgv, plan, init(None), cfg))
    a, b = init(mesh), init(None)
    for _ in range(2):
        a = M.make_sharded_msbfs_step(mesh, None, cfg)(pgv, plan, a)
        b = M.msbfs_step_emulated(pgv, plan, b, cfg)
    out["step"] = diff(a, b)
    watch = np.arange(32) == 0
    blk = M.make_sharded_msbfs_block(mesh, None, cfg, 3)
    run = blk(pgv, plan, init(mesh), watch)
    run.wait()
    blk.runner.drain()
    ref = M.make_msbfs_block_emulated(cfg, 3)(pgv, plan, init(None), watch)
    ref.wait()
    out["block"] = diff(run.out, ref.out)
    out["captured"] = blk.runner.graphs is not None
    out["sweeps"] = int(run.out.it[0])
    torch.cuda.synchronize()
    return out


# -----------------------------------------------------------------------------
# Checks of a world's results against the emulated port (JAX-free)


def gathered(ranks: list, kind: str, name: str) -> dict:
    """Each rank's leaves of one case, leading dimension 1, stacked in
    rank (= partition) order."""
    out = {}
    for leaf in ranks[0][kind][name]["leaves"]:
        parts = [r[kind][name]["leaves"][leaf] for r in ranks]
        assert all(x.shape[0] == 1 for x in parts), leaf
        out[leaf] = np.concatenate(parts)
    return out


def assert_leaves(got: dict, want: dict, skip=()) -> None:
    for k, w in want.items():
        if k in skip:
            continue
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def delegate_bytes_pair(plan_of, comm: dict, n_elems: int, itemsize: int,
                        op: str) -> tuple:
    """One combine's bytes on the sharded (2, 2) plan and on the emulated
    one-axis plan of 4; ``plan_of(comm, axes, sizes)`` builds a plan (the
    reference's or the port's: the formulas are the same)."""
    return (plan_of(comm, AXES, SIZES).delegate_bytes(n_elems, itemsize, op),
            plan_of(comm, ("p",), (4,)).delegate_bytes(n_elems, itemsize,
                                                       op))


def check_wire_delegate(got, emu, pair) -> None:
    """Per sweep: the sharded plan's formula where the emulated one ran
    (ring and hier reduce per mesh axis; emulated, over one axis of 4)."""
    f22, f4 = pair
    np.testing.assert_array_equal(got, np.where(emu == f4, f22, emu))
    assert (emu == f4).any()


def check_state_case(ranks: list, kind: str, name: str, case: dict, pg,
                     emu, plan_of) -> dict:
    """A msBFS or BFS case: every gathered leaf equals the emulated state
    ``emu`` but ``wire_delegate`` (the sharded formula), and every rank
    got every level. Returns the gathered leaves."""
    want = (convert.state_to_numpy(emu) if kind == "msbfs"
            else convert.bfs_state_to_numpy(emu))
    got = gathered(ranks, kind, name)
    assert_leaves(got, want, skip=("wire_delegate",))
    if kind == "msbfs":
        pair = delegate_bytes_pair(plan_of, case["comm"], max(pg.d, 1)
                                   * C.n_words(case["w"]), 4, "or")
        levels = M.gather_levels_multi(pg, emu)
    else:
        pair = delegate_bytes_pair(plan_of, case["comm"], max(pg.d, 1),
                                   1 if case["u8"] else 4,
                                   "max" if case["u8"] else "min")
        levels = B.gather_levels(pg, emu)
    check_wire_delegate(got["wire_delegate"], want["wire_delegate"], pair)
    for r in ranks:
        np.testing.assert_array_equal(r[kind][name]["levels"], levels)
    return got


def check_engine_case(ranks: list, name: str, case: dict, want: dict, pg,
                      plan_of, section: str = "engine") -> None:
    """Every rank's answers and ``ServeStats`` equal the emulated
    engine's ``want``, its delegate bytes (and the payload plane's) in the
    sharded plan's formula."""
    ws = dict(want["stats"])
    for key, n, op in (("wire_delegate_bytes", C.n_words(case["w"]), "or"),
                       ("wire_pay_delegate_bytes", case["w"], "min")):
        f22, f4 = delegate_bytes_pair(plan_of, case["comm"],
                                      max(pg.d, 1) * n, 4, op)
        combines, rest = divmod(ws[key], f4)
        assert rest == 0 and (combines > 0 or key != "wire_delegate_bytes")
        ws[key] = combines * f22
        ws["wire_bytes_total"] += combines * (f22 - f4)
    for r in ranks:
        got = r[section][name]
        assert got["stats"] == ws
        assert len(got["answers"]) == len(want["answers"])
        for a, b in zip(got["answers"], want["answers"]):
            if isinstance(b, dict):
                assert a == b
            else:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
