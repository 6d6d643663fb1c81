"""End-to-end distributed BFS on the PyTorch port: one graph partition per
rank of a ``torch.distributed`` world (the paper's execution model),
validated against the oracle, with the paper's workload and traffic
counters.

The twin of ``examples/distributed_bfs.py``: ``spawn`` starts one process a
rank, joined over ``PartitionMesh(("pod", "data"), mesh)`` (default 2 x 4
= 8 ranks); every rank partitions the same graph, keeps its own partition
(``core.bfs.local_partition``) and runs ``make_sharded_bfs`` over the mesh
-- delegate combine and nn exchange as collectives -- then all-gathers the
levels. The parent holds every rank's levels against the numpy oracle and
prints MTEPS, ``nn_sent``, the overflow and the delegate rounds a source.

``--backend`` is ``gloo`` by default on the CPU and ``nccl`` on the card.
NCCL drives one card a rank, so a world larger than the cards it sees is
refused; gloo may share one card between ranks (``--mesh 1,2``).

    PYTHONPATH=src python examples/torch_distributed_bfs.py [--scale 13] \
        [--mesh 2,4] [--backend gloo|nccl] [--device cuda|cpu]
"""
import argparse
import sys
import time

import numpy as np

AXES = ("pod", "data")
WORLD_TIMEOUT = 600.0          # seconds before a hung world is killed


def bfs_rank(rank: int, world: int, spec: dict) -> dict:
    """One rank: its partition, the sharded BFS of every source, the
    levels (all-gathered), ``nn_sent`` and the overflow summed over the
    ranks and this partition's delegate rounds."""
    import torch

    from repro_torch.core import bfs as B, comm as C
    from repro_torch.core.partition import partition_graph
    from repro_torch.graphs.rmat import rmat_graph

    dev = B.resolve_device(spec["device"])
    sync = ((lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
            else (lambda: None))
    mesh = C.dist.PartitionMesh(AXES, spec["mesh"])
    g = rmat_graph(spec["scale"], seed=0)
    pg = partition_graph(g, th=spec["th"], p_rank=spec["mesh"][0],
                         p_gpu=spec["mesh"][1])
    pgv = B.device_view(B.local_partition(pg, rank), dev)
    cfg = B.BFSConfig(max_iters=48, enable_do=spec["do"])
    run = B.make_sharded_bfs(mesh, AXES, cfg)
    out = {"d": int(pg.d), "e_nn": int(np.asarray(pg.nn.m).sum()),
           "runs": []}
    for src in spec["sources"]:
        st = B.init_state(pg, src, cfg, dev, mesh=mesh)
        sync()
        t0 = time.perf_counter()
        st = run(pgv, st)
        sync()
        dt = time.perf_counter() - t0
        sums = torch.stack([st.nn_sent.sum(), st.nn_overflow.sum()])
        sums = C.dist.all_reduce(mesh, sums, "sum").tolist()
        out["runs"].append(dict(
            src=src, time_s=dt, iters=int(st.it[0]),
            levels=B.gather_levels(pg, st, mesh=mesh), nn_sent=sums[0],
            overflow=sums[1],
            delegate_rounds=int(st.delegate_round[0].sum())))
    return out


def main():
    import torch

    from repro_torch.core import comm as C
    from repro_torch.core.oracle import bfs_levels
    from repro_torch.core.types import INF_LEVEL
    from repro_torch.graphs.rmat import pick_sources, rmat_graph

    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=13)
    ap.add_argument("--th", type=int, default=64)
    ap.add_argument("--do", action="store_true", default=True)
    ap.add_argument("--mesh", default="2,4",
                    help="ranks along (pod, data), e.g. 2,4 or 1,2")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="process group backend (default: nccl on cuda, "
                         "gloo on cpu)")
    ap.add_argument("--device", default="cuda",
                    help="where each rank runs (cuda, or cpu for the plain "
                         "PyTorch path)")
    ap.add_argument("--sources", type=int, default=3)
    args = ap.parse_args()
    mesh = tuple(int(x) for x in args.mesh.split(","))
    if len(mesh) != 2 or min(mesh) < 1:
        ap.error(f"--mesh takes two positive sizes, not {args.mesh!r}")
    world = mesh[0] * mesh[1]
    on_card = args.device.startswith("cuda")
    backend = args.backend or ("nccl" if on_card else "gloo")
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is visible "
                           "(pass --device cpu for the plain PyTorch path)")
    if backend == "nccl":
        if not on_card:
            raise ValueError("--backend nccl needs --device cuda")
        if world > torch.cuda.device_count():
            raise ValueError(
                f"--backend nccl drives one card a rank: a {args.mesh} mesh "
                f"needs {world} cards, {torch.cuda.device_count()} visible "
                "(use --backend gloo to share cards between ranks)")

    g = rmat_graph(args.scale, seed=0)
    sources = [int(s) for s in pick_sources(g, args.sources, seed=2)]
    print(f"mesh: {dict(zip(AXES, mesh))} over {world} ranks "
          f"({backend}, {args.device})")
    spec = dict(scale=args.scale, th=args.th, mesh=mesh, do=args.do,
                device=args.device, sources=sources)
    res = C.dist.spawn(bfs_rank, world, (spec,), backend=backend,
                       timeout=WORLD_TIMEOUT)
    print(f"graph n={g.n:,} m={g.m:,}; delegates={res[0]['d']}, "
          f"E_nn={res[0]['e_nn']:,}")
    for i, src in enumerate(sources):
        ref = bfs_levels(g, src)
        runs = [r["runs"][i] for r in res]
        ok = all(np.array_equal(r["levels"], ref) for r in runs)
        r0 = runs[0]
        edges = int((ref[g.src] != INF_LEVEL).sum()) // 2
        print(f"src={src:7,d} iters={r0['iters']:2d} "
              f"match={'OK' if ok else 'FAIL'} "
              f"MTEPS={edges / r0['time_s'] / 1e6:7.2f} "
              f"sent={r0['nn_sent']:,} overflow={r0['overflow']} "
              f"S'={r0['delegate_rounds']}")
        if not ok or r0["overflow"] != 0:
            sys.exit(1)
    print("all sources validated against the oracle.")


if __name__ == "__main__":
    main()
