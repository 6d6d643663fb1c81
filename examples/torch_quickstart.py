"""Quickstart on the PyTorch port: degree-separated DOBFS on an RMAT graph,
4 emulated partitions.

The twin of ``examples/quickstart.py`` on ``repro_torch``: partitions a
Graph500 RMAT graph, prints the partition's memory against the edge list
and CSR (the paper's Table I: about 1/3 and 0.55), then runs one
single-source BFS a source (``core.bfs.init_state`` ->
``run_bfs_emulated`` -> ``gather_levels``; on a card each sweep's three
pulls are one ``ell_pull`` kernel launch) and checks every answer against
the numpy oracle. Exits 1 on a mismatch.

    PYTHONPATH=src python examples/torch_quickstart.py [--scale 12] \
        [--th 64] [--device cuda|cpu]
"""
import argparse
import sys
import time

import numpy as np


def main():
    import torch

    from repro_torch.core import bfs as B
    from repro_torch.core.oracle import bfs_levels
    from repro_torch.core.partition import partition_graph
    from repro_torch.core.types import INF_LEVEL
    from repro_torch.graphs.rmat import pick_sources, rmat_graph

    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=12)
    ap.add_argument("--th", type=int, default=64)
    ap.add_argument("--p-rank", type=int, default=2)
    ap.add_argument("--p-gpu", type=int, default=2)
    ap.add_argument("--sources", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="where the BFS runs (cuda, or cpu for the plain "
                         "PyTorch path)")
    args = ap.parse_args()
    dev = B.resolve_device(args.device)

    print(f"generating RMAT scale {args.scale} (Graph500 params)...")
    g = rmat_graph(args.scale, seed=0)
    print(f"  n={g.n:,} m={g.m:,}")

    pg = partition_graph(g, th=args.th, p_rank=args.p_rank, p_gpu=args.p_gpu)
    mem = pg.memory_bytes()
    print(f"partitioned: p={pg.p} delegates={pg.d} ({pg.d/g.n:.2%}) "
          f"nn-edges={mem['e_nn']/mem['m']:.2%}")
    print(f"memory: {mem['total']:,}B = "
          f"{mem['total']/mem['edge_list_16m']:.2f}x edge-list, "
          f"{mem['total']/mem['csr_8n_8m']:.2f}x CSR  "
          "(paper Table I: ~1/3, ~0.55)")

    cfg = B.BFSConfig(max_iters=48, enable_do=True)
    pgv = B.device_view(pg, dev)
    teps = []
    for src in pick_sources(g, args.sources, seed=1):
        st = B.init_state(pg, int(src), cfg, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = B.run_bfs_emulated(pgv, st, cfg)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        levels = B.gather_levels(pg, out)
        ref = bfs_levels(g, int(src))
        ok = np.array_equal(levels, ref)
        edges = int((ref[g.src] != INF_LEVEL).sum()) // 2
        teps.append(edges / dt)
        w = int(out.work_fwd.sum()) + int(out.work_bwd.sum())
        print(f"  src={int(src):6d} iters={int(out.it[0])} "
              f"match={'OK' if ok else 'FAIL'} MTEPS={edges/dt/1e6:8.2f} "
              f"work={w:,}")
        if not ok:
            sys.exit(1)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "the CPU: plain PyTorch path")
    print(f"geomean MTEPS: {np.exp(np.mean(np.log(teps)))/1e6:.2f} "
          f"(on {where})")


if __name__ == "__main__":
    main()
