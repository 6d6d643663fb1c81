#!/usr/bin/env python3
"""Lane batches of the port at a large scale on one GPU, with and without
``edge_chunk``: peak device memory and ms a sweep.

    python3 chip_memory_scale.py [--scale 23] [--edge-chunk 262144] [--no-mono]

Builds a Graph500 RMAT graph of ``--scale`` (edge factor 16, doubled),
partitions it as ``chip_smoke.py`` does (TH = 64, two emulated partitions
on the card) and runs a bit lane batch of 32 LEVELS queries and a
WEIGHTED_SSSP lane batch of 32 through ``run_msbfs_emulated``: chunked
(``MSBFSConfig(edge_chunk=...)``) and, unless ``--no-mono``, monolithic.
The kernels are built before the first batch. For each run it prints the
sweeps, the ms a sweep (CUDA-synchronized host clock over the sweep loop)
and the peak of ``max_memory_allocated`` over the batch beside what was
resident before it. The chunked and monolithic
runs must leave every state leaf equal, and one LEVELS lane must equal
the numpy oracle. Prints the card's name and power limit. Exits non-zero
without a CUDA device. Imports nothing of JAX or of the reference
package.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TH, P_RANK, P_GPU, W = 64, 1, 2, 32


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def run_batch(eng, cfg, init: dict, what: str, device: str):
    """One lane batch to convergence: its state on the host and its row
    (sweeps, ms a sweep, peak and resident bytes)."""
    import torch
    from repro_torch.core import convert, msbfs as M

    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    kw = dict(init)
    sources = kw.pop("sources")
    if cfg.payload:
        kw["gids"] = eng._pay_gids()
    st = M.init_multi_state(eng.pg, sources, cfg, device=device, **kw)
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = M.run_msbfs_emulated(eng.pgv, eng.plan, st, cfg)
    if cuda:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    sweeps = int(st.it[0])
    row = dict(sweeps=sweeps, ms_per_sweep=dt * 1e3 / sweeps,
               peak=torch.cuda.max_memory_allocated() if cuda else 0,
               base=base if cuda else 0)
    print(f"{what} edge_chunk={cfg.edge_chunk}: sweeps={sweeps} ms/sweep="
          f"{row['ms_per_sweep']:.2f} max_memory_allocated={row['peak']} B "
          f"(resident before the batch {row['base']} B, batch "
          f"{row['peak'] - row['base']} B)", flush=True)
    return convert.state_to_numpy(st), row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=23)
    ap.add_argument("--edge-chunk", type=int, default=1 << 18)
    ap.add_argument("--no-mono", action="store_true",
                    help="skip the monolithic runs (they may not fit)")
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import numpy as np
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("chip_memory_scale: torch.cuda.is_available() is False; this "
              "script runs only on a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import msbfs as M, oracle as O
    from repro_torch.graphs.rmat import pick_sources, rmat_graph
    from repro_torch.serve import BFSServeEngine

    if args.device == "cuda":
        from repro_torch.kernels import _build

        print(card_line())
        print(f"torch {torch.__version__} cuda {torch.version.cuda}")
        t0 = time.perf_counter()
        _build.build()              # not inside the first timed batch
        print(f"build: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    g = rmat_graph(args.scale, seed=0)
    t_gen = time.perf_counter() - t0
    eng = BFSServeEngine(g, th=TH, p_rank=P_RANK, p_gpu=P_GPU,
                         device=args.device)
    pg = eng.pg
    print(f"setup: rmat_graph({args.scale}) {t_gen:.1f} s, partition+plan+"
          f"upload {time.perf_counter() - t0 - t_gen:.1f} s; n={pg.n} "
          f"m={g.m} d={pg.d} E_max nn/nd/dn/dd={pg.nn.e_max}/{pg.nd.e_max}/"
          f"{pg.dn.e_max}/{pg.dd.e_max}", flush=True)
    M.payload_view(eng.pgv, eng.plan)      # resident in every run
    eng._pay_gids()
    srcs = [int(s) for s in pick_sources(g, W, seed=21)]
    batches = (
        ("bit", M.MSBFSConfig(n_queries=W, enable_targets=False),
         dict(sources=srcs)),
        ("sssp", M.MSBFSConfig(n_queries=W, payload=True,
                               enable_targets=False, max_iters=64 * 6),
         dict(sources=srcs, payload_modes=["sssp"] * W)))
    ok = True
    for name, cfg, init in batches:
        ecs = (args.edge_chunk,) if args.no_mono else (args.edge_chunk, 0)
        states = {}
        for ec in ecs:
            states[ec], _ = run_batch(
                eng, dataclasses.replace(cfg, edge_chunk=ec), init, name,
                args.device)
        if len(states) == 2:
            a, b = states.values()
            diff = [k for k in M.STATE_LEAVES if not np.array_equal(a[k],
                                                                    b[k])]
            print(f"{name}: leaves differing between the runs: {diff}")
            ok &= not diff
        if name == "bit":
            st = states[args.edge_chunk]
            level = st["level_n"][:, :, 0]
            lv = np.full(pg.n, 2**30, dtype=np.int32)
            vids = np.arange(pg.n, dtype=np.int64)
            from repro_torch.core.types import PartitionLayout
            lay = PartitionLayout(pg.n, pg.p_rank, pg.p_gpu)
            lv[:] = level[lay.part_of(vids), lay.local_of(vids)]
            dv = np.asarray(pg.delegate_vids).reshape(-1)[: pg.d]
            lv[dv] = st["level_d"][0, : pg.d, 0]
            same = np.array_equal(lv, O.bfs_levels(g, srcs[0]))
            print(f"bit: lane 0 equals the numpy oracle: {same}")
            ok &= same
        del states
    if args.device == "cuda":
        print(card_line())
    print(f"chip_memory_scale: {'ok' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
