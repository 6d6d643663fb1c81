#!/usr/bin/env python
"""Dispatch-latency calibration sweep of the PyTorch port: measure the
(delegate combine x nn wire format x sweep_block) matrix and emit
``CALIB_device.json``.

The twin of ``scripts/profile_sweep.py`` on ``repro_torch``: each matrix
cell builds a serving engine with sweep telemetry
(``MSBFSConfig(telemetry=True)``) and a per-cell
:class:`repro_torch.obs.DispatchProfiler`, drains the same deterministic
query load through the overlapped pipeline, and records

* **exact** counters -- sweeps, wire bytes per strategy, sweep blocks, nn
  sparse/overflow, per-shard frontier/wire skew -- deterministic functions
  of the graph and the schedule, equal to the reference's cell for cell;
* **perf** numbers -- ``dispatch_latency_s`` summaries (p50/p95/p99 per
  dispatch site) and ``qps`` -- of the device the cells ran on.

The artifact is the shared ``repro-bench/1`` schema (section
``device_calibration``), written by :mod:`repro_torch.obs.artifact`, with
the torch / CUDA versions and the device in its ``meta``. The cells run on
the card (``--device cuda``, the default; raises without one) or, asked
for, on the CPU.

Usage::

    python scripts/torch_profile_sweep.py --scale 9 --out CALIB_device.json \
        [--trace-dir runs/profile] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)

from repro_torch.core import msbfs as M  # noqa: E402
from repro_torch.core.comm import CommConfig  # noqa: E402
from repro_torch.graphs.rmat import pick_sources, rmat_graph  # noqa: E402
from repro_torch.obs import DispatchProfiler, skew  # noqa: E402
from repro_torch.obs.artifact import write_bench  # noqa: E402
from repro_torch.serve import BFSServeEngine  # noqa: E402


def run_cell(pg, queries, *, comm: CommConfig, sweep_block: int,
             n_queries: int, max_iters: int, sample_rate: float,
             trace_dir: str | None, runner_cache: dict,
             device="cuda") -> dict:
    """One matrix cell: drain ``queries`` through an overlapped telemetry
    engine under ``comm`` / ``sweep_block``; returns the cell payload."""
    prof = DispatchProfiler(sample_rate=sample_rate, trace_dir=trace_dir)
    eng = BFSServeEngine(
        pg=pg, comm=comm,
        cfg=M.MSBFSConfig(n_queries=n_queries, max_iters=max_iters,
                          telemetry=True),
        cache_capacity=0, refill=True, overlap=True,
        sweep_block=sweep_block, profile=prof, runner_cache=runner_cache,
        device=device)
    eng.warmup()
    t0 = time.perf_counter()
    with prof.trace_session():
        eng.run_refill_queries(list(queries))
    dt = time.perf_counter() - t0
    s = eng.stats
    tel = eng.last_telemetry
    return {
        # exact schedule facts (bit-stable given graph + config)
        "sweeps": s.sweeps,
        "sweep_blocks": s.sweep_blocks,
        "wire_delegate_bytes": s.wire_delegate_bytes,
        "wire_nn_bytes": s.wire_nn_bytes,
        "nn_sparse_sweeps": s.nn_sparse_sweeps,
        "nn_overflow": s.nn_overflow,
        "frontier_skew": skew(tel.shard_frontier()),
        "wire_skew": skew(tel.shard_wire_bytes()),
        # perf (device-dependent)
        "time_s": dt,
        "qps": len(queries) / dt if dt > 0 else 0.0,
        "profile": prof.summary(),   # dispatch_latency_s.<site>.* inside
    }


def run_matrix(*, scale: int = 9, edge_factor: int = 8, n_queries: int = 8,
               requests: int = 24, th: int = 64, p_rank: int = 2,
               p_gpu: int = 2, max_iters: int = 128,
               delegates=("auto", "ring"), nn_formats=("dense", "adaptive"),
               sweep_blocks=(4, 8), sample_rate: float = 1.0,
               trace_dir: str | None = None, seed: int = 7,
               out: str | None = None, device="cuda") -> dict:
    """Run the calibration matrix on ``device``; returns (and, with
    ``out``, writes) the ``device_calibration`` section payload."""
    from repro_torch.core.partition import partition_graph

    g = rmat_graph(scale, edge_factor=edge_factor, seed=seed)
    pg = partition_graph(g, th=th, p_rank=p_rank, p_gpu=p_gpu)
    queries = [int(x) for x in pick_sources(g, requests, seed=seed + 1)]
    runner_cache: dict = {}
    cells: dict = {}
    for delegate in delegates:
        for nn in nn_formats:
            for blk in sweep_blocks:
                key = f"delegate={delegate},nn={nn},block={blk}"
                print(f"[torch_profile_sweep] {key} ...", flush=True)
                cells[key] = run_cell(
                    pg, queries, comm=CommConfig(delegate=delegate, nn=nn),
                    sweep_block=blk, n_queries=n_queries,
                    max_iters=max_iters, sample_rate=sample_rate,
                    trace_dir=trace_dir, runner_cache=runner_cache,
                    device=device)
    payload = {
        "graph": {"scale": scale, "edge_factor": edge_factor,
                  "n": int(g.n), "p": int(pg.p), "d": int(pg.d),
                  "th": th, "seed": seed},
        "requests": requests,
        "n_queries": n_queries,
        "sample_rate": sample_rate,
        "cells": cells,
    }
    if out is not None:
        write_bench(out, "device_calibration", payload, device=device)
        print(f"[torch_profile_sweep] wrote {out} ({len(cells)} cells)")
    return payload


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scale", type=int, default=9,
                    help="RMAT graph scale (2^scale vertices)")
    ap.add_argument("--edge-factor", type=int, default=8)
    ap.add_argument("--requests", type=int, default=24,
                    help="queries drained per matrix cell")
    ap.add_argument("--n-queries", type=int, default=8,
                    help="lane width W")
    ap.add_argument("--delegates", nargs="+", default=["auto", "ring"],
                    help="delegate combine strategies to sweep")
    ap.add_argument("--nn-formats", nargs="+", default=["dense", "adaptive"],
                    help="nn wire formats to sweep")
    ap.add_argument("--sweep-blocks", nargs="+", type=int, default=[4, 8],
                    help="sweep_block fusion factors to sweep")
    ap.add_argument("--sample-rate", type=float, default=1.0,
                    help="dispatch-latency sample rate (0 < r <= 1)")
    ap.add_argument("--trace-dir", default=None,
                    help="capture a torch.profiler trace per cell into this "
                         "directory (best-effort)")
    ap.add_argument("--out", default="CALIB_device.json",
                    help="calibration artifact path (repro-bench/1 schema)")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda",
                    help="where the engines run (cuda, or cpu for the plain "
                         "PyTorch path)")
    args = ap.parse_args(argv)
    run_matrix(scale=args.scale, edge_factor=args.edge_factor,
               requests=args.requests, n_queries=args.n_queries,
               delegates=tuple(args.delegates),
               nn_formats=tuple(args.nn_formats),
               sweep_blocks=tuple(args.sweep_blocks),
               sample_rate=args.sample_rate, trace_dir=args.trace_dir,
               seed=args.seed, out=args.out, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
