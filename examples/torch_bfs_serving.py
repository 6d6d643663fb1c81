"""BFS query serving demo on the PyTorch port: a skewed query stream
through the msBFS engine.

The twin of ``examples/bfs_serving.py`` on ``repro_torch`` (every flag,
plus ``--device``). Simulates serving traffic against one graph: a
Zipf-ish stream of source vertices (a few hot landmarks, a long tail) is
queued, batched 32-to-a-lane-word, traversed by shared msBFS sweeps (on a
card: one ``ell_pull_multi`` and one ``mask_reduce`` launch a sweep), and
memoized in the LRU cache. Prints throughput, batch utilization, and cache
hit rate, and spot-checks answers against the numpy oracle.

``--mixed`` serves a typed mixed-kind stream instead: the same skewed
sources cycled through all seven query kinds (full levels, reachability,
distance-limited, multi-target, weighted SSSP, components, k-hop sample)
via ``BFSServeEngine.submit_many``, with per-kind oracle spot-checks and
the per-kind ``ServeStats`` printed (kind tallies with early exits,
component reuse, and the comm layer's wire-volume counters --
delegate/nn bytes for both the bit plane and the int32 payload plane the
SSSP/components lanes ride, sparse-format sweeps, and the overflow
counter that must stay 0).

``--overlap`` (with ``--refill``) serves through the overlapped
host/device pipeline: sweeps run in fused blocks (on a card, CUDA graph
replays) with a speculative next block in flight while the host unpacks
retired lanes -- same traversal schedule (``sweeps`` and wire counters
equal the per-sweep driver's), fewer host round trips. ``--stream`` feeds
the same traffic incrementally through ``submit_stream``/``poll`` instead
of one big ``submit_many`` call, draining results as they retire.

``--delegate`` / ``--adaptive-nn`` swap the communication strategies
(``repro_torch.core.comm.CommConfig``) the sweeps run under.

``--trace`` attaches the observability plane (``repro_torch.obs``): the
run writes a Chrome/Perfetto trace (``--trace-out``, default
``serve_trace.json`` -- open at https://ui.perfetto.dev) and a metrics
snapshot (``--metrics-out``) with per-kind submit->deliver latency
percentiles, and prints the latency/hit-rate summary. Tracing never
changes the traversal schedule: the same sweeps, the same wire bytes.

``--profile`` turns on the device plane: sweep telemetry
(``MSBFSConfig(telemetry=True)`` -- per-shard frontier totals and skew,
harvested in one copy) plus sampled dispatch-latency bracketing
(``repro_torch.obs.DispatchProfiler``), printed at the end and written as
a ``CALIB_device.json``-style artifact (``--calib-out``, ``repro-bench/1``
schema, by ``repro_torch.obs.artifact``). ``--profile-trace-dir``
additionally captures a ``torch.profiler`` trace (best-effort).

    PYTHONPATH=src python examples/torch_bfs_serving.py [--scale 11] \
        [--requests 400] [--refill] [--overlap] [--stream] [--mixed] \
        [--delegate ring] [--adaptive-nn] [--trace] [--profile] \
        [--device cuda|cpu]
"""
import argparse
import time

import numpy as np


def serve_classic(eng, g, stream, args):
    from repro_torch.core.oracle import bfs_levels
    from repro_torch.serve import QueryBatcher

    batcher = QueryBatcher(width=eng.cfg.n_queries)
    tickets = {}
    for s in stream:
        tickets[batcher.submit(int(s))] = int(s)

    t0 = time.perf_counter()
    answers = {}
    for batch_tickets, batch_sources in batcher.drain():
        levels = eng.query(batch_sources)       # cache absorbs repeats
        for t, lev in zip(batch_tickets, levels):
            answers[t] = lev
    dt = time.perf_counter() - t0

    st = eng.stats
    print(f"served {len(answers)} requests in {dt:.2f}s "
          f"({len(answers) / dt:.0f} req/s)")
    print(f"msbfs batches={st.batches} lane_utilization="
          f"{st.lanes_used / max(st.lanes_used + st.lanes_padded, 1):.0%} "
          f"cache_hit_rate={st.cache_hits / max(st.queries, 1):.0%}")
    if args.refill:
        print(f"refill sweeps={st.sweeps} reseeds={st.refills} "
              f"busy_lane_sweeps={st.lane_utilization:.0%}")
    if args.overlap:
        print(f"overlap blocks={st.sweep_blocks} "
              f"fusion={st.sweeps / max(st.sweep_blocks, 1):.1f} sweeps/block")

    for t in list(answers)[:: max(len(answers) // 5, 1)]:
        ref = bfs_levels(g, tickets[t])
        assert np.array_equal(answers[t], ref), f"mismatch for source {tickets[t]}"
    print("spot-checked answers against the oracle: OK")
    return {"answers": answers}


def serve_stream(eng, g, stream, args):
    """Incremental feed/drain through the streaming API: submit in small
    chunks, poll for retired results between submissions."""
    from repro_torch.core.oracle import bfs_levels
    from repro_torch.serve import Query

    t0 = time.perf_counter()
    answers = {}
    chunk = max(1, eng.cfg.n_queries // 2)
    for i in range(0, len(stream), chunk):
        eng.submit_stream([Query(int(s)) for s in stream[i : i + chunk]])
        answers.update(eng.poll())          # drain whatever has retired
    answers.update(eng.drain_stream())
    dt = time.perf_counter() - t0

    st = eng.stats
    uniq = len({int(s) for s in stream})
    print(f"streamed {len(stream)} requests ({uniq} unique) in {dt:.2f}s "
          f"({len(stream) / dt:.0f} req/s)")
    print(f"results={len(answers)} sweeps={st.sweeps} blocks={st.sweep_blocks} "
          f"reseeds={st.refills} dedup_hits={st.dedup_hits} "
          f"cache_hits={st.cache_hits}")
    assert len(answers) == uniq
    for q in list(answers)[:: max(len(answers) // 5, 1)]:
        ref = bfs_levels(g, q.source)
        assert np.array_equal(answers[q], ref), f"mismatch for {q}"
    print("spot-checked streamed answers against the oracle: OK")
    return {"answers": answers}


def serve_mixed(eng, g, stream, args):
    from repro_torch.serve import Query, QueryKind, oracle_check

    tpool = tuple(int(s) for s in np.unique(stream)[:2])
    kinds = [lambda s: Query(s),
             lambda s: Query(s, QueryKind.REACHABILITY),
             lambda s: Query(s, QueryKind.DISTANCE_LIMITED, max_depth=3),
             lambda s: Query(s, QueryKind.MULTI_TARGET, targets=tpool),
             lambda s: Query(s, QueryKind.WEIGHTED_SSSP),
             lambda s: Query(s, QueryKind.COMPONENTS),
             lambda s: Query(s, QueryKind.KHOP_SAMPLE, max_depth=2)]
    queries = [kinds[i % len(kinds)](int(s)) for i, s in enumerate(stream)]

    t0 = time.perf_counter()
    answers = eng.submit_many(queries)
    dt = time.perf_counter() - t0

    st = eng.stats
    print(f"served {len(answers)} typed requests in {dt:.2f}s "
          f"({len(answers) / dt:.0f} req/s)")
    # per-kind ServeStats: every submitted kind with its traffic share and
    # how many of its lanes retired through a latched early exit
    for kind in sorted(st.kind_counts):
        print(f"  kind={kind:17s} queries={st.kind_counts[kind]:4d} "
              f"early_stops={st.early_stops_by_kind.get(kind, 0)}")
    print(f"early_stops={st.early_stops} "
          f"component_hits={st.component_hits} "
          f"reach_fast_batches={st.reach_fast_batches}")
    print(f"wire: delegate={st.wire_delegate_bytes}B "
          f"nn={st.wire_nn_bytes}B "
          f"payload_delegate={st.wire_pay_delegate_bytes}B "
          f"payload_nn={st.wire_pay_nn_bytes}B "
          f"total={st.wire_bytes_total}B "
          f"sparse_nn_sweeps={st.nn_sparse_sweeps} "
          f"nn_overflow={st.nn_overflow}")
    assert st.nn_overflow == 0, "nn exchange dropped slots (grow sparse_cap)"
    print(f"msbfs batches={st.batches} "
          f"cache_hit_rate={st.cache_hits / max(st.queries, 1):.0%}"
          + (f" refill sweeps={st.sweeps} reseeds={st.refills}"
             if args.refill else ""))

    for i in range(0, len(queries), max(len(queries) // 12, 1)):
        oracle_check(g, queries[i], answers[i])
    print("spot-checked per-kind answers against the oracle: OK")
    return {"queries": queries, "answers": answers}


def main(argv=None) -> dict:
    """Run the demo; returns the engine, the queries or sources served and
    their answers (for tests)."""
    from repro_torch.graphs.rmat import pick_sources, rmat_graph
    from repro_torch.serve import BFSServeEngine

    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=11)
    ap.add_argument("--th", type=int, default=64)
    ap.add_argument("--requests", type=int, default=400)
    ap.add_argument("--hot", type=int, default=16, help="hot landmark count")
    ap.add_argument("--refill", action="store_true",
                    help="serve through the mid-flight lane-refill pipeline")
    ap.add_argument("--overlap", action="store_true",
                    help="overlapped host/device pipeline (implies --refill)")
    ap.add_argument("--stream", action="store_true",
                    help="feed/drain incrementally via submit_stream/poll")
    ap.add_argument("--mixed", action="store_true",
                    help="serve a typed mixed-kind query stream")
    ap.add_argument("--delegate", default="auto",
                    choices=["auto", "allgather", "ring", "hier"],
                    help="delegate combine strategy (core.comm)")
    ap.add_argument("--adaptive-nn", action="store_true",
                    help="frontier-adaptive sparse/dense nn wire format")
    ap.add_argument("--compressed-nn", action="store_true",
                    help="compressed nn wire codec (varint rle/delta "
                         "streams; exact byte accounting)")
    ap.add_argument("--edge-chunk", type=int, default=0,
                    help="chunked out-of-core sweeps: stream edge blocks "
                         "of this size (0 = monolithic; bit-identical)")
    ap.add_argument("--trace", action="store_true",
                    help="attach the observability plane; export a "
                         "Chrome/Perfetto trace + metrics snapshot")
    ap.add_argument("--trace-out", default="serve_trace.json",
                    help="trace JSON path (open at ui.perfetto.dev)")
    ap.add_argument("--metrics-out", default="serve_metrics.json",
                    help="metrics snapshot JSON path")
    ap.add_argument("--profile", action="store_true",
                    help="device plane: sweep telemetry + sampled "
                         "dispatch-latency profiling; writes --calib-out")
    ap.add_argument("--calib-out", default="CALIB_device.json",
                    help="calibration artifact path for --profile")
    ap.add_argument("--profile-trace-dir", default=None,
                    help="also capture a torch.profiler trace into this "
                         "directory (best-effort)")
    ap.add_argument("--sample-rate", type=float, default=1.0,
                    help="dispatch-latency sample rate for --profile")
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs (cuda, or cpu for the plain "
                         "PyTorch path)")
    args = ap.parse_args(argv)

    from repro_torch.core import msbfs as M
    from repro_torch.core.comm import CommConfig
    from repro_torch.obs import DispatchProfiler, Observability, skew

    if args.overlap or args.stream:
        args.refill = True   # the pipelined drivers ride the refill path
    obs = Observability() if args.trace else None
    profiler = None
    if args.profile:
        profiler = DispatchProfiler(sample_rate=args.sample_rate,
                                    trace_dir=args.profile_trace_dir)
    g = rmat_graph(args.scale, seed=0)
    print(f"graph n={g.n:,} m={g.m:,}")
    eng = BFSServeEngine(g, th=args.th, p_rank=2, p_gpu=2, cache_capacity=512,
                         refill=args.refill, overlap=args.overlap,
                         cfg=M.MSBFSConfig(telemetry=args.profile),
                         comm=CommConfig(
                             delegate=args.delegate,
                             nn="compressed" if args.compressed_nn
                             else "adaptive" if args.adaptive_nn else "dense"),
                         obs=obs, profile=profiler,
                         edge_chunk=args.edge_chunk, device=args.device)
    t0 = time.perf_counter()
    # a mixed stream is never homogeneously-reachability, so only the
    # multi-target and payload-plane variants need the extra compiles
    eng.warmup(targets=args.mixed, payload=args.mixed)
    print(f"engine ready on {eng.device} (warm-up "
          f"{time.perf_counter() - t0:.1f}s, "
          f"W={eng.cfg.n_queries}, p={eng.pg.p}, delegates={eng.pg.d})")

    # skewed request stream: 80% of traffic on `hot` landmarks
    candidates = pick_sources(g, 4 * args.hot, seed=7)
    hot, cold = candidates[: args.hot], candidates[args.hot :]
    rng = np.random.default_rng(1)
    stream = np.where(rng.random(args.requests) < 0.8,
                      rng.choice(hot, args.requests),
                      rng.choice(cold, args.requests))

    ctx = profiler.trace_session() if profiler is not None else None
    if ctx is not None:
        ctx.__enter__()
    try:
        if args.mixed:
            served = serve_mixed(eng, g, stream, args)
        elif args.stream:
            served = serve_stream(eng, g, stream, args)
        else:
            served = serve_classic(eng, g, stream, args)
    finally:
        if ctx is not None:
            ctx.__exit__(None, None, None)

    if profiler is not None:
        summ = profiler.summary()
        print(f"profile: {summ['sampled']}/{summ['dispatches']} dispatches "
              f"sampled (rate={summ['sample_rate']:g})")
        for site, h in sorted(summ["dispatch_latency_s"].items()):
            print(f"  dispatch[{site}]: n={h['count']} "
                  f"p50={h['p50'] * 1e3:.2f}ms p99={h['p99'] * 1e3:.2f}ms")
        tel = eng.last_telemetry
        if tel is not None:
            print(f"telemetry: sweeps={tel.sweeps} "
                  f"shard_frontier={tel.shard_frontier().tolist()} "
                  f"frontier_skew={skew(tel.shard_frontier()):.3f} "
                  f"wire_skew={skew(tel.shard_wire_bytes()):.3f}")
        # the calibration artifact rides the shared repro-bench/1 schema
        from repro_torch.obs.artifact import write_bench

        st = eng.stats
        write_bench(args.calib_out, "device_calibration", {
            "graph": {"scale": args.scale, "th": args.th,
                      "n": int(g.n), "p": int(eng.pg.p),
                      "d": int(eng.pg.d), "seed": 0},
            "requests": args.requests,
            "n_queries": int(eng.cfg.n_queries),
            "sample_rate": args.sample_rate,
            "cells": {"serving": {
                "sweeps": st.sweeps,
                "sweep_blocks": st.sweep_blocks,
                "wire_delegate_bytes": st.wire_delegate_bytes,
                "wire_nn_bytes": st.wire_nn_bytes,
                "nn_sparse_sweeps": st.nn_sparse_sweeps,
                "nn_overflow": st.nn_overflow,
                "frontier_skew": (skew(tel.shard_frontier())
                                  if tel is not None else 0.0),
                "wire_skew": (skew(tel.shard_wire_bytes())
                              if tel is not None else 0.0),
                "profile": summ,
            }},
        }, device=eng.device)
        print(f"calibration artifact -> {args.calib_out}")
        if args.profile_trace_dir:
            print(f"torch.profiler trace -> {args.profile_trace_dir}")

    if obs is not None:
        obs.export(args.trace_out, args.metrics_out)
        snap = obs.metrics.snapshot()
        print(f"trace: {len(obs.trace.events())} events "
              f"({obs.trace.dropped} dropped) -> {args.trace_out} "
              f"(open at https://ui.perfetto.dev)")
        print(f"metrics: {len(snap['counters']) + len(snap['gauges']) + len(snap['histograms'])} "
              f"instruments -> {args.metrics_out}")
        for name, h in sorted(snap["histograms"].items()):
            if name.startswith("serve.latency_s."):
                kind = name.rsplit(".", 1)[1]
                print(f"  latency[{kind}]: n={h['count']} "
                      f"p50={h['p50'] * 1e3:.1f}ms p99={h['p99'] * 1e3:.1f}ms")
    return {"engine": eng, "stream": stream, **served}


if __name__ == "__main__":
    main()
