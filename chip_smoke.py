#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (``nvidia-smi``) and builds the
   port's CUDA kernels from the sources in this checkout.
2. Partitions a scale-20 Graph500 RMAT graph (1,048,576 vertices, 33.5 M
   directed edges after doubling) into ``BFSServeEngine(th=64, p_rank=1,
   p_gpu=2)`` -- two emulated partitions on one card. Both paths below run
   on this one partition.
3. msBFS kernel phases, at the serving path's shapes: the three pulls of
   one sweep (dd, nd over the dn subgraph, dn over the nd subgraph) on a
   real mid-BFS frontier, in one launch of the sweep entry, and the
   delegate OR fold over the p=2 partitions' candidate words. Each kernel
   must equal its plain PyTorch version exactly (found words and work;
   both ``mask_reduce`` variants) and a second pull launch the first; the
   sweep launch's time (CUDA events), each pull's time alone (events and
   the profiler's device time), the plain version's time, the bytes bound
   and each subgraph's row schedule (rows and slots per length class,
   longest row) are printed. Then the fused delegate update of the step
   (``mask_reduce_apply``: fold, new level or visited plane, lane flags)
   on the same words, on int32 levels with a target plane and on a bool
   visited plane: equal to its plain version and to the chain of torch
   operators it replaced, timed beside that chain (events and the
   profiler's device time), and one call through ``comm`` profiled: one
   launch, none of the chain's operators.
4. Serving path: ``warmup()``, then ``submit_many`` of 64 queries mixing the
   four bit kinds (at least two lane batches). Launch counts are zeroed
   just before and read just after; both kernels must have launched, two
   answers per kind must equal the numpy oracle, and no nn slot may be
   dropped. Then one lane batch of it split into timed phases (three
   times): (a) ``init_multi_state``, (b) the sweep loop, (c) the lane
   gather (and the bare copy of its bytes, and a host assembly of the
   same rows -- pageable copy, then numpy indexing -- in two parts), (d)
   ``unpack_result``. Then one more lane batch under ``torch.profiler``.
   Every profile phase names the port kernels it must find in the trace;
   a trace that misses one, or holds no device time, is taken once more,
   and a second miss fails the run.
5. Single-source kernel phases: the three bit pulls of one sweep on a real
   mid-BFS frontier (2 sweeps from the highest-degree vertex) and the
   delegate min fold of the p=2 partitions' level candidates (both
   variants), each against its plain version, exactly, timed as in 3; the
   fused min fold into the state's delegate levels
   (``payload_min_fold_apply``) against its plain version and the chain
   it replaced, as in 3; the ELL contract of the pull against its oracle
   on 4 random shapes.
6. Single-source path, Graph500 style: one warm-up BFS, then 16 search
   keys through ``run_bfs_emulated`` with the ``bfs-rmat`` FULL config
   (DO, pull_chunk=64, binned nn exchange, int32 min combine); each answer
   must equal the numpy oracle; per-BFS time, sweeps, TEPS and their
   harmonic mean are printed. Then 4 of the keys under OPT2
   (``delegate_u8``, static exchange) and 4 under ``delegate="allgather"``:
   answers equal the FULL run's. Each run zeroes the launch counts before
   and reads them after: one pull launch (three pulls) per sweep, one min
   fold per sweep in the allgather run only. One FULL and one allgather
   BFS under ``torch.profiler``.
7. Comm strategies and the sharded drivers. (a) The 64-query serving run
   again on the same partition under ring / dense, hier / adaptive,
   allgather / adaptive and pinned sparse (a cap of every slot), beside
   the default allgather / dense, each on a fresh engine, timed twice in
   turns: answers equal the main run's, ``wire_delegate_bytes`` the plan
   formula times sweeps times p, no slot dropped, one B1 and one B2
   launch a sweep (B2 at K = 1 under the ring). (b) 4 FULL search keys
   with the static exchange under adaptive and pinned sparse bits:
   levels equal the FULL run's, delegate bytes the formula. (c) The
   sharded drivers in this process on a world of one rank under NCCL (a
   p = 1 partition of a scale-16 graph; scale cut from 20 for time):
   ``make_sharded_msbfs`` (timed in turns with the emulated run after a
   first call that sets up the communicators), two steps, a block of 4
   captured as CUDA graphs and the same block eagerly, a payload lane
   batch (16 SSSP, 8 components, 8 bit lanes) through the sharded run
   and a captured sharded block of 4, and
   ``make_sharded_bfs`` with and without the plan, every leaf equal to
   the emulated run. (d) The engine on a world of two spawned ranks
   sharing the card under gloo (NCCL refuses two ranks on one device;
   gloo carries every collective of the step on CUDA tensors): each rank
   loads its own partition's rows and plan rows from a file written
   here, serves the 64 queries under the two-level combine over its
   ``("rank", "gpu")`` = (1, 2) mesh (B2a then B2 a sweep) and runs 4
   FULL keys; answers (by digest), every stats field, levels and
   counters equal the emulated p = 2 runs.
8. Recsys path (xDeepFM ``FULL``: 39 fields, D=10, CIN 200-200-200, MLP
   400-400, 2^18 hot and 2^25 cold rows, seeded random weights), with
   TF32 off for matmuls and cuDNN (printed). ``ClickStream(39, 2^25,
   hot_fraction=0.005, seed=0)`` makes the data; its row counts must fit
   the tables. The ``cin_fused`` kernel phase prints the kernel's
   registers and spills (``-Xptxas -v``) and counts the tensor-core MMA
   instructions in its SASS (``cuobjdump``; there must be some), then
   holds each CIN layer of a real ``serve_p99`` batch (B=512) against its
   plain version, checks that a second launch gives bit-equal output, and
   times it beside its two bounds (3xTF32 on the TF32 tensor cores, the
   reported one, and float32 on the CUDA cores), the plain version and
   cuBLAS on the materialised outer product. Serving: ``serve_p99`` (20 batches of 512
   after a warm-up; median and p99 ms per batch, host indices to host
   logits) and ``serve_bulk`` (3 batches of 262,144; samples/s, peak
   memory); launch counts zeroed before and read after each run: 3
   ``cin_fused`` per forward and nothing else. Logits of one p99 batch and
   of a 2,048-sample slice of one bulk batch are held against the same
   forward on the plain CIN. Retrieval: one query against 1,000,000
   seeded candidates of width 64, top 100, against a plain sort of the
   full score row. Then ``segment_bag`` and ``ell_pull_payload`` (no path
   of the reference runs them) against their plain versions at the
   reference tests' shapes and at large shapes: ``segment_bag`` at the
   bulk shape (262,144 x 39 bags of 8 ClickStream ids of one serve_bulk
   batch, a quarter -1) over ``emb_hot`` in float32 and bfloat16 and over
   ``emb_cold``, beside ``F.embedding_bag``; ``ell_pull_payload`` on the
   scale-20 ELL with 70% of the lanes and with 10% of the rows active.
   Each large call is timed flushed (a 512 MB buffer written before each
   call), back to back and by the profiler's device time, beside its
   bound (``segment_bag`` in turns with ``F.embedding_bag``); one call of
   each is profiled: one launch a call and nothing else on the device
   (so no cast of bfloat16 weights). Then one ``serve_p99`` forward
   under ``torch.profiler``.
9. Launch cost: for each of the seven wrappers at its path's shapes (the
   pulls both for one subgraph and as the sweep entry), and
   for ``torch.amin`` on the min fold's inputs, the host microseconds per
   call (host clock over the first 20 and over all 300 calls, then one
   synchronize); for the folds also the profiler's device microseconds
   per call. Pairs of a design and the one it replaced are measured as
   the median of 9 interleaved rounds of 20 calls: each pull kernel's
   sweep entry and three single calls of the same pulls with no row
   active (where the device never holds the host back), and each fused
   delegate update and the chain it replaced (also with their device
   time). The folds, ``torch.amin`` and the pairs (the delegate updates
   on seeded planes of the paths' shapes) are also measured right after
   set-up, before any profiler session (which raises the wrappers' host
   cost for the rest of the process).
10. Payload path (WEIGHTED_SSSP, COMPONENTS, KHOP_SAMPLE) on the same
   graph and partition at W = 32: (a) three lane batches of 32 queries
   (SSSP, COMPONENTS without component reuse, KHOP_SAMPLE with k = 3),
   each one ``submit_many`` after ``warmup(payload=True)``: sweeps, ms a
   sweep, queries/s, payload wire bytes, peak memory; (c) the SSSP batch
   again under ``CommConfig(delegate="allgather")``, launch counts zeroed
   before and read after: one ``payload_min_fold`` (B4, the payload
   delegate update at ``n = d * W``), one B1 and one B2 launch a sweep,
   answers equal to (a)'s; (d) the parts of one payload sweep on a
   mid-run state timed alone (min-plus pushes, bit pushes, the payload nn
   exchange, B4 against its plain version with its device time and bound,
   the whole sweep) and one SSSP batch under ``torch.profiler`` (B1, B2,
   B4 in the trace, busy share, the operators' device time); (b) 64
   queries of the seven kinds through the per-sweep refill driver and the
   overlapped one (``sweep_block=8``, blocks captured by the warm-up):
   answers equal, every ServeStats field but ``sweep_blocks`` equal. Four
   answers of each kind are held against the oracles: scipy's
   ``dijkstra`` over the port's edge weights and ``connected_components``
   (each component's minimum id) for the payload kinds, the numpy oracle
   for the others. (e) runs in 7(c): a payload lane batch through
   ``make_sharded_msbfs`` and a captured sharded block under NCCL, equal
   to the emulated run.
11. Memory and telemetry modes, on the same graph and partition at W =
   32: (a) a bit lane batch of the serving run's first 32 queries and a
   WEIGHTED_SSSP lane batch of 32 (10's sources), each monolithic and
   with ``edge_chunk=EDGE_CHUNK`` (printed): peak memory
   (``max_memory_allocated`` after ``reset_peak_memory_stats``), ms a
   sweep and sweeps of each; every state leaf equal between the two, two
   answers of each against the oracle (scipy's ``dijkstra`` for SSSP),
   the chunked SSSP peak at least ``MIN_SSSP_SAVING`` below the
   monolithic one; then 10's seven-kind stream through the overlapped
   driver (blocks captured) both ways: every ServeStats field and answer
   equal, peaks printed. (b) The bit batch with ``telemetry=True``: every
   other leaf equal to (a)'s; ``tm_frontier_*`` equal to each sweep's
   frontier counts and ``tm_backward`` to each sweep's packed directions,
   read on the host from a sweep-by-sweep run; a captured block of
   ``TELEMETRY_BLOCK`` sweeps with telemetry equal to the eager sweeps.
   (c) The 64-query serving run under ``nn="compressed"``: answers equal
   the dense run's; one mid-BFS sweep's ``wire_nn`` (and stream choice)
   per partition equal to the host encoders (``rle_encode``,
   ``delta_encode_ids``) over that sweep's sent slot maps. (d)
   ``compress_partition`` of the partition (host seconds, bytes per edge
   raw and compressed); partition 0's nd rows decoded into an ELL tile
   (``decode_ell_tile``) feed B1 (``ops.ell_pull_multi``, one counted
   launch) on a mid-BFS frontier, equal to its plain version.
12. Observability plane (``repro_torch.obs``), on the same partition: (a)
   right after 7(b), the 64-query serving run of 4 on three fresh engines
   -- obs off, obs on, ``profile=`` a ``DispatchProfiler`` -- with every
   ServeStats field (equal to 4's), answer, ``ops.LAUNCHES`` and
   ``ops.REPLAYED`` count equal across the three; queries/s of each and
   the profiler's p50 / p99 dispatch latencies printed; on the obs
   engine, cache and component hits and a per-sweep refill drain with
   duplicates; one ``trace_session()`` of the profiled engine must write
   its file (kernel records in it); a lane batch with ``telemetry=True``
   fills ``last_telemetry``, its ``device.shard.<i>.wire_bytes`` summing
   to the state's ``wire_delegate + wire_nn``. (b) In 14, the 120-query
   overlap run once more with the same plane on: counters, answers,
   launches and replays equal the obs-off run, queries/s of both printed;
   then a two-query stream; the plane's exported trace must parse as
   Chrome JSON and hold every name of ``OBS_EVENTS``.
13. Multi-tenant frontend (``ServeFrontend``): the main partition and a
   relabelled copy (``v -> (v + p) % n``, partitioned here: about 46 s of
   host time), W = 32, engines sharing one graph memory pool
   (``memory_reserved`` printed after each engine's captures); four
   tenants (a latency- and a throughput-class one on each graph), 16
   queries each (5 / 5 / 5 / 1 of the bit kinds) in chunks of 4, round
   robin, ``poll()`` between chunks: both graphs' sessions in flight at
   once, one B1 and one B2 launch or replay per executed sweep; every
   answer and TenantStats field (but ``peak_in_flight``) equal to a
   back-to-back run on the same engines, two answers a kind against the
   oracle; mux and sequential queries/s, per-tenant p99 (obs clock),
   sweeps and blocks per engine printed. Then a burst over a tenant's
   ``max_inflight`` is rejected whole, ``warm(budget=8)`` runs and a
   replay of the warmed sources is served from the LRU.
14. Refill path, last (its long profiled runs come after every short
   profiler session above): the graph with 8 tails of 96 (``with_tails``,
   seed 5; ``max_iters=240``, W=32, no cache, no component reuse), 120
   queries (the 8 tips spread through 112 core sources, the four kinds
   cycled) served four ways after a warm-up that captures the blocks'
   CUDA graphs -- batch, ``refill=True`` (per-sweep driver),
   ``overlap=True, sweep_block=8``, and the stream API (4
   ``submit_stream`` chunks with ``poll()`` between, then
   ``drain_stream()``). Each run zeroes the stats and launch counts
   before and reads them after: one pull and one fold launch per executed
   sweep, graph replays counted (``ops.REPLAYED``). Every tip and two
   answers of each kind must equal the oracle, the four drivers must
   agree, sync and overlap counters must be equal but ``sweep_blocks``.
   Queries/s, sweeps, refills, lane utilisation, fusion, gated sweeps
   (and their device ms) are printed; then 12(b); then the sync and
   overlap runs again under ``torch.profiler``, on the first 40 of the
   queries, for the device busy share and the host time per sweep (the
   batch and stream reruns were cut for the run's time, and the reruns'
   queries from 120 to 40 when phases 16-18 came: the profiled sync run of
   120 took about 110 s); one block of 8 sweeps from one state by graph
   replay and eagerly (equal leaves, both timed); and the overlap run with two
   sweeps in flight instead of one (counters equal, gated sweeps
   printed).
15. Distributed GNN training on the degree-separated engine (run before
   14, which stays last; TF32 off, printed): (a) ``gcn-cora`` at
   ``GNN_SHAPES["ogb_products"]`` widths (d_in 100, 16 hidden, 7 classes,
   sym norm) on the scale-20 partition above (seeded bag-of-words
   features, labels, train mask; the cut from ogb_products' 2,449,029
   nodes is printed as ``reduced``): distributed logits and the first
   step's gradients equal the local ``gcn_forward`` / ``gcn_loss`` over the
   whole graph within rtol 5e-3, atol 5e-4 (the reference's
   dist-against-local bound); 5 AdamW steps, the loss falls; ms per step
   (CUDA events after a warm-up step), peak memory, ``payload_round_bytes``
   of a round, one step under ``torch.profiler``. (b) MeshGraphNet at
   full width (15 layers, 128 hidden) on ``mesh_batch(512, 512, 12, 4)``
   at p = 2: forward equal to the local ``mgn_forward`` at the
   materialized parameters, at every parameter plus 0.1 N(0, 1) (non-zero
   biases: the padding edges, which the port masks, would carry
   ``enc_edge(0)``, ROADMAP C2) and after 3 AdamW steps. (c) GraphCast at
   full width (16 layers, 512 hidden, 227 vars) on ``mesh_batch(128, 128,
   227, 4, multimesh_levels=4)``, th = 13 (the hubs of levels 2-4 are
   delegates; d printed): the same three forward checks around 1 step. (d) ``examples/torch_gnn_training.py`` twice in a
   subprocess on one ``--ckpt``: ``--steps 30``, then ``--steps 60``
   resumes at step 30 and ends lower. (e) A world-1 NCCL run (spawned) of
   the sharded GCN training step on ``cora_like(2708, d_feat=1433)``:
   parameters after 3 AdamW steps equal the emulated run's within rtol
   1e-4, atol 1e-5.
16. The entry points (run after 15, before 14), each in a subprocess
   with its exit code checked and its output parsed:
   ``examples/torch_quickstart.py`` at scale 16 (every source
   ``match=OK``, the memory ratios); ``examples/torch_bfs_serving.py
   --mixed --refill --overlap --trace --profile`` at scale 16, 120
   requests (answers held against the oracle, the trace and metrics files
   written, the calibration artifact parses and was taken on the card, no
   nn slot dropped); ``examples/torch_distributed_bfs.py`` at scale 16,
   ``--mesh 1,1 --backend nccl`` and ``--mesh 1,2 --backend gloo`` (two
   ranks sharing the card), every answer the oracle's;
   ``scripts/torch_profile_sweep.py`` at scale 16 over delegate {auto,
   ring} x nn {dense} x block {4, 8}, whose exact counters must equal the
   same matrix run in this process on the CPU.
17. The CIN backward kernels (``cin_fused_bwd_w``, ``cin_fused_bwd_x``)
   against ``cin_fused_bwd_plain`` at FULL widths, layer 0 (Fk = 39) and
   layer 1 (Fk = 200), B = 512 and 1,000: per element within 1e-5
   max|plain| + 1e-4 |plain|, two launches bit-equal; then each of a train
   step's three layers at B = 65,536 timed flushed and back to back,
   beside the plain version, the bound (dW: 3xTF32 on the tensor cores,
   three TF32 products a float32 one at 495 TFLOP/s; dx: SIMT float32 at
   67 TFLOP/s, with the 3xTF32 yardstick printed beside it) and, for dW,
   cuBLAS ``dOut_flat @ Z`` on Z materialised beforehand.
18. xDeepFM FULL training at ``train_batch`` (B = 65,536), AdamW, TF32
   off: one step's gradients at B = 4,096 through the kernels against the
   same step through ``cin_fused_plain`` under autograd (each reached leaf
   within 1e-3 of its max |gradient|, non-zero); 2 warm-up and 8 timed
   steps on one ClickStream batch (ms a step, peak memory, the loss
   falls, 3 launches of ``cin_fused`` and of each backward kernel a step
   and no other kernel); two steps under ``torch.profiler`` (busy share).
19. Prints one JSON line describing every kernel, then, last, the device
    line ``{"ok": true, "device": {...}}``.

Option: ``--only segment_bag,ell_pull_payload,sharded,payload,memory,obs,
frontend,gnn,examples,cin_bwd,recsys_train`` (those phases alone, on the
same inputs; ``sharded`` is 7 after the main serving run and 4 FULL keys
it is held against, ``payload`` is 10 and 7(c), ``memory`` is 11 after
the 64-query serving run it holds (c) against, ``obs`` is 12 after that
serving run, (b) on the refill path's engine after its obs-off overlap
run, ``frontend`` is 13, ``gnn`` is 15 on a fresh scale-20 partition,
``examples``, ``cin_bwd`` and ``recsys_train`` are 16-18; with both of
the last two, the kernels line of the two backward kernels).

Any failure raises, so the script exits non-zero; it also exits non-zero,
printing no result, without a CUDA device or without ``src/repro_torch``
beside it. Imports nothing of JAX or of the reference package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
SCALAR_OPS_PER_S = 67e12       # H100 non-tensor 32-bit peak (data sheet)
TF32_OPS_PER_S = 495e12        # H100 dense TF32 tensor-core peak (data sheet)
TF32_PASSES = 3                # cin_fused: 3xTF32, three products per product
SCALE, TH, P_RANK, P_GPU = 20, 64, 1, 2
DEVICE = "cuda"
N_QUERIES = 64
N_KEYS, N_VARIANT_KEYS = 16, 4      # Graph500 search keys; keys per variant
# refill path: the tailed graph and stream of benchmarks/msbfs_throughput.py's
# overlap cell, on the scale-20 graph
N_TAILS, TAIL_LEN, REFILL_QUERIES, REFILL_MAX_ITERS = 8, 96, 120, 240
SWEEP_BLOCK, STREAM_CHUNKS = 8, 4
# the refill runs taken again under torch.profiler (batch and stream were
# cut, for the run's time, when the obs and frontend phases came), on the
# first PROFILED_REFILL_QUERIES of the queries (all 120 before phases 16-18
# came: the profiler's sync trace of 120 took about 110 s to take and read)
PROFILED_REFILL_MODES = ("sync", "overlap")
PROFILED_REFILL_QUERIES = 40
# recsys path: RECSYS_SHAPES of the xdeepfm config (serve_p99, serve_bulk,
# retrieval_cand); the ClickStream's total vocabulary is the cold table size
P99_BATCH, N_P99_BATCHES = 512, 20
BULK_BATCH, N_BULK_BATCHES, BULK_SLICE = 262144, 3, 2048
N_CANDIDATES, TOP_K = 1_000_000, 100
HOT_FRACTION = 0.005
BAG_WIDTH = 8                       # segment_bag bags: 8 slots each,
BULK_PAD = 0.25                     # a quarter of them -1
PAYLOAD_ROWS_ON = 0.1               # ell_pull_payload's sparse case
# payload path: three lane batches of W = 32 (WEIGHTED_SSSP, COMPONENTS,
# KHOP_SAMPLE with k = 3) and a seven-kind mixed stream of 64 queries
PAYLOAD_BATCH, PAYLOAD_MIXED, KHOP_K = 32, 64, 3
# memory phase: edge slots of every partition per push block (the
# chunked runs' edge_chunk), the SSSP answers held against scipy, and the
# least saving of the chunked SSSP batch's peak over the monolithic one
EDGE_CHUNK, MEMORY_SSSP_ORACLES, MIN_SSSP_SAVING = 1 << 18, 2, 3e9
TELEMETRY_BLOCK = 4
# flushed kernel times: a scratch buffer written before each call, so L2
# (50 MB) holds nothing of the last call
FLUSH_BYTES, FLUSH_REPS = 512 << 20, 20
_FLUSH: dict = {}
# Tolerances of the float kernels against their plain versions (float32
# sums in another order; see PERF.md): CIN |kernel - plain| <= CIN_TOL *
# max|plain| per layer; logits |kernel - plain| <= LOGIT_ATOL + LOGIT_RTOL *
# |plain|; segment_bag float32 1e-6 + 1e-5 |plain|, bfloat16 2**-7 |plain|
CIN_TOL = 1e-4
LOGIT_RTOL, LOGIT_ATOL = 1e-4, 1e-5
LAUNCH_REPS, LAUNCH_FIRST, LAUNCH_ROUNDS, FOLD_PROFILE_REPS = 300, 20, 9, 50
#: one call of each wrapper (and of torch.amin) at its path's shapes, filled
#: by the kernel phases for the launch-cost phase: {name: fn}
LAUNCH_CASES: dict = {}
#: the folds, whose device time is printed beside their host cost
FOLD_CASES = ("mask_reduce", "payload_min_fold", "torch.amin",
              "mask_reduce_apply", "mask_reduce chain",
              "payload_min_fold_apply", "payload_min_fold chain")
#: launch-cost cases measured as interleaved pairs (new design, old design)
PAIRS = (("ell_pull_multi [sweep, idle]", "ell_pull_multi [3 calls, idle]"),
         ("ell_pull [sweep, idle]", "ell_pull [3 calls, idle]"),
         ("mask_reduce_apply", "mask_reduce chain"),
         ("payload_min_fold_apply", "payload_min_fold chain"))


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def time_ms(fn, reps: int, rounds: int = 3) -> float:
    """Milliseconds per call of ``fn()``: CUDA events around ``reps``
    back-to-back calls, divided by ``reps``; the median of ``rounds`` such
    runs, after one warm-up call. A call shorter than its host-side launch
    cost times at that cost (the profiler's per-launch device time is
    printed separately)."""
    import torch

    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(stop) / reps)
    per_call.sort()
    return per_call[len(per_call) // 2]


def per_call_us(prof, reps: int, name: str | None = None) -> float:
    """Device microseconds per call in a profile of ``reps`` calls: for
    each kernel, copy or memset (whose name holds ``name``, where given),
    its mean time times its launches per call. Launches per call are
    rounded, so records the profiler drops (a session can lose some, or
    all those of a short one) do not lower the figure; a kind with no
    record at all is missing from it."""
    total = 0.0
    for ev in prof.key_averages():
        if (ev.key.startswith("aten::") or ev.key == "Activity Buffer Request"
                or (name is not None and name not in ev.key)):
            continue
        us = getattr(ev, "self_device_time_total", None)
        us = ev.self_cuda_time_total if us is None else us
        if us > 0 and ev.count:
            total += us / ev.count * max(1, round(ev.count / reps))
    return total


def device_us(fn, name: str | None = None, reps: int = 30) -> float:
    """The profiler's device microseconds per call of ``fn()`` in kernels
    whose name holds ``name`` (every kernel, copy and memset where None),
    after one warm-up call; a session with no such record is taken once
    more, and a second one fails the run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = per_call_us(prof, reps, name)
        if us > 0:
            return us
    check(False, f"device time of {name or 'a call'} in the trace")


#: operators of the delegate chains the fused apply kernels replaced
CHAIN_OPS = ("aten::where", "aten::minimum", "aten::full", "aten::any",
             "aten::__rshift__", "aten::bitwise_right_shift",
             "aten::bitwise_and", "aten::__and__", "aten::gt", "aten::lt",
             "aten::zeros", "aten::bitwise_or", "aten::__or__",
             "aten::bitwise_not")


def span_check(fn, kernel: str, what: str, calls: int = 20) -> None:
    """``calls`` calls of ``fn`` (a step's delegate update through comm,
    one ``ops`` wrapper call each) under ``torch.profiler``: each counts
    one launch, the device runs ``kernel`` and its memset and nothing
    else, and the host runs none of the replaced chain's operators. (A
    session of one short call may get no device records at all.)"""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops

    fn()
    torch.cuda.synchronize()
    for attempt in (1, 2):
        before = sum(ops.LAUNCHES.values())
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        counted = sum(ops.LAUNCHES.values()) - before
        evs = prof.key_averages()
        ops_seen = sorted({ev.key for ev in evs if ev.key.startswith("aten::")})
        dev = {ev.key: ev.count for ev in evs if not ev.key.startswith("aten::")
               and getattr(ev, "self_device_time_total", 0) > 0}
        launches = sum(n for k, n in dev.items() if kernel in k)
        if launches:
            break
        print(f"  span {what}: attempt {attempt}: {kernel} not in the trace")
    others = [k for k in dev if kernel not in k and "Memset" not in k]
    print(f"span {what}: {calls} calls, {counted} launches counted, "
          f"operators {ops_seen}; device: "
          f"{ {k[:60]: n for k, n in dev.items()} }")
    check(counted == calls, f"span {what}: one launch a call")
    check(0 < launches <= calls, f"span {what}: {kernel} in the trace")
    check(not others, f"span {what}: nothing else on the device ({others})")
    check(not set(ops_seen) & set(CHAIN_OPS),
          f"span {what}: no chain operator ({set(ops_seen) & set(CHAIN_OPS)})")


def bound(nbytes: float, nops: float,
          ops_per_s: float = SCALAR_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def mid_bfs_inputs(eng, g, sweeps: int = 2):
    """A real frontier: 32 sources swept ``sweeps`` times on the engine's
    graph; returns the state and its frontier / unvisited lane masks."""
    import torch
    from repro_torch.core import msbfs as M
    from repro_torch.core.types import INF_LEVEL
    from repro_torch.graphs.rmat import pick_sources

    cfg = eng.cfg
    srcs = pick_sources(g, cfg.n_queries, seed=1)
    st = M.init_multi_state(eng.pg, [int(s) for s in srcs], cfg,
                            device=eng.device)
    for _ in range(sweeps):
        st = M.msbfs_step(eng.pgv, eng.plan, st, cfg)
    nv = eng.pgv.normal_valid[:, :, None]
    it = st.it[:, None, None]
    masks = dict(
        frontier_n=(st.level_n == it) & nv, frontier_d=st.level_d == it,
        unvis_n=(st.level_n == int(INF_LEVEL)) & nv,
        unvis_d=st.level_d == int(INF_LEVEL))
    torch.cuda.synchronize()
    return st, masks


def schedule_line(csr) -> str:
    """Class row counts, the slots in each class and the longest row of a
    device CSR's pull schedule."""
    from repro_torch.kernels import pull_schedule as PS

    deg = (csr.offsets[:, 1:] - csr.offsets[:, :-1]).reshape(-1).long()
    order = csr.sched.order.long()
    parts, at = [], 0
    for c, name in ((PS.LONG, "long"), (PS.MEDIUM, "medium"),
                    (PS.SHORT, "short"), (PS.EMPTY, "empty")):
        n = csr.sched.counts[c]
        slots = int(deg[order[at:at + n]].sum())
        parts.append(f"{name}={n} rows/{slots} slots")
        at += n
    return f"schedule {' '.join(parts)} longest={int(deg.max())}"


def pull_sweep_phase(kernel: str, pulls, chunk: int, cuda_sweep, cuda_one,
                     plain, nbytes_fn, sweep_case: str):
    """The three pulls of one sweep: one launch of the sweep entry held
    against the plain version of each pull, exactly (found and work), a
    second launch bit-equal to the first; then the sweep launch timed, and
    each pull alone (one launch each) for the table, with CUDA events
    before any profiler session of the phase. ``pulls``: (name, csr,
    frontier, need); returns the totals for the JSON line."""
    import torch
    from repro_torch.kernels import ops

    args = [(csr.offsets, csr.cols, csr.sched, f, n) for _, csr, f, n in pulls]
    got = cuda_sweep(args, chunk)
    again = cuda_sweep(args, chunk)
    wants = [plain(csr.offsets, csr.cols, f, n, chunk) for _, csr, f, n in pulls]
    torch.cuda.synchronize()
    total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0, one_ms=0.0)
    alone = [lambda o=csr.offsets, c=csr.cols, f=f, n=n, s=csr.sched:
             cuda_one(o, c, f, n, chunk, sched=s) for _, csr, f, n in pulls]
    total["ms"] = time_ms(lambda: cuda_sweep(args, chunk), reps=20)
    alone_ms = [time_ms(fn, reps=20) for fn in alone]
    for (name, csr, f, n), (fk, wk), (fa, wa), (fp, wp), fn, one_ms in zip(
            pulls, got, again, wants, alone, alone_ms):
        err = max(int((fk.long() - fp.long()).abs().max()),
                  int((wk.long() - wp.long()).abs().max()))
        check(err == 0, f"{kernel} {name}: kernel != plain")
        check(torch.equal(fk, fa) and torch.equal(wk, wa),
              f"{kernel} {name}: two launches equal")
        a = (csr.offsets, csr.cols, f, n, chunk)
        one_us = device_us(fn, "pull_rows_kernel")
        plain_ms = time_ms(lambda: plain(*a), reps=1)
        slots = int(wk.sum())
        b_ms, b_by = bound(*nbytes_fn(csr, f, n, wk, slots))
        check(b_by == "bytes", "pull bound is the memory stream")
        p, r1 = csr.offsets.shape
        print(f"kernel {kernel} [{name}]: rows={p * (r1 - 1)} "
              f"active={int((n != 0).reshape(p, r1 - 1, -1).any(-1).sum())} "
              f"E_max={csr.cols.shape[1]} chunk={chunk} slots_entered={slots} "
              f"found_bits={int(torch.count_nonzero(fk))} ms(alone)="
              f"{one_ms:.4f} device_us(alone)={one_us:.1f} "
              f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.5f} "
              f"exact=True; {schedule_line(csr)}")
        total["one_ms"] += one_ms
        total["plain_ms"] += plain_ms
        total["bound_ms"] += b_ms
        total["err"] = max(total["err"], err)
    sweep_us = device_us(lambda: cuda_sweep(args, chunk), "pull_rows_kernel")
    print(f"kernel {kernel} [sweep, one launch for 3 pulls]: ms="
          f"{total['ms']:.4f} (3 launches alone: {total['one_ms']:.4f}) "
          f"device_us={sweep_us:.1f} (profiler) plain_ms={total['plain_ms']:.4f} "
          f"bound_ms={total['bound_ms']:.5f} "
          f"ms/bound={total['ms'] / total['bound_ms']:.1f}")
    # the critical path of the longest row: the dd pull with every other
    # row's need cleared, against the same launch with no row active
    _, csr, f, n = pulls[0]
    p, r1 = csr.offsets.shape
    flat = int(csr.sched.order[0])
    rows = n.reshape(p * (r1 - 1), -1)
    one = torch.zeros_like(rows)
    one[flat] = rows[flat]
    one, none = one.reshape(n.shape), torch.zeros_like(n)
    run = lambda nd: lambda: cuda_one(csr.offsets, csr.cols, f, nd, chunk,
                                      sched=csr.sched)
    print(f"kernel {kernel} [{pulls[0][0]}, longest row only]: length="
          f"{int(csr.sched.span[0, 1])} device_us="
          f"{device_us(run(one), 'pull_rows_kernel'):.1f}; no row active: "
          f"device_us={device_us(run(none), 'pull_rows_kernel'):.1f}; every "
          f"row: device_us={device_us(run(n), 'pull_rows_kernel'):.1f}")
    sweep = (ops.ell_pull_chunked_sweep if kernel == "ell_pull_multi"
             else ops.ell_pull_bits_sweep)
    ops_args = [(csr, f, n) for _, csr, f, n in pulls]
    LAUNCH_CASES[sweep_case] = lambda: sweep(ops_args, chunk)
    return total


def kernel_phase_pull(eng, masks):
    """The three pulls of one sweep, kernel against plain version."""
    from repro_torch.core.comm import pack_lanes
    from repro_torch.kernels import ell_pull_multi as K
    from repro_torch.kernels import ops

    pgv, chunk = eng.pgv, eng.cfg.pull_chunk
    words_d = pack_lanes(masks["frontier_d"])
    pulls = [
        ("dd", pgv.dd, words_d,
         pack_lanes(masks["unvis_d"] & pgv.dd_src_mask[:, :, None])),
        ("nd (walks dn)", pgv.dn, pack_lanes(masks["frontier_n"]),
         pack_lanes(masks["unvis_d"] & pgv.dn_src_mask[:, :, None])),
        ("dn (walks nd)", pgv.nd, words_d,
         pack_lanes(masks["unvis_n"] & pgv.nd_src_mask[:, :, None])),
    ]
    dd = pulls[0]
    LAUNCH_CASES["ell_pull_multi [dd]"] = (
        lambda: ops.ell_pull_chunked(dd[1].offsets, dd[1].cols, dd[2], dd[3],
                                     chunk, dd[1].sched))

    def nbytes(csr, front, need, work, slots):
        p, r1 = csr.offsets.shape
        nw = need.shape[-1]
        frontier_bytes = min(front.numel() * 4, slots * nw * 4)
        return (p * r1 * 4 + 2 * need.numel() * 4 + work.numel() * 4
                + slots * 4 + frontier_bytes), slots * nw

    return pull_sweep_phase("ell_pull_multi", pulls, chunk,
                            K.ell_pull_chunked_sweep_cuda,
                            K.ell_pull_chunked_cuda, K.ell_pull_chunked_plain,
                            nbytes, "ell_pull_multi [sweep]")


def or_apply_pair(plan, words, level, it, target) -> dict:
    """The serving step's delegate update from its packed candidate words
    ``[p, d, nw]``: through the fused kernel (``comm.delegate_or_apply``)
    and as the chain it replaces ran (``delegate_combine``'s fold into a
    fresh zero ``prev``, unpack, AND with the unvisited lanes, the row and
    lane flags, ``where`` or OR into the plane, the target scan; the
    unvisited mask comes from the step, as before). Both return the new
    plane, frontier, lane flags, unhit flags and row flags."""
    import torch
    from repro_torch.core import comm as TC

    w = level.shape[-1]
    visited = level.dtype == torch.bool
    unvis = ~level if visited else level == 2**30

    def chain():
        reduced, _ = TC.delegate_combine(plan, words, "or")
        newly = TC.unpack_lanes(reduced, w) & unvis
        new_any = newly.reshape(newly.shape[0], -1).any(1)
        if visited:
            new_level, frontier = level | newly, newly
        else:
            new_level = torch.where(newly, (it + 1)[:, None, None], level)
            frontier = None
        unhit = None if target is None else (target & unvis & ~newly).any(1)
        return new_level, frontier, newly.any(1), unhit, new_any

    return {"mask_reduce_apply":
                lambda: TC.delegate_or_apply(plan, words, level, it, target)[0],
            "mask_reduce chain": chain}


def min_apply_pair(plan, cand, prev) -> dict:
    """The single-source step's delegate update under ``allgather`` from its
    candidate levels ``[p, d]``: through the fused kernel
    (``comm.delegate_min_apply``) and as the chain it replaces ran
    (``delegate_combine``'s ``torch.full`` identity and fold, ``minimum``,
    ``<``, ``any``)."""
    import torch
    from repro_torch.core import comm as TC

    def chain():
        reduced, _ = TC.delegate_combine(plan, cand, "min")
        out = torch.minimum(prev, reduced)
        return out, (out < prev).any(1)

    return {"payload_min_fold_apply":
                lambda: TC.delegate_min_apply(plan, cand, prev)[:2],
            "payload_min_fold chain": chain}


def apply_bytes(gathered, level, target, flags_words: int) -> int:
    """Bytes the OR apply must move: the gathered words once, the plane
    read and written (and the frontier plane written for visited planes),
    the target plane read, ``it`` and the flag words."""
    plane = level.numel() * level.element_size()
    visited = level.element_size() == 1
    return (gathered.numel() * 4 + 2 * plane + (level.numel() if visited else 0)
            + (0 if target is None else target.numel())
            + level.shape[0] * 4 + flags_words * 4)


def kernel_phase_apply(eng, st, masks, cand) -> dict:
    """The serving step's fused delegate update (``mask_reduce_apply``) at
    the path's shapes, on the mid-BFS state and the candidate words of
    ``kernel_phase_fold``: int32 levels with a target plane (3 delegate
    targets a lane, as MULTI_TARGET queries carry), and the reachability
    batches' bool visited plane without targets. Each against its plain
    version exactly and against the chain it replaced (results equal),
    timed (events), with the profiler's device us of the kernel and of the
    chain, its bound, and the span of one call through comm."""
    import torch
    from repro_torch.core import comm as TC
    from repro_torch.kernels import mask_reduce as K

    p, d, w = st.level_d.shape
    plan = TC.plan_for(eng.cfg.comm, p)
    words = TC.pack_lanes(cand)
    gathered = words.reshape(p, -1).contiguous()
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    target = torch.zeros_like(masks["unvis_d"])
    rows = torch.randint(0, d, (3, w), generator=gen, device=DEVICE)
    target[:, rows, torch.arange(w, device=DEVICE)] = True
    cases = {"levels + targets": (st.level_d, target),
             "reachability": (~masks["unvis_d"], None)}
    out = {}
    for name, (level, tgt) in cases.items():
        args = (gathered, level, st.it, tgt)
        got = K.mask_reduce_apply_cuda(*args)
        want = K.mask_reduce_apply_plain(*args)
        pair = or_apply_pair(plan, words, level, st.it, tgt)
        old = pair["mask_reduce chain"]()
        torch.cuda.synchronize()
        err = 0
        for field, g, wv, o in zip(want._fields, got, want, old):
            check((g is None) == (wv is None) == (o is None), f"{field} shape")
            if g is None:
                continue
            if g.numel():
                err = max(err, int((g.long() - wv.long()).abs().max()))
            check(g.dtype == wv.dtype and torch.equal(g, wv),
                  f"mask_reduce_apply [{name}] {field}: kernel != plain")
            check(torch.equal(g, o), f"mask_reduce_apply [{name}] {field}: "
                  "kernel != the chain it replaced")
        ms = time_ms(lambda: K.mask_reduce_apply_cuda(*args), 50)
        plain_ms = time_ms(lambda: K.mask_reduce_apply_plain(*args), 10)
        chain_ms = time_ms(pair["mask_reduce chain"], 10)
        dev = device_us(lambda: K.mask_reduce_apply_cuda(*args),
                        "mask_reduce_apply_kernel")
        chain_dev = device_us(pair["mask_reduce chain"])
        f4 = -(-w // 4)
        b_ms, b_by = bound(apply_bytes(gathered, level, tgt, p * (2 * f4 + 1)),
                           level.numel() * (gathered.shape[0] + 3))
        print(f"kernel mask_reduce_apply [{name}]: K={p} P={p} D={d} W={w} "
              f"level {level.dtype} newly_marked="
              f"{int((got.level != level).sum())} ms={ms:.4f} "
              f"device_us={dev:.2f} plain_ms={plain_ms:.4f} bound_ms="
              f"{b_ms:.5f} ({b_by}) bound/device={b_ms * 1e3 / dev:.3f}; "
              f"replaced chain: ms={chain_ms:.4f} device_us={chain_dev:.2f} "
              f"exact=True")
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         err=err, device_us=dev, chain_device_us=chain_dev)
        span_check(pair["mask_reduce_apply"], "mask_reduce_apply_kernel",
                   f"serving delegate update [{name}]")
        if tgt is not None:
            LAUNCH_CASES.update(pair)
    return out


def kernel_phase_fold(eng, st, masks):
    """The delegate OR fold over the p partitions' candidate words (the
    pushes of a sweep in which every lane pushes), both variants, then the
    fused apply of the serving step on the same words."""
    import torch
    from repro_torch.core import msbfs as M
    from repro_torch.core.comm import pack_lanes
    from repro_torch.kernels import mask_reduce as K
    from repro_torch.kernels import ops

    pgv, d = eng.pgv, masks["unvis_d"].shape[1]
    cand = (M._push_multi(pgv.dd, masks["frontier_d"], d)
            | M._push_multi(pgv.nd, masks["frontier_n"], d))
    partials = pack_lanes(cand).reshape(cand.shape[0], -1).contiguous()
    k, nw = partials.shape
    out = {}
    for with_count in (False, True):
        prev = (torch.zeros(nw, dtype=torch.int32, device=partials.device)
                if not with_count
                else pack_lanes(~masks["unvis_d"][0]).reshape(-1).contiguous())
        got = K.mask_reduce_cuda(partials, prev, with_count)
        want = K.mask_reduce_plain(partials, prev, with_count)
        if not with_count:
            LAUNCH_CASES["mask_reduce"] = (
                lambda a=(partials, prev): ops.mask_reduce(*a, with_count=False))
        torch.cuda.synchronize()
        err = int((got[0].long() - want[0].long()).abs().max())
        if with_count:
            err = max(err, int((got[1].long() - want[1].long()).abs().max()))
        check(err == 0, f"mask_reduce(with_count={with_count}): kernel != plain")
        ms = time_ms(lambda: K.mask_reduce_cuda(partials, prev, with_count), 50)
        plain_ms = time_ms(lambda: K.mask_reduce_plain(partials, prev,
                                                       with_count), 10)
        nbytes = (k + 1) * nw * 4 + nw * 4 * (2 if with_count else 1)
        b_ms, b_by = bound(nbytes, (k + (2 if with_count else 0)) * nw)
        print(f"kernel mask_reduce [with_count={with_count}]: K={k} NW={nw} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.6f} "
              f"new_bits={int(got[1].sum()) if with_count else '-'} exact=True")
        out[with_count] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                               bound_by=b_by, err=err)
    out["apply"] = kernel_phase_apply(eng, st, masks, cand)
    return out


def ell_contract_check(device) -> None:
    """The reference kernel's ELL contract (-1 padded parents, one chunk)
    through the same CUDA kernel, against its plain version."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.ell_pull_multi import (ell_as_csr,
                                                    ell_pull_chunked_cuda)

    rng = np.random.default_rng(0)
    for r, k, n, nw in [(7, 4, 40, 1), (256, 32, 500, 2), (33, 70, 100, 3),
                        (9, 3000, 700, 4)]:
        parents = torch.from_numpy(rng.integers(-1, n, (r, k)).astype(np.int32))
        fw = torch.from_numpy(rng.integers(-2**31, 2**31, (n, nw)).astype(np.int32))
        aw = torch.from_numpy(rng.integers(-2**31, 2**31, (r, nw)).astype(np.int32))
        offsets, cols, chunk, sched = ell_as_csr(parents.to(device))
        got, _ = ell_pull_chunked_cuda(offsets, cols, fw.to(device)[None],
                                       aw.to(device)[None], chunk, sched)
        want = ref.ell_pull_multi_ref(parents, fw, aw)
        torch.cuda.synchronize()
        check(torch.equal(got[0].cpu(), want), f"ELL contract r={r} k={k}")
    print("kernel ell_pull_multi [ELL contract, 4 shapes]: exact=True")


def _device_us(ev) -> float:
    """A profiler row's self device microseconds (the attribute's name
    differs across PyTorch versions)."""
    us = getattr(ev, "self_device_time_total", None)
    return ev.self_cuda_time_total if us is None else us


def report_profile(prof, wall_ms: float, header: str, names):
    """Print the device busy share and the top operators and kernels of a
    ``torch.profiler`` run, and each port kernel's per-launch device time
    (``names``: substrings of the kernel symbols). Returns ``({name: us
    per launch}, [names not in the trace], device ms)``."""
    rows = []
    for ev in prof.key_averages():
        dev_us = _device_us(ev)
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    # operator rows (aten::*, and the port's autograd Functions, forward
    # and backward) carry the device time of the kernels they launched;
    # the other rows are the kernels and copies themselves
    is_op = lambda key: key.startswith(("aten::", "autograd::")) or key in (
        "CinFused", "CinFusedBackward")
    ops_rows = [r for r in rows if is_op(r[2])]
    dev_rows = [r for r in rows if not is_op(r[2])]
    busy_ms = sum(r[0] for r in dev_rows)
    print(f"profile: {header}, wall_ms={wall_ms:.1f} (profiler on), device "
          f"time={busy_ms:.1f} ms, device busy share={busy_ms / wall_ms:.3f}")
    for title, sel in (("operator", ops_rows), ("kernel", dev_rows)):
        for dev_ms, count, key in sel[:8]:
            print(f"  profile {title}: {dev_ms:9.3f} ms x{count:<5d} {key[:100]}")
    per_launch, missing = {}, []
    for name in names:
        mine = [r for r in dev_rows if name in r[2]]
        n = sum(r[1] for r in mine)
        total = sum(r[0] for r in mine)
        if n == 0:
            print(f"  profile port kernel {name}: not in the trace")
            missing.append(name)
            continue
        per_launch[name] = total / n * 1e3
        print(f"  profile port kernel {name}: {n} launches, "
              f"{total:.3f} ms device, {per_launch[name]:.1f} us per launch")
    return per_launch, missing, busy_ms


def profile_run(run, header, names, into: dict | None = None) -> dict:
    """``run()`` under ``torch.profiler``, reported by report_profile;
    ``header(result)`` names the phase. A trace that misses a named
    kernel, or holds no device time, is profiled once more; a second miss
    fails the run. Returns ``{name: us per launch}``; ``into`` (where
    given) gets the run's ``wall_ms``, ``busy_ms``, result ``out`` and
    each operator's device ms (``ops``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in (1, 2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        per_launch, missing, busy_ms = report_profile(prof, wall_ms,
                                                      header(out), names)
        if not missing and busy_ms > 0:
            if into is not None:
                into.update(wall_ms=wall_ms, busy_ms=busy_ms, out=out,
                            ops={ev.key: _device_us(ev) / 1e3
                                 for ev in prof.key_averages()
                                 if ev.key.startswith("aten::")})
            return per_launch
        print(f"  profile attempt {attempt} of {header(out)}: missing "
              f"{missing}, device time {busy_ms:.1f} ms")
    check(False, f"profile {header(out)}: every named kernel in the trace, "
          "device time above 0")


def profile_batch(eng, queries) -> None:
    """Where one lane batch's time goes: ``torch.profiler`` over one
    ``run_batch_queries`` call (after the main path, outside its counts),
    top device ops by self time and the device busy share of the wall
    time."""
    batch = list(dict.fromkeys(queries))[: eng.cfg.n_queries]

    def run():
        sweeps0 = eng.traversal_sweeps
        eng.run_batch_queries(batch)
        return eng.traversal_sweeps - sweeps0

    profile_run(run, lambda sweeps: f"one batch of {len(batch)} queries, "
                f"sweeps={sweeps}",
                ("pull_rows_kernel<pull::WordGather", "mask_reduce_apply_kernel"))


def mixed_queries(g, pg):
    """64 queries: 16 of each bit kind, interleaved, with duplicates."""
    import numpy as np
    from repro_torch.graphs.rmat import pick_sources
    from repro_torch.serve import Query, QueryKind as K

    srcs = [int(s) for s in pick_sources(g, 60, seed=11)]
    tg = [int(s) for s in pick_sources(g, 24, seed=12)]
    per = {
        K.LEVELS: [Query(s) for s in srcs[0:14]],
        K.REACHABILITY: [Query(s, K.REACHABILITY) for s in srcs[14:28]],
        K.DISTANCE_LIMITED: [Query(s, K.DISTANCE_LIMITED, max_depth=1 + i % 3)
                             for i, s in enumerate(srcs[28:42])],
        K.MULTI_TARGET: [Query(s, K.MULTI_TARGET,
                               targets=tuple(tg[(3 * i) % 24:(3 * i) % 24 + 3]))
                         for i, s in enumerate(srcs[42:56])],
    }
    qs = [q for group in zip(*per.values()) for q in group]       # 56 unique
    dv = int(np.asarray(pg.delegate_vids)[0])
    qs += [Query(dv), Query(dv, K.REACHABILITY)]                   # delegates
    qs += qs[:6]                                                   # duplicates
    check(len(qs) == N_QUERIES, "64 queries")
    return qs


def bfs_configs():
    """The ``bfs-rmat`` configurations the single-source phases run: FULL
    (the paper's path), OPT2 (1-byte delegate masks, static bitmask nn
    exchange) and FULL under the all-gathered delegate combine."""
    from dataclasses import replace

    from repro_torch.configs.base import get_arch
    from repro_torch.core.comm import CommConfig

    full = get_arch("bfs-rmat").model
    opt2 = get_arch("bfs-rmat-opt2").model
    return {"FULL": full, "OPT2": opt2,
            "allgather": replace(full, comm=CommConfig(delegate="allgather"))}


def ss_mid_bfs(eng, g, cfg, sweeps: int = 2):
    """A real single-source frontier: the first Graph500 search key whose
    state after ``sweeps`` sweeps leaves rows to scan in all three pulls
    (from a typical key, that state is the sweep where direction
    optimization turns to pulling). Returns the key, the state and its
    frontier / unvisited masks."""
    import torch
    from repro_torch.core import bfs as TB
    from repro_torch.core.types import INF_LEVEL
    from repro_torch.graphs.rmat import pick_sources

    pgv = eng.pgv
    for src in (int(s) for s in pick_sources(g, N_KEYS, seed=2)):
        st = TB.init_state(eng.pg, src, cfg, device=eng.device)
        for _ in range(sweeps):
            st = TB.bfs_step(pgv, st, cfg)
        it = st.it[:, None]
        masks = dict(
            frontier_n=(st.level_n == it) & pgv.normal_valid,
            frontier_d=st.level_d == it,
            unvis_n=(st.level_n == int(INF_LEVEL)) & pgv.normal_valid,
            unvis_d=st.level_d == int(INF_LEVEL))
        rows = (masks["unvis_d"] & pgv.dd_src_mask, masks["unvis_d"] & pgv.dn_src_mask,
                masks["unvis_n"] & pgv.nd_src_mask)
        if all(bool(r.any()) for r in rows) and bool(masks["frontier_d"].any()):
            torch.cuda.synchronize()
            return src, st, masks
    raise RuntimeError("chip_smoke check failed: no search key leaves rows "
                       f"to pull after {sweeps} sweeps")


def kernel_phase_bit_pull(eng, masks, chunk: int):
    """The three single-source pulls of one sweep, every row that the
    reference's pull scans active, kernel against plain version."""
    import torch
    from repro_torch.core.comm import pack_lanes
    from repro_torch.kernels import ell_pull as K
    from repro_torch.kernels import ops

    pgv = eng.pgv
    mask_d = pack_lanes(masks["frontier_d"])
    act = lambda rows: rows.to(torch.int32)
    pulls = [
        ("dd", pgv.dd, mask_d, act(masks["unvis_d"] & pgv.dd_src_mask)),
        ("nd (walks dn)", pgv.dn, pack_lanes(masks["frontier_n"]),
         act(masks["unvis_d"] & pgv.dn_src_mask)),
        ("dn (walks nd)", pgv.nd, mask_d,
         act(masks["unvis_n"] & pgv.nd_src_mask)),
    ]
    dd = pulls[0]
    LAUNCH_CASES["ell_pull [dd]"] = (
        lambda: ops.ell_pull_bits(dd[1].offsets, dd[1].cols, dd[2], dd[3],
                                  chunk, dd[1].sched))

    def nbytes(csr, mask, active, work, slots):
        p, r1 = csr.offsets.shape
        return (p * r1 * 4 + 3 * active.numel() * 4 + slots * 4
                + min(mask.numel() * 4, slots * 4)), slots

    return pull_sweep_phase("ell_pull", pulls, chunk,
                            K.ell_pull_bits_sweep_cuda, K.ell_pull_bits_cuda,
                            K.ell_pull_bits_plain, nbytes, "ell_pull [sweep]")


def kernel_phase_min_fold(eng, st, masks):
    """The delegate min fold of the p=2 partitions' int32 level candidates
    (the pushes of the mid-BFS sweep), both variants; the library yardstick
    is one ``torch.amin`` over the pre-stacked ``[K + 1, NW]``."""
    import torch
    from repro_torch.core import bfs as TB
    from repro_torch.core import comm as TC
    from repro_torch.core.types import INF_LEVEL
    from repro_torch.kernels import mask_reduce as K
    from repro_torch.kernels import ops

    pgv, d = eng.pgv, masks["unvis_d"].shape[1]
    cand = (TB._push_fused(pgv.dd, masks["frontier_d"], d)
            | TB._push_fused(pgv.nd, masks["frontier_n"], d))
    partials = torch.where(cand & masks["unvis_d"], st.it[:, None] + 1,
                           int(INF_LEVEL)).to(torch.int32).contiguous()
    k, nw = partials.shape
    out = {}
    for with_count in (False, True):
        prev = (torch.full((nw,), int(INF_LEVEL), dtype=torch.int32,
                           device=partials.device)
                if not with_count else st.level_d[0].contiguous())
        got = K.payload_min_fold_cuda(partials, prev, with_count)
        want = K.payload_min_fold_plain(partials, prev, with_count)
        torch.cuda.synchronize()
        err = int((got[0].long() - want[0].long()).abs().max())
        if with_count:
            err = max(err, int((got[1].long() - want[1].long()).abs().max()))
        check(err == 0, f"payload_min_fold(with_count={with_count}): "
              "kernel != plain")
        ms = time_ms(lambda: K.payload_min_fold_cuda(partials, prev,
                                                     with_count), 50)
        plain_ms = time_ms(lambda: K.payload_min_fold_plain(
            partials, prev, with_count), 10)
        stacked = torch.cat([prev[None], partials])
        check(torch.equal(stacked.amin(0), got[0]), "amin yardstick")
        lib_ms = time_ms(lambda: stacked.amin(0), 50)
        if not with_count:
            LAUNCH_CASES["payload_min_fold"] = (
                lambda a=(partials, prev): ops.payload_min_fold(
                    *a, with_count=False))
            LAUNCH_CASES["torch.amin"] = lambda t=stacked: t.amin(0)
        nbytes = (k + 1) * nw * 4 + nw * 4 * (2 if with_count else 1)
        b_ms, b_by = bound(nbytes, (k + (1 if with_count else 0)) * nw)
        print(f"kernel payload_min_fold [with_count={with_count}]: K={k} "
              f"NW={nw} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms(amin)={lib_ms:.4f} kernel/amin={ms / lib_ms:.3f} "
              f"bound_ms={b_ms:.6f} "
              f"improved={int(got[1].sum()) if with_count else '-'} "
              "exact=True")
        out[with_count] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                               bound_by=b_by, library_ms=lib_ms, err=err)

    # the fused apply of the allgather step: the fold into the state's
    # delegate levels with the per-row improved flag
    prev = st.level_d
    plan = TC.plan_for(TC.CommConfig(delegate="allgather"), k)
    pair = min_apply_pair(plan, partials, prev)
    got = K.payload_min_fold_apply_cuda(partials, prev)
    want = K.payload_min_fold_apply_plain(partials, prev)
    old = pair["payload_min_fold chain"]()
    torch.cuda.synchronize()
    for i, field in enumerate(("levels", "improved")):
        check(got[i].dtype == want[i].dtype and torch.equal(got[i], want[i]),
              f"payload_min_fold_apply {field}: kernel != plain")
        check(torch.equal(got[i], old[i]), f"payload_min_fold_apply {field}: "
              "kernel != the chain it replaced")
    run = lambda: K.payload_min_fold_apply_cuda(partials, prev)
    ms = time_ms(run, 50)
    plain_ms = time_ms(lambda: K.payload_min_fold_apply_plain(partials, prev),
                       10)
    chain_ms = time_ms(pair["payload_min_fold chain"], 10)
    dev = device_us(run, "payload_min_fold_apply_kernel")
    chain_dev = device_us(pair["payload_min_fold chain"])
    p = prev.shape[0]
    nbytes = partials.numel() * 4 + 2 * prev.numel() * 4 + 4 * -(-p // 4)
    b_ms, b_by = bound(nbytes, (k + 1) * prev.numel())
    print(f"kernel payload_min_fold_apply: K={k} P={p} D={nw} "
          f"improved_rows={int(got[1].sum())} changed="
          f"{int((got[0] != prev).sum())} ms={ms:.4f} device_us={dev:.2f} "
          f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.6f} ({b_by}) "
          f"bound/device={b_ms * 1e3 / dev:.3f}; replaced chain: "
          f"ms={chain_ms:.4f} device_us={chain_dev:.2f} exact=True")
    span_check(pair["payload_min_fold_apply"], "payload_min_fold_apply_kernel",
               "single-source delegate update [allgather]")
    LAUNCH_CASES.update(pair)
    out["apply"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                        err=0, device_us=dev, chain_device_us=chain_dev)
    return out


def ell_pull_contract_check(device) -> int:
    """The reference kernel's ELL contract (-1 padded parents, bit-packed
    mask, one chunk) through the CUDA kernel, against its oracle."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.ell_pull import ell_pull_bits_cuda
    from repro_torch.kernels.ell_pull_multi import ell_as_csr

    rng = np.random.default_rng(1)
    for r, w, n in [(7, 4, 40), (256, 32, 1000), (300, 70, 333),
                    (9, 3000, 700)]:
        parents = torch.from_numpy(rng.integers(-1, n, (r, w)).astype(np.int32))
        mask = ref.pack_bitmask(torch.from_numpy(rng.random(n) < 0.3))
        active = torch.from_numpy(rng.integers(0, 2, r).astype(np.int32))
        offsets, cols, chunk, sched = ell_as_csr(parents.to(device))
        got, _ = ell_pull_bits_cuda(offsets, cols, mask.to(device)[None],
                                    active.to(device)[None], chunk, sched)
        want = ref.ell_pull_ref(parents, mask, active)
        torch.cuda.synchronize()
        check(torch.equal(got[0].cpu(), want), f"ELL contract r={r} w={w}")
    print("kernel ell_pull [ELL contract, 4 shapes]: exact=True")
    return 0


def run_bfs_keys(eng, g, cfg, keys, csr, want_levels=None):
    """BFS from each key with the launch counts zeroed before and read
    after each run; each answer is held against the numpy oracle (or the
    given levels). Returns per-key records."""
    import numpy as np
    import torch
    from repro_torch.core import bfs as TB
    from repro_torch.core import oracle as O
    from repro_torch.kernels import ops

    plan = eng.plan if cfg.static_exchange else None
    recs = []
    for i, src in enumerate(keys):
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        out = TB.run_bfs_emulated(
            eng.pgv, TB.init_state(eng.pg, src, cfg, device=eng.device), cfg,
            plan)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        levels = TB.gather_levels(eng.pg, out)
        want = (O.bfs_levels(g, src, csr) if want_levels is None
                else want_levels[i])
        check(np.array_equal(levels, want), f"levels of key {src}")
        sweeps = int(out.it[0])
        check(int(out.nn_overflow.sum()) == 0, "no nn id dropped")
        recs.append(dict(
            src=src, time_s=dt, sweeps=sweeps, levels=levels,
            edges=O.traversed_edges(g, levels), launches=launches,
            work_fwd=int(out.work_fwd.sum()), work_bwd=int(out.work_bwd.sum()),
            nn_sent=int(out.nn_sent.sum()),
            wire_delegate=int(out.wire_delegate.sum()),
            wire_nn=int(out.wire_nn.sum()),
            nn_sparse=int(out.nn_sparse[0].sum())))
    return recs


def check_bfs_launches(recs, name: str) -> None:
    for r in recs:
        la = r["launches"]
        check(la["ell_pull"] == r["sweeps"],
              f"{name}: ell_pull launches == sweeps (one for 3 pulls)")
        check(la["payload_min_fold"] == (r["sweeps"] if name == "allgather"
                                         else 0),
              f"{name}: payload_min_fold launches")
        check(la["ell_pull_multi"] == 0 and la["mask_reduce"] == 0,
              f"{name}: no msBFS kernel on the single-source path")


def single_source_path(eng, g, csr):
    """The Graph500-style search-key runs (FULL, then OPT2 and allgather
    on the first keys); returns the first key, the FULL and allgather
    launch totals and the FULL records."""
    from repro_torch.graphs.rmat import pick_sources

    cfgs = bfs_configs()
    keys = [int(s) for s in pick_sources(g, N_KEYS, seed=2)]
    run_bfs_keys(eng, g, cfgs["FULL"], keys[:1], csr)          # warm-up
    full = run_bfs_keys(eng, g, cfgs["FULL"], keys, csr)
    check_bfs_launches(full, "FULL")
    teps = []
    for r in full:
        t = r["edges"] / r["time_s"]
        if r["sweeps"] > 1:                    # Graph500: skip <=1 sweep
            teps.append(t)
        print(f"bfs FULL key={r['src']}: {r['time_s'] * 1e3:.1f} ms "
              f"sweeps={r['sweeps']} edges={r['edges']} TEPS={t:.4e} "
              f"work_fwd={r['work_fwd']} work_bwd={r['work_bwd']} "
              f"nn_sent={r['nn_sent']} wire_delegate={r['wire_delegate']} "
              f"wire_nn={r['wire_nn']} launches={r['launches']}")
    check(len(teps) > 0, "at least one multi-sweep search key")
    hmean = len(teps) / sum(1.0 / t for t in teps)
    times = sorted(r["time_s"] for r in full)
    print(f"bfs FULL: {len(full)} keys exact vs oracle, harmonic-mean "
          f"TEPS={hmean:.4e} over {len(teps)} keys, median time "
          f"{times[len(times) // 2] * 1e3:.1f} ms, sweeps "
          f"{sorted(r['sweeps'] for r in full)}")
    def summed(recs):
        return {k: sum(r["launches"][k] for r in recs) for k in
                recs[0]["launches"]}

    totals = {"FULL": summed(full)}
    for name in ("OPT2", "allgather"):
        sub = full[:N_VARIANT_KEYS]
        recs = run_bfs_keys(eng, g, cfgs[name], [r["src"] for r in sub], csr,
                            want_levels=[r["levels"] for r in sub])
        check_bfs_launches(recs, name)
        totals[name] = summed(recs)
        print(f"bfs {name}: {len(recs)} keys equal the FULL run; ms "
              f"{[round(r['time_s'] * 1e3, 1) for r in recs]} sweeps "
              f"{[r['sweeps'] for r in recs]} wire_delegate "
              f"{[r['wire_delegate'] for r in recs]} wire_nn "
              f"{[r['wire_nn'] for r in recs]}")
    print(f"launches per single-source run set: {totals}")
    return full[0]["src"], totals, full


def profile_bfs(eng, src: int) -> None:
    """``torch.profiler`` over one FULL single-source BFS, and over one
    under ``delegate="allgather"`` (the fused min fold's path)."""
    from repro_torch.core import bfs as TB

    for name, kernels in (("FULL", ("pull_rows_kernel<pull::BitGather>",)),
                          ("allgather", ("pull_rows_kernel<pull::BitGather>",
                                         "payload_min_fold_apply_kernel"))):
        cfg = bfs_configs()[name]
        profile_run(lambda: TB.run_bfs_emulated(
                        eng.pgv, TB.init_state(eng.pg, src, cfg,
                                               device=eng.device), cfg),
                    lambda out: f"one {name} BFS from {src}, "
                    f"sweeps={int(out.it[0])}", kernels)


# ------------------------------------------ serving: host phases, refill
def batch_phases(eng, queries) -> None:
    """One lane batch of the serving run (its first 32 distinct queries)
    split into phases, each bracketed by ``torch.cuda.synchronize()``:
    (a) ``init_multi_state``, (b) the sweep loop, (c) the lane gather --
    the package's (``LaneGather``: rows assembled on the device, copied to
    pinned memory), the bare pinned copy of the same bytes, and a host
    assembly of the same rows (lane slice copied to pageable memory, then
    numpy indexing) timed in its two parts -- and (d) ``unpack_result`` over the
    batch; beside the batch's wall time."""
    import numpy as np
    import torch
    from repro_torch.core import msbfs as M
    from repro_torch.core.types import INF_LEVEL, PartitionLayout
    from repro_torch.serve.queries import unpack_result

    batch = list(dict.fromkeys(queries))[: eng.cfg.n_queries]
    reach_fast = eng._reach_fast(batch)
    cfg = eng._session_cfg(batch)
    pg, k = eng.pg, len(batch)
    sync, clock = torch.cuda.synchronize, time.perf_counter
    sync()
    t = [clock()]
    st = M.init_multi_state(pg, [q.source for q in batch], cfg,
                            depth_caps=[q.depth_cap for q in batch],
                            targets=[q.targets for q in batch],
                            device=eng.device)
    sync()
    t.append(clock())
    out = M.run_msbfs_emulated(eng.pgv, eng.plan, st, cfg)
    sync()
    t.append(clock())
    rows = M.LaneGather(pg, out, np.arange(k)).rows()
    t.append(clock())
    results = [unpack_result(q, rows[i], packed_reach=reach_fast)
               for i, q in enumerate(batch)]
    t.append(clock())
    sweeps = int(out.it[0])
    dev_rows = torch.empty(rows.shape, dtype=torch.int32, device=eng.device)
    host = torch.empty(rows.shape, dtype=torch.int32, pin_memory=True)
    sync()
    t0 = clock()
    host.copy_(dev_rows)
    sync()
    t_copy = clock() - t0
    sel = torch.arange(k, device=eng.device)
    sync()
    t0 = clock()
    host_n = out.level_n[..., sel].cpu().numpy()
    host_d = out.level_d[0][..., sel].cpu().numpy()
    t1 = clock()
    layout = PartitionLayout(pg.n, pg.p_rank, pg.p_gpu)
    vids = np.arange(pg.n, dtype=np.int64)
    cols = np.ascontiguousarray(
        host_n[layout.part_of(vids), layout.local_of(vids)].T)
    cols[:, np.asarray(pg.delegate_vids).reshape(-1)[: pg.d]] = \
        host_d[: pg.d].T
    t2 = clock()
    inf = int(INF_LEVEL)
    base = out.base_it[0].cpu().numpy()[:, None]
    check(len(results) == k and not reach_fast and np.array_equal(
        np.where(cols == inf, inf, cols - base), rows),
          "phase split: both gathers agree")
    ms = [(b - a) * 1e3 for a, b in zip(t, t[1:])]
    print(f"batch phases ({k} queries, {sweeps} sweeps): (a) init_multi_state "
          f"{ms[0]:.2f} ms; (b) sweep loop {ms[1]:.2f} ms = "
          f"{ms[1] / max(sweeps, 1):.2f} ms a sweep; (c) gather "
          f"(LaneGather: device assembly + pinned copy) {ms[2]:.2f} ms, of "
          f"which the bare pinned copy of the {rows.nbytes} B "
          f"{t_copy * 1e3:.2f} ms; host assembly: lane slice + "
          f"pageable copy {(t1 - t0) * 1e3:.2f} ms, numpy assembly "
          f"{(t2 - t1) * 1e3:.2f} ms; (d) unpack_result {ms[3]:.2f} ms; "
          f"batch wall (a+b+c+d) {(t[-1] - t[0]) * 1e3:.2f} ms")


def tailed_stream(g, tips):
    """The refill stream: the tail tips spread through REFILL_QUERIES -
    len(tips) core sources (``pick_sources(g, ., seed=1)``), the four kinds
    cycled -- LEVELS, REACHABILITY, DISTANCE_LIMITED (max_depth 3) and
    MULTI_TARGET on two core sources (``benchmarks/msbfs_throughput.py``'s
    overlap stream, at this graph)."""
    from repro_torch.graphs.rmat import pick_sources
    from repro_torch.serve import Query, QueryKind as K

    core = [int(s) for s in pick_sources(g, REFILL_QUERIES - len(tips),
                                         seed=1)]
    stream = list(core)
    gap = max(1, len(stream) // len(tips))
    for i, tip in enumerate(tips):
        stream.insert(i * gap, int(tip))
    tpool = tuple(core[:2])
    kinds = [lambda s: Query(s), lambda s: Query(s, K.REACHABILITY),
             lambda s: Query(s, K.DISTANCE_LIMITED, max_depth=3),
             lambda s: Query(s, K.MULTI_TARGET, targets=tpool)]
    return [kinds[i % 4](s) for i, s in enumerate(stream)]


def block_totals(eng) -> dict:
    """Sweeps dispatched, gated-off sweeps (and their device ms) and graph
    replays over every fused block of ``eng``."""
    out = dict(sweeps=0, gated=0, gated_ms=0.0, replays=0)
    for blk in eng.blocks.values():
        if blk.runner is not None:
            for key in out:
                out[key] += getattr(blk.runner, key)
    return out


def drive(eng, mode: str, queries) -> dict:
    """One run of ``queries`` through ``mode`` (batch, sync, overlap or
    stream: STREAM_CHUNKS ``submit_stream`` chunks with ``poll()`` between,
    then ``drain_stream()``) with the stats and the launch counts zeroed
    just before and read just after. Returns {query: result} and the
    run's numbers."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeStats

    eng.refill, eng.overlap = mode != "batch", mode == "overlap"
    eng.stats = ServeStats()
    for blk in eng.blocks.values():
        if blk.runner is not None:
            # sweeps a warm-up left in flight (with two in flight, its
            # frozen block's second one) are read now, not in the run
            blk.runner.drain()
    sweeps0, blocks0 = eng.traversal_sweeps, block_totals(eng)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    if mode == "stream":
        res = {}
        step = -(-len(queries) // STREAM_CHUNKS)
        for i in range(0, len(queries), step):
            eng.submit_stream(queries[i:i + step])
            res.update(eng.poll())
        res.update(eng.drain_stream())
    else:
        res = dict(zip(queries, eng.submit_many(queries)))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: ops.LAUNCHES[k] + ops.REPLAYED[k] for k in ops.LAUNCHES}
    blocks = {k: v - blocks0[k] for k, v in block_totals(eng).items()}
    sweeps = (eng.traversal_sweeps - sweeps0 if mode == "batch"
              else eng.stats.sweeps)
    executed = blocks["sweeps"] if mode in ("overlap", "stream") else sweeps
    return dict(results=res, time_s=dt, sweeps=sweeps, executed=executed,
                launches=launches, replayed=dict(ops.REPLAYED),
                blocks=blocks, stats=eng.stats.as_dict())


def block_both_ways(eng, queries, tips) -> None:
    """One block of SWEEP_BLOCK sweeps from the same state -- the first
    lane word of the stream, watching only the tail tips' lanes so no
    watched lane retires -- by graph replay (the engine's captured block)
    and eagerly: every state leaf equal, each timed (host clock to the
    block's last probe, and CUDA events over the block), median of 3."""
    import numpy as np
    import torch
    from repro_torch.core import convert, msbfs as M

    batch = queries[: eng.cfg.n_queries]
    cfg = eng._session_cfg(batch)
    st = M.init_multi_state(eng.pg, [q.source for q in batch], cfg,
                            depth_caps=[q.depth_cap for q in batch],
                            targets=[q.targets for q in batch],
                            device=eng.device)
    watch = np.array([q.source in tips and q.depth_cap is None
                      for q in batch])
    check(watch.any(), "block timing: a tail tip among the watched lanes")
    ways = {"graph": eng._block(cfg, False),
            "eager": M.make_msbfs_block_emulated(cfg, SWEEP_BLOCK,
                                                 graph=False)}
    out, times = {}, {}
    for name, blk in ways.items():
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0 = time.perf_counter()
            e0.record()
            run = blk(eng.pgv, eng.plan, st, watch)
            probe = run.wait()
            e1.record()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            runs.append(((t1 - t0) * 1e3, e0.elapsed_time(e1)))
            check(probe.it == SWEEP_BLOCK and probe.ran,
                  f"block {name}: {SWEEP_BLOCK} sweeps ran")
        out[name] = convert.state_to_numpy(run.out)
        runs.sort()
        times[name] = runs[1]
    for key in M.STATE_LEAVES:
        check(np.array_equal(out["graph"][key], out["eager"][key]),
              f"graph block == eager block: {key}")
    print(f"block of {SWEEP_BLOCK} sweeps, same state, {int(watch.sum())} "
          f"watched tip lanes: graph replay {times['graph'][0]:.2f} ms host "
          f"to last probe, {times['graph'][1]:.2f} ms events; eager "
          f"{times['eager'][0]:.2f} ms host, {times['eager'][1]:.2f} ms "
          f"events; every state leaf equal")


def lookahead_phase(eng, queries, sync_stats: dict) -> None:
    """The overlap run once more with two sweeps in flight instead of
    ``msbfs.LOOKAHEAD`` (new captures): its counters must equal the sync
    driver's; prints its time and the gated sweeps it ran -- each block
    stopped by a retirement leaves one sweep in flight, which runs frozen
    at a full sweep's cost."""
    import torch
    from repro_torch.core import msbfs as M

    saved = M.LOOKAHEAD
    M.LOOKAHEAD = 2
    try:
        eng.blocks.clear()
        eng.warmup(reachability=True, targets=True)
        r = drive(eng, "overlap", queries)
    finally:
        M.LOOKAHEAD = saved
        eng.blocks.clear()
        torch.cuda.empty_cache()
    st, bl = r["stats"], r["blocks"]
    for key in sync_stats:
        if key != "sweep_blocks":
            check(st[key] == sync_stats[key],
                  f"lookahead 2: counters equal sync: {key}")
    check(bl["sweeps"] - bl["gated"] == st["sweeps"],
          f"lookahead 2: every ungated sweep is in the schedule "
          f"({bl['sweeps']} dispatched, {bl['gated']} gated, "
          f"{st['sweeps']} in the schedule)")
    print(f"refill overlap, lookahead 2: {len(queries)} queries in "
          f"{r['time_s']:.3f} s = {len(queries) / r['time_s']:.2f} queries/s;"
          f" sweeps={st['sweeps']} executed={bl['sweeps']} gated sweeps="
          f"{bl['gated']} ({bl['gated_ms']:.2f} ms device) "
          f"sweep_blocks={st['sweep_blocks']}")


def refill_engine(g):
    """The refill path's engine on the tailed graph, warmed up with its
    blocks captured (the stream's too); returns ``(gt, tips, eng,
    queries)``."""
    import torch
    from repro_torch.core import msbfs as M
    from repro_torch.graphs.synthetic import with_tails
    from repro_torch.serve import BFSServeEngine, Query, QueryKind as K

    t0 = time.perf_counter()
    gt, tips = with_tails(g, n_tails=N_TAILS, length=TAIL_LEN, seed=5)
    tips = [int(t) for t in tips]
    cfg = M.MSBFSConfig(n_queries=32, max_iters=REFILL_MAX_ITERS)
    eng = BFSServeEngine(gt, th=TH, p_rank=P_RANK, p_gpu=P_GPU, cfg=cfg,
                         cache_capacity=0, reuse_components=False,
                         refill=True, overlap=True, sweep_block=SWEEP_BLOCK,
                         device=DEVICE)
    t_setup = time.perf_counter() - t0
    queries = tailed_stream(g, tips)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng.warmup(reachability=True, targets=True)
    eng.submit_stream([Query(int(tips[0]), K.DISTANCE_LIMITED, max_depth=1)])
    eng.drain_stream()                       # captures the stream's block
    torch.cuda.synchronize()
    print(f"refill setup: with_tails({N_TAILS}, {TAIL_LEN}) n={gt.n} "
          f"m={gt.m}, partition+plan+upload {t_setup:.1f} s; warm-up with "
          f"captures {time.perf_counter() - t0:.1f} s; "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()} B "
          f"memory_reserved={torch.cuda.memory_reserved()} B; "
          f"{len(queries)} queries, sweep_block={SWEEP_BLOCK}")
    return gt, tips, eng, queries


def refill_path(g, obs=None) -> None:
    """The tailed scale-20 graph served four ways (batch, sync refill,
    overlap, stream), each warmed up; answers held against the oracle and
    across drivers, sync and overlap counters held equal, one pull and one
    fold launch per executed sweep (graph replays counted); with ``obs``,
    the overlap run once more with the observability plane on
    (:func:`refill_obs_run`); then ``PROFILED_REFILL_MODES`` on the first
    ``PROFILED_REFILL_QUERIES`` queries under ``torch.profiler`` for the
    device busy share, and one block timed both ways."""
    import numpy as np
    import torch
    from repro_torch.core import oracle as O
    from repro_torch.serve import QueryKind as K

    gt, tips, eng, queries = refill_engine(g)
    runs = {}
    for mode in ("batch", "sync", "overlap", "stream"):
        torch.cuda.reset_peak_memory_stats()
        r = runs[mode] = drive(eng, mode, queries)
        st, la, bl = r["stats"], r["launches"], r["blocks"]
        fusion = (f"{st['sweeps'] / st['sweep_blocks']:.3f}"
                  if st["sweep_blocks"] else "-")
        print(f"refill {mode}: {len(queries)} queries in {r['time_s']:.3f} s "
              f"= {len(queries) / r['time_s']:.2f} queries/s; sweeps="
              f"{r['sweeps']} executed={r['executed']} refills="
              f"{st['refills']} lane_utilization="
              f"{st['lane_sweeps_busy'] / max(st['lane_sweeps_total'], 1):.4f}"
              f" sweep_blocks={st['sweep_blocks']} fusion={fusion} gated "
              f"sweeps={bl['gated']} ({bl['gated_ms']:.2f} ms device) "
              f"replays={bl['replays']} launches={la} "
              f"max_memory_allocated={torch.cuda.max_memory_allocated()} B")
        check(la["ell_pull_multi"] == r["executed"]
              and la["mask_reduce"] == r["executed"],
              f"refill {mode}: one pull and one fold launch per sweep")
        check(la["ell_pull"] == la["payload_min_fold"] == 0,
              f"refill {mode}: no single-source kernel")
        if mode in ("overlap", "stream"):
            check(r["replayed"]["ell_pull_multi"] == bl["replays"] > 0,
                  f"refill {mode}: the sweeps are graph replays")
            check(bl["sweeps"] - bl["gated"] >= st["sweeps"],
                  f"refill {mode}: executed sweeps cover the schedule")
        if mode == "overlap":
            check(bl["sweeps"] - bl["gated"] == st["sweeps"],
                  "refill overlap: every ungated sweep is in the schedule")
    s_sync, s_over = runs["sync"]["stats"], runs["overlap"]["stats"]
    for key in s_sync:
        if key != "sweep_blocks":
            check(s_sync[key] == s_over[key],
                  f"sync and overlap counters equal: {key}")
    check(s_over["sweep_blocks"] > 0 and s_sync["nn_overflow"] == 0,
          "overlap ran blocks; no nn slot dropped")
    base = runs["batch"]["results"]
    for mode in ("sync", "overlap", "stream"):
        got = runs[mode]["results"]
        check(set(got) == set(base), f"{mode}: every query answered")
        for q, a in base.items():
            b = got[q]
            check(a == b if isinstance(a, dict) else np.array_equal(a, b),
                  f"{mode} answer equals batch: {q}")
    csr = O.csr_from_coo(gt)
    checked, tips_ok = {}, 0
    for q, a in base.items():
        tip = q.source in tips
        if not tip and checked.get(q.kind, 0) >= 2:
            continue
        if q.kind is K.LEVELS:
            ok = np.array_equal(a, O.bfs_levels(gt, q.source, csr))
        elif q.kind is K.REACHABILITY:
            ok = np.array_equal(a, O.reachable_mask(gt, q.source, csr))
        elif q.kind is K.DISTANCE_LIMITED:
            ok = np.array_equal(a, O.bfs_levels_limited(gt, q.source,
                                                        q.max_depth, csr))
        else:
            ok = a == O.target_depths(gt, q.source, q.targets, csr)
        check(ok, f"refill oracle: {q}")
        tips_ok += tip
        checked[q.kind] = checked.get(q.kind, 0) + 1
    check(tips_ok == len(tips) and all(
        checked.get(k, 0) >= 2 for k in (K.LEVELS, K.REACHABILITY,
                                         K.DISTANCE_LIMITED, K.MULTI_TARGET)),
          "refill oracle: every tip and two answers per kind")
    print(f"refill oracle: {tips_ok} tips and "
          f"{dict((k.value, v) for k, v in checked.items())} answers exact; "
          "the four drivers agree; sync and overlap counters equal but "
          "sweep_blocks")
    if obs is not None:
        refill_obs_run(eng, queries, tips, runs["overlap"], obs)
    sub = queries[:PROFILED_REFILL_QUERIES]
    for mode in PROFILED_REFILL_MODES:
        r, prof = runs[mode], {}
        per_launch = profile_run(
            lambda m=mode: drive(eng, m, sub),
            lambda out, m=mode: f"refill {m}, {len(sub)} queries, "
            f"sweeps={out['sweeps']}",
            ("pull_rows_kernel<pull::WordGather", "mask_reduce_apply_kernel"),
            into=prof)
        idle_us = ((prof["wall_ms"] - prof["busy_ms"]) * 1e3
                   / max(prof["out"]["executed"], 1))
        print(f"refill {mode} (profiled): device busy share "
              f"{prof['busy_ms'] / prof['wall_ms']:.3f}, "
              f"host time per executed sweep (wall - device busy) "
              f"{idle_us:.0f} us; unprofiled wall per sweep "
              f"{r['time_s'] * 1e6 / max(r['executed'], 1):.0f} us; "
              f"{ {k[:30]: round(v, 1) for k, v in per_launch.items()} } "
              "us per launch")
    block_both_ways(eng, queries, tips)
    lookahead_phase(eng, queries, s_sync)


# -----------------------------------------------------------------------------
# The observability plane and the multi-tenant frontend (A11)

#: the spans and instants the obs phase's exported trace must hold
OBS_EVENTS = ("serve.batch", "serve.gather", "serve.dedup",
              "serve.refill_drain", "serve.session.open",
              "serve.session.close", "serve.reseed", "serve.boundary",
              "serve.gather.deferred", "serve.sweep", "serve.block.dispatch",
              "serve.block.wait", "serve.block.speculate",
              "serve.submit_stream", "serve.cache.hit",
              "serve.component.hit", "serve.poll")
#: frontend phase: queries a tenant submits, per round, and the warmer's
#: budget of sources a graph; the second graph relabels v -> (v + p) % n
#: (the reference tests' construction: the same degrees, other edges)
TENANT_QUERIES, TENANT_CHUNK, WARM_BUDGET = 16, 4, 8
FRONTEND_SHIFT = P_RANK * P_GPU


def gib(nbytes: float) -> str:
    return f"{nbytes / 2**30:.3f} GiB"


def pool_bytes(pool) -> int:
    """Bytes the caching allocator holds in the graph memory pool
    ``pool`` (a ``graph_pool_handle()``): the segments of that pool in a
    memory snapshot."""
    import torch

    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


def obs_serving(eng, g, hplan, queries, answers, main_stats, obs) -> dict:
    """The 64-query serving run on fresh engines over the main partition,
    three ways: obs off, obs on (``obs``, the phase's plane) and
    ``profile=`` a :class:`DispatchProfiler`; every ServeStats field (equal
    to the main run's), answer, launch and replay count equal across the
    three; queries/s of each and the profiler's dispatch latencies
    printed. Then, on the obs engine: memo hits (cache, component) and a
    per-sweep refill drain with duplicates; one ``trace_session()`` on the
    profiled engine writes its file; a lane batch with ``telemetry=True``
    fills ``last_telemetry``, its ``device.shard.<i>.wire_bytes`` summing
    to the state's wire counters."""
    import json
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch.core import msbfs as M, oracle as O
    from repro_torch.graphs.rmat import pick_sources
    from repro_torch.kernels import ops
    from repro_torch.obs import DispatchProfiler, Observability
    from repro_torch.serve import BFSServeEngine, Query, QueryKind as K

    pg = eng.pg
    tmp = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    prof = DispatchProfiler(trace_dir=tmp)
    ways = {"off": lambda: {}, "obs": lambda: dict(obs=obs),
            "profile": lambda: dict(profile=prof)}
    qps = {name: [] for name in ways}
    runs, engines = {}, {}
    # two turns, the second in reverse order, each on fresh engines
    for name in list(ways) + list(ways)[::-1]:
        e = BFSServeEngine(pg=pg, plan=hplan, device=DEVICE, **ways[name]())
        e.warmup(reachability=True, targets=True)
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        got = e.submit_many(queries)
        torch.cuda.synchronize()
        qps[name].append(len(queries) / (time.perf_counter() - t0))
        runs[name] = dict(stats=e.stats.as_dict(),
                          launches=dict(ops.LAUNCHES),
                          replayed=dict(ops.REPLAYED),
                          sweeps=e.traversal_sweeps)
        check(all(answers_equal(a, b) for a, b in zip(got, answers)),
              f"obs {name}: answers equal the main run's")
        engines[name] = e
    for name, r in runs.items():
        check(r["stats"] == main_stats,
              f"obs {name}: every ServeStats field equals the main run's")
        check(r["launches"] == runs["off"]["launches"]
              and r["replayed"] == runs["off"]["replayed"],
              f"obs {name}: launches and replays equal obs off")
        check(r["launches"]["ell_pull_multi"] == r["sweeps"]
              == r["launches"]["mask_reduce"],
              f"obs {name}: one B1 and one B2 launch a sweep")
    lat = prof.summary()["dispatch_latency_s"]["batch"]
    check(prof.sampled == prof.dispatches == lat["count"] > 0,
          "profile: every batch dispatch sampled")
    print(f"obs ({card_line()}): {len(queries)} queries, sweeps="
          f"{runs['off']['sweeps']}; queries/s in turns (off, obs, profile, "
          f"then reversed): off {[round(q, 2) for q in qps['off']]}, obs on "
          f"{[round(q, 2) for q in qps['obs']]}, profile=True "
          f"{[round(q, 2) for q in qps['profile']]}; every ServeStats field, "
          f"answer, launch and replay equal; profiler: {lat['count']} batch "
          f"dispatches over both turns, p50 {lat['p50'] * 1e3:.2f} ms, p99 "
          f"{lat['p99'] * 1e3:.2f} ms, max {lat['max'] * 1e3:.2f} ms")

    # memo hits, and a per-sweep refill drain with duplicates (obs engine)
    e = engines["obs"]
    hits0, comp0 = e.stats.cache_hits, e.stats.component_hits
    e.submit_many(queries[:4])
    check(e.stats.cache_hits == hits0 + len(set(queries[:4])),
          "obs: cache hits")
    i = next(i for i, q in enumerate(queries) if q.kind is K.REACHABILITY)
    asked = {q.source for q in queries}
    other = next(int(v) for v in np.nonzero(answers[i])[0]
                 if int(v) not in asked)
    e.submit_many([Query(other, K.REACHABILITY)])
    check(e.stats.component_hits == comp0 + 1, "obs: a component hit")
    e.refill = True
    drain = [Query(int(s)) for s in pick_sources(g, 8, seed=13)]
    t0 = time.perf_counter()
    got = e.run_refill_queries(drain + drain[:2])
    dt = time.perf_counter() - t0
    e.refill = False
    check(set(got) == set(drain), "obs: the refill drain answered")
    check(np.array_equal(got[drain[0]], O.bfs_levels(g, drain[0].source)),
          "obs: refill drain oracle")
    print(f"obs probes: {len(set(queries[:4]))} cache hits, 1 component "
          f"hit, a per-sweep refill drain of {len(drain)} (+2 duplicates) "
          f"in {dt:.3f} s")

    # one torch.profiler session of the profiled engine
    batch = list(dict.fromkeys(queries))[:32]
    check(prof.start_trace() is True, "trace_session: a capture started")
    engines["profile"].run_batch_queries(batch)
    torch.cuda.synchronize()
    prof.stop_trace()
    path = prof.trace_path
    check(path is not None and os.path.exists(path),
          "trace_session: the trace file was written")
    doc = json.loads(open(path).read())
    kernels = [ev for ev in doc["traceEvents"] if ev.get("cat") == "kernel"]
    print(f"trace_session: {os.path.basename(path)}, "
          f"{os.path.getsize(path)} B, {len(doc['traceEvents'])} events, "
          f"{len(kernels)} kernel records")
    check(kernels, "trace_session: kernel records in the trace")
    del engines, e
    shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()

    # telemetry harvested into last_telemetry and the device metrics
    te = BFSServeEngine(pg=pg, plan=hplan, device=DEVICE,
                        cfg=M.MSBFSConfig(telemetry=True),
                        obs=Observability())
    te.run_batch_queries(batch)
    tel, st = te.last_telemetry, te.stats
    gauges = te.obs.metrics.snapshot()["gauges"]
    shard = [gauges[f"device.shard.{i}.wire_bytes"] for i in range(pg.p)]
    check(tel is not None and tel.sweeps == te.traversal_sweeps,
          "telemetry: last_telemetry filled")
    check(sum(shard) == st.wire_delegate_bytes + st.wire_nn_bytes,
          "telemetry: shard wire bytes sum to the wire counters")
    print(f"telemetry: sweeps={tel.sweeps} device.shard.i.wire_bytes="
          f"{shard} (sum {sum(shard)} = wire_delegate {st.wire_delegate_bytes}"
          f" + wire_nn {st.wire_nn_bytes}); frontier per shard "
          f"{tel.shard_frontier().tolist()}, frontier_skew "
          f"{gauges['device.frontier_skew']:.4f}")
    del te
    torch.cuda.empty_cache()
    return dict(qps=qps, p50_ms=lat["p50"] * 1e3, p99_ms=lat["p99"] * 1e3)


def refill_obs_run(eng, queries, tips, base: dict, obs) -> None:
    """The 120-query overlap run of the refill path once more, on an engine
    of the same partition with the obs plane ``obs`` on (its blocks
    captured into the refill engine's pool): every ServeStats field,
    answer, launch and replay equal the obs-off run ``base``; queries/s of
    it, of ``base`` and of the obs-off run once more after it printed. Then a short stream on it, and the plane's exported
    trace must parse as Chrome JSON and hold every name of
    ``OBS_EVENTS``."""
    import json
    import os
    import tempfile

    import torch
    from repro_torch.core import engine as TE
    from repro_torch.serve import BFSServeEngine, Query, QueryKind as K

    t0 = time.perf_counter()
    e = BFSServeEngine(pg=eng.pg, plan=TE.build_exchange_plan(eng.pg),
                       cfg=eng.cfg, cache_capacity=0, reuse_components=False,
                       refill=True, overlap=True, sweep_block=SWEEP_BLOCK,
                       device=DEVICE, obs=obs, runner_cache=eng._runners)
    e.warmup(reachability=True, targets=True)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    r = drive(e, "overlap", queries)
    check(r["stats"] == base["stats"],
          "refill overlap, obs on: every ServeStats field equals obs off")
    check(r["launches"] == base["launches"]
          and r["replayed"] == base["replayed"]
          and r["blocks"]["gated"] == base["blocks"]["gated"],
          "refill overlap, obs on: launches, replays, gated sweeps equal")
    check(all(answers_equal(r["results"][q], a)
              for q, a in base["results"].items()),
          "refill overlap, obs on: answers equal obs off")
    again = drive(eng, "overlap", queries)
    check(again["stats"] == base["stats"], "refill overlap: obs off again")
    print(f"refill overlap, obs on ({card_line()}): {len(queries)} queries "
          f"in {r['time_s']:.3f} s = {len(queries) / r['time_s']:.2f} "
          f"queries/s (obs off, before and after: "
          f"{len(queries) / base['time_s']:.2f}, "
          f"{len(queries) / again['time_s']:.2f}); sweeps={r['sweeps']} "
          f"sweep_blocks={r['stats']['sweep_blocks']}; counters, launches, "
          f"replays and answers equal; engine set-up and captures "
          f"{t_setup:.1f} s")
    core = [q.source for q in queries if q.source not in tips][:2]
    e.submit_stream([Query(s, K.DISTANCE_LIMITED, max_depth=1)
                     for s in core])
    got = e.poll()
    got.update(e.drain_stream())
    check(len(got) == len(core), "obs stream: every query delivered")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        path = os.path.join(tmp, "serve_trace.json")
        obs.export(path)
        doc = json.loads(open(path).read())
        size = os.path.getsize(path)
    names = {ev["name"] for ev in doc["traceEvents"]}
    missing = [n for n in OBS_EVENTS if n not in names]
    snap = obs.metrics.snapshot()
    print(f"obs trace: {len(doc['traceEvents'])} events ({size} B, "
          f"{obs.trace.dropped} dropped), {len(names)} names; metrics: "
          f"{len(snap['counters'])} counters, {len(snap['gauges'])} gauges, "
          f"{len(snap['histograms'])} histograms")
    check(not missing, f"obs trace holds every span name (missing {missing})")
    check(obs.trace.dropped == 0, "obs trace: nothing dropped")
    del e
    torch.cuda.empty_cache()


def tenant_traffic(graphs: dict) -> dict:
    """Four tenants, a latency-class and a throughput-class one on each
    graph: ``TENANT_QUERIES`` disjoint sources each (``pick_sources(g, 32,
    seed=31 + graph)``), a MULTI_TARGET query first, then LEVELS,
    REACHABILITY and DISTANCE_LIMITED (max_depth 3) cycled: 5 / 5 / 5 / 1
    a tenant, as ``BENCH_serving.json`` ``frontend`` has."""
    from repro_torch.graphs.rmat import pick_sources
    from repro_torch.serve import (Query, QueryKind as K, SLO_LATENCY,
                                   SLO_THROUGHPUT)

    cycle = (K.LEVELS, K.REACHABILITY, K.DISTANCE_LIMITED)
    tenants = {}
    for gi, (name, (g, _)) in enumerate(graphs.items()):
        srcs = [int(s) for s in pick_sources(g, 2 * TENANT_QUERIES,
                                             seed=31 + gi)]
        for half, slo in enumerate((SLO_LATENCY, SLO_THROUGHPUT)):
            mine = srcs[half * TENANT_QUERIES:(half + 1) * TENANT_QUERIES]
            qs = [Query(mine[0], K.MULTI_TARGET, targets=tuple(srcs[:2]))]
            qs += [Query(s, cycle[i % 3], max_depth=3 if i % 3 == 2
                         else None) for i, s in enumerate(mine[1:])]
            tenants[f"tenant{2 * gi + half}"] = (name, slo, qs)
    return tenants


def frontend_mux(ft, tenants: dict) -> tuple:
    """Round-robin chunks of ``TENANT_CHUNK`` with a blocking ``poll()``
    between rounds, then ``drain()``. Returns the answers by tenant and
    the number of rounds after which both engines had lanes busy."""
    sessions = {t: ft.open_session(t, g, slo=slo)
                for t, (g, slo, _) in tenants.items()}
    answers = {t: {} for t in tenants}

    def take(out):
        for sid, res in out.items():
            answers[sid.split(":", 1)[0]].update(res)

    both = 0
    for r in range(-(-TENANT_QUERIES // TENANT_CHUNK)):
        for t, (_, _, qs) in tenants.items():
            ft.submit(sessions[t], qs[r * TENANT_CHUNK:(r + 1) * TENANT_CHUNK])
        take(ft.poll(wait=True))
        both += all(e.stream_status()["busy"] > 0
                    for e in ft.engines.values())
    take(ft.drain())
    return answers, both


def frontend_seq(ft, tenants: dict, tag: str) -> dict:
    """Each tenant submitted whole and drained before the next."""
    answers = {}
    for t, (g, slo, qs) in tenants.items():
        sess = ft.open_session(t + tag, g, slo=slo)
        ft.submit(sess, qs)
        got = {}
        for res in ft.drain().values():
            got.update(res)
        answers[t] = got
    return answers


def frontend_path(g, pg, csr) -> dict:
    """The multi-tenant frontend over two scale-20 graphs: the main
    partition and a relabelled copy (``v -> (v + p) % n``, partitioned
    here), engines at W = 32 (refill, overlap, ``sweep_block=8``, no
    component reuse) sharing one runner cache -- one graph memory pool,
    whose ``memory_reserved`` is printed after each engine's captures.
    Four tenants (:func:`tenant_traffic`) multiplexed (both graphs'
    sessions in flight at once), then the same traffic back to back on
    the same engines (stream sessions closed, cache cleared): equal answers, TenantStats equal
    but ``peak_in_flight``, two answers a kind against the oracle, one B1
    and one B2 launch or replay per executed sweep of the mux run. Then a
    tenant under ``max_inflight`` has a burst rejected atomically,
    ``warm(budget=WARM_BUDGET)`` pre-computes the hottest uncached
    sources and their replay is served from the LRU. Prints mux and
    sequential queries/s, per-tenant p99 on the obs clock, sweeps and
    blocks per engine."""
    import gc

    import torch
    from repro_torch.core import oracle as O
    from repro_torch.core.partition import partition_graph
    from repro_torch.core.types import COOGraph
    from repro_torch.kernels import ops
    from repro_torch.obs import Observability, tenant_metric
    from repro_torch.serve import (Query, QueryKind as K, QuotaExceeded,
                                   SLO_THROUGHPUT, ServeFrontend, ServeStats,
                                   oracle_check)

    t0 = time.perf_counter()
    g2 = COOGraph(g.n, (g.src + FRONTEND_SHIFT) % g.n,
                  (g.dst + FRONTEND_SHIFT) % g.n)
    pg2 = partition_graph(g2, th=TH, p_rank=P_RANK, p_gpu=P_GPU)
    t_part = time.perf_counter() - t0
    graphs = {"g1": (g, pg), "g2": (g2, pg2)}
    obs = Observability()
    ft = ServeFrontend(obs=obs, device=DEVICE, reuse_components=False,
                       sweep_block=SWEEP_BLOCK)
    gc.collect()                  # earlier phases' captured graphs
    torch.cuda.empty_cache()
    reserved, pool = [torch.cuda.memory_reserved()], []
    t0 = time.perf_counter()
    for name, (_, p) in graphs.items():
        eng = ft.register_graph(name, pg=p)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved.append(torch.cuda.memory_reserved())
        eng.warmup(targets=True)
        # a throwaway stream query captures the stream session's block
        eng.submit_stream([Query(0, K.DISTANCE_LIMITED, max_depth=1)])
        eng.drain_stream()
        eng.stats = ServeStats()
        eng.cache.clear()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved.append(torch.cuda.memory_reserved())
        pool.append(pool_bytes(ft.runner_cache["graph_pool"]))
    t_setup = time.perf_counter() - t0
    check(len({id(b.pool) for e in ft.engines.values()
               for b in e.blocks.values()}) == 1
          and all(b.runner.graphs is not None for e in ft.engines.values()
                  for b in e.blocks.values()),
          "frontend: every engine's captured blocks in the one shared pool")
    views = [reserved[1] - reserved[0], reserved[3] - reserved[2]]
    print(f"frontend setup: relabelled copy partitioned in {t_part:.1f} s; "
          f"engines, warm-ups and captures {t_setup:.1f} s; "
          f"memory_reserved: views g1 {gib(views[0])}, g2 {gib(views[1])}, "
          f"after g1's captures +{gib(reserved[2] - reserved[1])}, after "
          f"g2's +{gib(reserved[4] - reserved[3])}; the shared graph pool "
          f"holds {gib(pool[0])} after g1's {len(ft.engines['g1'].blocks)} "
          f"captured blocks and {gib(pool[1])} after g2's "
          f"{len(ft.engines['g2'].blocks)} (g2 added "
          f"{gib(pool[1] - pool[0])}); total reserved {gib(reserved[-1])}")

    tenants = tenant_traffic(graphs)
    n_total = sum(len(qs) for _, _, qs in tenants.values())
    blocks0 = {n: block_totals(e) for n, e in ft.engines.items()}
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    mux, both = frontend_mux(ft, tenants)
    torch.cuda.synchronize()
    t_mux = time.perf_counter() - t0
    launches = {k: ops.LAUNCHES[k] + ops.REPLAYED[k] for k in ops.LAUNCHES}
    executed = sum(block_totals(e)["sweeps"] - blocks0[n]["sweeps"]
                   for n, e in ft.engines.items())
    mux_engines = {n: e.stats.as_dict() for n, e in ft.engines.items()}
    mux_tenants = {t: ft.tenant_stats(t).as_dict() for t in tenants}
    snap = obs.metrics.snapshot()["histograms"]
    p99 = {t: max(h["p99"] for k, h in snap.items()
                  if k.startswith(tenant_metric(t, "latency_s")))
           for t in tenants}
    check(both > 0, "frontend: both graphs' sessions in flight at once")
    check(launches["ell_pull_multi"] == executed == launches["mask_reduce"]
          and launches["ell_pull"] == 0,
          "frontend mux: one B1 and one B2 launch or replay a sweep")
    for t, (_, _, qs) in tenants.items():
        check(set(mux[t]) == set(qs) and mux_tenants[t]["delivered"]
              == len(qs), f"frontend mux: {t} got every answer")

    for e in ft.engines.values():
        # close the mux run's stream sessions (their dedup memory) and
        # forget its answers: the back-to-back run starts as the mux did
        check(e.drain_stream() == {}, "frontend mux: everything delivered")
        e.stats = ServeStats()
        e.cache.clear()
    t0 = time.perf_counter()
    seq = frontend_seq(ft, tenants, "-seq")
    torch.cuda.synchronize()
    t_seq = time.perf_counter() - t0
    for t, (gname, _, qs) in tenants.items():
        for q in qs:
            check(answers_equal(mux[t][q], seq[t][q]),
                  f"frontend: mux answer equals back to back: {t} {q}")
        a = {k: v for k, v in mux_tenants[t].items() if k != "peak_in_flight"}
        b = {k: v for k, v in ft.tenant_stats(t + "-seq").as_dict().items()
             if k != "peak_in_flight"}
        check(a == b, f"frontend: {t} TenantStats equal back to back")
    seq_sweeps = {n: (e.stats.sweeps, e.stats.sweep_blocks)
                  for n, e in ft.engines.items()}
    csr2 = O.csr_from_coo(g2)
    checked = {}
    for t, (gname, _, qs) in tenants.items():
        if t not in ("tenant0", "tenant2"):
            continue
        for q in qs:
            if checked.get((gname, q.kind), 0) >= 1:
                continue
            oracle_check(graphs[gname][0], q, mux[t][q],
                         csr if gname == "g1" else csr2)
            checked[(gname, q.kind)] = 1
    check(len(checked) == 8, "frontend: two answers a kind against the oracle")
    for n, st in mux_engines.items():
        print(f"frontend mux engine {n}: sweeps={st['sweeps']} "
              f"sweep_blocks={st['sweep_blocks']} lanes_used="
              f"{st['lanes_used']} kind_counts={st['kind_counts']} "
              f"lane_utilization="
              f"{st['lane_sweeps_busy'] / max(st['lane_sweeps_total'], 1):.4f}")
    print(f"frontend ({card_line()}): {n_total} queries, 4 tenants on 2 "
          f"graphs; mux {t_mux:.3f} s = {n_total / t_mux:.2f} queries/s "
          f"(both graphs busy after {both} of "
          f"{-(-TENANT_QUERIES // TENANT_CHUNK)} polls; {executed} executed "
          f"sweeps, launches {launches}); back to back {t_seq:.3f} s = "
          f"{n_total / t_seq:.2f} queries/s (sweeps, blocks by engine "
          f"{seq_sweeps}); per-tenant p99 (obs clock) "
          f"{ {t: round(v * 1e3, 1) for t, v in p99.items()} } ms; "
          f"answers and TenantStats equal, oracle {len(checked)} exact")

    # a tenant under max_inflight: a burst rejected whole
    e1 = ft.engines["g1"]
    sess = ft.open_session("quota", "g1", slo=SLO_THROUGHPUT,
                           max_inflight=TENANT_CHUNK)
    extra = [Query(int(s)) for s in range(1000, 1000 + 2 * TENANT_CHUNK)]
    ft.submit(sess, extra[:TENANT_CHUNK])
    pre = e1.stats.queries
    try:
        ft.submit(sess, extra[TENANT_CHUNK:])
        rejected = False
    except QuotaExceeded:
        rejected = True
    ts = ft.tenant_stats("quota")
    check(rejected and ts.rejected == TENANT_CHUNK
          and ts.in_flight == TENANT_CHUNK and e1.stats.queries == pre,
          "frontend quota: the burst rejected whole, nothing admitted")
    ft.drain()
    ft.submit(sess, extra[TENANT_CHUNK:])
    got = ft.drain()[sess.sid]
    check(set(got) == set(extra[TENANT_CHUNK:]), "frontend quota: retried")

    # traffic-skew warming, then a replay served by the LRU
    t0 = time.perf_counter()
    picked = ft.warm(budget=WARM_BUDGET)
    t_warm = time.perf_counter() - t0
    check(all(0 < len(v) <= WARM_BUDGET for v in picked.values()),
          "frontend warm: sources picked on each graph")
    replay = {n: ft.open_session(f"replay-{n}", n) for n in picked}
    pre = {n: ft.tenant_stats(f"replay-{n}").cache_hits for n in picked}
    for n, srcs in picked.items():
        ft.submit(replay[n], [Query(s) for s in srcs])
    ft.drain()
    hits = {n: ft.tenant_stats(f"replay-{n}").cache_hits - pre[n]
            for n in picked}
    check(all(hits[n] == len(picked[n]) for n in picked),
          "frontend warm: the replay served from the LRU")
    print(f"frontend quota: a burst of {TENANT_CHUNK} over max_inflight="
          f"{TENANT_CHUNK} rejected whole, then served; warm(budget="
          f"{WARM_BUDGET}) {t_warm:.3f} s picked "
          f"{ {n: len(v) for n, v in picked.items()} } sources, the replay "
          f"{hits} cache hits")
    out = dict(qps_mux=n_total / t_mux, qps_seq=n_total / t_seq,
               pool=pool, p99_ms={t: v * 1e3 for t, v in p99.items()})
    del ft
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- recsys path

# -----------------------------------------------------------------------------
# Comm strategies and the sharded drivers (A3, A7)

#: (delegate combine, nn format) of the emulated strategy runs; "sparse" is
#: pinned with a cap of every slot (it never drops, so the answers can be
#: held to the default run's)
STRATEGY_RUNS = (("ring", "dense"), ("hier", "adaptive"),
                 ("allgather", "adaptive"), ("allgather", "sparse"))
#: the world-1 NCCL phase's graph: scale 16 (cut from 20: partitioning a
#: second scale-20 graph for p = 1 costs about 30 s of the run)
SHARDED_SCALE = 16
WORLD_TIMEOUT = 300.0
STRATEGY_TURNS = 2          # each strategy's serving run, timed in turns


def answers_equal(a, b) -> bool:
    import numpy as np

    if isinstance(b, dict):
        return a == b
    return a.dtype == b.dtype and np.array_equal(a, b)


def digest(a) -> str:
    """A served answer's content digest (a rank returns digests, not the
    answers' bytes, across its process boundary)."""
    import hashlib

    import numpy as np

    if isinstance(a, dict):
        return repr(sorted(a.items()))
    a = np.ascontiguousarray(a)
    return f"{a.dtype}:{a.shape}:" + hashlib.sha256(a.tobytes()).hexdigest()


def strategy_serving(eng, hplan, queries, want) -> None:
    """The 64-query serving run under each of ``STRATEGY_RUNS`` on the
    engine's partition (emulated, p = 2), beside the default allgather /
    dense configuration on a fresh engine of its own, each timed twice in
    turns (``STRATEGY_TURNS``): answers equal the main run's,
    ``wire_delegate_bytes`` the plan formula times sweeps times p, no slot
    dropped; queries/s, sparse sweeps and launches a sweep printed."""
    import torch
    from repro_torch.core import comm as C
    from repro_torch.kernels import ops
    from repro_torch.serve import BFSServeEngine

    pg = eng.pg
    runs = [("allgather", "dense")] + list(STRATEGY_RUNS)
    qps = {r: [] for r in runs}
    for turn in range(STRATEGY_TURNS):
        for delegate, nn in runs:
            comm = C.CommConfig(delegate=delegate, nn=nn,
                                sparse_cap=hplan.cap_peer if nn == "sparse"
                                else 0)
            e = BFSServeEngine(pg=pg, plan=hplan, comm=comm, device=DEVICE)
            e.warmup(reachability=True, targets=True)
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            got = e.submit_many(queries)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            qps[(delegate, nn)].append(len(queries) / dt)
            la, st, sweeps = dict(ops.LAUNCHES), e.stats, e.traversal_sweeps
            per = C.plan_for(comm, pg.p).delegate_bytes(
                max(pg.d, 1) * C.n_words(e.cfg.n_queries), 4)
            name = f"{delegate}/{nn}"
            check(all(answers_equal(a, b) for a, b in zip(got, want)),
                  f"{name}: answers equal the main run's")
            check(st.wire_delegate_bytes == sweeps * pg.p * per,
                  f"{name}: wire_delegate = formula x sweeps x p")
            check(st.nn_overflow == 0, f"{name}: no nn slot dropped")
            check(la["ell_pull_multi"] == sweeps
                  and la["mask_reduce"] == sweeps,
                  f"{name}: one B1 and one B2 launch a sweep")
            if turn == STRATEGY_TURNS - 1:
                print(f"strategy {name} ({card_line()}): queries/s "
                      f"{[round(q, 1) for q in qps[(delegate, nn)]]} (turns), "
                      f"sweeps={sweeps}, nn_sparse_sweeps="
                      f"{st.nn_sparse_sweeps}, wire_delegate_bytes="
                      f"{st.wire_delegate_bytes} ({per} B a combine), "
                      f"wire_nn_bytes={st.wire_nn_bytes}, B1 "
                      f"{la['ell_pull_multi'] / sweeps:.2f} and B2 "
                      f"{la['mask_reduce'] / sweeps:.2f} launches a sweep; "
                      "answers equal the main run's")
            del e
            torch.cuda.empty_cache()


def strategy_bfs(eng, hplan, g, csr, full) -> None:
    """4 FULL search keys with the static exchange under the adaptive and
    (pinned, every slot) sparse bit formats: levels equal the FULL run's,
    ``wire_delegate`` the plan formula times sweeps times p."""
    from dataclasses import replace

    from repro_torch.core import comm as C
    from repro_torch.serve import BFSServeEngine

    sub = full[:N_VARIANT_KEYS]
    teps = lambda recs: len(recs) / sum(r["time_s"] / r["edges"]
                                        for r in recs)
    print(f"strategies, single source ({card_line()}): FULL on these keys "
          f"TEPS={teps(sub):.4e}, ms {[round(r['time_s'] * 1e3, 1) for r in sub]}")
    pg = eng.pg
    for nn in ("adaptive", "sparse"):
        comm = C.CommConfig(nn=nn, sparse_cap=hplan.cap_peer
                            if nn == "sparse" else 0)
        cfg = replace(bfs_configs()["FULL"], static_exchange=True, comm=comm)
        e = BFSServeEngine(pg=pg, plan=hplan, comm=comm, device=DEVICE)
        run_bfs_keys(e, g, cfg, [sub[0]["src"]], csr,
                     want_levels=[sub[0]["levels"]])          # warm-up
        recs = run_bfs_keys(e, g, cfg, [r["src"] for r in sub], csr,
                            want_levels=[r["levels"] for r in sub])
        check_bfs_launches(recs, f"static {nn}")
        per = C.plan_for(comm, pg.p).delegate_bytes(max(pg.d, 1), 4, "min")
        for r in recs:
            check(r["wire_delegate"] == r["sweeps"] * pg.p * per,
                  f"static {nn}: wire_delegate = formula x sweeps x p")
        print(f"strategy static/{nn}: {len(recs)} keys equal the FULL run; "
              f"TEPS={teps(recs):.4e}; ms "
              f"{[round(r['time_s'] * 1e3, 1) for r in recs]} sweeps "
              f"{[r['sweeps'] for r in recs]} nn_sparse_sweeps "
              f"{[r['nn_sparse'] for r in recs]} wire_nn "
              f"{[r['wire_nn'] for r in recs]}")
        del e


def _states_equal(a, b, leaves, what: str) -> None:
    import torch

    for k in leaves:
        check(torch.equal(getattr(a, k), getattr(b, k)), f"{what}: {k}")


def _teardown(what: str) -> None:
    """Destroy the process group in a thread: a communicator whose
    collectives were captured in CUDA graphs can hang its teardown (seen
    under NCCL 2.28); the run goes on (and ends with ``os._exit``)."""
    import threading

    import torch.distributed as dist

    t = threading.Thread(target=dist.destroy_process_group, daemon=True)
    t.start()
    t.join(timeout=20)
    print(f"{what}: process group teardown "
          f"{'done' if not t.is_alive() else 'still running after 20 s'}")


def sharded_nccl_phase(backend: str = "nccl") -> None:
    """The sharded drivers in this process on a world of one rank under
    NCCL (a p = 1 partition of a scale-16 graph): ``make_sharded_msbfs``,
    two sweeps of ``make_sharded_msbfs_step``, a block of
    ``make_sharded_msbfs_block`` captured as CUDA graphs and the same
    block eagerly, a payload lane batch through the sharded run and a
    captured sharded block, and ``make_sharded_bfs`` with and without the
    static plan, each against the emulated run on the same views, every
    leaf."""
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.core import bfs as TB, comm as C, engine as TE
    from repro_torch.core import msbfs as TM
    from repro_torch.core.partition import partition_graph
    from repro_torch.graphs.rmat import pick_sources, rmat_graph
    from repro_torch.kernels import ops

    t_start = time.perf_counter()
    g = rmat_graph(SHARDED_SCALE, seed=0)
    pg = partition_graph(g, th=TH, p_rank=1, p_gpu=1)
    pgv = TB.device_view(pg, DEVICE)
    plan = TE.device_plan(TE.build_exchange_plan(pg), DEVICE)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous",
                            rank=0, world_size=1)
    mesh = C.dist.PartitionMesh(("p",), (1,))
    axes = mesh.axes
    cfg = TM.MSBFSConfig(n_queries=32, max_iters=64)
    srcs = [int(s) for s in pick_sources(g, 32, seed=1)]
    sync = torch.cuda.synchronize
    init = lambda m: TM.init_multi_state(pg, srcs, cfg, device=DEVICE, mesh=m)

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    run = TM.make_sharded_msbfs(mesh, axes, cfg)
    first_ms = timed(lambda: run(pgv, plan, init(mesh)))[1]   # communicators
    emu_ms, sh_ms = [], []
    for _ in range(2):                                          # in turns
        emu, t = timed(lambda: TM.run_msbfs_emulated(pgv, plan, init(None),
                                                     cfg))
        emu_ms.append(round(t, 1))
        ops.reset_launches()
        sh, t = timed(lambda: run(pgv, plan, init(mesh)))
        sh_ms.append(round(t, 1))
        launches = dict(ops.LAUNCHES)
    _states_equal(sh, emu, TM.STATE_LEAVES, "sharded msBFS (world 1)")
    sweeps = int(sh.it[0])
    check(launches["ell_pull_multi"] == sweeps
          and launches["mask_reduce"] == sweeps,
          "sharded msBFS: one B1 and one B2 launch a sweep")
    step = TM.make_sharded_msbfs_step(mesh, axes, cfg)
    a, b = init(mesh), init(None)
    for _ in range(2):
        a = step(pgv, plan, a)
        b = TM.msbfs_step_emulated(pgv, plan, b, cfg)
    _states_equal(a, b, TM.STATE_LEAVES, "sharded step (world 1)")
    watch = [True] + [False] * (cfg.n_queries - 1)
    blocks = {}
    for name, graph in (("graph", None), ("eager", False)):
        blk = TM.make_sharded_msbfs_block(mesh, axes, cfg, 4, graph=graph)
        r = blk(pgv, plan, init(mesh), watch)
        r.wait()
        blk.runner.drain()
        blocks[name] = (r.out, blk.runner)
    check((blocks["graph"][1].graphs is not None) == (DEVICE == "cuda")
          and blocks["eager"][1].graphs is None,
          "the NCCL block is captured, the eager one is not")
    ref_blk = TM.make_msbfs_block_emulated(cfg, 4)(pgv, plan, init(None),
                                                   watch)
    ref_blk.wait()
    _states_equal(blocks["graph"][0], blocks["eager"][0], TM.STATE_LEAVES,
                  "captured block = eager block")
    _states_equal(blocks["graph"][0], ref_blk.out, TM.STATE_LEAVES,
                  "sharded block = emulated block")
    replays = blocks["graph"][1].replays
    # (e) of the payload path: one payload lane batch (SSSP, components and
    # bit lanes) through the sharded run and a captured sharded block
    pcfg = TM.MSBFSConfig(n_queries=32, max_iters=384, payload=True,
                          enable_targets=False)
    modes = ["sssp"] * 16 + ["components"] * 8 + [None] * 8
    pinit = lambda m: TM.init_multi_state(pg, srcs, pcfg, payload_modes=modes,
                                          device=DEVICE, mesh=m)
    pe, pe_ms = timed(lambda: TM.run_msbfs_emulated(pgv, plan, pinit(None),
                                                    pcfg))
    ps, ps_ms = timed(lambda: TM.make_sharded_msbfs(mesh, axes, pcfg)(
        pgv, plan, pinit(mesh)))
    _states_equal(ps, pe, TM.STATE_LEAVES, "sharded payload msBFS (world 1)")
    check(int(ps.wire_pay_nn.sum()) == 0 and bool(ps.done.all()),
          "sharded payload msBFS: converged (p = 1 ships nothing)")
    pblk = TM.make_sharded_msbfs_block(mesh, axes, pcfg, 4)
    r = pblk(pgv, plan, pinit(mesh), watch)
    r.wait()
    pblk.runner.drain()
    ref_blk = TM.make_msbfs_block_emulated(pcfg, 4)(pgv, plan, pinit(None),
                                                    watch)
    ref_blk.wait()
    _states_equal(r.out, ref_blk.out, TM.STATE_LEAVES,
                  "sharded payload block = emulated block")
    check((pblk.runner.graphs is not None) == (DEVICE == "cuda"),
          "the payload NCCL block is captured")
    payload_line = (f"payload batch (16 SSSP, 8 components, 8 bit lanes) "
                    f"{int(ps.it[0])} sweeps sharded {ps_ms:.1f} ms, emulated "
                    f"{pe_ms:.1f} ms, every leaf equal; payload block of 4 "
                    f"captured = emulated")
    bfs_ms = {}
    for with_plan in (False, True):
        bcfg = TB.BFSConfig(max_iters=64, pull_chunk=64,
                            static_exchange=with_plan)
        pl = plan if with_plan else None
        src = srcs[0]
        e, e_ms = timed(lambda: TB.run_bfs_emulated(
            pgv, TB.init_state(pg, src, bcfg, device=DEVICE), bcfg, pl))
        runb = TB.make_sharded_bfs(mesh, axes, bcfg, with_plan=with_plan)
        st = TB.init_state(pg, src, bcfg, device=DEVICE, mesh=mesh)
        s, s_ms = timed(lambda: runb(pgv, plan, st) if with_plan
                        else runb(pgv, st))
        _states_equal(s, e, TB.STATE_LEAVES,
                      f"sharded BFS (world 1, plan={with_plan})")
        bfs_ms[with_plan] = (s_ms, e_ms, int(s.it[0]))
    print(f"sharded, world 1, NCCL ({card_line()}; scale {SHARDED_SCALE}, "
          f"p = 1): msBFS {sweeps} sweeps sharded {sh_ms} ms (first call, "
          f"with the communicators' set-up, {first_ms:.1f}), emulated "
          f"{emu_ms} ms (turns), every leaf equal; step x2 equal; block of 4 "
          f"captured ({replays} replays) = eager = emulated; BFS binned "
          f"{bfs_ms[False][0]:.1f} ms (emulated {bfs_ms[False][1]:.1f}, "
          f"{bfs_ms[False][2]} sweeps), static {bfs_ms[True][0]:.1f} ms "
          f"(emulated {bfs_ms[True][1]:.1f}, {bfs_ms[True][2]} sweeps), equal; "
          f"{payload_line}; phase {time.perf_counter() - t_start:.1f} s")
    del blocks, pblk
    _teardown("world 1")


def world2_rank(rank: int, world: int, spec: dict) -> dict:
    """One rank of the world-2 phase: its partition's rows from the file
    the parent wrote, an engine on a two-rank mesh (gloo, CUDA tensors on
    the one card), the 64-query serving run and the FULL search keys.
    Returns digests of the answers and levels, the stats and counters."""
    import json as _json

    import numpy as np
    import torch
    from repro_torch.core import bfs as TB, comm as C, convert
    from repro_torch.kernels import ops
    from repro_torch.serve import BFSServeEngine, Query, QueryKind

    dev = spec["device"]
    if dev == "cuda":
        torch.cuda.set_device(0)
    t0 = time.perf_counter()
    part = np.load(f"{spec['dir']}/part{rank}.npz")
    meta = _json.loads(part["meta"].item())
    pg = convert.partition_from_arrays(part, meta["pg"])
    plan = convert.plan_from_arrays(part, meta["plan"])
    # the partition's own axes, (p_rank, p_gpu) = (1, 2), under the
    # two-level combine: a fold over "rank" (B2a, K = 1), then the gathered
    # fold and update over "gpu" (B2) -- the same bytes as allgather here
    mesh = C.dist.PartitionMesh(("rank", "gpu"), (pg.p_rank, pg.p_gpu))
    eng = BFSServeEngine(pg=pg, plan=plan, graph_id=spec["gid"], mesh=mesh,
                         comm=C.CommConfig(delegate="hier"), device=dev)
    eng.warmup(reachability=True, targets=True)
    qs = [Query(s, QueryKind(k), max_depth=d,
                targets=None if t is None else tuple(t))
          for s, k, d, t in spec["queries"]]
    setup_s = time.perf_counter() - t0
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    sync()
    ops.reset_launches()
    t0 = time.perf_counter()
    answers = eng.submit_many(qs)
    sync()
    serve_s = time.perf_counter() - t0
    out = {"answers": [digest(a) for a in answers],
           "stats": eng.stats.as_dict(), "serve_s": serve_s,
           "setup_s": setup_s, "sweeps": eng.traversal_sweeps,
           "launches": dict(ops.LAUNCHES), "bfs": []}
    cfg = TB.BFSConfig(**spec["bfs_cfg"])
    run = TB.make_sharded_bfs(mesh, None, cfg)
    run(eng.pgv, TB.init_state(pg, spec["keys"][0], cfg, device=dev,
                               mesh=mesh))                      # warm-up
    for src in spec["keys"]:
        st = TB.init_state(pg, src, cfg, device=dev, mesh=mesh)
        sync()
        t0 = time.perf_counter()
        st = run(eng.pgv, st)
        sync()
        dt = time.perf_counter() - t0
        sums = torch.stack([getattr(st, k).sum() for k in
                            ("work_fwd", "work_bwd", "nn_sent",
                             "wire_delegate", "wire_nn", "nn_overflow")])
        sums = C.dist.all_gather(mesh, sums).sum(0).tolist()
        out["bfs"].append(dict(
            src=src, time_s=dt, sweeps=int(st.it[0]),
            levels=digest(TB.gather_levels(pg, st, mesh=mesh)),
            counters=sums))
    return out


def sharded_gloo_phase(eng, hplan, queries, want, stats, full) -> None:
    """The engine on a world of two ranks sharing the card: gloo carries
    every collective of the step on CUDA tensors there (NCCL refuses two
    ranks on one device). Each rank loads its own partition's rows (and
    plan rows) from a file written here, serves the 64 queries under the
    two-level combine over its ``("rank", "gpu")`` mesh and runs the first
    FULL search keys; answers, every stats field, levels and counters
    must equal this process's emulated p = 2 (allgather) runs."""
    import json as _json
    import tempfile

    import numpy as np
    from dataclasses import asdict
    from repro_torch.core import bfs as TB, comm as C, convert
    from repro_torch.core import engine as TE

    t_start = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_world2_")
    for r in range(eng.pg.p):
        arrays, pmeta = convert.partition_to_arrays(
            TB.local_partition(eng.pg, r))
        for s in ("nn", "nd", "dn", "dd"):
            arrays[f"{s}.eidx"] = np.zeros((1, 0), dtype=np.int64)
        parr, plmeta = convert.plan_to_arrays(TE.local_plan(hplan, r))
        np.savez(f"{tmp}/part{r}.npz", **arrays, **parr,
                 meta=np.array(_json.dumps({"pg": pmeta, "plan": plmeta})))
    write_s = time.perf_counter() - t_start
    sub = full[:N_VARIANT_KEYS]
    spec = dict(dir=tmp, gid=eng.graph_id, device=DEVICE,
                queries=[(q.source, q.kind.value, q.max_depth, q.targets)
                         for q in queries],
                keys=[r["src"] for r in sub],
                bfs_cfg={k: v for k, v in asdict(bfs_configs()["FULL"]).items()
                         if k != "comm"})
    ranks = C.dist.spawn(world2_rank, eng.pg.p, (spec,), backend="gloo",
                         timeout=WORLD_TIMEOUT)
    want_d = [digest(a) for a in want]
    for r, res in enumerate(ranks):
        check(res["answers"] == want_d, f"world 2 rank {r}: answers")
        check(res["stats"] == stats, f"world 2 rank {r}: every stats field "
              f"({ {k: (v, stats[k]) for k, v in res['stats'].items() if v != stats[k]} })")
        for b, f in zip(res["bfs"], sub):
            check(b["levels"] == digest(f["levels"]) and b["sweeps"] ==
                  f["sweeps"] and b["counters"] == [
                      f["work_fwd"], f["work_bwd"], f["nn_sent"],
                      f["wire_delegate"], f["wire_nn"], 0],
                  f"world 2 rank {r}: key {f['src']} levels and counters")
        check(res["launches"]["ell_pull_multi"] == res["sweeps"]
              and res["launches"]["mask_reduce"] == 2 * res["sweeps"],
              f"world 2 rank {r}: one B1, one B2a and one B2 launch a "
              "sweep")
    r0 = ranks[0]
    print(f"sharded, world 2, gloo on one card ({card_line()}): partition "
          f"files {write_s:.1f} s; rank set-up {r0['setup_s']:.1f} s; 64 "
          f"queries {r0['serve_s']:.3f} s = "
          f"{len(queries) / r0['serve_s']:.1f} queries/s (rank 1: "
          f"{len(queries) / ranks[1]['serve_s']:.1f}), {r0['sweeps']} sweeps; "
          f"FULL keys ms {[round(b['time_s'] * 1e3, 1) for b in r0['bfs']]}; "
          f"launches a rank {r0['launches']}; answers, every stats field, "
          f"levels and counters equal the emulated p = 2 runs; phase "
          f"{time.perf_counter() - t_start:.1f} s")


# -----------------------------------------------------------------------------
# Payload path: WEIGHTED_SSSP, COMPONENTS and KHOP_SAMPLE at full width


def scipy_oracles(g, srcs):
    """The payload kinds' answers at this size, by scipy (the port's heapq
    Dijkstra takes minutes on 33.5 M edges): SSSP distances of ``srcs``
    by ``dijkstra`` over the synthetic weights of the port's
    ``edge_weights`` (held to the reference's by the CPU tests), on the
    deduplicated (u, v) pairs -- ``csr_matrix`` sums duplicate entries,
    and RMAT has many -- and the component label map, each component
    labelled with its minimum vertex id (``connected_components``)."""
    import numpy as np
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components, dijkstra
    from repro_torch.core.types import INF_LEVEL
    from repro_torch.core.weights import edge_weights

    import scipy

    t = [time.perf_counter()]
    # distinct (u, v) pairs: one sort and a neighbour compare
    key = np.sort(np.asarray(g.src, np.int64) * g.n
                  + np.asarray(g.dst, np.int64))
    key = key[np.concatenate([[True], key[1:] != key[:-1]])]
    u, v = key // g.n, key % g.n
    a = csr_matrix((edge_weights(u, v).astype(np.float64), (u, v)),
                   shape=(g.n, g.n))
    t.append(time.perf_counter())
    dist = dijkstra(a, directed=True, indices=np.asarray(srcs))
    sssp = np.where(np.isinf(dist), INF_LEVEL,
                    np.nan_to_num(dist, posinf=0)).astype(np.int32)
    t.append(time.perf_counter())
    k, lab = connected_components(a, directed=False)
    # each component's minimum id: its first vertex in a stable sort
    order = np.argsort(lab, kind="stable")
    first = order[np.searchsorted(lab[order], np.arange(k))]
    t.append(time.perf_counter())
    print("payload oracles (numpy {}, scipy {}): matrix {:.1f} s, dijkstra "
          "{:.1f} s, components {:.1f} s".format(np.__version__,
                                                 scipy.__version__,
                                                 *np.diff(t)))
    return {int(s): sssp[i] for i, s in enumerate(srcs)}, \
        first[lab].astype(np.int32)


def payload_queries(g):
    """The payload path's queries: three lane batches of PAYLOAD_BATCH
    (WEIGHTED_SSSP, COMPONENTS, KHOP_SAMPLE with k = KHOP_K) on one set of
    sources, and a seven-kind mixed stream of PAYLOAD_MIXED on another."""
    from repro_torch.graphs.rmat import pick_sources
    from repro_torch.serve import Query, QueryKind as K

    srcs = [int(s) for s in pick_sources(g, PAYLOAD_BATCH, seed=21)]
    batches = {
        "weighted_sssp": [Query(s, K.WEIGHTED_SSSP) for s in srcs],
        "components": [Query(s, K.COMPONENTS) for s in srcs],
        "khop_sample": [Query(s, K.KHOP_SAMPLE, max_depth=KHOP_K)
                        for s in srcs]}
    mix = [int(s) for s in pick_sources(g, PAYLOAD_MIXED, seed=22)]
    # the first four SSSP queries of the stream share the batch's first
    # four sources, so four Dijkstra runs serve both oracle checks
    for j, i in enumerate(range(4, 4 + 7 * 4, 7)):
        mix[i] = srcs[j]
    tpool = tuple(mix[:2])
    kinds = [lambda s: Query(s), lambda s: Query(s, K.REACHABILITY),
             lambda s: Query(s, K.DISTANCE_LIMITED, max_depth=3),
             lambda s: Query(s, K.MULTI_TARGET, targets=tpool),
             lambda s: Query(s, K.WEIGHTED_SSSP),
             lambda s: Query(s, K.COMPONENTS),
             lambda s: Query(s, K.KHOP_SAMPLE, max_depth=2)]
    return batches, [kinds[i % 7](s) for i, s in enumerate(mix)]


def payload_oracle(g, csr, q, a, sssp, labels) -> bool:
    """One answer of any kind against its oracle (``sssp`` / ``labels``
    from :func:`scipy_oracles`)."""
    import numpy as np
    from repro_torch.core import oracle as O
    from repro_torch.serve import QueryKind as K

    if q.kind is K.WEIGHTED_SSSP:
        return np.array_equal(a, sssp[q.source])
    if q.kind is K.COMPONENTS:
        return np.array_equal(a, labels)
    if q.kind is K.KHOP_SAMPLE:
        return np.array_equal(a, O.khop_nodes(g, q.source, q.max_depth, csr))
    if q.kind is K.LEVELS:
        return np.array_equal(a, O.bfs_levels(g, q.source, csr))
    if q.kind is K.REACHABILITY:
        return np.array_equal(a, O.reachable_mask(g, q.source, csr))
    if q.kind is K.DISTANCE_LIMITED:
        return np.array_equal(a, O.bfs_levels_limited(g, q.source,
                                                      q.max_depth, csr))
    return a == O.target_depths(g, q.source, q.targets, csr)


def payload_batches(pg, batches) -> tuple:
    """(a) The three lane batches, each one ``submit_many`` of
    PAYLOAD_BATCH queries on a warmed-up engine: sweeps, ms a sweep,
    queries/s, payload wire bytes and peak memory."""
    import torch
    from repro_torch.serve import BFSServeEngine

    eng = BFSServeEngine(pg=pg, cache_capacity=0, reuse_components=False,
                         device=DEVICE)
    eng.warmup(payload=True)
    answers, rows = {}, {}
    for name, qs in batches.items():
        before, sweeps0 = eng.stats.as_dict(), eng.traversal_sweeps
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        answers[name] = eng.submit_many(qs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        st = {k: v - before[k] for k, v in eng.stats.as_dict().items()
              if not isinstance(v, dict)}
        sweeps = eng.traversal_sweeps - sweeps0
        rows[name] = dict(sweeps=sweeps, ms_per_sweep=dt * 1e3 / sweeps,
                          qps=len(qs) / dt,
                          peak=torch.cuda.max_memory_allocated(),
                          **{k: st[k] for k in (
                              "wire_delegate_bytes", "wire_nn_bytes",
                              "wire_pay_delegate_bytes",
                              "wire_pay_nn_bytes", "nn_overflow")})
        r = rows[name]
        print(f"payload batch {name}: {len(qs)} queries in {dt:.3f} s = "
              f"{r['qps']:.2f} queries/s; sweeps={sweeps} ms/sweep="
              f"{r['ms_per_sweep']:.2f} wire_pay_delegate_bytes="
              f"{r['wire_pay_delegate_bytes']} wire_pay_nn_bytes="
              f"{r['wire_pay_nn_bytes']} wire_delegate_bytes="
              f"{r['wire_delegate_bytes']} wire_nn_bytes={r['wire_nn_bytes']}"
              f" nn_overflow={r['nn_overflow']} max_memory_allocated="
              f"{r['peak']} B ({card_line()})")
        check(r["nn_overflow"] == 0, f"payload batch {name}: no slot dropped")
        pay = name != "khop_sample"
        check((r["wire_pay_nn_bytes"] > 0) == pay
              and (r["wire_pay_delegate_bytes"] > 0) == pay,
              f"payload batch {name}: payload bytes only on the payload kinds")
    return eng, answers, rows


def payload_allgather(pg, qs, want) -> dict:
    """(c) One SSSP lane batch under ``CommConfig(delegate="allgather")``:
    launch counts zeroed just before and read just after -- one B4
    (``payload_min_fold_apply``), one B1 and one B2 launch a sweep; the
    answers equal the default run's."""
    import torch
    from repro_torch.core import comm as TC
    from repro_torch.kernels import ops
    from repro_torch.serve import BFSServeEngine

    eng = BFSServeEngine(pg=pg, cache_capacity=0, reuse_components=False,
                         comm=TC.CommConfig(delegate="allgather"),
                         device=DEVICE)
    eng.warmup(payload=True)
    sweeps0 = eng.traversal_sweeps
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    got = eng.submit_many(qs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    sweeps = eng.traversal_sweeps - sweeps0
    print(f"payload allgather: {len(qs)} SSSP queries in {dt:.3f} s, "
          f"sweeps={sweeps} ms/sweep={dt * 1e3 / sweeps:.2f} "
          f"launches={launches} ({card_line()})")
    check(launches["payload_min_fold"] == sweeps > 0,
          "payload allgather: one B4 launch a sweep")
    check(launches["ell_pull_multi"] == launches["mask_reduce"] == sweeps,
          "payload allgather: one B1 and one B2 launch a sweep")
    check(all(a.shape == b.shape and (a == b).all()
              for a, b in zip(got, want)),
          "payload allgather: answers equal the default run's")
    return dict(eng=eng, launches=launches, sweeps=sweeps)


def payload_breakdown(eng, qs) -> dict:
    """(d) Where a payload sweep's time goes, on a real mid-run state (an
    SSSP lane batch after 4 sweeps, allgather): each part of the sweep
    alone (CUDA events, median of 3) -- the min-plus pushes with the nn
    slot fold, the bit pushes with theirs, the payload nn exchange, the B4
    delegate update at ``n = d * W`` (held against its plain version,
    device time, bound) and the whole sweep; then one lane batch under
    ``torch.profiler`` (B1, B2 and B4 in the trace, the device busy share,
    the operators' device time)."""
    import torch
    from repro_torch.core import comm as TC, msbfs as TM
    from repro_torch.kernels import mask_reduce as MR

    cfg = eng._session_cfg(qs)
    pgv, plan = eng.pgv, eng.plan
    st = eng._init([q.source for q in qs], cfg,
                   payload_modes=[q.payload_mode for q in qs])
    for _ in range(4):
        st = TM.msbfs_step(pgv, plan, st, cfg)
    pv = TM.payload_view(pgv, plan)
    p, nl, (rows, d, w) = pgv.p, pgv.n_local, st.payload_d.shape
    cplan = TC.plan_for(cfg.comm, p)
    bucket = st.pay_bucket[:, None, :]
    nv = pgv.normal_valid[:, :, None]
    fn = st.pay_pending_n & nv & (st.payload_n < bucket)
    fd = st.pay_pending_d & (st.payload_d < bucket)
    wsel = st.pay_weighted
    lev_n = st.level_n == st.it[:, None, None]

    def minplus():
        return (TM._push_payload(pgv.dd, fd, st.payload_d, pv.w_dd, wsel, d),
                TM._push_payload(pgv.nd, fn, st.payload_n, pv.w_nd, wsel, d),
                TM._push_payload(pgv.dn, fd, st.payload_d, pv.w_dn, wsel, nl),
                TM._nn_slots_payload(pv, fn, st.payload_n, wsel, plan))

    def bits():
        fdb = st.level_d == st.it[:, None, None]
        return (TM._push_multi(pgv.dd, fdb, d), TM._push_multi(pgv.nd, lev_n, d),
                TM._push_multi(pgv.dn, fdb, nl),
                TM._nn_slots_multi(pgv.nn, lev_n, plan))

    pdd, pnd, _, sa = minplus()
    dense = TM._dense_slots_payload(plan, sa, p)
    exchange = lambda: TC.nn_exchange_payload(
        cplan, TM._dense_slots_payload(plan, sa, p), plan.recv_local, nl)
    gathered = torch.minimum(pdd, pnd).reshape(rows, d * w).contiguous()
    prev = st.payload_d.reshape(rows, d * w).contiguous()
    got = MR.payload_min_fold_apply_cuda(gathered, prev)
    want = MR.payload_min_fold_apply_plain(gathered, prev)
    torch.cuda.synchronize()
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          "payload_min_fold_apply at n = d * W: kernel != plain")
    b4 = lambda: MR.payload_min_fold_apply_cuda(gathered, prev)
    nbytes = gathered.numel() * 4 + 2 * prev.numel() * 4 + 4 * -(-rows // 4)
    b_ms, b_by = bound(nbytes, (rows + 1) * prev.numel())
    out = dict(
        minplus_ms=time_ms(minplus, 3), bits_ms=time_ms(bits, 3),
        exchange_ms=time_ms(exchange, 5),
        sweep_ms=time_ms(lambda: TM.msbfs_step(pgv, plan, st, cfg), 3),
        b4_ms=time_ms(b4, 50), b4_device_us=device_us(
            b4, "payload_min_fold_apply_kernel"),
        b4_plain_ms=time_ms(lambda: MR.payload_min_fold_apply_plain(
            gathered, prev), 10),
        b4_bound_ms=b_ms, b4_bound_by=b_by,
        b4_library_ms=time_ms(lambda: torch.minimum(prev, gathered.amin(0)),
                              50), b4_err=0)
    print(f"payload sweep parts (SSSP batch, sweep {int(st.it[0])}, "
          f"allgather; {card_line()}): min-plus pushes + nn slot fold "
          f"{out['minplus_ms']:.3f} ms, bit pushes + nn slot fold "
          f"{out['bits_ms']:.3f} ms, payload nn exchange (bin + a2a + "
          f"scatter) {out['exchange_ms']:.3f} ms, whole sweep "
          f"{out['sweep_ms']:.3f} ms; pending vertex-lane pairs "
          f"{int(fn.sum()) + int(fd.sum())} (active slots "
          f"{int((dense < int(TM.PAY_IDENT)).any(-1).sum())})")
    print(f"kernel payload_min_fold_apply [payload plane, n = d*W = {d * w}]"
          f": K={rows} P={rows} ms={out['b4_ms']:.4f} device_us="
          f"{out['b4_device_us']:.2f} plain_ms={out['b4_plain_ms']:.4f} "
          f"library_ms(minimum(prev, amin))={out['b4_library_ms']:.4f} "
          f"bound_ms={b_ms:.6f} ({b_by}) bound/device="
          f"{b_ms * 1e3 / out['b4_device_us']:.3f} exact=True")
    prof = {}
    sweeps0 = eng.traversal_sweeps
    per_launch = profile_run(
        lambda: eng.run_batch_queries(qs),
        lambda _: f"one payload lane batch of {len(qs)} SSSP queries "
                  f"(allgather), sweeps={eng.traversal_sweeps - sweeps0}",
        ("pull_rows_kernel<pull::WordGather", "mask_reduce_apply_kernel",
         "payload_min_fold_apply_kernel"), into=prof)
    for op in ("aten::scatter_reduce_", "aten::addcmul_", "aten::index",
               "aten::index_add_", "aten::where", "aten::minimum"):
        print(f"  payload profile operator {op}: "
              f"{prof['ops'].get(op, 0.0):.3f} ms device")
    out.update(busy=prof["busy_ms"] / prof["wall_ms"], per_launch=per_launch,
               prof_ops=prof["ops"])
    return out


def payload_mixed(pg, mixed, csr, g, sssp, labels) -> dict:
    """(b) The seven-kind mixed stream through the per-sweep refill driver
    and the overlapped one (``sweep_block`` SWEEP_BLOCK, blocks captured
    by ``warmup(payload=True, targets=True)``): equal answers, every
    ServeStats field equal but ``sweep_blocks``; 4 answers of each kind
    held against the oracles."""
    from repro_torch.serve import BFSServeEngine

    eng = BFSServeEngine(pg=pg, cache_capacity=0, reuse_components=False,
                         refill=True, overlap=True, sweep_block=SWEEP_BLOCK,
                         device=DEVICE)
    t0 = time.perf_counter()
    eng.warmup(payload=True, targets=True)
    t_warm = time.perf_counter() - t0
    runs = {mode: drive(eng, mode, mixed) for mode in ("sync", "overlap")}
    for mode, r in runs.items():
        st = r["stats"]
        print(f"payload mixed {mode}: {len(mixed)} queries in "
              f"{r['time_s']:.3f} s = {len(mixed) / r['time_s']:.2f} "
              f"queries/s; sweeps={r['sweeps']} executed={r['executed']} "
              f"refills={st['refills']} lane_utilization="
              f"{st['lane_sweeps_busy'] / max(st['lane_sweeps_total'], 1):.4f}"
              f" sweep_blocks={st['sweep_blocks']} replays="
              f"{r['blocks']['replays']} wire_pay_delegate_bytes="
              f"{st['wire_pay_delegate_bytes']} wire_pay_nn_bytes="
              f"{st['wire_pay_nn_bytes']} launches={r['launches']} "
              f"({card_line()}; warm-up with captures {t_warm:.1f} s)")
    s, o = runs["sync"]["stats"], runs["overlap"]["stats"]
    check({k: v for k, v in s.items() if k != "sweep_blocks"}
          == {k: v for k, v in o.items() if k != "sweep_blocks"},
          "payload mixed: sync and overlap counters equal")
    check(o["sweep_blocks"] > 0 and runs["overlap"]["blocks"]["replays"] > 0,
          "payload mixed: the overlap run replays captured blocks")
    ra, rb = runs["sync"]["results"], runs["overlap"]["results"]
    check(all(payload_answer_equal(ra[q], rb[q]) for q in mixed),
          "payload mixed: sync and overlap answers equal")
    checked: dict = {}
    for q in mixed:
        if checked.get(q.kind, 0) < 4:
            check(payload_oracle(g, csr, q, ra[q], sssp, labels),
                  f"payload mixed oracle: {q}")
            checked[q.kind] = checked.get(q.kind, 0) + 1
    print(f"payload mixed oracle: {dict((k.value, v) for k, v in checked.items())}"
          " answers exact")
    check(len(checked) == 7 and min(checked.values()) == 4,
          "payload mixed: 4 oracle checks of each kind")
    return runs


def payload_answer_equal(a, b) -> bool:
    import numpy as np
    return a == b if isinstance(a, dict) else np.array_equal(a, b)


def payload_path(g, pg, csr) -> dict:
    """(a)-(d) of the payload path on the scale-20 graph and its p = 2
    partition, at W = 32; (e) runs with the sharded NCCL phase. Returns
    the numbers the kernel line and PERF.md take."""
    import torch

    t_start = time.perf_counter()
    batches, mixed = payload_queries(g)
    t0 = time.perf_counter()
    sssp_srcs = [q.source for q in batches["weighted_sssp"][:4]]
    sssp, labels = scipy_oracles(g, sssp_srcs)
    print(f"payload oracles (scipy dijkstra x{len(sssp_srcs)}, "
          f"connected_components): {time.perf_counter() - t0:.1f} s, "
          f"{len(set(labels.tolist()))} components")
    eng, answers, rows = payload_batches(pg, batches)
    for name, qs in batches.items():
        for q, a in list(zip(qs, answers[name]))[:4]:
            check(payload_oracle(g, csr, q, a, sssp, labels),
                  f"payload batch oracle: {q}")
    check(all(payload_answer_equal(a, labels)
              for a in answers["components"]),
          "payload batch: every COMPONENTS answer is the label map")
    print("payload batch oracle: 4 answers of each kind exact")
    del eng
    torch.cuda.empty_cache()
    ag = payload_allgather(pg, batches["weighted_sssp"],
                           answers["weighted_sssp"])
    parts = payload_breakdown(ag["eng"], batches["weighted_sssp"])
    del ag["eng"]
    torch.cuda.empty_cache()
    mixed_runs = payload_mixed(pg, mixed, csr, g, sssp, labels)
    print(f"payload path: {time.perf_counter() - t_start:.1f} s")
    return dict(rows=rows, allgather=ag, parts=parts,
                mixed={m: r["stats"] for m, r in mixed_runs.items()})


# -----------------------------------------------------------------------------
# Memory and telemetry modes (edge_chunk, telemetry=True, nn="compressed",
# the compressed partition)


def lane_init(queries) -> dict:
    """``init_multi_state`` keywords seeding one lane per typed bit query
    (its source, depth cap and targets)."""
    from repro_torch.serve import QueryKind as K

    return dict(
        sources=[q.source for q in queries],
        depth_caps=[q.max_depth if q.kind is K.DISTANCE_LIMITED else None
                    for q in queries],
        targets=[q.targets if q.kind is K.MULTI_TARGET else None
                 for q in queries])


def memory_run(eng, cfg, init: dict, what: str):
    """One lane batch to convergence on ``eng``'s partition: its state,
    and the peak memory over the batch (``max_memory_allocated`` after
    ``reset_peak_memory_stats``, state build included), what was
    allocated before it, the sweeps and the ms a sweep (CUDA-synchronized
    host clock over the sweep loop)."""
    import torch
    from repro_torch.core import msbfs as M

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kw = dict(init)
    sources = kw.pop("sources")
    if cfg.payload:
        kw["gids"] = eng._pay_gids()
    st = M.init_multi_state(eng.pg, sources, cfg, device=eng.device, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = M.run_msbfs_emulated(eng.pgv, eng.plan, st, cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    sweeps = int(st.it[0])
    row = dict(peak=torch.cuda.max_memory_allocated(), base=base,
               sweeps=sweeps, ms_per_sweep=dt * 1e3 / sweeps)
    print(f"memory {what} edge_chunk={cfg.edge_chunk}: sweeps={sweeps} "
          f"ms/sweep={row['ms_per_sweep']:.2f} max_memory_allocated="
          f"{row['peak']} B (resident before the batch {base} B, batch "
          f"{row['peak'] - base} B) ({card_line()})")
    return st, row


def memory_peaks(eng, g, csr, queries) -> dict:
    """(1) Peak memory: a bit lane batch of the serving path's first 32
    queries and a WEIGHTED_SSSP lane batch of 32 (the payload path's
    sources), each monolithic and with ``edge_chunk=EDGE_CHUNK``: every
    leaf equal between the two, answers equal to the oracle."""
    import dataclasses

    import numpy as np
    from repro_torch.core import convert, msbfs as M
    from repro_torch.core import oracle as O
    from repro_torch.graphs.rmat import pick_sources
    from repro_torch.serve import QueryKind as K
    from repro_torch.serve.engine import PAYLOAD_ITERS_FACTOR

    out = {}
    bit_qs = queries[:PAYLOAD_BATCH]
    bit_cfg = M.MSBFSConfig(n_queries=PAYLOAD_BATCH)
    srcs = [int(s) for s in pick_sources(g, PAYLOAD_BATCH, seed=21)]
    pay_cfg = M.MSBFSConfig(n_queries=PAYLOAD_BATCH, payload=True,
                            enable_targets=False,
                            max_iters=64 * PAYLOAD_ITERS_FACTOR)
    # resident in both runs: the payload plane's edge weights and seeds
    M.payload_view(eng.pgv, eng.plan)
    eng._pay_gids()
    for name, cfg, init in (
            ("bit", bit_cfg, lane_init(bit_qs)),
            ("sssp", pay_cfg, dict(sources=srcs,
                                   payload_modes=["sssp"] * len(srcs)))):
        out[name] = {}
        mono, out[name][0] = memory_run(
            eng, dataclasses.replace(cfg, edge_chunk=0), init, name)
        mono = convert.state_to_numpy(mono)   # off the card for the next
        st, out[name][EDGE_CHUNK] = memory_run(
            eng, dataclasses.replace(cfg, edge_chunk=EDGE_CHUNK), init, name)
        got = convert.state_to_numpy(st)
        diff = [k for k in M.STATE_LEAVES
                if not np.array_equal(got[k], mono[k])]
        check(not diff, f"memory {name}: every leaf equal, chunked and not "
                        f"(differ: {diff})")
        out[name]["state"] = st
    st = out["bit"]["state"]
    lv = [i for i, q in enumerate(bit_qs) if q.kind is K.LEVELS][:2]
    for i, row in zip(lv, M.gather_levels_multi(eng.pg, st, lanes=lv)):
        check((row == O.bfs_levels(g, bit_qs[i].source, csr)).all(),
              f"memory bit: lane {i} equals the oracle")
    sssp, _ = scipy_oracles(g, srcs[:MEMORY_SSSP_ORACLES])
    pay = M.gather_payload_multi(eng.pg, out["sssp"]["state"],
                                 lanes=list(range(MEMORY_SSSP_ORACLES)))
    for i, row in enumerate(pay):
        check((row == sssp[srcs[i]]).all(),
              f"memory sssp: lane {i} equals scipy's dijkstra")
    saving = out["sssp"][0]["peak"] - out["sssp"][EDGE_CHUNK]["peak"]
    print(f"memory: edge_chunk={EDGE_CHUNK} saves {saving} B on the SSSP "
          f"batch, {out['bit'][0]['peak'] - out['bit'][EDGE_CHUNK]['peak']} "
          f"B on the bit batch ({card_line()})")
    check(saving >= MIN_SSSP_SAVING,
          f"memory sssp: the chunked peak is {MIN_SSSP_SAVING:.0f} B or more "
          "below the monolithic one")
    return out


def memory_overlap(pg, mixed) -> dict:
    """(1, end) The seven-kind stream of the payload path through the
    overlapped refill driver (blocks captured by the warm-up), monolithic
    and with ``edge_chunk``: every ServeStats field and every answer
    equal; the peak of each run."""
    import torch
    from repro_torch.serve import BFSServeEngine

    runs = {}
    for ec in (0, EDGE_CHUNK):
        eng = BFSServeEngine(pg=pg, cache_capacity=0, reuse_components=False,
                             refill=True, overlap=True,
                             sweep_block=SWEEP_BLOCK, edge_chunk=ec,
                             device=DEVICE)
        eng.warmup(payload=True, targets=True)
        # a replay allocates nothing: its temporaries live in the graphs'
        # pool, which memory_reserved counts (the free cache dropped)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        pools = torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        r = drive(eng, "overlap", mixed)
        r["peak"] = torch.cuda.max_memory_allocated()
        r["reserved"] = torch.cuda.max_memory_reserved()
        r["pools"] = pools
        print(f"memory overlap edge_chunk={ec}: {len(mixed)} queries in "
              f"{r['time_s']:.3f} s = {len(mixed) / r['time_s']:.2f} "
              f"queries/s; sweeps={r['sweeps']} sweep_blocks="
              f"{r['stats']['sweep_blocks']} replays={r['blocks']['replays']}"
              f" memory_reserved after the warm-up's captures={pools} B "
              f"max_memory_reserved={r['reserved']} B max_memory_allocated="
              f"{r['peak']} B ({card_line()})")
        check(r["blocks"]["replays"] > 0,
              f"memory overlap edge_chunk={ec}: captured blocks replayed")
        runs[ec] = r
        del eng
        torch.cuda.empty_cache()
    a, b = runs[0], runs[EDGE_CHUNK]
    check(b["pools"] < a["pools"],
          "memory overlap: the chunked blocks' graph pools are smaller")
    check(a["stats"] == b["stats"],
          "memory overlap: every ServeStats field equal, chunked and not")
    check(all(payload_answer_equal(a["results"][q], b["results"][q])
              for q in mixed), "memory overlap: answers equal")
    return {ec: {k: r[k] for k in ("peak", "reserved", "pools", "time_s",
                                   "sweeps")} for ec, r in runs.items()}


def pack_rows(flags):
    """Host lane packing of ``[..., W]`` bool -> ``[..., ceil(W/32)]``
    uint32 (lane q -> bit q % 32 of word q // 32), as the wire packs."""
    import numpy as np

    w = flags.shape[-1]
    nw = -(-w // 32)
    pad = np.zeros(flags.shape[:-1] + (nw * 32,), dtype=np.uint64)
    pad[..., :w] = flags
    bits = pad.reshape(flags.shape[:-1] + (nw, 32))
    return (bits << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)


def memory_telemetry(eng, init: dict, plain) -> None:
    """(2) The bit batch with ``telemetry=True``: every other leaf equal to
    the run without it (``plain``); the ``tm_*`` leaves equal to the
    frontier counts and packed directions read on the host from a
    sweep-by-sweep run; a captured ``SweepBlock`` with telemetry equal to
    the same sweeps run eagerly."""
    import dataclasses

    import numpy as np
    from repro_torch.core import msbfs as M

    cfg = M.MSBFSConfig(n_queries=PAYLOAD_BATCH, telemetry=True)
    kw = dict(init)
    sources = kw.pop("sources")
    init_state = lambda c: M.init_multi_state(eng.pg, sources, c,
                                              device=eng.device, **kw)
    st = M.run_msbfs_emulated(eng.pgv, eng.plan, init_state(cfg), cfg)
    tm = ("tm_frontier_n", "tm_frontier_d", "tm_backward")
    _states_equal(st, plain, [k for k in M.STATE_LEAVES if k not in tm],
                  "memory telemetry: answers and counters unchanged")
    off = dataclasses.replace(cfg, telemetry=False)
    cur = init_state(off)
    nv = eng.pgv.normal_valid.cpu().numpy()[:, :, None]
    sweeps = int(st.it[0])
    fn, fd, bw = (getattr(st, k).cpu().numpy() for k in tm)
    for t in range(sweeps):
        h = {k: getattr(cur, k).cpu().numpy() for k in (
            "level_n", "level_d", "base_it", "lane_stop", "depth_cap")}
        it = t
        expand = (~h["lane_stop"] & (it - h["base_it"] < h["depth_cap"]))
        front_n = (h["level_n"] == it) & nv & expand[:, None, :]
        front_d = (h["level_d"] == it) & expand[:, None, :]
        check((fn[:, t] == front_n.reshape(front_n.shape[0], -1).sum(1)).all()
              and (fd[:, t] == front_d.reshape(front_d.shape[0], -1).sum(1))
              .all(), f"memory telemetry: frontier counts of sweep {t}")
        cur = M.msbfs_step(eng.pgv, eng.plan, cur, off)
        check((bw[:, t].view(np.uint32)
               == pack_rows(cur.backward.cpu().numpy())).all(),
              f"memory telemetry: packed directions of sweep {t}")
    check(int(fn[:, sweeps:].sum()) == 0 and int(bw.sum()) != 0,
          "memory telemetry: nothing past the last sweep; some lane pulled")
    blk = M.make_msbfs_block_emulated(cfg, TELEMETRY_BLOCK)
    run = blk(eng.pgv, eng.plan, init_state(cfg),
              np.zeros(PAYLOAD_BATCH, dtype=bool))
    run.wait()
    blk.runner.drain()
    eager = init_state(cfg)
    for _ in range(TELEMETRY_BLOCK):
        eager = M.msbfs_step(eng.pgv, eng.plan, eager, cfg)
    check(blk.runner.graphs is not None, "memory telemetry: block captured")
    _states_equal(run.out, eager, M.STATE_LEAVES,
                  f"memory telemetry: a captured block of {TELEMETRY_BLOCK} "
                  "equals the eager sweeps")
    print(f"memory telemetry: {sweeps} sweeps, tm_* equal to the host's "
          f"per-sweep frontier counts and directions; captured block of "
          f"{TELEMETRY_BLOCK} equal to eager; frontier_n per sweep "
          f"{fn.sum(0)[:sweeps].tolist()}")


def memory_compressed_nn(eng, g, queries, answers) -> None:
    """(3) The 64-query serving run under ``nn="compressed"``: answers
    equal to the dense run's; then one sweep's ``wire_nn`` on a mid-BFS
    state equal to the host encoders (``rle_encode`` /
    ``delta_encode_ids``) applied to that sweep's sent slot maps."""
    import numpy as np
    import torch
    from repro_torch.core import bfs as B, comm as C, msbfs as M
    from repro_torch.core.comm import codec
    from repro_torch.graphs.rmat import pick_sources
    from repro_torch.serve import BFSServeEngine

    comm = C.CommConfig(nn="compressed")
    ce = BFSServeEngine(pg=eng.pg, comm=comm, device=DEVICE)
    t0 = time.perf_counter()
    got = ce.submit_many(queries)
    dt = time.perf_counter() - t0
    s = ce.stats
    print(f"memory compressed nn: {len(queries)} queries in {dt:.3f} s; "
          f"wire_nn_bytes={s.wire_nn_bytes} nn_sparse_sweeps (delta ids "
          f"won on partition 0)={s.nn_sparse_sweeps} nn_overflow="
          f"{s.nn_overflow} ({card_line()})")
    check(all(payload_answer_equal(a, b) for a, b in zip(got, answers)),
          "memory compressed nn: answers equal the dense run's")
    check(s.nn_overflow == 0, "memory compressed nn: no slot dropped")
    del ce
    cfg = M.MSBFSConfig(n_queries=PAYLOAD_BATCH, enable_targets=False,
                        comm=comm)
    st = M.init_multi_state(eng.pg, [int(x) for x in pick_sources(
        g, PAYLOAD_BATCH, seed=1)], cfg, device=eng.device)
    for _ in range(2):
        st = M.msbfs_step(eng.pgv, eng.plan, st, cfg)
    # this sweep's sent slot maps, as msbfs_step builds them
    it = st.it[:, None, None]
    expand = (~st.lane_stop & (st.it[:, None] - st.base_it
                               < st.depth_cap))[:, None, :]
    front = (st.level_n == it) & eng.pgv.normal_valid[:, :, None] & expand
    sa, _ = M._nn_slots_multi(eng.pgv.nn, front, eng.plan)
    act = B._dense_slots(eng.plan, sa, eng.pg.p).any(-1).cpu().numpy()
    t = int(st.it[0])
    nxt = M.msbfs_step(eng.pgv, eng.plan, st, cfg)
    wire = (nxt.wire_nn[:, t] - st.wire_nn[:, t]).cpu().numpy()
    flag = (nxt.nn_sparse[:, t] - st.nn_sparse[:, t]).cpu().numpy()
    nw = C.n_words(PAYLOAD_BATCH)
    for k in range(eng.pg.p):
        rle = delta = sent = 0
        for j in range(eng.pg.p):
            if j != k:
                rle += codec.rle_encode(act[k, j]).size
                delta += codec.delta_encode_ids(np.nonzero(act[k, j])[0]).size
                sent += int(act[k, j].sum())
        want = min(rle, delta) + sent * nw * 4
        print(f"memory compressed nn sweep {t}, partition {k}: {sent} slots "
              f"sent; rle {rle} B, delta {delta} B; wire_nn {int(wire[k])} "
              f"(host encoders {want})")
        check(int(wire[k]) == want and int(flag[k]) == int(delta <= rle),
              f"memory compressed nn: wire_nn of partition {k} equals the "
              "host encoders")
    torch.cuda.synchronize()


def memory_partition(eng, mid) -> dict:
    """(4) ``compress_partition`` of the scale-20 partition (host seconds,
    bytes per edge raw and compressed); then partition 0's nd rows decoded
    into an ELL tile (``decode_ell_tile``) feed B1 (``ops.ell_pull_multi``,
    one counted launch) on a real mid-BFS frontier (``mid``): equal to
    B1's plain version on the same tile."""
    import numpy as np
    import torch
    from repro_torch.core import partition as P
    from repro_torch.core.comm import pack_lanes
    from repro_torch.core.types import INF_LEVEL
    from repro_torch.kernels import ops, ref

    pg = eng.pg
    t0 = time.perf_counter()
    cp = P.compress_partition(pg)
    t_c = time.perf_counter() - t0
    mem = pg.memory_bytes(compressed=cp)
    print(f"memory compressed partition: {t_c:.1f} s on the host; "
          f"bytes_per_edge_raw={mem['bytes_per_edge_raw']:.4f} "
          f"bytes_per_edge_compressed={mem['bytes_per_edge_compressed']:.4f} "
          f"compressed_vs_raw={mem['compressed_vs_raw']:.4f} "
          f"total={mem['total']} B compressed_total={mem['compressed_total']}"
          f" B m={mem['m']} per subgraph {mem['compressed_per_subgraph']}")
    deg = np.diff(np.asarray(pg.nd.offsets)[0])
    k_max = int(deg.max()) + 1
    t0 = time.perf_counter()
    tile = P.decode_ell_tile(cp.nd, 0, 0, pg.n_local, k_max)
    t_d = time.perf_counter() - t0
    it = int(mid.it[0])
    fw = pack_lanes(mid.level_d[0] == it)                     # [d, nw]
    nv = eng.pgv.normal_valid[0][:, None]
    aw = pack_lanes((mid.level_n[0] == int(INF_LEVEL)) & nv)  # [nl, nw]
    tile_dev = torch.from_numpy(tile).to(eng.device)
    ops.reset_launches()
    got = ops.ell_pull_multi(tile_dev, fw, aw)
    torch.cuda.synchronize()
    launches = ops.LAUNCHES["ell_pull_multi"]
    want = ref.ell_pull_multi_ref(torch.from_numpy(tile), fw.cpu(), aw.cpu())
    found = int((got.cpu() != 0).any(1).sum())
    print(f"memory decoded tile: partition 0 nd rows {tile.shape} (k_max "
          f"{k_max}) decoded in {t_d:.1f} s; B1 launches={launches}; rows "
          f"found {found} of {int((aw != 0).any(1).sum())} needing a lane "
          f"({card_line()})")
    check(launches == 1, "memory decoded tile: one B1 launch")
    check(torch.equal(got.cpu(), want) and found > 0,
          "memory decoded tile: B1 equals its plain version")
    return dict(compress_s=t_c, decode_s=t_d, **{
        k: mem[k] for k in ("bytes_per_edge_raw", "bytes_per_edge_compressed",
                            "compressed_vs_raw", "total", "compressed_total",
                            "m")})


def memory_path(eng, g, csr, queries, answers) -> dict:
    """The memory and telemetry modes on the scale-20 partition (p = 2
    emulated, TH = 64, W = 32): (1) peaks, (2) telemetry, (3) the
    compressed nn format, (4) the compressed partition."""
    import torch
    from repro_torch.core import msbfs as M

    t_start = time.perf_counter()
    print(f"memory phase: edge_chunk={EDGE_CHUNK} edge slots of every "
          f"partition per push block (E_max nn/nd/dn/dd "
          f"{eng.pg.nn.e_max}/{eng.pg.nd.e_max}/{eng.pg.dn.e_max}/"
          f"{eng.pg.dd.e_max})")
    peaks = memory_peaks(eng, g, csr, queries)
    _, mixed = payload_queries(g)
    peaks["overlap"] = memory_overlap(eng.pg, mixed)
    bit_state = peaks["bit"].pop("state")
    peaks["sssp"].pop("state")
    init = lane_init(queries[:PAYLOAD_BATCH])
    memory_telemetry(eng, init, bit_state)
    del bit_state
    torch.cuda.empty_cache()
    memory_compressed_nn(eng, g, queries, answers)
    kw = dict(init)
    cfg = M.MSBFSConfig(n_queries=PAYLOAD_BATCH)
    mid = M.init_multi_state(eng.pg, kw.pop("sources"), cfg,
                             device=eng.device, **kw)
    for _ in range(2):
        mid = M.msbfs_step(eng.pgv, eng.plan, mid, cfg)
    part = memory_partition(eng, mid)
    print(f"memory path: {time.perf_counter() - t_start:.1f} s")
    return dict(peaks=peaks, partition=part)


def recsys_setup():
    """TF32 off, the FULL xDeepFM with seeded random weights on the card,
    and the ClickStream whose hot / cold row ids index its tables."""
    import torch
    from repro_torch.configs.xdeepfm import FULL
    from repro_torch.data.recsys_data import ClickStream
    from repro_torch.models.recsys import XDeepFM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card settings: torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} "
          f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"float32_matmul_precision={torch.get_float32_matmul_precision()}")
    t0 = time.perf_counter()
    model = XDeepFM(FULL, device=DEVICE, seed=0)
    torch.cuda.synchronize()
    t_model = time.perf_counter() - t0
    t0 = time.perf_counter()
    cs = ClickStream(n_fields=FULL.n_sparse, total_vocab=FULL.n_cold,
                     hot_fraction=HOT_FRACTION, seed=0)
    t_data = time.perf_counter() - t0
    n_hot, n_cold = cs.hot_cold.n_hot, cs.hot_cold.n_cold
    print(f"recsys setup: XDeepFM({FULL.name}) n_sparse={FULL.n_sparse} "
          f"embed_dim={FULL.embed_dim} cin={FULL.cin_layers} "
          f"mlp={FULL.mlp_layers} table bytes="
          f"{sum(p.numel() * 4 for p in model.parameters())} in "
          f"{t_model:.1f} s; ClickStream(total_vocab={FULL.n_cold}) "
          f"{t_data:.1f} s: n_hot={n_hot} (table {FULL.n_hot}) "
          f"n_cold={n_cold} (table {FULL.n_cold}) "
          f"hot_lookup_fraction={cs.hot_lookup_fraction:.4f}")
    check(n_hot <= FULL.n_hot and n_cold <= FULL.n_cold,
          "ClickStream row ids fit the tables")
    return model, cs


def on_card(batch):
    import torch

    return (torch.from_numpy(batch["hot_idx"]).to(DEVICE),
            torch.from_numpy(batch["cold_idx"]).to(DEVICE))


def cin_build_report() -> None:
    """Registers and spills of the cin_fused kernels (``-Xptxas -v``, from
    this process's build) and the tensor-core MMA instructions in the
    library's SASS (``cuobjdump``)."""
    import shutil
    from repro_torch.kernels import _build

    lines = [ln.strip() for ln in _build.BUILD_LOG.get("cin_fused", "")
             .splitlines() if "registers" in ln or "spill" in ln
             or "entry function" in ln]
    for ln in lines or ["no ptxas report (library built by another process)"]:
        print(f"  ptxas cin_fused: {ln}")
    cob = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(cob).is_file():
        print("  sass cin_fused: cuobjdump not available")
        return
    sass = subprocess.run([cob, "-sass", str(_build.library_path("cin_fused"))],
                          capture_output=True, text=True, timeout=120).stdout
    mma = [ln for ln in sass.splitlines() if "HGMMA" in ln or "HMMA" in ln]
    kinds = sorted({w for ln in mma for w in ln.split()
                    if w.startswith(("HGMMA", "HMMA"))})
    print(f"  sass cin_fused: {len(mma)} tensor-core MMA instructions {kinds}")
    check(len(mma) > 0, "cin_fused runs on the tensor cores (HGMMA in SASS)")


def kernel_phase_cin(model, batch):
    """Each CIN layer of a real serve_p99 batch: kernel against plain
    version, timed beside its two bounds (3xTF32 on the tensor cores, the
    reported one, and float32 on the CUDA cores), the plain version and
    cuBLAS on the outer product materialised beforehand (not timed)."""
    import torch
    from repro_torch.kernels import cin_fused as K
    from repro_torch.kernels import ops
    from repro_torch.models.recsys import embed_lookup

    cin_build_report()
    params = model.params()
    hot, cold = on_card(batch)
    x0 = embed_lookup(params, hot, cold, "emb")
    b, f0, d = x0.shape
    xk = x0
    total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bound_f32_ms=0.0,
                 library_ms=0.0, err=0.0)
    for i in range(len(model.cfg.cin_layers)):
        w = params[f"cin_w{i}"]
        fk, h = xk.shape[1], w.shape[0]
        got = K.cin_fused_cuda(x0, xk, w)
        want = K.cin_fused_plain(x0, xk, w)
        z = torch.einsum("bid,bjd->ijbd", x0, xk).reshape(f0 * fk, b * d)
        lib = (w @ z).reshape(h, b, d).permute(1, 0, 2)
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        lib_err = float((lib - want).abs().max())
        check(bool(torch.isfinite(got).all()), f"cin layer {i}: finite")
        check(err <= CIN_TOL * scale, f"cin layer {i}: kernel != plain "
              f"({err} > {CIN_TOL} x {scale})")
        check(lib_err <= CIN_TOL * scale, f"cin layer {i}: cuBLAS != plain")
        again = K.cin_fused_cuda(x0, xk, w)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"cin layer {i}: deterministic")
        del again
        ms = time_ms(lambda: K.cin_fused_cuda(x0, xk, w), reps=20)
        plain_ms = time_ms(lambda: K.cin_fused_plain(x0, xk, w), reps=5)
        lib_ms = time_ms(lambda: w @ z, reps=20)
        flops = 2 * h * f0 * fk * d * b
        nbytes = 4 * (x0.numel() + xk.numel() + w.numel() + got.numel())
        b_ms, b_by = bound(nbytes, TF32_PASSES * flops, TF32_OPS_PER_S)
        f32_ms, f32_by = bound(nbytes, flops)
        check(b_by == "operations" and f32_by == "operations",
              "cin bounds are the tensor-core and float32 rates")
        n_split = K.splits(x0.device.index, b * d, f0, fk, h)
        print(f"kernel cin_fused [layer {i}]: B={b} F0={f0} Fk={fk} H={h} "
              f"D={d} K={f0 * fk} flops={flops} splits={n_split} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms(cuBLAS w @ Z)="
              f"{lib_ms:.4f} bound_ms(3xTF32 at {TF32_OPS_PER_S / 1e12:.0f} "
              f"TFLOP/s)={b_ms:.5f} bound_ms(float32 at "
              f"{SCALAR_OPS_PER_S / 1e12:.0f} TFLOP/s)={f32_ms:.5f} "
              f"max_abs_err={err:.3e} max|plain|={scale:.3e} "
              f"err/max|plain|={err / scale:.3e} cuBLAS_err={lib_err:.3e} "
              f"achieved={flops / ms / 1e9:.2f} TFLOP/s (float32 products), "
              f"{b_ms / ms:.3f} of the 3xTF32 bound")
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                     ("bound_f32_ms", f32_ms), ("library_ms", lib_ms)):
            total[k] += v
        total["err"] = max(total["err"], err)
        xk_last, w_last = xk, w
        xk = got
        del z, lib, want
    print(f"kernel cin_fused [one forward, 3 layers]: ms={total['ms']:.4f} "
          f"plain_ms={total['plain_ms']:.4f} library_ms="
          f"{total['library_ms']:.4f} bound_ms(3xTF32)="
          f"{total['bound_ms']:.5f} bound_ms(float32)="
          f"{total['bound_f32_ms']:.5f} kernel/library="
          f"{total['ms'] / total['library_ms']:.3f}")
    LAUNCH_CASES["cin_fused [layer 2]"] = (
        lambda: ops.cin_fused(x0, xk_last, w_last))
    return total


def serve_batch(model, batch):
    """One scoring request: host indices -> card -> logits -> host."""
    import torch

    with torch.no_grad():
        hot, cold = on_card(batch)
        return model(hot, cold).cpu()


def check_logits(model, batch, got, what: str) -> float:
    """``got`` (host logits of ``batch``) against the same forward with the
    plain CIN, on the card."""
    import torch
    from repro_torch.kernels.cin_fused import cin_fused_plain
    from repro_torch.models.recsys import xdeepfm_logits

    with torch.no_grad():
        want = xdeepfm_logits(model.cfg, model.params(), *on_card(batch),
                              cin_op=cin_fused_plain).cpu()
    check(got.shape == want.shape == (batch["hot_idx"].shape[0],),
          f"{what}: logits shape")
    check(bool(torch.isfinite(got).all()), f"{what}: logits finite")
    err = (got - want).abs()
    check(bool((err <= LOGIT_ATOL + LOGIT_RTOL * want.abs()).all()),
          f"{what}: kernel logits != plain logits")
    print(f"{what}: {got.shape[0]} logits within {LOGIT_ATOL} + "
          f"{LOGIT_RTOL} |plain| of the plain forward (max_abs_err="
          f"{float(err.max()):.3e}, logits in [{float(want.min()):.4f}, "
          f"{float(want.max()):.4f}])")
    return float(err.max())


def serve_run(model, batches, name: str):
    """Score ``batches`` (after ``batches[0]`` as a warm-up), launch counts
    zeroed before and read after; returns per-batch seconds, the logits and
    the launches."""
    import torch
    from repro_torch.kernels import ops

    serve_batch(model, batches[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    times, logits = [], []
    for bt in batches[1:]:
        t0 = time.perf_counter()
        logits.append(serve_batch(model, bt))
        times.append(time.perf_counter() - t0)
    launches = dict(ops.LAUNCHES)
    n = len(batches) - 1
    check(launches["cin_fused"] == len(model.cfg.cin_layers) * n,
          f"{name}: 3 cin_fused launches per forward")
    check(all(v == 0 for k, v in launches.items() if k != "cin_fused"),
          f"{name}: no other kernel on the recsys path")
    return times, logits, launches


def serving_phase(model, cs):
    import numpy as np
    import torch

    t0 = time.perf_counter()
    p99 = [cs.batch(1 + s, P99_BATCH) for s in range(N_P99_BATCHES + 1)]
    print(f"serve_p99: {len(p99)} batches made on the host in "
          f"{time.perf_counter() - t0:.1f} s")
    times, logits, la_p99 = serve_run(model, p99, "serve_p99")
    ms = np.array(times) * 1e3
    print(f"serve_p99: B={P99_BATCH} x {N_P99_BATCHES} batches: median "
          f"{np.median(ms):.3f} ms, p99 {np.percentile(ms, 99):.3f} ms, max "
          f"{ms.max():.3f} ms per batch (host indices to host logits); "
          f"{P99_BATCH * N_P99_BATCHES / sum(times):.1f} samples/s; "
          f"launches {la_p99}")
    err_p99 = check_logits(model, p99[1], logits[0], "serve_p99 batch 1")

    t0 = time.perf_counter()
    bulk = [cs.batch(1000 + s, BULK_BATCH) for s in range(N_BULK_BATCHES)]
    print(f"serve_bulk: {len(bulk)} batches made on the host in "
          f"{time.perf_counter() - t0:.1f} s")
    times, logits, la_bulk = serve_run(model, [bulk[0]] + bulk, "serve_bulk")
    peak = torch.cuda.max_memory_allocated()
    print(f"serve_bulk: B={BULK_BATCH} x {N_BULK_BATCHES} batches: ms "
          f"{[round(t * 1e3, 1) for t in times]}, "
          f"{BULK_BATCH * N_BULK_BATCHES / sum(times):.1f} samples/s; "
          f"max_memory_allocated={peak} B; launches {la_bulk}")
    head = {k: v[:BULK_SLICE] for k, v in bulk[0].items()}
    err_bulk = check_logits(model, head, logits[0][:BULK_SLICE],
                            f"serve_bulk batch 0, first {BULK_SLICE}")
    return dict(p99_batch=p99[1], bulk_batch=bulk[0], launches_p99=la_p99,
                launches_bulk=la_bulk, err=max(err_p99, err_bulk))


def retrieval_phase(model, cs) -> None:
    """retrieval_cand: one query against seeded candidates, top-k against
    a plain sort of the full score row (scores compared; indices only
    where the scores differ)."""
    import torch
    from repro_torch.models.recsys import embed_lookup, retrieval_scores

    gen = torch.Generator(device=DEVICE).manual_seed(1)
    cands = torch.randn((N_CANDIDATES, model.cfg.d_query), generator=gen,
                        device=DEVICE)
    hot, cold = on_card(cs.batch(5000, 1))
    with torch.no_grad():
        vals, idx = retrieval_scores(model, hot, cold, cands, top_k=TOP_K)
        p = model.params()
        q = embed_lookup(p, hot, cold, "emb").reshape(1, -1)
        q = torch.relu(q @ p["q_w0"] + p["q_b0"]) @ p["q_w1"]
        scores = (q @ cands.T)[0]
        srt, order = torch.sort(scores, descending=True)
    torch.cuda.synchronize()
    check(vals.shape == idx.shape == (1, TOP_K), "retrieval shapes")
    check(bool(torch.isfinite(vals).all()), "retrieval scores finite")
    tol = 1e-6 * float(srt.abs().max())
    check(float((vals[0] - srt[:TOP_K]).abs().max()) <= tol,
          "retrieval top-k scores == sorted full row")
    differ = idx[0] != order[:TOP_K]
    if bool(differ.any()):
        gap = (scores[idx[0][differ]] - scores[order[:TOP_K][differ]]).abs()
        check(float(gap.max()) <= tol,
              "retrieval indices differ only at tied scores")
    ms = time_ms(lambda: retrieval_scores(model, hot, cold, cands,
                                          top_k=TOP_K), reps=20)
    print(f"retrieval_cand: 1 query x {N_CANDIDATES} candidates x "
          f"d={model.cfg.d_query}, top {TOP_K}: {ms:.4f} ms per call "
          f"(CUDA events); top score {float(vals[0, 0]):.4f}, "
          f"{int(differ.sum())} indices differ from the sort (ties)")


def flushed_ms(fn, reps: int = FLUSH_REPS) -> float:
    """Milliseconds of one call of ``fn()`` that finds L2 cold, as a caller
    with other kernels in between does: before each call a scratch buffer
    of ``FLUSH_BYTES`` is written, and CUDA events bracket the call alone;
    the median of ``reps`` calls, after one warm-up call. (The fill takes
    longer than a wrapper's host cost, so the call is enqueued before the
    card reaches its start event.)"""
    import torch

    buf = _FLUSH.get("buf")
    if buf is None:
        buf = _FLUSH["buf"] = torch.empty(FLUSH_BYTES, dtype=torch.uint8,
                                          device=DEVICE)
    fn()
    torch.cuda.synchronize()
    events = []
    for i in range(reps):
        buf.fill_(i & 0xFF)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        events.append((start, stop))
    torch.cuda.synchronize()
    ms = sorted(a.elapsed_time(b) for a, b in events)
    return ms[len(ms) // 2]


def free_flush() -> None:
    """Release ``flushed_ms``'s scratch buffer (at the end of a phase, so
    later phases' memory readings do not carry it)."""
    import torch

    _FLUSH.pop("buf", None)
    torch.cuda.empty_cache()


def interleaved_times(fns: dict, reps: int = 20) -> dict:
    """Each call in ``fns`` ({label: fn}) timed three ways, in turns (the
    labels in order, then reversed: a, b, b, a): flushed
    (``flushed_ms``), back to back (``time_ms`` over ``reps`` calls), and
    the profiler's device us of every kernel of a call (``device_us``).
    Returns {label: {"flushed": [ms, ms], "b2b": [ms, ms], "dev": us}}."""
    order = list(fns) + list(fns)[::-1]
    out = {k: {"flushed": [], "b2b": []} for k in fns}
    for k in order:
        out[k]["flushed"].append(flushed_ms(fns[k]))
    for k in order:
        out[k]["b2b"].append(time_ms(fns[k], reps=reps))
    for k in fns:
        out[k]["dev"] = device_us(fns[k])
    return out


def times_line(t: dict, b_ms: float) -> str:
    """One call's three times (both turns) and its share of the bound."""
    return (f"flushed {t['flushed'][0]:.4f} / {t['flushed'][1]:.4f} ms "
            f"({100 * b_ms / min(t['flushed']):.1f}% of bound), back to back "
            f"{t['b2b'][0]:.4f} / {t['b2b'][1]:.4f} ms, device "
            f"{t['dev']:.2f} us")


def bag_bound(table, idx, w, out) -> tuple:
    """Bytes and flops one EmbeddingBag call needs: indices and weights,
    each distinct valid row once, the output; 2 flops per value summed."""
    import torch

    valid = idx[idx >= 0]
    rows = int(torch.unique(valid).numel())
    item = table.element_size()
    nbytes = (idx.numel() * 4 + w.numel() * w.element_size()
              + rows * table.shape[1] * item + out.numel() * item)
    return bound(nbytes, 2 * int(valid.numel()) * table.shape[1])


def bulk_bags(pool, n_bags: int, seed: int):
    """``n_bags`` bags of ``BAG_WIDTH`` ids drawn on the card from ``pool``
    (a batch's valid ids), a quarter set to -1, and normal weights."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    pool = torch.from_numpy(pool).to(DEVICE)
    pick = torch.randint(0, pool.numel(), (n_bags, BAG_WIDTH), generator=gen,
                         device=DEVICE)
    idx = pool[pick].to(torch.int32)
    idx[torch.rand(idx.shape, generator=gen, device=DEVICE) < BULK_PAD] = -1
    w = torch.randn(idx.shape, generator=gen, device=DEVICE)
    return idx, w


def bag_close(got, want, table, idx, w) -> tuple:
    """(within tolerance, max abs error): the error of a float32 sum in
    another order, 1e-6 + 1e-5 sum_l |w_l row_l| (the summed magnitudes, not
    |plain|, which cancellation may take to 0), plus 2**-7 |plain| for a
    bfloat16 table (one bfloat16 rounding step)."""
    import torch
    from repro_torch.kernels import segment_bag as K

    err = (got.float() - want.float()).abs()
    mag = K.segment_bag_plain(table.float().abs(), idx, w.float().abs())
    tol = 1e-6 + 1e-5 * mag
    if table.dtype == torch.bfloat16:
        tol += 2.0**-7 * want.float().abs()
    return bool((err <= tol).all()), float(err.max())


def kernel_phase_segment_bag(model, batches, bulk) -> dict:
    """segment_bag (on no path of the reference) against its plain version
    at the reference tests' shapes and at 512 x 39 bags of 8 hot ids
    (launches counted over these calls); then at the bulk shape: one bag
    per field of a serve_bulk batch (262,144 x 39 bags of 8, a quarter -1)
    over the model's ``emb_hot`` in float32 and bfloat16 (bfloat16
    weights), ids drawn from the batch's hot ids, and over ``emb_cold``
    (float32, ids from its cold ids): each against its plain version,
    timed three ways in turns with ``F.embedding_bag`` (sum, per-sample
    weights), with its bound; the bfloat16 call profiled: one launch a
    call, nothing else."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_bag as K

    rng = np.random.default_rng(0)
    cases = []
    for b, l, v, d, dt in [(5, 3, 50, 8, torch.float32),
                           (130, 7, 200, 130, torch.float32),
                           (64, 1, 10, 16, torch.float32),
                           (3, 20, 1000, 10, torch.bfloat16)]:
        table = torch.from_numpy(rng.normal(size=(v, d)).astype(np.float32))
        idx = torch.from_numpy(rng.integers(-1, v, (b, l)).astype(np.int32))
        wgt = torch.from_numpy(rng.normal(size=(b, l)).astype(np.float32))
        cases.append((f"{b}x{l} V={v} D={d} {dt}", table.to(DEVICE, dt),
                      idx.to(DEVICE), wgt.to(DEVICE, dt)))
    pool = np.concatenate([bt["hot_idx"][bt["hot_idx"] >= 0] for bt in batches])
    n_bags = P99_BATCH * model.cfg.n_sparse
    small_idx = rng.choice(pool, (n_bags, BAG_WIDTH)).astype(np.int32)
    small_idx[rng.random(small_idx.shape) < BULK_PAD] = -1
    small_idx = torch.from_numpy(small_idx).to(DEVICE)
    small_w = torch.from_numpy(rng.normal(size=(n_bags, BAG_WIDTH))
                               .astype(np.float32)).to(DEVICE)
    params = model.params()
    emb_hot = params["emb_hot"]
    for dt in (torch.float32, torch.bfloat16):
        cases.append((f"{n_bags}x{BAG_WIDTH} emb_hot {tuple(emb_hot.shape)} "
                      f"{dt}", emb_hot.to(dt), small_idx, small_w.to(dt)))
    ops.reset_launches()
    out = {}
    for name, table, idx, w in cases:
        got = ops.segment_bag(table, idx, w)
        want = K.segment_bag_plain(table, idx, w)
        torch.cuda.synchronize()
        ok, out[name] = bag_close(got, want, table, idx, w)
        check(ok, f"segment_bag {name}: kernel != plain")
    launches = ops.LAUNCHES["segment_bag"]
    check(launches == len(cases), "segment_bag launches of the phase")
    print(f"kernel segment_bag: {len(cases)} shapes within tolerance of the "
          f"plain version: {out}")
    LAUNCH_CASES["segment_bag [float32]"] = (
        lambda a=(emb_hot, small_idx, small_w): ops.segment_bag(*a))

    n_bulk = bulk["hot_idx"].size
    hot_idx, hot_w = bulk_bags(bulk["hot_idx"][bulk["hot_idx"] >= 0],
                               n_bulk, 1)
    cold_idx, cold_w = bulk_bags(bulk["cold_idx"][bulk["cold_idx"] >= 0],
                                 n_bulk, 2)
    lines = [("emb_hot float32", emb_hot, hot_idx, hot_w),
             ("emb_hot bfloat16", emb_hot.to(torch.bfloat16), hot_idx,
              hot_w.to(torch.bfloat16)),
             ("emb_cold float32", params["emb_cold"], cold_idx, cold_w)]
    res = {}
    for name, table, idx, w in lines:
        got = ops.segment_bag(table, idx, w)
        want = K.segment_bag_plain(table, idx, w)
        torch.cuda.synchronize()
        ok, err = bag_close(got, want, table, idx, w)
        check(ok, f"segment_bag bulk {name}: kernel != plain")
        same = float((got == want).float().mean())
        del got
        valid = idx >= 0
        safe = idx.clamp(min=0)
        psw = torch.where(valid, w, 0)
        lib = F.embedding_bag(safe, table, mode="sum", per_sample_weights=psw)
        torch.cuda.synchronize()
        check(bool(((lib.float() - want.float()).abs()
                    <= 2.0**-7 * want.float().abs() + 1e-6).all()),
              f"segment_bag bulk {name}: embedding_bag yardstick agrees")
        del lib
        b_ms, b_by = bag_bound(table, idx, w, want)
        del want
        fns = {"kernel": lambda a=(table, idx, w): K.segment_bag_cuda(*a),
               "embedding_bag": lambda a=(safe, table, psw): F.embedding_bag(
                   a[0], a[1], mode="sum", per_sample_weights=a[2])}
        times = interleaved_times(fns)
        plain_ms = time_ms(lambda a=(table, idx, w): K.segment_bag_plain(*a),
                           reps=2, rounds=1)
        print(f"kernel segment_bag [bulk: {n_bulk} bags x {BAG_WIDTH}, "
              f"{name} {tuple(table.shape)}]: valid slots="
              f"{int(valid.sum())} max_abs_err={err:.3e} (bit-equal share "
              f"{same:.8f}) bound_ms="
              f"{b_ms:.6f} ({b_by}) plain_ms={plain_ms:.4f}")
        for k, t in times.items():
            print(f"  {k}: {times_line(t, b_ms)}")
        res[name] = dict(ms=min(times["kernel"]["flushed"]), plain_ms=plain_ms,
                         library_ms=min(times["embedding_bag"]["flushed"]),
                         bound_ms=b_ms, bound_by=b_by, err=err)
        if name == "emb_hot bfloat16":
            span_check(lambda a=(table, idx, w): ops.segment_bag(*a),
                       "segment_bag_kernel", "segment_bag bfloat16 weights")
    del hot_idx, hot_w, cold_idx, cold_w, lines, fns
    free_flush()
    return dict(res["emb_hot float32"], launches=launches)


def payload_bound(parents, payload_w: int, active) -> tuple:
    """Bytes and operations one call needs: every active flag and output
    value; for the rows with an active lane, all their ids, the weights of
    their valid slots and each distinct valid parent's payload row once;
    an add and a min per valid slot and lane."""
    import numpy as np

    on = active.any(1)
    ids = parents[on]
    valid = ids[ids >= 0]
    nbytes = (2 * active.size * 4 + ids.size * 4 + valid.size * 4
              + np.unique(valid).size * payload_w * 4)
    return bound(nbytes, 2 * valid.size * payload_w)


def payload_cases(g, csr) -> tuple:
    """The ell_pull_payload inputs (numpy): the reference test's shape and
    the ELL of partition 0's rows with 1..TH parents of the scale-20 graph,
    W = 32, with 70% of the lanes active and with ``PAYLOAD_ROWS_ON`` of the
    rows active. Returns ([(name, parents, payload, weights, active)], the
    two large cases' names)."""
    import numpy as np
    from repro_torch.core.types import PartitionLayout

    rng = np.random.default_rng(5)
    small = rng.integers(-1, 40, size=(64, 5)).astype(np.int32)
    payload = rng.integers(0, 50, size=(40, 8)).astype(np.int32)
    payload[rng.random((40, 8)) < 0.3] = 2**30
    cases = [("64x5 W=8 (reference test)", small, payload,
              rng.integers(1, 16, size=(64, 5)).astype(np.int32),
              (rng.random((64, 8)) < 0.7).astype(np.int32))]
    offsets, dst = csr
    deg = np.diff(offsets)
    layout = PartitionLayout(g.n, P_RANK, P_GPU)
    rows = np.flatnonzero((layout.part_of(np.arange(g.n)) == 0)
                          & (deg >= 1) & (deg <= TH))
    parents = np.full((rows.size, TH), -1, np.int32)
    rdeg = deg[rows]
    r_of = np.repeat(np.arange(rows.size), rdeg)
    slot = np.arange(r_of.size) - np.repeat(np.cumsum(rdeg) - rdeg, rdeg)
    parents[r_of, slot] = dst[np.repeat(offsets[rows], rdeg) + slot]
    w = 32
    p_big = rng.integers(0, 50, size=(g.n, w)).astype(np.int32)
    p_big[rng.random((g.n, w)) < 0.3] = 2**30
    a_big = (rng.random((rows.size, w)) < 0.7).astype(np.int32)
    wt_big = rng.integers(1, 16, size=parents.shape).astype(np.int32)
    a_few = a_big * (rng.random((rows.size, 1)) < PAYLOAD_ROWS_ON)
    big_name = f"scale-{SCALE} partition 0, {rows.size} rows x {TH}, W={w}"
    few_name = f"{big_name}, {PAYLOAD_ROWS_ON:.0%} of rows active"
    cases += [(big_name, parents, p_big, wt_big, a_big),
              (few_name, parents, p_big, wt_big, a_few)]
    return cases, (big_name, few_name)


def kernel_phase_payload(g, csr) -> dict:
    """ell_pull_payload (on no path of the reference) against its plain
    version, exactly, on ``payload_cases``; the large cases timed three
    ways and profiled: one launch a call, nothing else."""
    import torch
    from repro_torch.kernels import ell_pull_payload as K
    from repro_torch.kernels import ops

    cases, (big_name, few_name) = payload_cases(g, csr)
    _, parents, _, _, a_big = cases[1]
    a_few, w = cases[2][4], a_big.shape[1]
    ops.reset_launches()
    on_card = {}
    for name, *arrays in cases:
        args = tuple(torch.from_numpy(a).to(DEVICE) for a in arrays)
        got = ops.ell_pull_payload(*args)
        want = K.ell_pull_payload_plain(*args)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"ell_pull_payload {name}: kernel != plain")
        on_card[name] = args
        del want
    launches = ops.LAUNCHES["ell_pull_payload"]
    check(launches == len(cases), "ell_pull_payload launches of the phase")
    big_args = on_card[big_name]
    LAUNCH_CASES["ell_pull_payload"] = lambda: ops.ell_pull_payload(*big_args)
    res = {}
    for name, act in ((big_name, a_big), (few_name, a_few)):
        args = on_card[name]
        b_ms, b_by = payload_bound(parents, w, act)
        times = interleaved_times(
            {"kernel": lambda a=args: K.ell_pull_payload_cuda(*a)})
        act_rows = parents[act.any(1)]
        print(f"kernel ell_pull_payload [{name}]: rows active="
              f"{act_rows.shape[0]} valid slots of active rows="
              f"{int((act_rows >= 0).sum())} bound_ms={b_ms:.6f} ({b_by})")
        for k, t in times.items():
            print(f"  {k}: {times_line(t, b_ms)}")
        res[name] = dict(ms=min(times["kernel"]["flushed"]), bound_ms=b_ms,
                         bound_by=b_by)
    span_check(lambda: ops.ell_pull_payload(*big_args),
               "ell_pull_payload_kernel", "ell_pull_payload")
    free_flush()
    plain_ms = time_ms(lambda: K.ell_pull_payload_plain(*big_args), reps=2)
    print(f"kernel ell_pull_payload: {len(cases)} shapes exact; plain_ms="
          f"{plain_ms:.4f} [{big_name}]; library_ms: null (no single "
          "PyTorch call computes a min-plus gather)")
    return dict(res[big_name], plain_ms=plain_ms, launches=launches, err=0.0)


def profile_serve(model, batch) -> None:
    """``torch.profiler`` over one serve_p99 forward."""
    import torch

    hot, cold = on_card(batch)

    def run():
        with torch.no_grad():
            return model(hot, cold)

    profile_run(run, lambda _: f"one serve_p99 forward, B={hot.shape[0]}",
                ("cin_w_split_kernel", "cin_fused_kernel",
                 "cin_split_sum_kernel"))


def fold_cases(k: int, nw: int, w: int) -> dict:
    """The fold calls of the launch-cost phase on seeded words of the
    delegate fold's shape ``[k, nw]``: both wrappers and ``torch.amin``;
    and both fused delegate updates beside the chains they replaced, on
    seeded planes of the paths' shapes (``k`` partitions, ``nw``
    delegates, ``w`` lanes; half the levels unvisited, 3 targets a lane)."""
    import torch
    from repro_torch.core import comm as TC
    from repro_torch.kernels import ops

    gen = torch.Generator(device=DEVICE).manual_seed(3)
    parts = torch.randint(0, 2**30, (k, nw), generator=gen, device=DEVICE,
                          dtype=torch.int32)
    prev = torch.randint(0, 2**30, (nw,), generator=gen, device=DEVICE,
                         dtype=torch.int32)
    stacked = torch.cat([prev[None], parts])
    words = torch.randint(-2**31, 2**31, (k, nw, -(-w // 32)), generator=gen,
                          device=DEVICE, dtype=torch.int32)
    level = torch.randint(0, 8, (k, nw, w), generator=gen, device=DEVICE,
                          dtype=torch.int32)
    level[torch.rand((k, nw, w), generator=gen, device=DEVICE) < 0.5] = 2**30
    it = torch.full((k,), 7, dtype=torch.int32, device=DEVICE)
    target = torch.zeros((k, nw, w), dtype=torch.bool, device=DEVICE)
    rows = torch.randint(0, nw, (3, w), generator=gen, device=DEVICE)
    target[:, rows, torch.arange(w, device=DEVICE)] = True
    cand = torch.where(torch.rand((k, nw), generator=gen, device=DEVICE) < 0.3,
                       8, 2**30).to(torch.int32)
    levels_d = torch.where(torch.rand((k, nw), generator=gen, device=DEVICE)
                           < 0.5, 3, 2**30).to(torch.int32)
    return {"mask_reduce": lambda: ops.mask_reduce(parts, prev,
                                                   with_count=False),
            "payload_min_fold": lambda: ops.payload_min_fold(
                parts, prev, with_count=False),
            "torch.amin": lambda: stacked.amin(0),
            **or_apply_pair(TC.plan_for(TC.CommConfig(), k), words, level, it,
                            target),
            **min_apply_pair(TC.plan_for(TC.CommConfig(delegate="allgather"),
                                         k), cand, levels_d)}


def pull_launch_cases(eng) -> dict:
    """The pulls' host cost apart from their device time: each sweep entry
    and three single calls of the same pulls, at the paths' shapes, on a
    zero frontier with no row active, so that a launch's device time (every
    row's need read, about 10 us) stays below its host cost and never holds
    the host clock back. Named ``<kernel> [sweep, idle]`` and ``<kernel>
    [3 calls, idle]``; the launch-cost phase measures each pair
    interleaved."""
    import torch
    from repro_torch.kernels import ops

    pgv, p = eng.pgv, eng.pg.p
    dslots = max(eng.pg.d, 1)
    subs = [(pgv.dd, dslots), (pgv.dn, eng.pg.n_local), (pgv.nd, dslots)]
    zeros = lambda *s: torch.zeros(s, dtype=torch.int32, device=DEVICE)
    rows = lambda c: c.offsets.shape[1] - 1
    words = [(c, zeros(p, n, 1), zeros(p, rows(c), 1)) for c, n in subs]
    bits = [(c, zeros(p, (n + 31) // 32), zeros(p, rows(c))) for c, n in subs]
    cw, cb = eng.cfg.pull_chunk, bfs_configs()["FULL"].pull_chunk
    return {
        "ell_pull_multi [sweep, idle]":
            lambda: ops.ell_pull_chunked_sweep(words, cw),
        "ell_pull_multi [3 calls, idle]":
            lambda: [ops.ell_pull_chunked(c.offsets, c.cols, f, n, cw, c.sched)
                     for c, f, n in words],
        "ell_pull [sweep, idle]":
            lambda: ops.ell_pull_bits_sweep(bits, cb),
        "ell_pull [3 calls, idle]":
            lambda: [ops.ell_pull_bits(c.offsets, c.cols, m, a, cb, c.sched)
                     for c, m, a in bits]}


def interleaved_host_us(cases: dict) -> dict:
    """Median host microseconds per call of each of ``cases`` ({name: fn})
    over LAUNCH_ROUNDS rounds, each of which runs every case in turn
    (LAUNCH_FIRST calls, then a synchronize), so that drift of the shared
    host falls on all of them alike."""
    import statistics

    import torch

    for fn in cases.values():
        fn()
    per = {name: [] for name in cases}
    for _ in range(LAUNCH_ROUNDS):
        for name, fn in cases.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(LAUNCH_FIRST):
                fn()
            per[name].append((time.perf_counter() - t0) / LAUNCH_FIRST * 1e6)
    torch.cuda.synchronize()
    return {name: statistics.median(v) for name, v in per.items()}


def launch_cost_phase(cases: dict, when: str) -> None:
    """Host cost of one call of each of ``cases`` ({name: fn}): host clock
    over the first LAUNCH_FIRST and over all LAUNCH_REPS calls, then one
    synchronize (also printed: the time per call up to that synchronize).
    A call whose device time exceeds its host cost fills the launch queue,
    and the host clock then reads the device's time; the first
    LAUNCH_FIRST calls stay clear of that. Each pair of PAIRS (a design and
    the one it replaced: each pull's idle pair, see pull_launch_cases, and
    each fused delegate update beside its old chain) is measured
    interleaved instead. Then, for the folds and the delegate updates, the
    profiler's device time per call, so launch cost and device time stand
    apart (the host times come first: a profiler session raises the
    wrappers' host cost for the rest of the process)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for new, old in PAIRS:
        if new not in cases or old not in cases:
            continue
        a, b = interleaved_host_us({new: cases[new], old: cases[old]}).values()
        print(f"launch cost ({when}) [{new} | {old}]: host_us={a:.2f} | "
              f"{b:.2f} per call (median of {LAUNCH_ROUNDS} interleaved "
              f"rounds of {LAUNCH_FIRST} calls); ratio={a / b:.3f}")
    paired = {n for pair in PAIRS for n in pair}
    host = {}
    for name, fn in cases.items():
        if name in paired:
            continue
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(LAUNCH_REPS):
            if i == LAUNCH_FIRST:
                t_first = time.perf_counter() - t0
            fn()
        t_host = time.perf_counter() - t0
        torch.cuda.synchronize()
        t_sync = time.perf_counter() - t0
        host[name] = t_host / LAUNCH_REPS * 1e6
        print(f"launch cost ({when}) [{name}]: host_us={host[name]:.2f} per "
              f"call ({LAUNCH_REPS} calls, host clock; first {LAUNCH_FIRST}: "
              f"{t_first / LAUNCH_FIRST * 1e6:.2f}), "
              f"{t_sync / LAUNCH_REPS * 1e6:.2f} us per call up to the sync")
    dev = {}
    for name in (n for n in cases if n in FOLD_CASES):
        for _ in range(2):        # a session may get no device records
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(FOLD_PROFILE_REPS):
                    cases[name]()
                torch.cuda.synchronize()
            dev[name] = per_call_us(prof, FOLD_PROFILE_REPS)
            if dev[name] > 0:
                break
        print(f"launch cost ({when}) [{name}]: device_us="
              + (f"{dev[name]:.2f} per call (profiler)" if dev[name] > 0
                 else "not measured (no device records in two sessions)"))
    for new, old in PAIRS:
        if dev.get(new, 0) > 0 and dev.get(old, 0) > 0:
            print(f"launch cost ({when}) [{new} | {old}]: device_us="
                  f"{dev[new]:.2f} | {dev[old]:.2f} per call; ratio="
                  f"{dev[new] / dev[old]:.3f}")
    if "payload_min_fold" in host and "torch.amin" in host:
        print(f"launch cost ({when}): payload_min_fold / torch.amin host "
              f"time = {host['payload_min_fold'] / host['torch.amin']:.3f}")


def recsys_path(g, csr) -> dict:
    """The recsys phases; returns the three kernels' JSON fields and the
    ClickStream (phase 18 trains on it)."""
    model, cs = recsys_setup()
    probe = cs.batch(0, P99_BATCH)
    cin = kernel_phase_cin(model, probe)
    served = serving_phase(model, cs)
    retrieval_phase(model, cs)
    bag = kernel_phase_segment_bag(model, [probe, served["p99_batch"]],
                                   served["bulk_batch"])
    pay = kernel_phase_payload(g, csr)
    profile_serve(model, served["p99_batch"])
    cin_launches = (served["launches_p99"]["cin_fused"]
                    + served["launches_bulk"]["cin_fused"])
    return {
        "cs": cs,
        "cin_fused": dict(launches=cin_launches, max_abs_err=cin["err"],
                          ms=cin["ms"], plain_ms=cin["plain_ms"],
                          bound_ms=cin["bound_ms"], bound_by="operations",
                          library_ms=cin["library_ms"]),
        "segment_bag": dict(launches=bag["launches"], max_abs_err=bag["err"],
                            ms=bag["ms"], plain_ms=bag["plain_ms"],
                            bound_ms=bag["bound_ms"], bound_by=bag["bound_by"],
                            library_ms=bag["library_ms"]),
        "ell_pull_payload": dict(launches=pay["launches"],
                                 max_abs_err=pay["err"], ms=pay["ms"],
                                 plain_ms=pay["plain_ms"],
                                 bound_ms=pay["bound_ms"],
                                 bound_by=pay["bound_by"], library_ms=None),
    }


# ------------------------------------ phase 15: distributed GNN training
#: the reference's own dist-against-local bound (tests/test_gnn_dist.py)
GNN_RTOL, GNN_ATOL = 5e-3, 5e-4
#: (a)'s first-step gradients: each leaf within this share of its largest
#: |local gradient| (near-uniform logits make the gradients ~1e-4, so an
#: absolute bound could not fail); the loss within LOSS_ATOL of the local
#: loss (float32 means of ~5e5 per-node terms summed in another order)
GRAD_REL, LOSS_ATOL = 1e-3, 1e-5
#: the world-1 NCCL run against the emulated one (float32 scatter-adds in
#: another order by the card's atomics, through 3 AdamW steps)
NCCL_RTOL, NCCL_ATOL = 1e-4, 1e-5
GCN_STEPS, MGN_STEPS, GNN_SEED = 5, 3, 0
GNN_LR, MGN_LR = 1e-2, 1e-4            # AdamW (MGN family: 15-16 residual
                                       # blocks move too far at 1e-2)
MGN_GRID, MGN_TH = 512, 6              # mesh_batch(512, 512, 12, 4): d = 0
GC_GRID, GC_LEVELS, GC_TH = 128, 4, 13  # hubs of degree >= 14: delegates
EXAMPLE_STEPS = (30, 60)
MGN_PERTURB = 0.1                      # C2: the scale of the perturbation
GNN_BUDGET_S = 150.0
GNN_BACKEND = "nccl"                   # (e)'s process group


def events_ms(fn) -> tuple:
    """``(fn(), device ms)``: CUDA events around one call."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def leaf_diffs(got, want) -> dict:
    """``{path: (max |want|, max |got - want|)}`` of two tensor trees."""
    from repro_torch.core import convert
    from repro_torch.tree import flatten_with_path

    want = dict(flatten_with_path(convert.tree_to_numpy(want)))
    return {k: (float(abs(want[k]).max()), float(abs(v - want[k]).max()))
            for k, v in flatten_with_path(convert.tree_to_numpy(got))}


def grads_close(got, want, what: str) -> dict:
    """Hold every leaf of ``got`` within ``GRAD_REL`` of its largest
    |``want``|, which must be finite and non-zero; returns
    :func:`leaf_diffs`."""
    import math

    diffs = leaf_diffs(got, want)
    for k, (scale, err) in diffs.items():
        check(math.isfinite(scale) and scale > 0,
              f"{what}: {k} has a finite non-zero local gradient ({scale})")
        check(err <= GRAD_REL * scale,
              f"{what}: {k} max |diff| {err:.3e} within {GRAD_REL} x max "
              f"|local| {scale:.3e}")
    return diffs


def train_steps(step, params, opt, batch, n: int) -> tuple:
    """``n`` steps of ``step``, each timed with CUDA events. Returns
    (params, losses, ms per step -- the first is the warm-up --, peak
    bytes over the run)."""
    import torch

    state, losses, ms = opt.init(params), [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(n):
        (params, state, loss), t = events_ms(lambda: step(params, state, batch))
        losses.append(float(loss))
        ms.append(t)
    return params, losses, ms, torch.cuda.max_memory_allocated()


def gnn_gcn(g, pg, pgv, plan) -> dict:
    """(a) gcn-cora at ogb_products widths on the scale-20 partition."""
    import numpy as np
    import torch
    from repro_torch.configs.base import GNN_SHAPES, get_arch
    from repro_torch.core import engine as TE
    from repro_torch.models import gnn as G
    from repro_torch.models.common import materialize
    from repro_torch.train import gnn_batches as GB, gnn_dist as GD
    from repro_torch.train.optim import get_optimizer
    from repro_torch.train.trainer import value_and_grad

    shape = GNN_SHAPES["ogb_products"]
    arch = get_arch("gcn-cora")
    cfg = arch.model(shape)
    print(f"gnn (a): reduced: {arch.name} at ogb_products widths "
          f"({shape['n_nodes']:,} nodes, {shape['n_edges']:,} edges, d_feat "
          f"{shape['d_feat']}) on the scale-{SCALE} RMAT partition ({pg.n:,} "
          f"vertices, {int(g.m):,} edges, p = {pg.p}, d = {pg.d:,}), cut for "
          "host set-up time; the dataset is not in the repository")
    t0 = time.perf_counter()
    rng = np.random.default_rng(GNN_SEED)
    feats = (rng.random((pg.n, cfg.d_in), dtype=np.float32) < 0.05).astype(
        np.float32)
    labels = rng.integers(0, cfg.n_classes, pg.n).astype(np.int32)
    mask = rng.random(pg.n) < 0.5
    w = TE.device_weights(TE.build_edge_weights(pg, g.out_degrees(), "sym"),
                          DEVICE)
    batch = GB.batch_to_device(GB.gcn_batch(pg, feats, labels, mask), DEVICE)
    local = G.batch_to(G.GraphBatch(nodes=feats, senders=g.src.astype(np.int32),
                                    receivers=g.dst.astype(np.int32)), DEVICE)
    y, m = torch.from_numpy(labels).to(DEVICE), torch.from_numpy(mask).to(DEVICE)
    params = materialize(G.gcn_param_specs(cfg), GNN_SEED, DEVICE)
    setup_s = time.perf_counter() - t0
    loss_fn = lambda prm, bt: GD.dist_gcn_loss(cfg, prm, pgv, plan, w, bt)
    with torch.no_grad():
        ln, ld = GD.dist_gcn_forward(cfg, params, pgv, plan, w, batch["x_n"],
                                     batch["x_d"])
        got = torch.from_numpy(TE.gather_features(pg, ln.cpu().numpy(),
                                                  ld[0].cpu().numpy()))
        want = G.gcn_forward(cfg, params, local).cpu()
    err = float((got - want).abs().max())
    check(bool(((got - want).abs() <= GNN_ATOL + GNN_RTOL * want.abs()).all()),
          f"gnn (a): distributed logits equal the local model within rtol "
          f"{GNN_RTOL}, atol {GNN_ATOL} (max |diff| {err:.3e})")
    loss, grads = value_and_grad(loss_fn, params, batch)
    lloss, lgrads = value_and_grad(
        lambda prm: G.gcn_loss(cfg, prm, local, y, m), params)
    dloss = abs(float(loss) - float(lloss))
    check(dloss <= LOSS_ATOL, f"gnn (a): loss {float(loss)} within "
          f"{LOSS_ATOL} of the local {float(lloss)} (|diff| {dloss:.3e})")
    gd = grads_close(grads, lgrads,
                     "gnn (a): first step's gradients against the local model")
    # the bound's power: the local gradient over half the train mask (every
    # second vertex) must fall outside it
    half = m & (torch.arange(pg.n, device=DEVICE) % 2 == 0)
    hloss, hgrads = value_and_grad(
        lambda prm: G.gcn_loss(cfg, prm, local, y, half), params)
    hd = leaf_diffs(hgrads, lgrads)
    check(any(err > GRAD_REL * scale for scale, err in hd.values()),
          f"gnn (a): a half-mask gradient fails the bound ({hd})")
    gtxt = ", ".join(f"{k} {err:.3e} of max |g| {s:.3e} (half mask "
                     f"{hd[k][1]:.3e})" for k, (s, err) in gd.items())
    opt = get_optimizer(arch.optimizer, lr=GNN_LR)
    step = GD.make_dist_train_step(loss_fn, opt)
    _, losses, ms, peak = train_steps(step, params, opt, batch, GCN_STEPS)
    check(losses[-1] < losses[0], f"gnn (a): the loss falls ({losses})")
    warm, ms = ms[0], ms[1:]
    rb = [TE.payload_round_bytes(plan, axis_sizes=(pg.p,), d=pg.d, feat=f)
          for f in (cfg.d_hidden, cfg.n_classes)]
    p2, st2 = params, opt.init(params)
    profile_run(lambda: step(p2, st2, batch)[2],
                lambda out: f"gnn (a) one gcn-cora training step (loss "
                            f"{float(out):.4f})", ())
    ms_step = sorted(ms)[len(ms) // 2]
    print(f"gnn (a): {cfg}; set-up {setup_s:.1f} s; logits max |diff| "
          f"{err:.3e}; loss |diff| {dloss:.3e} (half mask "
          f"{abs(float(hloss) - float(lloss)):.3e}); gradients max |diff| "
          f"against the local model, bound {GRAD_REL} x max |g|: {gtxt}; "
          f"{GCN_STEPS} {arch.optimizer} steps, losses "
          f"{[round(x, 5) for x in losses]}; ms per step {ms_step:.2f} "
          f"(median of {[round(x, 2) for x in ms]}, CUDA events; warm-up "
          f"step {warm:.2f}); peak {gib(peak)}; one round's wire bytes: layer 1 "
          f"{rb[0]}, layer 2 {rb[1]}")
    return {"ms": ms_step, "peak": peak}


def mgn_runs(name: str, cfg, gb, th: int, steps: int, residual: bool) -> dict:
    """(b) / (c): a mesh batch partitioned at p = 2, the distributed
    forward against the local model, then ``steps`` AdamW steps."""
    import numpy as np
    import torch
    from repro_torch.core import bfs as TB, engine as TE
    from repro_torch.core.partition import partition_graph
    from repro_torch.core.types import COOGraph
    from repro_torch.models import gnn as G
    from repro_torch.models.common import materialize
    from repro_torch.train import gnn_batches as GB, gnn_dist as GD
    from repro_torch.train.optim import AdamW
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    n = gb.nodes.shape[0]
    graph = COOGraph(n, gb.senders.astype(np.int64), gb.receivers.astype(np.int64))
    pg = partition_graph(graph, th=th, p_rank=1, p_gpu=2)
    pgv = TB.device_view(pg, DEVICE)
    plan = TE.device_plan(TE.build_exchange_plan(pg), DEVICE)
    mcfg = G.graphcast_mgn(cfg) if residual else cfg
    tgt = np.random.default_rng(GNN_SEED).normal(
        size=(n, mcfg.d_out)).astype(np.float32)
    batch = GB.batch_to_device(GB.mgn_batch(pg, gb.nodes, gb.edge_feats, tgt),
                               DEVICE)
    params = materialize(G.mgn_param_specs(mcfg), GNN_SEED, DEVICE)
    setup_s = time.perf_counter() - t0
    fwd = G.graphcast_forward if residual else G.mgn_forward
    lgb = G.batch_to(gb, DEVICE)

    def forward_err(prm, what: str) -> float:
        """The gathered distributed forward against the local model."""
        with torch.no_grad():
            on, od = GD.dist_mgn_forward(mcfg, prm, pgv, plan, batch)
            if residual:
                on, od = on + batch["x_n"], od + batch["x_d"]
            got = torch.from_numpy(TE.gather_features(
                pg, on.cpu().numpy(), od[0].cpu().numpy()))
            want = fwd(cfg, prm, lgb).cpu()
        err = float((got - want).abs().max())
        check(bool(torch.isfinite(want).all()) and bool(
            ((got - want).abs() <= GNN_ATOL + GNN_RTOL * want.abs()).all()),
              f"gnn {name}: distributed forward equals the local model "
              f"{what} within rtol {GNN_RTOL}, atol {GNN_ATOL} (max |diff| "
              f"{err:.3e})")
        return err

    err = forward_err(params, "at the materialized parameters")
    # C2: every leaf + MGN_PERTURB N(0, 1) (biases and LN offsets too, so
    # enc_edge(0) != 0 reaches the padding edge slots, which the port masks)
    gen = torch.Generator(device=DEVICE).manual_seed(GNN_SEED + 1)
    perturbed = tree_map(lambda a: a + MGN_PERTURB * torch.randn(
        a.shape, generator=gen, device=a.device, dtype=a.dtype), params)
    err_pert = forward_err(perturbed, f"at parameters + {MGN_PERTURB} N(0, 1)")
    del perturbed
    opt = AdamW(lr=MGN_LR)
    step = GD.make_dist_train_step(
        lambda prm, bt: GD.dist_mgn_loss(mcfg, prm, pgv, plan, bt,
                                         residual=residual), opt)
    trained, losses, ms, peak = train_steps(step, params, opt, batch, steps)
    check(all(np.isfinite(losses)), f"gnn {name}: finite losses {losses}")
    check(steps == 1 or losses[-1] < losses[0],
          f"gnn {name}: the loss falls ({losses})")
    err_step = forward_err(trained, f"after {steps} AdamW steps")
    print(f"gnn {name}: {cfg}; graph n={n:,} m={int(graph.m):,}, p = {pg.p}, "
          f"th = {th}, d = {pg.d}; set-up {setup_s:.1f} s; forward max |diff| "
          f"against the local model: {err:.3e} at the materialized "
          f"parameters, {err_pert:.3e} at parameters + {MGN_PERTURB} N(0, 1) "
          f"(non-zero biases: C2), {err_step:.3e} after the steps; {steps} "
          f"AdamW steps, losses {[round(x, 5) for x in losses]}; ms per step "
          f"{[round(x, 2) for x in ms]} (CUDA events, the first a warm-up; "
          f"per-layer recompute under torch.utils.checkpoint); peak "
          f"{gib(peak)}")
    return {"ms": ms, "peak": peak}


def gnn_example() -> None:
    """(d) ``examples/torch_gnn_training.py`` twice on one ``--ckpt``: the
    second run restores step 30 and ends at 60 with a lower loss."""
    import os
    import re
    import tempfile

    ckpt = tempfile.mkdtemp(prefix="chip_smoke_gnn_ckpt_")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    done = []
    for steps in EXAMPLE_STEPS:
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, str(ROOT / "examples" / "torch_gnn_training.py"),
             "--steps", str(steps), "--ckpt", ckpt, "--device", DEVICE],
            env=env, capture_output=True, text=True, timeout=300)
        check(out.returncode == 0, f"gnn (d): example --steps {steps} rc "
              f"{out.returncode}: {out.stderr[-2000:]}")
        m = re.search(r"done: (\d+) steps \((\d+) run here, (\d+) restarts\), "
                      r"loss ([\d.]+) -> ([\d.]+)", out.stdout)
        check(m is not None, f"gnn (d): example summary in {out.stdout!r}")
        done.append([float(x) for x in m.groups()])
        print(f"gnn (d): example --steps {steps}: {m.group(0)} "
              f"({time.perf_counter() - t0:.1f} s)")
    (f1, r1, _, _, l1), (f2, r2, _, _, l2) = done
    check((f1, r1, f2, r2) == (30, 30, 60, 30),
          "gnn (d): the second run restored step 30 and ran 30 to 60")
    check(l2 < l1, f"gnn (d): the resumed run ends lower ({l2} < {l1})")


def gnn_nccl_rank(rank: int, world: int, spec: dict) -> dict:
    """(e) One rank of a world-1 NCCL mesh: the sharded GCN training step
    (differentiable collectives) and the emulated one, 3 AdamW steps each
    from the same parameters on the same card. Returns both parameter
    trees (numpy) and losses."""
    import torch
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.configs.gcn_cora import model_for_shape
    from repro_torch.core import bfs as TB, comm as C, convert, engine as TE
    from repro_torch.core.partition import partition_graph
    from repro_torch.graphs.synthetic import cora_like
    from repro_torch.models import gnn as G
    from repro_torch.models.common import materialize
    from repro_torch.train import gnn_batches as GB, gnn_dist as GD
    from repro_torch.train.optim import AdamW

    dev = spec["device"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shape = GNN_SHAPES["full_graph_sm"]
    cfg = model_for_shape(shape)
    g, feats, labels, mask = cora_like(n=shape["n_nodes"], d_feat=shape["d_feat"],
                                       seed=spec["seed"])
    pg = partition_graph(g, th=spec["th"], p_rank=1, p_gpu=1)
    pgv = TB.device_view(pg, dev)
    plan = TE.device_plan(TE.build_exchange_plan(pg), dev)
    w = TE.device_weights(TE.build_edge_weights(pg, g.out_degrees()), dev)
    batch = GB.batch_to_device(GB.gcn_batch(pg, feats, labels, mask), dev)
    mesh = C.dist.PartitionMesh(("p",), (1,))
    out = {"n": g.n, "m": int(g.m), "d": pg.d}
    for name, msh in (("mesh", mesh), ("emulated", None)):
        params = materialize(G.gcn_param_specs(cfg), spec["seed"], dev)
        opt = AdamW(lr=GNN_LR)
        step = GD.make_dist_train_step(
            lambda prm, bt: GD.dist_gcn_loss(cfg, prm, pgv, plan, w, bt, msh),
            opt, msh)
        state, losses = opt.init(params), []
        for _ in range(spec["steps"]):
            params, state, loss = step(params, state, batch)
            losses.append(float(loss))
        out[name] = {"params": convert.tree_to_numpy(params), "losses": losses}
    return out


def gnn_nccl() -> None:
    """(e) the world-1 NCCL run in a spawned process."""
    import numpy as np
    from repro_torch.core import comm as C
    from repro_torch.tree import flatten_with_path

    t0 = time.perf_counter()
    (res,) = C.dist.spawn(gnn_nccl_rank, 1, (dict(seed=GNN_SEED, th=16,
                                                  steps=3, device=DEVICE),),
                          backend=GNN_BACKEND, timeout=WORLD_TIMEOUT)
    want = dict(flatten_with_path(res["emulated"]["params"]))
    worst = 0.0
    for k, v in flatten_with_path(res["mesh"]["params"]):
        err = np.abs(v - want[k])
        worst = max(worst, float(err.max()))
        check(bool((err <= NCCL_ATOL + NCCL_RTOL * np.abs(want[k])).all()),
              f"gnn (e): world-1 NCCL parameter {k} equals the emulated run")
    print(f"gnn (e): full_graph_sm cora_like (n={res['n']}, m={res['m']}, "
          f"d={res['d']}, d_feat 1433), world 1 under {GNN_BACKEND}: 3 AdamW "
          f"steps, "
          f"losses {res['mesh']['losses']} (emulated "
          f"{res['emulated']['losses']}), parameters max |diff| {worst:.3e} "
          f"(rtol {NCCL_RTOL}, atol {NCCL_ATOL}); "
          f"{time.perf_counter() - t0:.1f} s")


def gnn_path(g, pg, pgv, plan) -> None:
    """Phase 15: (a)-(e) of the distributed GNN training path."""
    import torch
    from repro_torch.configs import graphcast, meshgraphnet
    from repro_torch.graphs.synthetic import mesh_batch

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"gnn phase ({card_line()}): allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}")
    gnn_gcn(g, pg, pgv, plan)
    torch.cuda.empty_cache()
    mgn_cfg = meshgraphnet.model_for_shape({})
    mgn_runs("(b) meshgraphnet", mgn_cfg,
             mesh_batch(MGN_GRID, MGN_GRID, mgn_cfg.d_node_in, mgn_cfg.d_edge_in),
             MGN_TH, MGN_STEPS, residual=False)
    torch.cuda.empty_cache()
    gc_cfg = graphcast.model_for_shape({})
    mgn_runs("(c) graphcast", gc_cfg,
             mesh_batch(GC_GRID, GC_GRID, gc_cfg.n_vars, gc_cfg.d_edge_in,
                        multimesh_levels=GC_LEVELS), GC_TH, 1, residual=True)
    torch.cuda.empty_cache()
    gnn_example()
    gnn_nccl()
    phase_s = time.perf_counter() - t_start
    print(f"gnn phase: {phase_s:.1f} s (budget {GNN_BUDGET_S:.0f} s)")


# ------------- phases 16-18: the entry points, the CIN backward, recsys training
#: the CIN backward kernels against their plain versions, per element:
#: |kernel - plain| <= CIN_BWD_ATOL x max|plain| + CIN_BWD_RTOL x |plain|
#: (float32 sums in another order; the forward's 1e-4 x max|plain|)
CIN_BWD_RTOL, CIN_BWD_ATOL = 1e-4, 1e-5
CIN_BWD_CHECK_BATCHES = (512, 1000)     # 1,000: no tile multiple
CIN_BWD_TIME_REPS = 3                   # calls of ~0.1-0.3 s each
#: recsys training: RECSYS_SHAPES["train_batch"], the check batch, steps
TRAIN_BATCH, TRAIN_CHECK_BATCH = 65536, 4096
TRAIN_WARMUP, TRAIN_TIMED, TRAIN_LR = 2, 8, 1e-3
#: the entry points, each in a subprocess
EXAMPLE_SCALE, EXAMPLE_REQUESTS, EXAMPLE_TIMEOUT = 16, 120, 600
SWEEP_ARGS = ("--delegates", "auto", "ring", "--nn-formats", "dense",
              "--sweep-blocks", "4", "8")
SWEEP_EXACT = ("sweeps", "sweep_blocks", "wire_delegate_bytes",
               "wire_nn_bytes", "nn_sparse_sweeps", "nn_overflow",
               "frontier_skew", "wire_skew")


def run_script(args, cwd, what: str) -> str:
    """A script of the checkout in a subprocess with the port on its path;
    fails the run on a non-zero exit. Returns its output."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, *map(str, args)], cwd=cwd, env=env,
                         capture_output=True, text=True,
                         timeout=EXAMPLE_TIMEOUT)
    check(out.returncode == 0, f"{what}: rc {out.returncode}\n"
          f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    print(f"examples: {what} rc 0 in {time.perf_counter() - t0:.1f} s")
    return out.stdout


def match_lines(out: str, n: int, what: str) -> list:
    lines = [ln.strip() for ln in out.splitlines() if "match=" in ln]
    check(len(lines) == n and all("match=OK" in ln for ln in lines),
          f"{what}: {n} sources, every one match=OK ({lines})")
    for ln in lines:
        print(f"  {what}: {ln}")
    return lines


def examples_path() -> None:
    """Phase 16: the three BFS examples and the calibration sweep on the
    card, each in a subprocess (outputs in a temporary directory)."""
    import json as _json
    import tempfile

    from repro_torch.obs.artifact import BENCH_SCHEMA, load_bench

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_examples_"))
    t_start = time.perf_counter()
    ex = ROOT / "examples"
    out = run_script([ex / "torch_quickstart.py", "--scale", EXAMPLE_SCALE,
                      "--device", DEVICE], tmp, "torch_quickstart.py")
    match_lines(out, 3, "quickstart")
    mem = [ln for ln in out.splitlines() if ln.startswith("memory:")]
    print(f"  quickstart: {mem[0] if mem else 'no memory line'}")
    check(bool(mem), "quickstart: memory ratios printed")

    out = run_script([ex / "torch_bfs_serving.py", "--scale", EXAMPLE_SCALE,
                      "--requests", EXAMPLE_REQUESTS, "--mixed", "--refill",
                      "--overlap", "--trace", "--profile", "--device",
                      DEVICE], tmp, "torch_bfs_serving.py --mixed --refill "
                      "--overlap --trace --profile")
    for ln in out.splitlines():
        if ln.startswith(("served", "wire:", "msbfs", "profile:", "telemetry",
                          "engine ready")):
            print(f"  serving: {ln}")
    check("spot-checked per-kind answers against the oracle: OK" in out,
          "serving: answers held against the oracle")
    trace = _json.loads((tmp / "serve_trace.json").read_text())
    _json.loads((tmp / "serve_metrics.json").read_text())
    doc = load_bench(str(tmp / "CALIB_device.json"))
    cell = doc["benchmarks"]["device_calibration"]["cells"]["serving"]
    check(doc["schema"] == BENCH_SCHEMA and doc["meta"]["backend"] == "cuda",
          "serving: the calibration artifact parses, taken on the card")
    check(cell["nn_overflow"] == 0 and "nn_overflow=0" in out,
          "serving: no nn slot dropped")
    check(len(trace["traceEvents"]) > 0 and cell["profile"]["sampled"] > 0,
          "serving: trace events and sampled dispatches")
    print(f"  serving: calibration cell sweeps={cell['sweeps']} "
          f"blocks={cell['sweep_blocks']} meta={doc['meta']}; trace "
          f"{len(trace['traceEvents'])} events")

    for mesh, backend in (("1,1", "nccl"), ("1,2", "gloo")):
        out = run_script([ex / "torch_distributed_bfs.py", "--scale",
                          EXAMPLE_SCALE, "--mesh", mesh, "--backend", backend,
                          "--device", DEVICE], tmp,
                         f"torch_distributed_bfs.py --mesh {mesh} "
                         f"--backend {backend}")
        lines = match_lines(out, 3, f"distributed {mesh} {backend}")
        check(all("overflow=0" in ln for ln in lines),
              f"distributed {mesh}: no overflow")

    sweep = ROOT / "scripts" / "torch_profile_sweep.py"
    run_script([sweep, "--scale", EXAMPLE_SCALE, *SWEEP_ARGS, "--device",
                DEVICE, "--out", tmp / "CALIB_sweep.json"], tmp,
               "torch_profile_sweep.py (2 x 1 x 2)")
    card = load_bench(str(tmp / "CALIB_sweep.json"))
    check(card["meta"]["backend"] == "cuda", "sweep: taken on the card")
    cells = card["benchmarks"]["device_calibration"]["cells"]
    # the same matrix in this process on the CPU: the exact counters equal
    import importlib.util

    spec = importlib.util.spec_from_file_location("torch_profile_sweep", sweep)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    t0 = time.perf_counter()
    cpu = mod.run_matrix(scale=EXAMPLE_SCALE, delegates=("auto", "ring"),
                         nn_formats=("dense",), sweep_blocks=(4, 8),
                         device="cpu")
    cpu_s = time.perf_counter() - t0
    check(sorted(cells) == sorted(cpu["cells"]) and len(cells) == 4,
          "sweep: the 2 x 1 x 2 cells")
    for key, c in cells.items():
        for k in SWEEP_EXACT:
            check(c[k] == cpu["cells"][key][k],
                  f"sweep {key}: {k} on the card {c[k]} equals the CPU's "
                  f"{cpu['cells'][key][k]}")
        lat = c["profile"]["dispatch_latency_s"].get("block", {})
        print(f"  sweep {key}: sweeps={c['sweeps']} blocks="
              f"{c['sweep_blocks']} wire_delegate={c['wire_delegate_bytes']} "
              f"wire_nn={c['wire_nn_bytes']} qps={c['qps']:.1f} block "
              f"dispatch p50={lat.get('p50', 0) * 1e3:.3f} ms p99="
              f"{lat.get('p99', 0) * 1e3:.3f} ms")
    print(f"examples: the exact counters of the 4 cells equal the same matrix "
          f"on the CPU ({cpu_s:.1f} s); phase {time.perf_counter() - t_start:.1f}"
          " s")


def cin_bwd_inputs(b: int, fk: int, seed: int) -> tuple:
    """FULL-width CIN layer inputs on the card: x0, xk ~ N(0, 1) (xk is x0
    where Fk = F0, the first layer), W ~ N(0, 1) / sqrt(H) (the scaled
    init), dOut ~ N(0, 1)."""
    import torch
    from repro_torch.configs.xdeepfm import FULL

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    f0, d, h = FULL.n_sparse, FULL.embed_dim, FULL.cin_layers[0]
    x0 = torch.randn(b, f0, d, device=DEVICE, generator=gen)
    xk = x0 if fk == f0 else torch.randn(b, fk, d, device=DEVICE,
                                         generator=gen)
    w = torch.randn(h, f0 * fk, device=DEVICE, generator=gen) / h ** 0.5
    g = torch.randn(b, h, d, device=DEVICE, generator=gen)
    return x0, xk, w, g


def cin_bwd_close(got, want, what: str) -> float:
    """Hold a backward kernel's output against its plain version; returns
    the max |diff|."""
    import torch

    top = float(want.abs().max())
    diff = (got - want).abs()
    check(bool(torch.isfinite(got).all()) and bool(
        (diff <= CIN_BWD_ATOL * top + CIN_BWD_RTOL * want.abs()).all()),
          f"{what}: kernel within {CIN_BWD_ATOL} max|plain| + "
          f"{CIN_BWD_RTOL} |plain| of the plain version (max |diff| "
          f"{float(diff.max()):.3e}, max|plain| {top:.3e})")
    return float(diff.max())


def kernel_phase_cin_bwd() -> dict:
    """Phase 17: both backward kernels against the plain backward at FULL
    widths (layer 0, Fk = 39, and layer 1, Fk = 200) for B = 512 and
    1,000; then, at the train_batch shape, each of a step's three layers
    timed flushed and back to back beside the plain version, the bound
    (dW: 3xTF32 on the tensor cores; dx: float32 on the CUDA cores, with
    the 3xTF32 yardstick printed) and, for dW, cuBLAS ``dOut_flat @ Z`` on
    Z materialised beforehand (not timed)."""
    import torch
    from repro_torch.configs.xdeepfm import FULL
    from repro_torch.kernels import cin_fused as K

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"cin_bwd phase ({card_line()}): build log")
    for src in ("cin_fused_bwd_w", "cin_fused_bwd_x"):
        for ln in _build_log(src):
            print(f"  ptxas {src}: {ln}")
    err = {"w": 0.0, "x": 0.0}
    for b in CIN_BWD_CHECK_BATCHES:
        for layer, fk in ((0, FULL.n_sparse), (1, FULL.cin_layers[0])):
            x0, xk, w, g = cin_bwd_inputs(b, fk, seed=b + fk)
            dx0p, dxkp, dwp = K.cin_fused_bwd_plain(x0, xk, w, g)
            dw = K.cin_fused_bwd_w_cuda(x0, xk, g)
            dx0, dxk = K.cin_fused_bwd_x_cuda(x0, xk, w, g)
            torch.cuda.synchronize()
            what = f"cin_bwd B={b} layer {layer} (Fk={fk})"
            e_w = cin_bwd_close(dw, dwp, f"{what} dW")
            e_x = max(cin_bwd_close(dx0, dx0p, f"{what} dx0"),
                      cin_bwd_close(dxk, dxkp, f"{what} dxk"))
            check(torch.equal(dw, K.cin_fused_bwd_w_cuda(x0, xk, g))
                  and all(torch.equal(a, c) for a, c in zip(
                      (dx0, dxk), K.cin_fused_bwd_x_cuda(x0, xk, w, g))),
                  f"{what}: two launches give bit-equal outputs")
            err["w"], err["x"] = max(err["w"], e_w), max(err["x"], e_x)
            print(f"kernel cin_bwd [{what}]: dW max |diff| {e_w:.3e} (max "
                  f"|plain| {float(dwp.abs().max()):.3e}); dx0/dxk max |diff| "
                  f"{e_x:.3e} (max |plain| {float(dx0p.abs().max()):.3e} / "
                  f"{float(dxkp.abs().max()):.3e}); deterministic")
            del x0, xk, w, g, dx0p, dxkp, dwp, dw, dx0, dxk
    torch.cuda.empty_cache()
    tot = {k: dict(ms=0.0, flushed_ms=0.0, plain_ms=0.0, bound_ms=0.0)
           for k in ("w", "x")}
    lib_ms = 0.0
    widths = (FULL.n_sparse,) + tuple(FULL.cin_layers[:-1])
    for layer, fk in enumerate(widths):
        x0, xk, w, g = cin_bwd_inputs(TRAIN_BATCH, fk, seed=7 + layer)
        b, f0, d = x0.shape
        h = w.shape[0]
        flops = 2 * h * f0 * fk * b * d
        n_in = x0.numel() + (0 if xk is x0 else xk.numel()) + g.numel()
        # (kernel, plain, bytes, float32 operations, TF32 products per
        # float32 one, the rate they run at)
        cases = {
            "w": (lambda: K.cin_fused_bwd_w_cuda(x0, xk, g),
                  lambda: K.cin_fused_bwd_w_plain(x0, xk, g),
                  4 * (n_in + w.numel()), flops, 3, TF32_OPS_PER_S),
            "x": (lambda: K.cin_fused_bwd_x_cuda(x0, xk, w, g),
                  lambda: K.cin_fused_bwd_x_plain(x0, xk, w, g),
                  4 * (n_in + w.numel() + x0.numel() + xk.numel()),
                  flops + 4 * f0 * fk * b * d, 1, SCALAR_OPS_PER_S)}
        for k, (kern, plain, nbytes, nops, per, rate) in cases.items():
            t_fl = flushed_ms(kern, reps=CIN_BWD_TIME_REPS)
            t_b2b = time_ms(kern, reps=CIN_BWD_TIME_REPS, rounds=1)
            t_plain = time_ms(plain, reps=1, rounds=1)
            b_ms, b_by = bound(nbytes, per * nops, rate)
            check(b_by == "operations", f"cin_bwd_{k}: bound by operations")
            arith = ("3xTF32" if per == 3 else "float32") + \
                f" at {rate / 1e12:.0f} TFLOP/s"
            tf32_ms = bound(nbytes, 3 * nops, TF32_OPS_PER_S)[0]
            print(f"kernel cin_fused_bwd_{k} [layer {layer}, B={b} F0={f0} "
                  f"Fk={fk} H={h} D={d}]: flushed {t_fl:.3f} ms, back to back "
                  f"{t_b2b:.3f} ms, plain {t_plain:.3f} ms, bound_ms({arith})"
                  f"={b_ms:.3f} ({100 * b_ms / t_fl:.1f}% of bound; 3xTF32 "
                  f"yardstick {tf32_ms:.3f} ms, {100 * tf32_ms / t_fl:.1f}%), "
                  f"achieved {nops / t_fl / 1e9:.2f} TFLOP/s")
            for key, v in (("ms", t_b2b), ("flushed_ms", t_fl),
                           ("plain_ms", t_plain), ("bound_ms", b_ms)):
                tot[k][key] += v
            torch.cuda.empty_cache()
        # library: cuBLAS dW = dOut_flat [H, B*D] @ Z [B*D, K] in float32,
        # Z materialised beforehand and not timed
        z = torch.einsum("bid,bjd->bdij", x0, xk).reshape(b * d, f0 * fk)
        gf = g.permute(1, 0, 2).reshape(h, b * d)
        lib = gf @ z
        torch.cuda.synchronize()
        cin_bwd_close(lib, K.cin_fused_bwd_w_cuda(x0, xk, g),
                      f"cin_bwd layer {layer}: cuBLAS dW")
        t_lib = time_ms(lambda: gf @ z, reps=CIN_BWD_TIME_REPS, rounds=1)
        lib_ms += t_lib
        print(f"kernel cin_fused_bwd_w [layer {layer}]: library_ms(cuBLAS "
              f"dOut_flat @ Z, float32, Z not timed)={t_lib:.3f}")
        del x0, xk, w, g, z, gf, lib
        torch.cuda.empty_cache()
    for k in ("w", "x"):
        t = tot[k]
        print(f"kernel cin_fused_bwd_{k} [one train step, 3 layers, "
              f"B={TRAIN_BATCH}]: ms={t['ms']:.3f} flushed={t['flushed_ms']:.3f}"
              f" plain_ms={t['plain_ms']:.3f} bound_ms={t['bound_ms']:.3f}"
              + (f" library_ms={lib_ms:.3f}" if k == "w" else ""))
    return {"w": dict(max_abs_err=err["w"], ms=tot["w"]["ms"],
                      plain_ms=tot["w"]["plain_ms"],
                      bound_ms=tot["w"]["bound_ms"], bound_by="operations",
                      library_ms=lib_ms),
            "x": dict(max_abs_err=err["x"], ms=tot["x"]["ms"],
                      plain_ms=tot["x"]["plain_ms"],
                      bound_ms=tot["x"]["bound_ms"], bound_by="operations",
                      library_ms=None)}


def _build_log(src: str) -> list:
    from repro_torch.kernels import _build

    lines = [ln.strip() for ln in _build.BUILD_LOG.get(src, "").splitlines()
             if "registers" in ln or "spill" in ln]
    return lines or ["no ptxas report (library built by another process)"]


def cin_bwd_rows(cin_bwd: dict, train: dict) -> list:
    """The kernels line's rows of the two backward kernels."""
    return [{"name": f"cin_fused_bwd_{k}", "route": "cuda",
             "source": f"src/repro_torch/kernels/csrc/cin_fused_bwd_{k}.cu",
             "replaces": "src/repro/kernels/cin_fused.py:57",
             "launches": train["launches"][f"cin_fused_bwd_{k}"],
             **cin_bwd[k]} for k in ("w", "x")]


def recsys_train_path(cs=None) -> dict:
    """Phase 18: xDeepFM FULL training at the train_batch shape (B =
    65,536), AdamW, TF32 off. (1) One step's gradients at B = 4,096 through
    the kernels against the same step through ``cin_fused_plain`` under
    autograd: every leaf the loss reaches within 1e-3 x its largest
    |gradient| (non-zero); the retrieval tower's leaves, which it does not
    reach, zero in both. (2) TRAIN_WARMUP + TRAIN_TIMED steps on one
    ClickStream batch: ms a step (median of the timed steps' CUDA events),
    peak memory, the loss finite and lower after them than at step 0,
    ``cin_fused`` and both backward kernels launched 3 times a step and
    nothing else of the port. (3) Two steps under ``torch.profiler``."""
    import math

    import numpy as np
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.configs.xdeepfm import FULL
    from repro_torch.data.recsys_data import ClickStream
    from repro_torch.kernels import ops
    from repro_torch.kernels.cin_fused import cin_fused_plain
    from repro_torch.models.recsys import init_params, xdeepfm_loss
    from repro_torch.train import recsys as RT
    from repro_torch.train.optim import get_optimizer
    from repro_torch.train.trainer import value_and_grad

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = get_arch("xdeepfm")
    check(spec.shapes["train_batch"]["batch"] == TRAIN_BATCH,
          "the train_batch shape is B = 65,536")
    if cs is None:
        cs = ClickStream(n_fields=FULL.n_sparse, total_vocab=FULL.n_cold,
                         hot_fraction=HOT_FRACTION, seed=0)
    params = init_params(FULL, seed=0, device=DEVICE)
    n_params = sum(p.numel() for p in params.values())
    print(f"recsys_train ({card_line()}): {FULL}; {n_params:,} parameters; "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    # (1) gradients through the kernels against the plain CIN
    check_batch = RT.batch_to(cs.batch(1, TRAIN_CHECK_BATCH), DEVICE)
    ops.reset_launches()
    loss_k, g_k = value_and_grad(
        lambda p: xdeepfm_loss(FULL, p, check_batch), params)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    n_layers = len(FULL.cin_layers)
    check(launches["cin_fused"] == launches["cin_fused_bwd_w"]
          == launches["cin_fused_bwd_x"] == n_layers,
          f"recsys_train: one forward and one of each backward launch a CIN "
          f"layer ({launches})")
    loss_p, g_p = value_and_grad(
        lambda p: xdeepfm_loss(FULL, p, check_batch, cin_fused_plain), params)
    worst = 0.0
    for k in sorted(g_p):
        top = float(g_p[k].abs().max())
        diff = float((g_k[k] - g_p[k]).abs().max())
        if k.startswith("q_"):
            check(top == 0 and diff == 0, f"recsys_train: {k} is not reached")
            continue
        check(math.isfinite(top) and top > 0,
              f"recsys_train: {k} has a non-zero gradient ({top})")
        check(diff <= 1e-3 * top, f"recsys_train: {k} gradient through the "
              f"kernels within 1e-3 x {top:.3e} (max |diff| {diff:.3e})")
        worst = max(worst, diff / top)
    print(f"recsys_train: B={TRAIN_CHECK_BATCH} loss kernels {float(loss_k):.6f}"
          f" plain {float(loss_p):.6f}; every reached leaf's gradient within "
          f"{worst:.3e} x its max |plain gradient| (bound 1e-3)")
    del g_k, g_p, check_batch
    torch.cuda.empty_cache()
    # (2) the train step at B = 65,536
    t0 = time.perf_counter()
    batch = RT.batch_to(cs.batch(2, TRAIN_BATCH), DEVICE)
    data_s = time.perf_counter() - t0
    opt = get_optimizer(spec.optimizer, lr=TRAIN_LR)
    step = RT.make_recsys_train_step(FULL, opt)
    state = opt.init(params)
    losses, ms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_WARMUP + TRAIN_TIMED):
        if i == TRAIN_WARMUP:
            ops.reset_launches()
        (params, state, metrics), t = events_ms(
            lambda: step(params, state, batch))
        losses.append(float(metrics["loss"]))
        ms.append(t)
    peak = torch.cuda.max_memory_allocated()
    launches = dict(ops.LAUNCHES)
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"recsys_train: finite losses that fall ({losses})")
    want = {k: (n_layers * TRAIN_TIMED if k.startswith("cin_fused") else 0)
            for k in launches}
    check(launches == want, f"recsys_train: {n_layers} launches of cin_fused "
          f"and of each backward kernel a step, nothing else ({launches})")
    med = float(np.median(ms[TRAIN_WARMUP:]))
    print(f"recsys_train: B={TRAIN_BATCH} AdamW(lr={TRAIN_LR}) on one "
          f"ClickStream batch ({data_s:.1f} s to make); ms per step "
          f"{[round(x, 2) for x in ms]} (CUDA events; the first "
          f"{TRAIN_WARMUP} warm-up), median {med:.2f} ms = "
          f"{TRAIN_BATCH / med * 1e3:.0f} samples/s; peak {gib(peak)}; "
          f"losses {[round(x, 5) for x in losses]}; launches over the "
          f"{TRAIN_TIMED} timed steps {launches}")
    # (3) two steps profiled: the first kernels of a session can lose
    # their device records (section 7 of PERF.md; the forward's did once all
    # phases ran before, on an H100), so only the backward kernels, which
    # every step launches after it, are required (the top kernels printed
    # show the rest)
    prof = {}

    def two_steps():
        out = step(params, state, batch)
        return step(out[0], out[1], batch)

    per_launch = profile_run(
        two_steps, lambda out: f"recsys train, 2 steps, B={TRAIN_BATCH}",
        ("cin_bwd_w_kernel", "cin_bwd_x_kernel"), into=prof)
    print(f"recsys_train (2 profiled steps): device busy share "
          f"{prof['busy_ms'] / prof['wall_ms']:.3f}; us per launch "
          f"{ {k: round(v, 1) for k, v in per_launch.items()} }; phase "
          f"{time.perf_counter() - t_start:.1f} s")
    del params, state, batch
    torch.cuda.empty_cache()
    return {"launches": launches, "ms": med, "peak": peak}


def run() -> None:
    import numpy as np
    import torch
    from repro_torch.core import oracle as O
    from repro_torch.core.types import INF_LEVEL
    from repro_torch.graphs.rmat import rmat_graph
    from repro_torch.kernels import _build, ops
    from repro_torch.serve import BFSServeEngine, QueryKind as K

    start = time.perf_counter()
    stamp = lambda what: print(f"elapsed {time.perf_counter() - start:.1f} s:"
                               f" {what}")
    print(card_line())
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")

    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s (built {built})")
    for src, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {src}: {line.strip()}")

    t0 = time.perf_counter()
    g = rmat_graph(SCALE, seed=0)
    t_gen = time.perf_counter() - t0
    eng = BFSServeEngine(g, th=TH, p_rank=P_RANK, p_gpu=P_GPU, device=DEVICE)
    pg = eng.pg
    print(f"setup: rmat_graph({SCALE}) {t_gen:.1f} s, partition+plan+upload "
          f"{time.perf_counter() - t0 - t_gen:.1f} s; n={pg.n} m={g.m} "
          f"p={pg.p} d={pg.d} n_local={pg.n_local} "
          f"E_max nn/nd/dn/dd={pg.nn.e_max}/{pg.nd.e_max}/{pg.dn.e_max}/"
          f"{pg.dd.e_max} cap_total={eng.plan.cap_total} "
          f"cap_peer={eng.plan.cap_peer}")

    stamp("set-up done")
    # ---- launch cost in a fresh process, before any profiler session ------
    pull_cases = pull_launch_cases(eng)
    launch_cost_phase({**fold_cases(pg.p, pg.d, eng.cfg.n_queries),
                       **pull_cases},
                      "fresh process")
    LAUNCH_CASES.update(pull_cases)

    stamp("launch cost done")
    # ---- kernel phases at the main path's shapes ---------------------------
    st, masks = mid_bfs_inputs(eng, g)
    print(f"mid-BFS state: it={int(st.it[0])} frontier_n="
          f"{int(masks['frontier_n'].sum())} frontier_d="
          f"{int(masks['frontier_d'].sum())} (vertex-lane pairs)")
    pull = kernel_phase_pull(eng, masks)
    fold = kernel_phase_fold(eng, st, masks)
    ell_contract_check(eng.device)
    print("library_ms: no single PyTorch call computes either function "
          "(no OR reduction, no early-exit pull), so both are null")

    stamp("kernel phases done")
    # ---- main path ---------------------------------------------------------
    eng.warmup(reachability=True, targets=True)
    queries = mixed_queries(g, pg)
    sweeps0 = eng.traversal_sweeps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    answers = eng.submit_many(queries)
    dt = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    sweeps = eng.traversal_sweeps - sweeps0
    s = eng.stats
    print(f"serve: {len(queries)} queries in {dt:.3f} s = "
          f"{len(queries) / dt:.1f} queries/s; batches={s.batches} "
          f"sweeps={sweeps} cache_hits={s.cache_hits} "
          f"component_hits={s.component_hits} early_stops={s.early_stops} "
          f"reach_fast_batches={s.reach_fast_batches}")
    print(f"serve: wire_delegate_bytes={s.wire_delegate_bytes} "
          f"wire_nn_bytes={s.wire_nn_bytes} nn_overflow={s.nn_overflow} "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()} B")
    print(f"launches: {launches} (1 pull launch + 1 fold per sweep)")
    check(s.batches >= 2, "at least two lane batches")
    check(s.nn_overflow == 0, "no nn slot dropped")
    check(launches["ell_pull_multi"] > 0 and launches["mask_reduce"] > 0,
          "both kernels launched")
    check(launches["ell_pull"] == 0 and launches["payload_min_fold"] == 0,
          "no single-source kernel on the serving path")
    check(launches["ell_pull_multi"] == sweeps
          and launches["mask_reduce"] == sweeps, "launches per sweep")
    main_stats = s.as_dict()

    csr = O.csr_from_coo(g)
    checked = {}
    for q, a in zip(queries, answers):
        if checked.get(q.kind, 0) >= 2:
            continue
        if q.kind is K.LEVELS:
            ok = np.array_equal(a, O.bfs_levels(g, q.source, csr))
        elif q.kind is K.REACHABILITY:
            ok = np.array_equal(a, O.reachable_mask(g, q.source, csr))
        elif q.kind is K.DISTANCE_LIMITED:
            ok = np.array_equal(a, O.bfs_levels_limited(g, q.source,
                                                        q.max_depth, csr))
        else:
            ok = a == O.target_depths(g, q.source, q.targets, csr)
        check(ok, f"oracle: {q}")
        checked[q.kind] = checked.get(q.kind, 0) + 1
    check(all(checked.get(k, 0) >= 2 for k in (K.LEVELS, K.REACHABILITY,
                                               K.DISTANCE_LIMITED,
                                               K.MULTI_TARGET)),
          "two oracle checks per kind")
    reached = sum(int((a != INF_LEVEL).sum()) for q, a in zip(queries, answers)
                  if q.kind is K.LEVELS)
    print(f"oracle: {dict((k.value, v) for k, v in checked.items())} answers "
          f"exact; LEVELS answers reach {reached} vertex-query pairs")

    for _ in range(3):
        batch_phases(eng, queries)
    profile_batch(eng, queries)
    stamp("serving, batch phases and profiled batch done")
    # ---- single-source path: kernel phases, then Graph500 search keys ----
    chunk = bfs_configs()["FULL"].pull_chunk
    ss_src, ss_st, ss_masks = ss_mid_bfs(eng, g, bfs_configs()["FULL"])
    print(f"single-source mid-BFS state: source={ss_src} "
          f"it={int(ss_st.it[0])} frontier_n="
          f"{int(ss_masks['frontier_n'].sum())} frontier_d="
          f"{int(ss_masks['frontier_d'].sum())} unvisited_n="
          f"{int(ss_masks['unvis_n'].sum())} unvisited_d="
          f"{int(ss_masks['unvis_d'][0].sum())}")
    bit_pull = kernel_phase_bit_pull(eng, ss_masks, chunk)
    min_fold = kernel_phase_min_fold(eng, ss_st, ss_masks)
    ell_pull_contract_check(eng.device)
    prof_src, ss_launches, full = single_source_path(eng, g, csr)
    profile_bfs(eng, prof_src)

    stamp("single-source path done")
    # ---- comm strategies (emulated, full width), then the sharded
    # drivers: world 1 under NCCL here, world 2 under gloo on this card --
    from repro_torch.core import engine as TE

    t0 = time.perf_counter()
    hplan = TE.build_exchange_plan(pg)
    print(f"host exchange plan for the strategy phases: "
          f"{time.perf_counter() - t0:.1f} s")
    strategy_serving(eng, hplan, queries, answers)
    strategy_bfs(eng, hplan, g, csr, full)
    stamp("strategy phases done")
    # ---- the observability plane: the serving run three ways (the plane
    # goes on to the refill path's overlap run) ----------------------------
    from repro_torch.obs import Observability

    torch.cuda.empty_cache()
    obs = Observability()
    obs_serving(eng, g, hplan, queries, answers, main_stats, obs)
    stamp("obs serving phase done")
    torch.cuda.empty_cache()
    sharded_nccl_phase()
    stamp("sharded world-1 NCCL phase done")
    sharded_gloo_phase(eng, hplan, queries, answers, main_stats, full)
    del hplan
    torch.cuda.empty_cache()
    stamp("sharded world-2 phase done")
    # ---- recsys path: xDeepFM scoring and retrieval, then B5 / B6 ----------
    recsys = recsys_path(g, csr)
    launch_cost_phase(LAUNCH_CASES, "after the paths")
    stamp("recsys path and launch cost done")

    # ---- payload path: the three payload kinds at full width --------------
    torch.cuda.empty_cache()
    payload = payload_path(g, pg, csr)
    stamp("payload path done")

    # ---- memory and telemetry modes: edge_chunk, telemetry, the
    # compressed nn format and partition ----------------------------------
    torch.cuda.empty_cache()
    memory_path(eng, g, csr, queries, answers)
    stamp("memory path done")

    # ---- the multi-tenant frontend over two scale-20 graphs -----------------
    torch.cuda.empty_cache()
    frontend_path(g, pg, csr)
    stamp("frontend path done")

    # ---- distributed GNN training (phase 15; before the refill path, whose
    # long profiled runs stay last) -----------------------------------------
    torch.cuda.empty_cache()
    gnn_path(g, pg, eng.pgv, eng.plan)
    stamp("gnn path done")

    # ---- the entry points, the CIN backward and recsys training (phases
    # 16-18; before the refill path, as phase 15) ---------------------------
    torch.cuda.empty_cache()
    examples_path()
    stamp("examples done")
    cin_bwd = kernel_phase_cin_bwd()
    stamp("cin_bwd done")
    train = recsys_train_path(recsys.pop("cs"))
    stamp("recsys_train done")

    # ---- refill path last: after its long profiled runs, the short
    # profiler sessions of the phases above lost their device records -------
    torch.cuda.empty_cache()
    refill_path(g, obs)
    stamp("refill path done")

    or_apply = fold["apply"]["levels + targets"]
    print(f"single-source payload_min_fold_apply (n = d): ms="
          f"{min_fold['apply']['ms']:.4f} bound_ms="
          f"{min_fold['apply']['bound_ms']:.6f} launches over the 4 "
          f"allgather keys {ss_launches['allgather']['payload_min_fold']}")
    pparts = payload["parts"]
    kernels = [
        {"name": "ell_pull_multi", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ell_pull_multi.cu",
         "replaces": "src/repro/kernels/ell_pull_multi.py:60",
         "launches": launches["ell_pull_multi"],
         "max_abs_err": float(pull["err"]), "ms": pull["ms"],
         "plain_ms": pull["plain_ms"], "bound_ms": pull["bound_ms"],
         "bound_by": "bytes", "library_ms": None},
        {"name": "mask_reduce", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/mask_reduce.cu",
         "replaces": "src/repro/kernels/mask_reduce.py:92",
         "launches": launches["mask_reduce"],
         "max_abs_err": float(or_apply["err"]), "ms": or_apply["ms"],
         "plain_ms": or_apply["plain_ms"], "bound_ms": or_apply["bound_ms"],
         "bound_by": or_apply["bound_by"], "library_ms": None},
        {"name": "ell_pull", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ell_pull.cu",
         "replaces": "src/repro/kernels/ell_pull.py:54",
         "launches": ss_launches["FULL"]["ell_pull"],
         "max_abs_err": float(bit_pull["err"]), "ms": bit_pull["ms"],
         "plain_ms": bit_pull["plain_ms"], "bound_ms": bit_pull["bound_ms"],
         "bound_by": "bytes", "library_ms": None},
        {"name": "payload_min_fold", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/mask_reduce.cu",
         "replaces": "src/repro/kernels/mask_reduce.py:145",
         "launches": payload["allgather"]["launches"]["payload_min_fold"],
         "max_abs_err": float(pparts["b4_err"]), "ms": pparts["b4_ms"],
         "plain_ms": pparts["b4_plain_ms"], "bound_ms": pparts["b4_bound_ms"],
         "bound_by": pparts["b4_bound_by"], "library_ms": None},
        {"name": "cin_fused", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/cin_fused.cu",
         "replaces": "src/repro/kernels/cin_fused.py:57",
         **recsys["cin_fused"]},
        {"name": "segment_bag", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/segment_bag.cu",
         "replaces": "src/repro/kernels/segment_bag.py:55",
         **recsys["segment_bag"]},
        {"name": "ell_pull_payload", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ell_pull_payload.cu",
         "replaces": "src/repro/kernels/ell_pull_payload.py:64",
         **recsys["ell_pull_payload"]},
        *cin_bwd_rows(cin_bwd, train),
    ]
    print("ell_pull_multi / ell_pull ms: one launch of a sweep's three "
          "pulls; plain_ms, bound_ms: sum of the three; mask_reduce / "
          "payload_min_fold: the fused delegate update of the path "
          "(mask_reduce_apply on int32 levels with targets; "
          "payload_min_fold_apply on the payload plane, n = d * W, on a "
          "mid-run SSSP batch; library_ms null: no single PyTorch call "
          "folds and applies; the standalone folds and torch.amin are "
          "printed above). Launches: ell_pull_multi and "
          "mask_reduce over the 64-query serving run, ell_pull over the 16 "
          "FULL search keys, payload_min_fold over the payload path's "
          "allgather SSSP batch. "
          "cin_fused (path: recsys serving): ms, plain_ms, bound_ms, "
          "library_ms summed over the 3 CIN layers of one serve_p99 forward "
          "(bound_ms: 3xTF32, three TF32 tensor-core products per float32 "
          "product at 495 TFLOP/s; library: cuBLAS w @ Z in float32 on Z "
          "materialised beforehand, not timed); "
          "launches over the 20 serve_p99 and 3 serve_bulk batches. "
          "segment_bag and ell_pull_payload (path: none in the reference): "
          "ms and library_ms flushed (L2 written over before each call) at "
          "the bulk emb_hot float32 shape and the scale-20 ELL with 70% of "
          "lanes active, launches over their parity phases. "
          "cin_fused_bwd_w / cin_fused_bwd_x (path: recsys training): "
          "ms (back to back), plain_ms, bound_ms summed over the 3 CIN "
          "layers of one train step at B = 65,536 (bound: dW 3xTF32 at 495 "
          "TFLOP/s, dx float32 at 67 TFLOP/s, SIMT; library for dW: cuBLAS "
          "dOut_flat @ Z on Z materialised beforehand, not timed), "
          "max_abs_err over the B = 512 and 1,000 parity checks, launches "
          "over the timed train steps")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


def sharded_alone() -> None:
    """``--only sharded``: the strategy and sharded phases on the scale-20
    graph, after the default serving run and the first FULL search keys
    they are held against (as ``run`` makes them; nothing else)."""
    import torch
    from repro_torch.core import engine as TE, oracle as O
    from repro_torch.graphs.rmat import pick_sources, rmat_graph
    from repro_torch.kernels import ops
    from repro_torch.serve import BFSServeEngine

    g = rmat_graph(SCALE, seed=0)
    eng = BFSServeEngine(g, th=TH, p_rank=P_RANK, p_gpu=P_GPU, device=DEVICE)
    eng.warmup(reachability=True, targets=True)
    queries = mixed_queries(g, eng.pg)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    answers = eng.submit_many(queries)
    torch.cuda.synchronize()
    print(f"serve: {len(queries)} queries in "
          f"{time.perf_counter() - t0:.3f} s, {eng.traversal_sweeps} sweeps")
    stats = eng.stats.as_dict()
    csr = O.csr_from_coo(g)
    keys = [int(s) for s in pick_sources(g, N_KEYS, seed=2)]
    full_cfg = bfs_configs()["FULL"]
    run_bfs_keys(eng, g, full_cfg, keys[:1], csr)               # warm-up
    full = run_bfs_keys(eng, g, full_cfg, keys[:N_VARIANT_KEYS], csr)
    hplan = TE.build_exchange_plan(eng.pg)
    strategy_serving(eng, hplan, queries, answers)
    strategy_bfs(eng, hplan, g, csr, full)
    torch.cuda.empty_cache()
    sharded_nccl_phase()
    sharded_gloo_phase(eng, hplan, queries, answers, stats, full)


def run_alone(names) -> None:
    """``--only``: the named phases (``segment_bag``, ``ell_pull_payload``,
    ``sharded``, ``payload``, ``memory``) on their inputs (the recsys
    model and ClickStream batches, the scale-20 graph, made as ``run``
    makes them; ``memory`` first serves the 64 queries it holds the
    compressed run against), nothing else (``payload`` adds the sharded
    world-1 NCCL phase, which holds its (e)); then the device line."""
    import torch
    from repro_torch.core import oracle as O
    from repro_torch.core.partition import partition_graph
    from repro_torch.graphs.rmat import rmat_graph
    from repro_torch.kernels import _build

    print(card_line())
    print(f"build: built {_build.build()}")
    if "segment_bag" in names:
        model, cs = recsys_setup()
        kernel_phase_segment_bag(
            model, [cs.batch(0, P99_BATCH), cs.batch(2, P99_BATCH)],
            cs.batch(1000, BULK_BATCH))
        del model
        torch.cuda.empty_cache()
    if "ell_pull_payload" in names:
        g = rmat_graph(SCALE, seed=0)
        kernel_phase_payload(g, O.csr_from_coo(g))
    if "sharded" in names:
        sharded_alone()
    if "payload" in names:
        g = rmat_graph(SCALE, seed=0)
        pg = partition_graph(g, th=TH, p_rank=P_RANK, p_gpu=P_GPU)
        payload_path(g, pg, O.csr_from_coo(g))
        if "sharded" not in names:
            torch.cuda.empty_cache()
            sharded_nccl_phase()
    if "memory" in names:
        from repro_torch.serve import BFSServeEngine

        torch.cuda.empty_cache()
        g = rmat_graph(SCALE, seed=0)
        eng = BFSServeEngine(g, th=TH, p_rank=P_RANK, p_gpu=P_GPU,
                             device=DEVICE)
        queries = mixed_queries(g, eng.pg)
        memory_path(eng, g, O.csr_from_coo(g), queries,
                    eng.submit_many(queries))
    if "obs" in names or "frontend" in names:
        obs_frontend_alone(names)
    if "gnn" in names:
        from repro_torch.core import bfs as TB, engine as TE

        torch.cuda.empty_cache()
        g = rmat_graph(SCALE, seed=0)
        pg = partition_graph(g, th=TH, p_rank=P_RANK, p_gpu=P_GPU)
        gnn_path(g, pg, TB.device_view(pg, DEVICE),
                 TE.device_plan(TE.build_exchange_plan(pg), DEVICE))
    if "examples" in names:
        torch.cuda.empty_cache()
        examples_path()
    cin_bwd = train = None
    if "cin_bwd" in names:
        torch.cuda.empty_cache()
        cin_bwd = kernel_phase_cin_bwd()
    if "recsys_train" in names:
        torch.cuda.empty_cache()
        train = recsys_train_path()
    if cin_bwd is not None and train is not None:
        print(json.dumps({"kernels": cin_bwd_rows(cin_bwd, train)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def obs_frontend_alone(names) -> None:
    """``--only obs`` / ``frontend``: the scale-20 graph and engine and the
    64-query serving run (as ``run`` makes them); ``obs`` then runs
    :func:`obs_serving` and, on the refill path's engine, its overlap run
    with the plane off and then on (:func:`refill_obs_run`); ``frontend``
    runs :func:`frontend_path`."""
    import torch
    from repro_torch.core import engine as TE, oracle as O
    from repro_torch.graphs.rmat import rmat_graph
    from repro_torch.obs import Observability
    from repro_torch.serve import BFSServeEngine

    torch.cuda.empty_cache()
    g = rmat_graph(SCALE, seed=0)
    eng = BFSServeEngine(g, th=TH, p_rank=P_RANK, p_gpu=P_GPU, device=DEVICE)
    csr = O.csr_from_coo(g)
    if "obs" in names:
        eng.warmup(reachability=True, targets=True)
        queries = mixed_queries(g, eng.pg)
        answers = eng.submit_many(queries)
        obs = Observability()
        obs_serving(eng, g, TE.build_exchange_plan(eng.pg), queries, answers,
                    eng.stats.as_dict(), obs)
        torch.cuda.empty_cache()
        _, tips, reng, rq = refill_engine(g)
        refill_obs_run(reng, rq, tips, drive(reng, "overlap", rq), obs)
        del reng
        torch.cuda.empty_cache()
    if "frontend" in names:
        frontend_path(g, eng.pg, csr)


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    phases = ("segment_bag", "ell_pull_payload", "sharded", "payload",
              "memory", "obs", "frontend", "gnn", "examples", "cin_bwd",
              "recsys_train")
    ap.add_argument("--only", default=None,
                    help="comma-separated phases to run alone: "
                         + ", ".join(phases))
    args = ap.parse_args()
    only = None if args.only is None else set(args.only.split(","))
    if only is not None and not only <= set(phases):
        ap.error(f"--only takes {', '.join(phases)}, not {only}")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found; run "
              "from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    if only is None:
        run()
    else:
        run_alone(only)
    return 0


if __name__ == "__main__":
    import os
    import traceback

    try:
        rc = main()
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else 1
    except Exception:                        # reported, exits non-zero
        traceback.print_exc()
        rc = 1
    # leave without the interpreter's teardown: a process group whose
    # collectives were captured can hang it (every child is joined)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
