"""The port's lane-refill, overlapped and streaming serving (and the lane
scheduler, ``reseed_lanes``, the fused block and ``with_tails`` beneath
them) against the reference package, in one process: the same inputs go
through both, on the fixtures of ``tests/test_serve_overlap.py``
(``rmat_graph(8, seed=11)`` with 2 tails of 24, W=4, ``p_rank=2``,
``p_gpu=2``, ``th=32``). Exact equality throughout: every compared
quantity is an integer or a bool."""
import jax.numpy as jnp
import numpy as np
import pytest
pytest.importorskip("torch")

from repro.core import msbfs as RM
from repro.core.partition import partition_graph
from repro.graphs.rmat import pick_sources, rmat_graph
from repro.graphs.synthetic import with_tails as ref_with_tails
from repro.serve import BFSServeEngine as RefEngine
from repro.serve import Query as RQ, QueryKind as RK
from repro.serve.batcher import (LaneScheduler as RefScheduler,
                                 QueryBatcher as RefBatcher,
                                 pack_sources as ref_pack_sources)
from repro_torch.core import convert, msbfs as TM
from repro_torch.core.oracle import bfs_levels, component_labels
from repro_torch.core.types import COOGraph
from repro_torch.graphs.synthetic import with_tails
from repro_torch.serve import (BFSServeEngine, LaneScheduler, Query,
                               QueryBatcher, QueryKind as K, pack_sources)

W = 4


@pytest.fixture(scope="module")
def tailed():
    core = rmat_graph(8, seed=11)
    g, tips = ref_with_tails(core, n_tails=2, length=24, seed=2)
    rpg = partition_graph(g, th=32, p_rank=2, p_gpu=2)
    pg = convert.partition_from_arrays(*convert.partition_to_arrays(rpg))
    return core, g, tips, rpg, pg


def engines(tailed, *, w=W, cache=0, max_iters=96, **kw):
    *_, rpg, pg = tailed
    ref = RefEngine(pg=rpg, cfg=RM.MSBFSConfig(n_queries=w, max_iters=max_iters),
                    cache_capacity=cache, refill=True, **kw)
    port = BFSServeEngine(pg=pg, cfg=TM.MSBFSConfig(n_queries=w,
                                                    max_iters=max_iters),
                          cache_capacity=cache, refill=True, device="cpu", **kw)
    return ref, port


def to_ref(q: Query) -> RQ:
    return RQ(q.source, RK(q.kind.value), max_depth=q.max_depth,
              targets=q.targets)


def mixed(srcs):
    tg = tuple(int(s) for s in srcs[:2])
    kinds = [lambda s: Query(s), lambda s: Query(s, K.REACHABILITY),
             lambda s: Query(s, K.DISTANCE_LIMITED, max_depth=2),
             lambda s: Query(s, K.MULTI_TARGET, targets=tg)]
    return [kinds[i % 4](int(s)) for i, s in enumerate(srcs)]


def skewed(core, tips, n_shallow=10):
    shallow = pick_sources(core, n_shallow, seed=3)
    return np.concatenate([[tips[0]], shallow[: n_shallow // 2], [tips[1]],
                           shallow[n_shallow // 2:]])


def assert_result_equal(a, b):
    if isinstance(b, dict):
        assert a == b
    else:
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def assert_results_equal(port: dict, ref: dict):
    """{Query: result} of the port against {RQ: result} of the reference,
    in the same order."""
    assert [to_ref(q) for q in port] == list(ref)
    for q, a in port.items():
        assert_result_equal(a, ref[to_ref(q)])


def assert_state_equal(rs, ts):
    leaves = convert.state_to_numpy(ts)
    for k in TM.STATE_LEAVES:
        want, got = np.asarray(getattr(rs, k)), leaves[k]
        if want.dtype == np.uint32:
            got = got.view(np.uint32)
        assert got.shape == want.shape and got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)


# ------------------------------------------------------------- with_tails
@pytest.mark.parametrize("seed", [2, 5])
def test_with_tails_equals_reference(seed):
    core = rmat_graph(8, seed=11)
    rg, rtips = ref_with_tails(core, n_tails=3, length=17, seed=seed)
    g, tips = with_tails(COOGraph(core.n, core.src, core.dst), n_tails=3,
                         length=17, seed=seed)
    assert g.n == rg.n == core.n + 3 * 17
    np.testing.assert_array_equal(g.src, rg.src)
    np.testing.assert_array_equal(g.dst, rg.dst)
    np.testing.assert_array_equal(tips, rtips)
    assert tips.dtype == rtips.dtype == np.int64


# ------------------------------------------------------------- scheduling
def test_pack_sources_and_query_batcher_match_reference():
    srcs = [5, 1, 9, 9, 2, 7, 3]
    for a, b in zip(pack_sources(srcs, 3), ref_pack_sources(srcs, 3)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        pack_sources([[1, 2]], 2)
    qb, rb = QueryBatcher(width=3), RefBatcher(width=3)
    assert [qb.submit(s) for s in srcs] == [rb.submit(s) for s in srcs]
    assert len(qb) == len(rb) and qb.pending == rb.pending
    for (ta, sa), (tb, sb) in zip(qb.drain(), rb.drain()):
        assert ta == tb
        np.testing.assert_array_equal(sa, sb)
    assert qb.pending == rb.pending == 0


def test_lane_scheduler_same_sequence_as_reference():
    """One operation sequence -- queue, fill, retire, front-of-queue stream
    submissions, refill -- gives the same lanes, generations, assignments
    and pending order."""
    items = [Query(s) for s in (3, 8, 1, 6, 4, 2, 9)]
    ours, ref = LaneScheduler(3, pending=items[:2]), RefScheduler(
        3, pending=[to_ref(q) for q in items[:2]])

    def same():
        assert [to_ref(x) for x in ours.pending] == list(ref.pending)
        np.testing.assert_array_equal(ours.busy, ref.busy)
        np.testing.assert_array_equal(ours.lane_generation,
                                      ref.lane_generation)
        np.testing.assert_array_equal(ours.lane_source, ref.lane_source)
        assert ours.n_busy == ref.n_busy and ours.n_pending == ref.n_pending
        assert {k: (to_ref(i), g) for k, (i, g) in ours.poll().items()} == \
            ref.poll()

    def fill():
        a, b = ours.fill_idle(), ref.fill_idle()
        assert [(x.lane, x.source, x.generation, to_ref(x.item)) for x in a] \
            == [(x.lane, x.source, x.generation, x.item) for x in b]

    fill()
    same()
    ours.submit(items[2])
    ref.submit(to_ref(items[2]))
    assert ours.submit_stream(items[3:5]) == ref.submit_stream(
        [to_ref(q) for q in items[3:5]])
    assert ours.submit_stream(items[5:], front=True) == ref.submit_stream(
        [to_ref(q) for q in items[5:]], front=True)
    same()
    fill()
    for lane in (0, 2):
        (a, ga), (b, gb) = ours.retire(lane), ref.retire(lane)
        assert (to_ref(a), ga) == (b, gb)
    same()
    fill()
    same()
    (a, ga), (b, gb) = ours.retire(1), ref.retire(1)
    assert (to_ref(a), ga) == (b, gb)
    same()
    for s in (ours, ref):
        with pytest.raises(ValueError):
            s.retire(1)                   # idle lane
    with pytest.raises(ValueError):
        LaneScheduler(0)


# ---------------------------------------------------------------- reseed
@pytest.mark.parametrize("track_levels", [True, False])
def test_reseed_lanes_every_leaf_equal(tailed, track_levels):
    """Reseed two lanes of a mid-traversal state -- a normal and a
    delegate source, with a depth cap and with normal and delegate
    targets -- through both packages: every leaf equal, and the untouched
    lanes bit-identical to the state before."""
    core, g, tips, rpg, pg = tailed
    enable_targets = track_levels
    rcfg = RM.MSBFSConfig(n_queries=W, max_iters=96, track_levels=track_levels,
                          enable_targets=enable_targets)
    tcfg = TM.MSBFSConfig(n_queries=W, max_iters=96, track_levels=track_levels,
                          enable_targets=enable_targets)
    srcs = [int(s) for s in pick_sources(core, 3, seed=4)] + [int(tips[0])]
    reng = RefEngine(pg=rpg, cfg=RM.MSBFSConfig(n_queries=W, max_iters=96))
    tv = BFSServeEngine(pg=pg, cfg=TM.MSBFSConfig(n_queries=W, max_iters=96),
                        device="cpu")
    rs = RM.init_multi_state(rpg, srcs, rcfg)
    ts = TM.init_multi_state(pg, srcs, tcfg, device="cpu")
    for _ in range(3):
        rs = RM.msbfs_step_emulated(reng.pgv, reng.plan, rs, rcfg)
        ts = TM.msbfs_step_emulated(tv.pgv, tv.plan, ts, tcfg)
    dv = [int(v) for v in np.asarray(rpg.delegate_vids)[:2]]
    targets = ([None, (srcs[0], dv[1], int(tips[1]))] if enable_targets
               else None)
    desc = TM.lane_descriptors(pg, W, [1, 2], [int(tips[1]), dv[0]],
                               depth_caps=[2, None], targets=targets,
                               n_targets=8)
    rout = RM.reseed_lanes(rs, *map(jnp.asarray, desc))
    tout = TM.reseed_lanes(ts, *desc)
    assert_state_equal(rout, tout)
    before, after = convert.state_to_numpy(ts), convert.state_to_numpy(tout)
    for k in ("level_n", "level_d", "base_it", "lane_active", "depth_cap"):
        np.testing.assert_array_equal(before[k][..., [0, 3]],
                                      after[k][..., [0, 3]], err_msg=k)
    # only the first six (no target arrays): plain full-levels semantics
    assert_state_equal(RM.reseed_lanes(rs, *map(jnp.asarray, desc[:6])),
                       TM.reseed_lanes(ts, *desc[:6]))
    # payload lanes are served now, on a cfg.payload state only (their
    # parity is in tests/test_torch_payload.py)
    pay = TM.payload_descriptors(W, [1, 2], ["sssp", "components"])
    with pytest.raises(ValueError, match="cfg.payload"):
        TM.reseed_lanes(ts, *desc, *pay, *TM.gid_planes(pg))


# ------------------------------------------------------------- the block
def test_block_stops_at_retirement_like_reference(tailed):
    """The fused block stops at the exact sweep a watched lane converges,
    with every leaf equal to the reference's block; a block chained
    behind it, watching the same lanes, runs zero sweeps."""
    core, g, tips, rpg, pg = tailed
    reng = RefEngine(pg=rpg, cfg=RM.MSBFSConfig(n_queries=W, max_iters=96))
    teng = BFSServeEngine(pg=pg, cfg=TM.MSBFSConfig(n_queries=W, max_iters=96),
                          device="cpu")
    rcfg = RM.MSBFSConfig(n_queries=W, max_iters=96, enable_targets=False)
    tcfg = TM.MSBFSConfig(n_queries=W, max_iters=96, enable_targets=False)
    srcs = [int(tips[0]), int(pick_sources(core, 1, seed=5)[0]), 3]
    watch = np.array([True, True, True, False])
    rout = RM.make_msbfs_block_emulated(rcfg, 64)(
        reng.pgv, reng.plan, RM.init_multi_state(rpg, srcs, rcfg), watch)
    block = TM.make_msbfs_block_emulated(tcfg, 64)
    run = block(teng.pgv, teng.plan,
                TM.init_multi_state(pg, srcs, tcfg, device="cpu"), watch)
    probe = run.wait()
    assert 0 < probe.it == int(np.asarray(rout.it)[0]) < 64
    assert probe.ran and not probe.active[watch].all() and probe.active[0]
    assert_state_equal(rout, run.out)
    nxt = block(teng.pgv, teng.plan, run, watch)
    assert nxt.wait().it == probe.it and nxt.out is run.out
    assert block.runner.gated == 0       # the host knew: nothing dispatched


def test_block_freezes_on_pre_retired_watch_like_reference(tailed):
    """A block dispatched with an already-converged watched lane leaves the
    state as it was, as the reference's does (one gated-off sweep)."""
    core, g, tips, rpg, pg = tailed
    reng = RefEngine(pg=rpg, cfg=RM.MSBFSConfig(n_queries=W, max_iters=96))
    teng = BFSServeEngine(pg=pg, cfg=TM.MSBFSConfig(n_queries=W, max_iters=96),
                          device="cpu")
    rcfg = RM.MSBFSConfig(n_queries=W, max_iters=96, enable_targets=False)
    tcfg = TM.MSBFSConfig(n_queries=W, max_iters=96, enable_targets=False)
    watch = np.ones(W, dtype=bool)        # lanes 1..3 were never seeded
    rout = RM.make_msbfs_block_emulated(rcfg, 8)(
        reng.pgv, reng.plan, RM.init_multi_state(rpg, [3], rcfg), watch)
    block = TM.make_msbfs_block_emulated(tcfg, 8)
    run = block(teng.pgv, teng.plan,
                TM.init_multi_state(pg, [3], tcfg, device="cpu"), watch)
    probe = run.wait()
    assert probe.it == 0 and not probe.ran and block.runner.gated == 1
    assert_state_equal(rout, run.out)
    with pytest.raises(ValueError):
        TM.make_msbfs_block_emulated(tcfg, 0)


# ----------------------------------------------------- refill drain parity
@pytest.mark.parametrize("kw", [dict(), dict(overlap=True, sweep_block=1),
                                dict(overlap=True, sweep_block=4),
                                dict(overlap=True, sweep_block=8)],
                         ids=["sync", "overlap1", "overlap4", "overlap8"])
def test_run_refill_queries_equal_reference(tailed, kw):
    """The skewed mixed-kind stream through the per-sweep and the
    overlapped drivers: answers and every ServeStats field equal to the
    reference engine's in the same mode (and to the oracle)."""
    core, g, tips, _, _ = tailed
    ref, port = engines(tailed, **kw)
    qs = mixed(skewed(core, tips))
    got = port.run_refill_queries(qs)
    want = ref.run_refill_queries([to_ref(q) for q in qs])
    assert_results_equal(got, want)
    assert port.stats.as_dict() == ref.stats.as_dict()
    assert port.stats.refills > 0 and port.stats.lane_utilization > 0
    if kw:
        assert port.stats.sweep_blocks > 0
    for q in qs:
        if q.kind is K.LEVELS:
            np.testing.assert_array_equal(got[q], bfs_levels(g, q.source))


def test_submit_many_refill_and_reach_reuse_equal_reference(tailed):
    """submit_many through refill engines (both drivers): a reachability
    stream with per-component reuse, then a mixed stream with cache hits;
    answers and stats equal the reference's after every call."""
    core, g, tips, _, _ = tailed
    reach = [Query(int(s), K.REACHABILITY) for s in skewed(core, tips)]
    mix = mixed(skewed(core, tips, 6)) + [Query(int(tips[0]))]
    for kw in (dict(), dict(overlap=True, sweep_block=4)):
        ref, port = engines(tailed, cache=16, **kw)
        for qs in (reach, mix, mix[:3]):
            got = port.submit_many(qs)
            want = ref.submit_many([to_ref(q) for q in qs])
            for a, b in zip(got, want):
                assert_result_equal(a, b)
            assert port.stats.as_dict() == ref.stats.as_dict(), kw
        assert port.stats.component_hits > 0 and port.stats.cache_hits > 0


def test_bench_queries_overlap_counts():
    """``BENCH_queries.json`` ``overlap`` on the port: scale 7 (seed 3), 8
    tails of 96 (seed 5), 40 requests of the four kinds, W=32,
    max_iters=240, sweep_block=8, five drains: sweeps 980, sweep_blocks
    160, wire_bytes_total 10960320, every other counter equal to the
    per-sweep driver's."""
    from repro_torch.core.partition import partition_graph as t_partition
    from repro_torch.graphs.rmat import pick_sources as t_pick, \
        rmat_graph as t_rmat
    core = t_rmat(7, seed=3)
    g, tips = with_tails(core, n_tails=8, length=96, seed=5)
    pg = t_partition(g, th=64, p_rank=2, p_gpu=2)
    shallow = t_pick(core, 40 - len(tips), seed=1)
    stream = np.asarray(shallow, np.int64).tolist()
    gap = max(1, len(stream) // len(tips))
    for i, tip in enumerate(tips):
        stream.insert(i * gap, int(tip))
    tpool = tuple(int(s) for s in shallow[:2])
    kinds = [lambda s: Query(s), lambda s: Query(s, K.REACHABILITY),
             lambda s: Query(s, K.DISTANCE_LIMITED, max_depth=3),
             lambda s: Query(s, K.MULTI_TARGET, targets=tpool)]
    qs = [kinds[i % 4](int(s)) for i, s in enumerate(stream[:40])]
    cfg = TM.MSBFSConfig(n_queries=32, max_iters=240)
    stats = {}
    for overlap in (False, True):
        eng = BFSServeEngine(pg=pg, cfg=cfg, cache_capacity=0, refill=True,
                             overlap=overlap, sweep_block=8,
                             reuse_components=False, device="cpu")
        eng.warmup(targets=True)
        for _ in range(5):
            eng.run_refill_queries(qs)
        stats[overlap] = eng.stats.as_dict()
    o, s = stats[True], stats[False]
    assert (o["sweeps"], o["sweep_blocks"], o["wire_bytes_total"]) == \
        (980, 160, 10960320)
    assert {k: v for k, v in o.items() if k != "sweep_blocks"} == \
        {k: v for k, v in s.items() if k != "sweep_blocks"}


# ------------------------------------------------------------ streaming API
def stream_script(core, tips):
    """One submit sequence: chunks with a front-of-queue submission, an
    in-session duplicate, a resubmission after delivery, polls between."""
    qs = mixed(skewed(core, tips))
    return [("submit", qs[:3], False), ("poll",), ("poll",),
            ("submit", qs[3:7], False), ("submit", qs[7:9], True),
            ("poll",), ("submit", [qs[1], qs[9]], False), ("poll",),
            ("submit", qs[10:] + [qs[0]], False), ("poll",), ("drain",)]


@pytest.mark.parametrize("cache", [0, 16])
def test_stream_deliveries_equal_reference(tailed, cache):
    """The same submit_stream / poll / drain_stream sequence through both
    engines: each call delivers the same queries and results, returns the
    same counts, and the stats are equal after every step."""
    core, g, tips, _, _ = tailed
    ref, port = engines(tailed, cache=cache, overlap=True)
    for step in stream_script(core, tips):
        if step[0] == "submit":
            _, qs, front = step
            assert port.submit_stream(qs, front=front) == ref.submit_stream(
                [to_ref(q) for q in qs], front=front)
            assert port.stream_status() == ref.stream_status()
            continue
        got = port.poll() if step[0] == "poll" else port.drain_stream()
        want = ref.poll() if step[0] == "poll" else ref.drain_stream()
        assert_results_equal(got, want)
        assert port.stats.as_dict() == ref.stats.as_dict(), step
    assert port._stream is None and port.poll() == {} == ref.poll()
    assert port.stream_status()["open"] is False


def test_stream_poll_nonblocking_and_mid_session_fill(tailed):
    """Queries fed to idle lanes mid-session are seeded at the next quiet
    boundary, as the reference does; then poll(wait=False) drains
    everything (on the CPU a sweep is done when it returns)."""
    core, g, tips, _, _ = tailed
    ref, port = engines(tailed, overlap=True)
    first = [Query(int(tips[0]))]
    shallow = [Query(int(s)) for s in pick_sources(core, 3, seed=13)]
    for eng, conv in ((port, lambda q: q), (ref, to_ref)):
        eng.submit_stream([conv(q) for q in first])
        eng.poll()
        eng.submit_stream([conv(q) for q in shallow])
        eng.poll()
        assert not eng._stream.sched.pending
    assert port.stream_status() == ref.stream_status()
    got = {}
    for _ in range(1000):
        got.update(port.poll(wait=False))
        if not (port._stream.sched.n_busy or port._stream.sched.pending):
            break
    got.update(port.drain_stream())
    ref.drain_stream()
    assert port.stats.as_dict() == ref.stats.as_dict()
    for q in first + shallow:
        np.testing.assert_array_equal(got[q], bfs_levels(g, q.source))


def test_stream_variant_mismatch_and_generality(tailed):
    core, g, tips, _, port = (*tailed[:3], None, engines(
        tailed, reuse_components=False)[1])
    srcs = [int(s) for s in pick_sources(core, 3, seed=4)]
    port.submit_stream([Query(srcs[0], K.REACHABILITY)])
    with pytest.raises(ValueError, match="REACHABILITY"):
        port.submit_stream([Query(srcs[1])])
    port.drain_stream()
    port.submit_stream([Query(srcs[1])])
    mt = Query(srcs[2], K.MULTI_TARGET, targets=(srcs[0],))
    port.submit_stream([mt])
    out = port.drain_stream()
    assert out[mt] == {srcs[0]: int(bfs_levels(g, srcs[2])[srcs[0]])}
    # a drained engine opens a payload stream for a COMPONENTS query
    port.submit_stream([Query(srcs[0], K.COMPONENTS)])
    np.testing.assert_array_equal(
        port.drain_stream()[Query(srcs[0], K.COMPONENTS)],
        component_labels(g))


# ------------------------------------------------------- boundary cases
@pytest.mark.parametrize("mode", ["batch", "refill", "overlap", "stream"])
def test_empty_single_and_exactly_w(tailed, mode):
    """Empty, single and exactly-W query sets through every entry point:
    answers and stats equal to the reference's (reach_fast included)."""
    core = tailed[0]
    kw = dict(overlap=True) if mode in ("overlap", "stream") else {}
    ref, port = engines(tailed, **kw)
    if mode == "batch":
        ref.refill = port.refill = False
    srcs = [int(s) for s in pick_sources(core, W, seed=6)]
    sets = [[], [Query(srcs[0])], [Query(s) for s in srcs],
            [Query(s, K.REACHABILITY) for s in srcs]]
    for qs in sets:
        rqs = [to_ref(q) for q in qs]
        if mode == "batch":
            got, want = port.run_batch_queries(qs), ref.run_batch_queries(rqs)
        elif mode == "stream":
            assert port.submit_stream(qs) == ref.submit_stream(rqs)
            got, want = port.drain_stream(), ref.drain_stream()
        else:
            got, want = port.run_refill_queries(qs), ref.run_refill_queries(rqs)
        assert_results_equal(got, want)
        assert port.stats.as_dict() == ref.stats.as_dict(), (mode, len(qs))
    if mode == "batch":
        with pytest.raises(ValueError):
            port.run_batch_queries([Query(s) for s in srcs] + [Query(3)])


def test_refill_entry_points_dedup_with_stats(tailed):
    """Both refill entry points drop exact duplicates and count them in
    dedup_hits; same source under different kinds stays distinct."""
    core, g, tips, _, _ = tailed
    s0, s1 = (int(s) for s in pick_sources(core, 2, seed=8))
    ref, port = engines(tailed)
    qs = [Query(s0), Query(s0), Query(s1), Query(s0, K.REACHABILITY),
          Query(s0), Query(s0, K.DISTANCE_LIMITED, max_depth=2),
          Query(s0, K.REACHABILITY)]
    assert_results_equal(port.run_refill_queries(qs),
                         ref.run_refill_queries([to_ref(q) for q in qs]))
    assert port.stats.as_dict() == ref.stats.as_dict()
    assert port.stats.dedup_hits == 3
    got = port.run_refill(np.asarray([s0, s1, s0, s1]))
    want = ref.run_refill(np.asarray([s0, s1, s0, s1]))
    assert list(got) == list(want)
    for s in got:
        np.testing.assert_array_equal(got[s], want[s])
    assert port.stats.as_dict() == ref.stats.as_dict()
    with pytest.raises(ValueError):
        port.run_refill(np.asarray([g.n]))


def test_warmup_leaves_stats_and_cache_untouched(tailed):
    _, port = engines(tailed, cache=8, overlap=True)
    port.warmup(reachability=True, targets=True)
    assert port.stats.as_dict() == BFSServeEngine.__init__.__globals__[
        "ServeStats"]().as_dict()
    assert len(port.cache) == 0
    with pytest.raises(ValueError):
        engines(tailed, sweep_block=0)
