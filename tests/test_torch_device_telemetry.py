"""The observability half of device telemetry in the port: the harvest of
the ``tm_*`` leaves (``repro_torch.obs.harvest_telemetry``, the engine's
``last_telemetry``), the per-shard metrics export, and the sampled
dispatch profiler -- against the reference's ``repro.obs``.

* A state without telemetry harvests to ``None``; skew's edge cases.
* Telemetry on, with obs and profiler attached, changes no answer and no
  ``ServeStats`` field in batch, refill and overlap modes; the port's
  ``last_telemetry`` and ``device.shard.<i>.*`` metrics equal the
  reference engine's.
* Per-shard wire telemetry sums exactly to the global wire counters, and
  single-source frontier telemetry to the oracle's level sizes.
* Profiler sampling is deterministic (a counter, no RNG); a ``BlockRun``
  and a tuple of tensors both work as a dispatch's result.

rmat scale 8 (seed 11), W = 4, the reference tests' fixtures. Exact
equality throughout."""
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import _torch_obs as TO
from repro.core import msbfs as RM
from repro.core.partition import partition_graph
from repro.graphs.rmat import pick_sources, rmat_graph
from repro.obs import Observability as RefObs
from repro.serve import BFSServeEngine as RefEngine
from repro_torch.core import bfs as TB, convert, engine as TE
from repro_torch.core import msbfs as TM
from repro_torch.core.oracle import bfs_levels
from repro_torch.obs import (NULL_PROFILER, DispatchProfiler, Observability,
                             as_profiler, harvest_telemetry, shard_metric,
                             skew)
from repro_torch.obs.profile import until_ready
from repro_torch.serve import BFSServeEngine, Query

GRAPH = rmat_graph(8, seed=11)
TEL_FIELDS = ("frontier_n", "frontier_d", "dir_backward", "wire_delegate",
              "wire_nn", "nn_sparse", "nn_overflow")


@pytest.fixture(scope="module")
def parts():
    rpg = partition_graph(GRAPH, th=32, p_rank=2, p_gpu=2)
    pg = convert.partition_from_arrays(*convert.partition_to_arrays(rpg))
    return rpg, pg


def make_engine(pg, telemetry=False, obs=None, **kw):
    cfg = TM.MSBFSConfig(n_queries=4, max_iters=96, telemetry=telemetry)
    return BFSServeEngine(pg=pg, cfg=cfg, cache_capacity=0, obs=obs,
                          device="cpu", **kw)


def assert_telemetry_equal(got, want) -> None:
    assert got.sweeps == want.sweeps
    for name in TEL_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_disabled_state_harvests_nothing(parts):
    _, pg = parts
    srcs = [int(s) for s in pick_sources(GRAPH, 4, seed=1)]
    off = TM.init_multi_state(pg, srcs, TM.MSBFSConfig(n_queries=4),
                              device="cpu")
    assert tuple(off.tm_frontier_n.shape) == (pg.p, 0)
    assert harvest_telemetry(off) is None
    on = TM.init_multi_state(pg, srcs, TM.MSBFSConfig(
        n_queries=4, max_iters=64, telemetry=True), device="cpu")
    tel = harvest_telemetry(on)
    assert tel.frontier_n.shape == (pg.p, 64) and tel.sweeps == 0
    assert tel.dir_backward.dtype == np.uint32
    boff = TB.init_state(pg, srcs[0], TB.BFSConfig(max_iters=48),
                         device="cpu")
    assert harvest_telemetry(boff) is None
    bon = TB.init_state(pg, srcs[0], TB.BFSConfig(max_iters=48,
                                                  telemetry=True),
                        device="cpu")
    assert harvest_telemetry(bon).dir_backward.dtype == np.int32

    class Legacy:
        pass

    assert harvest_telemetry(Legacy()) is None


def test_skew_edge_cases():
    assert skew([]) == 0.0
    assert skew([0, 0, 0]) == 0.0
    assert skew([5, 5, 5, 5]) == pytest.approx(1.0)
    assert skew([3, 1]) == pytest.approx(1.5)


@pytest.mark.parametrize("mode", ["batch", "refill", "overlap"])
def test_telemetry_never_changes_schedule_and_matches_reference(parts,
                                                                 mode):
    """Telemetry on with obs + profiler against a bare engine: answers and
    every ServeStats field equal; the harvested telemetry and the device
    metrics equal the reference engine's on the same run."""
    rpg, pg = parts
    kw = {"batch": {}, "refill": {"refill": True},
          "overlap": {"refill": True, "overlap": True}}[mode]
    qs = [Query(int(s)) for s in pick_sources(GRAPH, 8, seed=3)]
    obs = Observability(clock=TO.FakeClock())
    on = make_engine(pg, telemetry=True, obs=obs, profile=True, **kw)
    off = make_engine(pg, **kw)
    ref = RefEngine(pg=rpg, cfg=RM.MSBFSConfig(n_queries=4, max_iters=96,
                                               telemetry=True),
                    cache_capacity=0, obs=RefObs(clock=TO.FakeClock()),
                    profile=True, **kw)
    a_on, a_off = on.submit_many(qs), off.submit_many(qs)
    a_ref = ref.submit_many([TO.to_ref(q) for q in qs])
    assert on.stats.as_dict() == off.stats.as_dict() == ref.stats.as_dict()
    for a, b, c in zip(a_on, a_off, a_ref):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    tel = on.last_telemetry
    assert tel is not None and tel.sweeps > 0 and tel.p == pg.p
    assert off.last_telemetry is None
    assert int(tel.shard_frontier().sum()) > 0
    assert_telemetry_equal(tel, ref.last_telemetry)
    TO.assert_planes_equal(ref.obs, obs)
    assert on.profiler.sampled == on.profiler.dispatches > 0


def test_shard_telemetry_sums_to_global_wire_counters(parts):
    """One batch traversal: the per-shard per-sweep wire split sums
    exactly to the global ServeStats wire counters, and the harvested
    nn_sparse record to nn_sparse_sweeps."""
    _, pg = parts
    eng = make_engine(pg, telemetry=True)
    eng.submit_many([Query(int(s)) for s in pick_sources(GRAPH, 4, seed=5)])
    st, tel = eng.stats, eng.last_telemetry
    assert st.batches == 1 and tel is not None
    assert int(tel.wire_delegate.sum()) == st.wire_delegate_bytes
    assert int(tel.wire_nn.sum()) == st.wire_nn_bytes
    assert int(tel.shard_wire_bytes().sum()) == st.wire_bytes_total
    assert int(tel.nn_sparse.sum()) == st.nn_sparse_sweeps
    assert tel.wire_delegate.shape == tel.wire_nn.shape == (
        pg.p, eng.cfg.max_iters)


def test_bfs_frontier_telemetry_matches_oracle_levels(parts):
    """Single-source BFS: for every executed sweep, the per-shard normal
    frontier counts plus the replicated delegate count equal the oracle's
    number of vertices at that level."""
    _, pg = parts
    src = int(pick_sources(GRAPH, 1, seed=2)[0])
    cfg = TB.BFSConfig(max_iters=48, enable_do=True, telemetry=True)
    out = TB.run_bfs_emulated(TB.device_view(pg, "cpu"),
                              TB.init_state(pg, src, cfg, device="cpu"), cfg)
    levels = bfs_levels(GRAPH, src)
    np.testing.assert_array_equal(TB.gather_levels(pg, out), levels)
    tel = harvest_telemetry(out)
    sweeps = int(out.it[0])
    assert tel is not None and tel.sweeps == sweeps
    for t in range(sweeps):
        got = int(tel.frontier_n[:, t].sum()) + int(tel.frontier_d[0, t])
        assert got == int(np.sum(levels == t)), t
    np.testing.assert_array_equal(
        tel.frontier_d, np.broadcast_to(tel.frontier_d[:1],
                                        tel.frontier_d.shape))
    assert int(tel.frontier_n[:, sweeps:].sum()) == 0
    assert 0 <= int(tel.dir_backward.min()) <= int(tel.dir_backward.max()) \
        <= 7


def test_shard_metrics_export(parts):
    """The harvested telemetry lands in the registry under the canonical
    ``device.*`` names with exact per-shard totals."""
    _, pg = parts
    obs = Observability()
    eng = make_engine(pg, telemetry=True, obs=obs)
    eng.submit_many([Query(int(s)) for s in pick_sources(GRAPH, 4, seed=7)])
    tel = eng.last_telemetry
    snap = obs.metrics.snapshot()
    ftot, wtot = tel.shard_frontier(), tel.shard_wire_bytes()
    for i in range(tel.p):
        assert snap["gauges"][shard_metric(i, "frontier_total")] == \
            int(ftot[i])
        assert snap["gauges"][shard_metric(i, "wire_bytes")] == int(wtot[i])
        h = snap["histograms"][shard_metric(i, "frontier_per_sweep")]
        assert h["count"] == min(tel.sweeps, tel.frontier_n.shape[1])
    assert snap["gauges"]["device.sweeps"] == tel.sweeps
    assert snap["gauges"]["device.frontier_skew"] == pytest.approx(skew(ftot))
    assert snap["gauges"]["device.wire_skew"] == pytest.approx(skew(wtot))
    assert snap["histograms"]["device.frontier_skew_dist"]["count"] == \
        eng.stats.batches


# ---------------------------------------------------------------- profiler
def test_profiler_deterministic_sampling():
    clock = iter(float(i) for i in range(1000))
    prof = DispatchProfiler(sample_rate=0.5, clock=lambda: next(clock))
    assert prof.sample_every == 2
    for _ in range(5):
        assert prof.timed("x", lambda: 42) == 42
    assert prof.dispatches == 5 and prof.sampled == 3   # calls 1, 3, 5
    s = prof.summary()
    assert s["sample_rate"] == 0.5
    assert s["dispatch_latency_s"]["x"]["count"] == 3
    prof.timed("y", lambda: None)                      # its own counter
    assert prof.sampled == 4
    full = DispatchProfiler(sample_rate=1.0, clock=lambda: next(clock))
    for _ in range(4):
        full.timed("z", lambda: 0)
    assert full.sampled == full.dispatches == 4


def test_profiler_mirrors_into_obs():
    clock = iter(float(i) for i in range(1000))
    obs = Observability()
    prof = DispatchProfiler(sample_rate=1.0, obs=obs,
                            clock=lambda: next(clock))
    prof.timed("batch", lambda a: a + 1, 1)
    snap = obs.metrics.snapshot()
    assert snap["histograms"]["profile.dispatch_s.batch"]["count"] == 1
    assert snap["counters"]["profile.samples"] == 1
    prof.bind_obs(Observability())             # only fills an empty slot
    assert prof.obs is obs


def test_as_profiler_coercions():
    assert as_profiler(None) is NULL_PROFILER
    assert as_profiler(False) is NULL_PROFILER
    assert as_profiler(NULL_PROFILER) is NULL_PROFILER
    p = as_profiler(True)
    assert isinstance(p, DispatchProfiler) and p.sample_every == 1
    assert as_profiler(0.25).sample_every == 4
    inst = DispatchProfiler(sample_rate=0.5)
    assert as_profiler(inst) is inst
    with pytest.raises(TypeError):
        as_profiler("always")
    with pytest.raises(ValueError):
        DispatchProfiler(sample_rate=0.0)
    with pytest.raises(ValueError):
        DispatchProfiler(sample_rate=1.5)
    assert NULL_PROFILER.timed("x", lambda: 7) == 7
    assert NULL_PROFILER.summary() == {}
    assert NULL_PROFILER.start_trace() is False
    with NULL_PROFILER.trace_session():
        pass


def test_trace_session_without_dir_is_noop():
    prof = DispatchProfiler(sample_rate=1.0)
    assert prof.start_trace() is False
    with prof.trace_session():
        pass
    assert prof._tracing is False and prof.trace_path is None


def test_profiled_block_and_tuple_results(parts):
    """A ``BlockRun`` is waited for (its probe known, the same state as an
    unprofiled block of the same start), and a tuple of tensors passes
    through; on the CPU the call itself is what is timed."""
    _, pg = parts
    cfg = TM.MSBFSConfig(n_queries=4, max_iters=96, enable_targets=False)
    pgv = TB.device_view(pg, "cpu")
    plan = TE.device_plan(TE.build_exchange_plan(pg), "cpu")
    srcs = [int(s) for s in pick_sources(GRAPH, 3, seed=4)]
    watch = np.array([True, True, True, False])
    prof = DispatchProfiler()
    outs = []
    for timed in (True, False):
        blk = TM.make_msbfs_block_emulated(cfg, 4)
        st = TM.init_multi_state(pg, srcs, cfg, device="cpu")
        run = (prof.timed("block", blk, pgv, plan, st, watch) if timed
               else blk(pgv, plan, st, watch))
        outs.append((run.wait().it, convert.state_to_numpy(run.out)))
    assert prof.sampled == 1 and outs[0][0] == outs[1][0] > 0
    for k in TM.STATE_LEAVES:
        np.testing.assert_array_equal(outs[0][1][k], outs[1][1][k])
    pair = prof.timed("pair", lambda: (torch.ones(3), torch.zeros(2)))
    assert isinstance(pair, tuple) and len(pair) == 2
    until_ready(None)
    assert prof.summary()["dispatch_latency_s"].keys() == {"block", "pair"}
