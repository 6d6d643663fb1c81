"""The port's comm strategies against the reference's on the same numpy
inputs: every delegate combine strategy (auto / allgather / ring / hier)
on one emulated axis (``vmap(axis_name="p")``) and on the emulated
two-axis mesh (a nested vmap), for ``or`` / ``min`` / ``max`` / ``sum``
(int32, wrapping); the nn wire
formats (dense / sparse / adaptive) feasible, saturated and pinned-sparse
overflowing; and the emulated msBFS reproducing ``BENCH_comm.json``'s
``comm_strategies`` rows. Exact equality throughout: values, wire bytes,
the sparse flag and the overflow counter are integers."""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import bfs as RB, comm as RC, engine as RE, msbfs as RM
from repro.core.partition import partition_graph
from repro.graphs.rmat import pick_sources, rmat_graph
from repro_torch.core import comm as TC, convert, engine as TE, msbfs as TM
from repro_torch.core import bfs as TB
from repro_torch.core.oracle import bfs_levels
from repro_torch.kernels.mask_reduce import mask_reduce_apply_plain

from test_torch_bfs import (assert_state_equal as bfs_assert_equal,
                            both as bfs_both, ref_step as bfs_ref_step)
from test_torch_msbfs import (assert_state_equal as msbfs_assert_equal,
                              both as msbfs_both, seeds as msbfs_seeds)

STRATEGIES = ("auto", "allgather", "ring", "hier")
ROOT = Path(__file__).resolve().parents[1]


def _values(rng, op, shape):
    if op == "or":
        return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    if op == "min":
        return np.where(rng.random(shape) < 0.5, rng.integers(0, 50, shape),
                        2**30).astype(np.int32)
    if op == "sum":                  # int32 sums that wrap
        return rng.integers(-2**31, 2**31, shape).astype(np.int32)
    return rng.integers(-7, 9, shape).astype(np.int32)


def _port(x):
    return torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x)


def _np(t, like):
    a = t.contiguous().numpy()
    return a.view(np.uint32) if like.dtype == np.uint32 else a


# ------------------------------------------------------ delegate combine
@pytest.mark.parametrize("op", ["or", "min", "max", "sum"])
@pytest.mark.parametrize("delegate", STRATEGIES)
@pytest.mark.parametrize("p,n", [(2, 9), (3, 31), (4, 7), (5, 33)])
def test_delegate_combine_matches_reference_vmap(delegate, op, p, n):
    x = _values(np.random.default_rng(p * 100 + n), op, (p, n))
    cfg = dict(delegate=delegate)
    seen = {}

    def ref(v):
        out, seen["bytes"] = RC.delegate_combine(
            RC.plan_for(RC.CommConfig(**cfg), "p"), v, op)
        return out

    want = np.asarray(jax.vmap(ref, axis_name="p")(jnp.asarray(x)))
    got, nbytes = TC.delegate_combine(TC.plan_for(TC.CommConfig(**cfg), p),
                                      _port(x), op)
    np.testing.assert_array_equal(_np(got, x), want)
    assert nbytes == seen["bytes"]


def test_delegate_combine_max_uint8_matches_reference_vmap():
    """The single-source ``delegate_u8`` masks: uint8 ``"max"``."""
    x = (np.random.default_rng(3).random((4, 13)) < 0.3).astype(np.uint8)
    for delegate in STRATEGIES:
        seen = {}

        def ref(v):
            out, seen["b"] = RC.delegate_combine(
                RC.plan_for(RC.CommConfig(delegate=delegate), "p"), v, "max")
            return out

        want = np.asarray(jax.vmap(ref, axis_name="p")(jnp.asarray(x)))
        got, nbytes = TC.delegate_combine(
            TC.plan_for(TC.CommConfig(delegate=delegate), 4),
            torch.from_numpy(x), "max")
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)
        assert nbytes == seen["b"]


@pytest.mark.parametrize("op", ["or", "min", "max", "sum"])
@pytest.mark.parametrize("delegate,split", [("allgather", 1), ("ring", 1),
                                            ("hier", 1), ("auto", 1)])
@pytest.mark.parametrize("sizes", [(2, 2), (2, 3), (3, 2)])
def test_delegate_combine_two_axis_emulated(delegate, split, op, sizes):
    """A nested vmap is the emulated (outer, inner) mesh: hier runs two
    levels there and the ring one ring per axis; the port's two-axis plan
    stacks the same rows row-major."""
    p, n = sizes[0] * sizes[1], 11
    x = _values(np.random.default_rng(sum(sizes) + len(op)), op, (p, n))
    cfg = dict(delegate=delegate, hier_split=split)
    seen = {}

    def ref(v):
        out, seen["bytes"] = RC.delegate_combine(
            RC.plan_for(RC.CommConfig(**cfg), ("outer", "inner")), v, op)
        return out

    want = jax.vmap(jax.vmap(ref, axis_name="inner"), axis_name="outer")(
        jnp.asarray(x.reshape(sizes + (n,))))
    plan = TC.CommPlan(TC.CommConfig(**cfg), ("outer", "inner"), sizes)
    got, nbytes = TC.delegate_combine(plan, _port(x), op)
    np.testing.assert_array_equal(_np(got, x),
                                  np.asarray(want).reshape(p, n))
    assert nbytes == seen["bytes"]


@pytest.mark.parametrize("delegate", STRATEGIES)
@pytest.mark.parametrize("axes,sizes", [(("p",), (4,)),
                                        (("outer", "inner"), (2, 2)),
                                        (("outer", "inner"), (3, 2))])
def test_delegate_or_apply_strategies_equal_the_plain_update(delegate, axes,
                                                             sizes):
    """The step's fused update under every strategy (ring: one reduced
    row, K = 1; hier: the last group's members) equals the plain update of
    the flat OR, and its bytes the reference plan's formula."""
    rng = np.random.default_rng(len(axes) * 10 + sizes[0])
    p, d, w = int(np.prod(sizes)), 9, 40
    nw = 2
    words = rng.integers(-2**31, 2**31, (p, d, nw)).astype(np.int32)
    level = np.where(rng.random((p, d, w)) < 0.5, 2**30,
                     rng.integers(0, 3, (p, d, w))).astype(np.int32)
    level[:] = level[:1]                       # replicated delegate plane
    target = np.broadcast_to(rng.random((1, d, w)) < 0.2, (p, d, w)).copy()
    it = np.full(p, 2, dtype=np.int32)
    plan = TC.CommPlan(TC.CommConfig(delegate=delegate), axes, sizes)
    got, nbytes = TC.delegate_or_apply(
        plan, torch.from_numpy(words), torch.from_numpy(level),
        torch.from_numpy(it), torch.from_numpy(target))
    flat = np.bitwise_or.reduce(words.reshape(p, -1), axis=0)[None]
    want = mask_reduce_apply_plain(torch.from_numpy(flat),
                                   torch.from_numpy(level),
                                   torch.from_numpy(it),
                                   torch.from_numpy(target))
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    ref = RC.CommPlan(RC.CommConfig(delegate=delegate), axes, sizes)
    assert nbytes == ref.delegate_bytes(d * nw, 4, "or")


@pytest.mark.parametrize("delegate", STRATEGIES)
def test_delegate_min_apply_strategies_equal(delegate):
    rng = np.random.default_rng(9)
    cand = _values(rng, "min", (4, 21))
    prev = np.broadcast_to(_values(rng, "min", (1, 21)), (4, 21)).copy()
    plan = TC.plan_for(TC.CommConfig(delegate=delegate), 4)
    out, improved, nbytes = TC.delegate_min_apply(
        plan, torch.from_numpy(cand), torch.from_numpy(prev))
    want = np.minimum(prev, cand.min(0))
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(improved.numpy(), (want < prev).any(1))
    ref = RC.CommPlan(RC.CommConfig(delegate=delegate), ("p",), (4,))
    assert nbytes == ref.delegate_bytes(21, 4, "min")


# ------------------------------------------------------ nn wire formats
def _nn_case(seed, p, cap, w, per_row):
    """Random slot occupancy with ``per_row`` active slots per peer row
    (None: dense occupancy) and random receive tables."""
    rng = np.random.default_rng(seed)
    nl = 16
    recv_local = rng.integers(-1, nl, (p, p, cap)).astype(np.int32)
    dense = np.zeros((p, p, cap, w), dtype=bool)
    for i in range(p):
        for j in range(p):
            k = cap if per_row is None else per_row
            for s in rng.choice(cap, size=k, replace=False):
                dense[i, j, s] = rng.random(w) < 0.5
            dense[i, j, rng.choice(cap, size=k, replace=False)[:1], 0] = True
    return dense, recv_local, nl


def _compare_nn(want, got, p):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for name, g, wv in zip(("bytes", "sparse", "overflow"), got[1:],
                           want[1:]):
        g = np.broadcast_to(np.asarray(g), (p,))
        np.testing.assert_array_equal(g, np.asarray(wv), err_msg=name)


@pytest.mark.parametrize("mode", ["dense", "sparse", "adaptive"])
@pytest.mark.parametrize("case", ["feasible", "saturated", "overflow"])
@pytest.mark.parametrize("p,w", [(2, 33), (3, 7), (4, 32)])
def test_nn_exchange_words_formats_match_reference_vmap(mode, case, p, w):
    """Feasible: at most ``sparse_cap`` (2) active slots per peer row, so
    adaptive ships sparse; saturated: every slot active, adaptive falls
    back to dense; overflow: 5 active slots per row over a pinned cap of
    2, so sparse drops (and counts) the ones a stable sort puts last."""
    cap = 10
    per_row = {"feasible": 2, "saturated": None, "overflow": 5}[case]
    dense, recv_local, nl = _nn_case(p * 7 + w, p, cap, w, per_row)
    cfg = dict(nn=mode, sparse_cap=2)
    want = jax.vmap(
        lambda d, r: RC.nn_exchange_words(RC.plan_for(RC.CommConfig(**cfg),
                                                      "p"), d, r, nl),
        axis_name="p")(jnp.asarray(dense), jnp.asarray(recv_local))
    got = TC.nn_exchange_words(TC.plan_for(TC.CommConfig(**cfg), p),
                               torch.from_numpy(dense),
                               torch.from_numpy(recv_local), nl)
    _compare_nn(want, got, p)
    if mode == "sparse" and case != "feasible":
        assert int(np.asarray(want[3]).sum()) > 0


@pytest.mark.parametrize("mode", ["dense", "sparse", "adaptive"])
@pytest.mark.parametrize("case", ["feasible", "saturated", "overflow"])
@pytest.mark.parametrize("p", [2, 4])
def test_nn_exchange_bits_formats_match_reference_vmap(mode, case, p):
    cap = 64
    per_row = {"feasible": 1, "saturated": None, "overflow": 6}[case]
    dense, recv_local, nl = _nn_case(p * 13, p, cap, 1, per_row)
    active = dense[..., 0] | dense.any(-1)
    cfg = dict(nn=mode, sparse_cap=0 if case != "overflow" else 3)
    want = jax.vmap(
        lambda a, r: RC.nn_exchange_bits(RC.plan_for(RC.CommConfig(**cfg),
                                                     "p"), a, r, nl),
        axis_name="p")(jnp.asarray(active), jnp.asarray(recv_local))
    got = TC.nn_exchange_bits(TC.plan_for(TC.CommConfig(**cfg), p),
                              torch.from_numpy(active),
                              torch.from_numpy(recv_local), nl)
    _compare_nn(want, got, p)


def test_compact_active_is_stable_over_its_cap():
    """Over the cap the first active slots in slot order are kept (the
    reference's stable ``argsort``); an unstable order would keep others."""
    act = torch.zeros((1, 1, 64), dtype=torch.bool)
    act[0, 0, [3, 9, 10, 40, 41, 63]] = True
    ids, valid, overflow = TC.exchange._compact_active(act, 4)
    assert ids[0, 0].tolist() == [3, 9, 10, 40]
    assert valid.all() and overflow.tolist() == [2]


# ------------------------------------- BENCH_comm.json comm_strategies
BENCH_ROWS = [("allgather", "dense"), ("allgather", "adaptive"),
              ("allgather+maskfold", "dense"),
              ("allgather+maskfold", "adaptive"), ("ring", "dense"),
              ("ring", "adaptive"), ("hier", "dense"), ("hier", "adaptive")]


@pytest.fixture(scope="module")
def bench_graph():
    g = rmat_graph(10, seed=10)
    rpg = partition_graph(g, th=64, p_rank=2, p_gpu=2)
    pg = convert.partition_from_arrays(*convert.partition_to_arrays(rpg))
    sources = pick_sources(g, 32, seed=11)
    return g, pg, sources, [bfs_levels(g, int(s)) for s in sources]


@pytest.mark.parametrize("name,nn", BENCH_ROWS)
def test_emulated_msbfs_reproduces_bench_comm(bench_graph, name, nn):
    """The benchmark's run (``benchmarks/comm_model.py --strategies``) on
    the port: every committed counter of the row, and oracle-exact levels.
    The ``+maskfold`` rows pin the reference's kernel fold, which the port
    always runs."""
    g, pg, sources, oracle = bench_graph
    row = json.loads((ROOT / "BENCH_comm.json").read_text())[
        "benchmarks"]["comm_strategies"]["strategies"][f"{name}/{nn}"]
    delegate = name.split("+")[0]
    cfg = TM.MSBFSConfig(n_queries=32, max_iters=48,
                         comm=TC.CommConfig(delegate=delegate, nn=nn))
    pgv = TB.device_view(pg, "cpu")
    plan = TE.device_plan(TE.build_exchange_plan(pg), "cpu")
    st = TM.init_multi_state(pg, sources, cfg, device="cpu")
    out = TM.run_msbfs_emulated(pgv, plan, st, cfg)
    levels = TM.gather_levels_multi(pg, out)
    sweeps = int(out.it[0])
    got = {
        "delegate_bytes": int(out.wire_delegate.sum()),
        "nn_bytes": int(out.wire_nn.sum()),
        "sweeps": sweeps,
        "nn_sparse_sweeps": int(out.nn_sparse[0].sum()),
        "nn_overflow": int(out.nn_overflow.sum()),
        "oracle_exact": all(np.array_equal(levels[i], oracle[i])
                            for i in range(len(sources))),
    }
    got["delegate_bytes_per_sweep"] = got["delegate_bytes"] // max(sweeps, 1)
    got["nn_bytes_per_sweep"] = got["nn_bytes"] // max(sweeps, 1)
    assert got == row


@pytest.mark.parametrize("delegate", ["allgather", "ring", "hier"])
@pytest.mark.parametrize("nn", ["dense", "sparse", "adaptive"])
def test_emulated_msbfs_strategies_every_leaf_equal(delegate, nn):
    """msBFS under every strategy and format, targets and depth caps on,
    at p = 4: every state leaf equals the reference's after every sweep
    (pinned sparse at the default cap drops slots: its overflow and the
    levels it leaves must equal the reference's too)."""
    graph = rmat_graph(10, seed=7)
    (rpg, rplan), (pg, pgv, plan) = msbfs_both(graph, 32, 2, 2)
    srcs, caps, tgts = msbfs_seeds(graph, rpg, True)
    comm = dict(delegate=delegate, nn=nn)
    rcfg = RM.MSBFSConfig(n_queries=8, max_iters=24, pull_chunk=16,
                          comm=RC.CommConfig(**comm))
    tcfg = TM.MSBFSConfig(n_queries=8, max_iters=24, pull_chunk=16,
                          comm=TC.CommConfig(**comm))
    rs = RM.init_multi_state(rpg, srcs, rcfg, depth_caps=caps, targets=tgts)
    ts = TM.init_multi_state(pg, srcs, tcfg, depth_caps=caps, targets=tgts,
                             device="cpu")
    rpgv = RB.device_view(rpg)
    sweep = 0
    while not bool(np.all(np.asarray(rs.done))):
        rs = RM.msbfs_step_emulated(rpgv, rplan, rs, rcfg)
        ts = TM.msbfs_step_emulated(pgv, plan, ts, tcfg)
        sweep += 1
        msbfs_assert_equal(rs, ts, f"sweep {sweep}")
    assert sweep >= 3
    if nn != "dense":
        assert int(ts.nn_sparse[0].sum()) > 0


@pytest.mark.parametrize("delegate", ["auto", "allgather", "ring", "hier"])
@pytest.mark.parametrize("nn", ["dense", "sparse", "adaptive"])
@pytest.mark.parametrize("u8", [False, True])
def test_emulated_bfs_strategies_every_leaf_equal(delegate, nn, u8):
    """The single-source path with the static exchange under every
    strategy and format (and the uint8 ``"max"`` combine): every state
    leaf equals the reference's after every sweep."""
    graph = rmat_graph(10, seed=7)
    (rpg, rplan), (pg, pgv, plan) = bfs_both(graph, 32, 2, 2)
    kw = dict(max_iters=24, pull_chunk=16, static_exchange=True,
              delegate_u8=u8)
    comm = dict(delegate=delegate, nn=nn)
    rcfg = RB.BFSConfig(**kw, comm=RC.CommConfig(**comm))
    tcfg = TB.BFSConfig(**kw, comm=TC.CommConfig(**comm))
    src = int(pick_sources(graph, 1, seed=1)[0])
    rs, ts = RB.init_state(rpg, src, rcfg), TB.init_state(pg, src, tcfg,
                                                         device="cpu")
    step, rpgv = bfs_ref_step(rcfg, True), RB.device_view(rpg)
    sweep = 0
    while not bool(np.all(np.asarray(rs.done))):
        rs = step(rpgv, rplan, rs)
        ts = TB.bfs_step(pgv, ts, tcfg, plan)
        sweep += 1
        bfs_assert_equal(rs, ts, f"sweep {sweep}")
    assert sweep >= 4
    if nn == "dense":
        np.testing.assert_array_equal(TB.gather_levels(pg, ts),
                                      bfs_levels(graph, src))
