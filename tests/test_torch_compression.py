"""The port's compression plane against the reference package: varint
streams, the compressed partition and its decoders, the compressed nn wire
codec, and the chunked (``edge_chunk``) sweeps.

The same inputs, made from a seed with numpy, go through both packages:

* the host codecs (varints, rle and delta-id streams, the partition's
  delta/varint adjacency) must be byte for byte the reference's;
* the torch byte-length formulas of the compressed nn format must equal
  the reference's ``jnp`` formulas, and so the host encoders' lengths;
* a chunked sweep must leave every state leaf equal to the reference's
  chunked sweep after every sweep, and to the port's own monolithic one;
  the ``BENCH_scaling.json`` ``chunked`` and ``memory_model`` sections are
  reproduced exactly.

Exact equality throughout: every quantity is an integer (the memory
model's ratios are the same integer quotients).
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import bfs as RB, comm as RC, engine as RE, msbfs as RM
from repro.core import partition as RP
from repro.core.comm import codec as RCodec
from repro.core.varint import (varint_decode as r_decode,
                               varint_encode as r_encode, varint_len as r_len)
from repro.graphs.rmat import pick_sources, rmat_graph
from repro.kernels import ops as rops
from repro.serve import BFSServeEngine as RefEngine
from repro.serve import Query as RQ, QueryKind as RK
from repro_torch.core import bfs as TB, comm as TC, convert, engine as TE
from repro_torch.core import msbfs as TM, partition as TP
from repro_torch.core.comm import codec as TCodec
from repro_torch.core.oracle import bfs_levels
from repro_torch.core.varint import varint_decode, varint_encode, varint_len
from repro_torch.kernels import ops
from repro_torch.serve import BFSServeEngine, Query, QueryKind

ROOT = Path(__file__).resolve().parents[1]
GRAPH = rmat_graph(8, seed=3)        # the reference's chunk-test graph


def port_of(rpg):
    return convert.partition_from_arrays(*convert.partition_to_arrays(rpg))


@pytest.fixture(scope="module")
def parts():
    """Reference partition and plan of ``GRAPH`` on the (2, 2) mesh, and
    the port's copies (host partition, CPU view, CPU plan)."""
    rpg = RP.partition_graph(GRAPH, th=64, p_rank=2, p_gpu=2)
    rplan = RE.build_exchange_plan(rpg)
    pg = port_of(rpg)
    plan = convert.plan_from_arrays(*convert.plan_to_arrays(rplan))
    return rpg, rplan, pg, TB.device_view(pg, "cpu"), TE.device_plan(plan,
                                                                     "cpu")


def leaves_equal(want: dict, got: dict, where: str = "") -> None:
    for k, w in want.items():
        g = got[k]
        if w.dtype == np.uint32:        # lane words: int32 bit patterns
            g = g.view(np.uint32)
        assert g.shape == w.shape and g.dtype == w.dtype, (k, where)
        np.testing.assert_array_equal(g, w, err_msg=f"{k} {where}")


def ref_leaves(rs, names) -> dict:
    return {k: np.asarray(getattr(rs, k)) for k in names}


# ------------------------------------------------------------------ varints
@pytest.mark.parametrize("seed", range(6))
def test_varint_round_trip_equals_reference(seed):
    """Magnitude-spread values (every byte-length class): the stream is
    byte for byte the reference's and decodes back; lengths agree."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 300))
    vals = (rng.integers(0, 2**63 - 1, n, dtype=np.int64)
            >> rng.integers(0, 63, n)).astype(np.int64)
    stream = varint_encode(vals)
    np.testing.assert_array_equal(stream, r_encode(vals))
    assert stream.dtype == np.uint8
    assert stream.size == int(varint_len(vals).sum())
    np.testing.assert_array_equal(varint_len(vals), r_len(vals))
    np.testing.assert_array_equal(varint_decode(stream), vals)
    np.testing.assert_array_equal(varint_decode(stream), r_decode(stream))


def test_varint_byte_length_classes():
    bounds = np.asarray([0, 127, 128, 2**14 - 1, 2**14, 2**21 - 1, 2**21,
                         2**28 - 1, 2**28, 2**35 - 1, 2**35, 2**63 - 1],
                        np.int64)
    assert varint_len(bounds).tolist() == [1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6,
                                           9]
    np.testing.assert_array_equal(varint_decode(varint_encode(bounds)),
                                  bounds)
    with pytest.raises(ValueError):
        varint_decode(np.array([0x80], np.uint8))      # truncated


# ------------------------------------------------------- nn wire codec
def masks(seed: int) -> np.ndarray:
    """``[rows, cap]`` bool masks over a range of densities, with an
    all-off, an all-on, a slot-0-only and a last-slot-only row."""
    rng = np.random.default_rng(seed)
    cap = int(rng.integers(1, 300))
    dens = np.linspace(0.0, 1.0, 11)
    rows = [rng.random(cap) < d for d in dens]
    rows += [np.zeros(cap, bool), np.ones(cap, bool),
             np.eye(1, cap, 0, dtype=bool)[0],
             np.eye(1, cap, cap - 1, dtype=bool)[0]]
    # long gaps: deltas and runs past one varint byte
    sparse = np.zeros(cap, bool)
    sparse[::129] = True
    rows.append(sparse)
    return np.stack(rows)


@pytest.mark.parametrize("seed", range(5))
def test_host_codec_is_byte_identical_to_reference(seed):
    for mask in masks(seed):
        rle = TCodec.rle_encode(mask)
        np.testing.assert_array_equal(rle, RCodec.rle_encode(mask))
        np.testing.assert_array_equal(TCodec.rle_decode(rle, mask.size), mask)
        ids = np.nonzero(mask)[0].astype(np.int64)
        delta = TCodec.delta_encode_ids(ids)
        np.testing.assert_array_equal(delta, RCodec.delta_encode_ids(ids))
        np.testing.assert_array_equal(TCodec.delta_decode_ids(delta), ids)
        assert TCodec.mask_stream_bytes(mask) == \
            RCodec.mask_stream_bytes(mask)
    with pytest.raises(ValueError):
        TCodec.rle_decode(TCodec.rle_encode(np.ones(5, bool)), 6)


@pytest.mark.parametrize("seed", range(5))
def test_torch_byte_formulas_equal_reference(seed):
    """The torch formulas equal the reference's jnp formulas and the host
    encoders' lengths, row by row (and with extra leading axes)."""
    m = masks(seed)
    rle = TCodec.rle_stream_bytes(torch.from_numpy(m)).numpy()
    delta = TCodec.delta_stream_bytes(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(
        rle, np.asarray(RCodec.rle_stream_bytes(jnp.asarray(m))))
    np.testing.assert_array_equal(
        delta, np.asarray(RCodec.delta_stream_bytes(jnp.asarray(m))))
    for row, r, d in zip(m, rle, delta):
        assert (int(r), int(d)) == TCodec.mask_stream_bytes(row)
    stacked = torch.from_numpy(np.stack([m, m[::-1]]))
    np.testing.assert_array_equal(
        TCodec.rle_stream_bytes(stacked).numpy(), np.stack([rle, rle[::-1]]))


@pytest.mark.parametrize("p,nw", [(2, 0), (4, 1), (4, 32), (3, 2)])
def test_compressed_wire_bytes_equal_reference(p, nw):
    """``compressed_wire_bytes`` of each partition of a stacked ``[p, p,
    cap]`` send map (each sender skips its own row) equals the
    reference's under ``vmap`` over the partition axis; delta wins
    ties."""
    rng = np.random.default_rng(10 * p + nw)
    cap = 97
    act = rng.random((p, p, cap)) < rng.random((p, p, 1)) * 0.6
    act[0, -1] = False                    # an empty peer row
    act[-1, 0, :] = True                  # a full one
    want = jax.vmap(lambda a: RCodec.compressed_wire_bytes(
        RC.plan_for(RC.CommConfig(nn="compressed"), "p"), a, nw),
        axis_name="p")(jnp.asarray(act))
    got = TCodec.compressed_wire_bytes(
        TC.plan_for(TC.CommConfig(nn="compressed"), p),
        torch.from_numpy(act), nw)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # ties go to delta: two active slots of two, 2 bytes either way
    tie = np.ones((2, 2, 2), bool)
    assert TCodec.mask_stream_bytes(tie[0, 1]) == (2, 2)
    wire, used = TCodec.compressed_wire_bytes(
        TC.plan_for(TC.CommConfig(nn="compressed"), 2),
        torch.from_numpy(tie), 0)
    assert wire.tolist() == [2, 2] and used.tolist() == [1, 1]


@pytest.mark.parametrize("fn", ["bits", "words", "payload"])
def test_compressed_nn_exchange_equals_reference(fn):
    """Each nn exchange under ``nn="compressed"``, on real receive tables
    of a scale-9 (2, 2) plan and random send maps (a sparse sweep and a
    dense one): the receive set, ``wire_nn`` and the delta flag equal the
    reference's, and no slot is dropped."""
    rpg = RP.partition_graph(rmat_graph(9, seed=3), th=32, p_rank=2,
                             p_gpu=2)
    plan = RE.build_exchange_plan(rpg)
    p, cap, nl = rpg.p, plan.cap_peer, rpg.n_local
    recv_local = np.asarray(plan.recv_local)
    rcfg, tcfg = RC.CommConfig(nn="compressed"), TC.CommConfig(nn="compressed")
    for density in (0.002, 0.4):
        rng = np.random.default_rng(int(density * 1000))
        act = rng.random((p, p, cap)) < density
        if fn == "bits":
            x = act
            rfn, tfn = RC.nn_exchange_bits, TC.nn_exchange_bits
        elif fn == "words":
            x = act[..., None] & (rng.random((p, p, cap, 32)) < 0.5)
            x[..., 0] |= act
            rfn, tfn = RC.nn_exchange_words, TC.nn_exchange_words
        else:
            x = np.where(act[..., None] & (rng.random((p, p, cap, 4)) < 0.7),
                         rng.integers(0, 100, (p, p, cap, 4)),
                         2**30).astype(np.int32)
            x[..., 0] = np.where(act, 7, x[..., 0])
            rfn, tfn = RC.nn_exchange_payload, TC.nn_exchange_payload
        want = jax.vmap(lambda d, r: rfn(RC.plan_for(rcfg, "p"), d, r, nl),
                        axis_name="p")(jnp.asarray(x), jnp.asarray(recv_local))
        got = tfn(TC.plan_for(tcfg, p), torch.from_numpy(x),
                  torch.from_numpy(recv_local), nl)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        assert got[3] == 0 and not np.asarray(want[3]).any()


# --------------------------------------------------- partition codec
@pytest.mark.parametrize("scale,th,seed", [(7, 8, 0), (9, 32, 3),
                                           (10, 64, 1)])
def test_compress_partition_equals_reference(scale, th, seed):
    """Every array and size of the four compressed stacks equals the
    reference's; decoding rows (whole and split) and ELL tiles equals the
    reference's too, the degree-overflow error included."""
    g = rmat_graph(scale, seed=seed)
    rpg = RP.partition_graph(g, th=th, p_rank=2, p_gpu=2)
    pg = port_of(rpg)
    rcp, cp = RP.compress_partition(rpg), TP.compress_partition(pg)
    for kind in ("nn", "nd", "dn", "dd"):
        rc, tc = rcp.subgraph(kind), cp.subgraph(kind)
        for a in ("data", "row_off", "nbytes", "m"):
            w, x = np.asarray(getattr(rc, a)), np.asarray(getattr(tc, a))
            assert x.dtype == w.dtype, (kind, a)
            np.testing.assert_array_equal(x, w, err_msg=f"{kind}.{a}")
        assert (tc.n_rows, tc.b_max, tc.key_split) == \
            (rc.n_rows, rc.b_max, rc.key_split)
        assert tc.memory_bytes() == rc.memory_bytes()
        for k in range(pg.p):
            for lo, hi in ((0, None), (0, tc.n_rows // 2),
                           (tc.n_rows // 3, None)):
                for x, w in zip(TP.decode_rows(tc, k, lo, hi),
                                RP.decode_rows(rc, k, lo, hi)):
                    np.testing.assert_array_equal(x, w)
        deg = np.diff(np.asarray(pg.subgraph(kind).offsets)[1], axis=-1)
        k_max = int(deg.max()) + 1
        for row0, n in ((0, tc.n_rows), (tc.n_rows // 2, 17)):
            np.testing.assert_array_equal(
                TP.decode_ell_tile(tc, 1, row0, n, k_max),
                RP.decode_ell_tile(rc, 1, row0, n, k_max))
        if k_max > 2:
            for mod, c in ((TP, tc), (RP, rc)):
                with pytest.raises(ValueError, match="exceeds k_max"):
                    mod.decode_ell_tile(c, 1, 0, c.n_rows, k_max - 2)
    assert pg.memory_bytes(compressed=cp) == rpg.memory_bytes(compressed=rcp)
    assert pg.memory_bytes() == rpg.memory_bytes()


def test_compress_csr_rejects_negative_values():
    pg = port_of(RP.partition_graph(rmat_graph(5, seed=2), th=8, p_rank=2,
                                    p_gpu=2))
    bad = np.full_like(np.asarray(pg.nd.cols), -1, dtype=np.int64)
    with pytest.raises(ValueError, match="negative"):
        TP.compress_csr(pg.nd, values=bad)


@pytest.mark.parametrize("th", [16, 64, 256])
def test_memory_model_reproduces_bench_scaling(th):
    """``BENCH_scaling.json`` ``memory_model`` (scale 14, seed 1, p = (2,
    2)): the port's compressed partition gives the committed bytes per
    edge and ratio exactly, and the same dict as the reference."""
    sec = json.loads((ROOT / "BENCH_scaling.json").read_text())[
        "benchmarks"]["memory_model"]
    gr = sec["graph"]
    from repro_torch.graphs.rmat import rmat_graph as port_rmat
    g = port_rmat(gr["scale"], seed=gr["seed"])
    pg = TP.partition_graph(g, th=th, p_rank=gr["p_rank"], p_gpu=gr["p_gpu"])
    mem = pg.memory_bytes(compressed=TP.compress_partition(pg))
    row = sec["ths"][f"th{th}"]
    for key in ("bytes_per_edge_raw", "bytes_per_edge_compressed",
                "compressed_vs_raw"):
        assert mem[key] == row[key], key
    assert pg.d == row["d"]
    assert mem["e_nn"] / mem["m"] == row["e_nn_frac"]
    assert mem["total"] / mem["edge_list_16m"] == row["vs_edge_list"]
    assert mem["total"] / mem["csr_8n_8m"] == row["vs_csr"]


@pytest.mark.parametrize("th", [4, 32, 64, 10**6])
def test_edge_kind_stats_equals_reference(th):
    from repro_torch.graphs.rmat import rmat_graph as port_rmat
    assert TP.edge_kind_stats(port_rmat(10, seed=1), th) == \
        RP.edge_kind_stats(rmat_graph(10, seed=1), th)


@pytest.mark.parametrize("kind", ["nd", "dn"])
def test_decoded_ell_tile_feeds_pull_kernel(kind):
    """A decoded ELL tile drives ``ops.ell_pull_multi`` (the plain
    version on the CPU): equal to the reference wrapper's ``"ref"``
    dispatch on the same tile and words, and to an OR over each row's
    decoded neighbors."""
    rpg = RP.partition_graph(rmat_graph(7, seed=3), th=32, p_rank=2,
                             p_gpu=2)
    pg = port_of(rpg)
    ccsr = TP.compress_partition(pg).subgraph(kind)
    rows = ccsr.n_rows
    k_max = int(np.diff(np.asarray(pg.subgraph(kind).offsets)[0]).max()) + 1
    tile = TP.decode_ell_tile(ccsr, 0, 0, rows, k_max)
    assert tile.shape == (rows, k_max) and tile.dtype == np.int32
    dec_r, dec_v = TP.decode_rows(ccsr, 0)
    for r in range(rows):
        np.testing.assert_array_equal(tile[r][tile[r] >= 0], dec_v[dec_r == r])
    n_src = int(tile.max()) + 2
    rng = np.random.default_rng(0)
    fw = rng.integers(0, 2**32, (n_src, 1), dtype=np.uint32)
    aw = rng.integers(0, 2**32, (rows, 1), dtype=np.uint32)
    got = ops.ell_pull_multi(torch.from_numpy(tile),
                             torch.from_numpy(fw.view(np.int32)),
                             torch.from_numpy(aw.view(np.int32)))
    want = np.asarray(rops.ell_pull_multi(jnp.asarray(tile), jnp.asarray(fw),
                                          jnp.asarray(aw), force="ref"))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    exp = np.zeros((rows, 1), np.uint32)
    for r in range(rows):
        for c in tile[r][tile[r] >= 0]:
            exp[r] |= fw[c]
    np.testing.assert_array_equal(want, exp & aw)


# ------------------------------------------------------ chunked sweeps
MS_CASES = {
    # name: (edge_chunk, nn, payload modes or None)
    "ec1-dense": (1, "dense", None),
    "ec37-adaptive": (37, "adaptive", None),
    "ec64-compressed": (64, "compressed", None),
    "ec-huge-compressed": (10**6, "compressed", None),
    "ec53-payload-compressed": (53, "compressed",
                                ["sssp", None, "components", "sssp"]),
    "ec64-payload-dense": (64, "dense", ["components", "sssp", None, None]),
}


@pytest.mark.parametrize("name", list(MS_CASES))
def test_chunked_msbfs_every_leaf_every_sweep(parts, name):
    """The port's chunked sweep against the reference's chunked sweep with
    the same ``edge_chunk`` (1, odd, 64, past ``e_max``), every leaf after
    every sweep, and against the port's own monolithic sweep; answers
    oracle-exact (bit lanes)."""
    ec, nn, modes = MS_CASES[name]
    rpg, rplan, pg, pgv, plan = parts
    w = 4
    srcs = [int(s) for s in pick_sources(GRAPH, 3, seed=1)]
    srcs.append(int(np.asarray(rpg.delegate_vids)[0]))
    kw = dict(n_queries=w, max_iters=96 if modes else 40,
              payload=modes is not None)
    rcfg = RM.MSBFSConfig(**kw, edge_chunk=ec, comm=RC.CommConfig(nn=nn))
    tcfg = TM.MSBFSConfig(**kw, edge_chunk=ec, comm=TC.CommConfig(nn=nn))
    mono = TM.MSBFSConfig(**kw, comm=TC.CommConfig(nn=nn))
    rs = RM.init_multi_state(rpg, srcs, rcfg, payload_modes=modes)
    ts = TM.init_multi_state(pg, srcs, tcfg, payload_modes=modes,
                             device="cpu")
    ms = TM.init_multi_state(pg, srcs, mono, payload_modes=modes,
                             device="cpu")
    step = jax.jit(lambda s: RM.msbfs_step_emulated(RB.device_view(rpg),
                                                    rplan, s, rcfg))
    sweep = 0
    while not bool(np.all(np.asarray(rs.done))) and sweep < kw["max_iters"]:
        rs = step(rs)
        ts = TM.msbfs_step_emulated(pgv, plan, ts, tcfg)
        ms = TM.msbfs_step_emulated(pgv, plan, ms, mono)
        sweep += 1
        got = convert.state_to_numpy(ts)
        leaves_equal(ref_leaves(rs, TM.STATE_LEAVES), got, f"sweep {sweep}")
        leaves_equal(convert.state_to_numpy(ms), got, f"mono {sweep}")
    assert sweep >= 3 and bool(ts.done.all())
    assert int(ts.work_bwd.sum()) > 0
    if nn == "compressed":
        assert int(ts.wire_nn.sum()) > 0
    levels = TM.gather_levels_multi(pg, ts)
    for q, s in enumerate(srcs):
        if modes is None or modes[q] is None:
            np.testing.assert_array_equal(levels[q], bfs_levels(GRAPH, s))


@pytest.mark.parametrize("static_exchange", [True, False])
@pytest.mark.parametrize("ec,nn", [(1, "compressed"), (48, "dense"),
                                   (10**6, "adaptive")])
def test_chunked_bfs_every_leaf_every_sweep(parts, static_exchange, ec, nn):
    """Single source: the chunked sweep equals the reference's chunked
    sweep (and the port's monolithic one) after every sweep, static
    exchange both ways (the binned nn path is monolithic in both)."""
    rpg, rplan, pg, pgv, plan = parts
    src = int(pick_sources(GRAPH, 1, seed=5)[0])
    kw = dict(max_iters=40, static_exchange=static_exchange)
    rcfg = RB.BFSConfig(**kw, edge_chunk=ec, comm=RC.CommConfig(nn=nn))
    tcfg = TB.BFSConfig(**kw, edge_chunk=ec, comm=TC.CommConfig(nn=nn))
    mono = TB.BFSConfig(**kw, comm=TC.CommConfig(nn=nn))
    rpgv = RB.device_view(rpg)
    rs = RB.init_state(rpg, src, rcfg)
    ts = TB.init_state(pg, src, tcfg, device="cpu")
    ms = TB.init_state(pg, src, mono, device="cpu")
    tplan = plan if static_exchange else None
    if static_exchange:
        step = jax.jit(lambda s: jax.vmap(
            lambda pv, pl, st: RB.bfs_step(pv, st, rcfg, "p", plan=pl),
            axis_name="p")(rpgv, rplan, s))
    else:
        step = jax.jit(lambda s: jax.vmap(
            lambda pv, st: RB.bfs_step(pv, st, rcfg, "p"),
            axis_name="p")(rpgv, s))
    sweep = 0
    while not bool(np.all(np.asarray(rs.done))) and sweep < 40:
        rs = step(rs)
        ts = TB.bfs_step(pgv, ts, tcfg, tplan)
        ms = TB.bfs_step(pgv, ms, mono, tplan)
        sweep += 1
        got = convert.bfs_state_to_numpy(ts)
        leaves_equal(ref_leaves(rs, convert.BFS_STATE_LEAVES), got,
                     f"sweep {sweep}")
        leaves_equal(convert.bfs_state_to_numpy(ms), got, f"mono {sweep}")
    assert sweep >= 3
    np.testing.assert_array_equal(TB.gather_levels(pg, ts),
                                  bfs_levels(GRAPH, src))


def test_bench_scaling_chunked_cell():
    """``BENCH_scaling.json`` ``chunked``: scale 12 (seed 3), p = (2, 2),
    32 queries, ``edge_chunk`` 4096, ``nn`` compressed, as
    ``benchmarks/msbfs_throughput.py::run_chunked`` builds it: every
    committed counter exactly, every leaf equal to the monolithic run,
    answers oracle-exact."""
    sec = json.loads((ROOT / "BENCH_scaling.json").read_text())[
        "benchmarks"]["chunked"]
    gr = sec["graph"]
    from repro_torch.graphs.rmat import pick_sources as port_pick
    from repro_torch.graphs.rmat import rmat_graph as port_rmat
    g = port_rmat(gr["scale"], seed=gr["seed"])
    pg = TP.partition_graph(g, th=64, p_rank=gr["p_rank"], p_gpu=gr["p_gpu"])
    plan = TE.device_plan(TE.build_exchange_plan(pg), "cpu")
    pgv = TB.device_view(pg, "cpu")
    sources = port_pick(g, sec["n_queries"], seed=1)
    outs = {}
    for ec in (0, sec["edge_chunk"]):
        cfg = TM.MSBFSConfig(n_queries=sec["n_queries"], max_iters=48,
                             enable_do=True, edge_chunk=ec,
                             comm=TC.CommConfig(nn=sec["nn"]))
        outs[ec] = TM.run_msbfs_emulated(
            pgv, plan, TM.init_multi_state(pg, sources, cfg, device="cpu"),
            cfg)
    st = outs[sec["edge_chunk"]]
    leaves_equal(convert.state_to_numpy(outs[0]), convert.state_to_numpy(st))
    got = {"sweeps": int(st.it.max()),
           "work_fwd": int(st.work_fwd.sum()),
           "work_bwd": int(st.work_bwd.sum()),
           "nn_sent": int(st.nn_sent.sum()),
           "wire_delegate_bytes": int(st.wire_delegate.sum()),
           "wire_nn_bytes": int(st.wire_nn.sum()),
           "nn_overflow": int(st.nn_overflow.sum())}
    assert got == {k: sec[k] for k in got}
    assert got == {"sweeps": 5, "nn_sent": 218276,
                   "wire_delegate_bytes": 72480, "wire_nn_bytes": 45947,
                   "work_fwd": 499279, "work_bwd": 162589, "nn_overflow": 0}
    levels = TM.gather_levels_multi(pg, st)
    for q in (0, 13, 31):
        np.testing.assert_array_equal(levels[q], bfs_levels(g, int(sources[q])))


# --------------------------------------------------------------- engine
@pytest.mark.parametrize("mode", ["batch", "refill", "overlap"])
def test_engine_edge_chunk_equals_reference(parts, mode):
    """``BFSServeEngine(edge_chunk=)`` under the compressed nn format:
    answers and every ``ServeStats`` field equal the reference engine's
    with the same keyword, and the engine without it."""
    rpg, _, pg, _, _ = parts
    srcs = [int(s) for s in pick_sources(GRAPH, 8, seed=7)]
    kinds = [(QueryKind.LEVELS, None, None), (QueryKind.REACHABILITY, None,
                                              None),
             (QueryKind.DISTANCE_LIMITED, 2, None),
             (QueryKind.MULTI_TARGET, None, (srcs[0], srcs[1]))]
    qs = [Query(s, k, max_depth=d, targets=t)
          for s, (k, d, t) in zip(srcs, kinds * 2)]
    kw = {"batch": {}, "refill": dict(refill=True),
          "overlap": dict(refill=True, overlap=True, sweep_block=3)}[mode]
    comm = dict(nn="compressed")
    ref = RefEngine(pg=rpg, cfg=RM.MSBFSConfig(n_queries=4, max_iters=40),
                    comm=RC.CommConfig(**comm), cache_capacity=0,
                    edge_chunk=64, **kw)
    assert ref.cfg.edge_chunk == 64
    want = ref.submit_many([RQ(q.source, RK(q.kind.value),
                               max_depth=q.max_depth, targets=q.targets)
                            for q in qs])
    stats = {}
    for ec in (64, 0):
        eng = BFSServeEngine(pg=pg, cfg=TM.MSBFSConfig(n_queries=4,
                                                       max_iters=40),
                             comm=TC.CommConfig(**comm), cache_capacity=0,
                             edge_chunk=ec, device="cpu", **kw)
        assert eng.cfg.edge_chunk == ec
        got = eng.submit_many(qs)
        for a, b in zip(got, want):
            if isinstance(b, dict):
                assert a == b
            else:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        stats[ec] = eng.stats.as_dict()
    assert stats[64] == stats[0] == ref.stats.as_dict()
    assert stats[64]["wire_nn_bytes"] > 0
