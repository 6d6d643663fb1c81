"""The port's comm layer against the reference's under ``vmap(axis_name=
"p")``: the same stacked inputs give the same words and the same byte
counts. Lane words are int32 bit patterns in the port and uint32 in the
reference; they compare through ``.view(np.uint32)``. Exact equality
throughout (every quantity is an integer)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import comm as RC, engine as RE
from repro.core.partition import partition_graph
from repro.graphs.rmat import rmat_graph
from repro_torch.core import comm as TC


def u32(t):
    return t.cpu().numpy().view(np.uint32)


# ---------------------------------------------------------------- wire
@pytest.mark.parametrize("w", [1, 31, 32, 33, 64, 96])
def test_pack_unpack_roundtrip_matches_reference(w):
    rng = np.random.default_rng(w)
    lanes = rng.random((5, 7, w)) < 0.4
    lanes[..., min(w, 32) - 1] = True            # lane 31: the sign bit
    words = TC.pack_lanes(torch.from_numpy(lanes))
    assert words.dtype == torch.int32 and words.shape == (5, 7, -(-w // 32))
    np.testing.assert_array_equal(
        u32(words), np.asarray(RC.pack_lanes(jnp.asarray(lanes))))
    np.testing.assert_array_equal(TC.unpack_lanes(words, w).numpy(), lanes)


def test_unpack_sign_bit_word():
    words = torch.tensor([[-2**31], [-1]], dtype=torch.int32)
    bits = TC.unpack_lanes(words, 32).numpy()
    assert bits[0].tolist() == [False] * 31 + [True]
    assert bits[1].all()


# ------------------------------------------------------ delegate combine
@pytest.mark.parametrize("delegate", ["auto", "allgather"])
@pytest.mark.parametrize("p,rows,nw", [(2, 9, 1), (4, 9, 2), (3, 1, 3)])
def test_delegate_or_combine_matches_reference_vmap(delegate, p, rows, nw):
    rng = np.random.default_rng(p * 10 + rows)
    words = rng.integers(0, 2**32, (p, rows, nw), dtype=np.uint64).astype(np.uint32)
    words[0, 0, 0] |= np.uint32(1 << 31)
    seen = {}

    def ref(x):
        out, seen["bytes"] = RC.delegate_combine(
            RC.plan_for(RC.CommConfig(delegate=delegate), "p"), x, "or")
        return out

    want = np.asarray(jax.vmap(ref, axis_name="p")(jnp.asarray(words)))
    got, nbytes = TC.delegate_combine(
        TC.plan_for(TC.CommConfig(delegate=delegate), p),
        torch.from_numpy(words.view(np.int32)), "or")
    np.testing.assert_array_equal(u32(got), want)
    assert nbytes == seen["bytes"]


@pytest.mark.parametrize("delegate", ["auto", "allgather"])
@pytest.mark.parametrize("p,d", [(1, 7), (2, 9), (4, 33)])
def test_delegate_min_max_combine_matches_reference_vmap(delegate, p, d):
    """The single-source path's two level combines: int32 ``"min"`` over
    candidate levels (identity 2**30 where nothing was found) and uint8
    ``"max"`` over {0, 1} visited bytes -- values and byte counts."""
    rng = np.random.default_rng(p * 100 + d)
    levels = np.where(rng.random((p, d)) < 0.4,
                      rng.integers(1, 9, (p, d)), 2**30).astype(np.int32)
    bits = (rng.random((p, d)) < 0.3).astype(np.uint8)
    for op, x in (("min", levels), ("max", bits)):
        seen = {}

        def ref(v):
            out, seen["bytes"] = RC.delegate_combine(
                RC.plan_for(RC.CommConfig(delegate=delegate), "p"), v, op)
            return out

        want = np.asarray(jax.vmap(ref, axis_name="p")(jnp.asarray(x)))
        got, nbytes = TC.delegate_combine(
            TC.plan_for(TC.CommConfig(delegate=delegate), p),
            torch.from_numpy(x), op)
        assert got.dtype == torch.from_numpy(x).dtype
        np.testing.assert_array_equal(got.numpy(), want)
        assert nbytes == seen["bytes"], (op, nbytes, seen["bytes"])


def test_any_reduce_matches_reference_vmap():
    for flags in ([False, False, True, False], [False] * 3, [True]):
        f = np.array(flags)
        want = np.asarray(jax.vmap(lambda v: RC.any_reduce(v, "p"),
                                   axis_name="p")(jnp.asarray(f)))
        np.testing.assert_array_equal(
            TC.any_reduce(torch.from_numpy(f)).numpy(), want)


def test_lane_any_reduce_matches_reference_vmap():
    rng = np.random.default_rng(5)
    flags = rng.random((4, 2, 32)) < 0.1
    want = np.asarray(jax.vmap(lambda f: RC.lane_any_reduce(f, "p"),
                               axis_name="p")(jnp.asarray(flags)))
    got = TC.lane_any_reduce(torch.from_numpy(flags))
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------- dense nn exchange
@pytest.mark.parametrize("p_rank,p_gpu", [(1, 2), (2, 2)])
def test_dense_nn_exchange_matches_reference_vmap(p_rank, p_gpu):
    """Real receive tables of a scale-9 plan, random sender slot words."""
    pg = partition_graph(rmat_graph(9, seed=3), th=32, p_rank=p_rank,
                         p_gpu=p_gpu)
    plan = RE.build_exchange_plan(pg)
    p, cap, w = pg.p, plan.cap_peer, 32
    rng = np.random.default_rng(p)
    dense = rng.random((p, p, cap, w)) < 0.05
    recv_local = np.asarray(plan.recv_local)
    cfg = RC.CommConfig(nn="dense")
    want = jax.vmap(
        lambda d, r: RC.nn_exchange_words(RC.plan_for(cfg, "p"), d, r,
                                          pg.n_local),
        axis_name="p")(jnp.asarray(dense), jnp.asarray(recv_local))
    got = TC.nn_exchange_words(TC.plan_for(TC.CommConfig(nn="dense"), p),
                               torch.from_numpy(dense),
                               torch.from_numpy(recv_local), pg.n_local)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[0].any()
    for k in range(p):        # bytes, sparse flag, overflow per partition
        assert (got[1], got[2], got[3]) == tuple(int(np.asarray(x)[k])
                                                 for x in want[1:])


# ------------------------------------------- legacy binned nn exchange
@pytest.mark.parametrize("uniquify", [False, True])
@pytest.mark.parametrize("cap", [None, 4])
def test_bin_by_owner_and_exchange_match_reference_vmap(uniquify, cap):
    """Real owner / local tables of a scale-9 p=4 partition with a random
    active edge set: bins, overflow and sent counts equal the reference's
    sort-and-scatter (``cap=4`` overflows), and the all_to_all of the bins
    equals ``lax.all_to_all``."""
    pg = partition_graph(rmat_graph(9, seed=3), th=32, p_rank=2, p_gpu=2)
    p, e = pg.p, pg.nn.e_max
    cap = cap or e
    owner, local = np.asarray(pg.nn_owner), np.asarray(pg.nn.cols)
    rng = np.random.default_rng(cap + uniquify)
    active = rng.random((p, e)) < 0.4
    active &= np.arange(e)[None, :] < np.asarray(pg.nn.m)[:, None]
    want = jax.vmap(lambda o, l, a: RC.bin_by_owner(
        o, l, a, p=p, cap=cap, uniquify=uniquify), axis_name="p")(
        jnp.asarray(owner), jnp.asarray(local), jnp.asarray(active))
    got = TC.bin_by_owner(torch.from_numpy(owner), torch.from_numpy(local),
                          torch.from_numpy(active), p=p, cap=cap,
                          uniquify=uniquify)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[2].sum()) > 0
    assert (int(got[1].sum()) > 0) == (cap == 4)
    recv = jax.vmap(lambda b: RC.exchange_normal(b, "p"),
                    axis_name="p")(want[0])
    np.testing.assert_array_equal(TC.exchange_normal(got[0]).numpy(),
                                  np.asarray(recv))


@pytest.mark.parametrize("p_rank,p_gpu", [(1, 2), (2, 2)])
def test_dense_nn_exchange_bits_matches_reference_vmap(p_rank, p_gpu):
    """The single-source slot bitmask exchange: real receive tables of a
    scale-9 plan, random sender slot occupancy."""
    pg = partition_graph(rmat_graph(9, seed=3), th=32, p_rank=p_rank,
                         p_gpu=p_gpu)
    plan = RE.build_exchange_plan(pg)
    p, cap = pg.p, plan.cap_peer
    rng = np.random.default_rng(p + 7)
    active = rng.random((p, p, cap)) < 0.2
    recv_local = np.asarray(plan.recv_local)
    cfg = RC.CommConfig(nn="dense")
    want = jax.vmap(
        lambda a, r: RC.nn_exchange_bits(RC.plan_for(cfg, "p"), a, r,
                                         pg.n_local),
        axis_name="p")(jnp.asarray(active), jnp.asarray(recv_local))
    got = TC.nn_exchange_bits(TC.plan_for(TC.CommConfig(nn="dense"), p),
                              torch.from_numpy(active),
                              torch.from_numpy(recv_local), pg.n_local)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[0].any()
    for k in range(p):        # bytes, sparse flag, overflow per partition
        assert (got[1], got[2], got[3]) == tuple(int(np.asarray(x)[k])
                                                 for x in want[1:])


# ------------------------------------------------------------ byte formulas
@pytest.mark.parametrize("p", [1, 2, 4, 7])
def test_byte_formulas_match_reference(p):
    ref = RC.CommPlan(cfg=RC.CommConfig(), axes=("p",), sizes=(p,))
    port = TC.plan_for(TC.CommConfig(), p)
    for n_elems in (1, 31, 60561):
        for op in ("or", "min", "sum"):
            assert port.delegate_bytes(n_elems, 4, op) == \
                ref.delegate_bytes(n_elems, 4, op)
    for cap in (32, 96, 235040):
        for nw in (1, 2):
            assert port.nn_dense_words_bytes(cap, nw) == ref.nn_dense_words_bytes(cap, nw)
            assert port.nn_sparse_words_bytes(cap // 4, nw) == \
                ref.nn_sparse_words_bytes(cap // 4, nw)
        assert port.sparse_cap_words(cap) == ref.sparse_cap_words(cap)
        assert port.sparse_cap_bits(cap) == ref.sparse_cap_bits(cap)
        assert port.nn_dense_bits_bytes(cap) == ref.nn_dense_bits_bytes(cap)
        assert port.nn_dense_payload_bytes(cap, 32) == ref.nn_dense_payload_bytes(cap, 32)
        assert port.nn_compressed_words_max_bytes(cap, 1) == \
            ref.nn_compressed_words_max_bytes(cap, 1)
        assert port.a2a_bytes(cap) == ref.a2a_bytes(cap)


@pytest.mark.parametrize("what", ["compressed", "sum"])
def test_unported_strategies_raise(what):
    """Both strategies that were once deferred are served: the compressed
    nn codec configures as the reference's does (an unknown format is a
    ValueError); the ``"sum"`` combine is an int32 sum that wraps as the
    reference's ``psum`` does, with the reference's bytes (an unknown op
    is a ValueError)."""
    if what == "compressed":
        assert TC.NN_FORMATS == RC.NN_FORMATS
        assert TC.CommConfig(nn="compressed").nn == \
            RC.CommConfig(nn="compressed").nn == "compressed"
        with pytest.raises(ValueError):
            TC.CommConfig(nn="zstd")
        return
    x = np.array([[2**31 - 1, 5, -3, 7], [1, -9, 2**31 - 1, 0]], np.int32)
    seen = {}

    def ref(v):
        out, seen["bytes"] = RC.delegate_combine(
            RC.plan_for(RC.CommConfig(), "p"), v, "sum")
        return out

    want = np.asarray(jax.vmap(ref, axis_name="p")(jnp.asarray(x)))
    got, nbytes = TC.delegate_combine(TC.plan_for(TC.CommConfig(), 2),
                                      torch.from_numpy(x), "sum")
    np.testing.assert_array_equal(got.numpy(), want)
    assert nbytes == seen["bytes"] and got.dtype == torch.int32
    with pytest.raises(ValueError, match="unknown combine op"):
        TC.delegate_combine(TC.plan_for(TC.CommConfig(), 2),
                            torch.from_numpy(x), "xor")


def test_unknown_strategy_is_a_value_error():
    with pytest.raises(ValueError):
        TC.CommConfig(delegate="bogus")
    with pytest.raises(ValueError):
        TC.CommConfig(nn="bogus")


# ------------------------------------------- the seed-era entry points (A14)
#: one emulated axis "p", and two: the reference's nested vmap over
#: ("outer", "inner"), the port's rows stacked row-major over both
AXES = {"one axis": {"p": 4}, "two axes": {"outer": 2, "inner": 2}}


def ref_vmap(fn, x, axes: dict):
    """``fn`` of each partition's slice of ``x [p, ...]`` under the
    reference's vmap over ``axes`` (nested for two axes)."""
    names = tuple(axes)
    if len(names) == 1:
        return np.asarray(jax.vmap(lambda v: fn(v, names[0]),
                                   axis_name=names[0])(jnp.asarray(x)))
    sizes = tuple(axes.values())
    inner = jax.vmap(lambda v: fn(v, names), axis_name=names[1])
    out = jax.vmap(inner, axis_name=names[0])(
        jnp.asarray(x).reshape(sizes + x.shape[1:]))
    return np.asarray(out).reshape((-1,) + np.asarray(out).shape[2:])


@pytest.mark.parametrize("axes", list(AXES), ids=list(AXES))
def test_delegate_allreduce_or_is_bitwise_or(axes):
    """Twin of ``tests/test_msbfs.py::test_delegate_allreduce_or_is_bitwise_or``."""
    axes = AXES[axes]
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, (4, 9, 2), dtype=np.uint32)
    want = np.bitwise_or.reduce(words, axis=0)
    ref = ref_vmap(lambda v, a: RC.delegate_allreduce_or(v, a), words, axes)
    got = u32(TC.delegate_allreduce_or(torch.from_numpy(words.view(np.int32)),
                                       axes))
    for k in range(4):          # replicated result on every partition
        np.testing.assert_array_equal(got[k], want)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("axes", list(AXES), ids=list(AXES))
def test_exchange_words_transposes_peer_blocks(axes):
    """Twin of ``tests/test_msbfs.py::test_exchange_words_transposes_peer_blocks``."""
    axes = AXES[axes]
    p, cap, nw = 4, 2, 1
    words = np.arange(p * p * cap * nw, dtype=np.uint32).reshape(p, p * cap, nw)
    want = words.reshape(p, p, cap, nw).transpose(1, 0, 2, 3).reshape(
        p, p * cap, nw)
    ref = ref_vmap(lambda v, a: RC.exchange_words(v, a), words, axes)
    got = u32(TC.exchange_words(torch.from_numpy(words.view(np.int32)), axes))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref)


DELEGATE_CFGS = [dict(delegate="allgather"), dict(delegate="ring"),
                 dict(delegate="hier"), dict(delegate="auto")]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("axes", list(AXES), ids=list(AXES))
def test_delegate_or_strategies_bit_exact(axes, seed):
    """Twin of ``tests/test_comm_strategies.py``'s
    ``test_delegate_or_strategies_bit_exact_vmap`` (one axis) and
    ``..._two_axis_emulated`` (two): every strategy's seed-era OR
    all-reduce equals numpy's OR and the reference's, every partition."""
    axes = AXES[axes]
    rng = np.random.default_rng(seed)
    rows, nw = int(rng.integers(1, 10)), int(rng.integers(1, 4))
    words = rng.integers(0, 2**32, (4, rows, nw), dtype=np.uint32)
    want = np.bitwise_or.reduce(words, axis=0)
    for cfg in DELEGATE_CFGS:
        ref = ref_vmap(lambda v, a: RC.delegate_allreduce_or(
            v, a, RC.CommConfig(**cfg)), words, axes)
        got = u32(TC.delegate_allreduce_or(
            torch.from_numpy(words.view(np.int32)), axes, TC.CommConfig(**cfg)))
        for k in range(4):
            np.testing.assert_array_equal(got[k], want, err_msg=str(cfg))
        np.testing.assert_array_equal(got, ref, err_msg=str(cfg))


@pytest.mark.parametrize("axes", list(AXES), ids=list(AXES))
def test_delegate_allreduce_min_matches_reference(axes):
    """The level-candidate min under every strategy (the default: the
    native min), int32 with the 2**30 identity, against numpy's min and
    the reference's ``delegate_allreduce_min``."""
    axes = AXES[axes]
    rng = np.random.default_rng(3)
    cand = np.where(rng.random((4, 33)) < 0.4, rng.integers(1, 9, (4, 33)),
                    2**30).astype(np.int32)
    for cfg in [None] + DELEGATE_CFGS:
        rcfg = None if cfg is None else RC.CommConfig(**cfg)
        tcfg = None if cfg is None else TC.CommConfig(**cfg)
        ref = ref_vmap(lambda v, a: RC.delegate_allreduce_min(v, a, rcfg),
                       cand, axes)
        got = TC.delegate_allreduce_min(torch.from_numpy(cand), axes,
                                        tcfg).numpy()
        np.testing.assert_array_equal(got, np.broadcast_to(cand.min(0),
                                                           cand.shape))
        np.testing.assert_array_equal(got, ref, err_msg=str(cfg))


@pytest.mark.parametrize("axes", list(AXES), ids=list(AXES))
def test_codec_names_at_package_level_match_reference(axes):
    """The codec's names re-exported by ``comm`` (as the reference's
    ``core/comm/__init__.py`` does): host encoders byte for byte, the
    stream byte counts, and the compressed wire bytes on one and two
    emulated axes."""
    axes = AXES[axes]
    rng = np.random.default_rng(7)
    mask = rng.random(300) < 0.1
    ids = np.flatnonzero(mask)
    for name in ("rle_encode", "delta_encode_ids"):
        arg = mask if name == "rle_encode" else ids
        np.testing.assert_array_equal(getattr(TC, name)(arg),
                                      np.asarray(getattr(RC, name)(arg)))
    np.testing.assert_array_equal(
        TC.rle_decode(TC.rle_encode(mask), mask.size), mask)
    np.testing.assert_array_equal(
        TC.delta_decode_ids(TC.delta_encode_ids(ids)), ids)
    act = rng.random((4, 4, 97)) < rng.random((4, 4, 1)) * 0.6
    for name in ("rle_stream_bytes", "delta_stream_bytes"):
        np.testing.assert_array_equal(
            getattr(TC, name)(torch.from_numpy(act[0])).numpy(),
            np.asarray(getattr(RC, name)(jnp.asarray(act[0]))))
    ref = [ref_vmap(lambda a, names: RC.compressed_wire_bytes(
        RC.plan_for(RC.CommConfig(nn="compressed"), names), a, 1)[k],
        act, axes) for k in (0, 1)]
    got = TC.compressed_wire_bytes(
        TC.plan_for(TC.CommConfig(nn="compressed"), axes),
        torch.from_numpy(act), 1)
    for g, w in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), w)


def test_comm_exports_cover_the_reference():
    """The port's ``comm.__all__`` covers the reference's, less the
    JAX-only axis helpers; each name resolves."""
    jax_only = {"AxisNames", "as_axes", "axis_size"}
    missing = set(RC.__all__) - jax_only - set(TC.__all__)
    assert not missing, missing
    for name in TC.__all__:
        assert getattr(TC, name) is not None, name


def test_plan_for_binds_emulated_axes():
    plan = TC.plan_for(TC.CommConfig(delegate="hier"), {"outer": 2, "inner": 3})
    assert (plan.axes, plan.sizes, plan.p, plan.mesh) == (
        ("outer", "inner"), (2, 3), 6, None)
    ref = RC.CommPlan(RC.CommConfig(delegate="hier"), ("outer", "inner"),
                      (2, 3))
    for op in ("or", "min", "sum"):
        assert plan.delegate_bytes(50, 4, op) == ref.delegate_bytes(50, 4, op)
