"""The port's comm layer against the reference's under ``vmap(axis_name=
"p")``: the same stacked inputs give the same words and the same byte
counts. Lane words are int32 bit patterns in the port and uint32 in the
reference; they compare through ``.view(np.uint32)``. Exact equality
throughout (every quantity is an integer)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("kw", [dict(delegate="ring"), dict(delegate="hier"),
                                dict(nn="sparse"), dict(nn="adaptive"),
                                dict(nn="compressed")])
def test_unported_strategies_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TC.CommConfig(**kw)


def test_unknown_strategy_is_a_value_error():
    with pytest.raises(ValueError):
        TC.CommConfig(delegate="bogus")
    with pytest.raises(ValueError):
        TC.CommConfig(nn="bogus")
