"""The port's kernels against the reference package's Pallas kernels.

On the CPU the port's wrappers take the kernels' plain PyTorch versions;
they must equal the Pallas kernels (run in interpret mode, as
tests/test_kernels.py runs them) and the reference's own chunked pull
exactly -- every compared quantity of the traversal kernels is an integer
(the CUDA kernels are held against the plain versions on the card by
tests/test_torch_cuda.py). Lane words are int32 bit patterns in the port
and uint32 in the reference; they compare through ``.view(np.uint32)``.

The float kernels (``cin_fused``, ``segment_bag``) compare within stated
tolerances: float32 sums taken in another order (XLA's against
PyTorch's), and for bfloat16 tables the reference's bfloat16 arithmetic
against the port's float32 sums rounded once.
"""
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import bfs as RB, msbfs as RM
from repro.core.partition import partition_graph
from repro.core.types import CSR as RCSR
from repro.graphs.rmat import rmat_graph
from _hypo import given, settings, st
from repro.kernels import ref as rref
from repro.kernels.cin_fused import cin_fused as pallas_cin_fused
from repro.kernels.ell_pull import ell_pull as pallas_ell_pull
from repro.kernels.ell_pull_multi import ell_pull_multi as pallas_ell_pull_multi
from repro.kernels.ell_pull_payload import (
    ell_pull_payload as pallas_ell_pull_payload)
from repro.kernels.mask_reduce import mask_reduce as pallas_mask_reduce
from repro.kernels.mask_reduce import payload_min_fold as pallas_min_fold
from repro.kernels.segment_bag import segment_bag as pallas_segment_bag
from repro_torch.core import comm as TC
from repro_torch.kernels import ops, ref as tref


def words(rng, shape):
    """Random 32-bit words (bit 31 included) as the reference's uint32."""
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def t32(a):
    """uint32 words -> the port's int32 bit patterns (same bytes)."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def u32(t):
    return t.cpu().numpy().view(np.uint32)


@pytest.fixture(scope="module")
def graph():
    return rmat_graph(10, seed=7)


# ------------------------------------------------------ ell_pull_multi (ELL)
ELL_SHAPES = [(7, 4, 40, 1), (256, 32, 500, 2), (33, 7, 100, 3), (1, 1, 32, 1)]


@pytest.mark.parametrize("r,k,n,nw", ELL_SHAPES)
def test_ell_pull_multi_plain_matches_pallas(r, k, n, nw):
    rng = np.random.default_rng(r * 100 + k)
    parents = rng.integers(-1, n, (r, k)).astype(np.int32)
    fw, aw = words(rng, (n, nw)), words(rng, (r, nw))
    want = np.asarray(pallas_ell_pull_multi(
        jnp.asarray(parents), jnp.asarray(fw), jnp.asarray(aw), interpret=True))
    np.testing.assert_array_equal(
        want, np.asarray(rref.ell_pull_multi_ref(
            jnp.asarray(parents), jnp.asarray(fw), jnp.asarray(aw))))
    tp = torch.from_numpy(parents)
    np.testing.assert_array_equal(
        u32(ops.ell_pull_multi(tp, t32(fw), t32(aw))), want)
    np.testing.assert_array_equal(
        u32(tref.ell_pull_multi_ref(tp, t32(fw), t32(aw))), want)


# ------------------------------------------------------------ ell_pull (ELL)
@pytest.mark.parametrize("r,w,n", [(7, 4, 40), (256, 32, 1000), (300, 7, 333),
                                   (1, 1, 32)])
def test_ell_pull_plain_matches_pallas(r, w, n):
    """The shapes of tests/test_kernels.py: Pallas (interpret) == the
    reference oracle == the port's wrapper == the port's oracle."""
    rng = np.random.default_rng(r * 1000 + w)
    parents = rng.integers(-1, n, (r, w)).astype(np.int32)
    flags = rng.random(n) < 0.3
    flags[-1] = True                       # bit 31 of some word, if n%32==0
    mask = rref.pack_bitmask(flags)
    active = rng.integers(0, 2, r).astype(np.int32)
    want = np.asarray(pallas_ell_pull(jnp.asarray(parents), jnp.asarray(mask),
                                      jnp.asarray(active), tile_rows=64,
                                      interpret=True))
    np.testing.assert_array_equal(want, np.asarray(rref.ell_pull_ref(
        jnp.asarray(parents), jnp.asarray(mask), jnp.asarray(active))))
    tmask = tref.pack_bitmask(torch.from_numpy(flags))
    np.testing.assert_array_equal(u32(tmask), mask)
    tp, ta = torch.from_numpy(parents), torch.from_numpy(active)
    got = ops.ell_pull(tp, tmask, ta)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tref.ell_pull_ref(tp, tmask, ta).numpy(),
                                  want)


# ------------------------------------------------ fused chunked pull (main)
def _one(csr, k):
    """Partition k of a stacked CSR as the reference's single CSR."""
    return RCSR(offsets=jnp.asarray(np.asarray(csr.offsets)[k]),
                cols=jnp.asarray(np.asarray(csr.cols)[k]),
                rowids=jnp.asarray(np.asarray(csr.rowids)[k]),
                m=jnp.asarray(np.asarray(csr.m)[k]), eidx=None,
                n_rows=csr.n_rows, e_max=csr.e_max)


def _ref_pull(csr, k, need, frontier, chunk):
    """The reference's _pull_chunked_multi on partition k of a stacked CSR."""
    found, work = RM._pull_chunked_multi(_one(csr, k), jnp.asarray(need),
                                         jnp.asarray(frontier), chunk)
    return np.asarray(found), int(work)


@pytest.mark.parametrize("pull,rows_of,cols_of", [
    ("dd", "d", "d"), ("dn", "d", "n"), ("nd", "n", "d")])
@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_bit_pull_plain_matches_bfs_pull(graph, pull, rows_of, cols_of,
                                         chunk):
    """found AND per-partition work of the main-path bit pull equal the
    reference's ``bfs._pull_chunked`` (the decision bfs_step makes) on the
    dd / dn / nd subgraphs of a p=4 partition."""
    pg = partition_graph(graph, th=32, p_rank=2, p_gpu=2)
    csr = pg.subgraph(pull)
    size = {"d": max(pg.d, 1), "n": pg.n_local}
    rng = np.random.default_rng(len(pull) * 11 + chunk)
    frontier = rng.random((pg.p, size[cols_of])) < 0.05
    active = rng.random((pg.p, size[rows_of])) < 0.6
    found, work = ops.ell_pull_bits(
        torch.from_numpy(np.asarray(csr.offsets)),
        torch.from_numpy(np.asarray(csr.cols)),
        TC.pack_lanes(torch.from_numpy(frontier)),
        torch.from_numpy(active.astype(np.int32)), chunk)
    assert found.dtype == work.dtype == torch.int32
    total = 0
    for k in range(pg.p):
        want_found, want_work = RB._pull_chunked(
            _one(csr, k), jnp.asarray(active[k]), jnp.asarray(frontier[k]),
            chunk)
        np.testing.assert_array_equal(found[k].numpy() > 0,
                                      np.asarray(want_found))
        assert int(work[k].sum()) == int(want_work)
        total += int(want_work)
    assert total > 0 and int(found.sum()) > 0


@pytest.mark.parametrize("pull,rows_of,cols_of", [
    ("dd", "d", "d"), ("dn", "d", "n"), ("nd", "n", "d")])
@pytest.mark.parametrize("chunk", [16, 32])
def test_chunked_pull_plain_matches_reference(graph, pull, rows_of, cols_of,
                                              chunk):
    """found words AND per-partition work equal the reference's chunked
    while-loop pull on the dd / dn / nd subgraphs of a p=4 partition."""
    pg = partition_graph(graph, th=32, p_rank=2, p_gpu=2)
    csr = pg.subgraph(pull)
    size = {"d": max(pg.d, 1), "n": pg.n_local}
    w = 32
    rng = np.random.default_rng(len(pull) * 7 + chunk)
    frontier = rng.random((pg.p, size[cols_of], w)) < 0.1
    need = (rng.random((pg.p, size[rows_of], w)) < 0.5)
    need[:, :, 31] |= rng.random((pg.p, size[rows_of])) < 0.5   # sign bit
    found_w, work = ops.ell_pull_chunked(
        torch.from_numpy(np.asarray(csr.offsets)),
        torch.from_numpy(np.asarray(csr.cols)),
        TC.pack_lanes(torch.from_numpy(frontier)),
        TC.pack_lanes(torch.from_numpy(need)), chunk)
    found = TC.unpack_lanes(found_w, w).numpy()
    total = 0
    for k in range(pg.p):
        want_found, want_work = _ref_pull(csr, k, need[k], frontier[k], chunk)
        np.testing.assert_array_equal(found[k], want_found)
        assert int(work[k].sum()) == want_work
        total += want_work
    assert total > 0                       # the pull did scan parents


# -------------------------------------------------------------- mask_reduce
@pytest.mark.parametrize("k,nw", [(1, 5), (4, 700), (8, 513)])
@pytest.mark.parametrize("with_count", [True, False])
def test_mask_reduce_plain_matches_pallas(k, nw, with_count):
    rng = np.random.default_rng(k * nw)
    parts, prev = words(rng, (k, nw)), words(rng, nw)
    parts[:, 0] |= np.uint32(1 << 31)      # bit 31 set somewhere
    want_or, want_cnt = pallas_mask_reduce(
        jnp.asarray(parts), jnp.asarray(prev), tile_words=256, interpret=True,
        with_count=with_count)
    got_or, got_cnt = ops.mask_reduce(t32(parts), t32(prev),
                                      with_count=with_count)
    np.testing.assert_array_equal(u32(got_or), np.asarray(want_or))
    if with_count:
        np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(want_cnt))
    else:
        assert got_cnt is None and want_cnt is None


# --------------------------------------------------------- payload_min_fold
@pytest.mark.parametrize("k,nw", [(1, 5), (4, 700), (8, 513)])
@pytest.mark.parametrize("with_count", [True, False])
def test_payload_min_fold_plain_matches_pallas(k, nw, with_count):
    rng = np.random.default_rng(k * nw + 1)
    ident = 2**30
    parts = rng.integers(-2**31, 2**31, (k, nw), dtype=np.int64).astype(np.int32)
    parts[rng.random((k, nw)) < 0.3] = ident
    prev = rng.integers(-100, 100, nw).astype(np.int32)
    prev[rng.random(nw) < 0.5] = ident
    want, want_imp = pallas_min_fold(jnp.asarray(parts), jnp.asarray(prev),
                                     tile_words=256, interpret=True,
                                     with_count=with_count)
    tparts, tprev = torch.from_numpy(parts), torch.from_numpy(prev)
    for got, got_imp in (ops.payload_min_fold(tparts, tprev,
                                              with_count=with_count),
                         tref.payload_min_fold_ref(tparts, tprev,
                                                   with_count=with_count)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if with_count:
            np.testing.assert_array_equal(got_imp.numpy(),
                                          np.asarray(want_imp))
        else:
            assert got_imp is None and want_imp is None


def test_cpu_tensors_never_count_launches():
    before = dict(ops.LAUNCHES)
    ops.mask_reduce(torch.zeros((2, 3), dtype=torch.int32),
                    torch.zeros(3, dtype=torch.int32))
    assert ops.LAUNCHES == before


def test_single_source_wrappers_never_count_launches_on_cpu():
    before = dict(ops.LAUNCHES)
    assert set(before) == {"ell_pull_multi", "mask_reduce", "ell_pull",
                           "payload_min_fold", "cin_fused", "segment_bag",
                           "ell_pull_payload"}
    z = torch.zeros((2, 3), dtype=torch.int32)
    ops.payload_min_fold(z, z[0])
    ops.ell_pull(z, z[0, :1], z[:, 0])
    ops.ell_pull_bits(torch.zeros((1, 3), dtype=torch.int32), z[:1],
                      z[:1, :1], z[:1, :2], 4)
    assert ops.LAUNCHES == before


def test_launch_helper_refuses_tensors_off_the_card():
    """The one-pass check every CUDA wrapper runs before its launch: a CPU
    tensor never reaches a kernel."""
    from repro_torch.kernels import _build
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        _build.require("payload_min_fold", torch.int32, ("partials", "prev"),
                       z[None], z)


# ---------------------------------------------------------------- cin_fused
def cin_inputs(rng, b, f0, fk, h, d):
    return (rng.normal(size=(b, f0, d)).astype(np.float32),
            rng.normal(size=(b, fk, d)).astype(np.float32),
            rng.normal(size=(h, f0 * fk)).astype(np.float32))


@pytest.mark.parametrize("b,f0,fk,h,d", [(4, 3, 3, 5, 8), (70, 39, 20, 200, 10),
                                         (1, 2, 7, 3, 16)])
def test_cin_fused_plain_matches_pallas(b, f0, fk, h, d):
    """The shapes of tests/test_kernels.py, with its tolerance (float32
    sums of up to F0*Fk = 780 products in another order)."""
    x0, xk, w = cin_inputs(np.random.default_rng(b), b, f0, fk, h, d)
    want = np.asarray(pallas_cin_fused(jnp.asarray(x0), jnp.asarray(xk),
                                       jnp.asarray(w), tile_b=32,
                                       interpret=True))
    tx0, txk, tw = map(torch.from_numpy, (x0, xk, w))
    for got in (ops.cin_fused(tx0, txk, tw), tref.cin_fused_ref(tx0, txk, tw)):
        assert got.dtype == torch.float32 and got.shape == (b, h, d)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@settings(max_examples=6, deadline=None)
@given(b=st.integers(1, 9), f0=st.integers(1, 6), fk=st.integers(1, 6),
       h=st.integers(1, 9), d=st.integers(1, 12), seed=st.integers(0, 99))
def test_cin_fused_plain_property(b, f0, fk, h, d, seed):
    x0, xk, w = cin_inputs(np.random.default_rng(seed), b, f0, fk, h, d)
    want = np.asarray(pallas_cin_fused(jnp.asarray(x0), jnp.asarray(xk),
                                       jnp.asarray(w), tile_b=4,
                                       interpret=True))
    got = ops.cin_fused(*map(torch.from_numpy, (x0, xk, w)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: float32 rounded to TF32's 10 mantissa bits,
    to nearest with ties away from zero, on the int32 bit pattern."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def cin_tf32(x0, xk, w, passes: int = 3):
    """The arithmetic of the CUDA ``cin_fused`` kernel in PyTorch: Z formed
    in float32 as x0 * xk, Z and W split into hi = rna(x) and lo = rna(x -
    hi), ``lo*hi + hi*lo + hi*hi`` summed in float32 (``passes=1``: hi*hi
    alone, single-pass TF32)."""
    b, f0, d = x0.shape
    z = torch.einsum("bid,bjd->bijd", x0, xk).reshape(b, -1, d)
    zh, wh = tf32_rna(z), tf32_rna(w)
    terms = [(wh, zh)]
    if passes == 3:
        terms = [(wh, tf32_rna(z - zh)), (tf32_rna(w - wh), zh)] + terms
    return sum(torch.einsum("hf,bfd->bhd", a, c) for a, c in terms)


def test_tf32_rna_rounds_to_nearest_ties_away():
    x = torch.tensor([1 + 2**-11, 1 + 3 * 2**-11, -(1 + 2**-11), 1 + 2**-12,
                      1 + 2**-10 + 2**-11, 3.0, -0.0], dtype=torch.float32)
    want = torch.tensor([1 + 2**-10, 1 + 2**-9, -(1 + 2**-10), 1.0,
                         1 + 2**-9, 3.0, -0.0], dtype=torch.float32)
    assert torch.equal(tf32_rna(x), want)
    hi = tf32_rna(x * 1.2345)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()


@pytest.mark.parametrize("b,f0,fk,h", [(3, 39, 39, 200), (2, 39, 200, 200)])
def test_cin_3xtf32_matches_pallas_at_full_widths(b, f0, fk, h):
    """The CUDA kernel's 3xTF32 arithmetic, emulated, against the reference
    Pallas kernel at the FULL layer widths (D = 10) within the card tests'
    tolerance, 1e-4 * max|reference|; single-pass TF32 misses it there."""
    x0, xk, w = cin_inputs(np.random.default_rng(b + fk), b, f0, fk, h, 10)
    want = np.asarray(pallas_cin_fused(jnp.asarray(x0), jnp.asarray(xk),
                                       jnp.asarray(w), tile_b=2,
                                       interpret=True))
    tx0, txk, tw = map(torch.from_numpy, (x0, xk, w))
    scale = float(np.abs(want).max())
    err3 = float(np.abs(cin_tf32(tx0, txk, tw).numpy() - want).max())
    err1 = float(np.abs(cin_tf32(tx0, txk, tw, passes=1).numpy()
                        - want).max())
    assert err3 <= 1e-4 * scale, (err3, scale)
    assert err3 <= 1e-5 * scale and err1 > 1e-4 * scale, (err3, err1, scale)


def test_cin_3xtf32_smoke_logits_match_reference():
    """xDeepFM SMOKE with the emulated kernel arithmetic in every CIN layer
    against the reference forward, at the SMOKE logits tolerance (rtol
    1e-5, atol 1e-6)."""
    import jax.numpy as jnp_
    from repro.configs import xdeepfm as RX
    from repro.models import recsys as R
    from repro_torch.configs import xdeepfm as TX
    from repro_torch.core import convert
    from repro_torch.models import recsys as TR
    from test_torch_recsys import make_batch, numpy_params

    params = numpy_params(RX.SMOKE, 1)
    tparams = convert.xdeepfm_params_from_numpy(params, TX.SMOKE, "cpu").params()
    hot, cold = make_batch(RX.SMOKE, 16, seed=3)
    want = R.xdeepfm_logits(RX.SMOKE, params, {"hot_idx": jnp_.asarray(hot),
                                               "cold_idx": jnp_.asarray(cold)})
    got = TR.xdeepfm_logits(TX.SMOKE, tparams, torch.from_numpy(hot),
                            torch.from_numpy(cold), cin_op=cin_tf32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# -------------------------------------------------------------- segment_bag
@pytest.mark.parametrize("b,l,v,d,dt", [
    (5, 3, 50, 8, "float32"), (130, 7, 200, 130, "float32"),
    (64, 1, 10, 16, "float32"), (3, 20, 1000, 10, "bfloat16")])
@pytest.mark.parametrize("weighted", [True, False])
def test_segment_bag_plain_matches_pallas(b, l, v, d, dt, weighted):
    """The shapes of tests/test_kernels.py. float32: rtol = atol = 1e-5 (sums
    of at most 7 products in another order). bfloat16: the reference
    multiplies and sums in bfloat16, the port sums in float32 and rounds
    once; they agree within the error of the reference's bfloat16
    arithmetic, (L + 1) * 2**-8 of the slot magnitudes summed, plus one
    bfloat16 rounding of the result."""
    rng = np.random.default_rng(b + l)
    jdt = jnp.bfloat16 if dt == "bfloat16" else jnp.float32
    table = jnp.asarray(rng.normal(size=(v, d)), jdt)
    idx = jnp.asarray(rng.integers(-1, v, (b, l)), jnp.int32)
    wgt = jnp.asarray(rng.normal(size=(b, l)), jdt) if weighted else None
    want = np.asarray(pallas_segment_bag(table, idx, wgt, tile_bags=32,
                                         tile_dim=64, interpret=True),
                      np.float32)
    ttable = torch.from_numpy(np.array(table, np.float32)).to(getattr(torch, dt))
    tidx = torch.from_numpy(np.array(idx))
    twgt = (None if wgt is None else
            torch.from_numpy(np.array(wgt, np.float32)).to(getattr(torch, dt)))
    for got in (ops.segment_bag(ttable, tidx, twgt),
                tref.segment_bag_ref(ttable, tidx, twgt)):
        assert got.dtype == getattr(torch, dt) and got.shape == (b, d)
        got = got.float().numpy()
        if dt == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            w_abs = np.abs(np.asarray(wgt, np.float32)) if weighted else 1.0
            valid = np.asarray(idx) >= 0
            mag = (np.abs(np.asarray(table, np.float32))[np.maximum(np.asarray(idx), 0)]
                   * (w_abs * valid)[..., None]).sum(1)
            tol = (l + 1) * 2.0**-8 * mag + 2.0**-8 * np.abs(want)
            assert (np.abs(got - want) <= tol).all()


@settings(max_examples=6, deadline=None)
@given(b=st.integers(1, 40), l=st.integers(0, 9), v=st.integers(2, 99),
       d=st.integers(1, 40), seed=st.integers(0, 99))
def test_segment_bag_plain_property(b, l, v, d, seed):
    """Random shapes, weights None (ones) and -1 padding; L = 0 gives
    zeros (the Pallas kernel takes L >= 1, so L = 0 is held against
    zeros)."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(v, d)).astype(np.float32)
    idx = rng.integers(-1, v, (b, l)).astype(np.int32)
    got = ops.segment_bag(torch.from_numpy(table), torch.from_numpy(idx))
    if l == 0:
        np.testing.assert_array_equal(got.numpy(), np.zeros((b, d), np.float32))
        return
    want = np.asarray(pallas_segment_bag(jnp.asarray(table), jnp.asarray(idx),
                                         None, tile_bags=16, tile_dim=16,
                                         interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------- ell_pull_payload
def payload_inputs(rng, r, k, n, w, ident=2**30):
    """The construction of tests/test_payload_kinds.py::
    test_payload_kernel_parity at any shape."""
    parents = rng.integers(-1, n, size=(r, k)).astype(np.int32)
    payload = rng.integers(0, 50, size=(n, w)).astype(np.int32)
    payload[rng.random((n, w)) < 0.3] = ident
    weights = rng.integers(1, 16, size=(r, k)).astype(np.int32)
    active = (rng.random((r, w)) < 0.7).astype(np.int32)
    return parents, payload, weights, active


def pallas_payload(parents, payload, weights, active, **kw):
    return np.asarray(pallas_ell_pull_payload(
        *map(jnp.asarray, (parents, payload, weights, active)),
        interpret=True, **kw))


@pytest.mark.parametrize("r,k,n,w", [(64, 5, 40, 8), (256, 32, 500, 32),
                                     (33, 36, 100, 40), (7, 1, 3, 1)])
def test_ell_pull_payload_plain_matches_pallas(r, k, n, w):
    """The shape of tests/test_payload_kinds.py (64, 5, 40, 8) and three
    more (W = 32, the warp width; K > 32 and W > 32; single column)."""
    args = payload_inputs(np.random.default_rng(5 + r), r, k, n, w)
    want = pallas_payload(*args)
    np.testing.assert_array_equal(
        want, np.asarray(rref.ell_pull_payload_ref(*map(jnp.asarray, args))))
    targs = tuple(map(torch.from_numpy, args))
    for got in (ops.ell_pull_payload(*targs), tref.ell_pull_payload_ref(*targs)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@settings(max_examples=6, deadline=None)
@given(r=st.integers(1, 60), k=st.integers(0, 12), n=st.integers(1, 50),
       w=st.integers(1, 40), seed=st.integers(0, 99))
def test_ell_pull_payload_plain_property(r, k, n, w, seed):
    """Random shapes with payloads over the whole int32 range, so payload +
    weight wraps as the reference's int32 add does; K = 0 gives the
    identity everywhere (as the reference's early return)."""
    rng = np.random.default_rng(seed)
    parents, payload, weights, active = payload_inputs(rng, r, k, n, w)
    payload[rng.random((n, w)) < 0.2] = 2**31 - 1
    payload[rng.random((n, w)) < 0.2] = -2**31
    want = pallas_payload(parents, payload, weights, active, tile_rows=16)
    got = ops.ell_pull_payload(*map(torch.from_numpy,
                                    (parents, payload, weights, active)))
    np.testing.assert_array_equal(got.numpy(), want)



def scattered_slots(rng, r, k, n):
    """[r, k] ids in [0, n) with -1 anywhere in a row (not left-packed):
    row 0 has every slot valid, row 1 none; about 40% of the other slots
    are -1."""
    ids = rng.integers(0, n, size=(r, k)).astype(np.int32)
    ids[rng.random((r, k)) < 0.4] = -1
    ids[0] = rng.integers(0, n, size=k)
    ids[1] = -1
    return ids


@pytest.mark.parametrize("kernel", ["ell_pull_payload", "segment_bag"])
@pytest.mark.parametrize("r,k,n,w", [(40, 9, 30, 8), (33, 64, 200, 32),
                                     (17, 3, 5, 10)])
def test_plain_versions_match_pallas_on_scattered_slots(kernel, r, k, n, w):
    """The inputs the card kernels' compaction and idle paths see: -1
    slots between valid ones, rows with every slot valid or none, and
    (ell_pull_payload) rows with no active lane (every third row) and
    payloads at the int32 edges -- exact; (segment_bag, table [n, w])
    bags of only -1 (every third bag) sum to 0, within the float32
    tolerance of test_segment_bag_plain_matches_pallas."""
    rng = np.random.default_rng(r * k + w)
    ids = scattered_slots(rng, r, k, n)
    if kernel == "ell_pull_payload":
        _, payload, weights, active = payload_inputs(rng, r, k, n, w)
        payload[rng.random((n, w)) < 0.1] = 2**31 - 1
        payload[rng.random((n, w)) < 0.1] = -2**31
        active[::3] = 0
        want = pallas_payload(ids, payload, weights, active, tile_rows=16)
        assert (want[::3] == 2**30).all()
        got = ops.ell_pull_payload(*map(torch.from_numpy,
                                        (ids, payload, weights, active)))
        np.testing.assert_array_equal(got.numpy(), want)
        return
    ids[::3] = -1
    table = rng.normal(size=(n, w)).astype(np.float32)
    wgt = rng.normal(size=(r, k)).astype(np.float32)
    want = np.asarray(pallas_segment_bag(jnp.asarray(table), jnp.asarray(ids),
                                         jnp.asarray(wgt), tile_bags=16,
                                         tile_dim=16, interpret=True))
    got = ops.segment_bag(*map(torch.from_numpy, (table, ids, wgt))).numpy()
    np.testing.assert_array_equal(got[::3], np.zeros((len(got[::3]), w)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

def test_recsys_wrappers_never_count_launches_on_cpu():
    before = dict(ops.LAUNCHES)
    z = torch.zeros((2, 3, 4))
    ops.cin_fused(z, z, torch.zeros((5, 9)))
    ops.segment_bag(torch.zeros((4, 2)), torch.zeros((2, 3), dtype=torch.int32))
    zi = torch.zeros((2, 3), dtype=torch.int32)
    ops.ell_pull_payload(zi, zi, zi, zi)
    assert ops.LAUNCHES == before


def test_recsys_wrappers_reject_mixed_devices_and_bad_shapes():
    z = torch.zeros((2, 3, 4))
    with pytest.raises(ValueError):
        ops.cin_fused(z, z.to("meta"), torch.zeros((5, 9)))
    with pytest.raises(ValueError):
        ops.cin_fused(z, z, torch.zeros((5, 8)))
    with pytest.raises(ValueError):
        ops.segment_bag(torch.zeros((4, 2)), torch.zeros((2, 3)))   # float ids
    with pytest.raises(ValueError):
        ops.segment_bag(torch.zeros((4, 2), dtype=torch.float16),
                        torch.zeros((2, 3), dtype=torch.int32))
    zi = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.ell_pull_payload(zi, zi, zi, torch.zeros((2, 4), dtype=torch.int32))
