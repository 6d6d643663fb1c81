"""The port's kernels against the reference package's Pallas kernels.

On the CPU the port's wrappers take the kernels' plain PyTorch versions;
they must equal the Pallas kernels (run in interpret mode, as
tests/test_kernels.py runs them) and the reference's own chunked pull
exactly -- every compared quantity is an integer (the CUDA kernels are
held against the plain versions on the card by tests/test_torch_cuda.py).
Lane words are int32 bit patterns in the port and
uint32 in the reference; they compare through ``.view(np.uint32)``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bfs as RB, msbfs as RM
from repro.core.partition import partition_graph
from repro.core.types import CSR as RCSR
from repro.graphs.rmat import rmat_graph
from repro.kernels import ref as rref
from repro.kernels.ell_pull import ell_pull as pallas_ell_pull
from repro.kernels.ell_pull_multi import ell_pull_multi as pallas_ell_pull_multi
from repro.kernels.mask_reduce import mask_reduce as pallas_mask_reduce
from repro.kernels.mask_reduce import payload_min_fold as pallas_min_fold
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
                           "payload_min_fold"}
    z = torch.zeros((2, 3), dtype=torch.int32)
    ops.payload_min_fold(z, z[0])
    ops.ell_pull(z, z[0, :1], z[:, 0])
    ops.ell_pull_bits(torch.zeros((1, 3), dtype=torch.int32), z[:1],
                      z[:1, :1], z[:1, :2], 4)
    assert ops.LAUNCHES == before
