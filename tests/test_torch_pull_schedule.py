"""The row schedule and the speculative evaluation of the port's two
early-exit pull kernels (``ell_pull``, ``ell_pull_multi``), on the CPU.

The CUDA kernels (``csrc/pull_rows.cuh``) read a row's parents ahead of
the reference's stop, several slots a lane and several rows a warp, and
derive ``work`` from the first covering slot. Here that evaluation is
emulated in numpy step by step, as the kernel groups slots, and held
against the plain versions (which walk the reference's chunk loop) and
against the reference's own chunked pulls; the schedule that assigns the
kernel's groups is checked on real partitions and on a synthetic CSR.
"""
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from _hypo import given, settings, st
from repro.core import bfs as RB, msbfs as RM
from repro.core.types import CSR as RCSR
from repro_torch.core import bfs as TB, comm as TC
from repro_torch.core.partition import partition_graph
from repro_torch.graphs.rmat import rmat_graph
from repro_torch.kernels import ops
from repro_torch.kernels import pull_schedule as PS
from repro_torch.kernels.ell_pull import ell_pull_bits_plain
from repro_torch.kernels.ell_pull_multi import ell_pull_chunked_plain

#: slots a step of each class's group (csrc/pull_rows.cuh: G lanes x U
#: loads; a short row is one lane's, 16 // nw loads a step)
STEP = {PS.MEDIUM: 32 * 4, PS.LONG: 256 * 8}


@pytest.fixture(scope="module")
def graph():
    return rmat_graph(10, seed=7)


def check_schedule(sched, offsets):
    """Every row in exactly one class, by its length; long rows first and
    longest first, the other classes in flat-id order."""
    offsets = np.asarray(offsets)
    lens = np.diff(offsets, axis=1).reshape(-1)
    order = sched.order.numpy()
    assert sched.order.dtype == torch.int32
    np.testing.assert_array_equal(np.sort(order), np.arange(lens.size))
    cls = np.where(lens == 0, PS.EMPTY, np.where(
        lens <= PS.SHORT_MAX, PS.SHORT,
        np.where(lens <= PS.MEDIUM_MAX, PS.MEDIUM, PS.LONG)))
    assert sched.counts == tuple(int((cls == c).sum()) for c in range(4))
    np.testing.assert_array_equal(cls[order], np.sort(cls[order]))
    n_long = sched.counts[PS.LONG]
    np.testing.assert_array_equal(sched.long_len.numpy(), lens[order[:n_long]])
    starts = offsets[:, :-1].reshape(-1)
    np.testing.assert_array_equal(sched.span.numpy(),
                                  np.stack([starts[order], lens[order]], 1))
    assert (np.diff(lens[order[:n_long]]) <= 0).all()
    at = n_long
    for c in (PS.MEDIUM, PS.SHORT, PS.EMPTY):
        part = order[at: at + sched.counts[c]]
        assert (np.diff(part) > 0).all() and (cls[part] == c).all()
        at += sched.counts[c]
    assert all(PS.row_class(int(n)) == int(k) for n, k in
               zip(lens[:50], cls[:50]))


@pytest.mark.parametrize("p_rank,p_gpu", [(1, 1), (2, 2)])
@pytest.mark.parametrize("kind", ["dd", "dn", "nd", "nn"])
def test_schedule_classes_on_rmat(graph, p_rank, p_gpu, kind):
    """rmat scale 10 at p = 1 and p = 4: the schedule of each subgraph's
    stacked offsets."""
    pg = partition_graph(graph, th=16, p_rank=p_rank, p_gpu=p_gpu)
    offsets = pg.subgraph(kind).offsets
    sched = PS.build_schedule(torch.from_numpy(np.asarray(offsets)))
    check_schedule(sched, offsets)
    assert sum(sched.counts) == pg.p * pg.subgraph(kind).n_rows


def test_cpu_device_view_builds_no_schedule(graph):
    """The plain pulls of the CPU take no schedule, so the CPU view builds
    none (a card's view builds one for dd, dn and nd)."""
    pgv = TB.device_view(partition_graph(graph, th=16, p_rank=2, p_gpu=2),
                         "cpu")
    assert all(getattr(pgv, k).sched is None for k in ("dd", "dn", "nd", "nn"))


SYNTH = [0, 1, PS.SHORT_MAX - 1, PS.SHORT_MAX, PS.SHORT_MAX + 1]


def synthetic_lengths(chunk):
    lim = PS.MEDIUM_MAX
    return SYNTH + [chunk - 1, chunk, chunk + 1, lim - 1, lim, lim + 1,
                    40 * lim, 0, 3]


def synthetic_csr(rng, p, lengths, n):
    """A stacked CSR ``[p, R+1]`` whose rows have ``lengths`` (shuffled per
    partition) over ``n`` columns."""
    r = len(lengths)
    deg = np.stack([rng.permutation(lengths) for _ in range(p)])
    offsets = np.zeros((p, r + 1), np.int32)
    offsets[:, 1:] = np.cumsum(deg, axis=1)
    cols = rng.integers(0, n, (p, max(int(offsets[:, -1].max()), 1)),
                        dtype=np.int64).astype(np.int32)
    return offsets, cols


@pytest.mark.parametrize("chunk", [32, 64])
def test_schedule_classes_on_synthetic_csr(chunk):
    rng = np.random.default_rng(chunk)
    lengths = synthetic_lengths(chunk)
    offsets, _ = synthetic_csr(rng, 2, lengths, 100)
    sched = PS.build_schedule(torch.from_numpy(offsets))
    check_schedule(sched, offsets)
    assert sched.counts[PS.LONG] == 2 * 2          # lim + 1 and 40 lim
    assert sched.long_len[:2].tolist() == [40 * PS.MEDIUM_MAX] * 2
    uni = PS.uniform_schedule(1, 5, chunk, "cpu")
    check_schedule(uni, np.arange(6, dtype=np.int32)[None] * chunk)


def test_long_items_merge_longest_first():
    """One launch's long work list: every long row of every subgraph once,
    longest first across them, as ``position * 4 + graph``."""
    rng = np.random.default_rng(3)
    csrs = []
    for g in range(3):
        lengths = list(rng.integers(PS.MEDIUM_MAX - 50, 4 * PS.MEDIUM_MAX, 9))
        offsets, _ = synthetic_csr(rng, 2, lengths + SYNTH, 10)
        csrs.append(torch.from_numpy(offsets))
    scheds = [PS.build_schedule(o) for o in csrs]
    items = PS.long_items(scheds).numpy()
    lens = []
    for it in items:
        offsets, sched = csrs[it & 3], scheds[it & 3]
        k, r = divmod(int(sched.order[it >> 2]), offsets.shape[1] - 1)
        lens.append(int(offsets[k, r + 1] - offsets[k, r]))
        start, n = sched.span[it >> 2].tolist()
        assert (start, n) == (int(offsets[k, r]), lens[-1])
    assert len(items) == sum(s.counts[PS.LONG] for s in scheds) > 3
    assert len(set(items.tolist())) == len(items)
    assert {int(i) & 3 for i in items} == {0, 1, 2}
    assert all(n > PS.MEDIUM_MAX for n in lens) and lens == sorted(lens)[::-1]
    solo = PS.long_items(scheds[1:2]).numpy()
    np.testing.assert_array_equal(solo,
                                  np.arange(scheds[1].counts[PS.LONG]) * 4)


# -------------------------------------------- speculative evaluation, emulated
def speculative_pull(offsets, cols, words, need, chunk):
    """The kernels' evaluation in numpy: per row, the step structure of its
    class (G lanes x U loads a step, a coverage test per step, the first
    covering slot searched in the covering step), and beside it the
    per-chunk form (one OR word per chunk, a prefix OR, the first covering
    chunk c*). Both give found = OR(row) & need and work = the slots of
    chunks 0..c*; they must agree. ``words [p, N, nw]`` uint32 per column,
    ``need [p, R, nw]`` uint32."""
    p, r1 = offsets.shape
    nw = words.shape[2]
    found = np.zeros((p, r1 - 1, nw), np.uint32)
    work = np.zeros((p, r1 - 1), np.int32)
    for k in range(p):
        for r in range(r1 - 1):
            s, e = int(offsets[k, r]), int(offsets[k, r + 1])
            nd = need[k, r]
            if e == s or not nd.any():
                continue
            c = cols[k, s:e]
            w = np.where((c >= 0)[:, None], words[k, np.maximum(c, 0)], 0)
            w = w.astype(np.uint32)
            row_or = np.bitwise_or.reduce(w, axis=0)
            # per-chunk OR words, prefix OR, first covering chunk
            n_chunks = -(-(e - s) // chunk)
            chunk_or = np.stack([np.bitwise_or.reduce(w[i * chunk:(i + 1) * chunk],
                                                      axis=0)
                                 for i in range(n_chunks)])
            prefix = np.bitwise_or.accumulate(chunk_or, axis=0)
            cov = ~((nd & ~prefix) != 0).any(1)
            by_chunk = (min(e - s, (int(np.argmax(cov)) + 1) * chunk)
                        if cov.any() else e - s)
            # the kernel's steps: test per step, then scan the covering one
            cls = PS.row_class(e - s)
            step = 16 // nw if cls == PS.SHORT else STEP[cls]
            acc = np.zeros(nw, np.uint32)
            by_step = e - s
            for b in range(0, e - s, step):
                so = np.bitwise_or.reduce(w[b:b + step], axis=0)
                if not ((nd & ~(acc | so)) != 0).any():
                    run = acc | np.bitwise_or.accumulate(w[b:b + step], axis=0)
                    j = b + int(np.argmax(~((nd & ~run) != 0).any(1)))
                    by_step = min(e - s, (j // chunk + 1) * chunk)
                    break
                acc |= so
            assert by_step == by_chunk
            found[k, r] = row_or & nd
            work[k, r] = by_chunk
    return found, work


def random_pull(rng, p, chunk, nw, density):
    lengths = synthetic_lengths(chunk) + list(rng.integers(0, 3 * chunk, 20))
    n = 300
    offsets, cols = synthetic_csr(rng, p, lengths, n)
    cols[rng.random(cols.shape) < 0.05] = -1          # ELL-style padding
    words = np.where(rng.random((p, n, nw)) < density,
                     rng.integers(0, 2**32, (p, n, nw), dtype=np.uint64), 0
                     ).astype(np.uint32)
    need = rng.integers(0, 2**32, (p, len(lengths), nw),
                        dtype=np.uint64).astype(np.uint32)
    need[:, ::5] = 0
    need[:, 1::7] = np.uint32(1 << 31)                # lane 31 only
    return offsets, cols, words, need


@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("nw", [1, 2, 3, 4])
@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), dens=st.integers(1, 60))
def test_speculative_words_equal_chunked_plain(chunk, nw, seed, dens):
    rng = np.random.default_rng(seed)
    offsets, cols, words, need = random_pull(rng, 2, chunk, nw, dens / 1000)
    want_found, want_work = speculative_pull(offsets, cols, words, need, chunk)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32)
                                   if a.dtype == np.uint32 else a)
    found, work = ell_pull_chunked_plain(t(offsets), t(cols), t(words),
                                         t(need), chunk)
    np.testing.assert_array_equal(found.numpy().view(np.uint32), want_found)
    np.testing.assert_array_equal(work.numpy(), want_work)


@pytest.mark.parametrize("chunk", [32, 64])
@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), dens=st.integers(1, 40))
def test_speculative_bits_equal_bit_plain(chunk, seed, dens):
    rng = np.random.default_rng(seed)
    offsets, cols, _, _ = random_pull(rng, 2, chunk, 1, 0.0)
    frontier = rng.random((2, 300)) < dens / 1000
    active = (rng.random((2, offsets.shape[1] - 1)) < 0.8).astype(np.int32)
    words = frontier[..., None].astype(np.uint32)
    want_found, want_work = speculative_pull(
        offsets, cols, words, active[..., None].astype(np.uint32), chunk)
    found, work = ell_pull_bits_plain(
        torch.from_numpy(offsets), torch.from_numpy(cols),
        TC.pack_lanes(torch.from_numpy(frontier)), torch.from_numpy(active),
        chunk)
    np.testing.assert_array_equal(found.numpy(), want_found[..., 0])
    np.testing.assert_array_equal(work.numpy(), want_work)


def _one(csr, k):
    return RCSR(offsets=jnp.asarray(np.asarray(csr.offsets)[k]),
                cols=jnp.asarray(np.asarray(csr.cols)[k]),
                rowids=jnp.asarray(np.asarray(csr.rowids)[k]),
                m=jnp.asarray(np.asarray(csr.m)[k]), eidx=None,
                n_rows=csr.n_rows, e_max=csr.e_max)


@pytest.mark.parametrize("kind,rows_of,cols_of", [
    ("dd", "d", "d"), ("dn", "d", "n"), ("nd", "n", "d")])
@pytest.mark.parametrize("chunk", [32, 64])
def test_speculative_equals_reference_pulls(graph, kind, rows_of, cols_of,
                                            chunk):
    """The emulated kernel evaluation against the reference's own chunked
    pulls (``bfs._pull_chunked`` for the bit gather,
    ``msbfs._pull_chunked_multi`` for the word gather) on a p = 4
    partition with long rows (TH = 8)."""
    pg = partition_graph(graph, th=8, p_rank=2, p_gpu=2)
    csr = pg.subgraph(kind)
    size = {"d": max(pg.d, 1), "n": pg.n_local}
    rng = np.random.default_rng(chunk + len(kind))
    offsets, cols = np.asarray(csr.offsets), np.asarray(csr.cols)
    frontier = rng.random((pg.p, size[cols_of], 32)) < 0.02
    need = rng.random((pg.p, size[rows_of], 32)) < 0.5
    words = TC.pack_lanes(torch.from_numpy(frontier)).numpy().view(np.uint32)
    needw = TC.pack_lanes(torch.from_numpy(need)).numpy().view(np.uint32)
    found, work = speculative_pull(offsets, cols, words, needw, chunk)
    bit = (words[..., :1] & 1)
    active = (needw[..., 0] & 1)
    bfound, bwork = speculative_pull(offsets, cols, bit, active[..., None],
                                     chunk)
    for k in range(pg.p):
        wf, ww = RM._pull_chunked_multi(_one(csr, k), jnp.asarray(need[k]),
                                        jnp.asarray(frontier[k]), chunk)
        np.testing.assert_array_equal(
            TC.unpack_lanes(torch.from_numpy(found[k].view(np.int32)),
                            32).numpy(), np.asarray(wf))
        assert int(work[k].sum()) == int(ww)
        bf, bw = RB._pull_chunked(_one(csr, k), jnp.asarray(active[k] == 1),
                                  jnp.asarray(frontier[k, :, 0]), chunk)
        np.testing.assert_array_equal(bfound[k, :, 0] > 0, np.asarray(bf))
        assert int(bwork[k].sum()) == int(bw)
    assert work.sum() > 0 and bwork.sum() > 0


# ------------------------------------------------------- sweep entry points
@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_sweep_entries_equal_three_single_calls_on_cpu(graph, chunk):
    pg = partition_graph(graph, th=16, p_rank=2, p_gpu=2)
    pgv = TB.device_view(pg, "cpu")
    rng = np.random.default_rng(chunk)
    d, nl, p = max(pg.d, 1), pg.n_local, pg.p
    fd, fn = rng.random((p, d, 32)) < 0.05, rng.random((p, nl, 32)) < 0.05
    ud, un = rng.random((p, d, 32)) < 0.5, rng.random((p, nl, 32)) < 0.5
    wd, wn = TC.pack_lanes(torch.from_numpy(fd)), TC.pack_lanes(torch.from_numpy(fn))
    pulls = [(pgv.dd, wd, TC.pack_lanes(torch.from_numpy(ud))),
             (pgv.dn, wn, TC.pack_lanes(torch.from_numpy(ud))),
             (pgv.nd, wd, TC.pack_lanes(torch.from_numpy(un)))]
    before = dict(ops.LAUNCHES)
    got = ops.ell_pull_chunked_sweep(pulls, chunk)
    for (csr, f, n), (gf, gw) in zip(pulls, got):
        wf, ww = ops.ell_pull_chunked(csr.offsets, csr.cols, f, n, chunk)
        assert torch.equal(gf, wf) and torch.equal(gw, ww)
    bits = [(pgv.dd, TC.pack_lanes(torch.from_numpy(fd[..., 0])),
             torch.from_numpy(ud[..., 0].astype(np.int32))),
            (pgv.dn, TC.pack_lanes(torch.from_numpy(fn[..., 0])),
             torch.from_numpy(ud[..., 1].astype(np.int32))),
            (pgv.nd, TC.pack_lanes(torch.from_numpy(fd[..., 0])),
             torch.from_numpy(un[..., 0].astype(np.int32)))]
    got = ops.ell_pull_bits_sweep(bits, chunk)
    for (csr, m, a), (gf, gw) in zip(bits, got):
        wf, ww = ops.ell_pull_bits(csr.offsets, csr.cols, m, a, chunk)
        assert torch.equal(gf, wf) and torch.equal(gw, ww)
        assert int(gw.sum()) > 0
    assert ops.LAUNCHES == before                 # CPU: no kernel launched


def test_sweep_entries_refuse_tensors_on_other_devices(graph):
    """No silent fallback: a sweep whose tensors lie neither all on the CPU
    nor on a card raises before any pull runs."""
    pg = partition_graph(graph, th=16, p_rank=2, p_gpu=2)
    pgv = TB.device_view(pg, "cpu")
    d = max(pg.d, 1)
    mask = TC.pack_lanes(torch.zeros((pg.p, d), dtype=torch.bool))
    act = torch.zeros((pg.p, d), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors launch the kernel"):
        ops.ell_pull_bits_sweep([(pgv.dd, mask, act.to("meta"))], 32)
    words = mask[..., None]
    with pytest.raises(ValueError, match="CUDA tensors launch the kernel"):
        ops.ell_pull_chunked_sweep([(pgv.dd, words.to("meta"), words)], 32)
