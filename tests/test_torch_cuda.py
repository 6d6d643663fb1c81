"""The port's CUDA kernels and serving path on the card, held against the
plain PyTorch versions on the same inputs (exact equality for the integer
kernels; stated tolerances for the float kernels ``cin_fused`` and
``segment_bag``, whose sums run in another order). Every test here needs
an NVIDIA GPU and ``nvcc`` and skips without one; the file imports no JAX,
so it runs on a machine that has PyTorch for CUDA only:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch.configs.xdeepfm import SMOKE
from repro_torch.core import bfs as TB, comm as TC, convert, engine as TE
from repro_torch.core.partition import partition_graph
from repro_torch.graphs.rmat import pick_sources, rmat_graph
from repro_torch.core.types import CSR
from repro_torch.kernels import ops
from repro_torch.kernels.cin_fused import cin_fused_plain
from repro_torch.kernels.cin_fused import splits as cin_splits
from repro_torch.kernels.pull_schedule import build_schedule
from repro_torch.models.recsys import XDeepFM
from repro_torch.serve import BFSServeEngine, Query, QueryKind

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def words(rng, shape):
    return torch.from_numpy(
        rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32))


@pytest.mark.parametrize("r,k,n,nw", [(7, 4, 40, 1), (256, 32, 500, 2),
                                      (33, 7, 100, 3), (1, 1, 32, 1),
                                      (40, 70, 300, 4), (9, 3000, 700, 2)])
def test_ell_pull_multi_cuda_matches_plain(card, r, k, n, nw):
    rng = np.random.default_rng(r * 100 + k)
    parents = torch.from_numpy(rng.integers(-1, n, (r, k)).astype(np.int32))
    fw, aw = words(rng, (n, nw)), words(rng, (r, nw))
    want = ops.ell_pull_multi(parents, fw, aw)
    got = ops.ell_pull_multi(parents.to(card), fw.to(card), aw.to(card))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.parametrize("chunk", [16, 32, 48])
@pytest.mark.parametrize("w", [32, 64])
def test_chunked_pull_cuda_matches_plain(card, chunk, w):
    pg = partition_graph(rmat_graph(10, seed=7), th=32, p_rank=2, p_gpu=2)
    rng = np.random.default_rng(chunk + w)
    for csr, rows, cols in ((pg.dn, pg.d, pg.n_local), (pg.nd, pg.n_local, pg.d),
                            (pg.dd, pg.d, pg.d)):
        frontier = TC.pack_lanes(torch.from_numpy(
            rng.random((pg.p, cols, w)) < 0.1))
        need = TC.pack_lanes(torch.from_numpy(
            rng.random((pg.p, rows, w)) < 0.5))
        args = (torch.from_numpy(np.asarray(csr.offsets)),
                torch.from_numpy(np.asarray(csr.cols)), frontier, need)
        want = ops.ell_pull_chunked(*args, chunk)
        before = ops.LAUNCHES["ell_pull_multi"]
        got = ops.ell_pull_chunked(*(a.to(card) for a in args), chunk)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["ell_pull_multi"] == before + 1
        for g, want_ in zip(got, want):
            np.testing.assert_array_equal(g.cpu().numpy(), want_.numpy())
        assert int(want[1].sum()) > 0


@pytest.mark.parametrize("k,nw", [(1, 5), (4, 700), (8, 513), (2, 60561)])
@pytest.mark.parametrize("with_count", [True, False])
def test_mask_reduce_cuda_matches_plain(card, k, nw, with_count):
    rng = np.random.default_rng(k * nw)
    parts, prev = words(rng, (k, nw)), words(rng, nw)
    want = ops.mask_reduce(parts, prev, with_count=with_count)
    got = ops.mask_reduce(parts.to(card), prev.to(card),
                          with_count=with_count)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got[0].cpu().numpy(), want[0].numpy())
    if with_count:
        np.testing.assert_array_equal(got[1].cpu().numpy(), want[1].numpy())


def stacked_csr(rng, p, r, frontier):
    """A random stacked CSR ``[p, R+1]`` / ``[p, E]`` over the columns of
    ``frontier [p, N]``. Per partition, row 0 has degree 0 and row 1 more
    than 1000 parents, the first 1200 of them off the frontier."""
    n = frontier.shape[1]
    deg = rng.integers(0, 40, (p, r))
    deg[:, 0] = 0
    deg[:, 1] = 1500 + rng.integers(0, 100, p)
    offsets = np.zeros((p, r + 1), np.int32)
    offsets[:, 1:] = np.cumsum(deg, axis=1)
    cols = rng.integers(0, n, (p, int(offsets[:, -1].max()))).astype(np.int32)
    for k in range(p):
        s = offsets[k, 1]
        cols[k, s:s + 1200] = rng.choice(np.flatnonzero(~frontier[k]), 1200)
    return torch.from_numpy(offsets), torch.from_numpy(cols)


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("chunk", [1, 16, 32, 64])
def test_bit_pull_cuda_matches_plain(card, p, chunk):
    rng = np.random.default_rng(p * 100 + chunk)
    r, n = 300, 2000
    frontier = rng.random((p, n)) < 0.01
    offsets, cols = stacked_csr(rng, p, r, frontier)
    mask = TC.pack_lanes(torch.from_numpy(frontier))
    active = torch.from_numpy((rng.random((p, r)) < 0.7).astype(np.int32))
    active[:, :2] = 1
    args = (offsets, cols, mask, active)
    want = ops.ell_pull_bits(*args, chunk)
    before = ops.LAUNCHES["ell_pull"]
    got = ops.ell_pull_bits(*(a.to(card) for a in args), chunk)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ell_pull"] == before + 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
    assert int(want[0].sum()) > 0
    assert (want[1][:, 0] == 0).all() and (want[1][:, 1] >= 1200).all()


@pytest.mark.parametrize("r,w,n", [(7, 4, 40), (256, 32, 1000),
                                   (300, 7, 333), (1, 1, 32), (40, 1100, 64),
                                   (9, 3000, 700)])
def test_ell_pull_cuda_matches_plain(card, r, w, n):
    rng = np.random.default_rng(r * 1000 + w)
    parents = torch.from_numpy(rng.integers(-1, n, (r, w)).astype(np.int32))
    mask = TC.pack_lanes(torch.from_numpy(rng.random(n) < 0.3))
    active = torch.from_numpy(rng.integers(0, 2, r).astype(np.int32))
    want = ops.ell_pull(parents, mask, active)
    got = ops.ell_pull(parents.to(card), mask.to(card), active.to(card))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


# ------------------------------------ scheduled pulls (csrc/pull_rows.cuh)
def scheduled_case(rng, chunk, nw, n=3000, p=2):
    """A stacked CSR whose rows have the class boundary lengths (0, 1,
    chunk +- 1, the short and medium limits +- 1, 40 times the medium
    limit) and 200 random ones, sparse frontier words with lane 31 set on
    some vertices, need words with some rows 0 and some lane 31 only.
    ``nw`` 0: the bit gather (mask and active rows)."""
    from repro_torch.kernels import pull_schedule as PS
    lim, sm = PS.MEDIUM_MAX, PS.SHORT_MAX
    lengths = ([0, 1, sm - 1, sm, sm + 1, chunk - 1, chunk, chunk + 1,
                lim - 1, lim, lim + 1, 2 * lim + 7, 40 * lim]
               + list(rng.integers(0, 3 * chunk, 200)))
    deg = np.stack([rng.permutation(lengths) for _ in range(p)])
    offsets = np.zeros((p, len(lengths) + 1), np.int32)
    offsets[:, 1:] = np.cumsum(deg, axis=1)
    cols = rng.integers(0, n, (p, int(offsets[:, -1].max())),
                        dtype=np.int64).astype(np.int32)
    if nw == 0:
        front = TC.pack_lanes(torch.from_numpy(rng.random((p, n)) < 0.0005))
        need = torch.from_numpy(
            (rng.random((p, len(lengths))) < 0.8).astype(np.int32))
    else:
        live = torch.from_numpy(rng.random((p, n, 1)) < 0.002)
        front = torch.where(live, words(rng, (p, n, nw)), 0)
        front[:, ::97, -1] |= -2**31                  # lane 31 of some words
        need = words(rng, (p, len(lengths), nw))
        need[:, ::5] = 0
        need[:, 1::7] = 0
        need[:, 1::7, -1] = -2**31                    # lane 31 only
    return torch.from_numpy(offsets), torch.from_numpy(cols), front, need


def scheduled_pull(nw):
    if nw == 0:
        return ops.ell_pull_bits, ops.ell_pull_bits_sweep, "ell_pull"
    return ops.ell_pull_chunked, ops.ell_pull_chunked_sweep, "ell_pull_multi"


@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("nw", [0, 1, 2, 3, 4])
def test_scheduled_pull_matches_plain_on_synthetic_csr(card, chunk, nw):
    """Both gathers, every length class, exact found and work; two launches
    give equal outputs."""
    rng = np.random.default_rng(chunk * 10 + nw)
    args = scheduled_case(rng, chunk, nw)
    one, _, name = scheduled_pull(nw)
    want = one(*args, chunk)
    dev = [a.to(card) for a in args]
    before = ops.LAUNCHES[name]
    got = one(*dev, chunk)
    again = one(*dev, chunk)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[name] == before + 2
    for g, a, w in zip(got, again, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
        assert torch.equal(g, a)
    assert int(want[1].max()) > 2048 and int(want[0].ne(0).sum()) > 0


@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("nw", [0, 1, 4])
def test_scheduled_pull_stops_at_step_edges(card, chunk, nw):
    """The covering slot first or last of a group's step (16 / nw slots a
    short row, 32 x 4 a medium one, 256 x 8 a long one) and of the row: one
    frontier parent per row, every other parent off the frontier."""
    n, p = 64, 1
    spots = [(16, 0), (16, 15), (64, 63), (40, 15), (40, 16), (40, 32),
             (100, 0), (100, 99), (200, 128), (200, 127),
             (300, 255), (5000, 0), (5000, 2047), (5000, 2048), (5000, 4095),
             (5000, 4999), (1500, 1024), (1500, 1023)]
    deg = np.array([[ln for ln, _ in spots]])
    offsets = np.zeros((p, len(spots) + 1), np.int32)
    offsets[:, 1:] = np.cumsum(deg, axis=1)
    cols = np.full((p, int(offsets[0, -1])), 5, np.int32)
    for r, (_, at) in enumerate(spots):
        cols[0, offsets[0, r] + at] = 7                # the one hit
    onfront = np.zeros((p, n), bool)
    onfront[0, 7] = True
    if nw == 0:
        front = TC.pack_lanes(torch.from_numpy(onfront))
        need = torch.ones((p, len(spots)), dtype=torch.int32)
    else:
        front = torch.zeros((p, n, nw), dtype=torch.int32)
        front[0, 7] = -2**31                           # lane 31 only
        need = torch.zeros((p, len(spots), nw), dtype=torch.int32)
        need[..., -1] = -2**31
    args = (torch.from_numpy(offsets), torch.from_numpy(cols), front, need)
    one, _, _ = scheduled_pull(nw)
    want = one(*args, chunk)
    got = one(*(a.to(card) for a in args), chunk)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
    expect = [min(ln, (at // chunk + 1) * chunk) for ln, at in spots]
    assert want[1][0].tolist() == expect


@pytest.mark.parametrize("nw", [0, 2])
def test_sweep_entry_is_one_launch(card, nw):
    """The sweep entry pulls three subgraphs (with shared long rows) in
    one counted launch and equals three single calls."""
    rng = np.random.default_rng(nw)
    cases = [scheduled_case(rng, 32, nw, n=n) for n in (500, 3000, 800)]
    one, sweep, name = scheduled_pull(nw)
    pulls, wants = [], []
    for offsets, cols, front, need in cases:
        csr = CSR(offsets=offsets.to(card), cols=cols.to(card), rowids=None,
                  m=None)
        csr.sched = build_schedule(csr.offsets)
        pulls.append((csr, front.to(card), need.to(card)))
        wants.append(one(offsets, cols, front, need, 32))
    before = ops.LAUNCHES[name]
    got = sweep(pulls, 32)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[name] == before + 1
    for (gf, gw), (wf, ww) in zip(got, wants):
        np.testing.assert_array_equal(gf.cpu().numpy(), wf.numpy())
        np.testing.assert_array_equal(gw.cpu().numpy(), ww.numpy())


def test_card_device_view_schedules_the_pulled_subgraphs(card):
    """A card's view schedules dd, dn and nd (each as build_schedule does
    on its offsets) and leaves nn, which is never pulled, without one."""
    pg = partition_graph(rmat_graph(10, seed=7), th=32, p_rank=2, p_gpu=2)
    pgv = TB.device_view(pg, card)
    assert pgv.nn.sched is None
    for kind in ("dd", "dn", "nd"):
        got = getattr(pgv, kind).sched
        want = build_schedule(torch.from_numpy(np.asarray(pg.subgraph(kind).offsets)))
        assert got.counts == want.counts
        for f in ("order", "span", "long_len"):
            np.testing.assert_array_equal(getattr(got, f).cpu().numpy(),
                                          getattr(want, f).numpy())


@pytest.mark.parametrize("k,nw", [(1, 5), (1, 257), (2, 60561), (8, 513)])
@pytest.mark.parametrize("with_count", [True, False])
def test_payload_min_fold_cuda_matches_plain(card, k, nw, with_count):
    rng = np.random.default_rng(k * nw + 3)
    parts, prev = words(rng, (k, nw)), words(rng, nw)
    parts[torch.from_numpy(rng.random((k, nw)) < 0.3)] = 2**30
    want = ops.payload_min_fold(parts, prev, with_count=with_count)
    before = ops.LAUNCHES["payload_min_fold"]
    got = ops.payload_min_fold(parts.to(card), prev.to(card),
                               with_count=with_count)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["payload_min_fold"] == before + 1
    np.testing.assert_array_equal(got[0].cpu().numpy(), want[0].numpy())
    if with_count:
        np.testing.assert_array_equal(got[1].cpu().numpy(), want[1].numpy())
    else:
        assert got[1] is None


def on_card_at(card, t, offset):
    """``t`` copied to the card at ``offset`` words past a 16-byte
    boundary (1: every row of it unaligned where its width is even)."""
    flat = torch.empty(t.numel() + offset, dtype=t.dtype, device=card)
    out = flat[offset:].view(t.shape)
    out.copy_(t)
    return out


FOLD_KEY = {"or": "mask_reduce", "min": "payload_min_fold"}


@pytest.mark.parametrize("op", ["or", "min"])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 9])
@pytest.mark.parametrize("nw", [1, 3, 4, 5, 60560, 60561])
def test_group_fold_cuda_matches_plain(card, op, k, nw):
    """The prev-less fold of a gathered ``[K, NW]`` (the op's identity in
    registers) equals its plain version bit for bit, on rows aligned and
    offset by one word (the ragged head and tail, and each row read at
    another phase than the output's); one launch a call, counted under
    the fold's kernel."""
    from repro_torch.kernels.mask_reduce import group_fold_plain
    rng = np.random.default_rng(k * 1000 + nw)
    rows = words(rng, (k, nw))
    want = group_fold_plain(rows, op, k)
    for offset in (0, 1, 3):
        before = ops.LAUNCHES[FOLD_KEY[op]]
        got = ops.group_fold(on_card_at(card, rows, offset), op, k)
        torch.cuda.synchronize()
        assert ops.LAUNCHES[FOLD_KEY[op]] == before + 1
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy(),
                                      err_msg=f"offset {offset}")


@pytest.mark.parametrize("op", ["or", "min"])
@pytest.mark.parametrize("n", [1_000_001, 2_000_000])
def test_group_fold_cuda_strides_past_one_wave(card, op, n):
    """Rows longer than the card holds threads at once (one word a thread
    at an odd n, one int4 at n % 4 == 0): longer rows take more blocks,
    equal to the plain version bit for bit."""
    from repro_torch.kernels.mask_reduce import group_fold_plain
    rows = words(np.random.default_rng(n), (2, n))
    got = ops.group_fold(rows.to(card), op, 2)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  group_fold_plain(rows, op, 2).numpy())


@pytest.mark.parametrize("fold", ["mask_reduce", "payload_min_fold"])
@pytest.mark.parametrize("k,nw", [(1, 3), (2, 60561), (3, 4), (5, 5),
                                  (9, 513)])
@pytest.mark.parametrize("with_count", [True, False])
def test_public_folds_cuda_take_unaligned_rows(card, fold, k, nw,
                                               with_count):
    """``ops.mask_reduce`` / ``ops.payload_min_fold`` with ``prev``, both
    bodies, on partials and ``prev`` offset by one and two words from a
    16-byte boundary: equal to the plain version bit for bit."""
    rng = np.random.default_rng(k * nw + with_count)
    parts, prev = words(rng, (k, nw)), words(rng, nw)
    if fold == "payload_min_fold":
        parts[torch.from_numpy(rng.random((k, nw)) < 0.3)] = 2**30
    want = getattr(ops, fold)(parts, prev, with_count=with_count)
    got = getattr(ops, fold)(on_card_at(card, parts, 1),
                             on_card_at(card, prev, 2),
                             with_count=with_count)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


@pytest.mark.parametrize("op", ["or", "min"])
@pytest.mark.parametrize("n", [1, 5, 60561])
def test_strided_group_fold_on_stacked_rows(card, op, n):
    """The group fold of the emulated rows ``[4, n]`` of (outer, inner) =
    (2, 2) over ``"outer"``, read in place by stride (member i of group g
    at row 2 i + g), and over all four rows: equal to the plain version.
    Through comm under ``hier``, the combine is that group fold and one
    fold of the two rows it leaves (2 launches), the min update one group
    fold and one ``payload_min_fold_apply`` (2), and with ``"outer"`` of
    size 1 the apply alone (1): all equal to the CPU."""
    from repro_torch.kernels.mask_reduce import group_fold_plain
    rng = np.random.default_rng(n + len(op))
    rows = words(rng, (4, n))
    for geo in ((2, 2, 2, 1), (4, 1, 1, 1), (2, 1, 2, 2)):
        want = group_fold_plain(rows, op, *geo)
        got = ops.group_fold(on_card_at(card, rows, 1), op, *geo)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy(),
                                      err_msg=str(geo))
    hier = TC.CommConfig(delegate="hier")
    plan = TC.plan_for(hier, {"outer": 2, "inner": 2})
    want, _ = TC.delegate_combine(plan, rows, op)
    ops.reset_launches()
    got, _ = TC.delegate_combine(plan, rows.to(card), op)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[FOLD_KEY[op]] == 2
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    cand = torch.from_numpy(np.where(rng.random((4, n)) < 0.3, 5,
                                     2**30).astype(np.int32))
    prev = torch.from_numpy(np.broadcast_to(np.where(
        rng.random(n) < 0.5, 3, 2**30), (4, n)).astype(np.int32).copy())
    for sizes, launches in (((2, 2), 2), ((1, 4), 1)):
        plan = TC.plan_for(hier, dict(zip(("outer", "inner"), sizes)))
        want = TC.delegate_min_apply(plan, cand, prev)
        ops.reset_launches()
        got = TC.delegate_min_apply(plan, cand.to(card), prev.to(card))
        torch.cuda.synchronize()
        assert ops.LAUNCHES["payload_min_fold"] == launches, sizes
        assert got[2] == want[2]
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


def or_apply_case(rng, k, p, d, w, track_levels):
    """Gathered words ``[k, d * nw]``, a level plane ``[p, d, w]`` (int32
    with INF delegates and visited lanes, or the bool visited plane), ``it``
    and a target plane, on the CPU."""
    levels = rng.integers(0, 6, (p, d, w)).astype(np.int32)
    levels[rng.random((p, d, w)) < 0.6] = 2**30
    levels[:, ::3] = 2**30
    return (words(rng, (k, d * -(-w // 32))),
            torch.from_numpy(levels if track_levels else levels != 2**30),
            torch.from_numpy(rng.integers(3, 9, p).astype(np.int32)),
            torch.from_numpy(rng.random((p, d, w)) < 0.2))


def assert_apply_equal(got, want):
    for name, g, w in zip(want._fields, got, want):
        if w is None:
            assert g is None, name
        else:
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(),
                                          err_msg=name)


@pytest.mark.parametrize("d", [1, 257, 60561])
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("w", [32, 40, 64])
@pytest.mark.parametrize("track_levels", [True, False])
@pytest.mark.parametrize("targets", [True, False])
def test_mask_reduce_apply_cuda_matches_plain(card, d, k, w, track_levels,
                                              targets):
    """The fused OR fold and delegate update equals its plain version: new
    plane, frontier, lane flags, row flag; one launch; a dirty flag buffer
    is cleared by the call itself."""
    from repro_torch.kernels.mask_reduce import mask_reduce_apply_cuda
    rng = np.random.default_rng(d * 7 + k * 3 + w)
    gathered, level, it, target = or_apply_case(rng, k, 3, d, w, track_levels)
    args = (gathered, level, it, target if targets else None)
    want = ops.mask_reduce_apply(*args)
    on = tuple(None if a is None else a.to(card) for a in args)
    before = ops.LAUNCHES["mask_reduce"]
    got = ops.mask_reduce_apply(*on)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["mask_reduce"] == before + 1
    assert_apply_equal(got, want)
    dirty = torch.ones((3, 4 * (2 * -(-w // 4) + 1)), dtype=torch.bool,
                       device=card)
    again = mask_reduce_apply_cuda(*on, flags=dirty)
    torch.cuda.synchronize()
    assert_apply_equal(again, want)
    assert torch.equal(on[1].cpu(), level)         # out of place


@pytest.mark.parametrize("d", [1, 257, 60561])
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("p", [1, 3])
def test_payload_min_fold_apply_cuda_matches_plain(card, d, k, p):
    """The fused min fold into the delegate levels equals its plain version
    (levels and the per-row improved flag); one launch; a dirty flag
    buffer is cleared by the call itself."""
    from repro_torch.kernels.mask_reduce import payload_min_fold_apply_cuda
    rng = np.random.default_rng(d * 5 + k * 3 + p)
    gathered = torch.from_numpy(rng.integers(1, 9, (k, d)).astype(np.int32))
    gathered[torch.from_numpy(rng.random((k, d)) < 0.6)] = 2**30
    prev = torch.from_numpy(rng.integers(0, 9, (p, d)).astype(np.int32))
    prev[torch.from_numpy(rng.random((p, d)) < 0.5)] = 2**30
    prev[0, ::2] = 2**30
    prev[-1] = 0 if p > 1 else prev[-1]            # a row nothing improves
    want = ops.payload_min_fold_apply(gathered, prev)
    before = ops.LAUNCHES["payload_min_fold"]
    got = ops.payload_min_fold_apply(gathered.to(card), prev.to(card))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["payload_min_fold"] == before + 1
    dirty = torch.ones(4 * -(-p // 4), dtype=torch.bool, device=card)
    again = payload_min_fold_apply_cuda(gathered.to(card), prev.to(card),
                                        flags=dirty)
    torch.cuda.synchronize()
    for g in (got, again):
        np.testing.assert_array_equal(g[0].cpu().numpy(), want[0].numpy())
        assert g[1].dtype == torch.bool
        np.testing.assert_array_equal(g[1].cpu().numpy(), want[1].numpy())


def test_apply_kernels_take_unaligned_planes(card):
    """Planes that start off a 16-byte boundary, and W not a multiple of 4,
    take the kernels' narrower loads and give the same result."""
    rng = np.random.default_rng(11)
    for w, track in ((33, True), (33, False), (32, True), (48, False)):
        gathered, level, it, target = or_apply_case(rng, 2, 2, 101, w, track)
        want = ops.mask_reduce_apply(gathered, level, it, target)
        flat = torch.empty(level.numel() + 1, dtype=level.dtype, device=card)
        shifted = flat[1:].view(level.shape)
        shifted.copy_(level)
        got = ops.mask_reduce_apply(gathered.to(card), shifted, it.to(card),
                                    target.to(card))
        torch.cuda.synchronize()
        assert_apply_equal(got, want)
    gathered = torch.from_numpy(rng.integers(0, 9, (2, 98)).astype(np.int32))
    prev = torch.from_numpy(rng.integers(0, 9, (3, 98)).astype(np.int32))
    want = ops.payload_min_fold_apply(gathered, prev)
    flat = torch.empty(prev.numel() + 1, dtype=torch.int32, device=card)
    shifted = flat[1:].view(prev.shape)
    shifted.copy_(prev)
    got = ops.payload_min_fold_apply(gathered.to(card), shifted)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got[0].cpu().numpy(), want[0].numpy())
    np.testing.assert_array_equal(got[1].cpu().numpy(), want[1].numpy())


def test_apply_wrappers_reject_bad_inputs(card):
    """float32 and non-contiguous inputs raise before any launch."""
    g = torch.zeros((2, 8), dtype=torch.int32, device=card)
    level = torch.zeros((2, 8, 32), dtype=torch.int32, device=card)
    it = torch.zeros(2, dtype=torch.int32, device=card)
    before = dict(ops.LAUNCHES)
    for bad in ((g.float(), level, it), (g, level.float(), it),
                (g, level.transpose(0, 1).contiguous().transpose(0, 1), it),
                (g.t().contiguous().t(), level, it)):
        with pytest.raises(ValueError):
            ops.mask_reduce_apply(*bad)
    prev = torch.zeros((2, 8), dtype=torch.int32, device=card)
    for bad in ((g.float(), prev), (g, prev.float()),
                (g, prev.t().contiguous().t())):
        with pytest.raises(ValueError):
            ops.payload_min_fold_apply(*bad)
    assert ops.LAUNCHES == before


def test_group_fold_rejects_bad_inputs(card):
    """The prev-less fold checks what it is given before any launch: a
    float32 or non-contiguous rows tensor, rows off the card, an op it has
    no kernel for and a member past the last row raise ValueError."""
    from repro_torch.kernels.mask_reduce import group_fold_cuda
    rows = torch.zeros((4, 8), dtype=torch.int32, device=card)
    before = dict(ops.LAUNCHES)
    for args in ((rows.float(), "or", 2), (rows.t().contiguous().t(), "or", 2),
                 (rows, "max", 2), (rows, "min", 5), (rows, "min", 2, 2, 3, 1),
                 (rows, "or", 0), (rows[0], "or", 1)):
        with pytest.raises(ValueError):
            ops.group_fold(*args)
    with pytest.raises(ValueError):
        group_fold_cuda(rows.cpu(), "or", 2)
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("kw", [
    dict(), dict(cap_nn=-4, delegate_u8=True),
    dict(static_exchange=True, delegate_u8=True),
    dict(comm=TC.CommConfig(delegate="allgather")),
    dict(comm=TC.CommConfig(delegate="hier"))])
def test_single_source_bfs_on_card_equals_cpu(card, kw):
    """A scale-10 single-source BFS: every BFSState leaf (levels and every
    counter) equal between the card (kernels) and the CPU (plain
    versions). Under allgather and hier (one emulated axis: one group) the
    delegate update is one ``payload_min_fold_apply`` launch a sweep."""
    g = rmat_graph(10, seed=7)
    pg = partition_graph(g, th=32, p_rank=2, p_gpu=2)
    plan = TE.build_exchange_plan(pg)
    cfg = TB.BFSConfig(max_iters=40, pull_chunk=16, **kw)
    src = int(pick_sources(g, 1, seed=1)[0])
    outs = []
    for device in (card, "cpu"):
        ops.reset_launches()
        out = TB.run_bfs_emulated(
            TB.device_view(pg, device), TB.init_state(pg, src, cfg, device),
            cfg, TE.device_plan(plan, device))
        outs.append((convert.bfs_state_to_numpy(out), dict(ops.LAUNCHES)))
    (a, la), (b, lb) = outs
    for k in convert.BFS_STATE_LEAVES:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    sweeps = int(a["it"][0])
    assert la["ell_pull"] == sweeps and lb["ell_pull"] == 0
    assert la["payload_min_fold"] == (sweeps if "comm" in kw else 0)
    assert la["ell_pull_multi"] == la["mask_reduce"] == 0


def test_wrappers_reject_bad_inputs(card):
    parts = torch.zeros((2, 8), dtype=torch.int64, device=card)
    with pytest.raises(ValueError):
        ops.mask_reduce(parts, torch.zeros(8, dtype=torch.int64, device=card))
    with pytest.raises(ValueError):
        ops.mask_reduce(torch.zeros((2, 8), dtype=torch.int32),
                        torch.zeros(8, dtype=torch.int32, device=card))


def test_launch_helpers(card):
    """Each C entry is prototyped once and handed out from a cache; the
    one-pass check refuses wrong dtype, non-contiguous and mixed-device
    inputs; a nonzero cudaError from a launch raises."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels.mask_reduce import _FOLD_ARGTYPES
    fn = _build.function("mask_reduce", "fold_rows", _FOLD_ARGTYPES)
    assert fn is _build.function("mask_reduce", "fold_rows", _FOLD_ARGTYPES)
    assert fn.restype is ctypes.c_int and len(fn.argtypes) == 11
    x = torch.zeros((2, 8), dtype=torch.int32, device=card)
    names = ("partials", "prev")
    assert _build.require("f", torch.int32, names, x, x[0]) == x.get_device()
    for bad in (x[0].long(), x[:, 0], x[0].cpu()):
        with pytest.raises(ValueError):
            _build.require("f", torch.int32, names, x, bad)
    with pytest.raises(RuntimeError, match="cudaError 7"):
        _build.launch("f", lambda *args: 7, x.get_device())


def test_engine_on_card_equals_engine_on_cpu(card):
    """The whole serving path: answers and every ServeStats counter equal
    between the card (kernels) and the CPU (plain versions)."""
    g = rmat_graph(10, seed=3)
    srcs = [int(s) for s in pick_sources(g, 12, seed=2)]
    K = QueryKind
    qs = ([Query(s) for s in srcs[:4]]
          + [Query(s, K.REACHABILITY) for s in srcs[4:6]]
          + [Query(s, K.DISTANCE_LIMITED, max_depth=2) for s in srcs[6:9]]
          + [Query(s, K.MULTI_TARGET, targets=(srcs[0], srcs[1]))
             for s in srcs[9:]] + [Query(srcs[0])])
    outs = []
    for device in (card, "cpu"):
        eng = BFSServeEngine(g, th=32, p_rank=2, p_gpu=2, device=device)
        outs.append((eng.submit_many(qs), eng.stats.as_dict()))
    (a, sa), (b, sb) = outs
    assert sa == sb
    for x, y in zip(a, b):
        if isinstance(y, dict):
            assert x == y
        else:
            np.testing.assert_array_equal(x, y)


# ------------------------------------------- refill, overlap and streaming
def tailed_setup():
    """rmat_graph(8, seed=11) with 2 tails of 24, partitioned as the
    reference's overlap tests do, and a skewed stream of the four kinds."""
    from repro_torch.graphs.synthetic import with_tails
    core = rmat_graph(8, seed=11)
    g, tips = with_tails(core, n_tails=2, length=24, seed=2)
    pg = partition_graph(g, th=32, p_rank=2, p_gpu=2)
    shallow = [int(s) for s in pick_sources(core, 10, seed=3)]
    srcs = [int(tips[0])] + shallow[:5] + [int(tips[1])] + shallow[5:]
    K = QueryKind
    kinds = [lambda s: Query(s), lambda s: Query(s, K.REACHABILITY),
             lambda s: Query(s, K.DISTANCE_LIMITED, max_depth=2),
             lambda s: Query(s, K.MULTI_TARGET, targets=tuple(srcs[:2]))]
    return pg, tips, [kinds[i % 4](s) for i, s in enumerate(srcs)]


def serve_engine(pg, device, **kw):
    from repro_torch.core import msbfs as TM
    return BFSServeEngine(pg=pg, cfg=TM.MSBFSConfig(n_queries=4, max_iters=96),
                          cache_capacity=0, refill=True, device=device, **kw)


def assert_answers_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(y, dict):
            assert x == y
        else:
            np.testing.assert_array_equal(x, y)


def test_graph_block_equals_eager_block(card):
    """The captured block (CUDA graph replays over static buffers) and the
    eager block give every state leaf equal, from the same state and
    watch, stopping at the same retirement sweep; both equal the per-sweep
    driver stepped to that sweep, and each replay of the captured sweep
    counts one pull and one fold launch in ``ops.REPLAYED``."""
    from repro_torch.core import msbfs as TM
    pg, tips, _ = tailed_setup()
    eng = serve_engine(pg, card)
    cfg = TM.MSBFSConfig(n_queries=4, max_iters=96, enable_targets=False)
    srcs = [int(tips[0]), 5, 3]
    st = TM.init_multi_state(pg, srcs, cfg, device=card)
    watch = np.array([True, True, True, False])
    outs = []
    for graph in (True, False):
        ops.reset_launches()
        blk = TM.make_msbfs_block_emulated(cfg, 64, graph=graph)
        run = blk(eng.pgv, eng.plan, st, watch)
        probe = run.wait()
        blk.runner.drain()
        outs.append((probe.it, convert.state_to_numpy(run.out),
                     dict(ops.LAUNCHES), dict(ops.REPLAYED), blk.runner))
    (it_g, a, lg, rg, runner), (it_e, b, le, re_, _) = outs
    assert it_g == it_e and 0 < it_g < 64
    for k in TM.STATE_LEAVES:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    ref = st
    for _ in range(it_g):
        ref = TM.msbfs_step(eng.pgv, eng.plan, ref, cfg)
    want = convert.state_to_numpy(ref)
    for k in TM.STATE_LEAVES:
        np.testing.assert_array_equal(a[k], want[k], err_msg=k)
    assert runner.per_replay["ell_pull_multi"] == 1
    assert runner.per_replay["mask_reduce"] == 1
    # the capture's one eager warm-up sweep launches; the capture does not
    assert lg["ell_pull_multi"] == lg["mask_reduce"] == 1
    assert rg["ell_pull_multi"] == rg["mask_reduce"] == runner.replays
    assert runner.replays == runner.sweeps >= it_g
    assert le["ell_pull_multi"] == le["mask_reduce"] >= it_g
    assert sum(re_.values()) == 0


@pytest.mark.parametrize("sweep_block", [1, 4, 8])
def test_overlap_counters_equal_sync_on_card(card, sweep_block):
    """The same skewed stream through the per-sweep and the overlapped
    driver on the card, and through the per-sweep driver on the CPU:
    equal answers, and every ServeStats field equal but sweep_blocks."""
    pg, _, qs = tailed_setup()
    runs = []
    for device, kw in ((card, {}), (card, dict(overlap=True,
                                               sweep_block=sweep_block)),
                       ("cpu", {})):
        eng = serve_engine(pg, device, **kw)
        eng.warmup(reachability=True, targets=True)
        runs.append((eng.submit_many(qs), eng.stats.as_dict()))
    (a_s, s_s), (a_o, s_o), (a_c, s_c) = runs
    assert_answers_equal(a_s, a_c)
    assert_answers_equal(a_o, a_c)
    assert s_s == s_c
    assert s_o["sweep_blocks"] > 0
    assert {k: v for k, v in s_o.items() if k != "sweep_blocks"} == \
        {k: v for k, v in s_c.items() if k != "sweep_blocks"}


def test_capture_after_dropped_captured_engines(card):
    """The captured graphs of a dropped engine die with its reference
    cycles whenever the collector runs; destroying a graph while another
    is being captured would invalidate that capture. With the collector
    running at every allocation, engines are dropped and new ones capture
    their blocks, and the last serves as the CPU does."""
    import gc
    pg, _, qs = tailed_setup()
    threshold = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        for _ in range(3):
            eng = serve_engine(pg, card, overlap=True, sweep_block=4)
            eng.warmup(reachability=True, targets=True)
        got = eng.submit_many(qs)
    finally:
        gc.set_threshold(*threshold)
    cpu = serve_engine(pg, "cpu")
    assert_answers_equal(got, cpu.submit_many(qs))
    assert eng.stats.as_dict()["sweeps"] == cpu.stats.as_dict()["sweeps"]


def test_stream_deliveries_on_card(card):
    """Chunks fed through submit_stream with poll() between them, then
    drain_stream(): each poll delivers the same queries and results on the
    card as on the CPU, and the stats are equal."""
    pg, _, qs = tailed_setup()
    runs = []
    for device in (card, "cpu"):
        eng = serve_engine(pg, device, overlap=True)
        deliveries = []
        for i in range(0, len(qs), 4):
            eng.submit_stream(qs[i:i + 4], front=i == 8)
            deliveries.append(eng.poll())
        deliveries.append(eng.drain_stream())
        runs.append((deliveries, eng.stats.as_dict()))
    (da, sa), (db, sb) = runs
    assert sa == sb
    assert [list(d) for d in da] == [list(d) for d in db]
    for x, y in zip(da, db):
        assert_answers_equal(list(x.values()), list(y.values()))


# ------------------------------------------------------------ payload plane
def payload_setup():
    """rmat_graph(8, seed=11) on the delegate-rich (2, 2) partition
    (th=16) and the seven kinds, payload ones first."""
    g = rmat_graph(8, seed=11)
    pg = partition_graph(g, th=16, p_rank=2, p_gpu=2)
    s = [int(v) for v in pick_sources(g, 6, seed=3)]
    K = QueryKind
    qs = [Query(s[4], K.WEIGHTED_SSSP), Query(s[5], K.COMPONENTS),
          Query(s[0], K.KHOP_SAMPLE, max_depth=2),
          Query(s[2], K.WEIGHTED_SSSP), Query(s[0]),
          Query(s[1], K.REACHABILITY),
          Query(s[2], K.DISTANCE_LIMITED, max_depth=2),
          Query(s[3], K.MULTI_TARGET, targets=(s[0], s[1]))]
    return g, pg, qs


@pytest.mark.parametrize("comm", [dict(), dict(delegate="allgather"),
                                  dict(delegate="hier", nn="adaptive")],
                         ids=["auto", "allgather", "hier-adaptive"])
def test_payload_batch_on_card_equals_cpu(card, comm):
    """The payload kinds in one lane batch beside the bit kinds: answers
    and every ServeStats field equal between the card and the CPU; under
    allgather and hier the payload delegate update is one
    ``payload_min_fold_apply`` launch a sweep, beside one pull and one OR
    fold."""
    from repro_torch.core import msbfs as TM
    _, pg, qs = payload_setup()
    outs = []
    for device in (card, "cpu"):
        eng = BFSServeEngine(pg=pg, cfg=TM.MSBFSConfig(n_queries=8,
                                                       max_iters=80),
                             comm=TC.CommConfig(**comm), cache_capacity=0,
                             device=device)
        eng.warmup(payload=True, targets=True)
        ops.reset_launches()
        outs.append((eng.submit_many(qs), eng.stats.as_dict(),
                     dict(ops.LAUNCHES), eng.traversal_sweeps))
    (a, sa, la, sweeps), (b, sb, _, _) = outs
    assert sa == sb and sa["wire_pay_delegate_bytes"] > 0
    assert_answers_equal(a, b)
    assert la["ell_pull_multi"] == la["mask_reduce"] == sweeps > 0
    # allgather and hier: the fused update (the emulated plan has one
    # axis, so hier has one group: no group fold before it); auto: the
    # native amin
    want = 0 if comm.get("delegate") is None else sweeps
    assert la["payload_min_fold"] == want


def test_payload_graph_block_equals_eager_block(card):
    """A payload block captured as CUDA graphs and the same block run
    eagerly: every leaf equal, both equal to the per-sweep driver; under
    allgather each replay counts one pull, one OR fold and one min fold."""
    from repro_torch.core import msbfs as TM
    _, pg, _ = payload_setup()
    pgv = TB.device_view(pg, card)
    plan = TE.device_plan(TE.build_exchange_plan(pg), card)
    cfg = TM.MSBFSConfig(n_queries=4, max_iters=80, payload=True,
                         enable_targets=False,
                         comm=TC.CommConfig(delegate="allgather"))
    srcs = [int(s) for s in pick_sources(rmat_graph(8, seed=11), 4, seed=1)]
    st = TM.init_multi_state(pg, srcs, cfg, device=card,
                             payload_modes=["sssp", None, "components",
                                            "sssp"])
    watch = np.array([True, True, True, True])
    outs = []
    for graph in (True, False):
        blk = TM.make_msbfs_block_emulated(cfg, 64, graph=graph)
        run = blk(pgv, plan, st, watch)
        probe = run.wait()
        blk.runner.drain()
        outs.append((probe.it, convert.state_to_numpy(run.out), blk.runner))
    (it_g, a, runner), (it_e, b, _) = outs
    assert it_g == it_e and 0 < it_g < 64
    ref = st
    for _ in range(it_g):
        ref = TM.msbfs_step(pgv, plan, ref, cfg)
    want = convert.state_to_numpy(ref)
    for k in TM.STATE_LEAVES:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_array_equal(a[k], want[k], err_msg=k)
    assert runner.per_replay["payload_min_fold"] == 1
    assert runner.per_replay["ell_pull_multi"] == 1
    assert runner.per_replay["mask_reduce"] == 1


def test_payload_overlap_session_on_card_equals_cpu(card):
    """The seven kinds through the overlapped driver on the card (blocks
    captured by ``warmup(payload=True)``), the per-sweep driver on the
    card and on the CPU: equal answers, and every ServeStats field equal
    but sweep_blocks."""
    from repro_torch.core import msbfs as TM
    _, pg, qs = payload_setup()
    runs = []
    for device, kw in ((card, dict(overlap=True, sweep_block=4)), (card, {}),
                       ("cpu", {})):
        eng = BFSServeEngine(pg=pg, cfg=TM.MSBFSConfig(n_queries=4,
                                                       max_iters=80),
                             cache_capacity=0, refill=True,
                             reuse_components=False, device=device, **kw)
        eng.warmup(payload=True, targets=True)
        runs.append((eng.submit_many(qs), eng.stats.as_dict()))
    (a_o, s_o), (a_s, s_s), (a_c, s_c) = runs
    assert_answers_equal(a_o, a_c)
    assert_answers_equal(a_s, a_c)
    assert s_s == s_c and s_o["sweep_blocks"] > 0
    assert {k: v for k, v in s_o.items() if k != "sweep_blocks"} == \
        {k: v for k, v in s_c.items() if k != "sweep_blocks"}


# ------------------------------------------------------------ recsys kernels
def on(card, *arrays):
    return tuple(torch.from_numpy(a).to(card) for a in arrays)


@pytest.mark.parametrize("b,f0,fk,h,d,plain_on", [
    (4, 3, 3, 5, 8, "cpu"), (70, 39, 20, 200, 10, "cpu"),
    (1, 2, 7, 3, 16, "cpu"), (33, 39, 39, 200, 10, "cpu"),
    (7, 39, 200, 200, 10, "cpu"), (5, 4, 5, 130, 7, "cpu"),
    (3, 1, 1, 1, 1, "cpu"), (130, 6, 8, 64, 33, "cpu"),
    # B*D not a multiple of the 128-column tile
    (13, 39, 200, 200, 10, "cpu"), (301, 5, 16, 24, 3, "cpu"),
    # H not a multiple of 8, and H over one 208-channel tile
    (9, 4, 5, 1, 10, "cpu"), (50, 6, 9, 5, 10, "cpu"),
    (40, 12, 17, 130, 10, "cpu"), (20, 5, 6, 300, 10, "cpu"),
    # K not a multiple of the 8-deep k step, F0 = 1
    (30, 1, 3, 16, 10, "cpu"), (25, 7, 13, 24, 3, "cpu"),
    (17, 1, 200, 200, 10, "cpu"),
    # FULL widths on the split-k path (B = 64, B = 512), and at B = 2048
    (64, 39, 200, 200, 10, "cpu"), (512, 39, 39, 200, 10, "card"),
    (2048, 39, 200, 200, 10, "card")])
def test_cin_fused_cuda_matches_plain(card, b, f0, fk, h, d, plain_on):
    """Ragged (b, d) columns, H and K not multiples of the tiles, the FULL
    layer shapes with and without the split k sum. 3xTF32 on the tensor
    cores against float32 sums of up to 7,800 products in another order:
    |kernel - plain| <= 1e-4 * max|plain|."""
    rng = np.random.default_rng(b * 7 + d)
    x0, xk, w = on(card, rng.normal(size=(b, f0, d)).astype(np.float32),
                   rng.normal(size=(b, fk, d)).astype(np.float32),
                   rng.normal(size=(h, f0 * fk)).astype(np.float32))
    if plain_on == "cpu":
        want = ops.cin_fused(x0.cpu(), xk.cpu(), w.cpu())
    else:
        want = cin_fused_plain(x0, xk, w).cpu()
    before = ops.LAUNCHES["cin_fused"]
    got = ops.cin_fused(x0, xk, w)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["cin_fused"] == before + 1
    assert got.shape == (b, h, d) and got.dtype == torch.float32
    err = float((got.cpu() - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()), err


@pytest.mark.parametrize("b,fk", [(64, 200), (512, 39), (512, 200),
                                  (2048, 200)])
def test_cin_fused_cuda_is_deterministic(card, b, fk):
    """Two launches on the same inputs give bit-equal outputs, on the split
    k path (partial sums added in a fixed order) and off it."""
    rng = np.random.default_rng(b + fk)
    x0, xk, w = on(card, rng.normal(size=(b, 39, 10)).astype(np.float32),
                   rng.normal(size=(b, fk, 10)).astype(np.float32),
                   rng.normal(size=(200, 39 * fk)).astype(np.float32))
    n_split = cin_splits(card.index or 0, b * 10, 39, fk, 200)
    assert (n_split > 1) == (b <= 512)
    first = ops.cin_fused(x0, xk, w)
    second = ops.cin_fused(x0, xk, w)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def cin_bwd_close(got, want) -> bool:
    """|kernel - plain| <= 1e-5 max|plain| + 1e-4 |plain|: float32 sums of
    the two in another order (the forward's tolerance, per element)."""
    want = want.to(got.device)
    return bool(((got - want).abs() <= 1e-5 * want.abs().max()
                 + 1e-4 * want.abs()).all())


@pytest.mark.parametrize("b,f0,fk,h,d", [(33, 6, 8, 8, 4), (1000, 39, 39,
                                                            200, 10),
                                         (512, 39, 200, 200, 10),
                                         (70, 5, 70, 3, 3),
                                         # dx's tiling edges (tiles of 5
                                         # fields x 40 j): Fk = 230, H not
                                         # a multiple of 8, H = 400 (two
                                         # chunks of 25 K steps), F0 = 1,
                                         # F0 = 7 with B * D = 231 rows
                                         (60, 39, 230, 200, 10),
                                         (50, 39, 200, 13, 10),
                                         (40, 39, 200, 400, 10),
                                         (100, 1, 39, 200, 10),
                                         (77, 7, 104, 24, 3)])
def test_cin_fused_backward_kernels_match_plain(card, b, f0, fk, h, d):
    """Both backward kernels against the plain backward on the same card
    inputs (no tile multiple in B * D, H, F0 * Fk), each one counted
    launch; two launches give bit-equal outputs."""
    from repro_torch.kernels.cin_fused import cin_fused_bwd_plain

    rng = np.random.default_rng(b + fk)
    x0, xk, w, g = on(card, rng.normal(size=(b, f0, d)).astype(np.float32),
                      rng.normal(size=(b, fk, d)).astype(np.float32),
                      (rng.normal(size=(h, f0 * fk)) / np.sqrt(h)
                       ).astype(np.float32),
                      rng.normal(size=(b, h, d)).astype(np.float32))
    want = cin_fused_bwd_plain(x0, xk, w, g)
    before = dict(ops.LAUNCHES)
    dw = ops.cin_fused_bwd_w(x0, xk, g)
    dx0, dxk = ops.cin_fused_bwd_x(x0, xk, w, g)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["cin_fused_bwd_w"] == before["cin_fused_bwd_w"] + 1
    assert ops.LAUNCHES["cin_fused_bwd_x"] == before["cin_fused_bwd_x"] + 1
    for got, ref in zip((dx0, dxk, dw), want):
        assert got.shape == ref.shape and cin_bwd_close(got, ref)
    assert torch.equal(dw, ops.cin_fused_bwd_w(x0, xk, g))
    assert all(torch.equal(a, b_) for a, b_ in
               zip((dx0, dxk), ops.cin_fused_bwd_x(x0, xk, w, g)))


def test_xdeepfm_gradients_through_kernels_equal_plain(card):
    """SMOKE at B = 300: every gradient leaf of the loss through the
    kernels (one forward and one of each backward launch a CIN layer)
    against the same loss through ``cin_fused_plain`` under autograd,
    each within 1e-3 of its largest |gradient| (the forward kernel is
    3xTF32, so the activations the gradients pass through differ in their
    last bits)."""
    from repro_torch.models.recsys import xdeepfm_loss
    from repro_torch.train.trainer import value_and_grad

    params = XDeepFM(SMOKE, device=card, seed=5).params()
    rng = np.random.default_rng(3)
    hot = rng.integers(-1, SMOKE.n_hot, (300, SMOKE.n_sparse)).astype(np.int32)
    cold = np.where(hot < 0, rng.integers(0, SMOKE.n_cold, hot.shape),
                    -1).astype(np.int32)
    batch = {"hot_idx": torch.from_numpy(hot).to(card),
             "cold_idx": torch.from_numpy(cold).to(card),
             "labels": torch.from_numpy(rng.integers(0, 2, 300)).to(card)}
    ops.reset_launches()
    loss, grads = value_and_grad(lambda p: xdeepfm_loss(SMOKE, p, batch),
                                 params)
    torch.cuda.synchronize()
    n = len(SMOKE.cin_layers)
    assert (ops.LAUNCHES["cin_fused"], ops.LAUNCHES["cin_fused_bwd_w"],
            ops.LAUNCHES["cin_fused_bwd_x"]) == (n, n, n)
    want_loss, want = value_and_grad(
        lambda p: xdeepfm_loss(SMOKE, p, batch, cin_fused_plain), params)
    assert abs(float(loss) - float(want_loss)) <= 1e-5
    for k in want:
        top = float(want[k].abs().max())
        assert float((grads[k] - want[k]).abs().max()) <= 1e-3 * top, k
    assert float(grads["cin_w0"].abs().max()) > 0


@pytest.mark.parametrize("b,l,v,d", [(5, 3, 50, 8), (130, 7, 200, 130),
                                     (64, 1, 10, 16), (3, 20, 1000, 10),
                                     (9, 40, 300, 32), (4, 0, 5, 3)])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("weighted", [True, False])
def test_segment_bag_cuda_matches_plain(card, b, l, v, d, dt, weighted):
    """float32: rtol 1e-5, atol 1e-6 (float32 sums in another order).
    bfloat16: both sum in float32 and round once, so they differ by at most
    one bfloat16 rounding step: |kernel - plain| <= 2**-7 * |plain|."""
    rng = np.random.default_rng(b * 3 + l)
    dtype = getattr(torch, dt)
    table = torch.from_numpy(rng.normal(size=(v, d)).astype(np.float32)).to(dtype)
    idx = torch.from_numpy(rng.integers(-1, v, (b, l)).astype(np.int32))
    wgt = (torch.from_numpy(rng.normal(size=(b, l)).astype(np.float32)).to(dtype)
           if weighted else None)
    want = ops.segment_bag(table, idx, wgt).float()
    before = ops.LAUNCHES["segment_bag"]
    got = ops.segment_bag(table.to(card), idx.to(card),
                          None if wgt is None else wgt.to(card))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["segment_bag"] == before + 1
    assert got.dtype == dtype and got.shape == (b, d)
    got = got.cpu().float()
    if dt == "float32":
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6)
    else:
        assert ((got - want).abs() <= 2.0**-7 * want.abs()).all()


@pytest.mark.parametrize("r,k,n,w", [(64, 5, 40, 8), (256, 32, 500, 32),
                                     (33, 70, 100, 40), (7, 1, 3, 1),
                                     (100, 0, 10, 32), (300, 64, 5000, 32)])
def test_ell_pull_payload_cuda_matches_plain(card, r, k, n, w):
    """Exact; payloads over the whole int32 range, so payload + weight
    wraps."""
    rng = np.random.default_rng(r + k)
    parents = rng.integers(-1, n, size=(r, k)).astype(np.int32)
    payload = rng.integers(0, 50, size=(n, w)).astype(np.int32)
    payload[rng.random((n, w)) < 0.3] = 2**30
    payload[rng.random((n, w)) < 0.1] = 2**31 - 1
    payload[rng.random((n, w)) < 0.1] = -2**31
    weights = rng.integers(1, 16, size=(r, k)).astype(np.int32)
    active = (rng.random((r, w)) < 0.7).astype(np.int32)
    args = tuple(map(torch.from_numpy, (parents, payload, weights, active)))
    want = ops.ell_pull_payload(*args)
    before = ops.LAUNCHES["ell_pull_payload"]
    got = ops.ell_pull_payload(*(a.to(card) for a in args))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ell_pull_payload"] == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def payload_edge_inputs(rng, r, k, n, w):
    """Parents with -1 between valid slots, row 0 with all K valid, row 1
    with none, every fourth row with no active lane, payloads at the int32
    edges (so payload + weight wraps)."""
    parents = rng.integers(0, n, size=(r, k)).astype(np.int32)
    parents[rng.random((r, k)) < 0.5] = -1
    parents[0] = rng.integers(0, n, size=k)
    parents[1] = -1
    payload = rng.integers(-50, 50, size=(n, w)).astype(np.int32)
    payload[rng.random((n, w)) < 0.2] = 2**30
    payload[rng.random((n, w)) < 0.1] = 2**31 - 1
    payload[rng.random((n, w)) < 0.1] = -2**31
    weights = rng.integers(-2**31, 2**31, size=(r, k), dtype=np.int64)
    weights[rng.random((r, k)) < 0.5] //= 2**24
    active = (rng.random((r, w)) < 0.6).astype(np.int32)
    active[::4] = 0
    return parents, payload, weights.astype(np.int32), active


@pytest.mark.parametrize("k", [0, 1, 6, 12, 63, 64, 65, 128])
@pytest.mark.parametrize("w", [1, 5, 6, 8, 16, 32, 40, 64])
def test_ell_pull_payload_cuda_every_path(card, k, w):
    """Every path of the kernel, exact against the plain version: rows
    sharing a warp, lanes owning 4, 2 or 1 payload lanes (W % 4, W % 2),
    column groups (W = 64 at 4 a lane is 16 lanes; none here exceeds
    128); ids read 8, 4, 2 or 1 at a time (K % 8, K % 4, K % 2), one
    chunk or several; -1 between valid slots, full rows, empty rows, idle rows;
    one launch a call."""
    rng = np.random.default_rng(k * 100 + w)
    args = tuple(map(torch.from_numpy, payload_edge_inputs(rng, 70, k, 90, w)))
    want = ops.ell_pull_payload(*args)
    before = ops.LAUNCHES["ell_pull_payload"]
    got = ops.ell_pull_payload(*(a.to(card) for a in args))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ell_pull_payload"] == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert (want[::4] == 2**30).all()


def unaligned(t: torch.Tensor, card) -> torch.Tensor:
    """``t`` on the card as a view one element into its storage, so no
    vector load of the kernel is aligned."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=card)
    flat[1:] = t.to(card).reshape(-1)
    return flat[1:].view(t.shape)


@pytest.mark.parametrize("w", [32, 160])
def test_ell_pull_payload_cuda_unaligned_views(card, w):
    """Every input one element into its storage: the kernel reads ids,
    flags and payload one value at a time (W = 160: five column groups of
    32 lanes) and still equals the plain version."""
    rng = np.random.default_rng(3)
    args = tuple(map(torch.from_numpy, payload_edge_inputs(rng, 50, 64, 80, w)))
    want = ops.ell_pull_payload(*args)
    got = ops.ell_pull_payload(*(unaligned(a, card) for a in args))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


BAG_KINDS = {"float32": (torch.float32, torch.float32),
             "bfloat16": (torch.bfloat16, torch.bfloat16),
             "bfloat16, float32 weights": (torch.bfloat16, torch.float32),
             "float32, no weights": (torch.float32, None),
             "bfloat16, no weights": (torch.bfloat16, None)}


def bag_close(got: torch.Tensor, want: torch.Tensor, table, idx,
              wgt) -> bool:
    """Within the error of a float32 sum in another order: |kernel - plain|
    <= 1e-6 + 1e-5 sum_l |w_l row_l| (the bound scales with the summed
    magnitudes, not with |plain|, which cancellation may take to 0), plus
    2**-7 |plain| for a bfloat16 table (each rounds its float32 sum once,
    so they may differ by one bfloat16 step)."""
    got, want = got.cpu().float(), want.cpu().float()
    w = (torch.ones(idx.shape) if wgt is None else wgt.float())
    w = torch.where(idx >= 0, w, 0.0)
    mag = (table.float()[idx.clamp(min=0).long()].abs()
           * w.abs()[..., None]).sum(1)
    tol = 1e-6 + 1e-5 * mag
    if table.dtype == torch.bfloat16:
        tol = tol + 2.0**-7 * want.abs()
    return bool(((got - want).abs() <= tol).all())


@pytest.mark.parametrize("d", [3, 10, 16, 17, 32, 130])
@pytest.mark.parametrize("l", [0, 1, 8, 9, 40])
@pytest.mark.parametrize("kind", list(BAG_KINDS))
def test_segment_bag_cuda_every_path(card, d, l, kind):
    """Every path of the kernel within ``bag_close`` of the plain version
    (on the CPU): several bags a warp (D <= 16), one bag a warp, column groups
    (D = 130), row vectors of every width, slots in vectors (L % 4 == 0)
    or one by one, one chunk of 8 slots or several; -1 between valid
    slots and bags of only -1 (every third, which sum to 0); weights in
    the table's type, float32 or none; one launch a call."""
    dtype, wdtype = BAG_KINDS[kind]
    rng = np.random.default_rng(d * 100 + l)
    b, v = 75, 300
    table = torch.from_numpy(rng.normal(size=(v, d)).astype(np.float32)
                             ).to(dtype)
    idx = rng.integers(0, v, (b, l)).astype(np.int32)
    idx[rng.random((b, l)) < 0.3] = -1
    idx[::3] = -1
    idx = torch.from_numpy(idx)
    wgt = (None if wdtype is None else torch.from_numpy(
        rng.normal(size=(b, l)).astype(np.float32)).to(wdtype))
    want = ops.segment_bag(table, idx, wgt)
    before = ops.LAUNCHES["segment_bag"]
    got = ops.segment_bag(table.to(card), idx.to(card),
                          None if wgt is None else wgt.to(card))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["segment_bag"] == before + 1
    assert got.dtype == dtype and got.shape == (b, d)
    assert bag_close(got, want, table, idx, wgt)
    assert (got[::3].cpu().float() == 0).all()


@pytest.mark.parametrize("kind", ["float32", "bfloat16"])
def test_segment_bag_cuda_unaligned_views(card, kind):
    """Table, indices and weights one element into their storage: the
    kernel reads rows and slots one value at a time and stays within
    ``bag_close`` of the plain version."""
    dtype, wdtype = BAG_KINDS[kind]
    rng = np.random.default_rng(11)
    table = torch.from_numpy(rng.normal(size=(200, 16)).astype(np.float32)
                             ).to(dtype)
    idx = torch.from_numpy(rng.integers(-1, 200, (40, 8)).astype(np.int32))
    wgt = torch.from_numpy(rng.normal(size=(40, 8)).astype(np.float32)
                           ).to(wdtype)
    want = ops.segment_bag(table, idx, wgt)
    got = ops.segment_bag(unaligned(table, card), unaligned(idx, card),
                          unaligned(wgt, card))
    torch.cuda.synchronize()
    assert bag_close(got, want, table, idx, wgt)


def test_xdeepfm_on_card_equals_cpu(card):
    """SMOKE: the same parameters on the card (kernel) and on the CPU
    (plain version); logits within rtol 1e-5, atol 1e-6, one cin_fused
    launch per CIN layer."""
    cpu_model = XDeepFM(SMOKE, device="cpu", seed=4)
    card_model = XDeepFM(SMOKE, device=card, params=cpu_model.params())
    rng = np.random.default_rng(0)
    hot = rng.integers(-1, SMOKE.n_hot, (37, SMOKE.n_sparse)).astype(np.int32)
    cold = np.where(hot < 0, rng.integers(0, SMOKE.n_cold, hot.shape),
                    -1).astype(np.int32)
    hot, cold = torch.from_numpy(hot), torch.from_numpy(cold)
    want = cpu_model(hot, cold)
    ops.reset_launches()
    got = card_model(hot.to(card), cold.to(card))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["cin_fused"] == len(SMOKE.cin_layers)
    assert sum(ops.LAUNCHES.values()) == len(SMOKE.cin_layers)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_recsys_wrappers_reject_bad_inputs(card):
    x = torch.zeros((2, 3, 4), device=card)
    w = torch.zeros((5, 9), device=card)
    with pytest.raises(ValueError):
        ops.cin_fused(x.double(), x.double(), w.double())
    with pytest.raises(ValueError):
        ops.cin_fused(x.transpose(0, 1), x, w)
    with pytest.raises(ValueError):
        ops.cin_fused(x, x.cpu(), w)
    with pytest.raises(ValueError):
        ops.cin_fused_bwd_x(x, x, w, torch.zeros((2, 4, 4), device=card))
    with pytest.raises(ValueError):     # F0 = 400: no dx tiling fits
        ops.cin_fused_bwd_x(torch.zeros((2, 400, 4), device=card),
                            torch.zeros((2, 5, 4), device=card),
                            torch.zeros((3, 2000), device=card),
                            torch.zeros((2, 3, 4), device=card))
    with pytest.raises(ValueError):
        ops.cin_fused(torch.zeros((2, 400, 4), device=card),
                      torch.zeros((2, 500, 4), device=card),
                      torch.zeros((1, 200000), device=card))
    idx = torch.zeros((2, 3), dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        ops.segment_bag(torch.zeros((4, 2), device=card), idx.long())
    with pytest.raises(ValueError):
        ops.segment_bag(torch.zeros((4, 2), device=card), idx,
                        torch.zeros((2, 4), device=card))
    with pytest.raises(ValueError):
        ops.ell_pull_payload(idx, idx, idx, idx.t())


STRATEGY_COMMS = [dict(delegate=d, nn=nn) for d in ("ring", "hier")
                  for nn in ("dense", "sparse", "adaptive")]


@pytest.mark.parametrize("comm", STRATEGY_COMMS,
                         ids=lambda c: f"{c['delegate']}-{c['nn']}")
def test_strategies_msbfs_on_card_equal_cpu(card, comm):
    """The emulated msBFS under the ring / hier combines and every nn
    format (p = 4) on the card: every state leaf equals the CPU run's
    after every sweep (the adaptive format's device-side select included),
    one pull and one fold launch a sweep."""
    from repro_torch.core import msbfs as TM
    pg = partition_graph(rmat_graph(10, seed=7), th=32, p_rank=2, p_gpu=2)
    plan = TE.build_exchange_plan(pg)
    cfg = TM.MSBFSConfig(n_queries=32, max_iters=24, pull_chunk=16,
                         comm=TC.CommConfig(**comm))
    srcs = [int(s) for s in pick_sources(rmat_graph(10, seed=7), 12, seed=1)]
    views = {dev: (TB.device_view(pg, dev), TE.device_plan(plan, dev))
             for dev in (card, "cpu")}
    st = {dev: TM.init_multi_state(pg, srcs, cfg, device=dev)
          for dev in views}
    ops.reset_launches()
    sweeps = 0
    while not bool(st["cpu"].done.all()):
        for dev, (pgv, pl) in views.items():
            st[dev] = TM.msbfs_step(pgv, pl, st[dev], cfg)
        sweeps += 1
        a, b = (convert.state_to_numpy(st[d]) for d in (card, "cpu"))
        for k in TM.STATE_LEAVES:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{k} {sweeps}")
    assert sweeps >= 3
    assert ops.LAUNCHES["ell_pull_multi"] == sweeps
    assert ops.LAUNCHES["mask_reduce"] == sweeps


@pytest.mark.parametrize("nn", ["dense", "sparse", "adaptive"])
@pytest.mark.parametrize("delegate", ["allgather", "ring", "hier"])
def test_strategies_bfs_on_card_equal_cpu(card, delegate, nn):
    """The single-source step with the static bit exchange under every
    strategy and format: every leaf equal on the card and the CPU."""
    pg = partition_graph(rmat_graph(10, seed=7), th=32, p_rank=2, p_gpu=2)
    plan = TE.build_exchange_plan(pg)
    cfg = TB.BFSConfig(max_iters=24, pull_chunk=16, static_exchange=True,
                       comm=TC.CommConfig(delegate=delegate, nn=nn))
    outs = []
    for dev in (card, "cpu"):
        st = TB.run_bfs_emulated(TB.device_view(pg, dev),
                                 TB.init_state(pg, 3, cfg, device=dev), cfg,
                                 TE.device_plan(plan, dev))
        outs.append(convert.bfs_state_to_numpy(st))
    for k in TB.STATE_LEAVES:
        np.testing.assert_array_equal(outs[0][k], outs[1][k], err_msg=k)


@pytest.mark.parametrize("comm", [dict(), dict(delegate="hier"),
                                  dict(delegate="ring")],
                         ids=["allgather", "hier", "ring"])
def test_sharded_world1_nccl_equals_emulated(card, comm):
    """``make_sharded_msbfs``, its step and its block (captured: NCCL and a
    fixed nn format) on a world of one rank under NCCL, in a spawned
    process (hard timeout), each equal to the emulated run, every leaf."""
    import _torch_world as TW
    spec = dict(scale=10, seed=7, th=32, comm=comm,
                sources=[int(s) for s in pick_sources(rmat_graph(10, seed=7),
                                                      20, seed=1)])
    (res,) = TC.dist.spawn(TW.nccl_world, 1, (spec,), backend="nccl",
                           timeout=240)
    assert res["run"] == [] and res["step"] == [] and res["block"] == []
    assert res["captured"] and res["sweeps"] == 3


def test_sharded_world4_nccl_equals_emulated(card):
    """The sharded world of ``tests/test_torch_sharded.py`` on four cards
    under NCCL (one partition a card, mesh (2, 2); the blocks of the
    overlap and stream engines captured as CUDA graphs with their
    collectives): every gathered leaf, level, answer and ``ServeStats``
    field equal to the emulated run on the CPU, ``wire_delegate`` in the
    (2, 2) plan's formula; the payload cases' answers and stats too.
    Needs four cards: NCCL refuses two ranks on one device."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards (NCCL refuses two ranks on one card)")
    import _torch_world as TW
    from repro_torch.kernels import _build
    _build.build()                       # once, before the ranks load it
    spec = TW.default_spec("cuda")
    ranks = TC.dist.spawn(TW.sharded_world, 4, (spec,), backend="nccl",
                          timeout=600)
    _, pg = TW.graph(spec)
    pgv = TB.device_view(pg, "cpu")
    plan = TE.device_plan(TE.build_exchange_plan(pg), "cpu")
    port_plan = lambda comm, axes, sizes: TC.CommPlan(TC.CommConfig(**comm),
                                                      axes, sizes)
    for name, case in spec["msbfs"].items():
        TW.check_state_case(ranks, "msbfs", name, case, pg,
                            TW.run_msbfs(pg, pgv, plan, case, "cpu"),
                            port_plan)
    for name, case in spec["bfs"].items():
        TW.check_state_case(ranks, "bfs", name, case, pg,
                            TW.run_bfs(pg, pgv, plan, case, "cpu"), port_plan)
    qs = TW.queries(spec["queries"])
    for name in list(spec["engine"]) + ["batch-local"]:
        case = spec["engine"]["batch" if name == "batch-local" else name]
        want = TW.serve(TW.make_engine(pg, case, "cpu"), case["mode"], qs)
        TW.check_engine_case(ranks, name, case, want, pg, port_plan)
    _, pg8 = TW.graph(spec["payload"])
    for name, case in spec["payload"]["cases"].items():
        want = TW.serve(TW.make_engine(pg8, case, "cpu"), case["mode"],
                        TW.queries(case["queries"]))
        TW.check_engine_case(ranks, name, case, want, pg8, port_plan,
                             "payload")
    for r in ranks:
        assert r["rows"] == {(True, 1)} and r["mismatch"] is not None


# -------------------------------------------- memory and telemetry modes
MEMORY_CASES = {
    # name: (edge_chunk, nn, payload modes or None)
    "bit-ec64-dense": (64, "dense", None),
    "bit-ec1000-compressed": (1000, "compressed", None),
    "payload-ec333-compressed": (333, "compressed",
                                 ["sssp", None, "components", "sssp"] * 8),
}


@pytest.mark.parametrize("name", list(MEMORY_CASES))
def test_chunked_msbfs_on_card_equal_cpu(card, name):
    """A chunked lane batch of 32 on the card: every leaf equal to the CPU
    run's and to the card's monolithic run after every sweep (telemetry
    on), and its peak memory below the monolithic run's."""
    import dataclasses
    from repro_torch.core import msbfs as TM
    ec, nn, modes = MEMORY_CASES[name]
    g = rmat_graph(12, seed=7)
    pg = partition_graph(g, th=32, p_rank=1, p_gpu=2)
    plan = TE.build_exchange_plan(pg)
    cfg = TM.MSBFSConfig(n_queries=32, max_iters=96 if modes else 32,
                         payload=modes is not None, telemetry=True,
                         edge_chunk=ec, comm=TC.CommConfig(nn=nn))
    runs = {"card": (card, cfg), "cpu": ("cpu", cfg),
            "mono": (card, dataclasses.replace(cfg, edge_chunk=0))}
    views = {dev: (TB.device_view(pg, dev), TE.device_plan(plan, dev))
             for dev in (card, "cpu")}
    srcs = [int(s) for s in pick_sources(g, 32, seed=4)]
    st = {k: TM.init_multi_state(pg, srcs, c, payload_modes=modes, device=d)
          for k, (d, c) in runs.items()}
    peaks = {}
    sweeps = 0
    while not bool(st["cpu"].done.all()):
        for k, (d, c) in runs.items():
            if d != "cpu":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
            st[k] = TM.msbfs_step(*views[d], st[k], c)
            if d != "cpu":
                torch.cuda.synchronize()
                peaks[k] = max(peaks.get(k, 0),
                               torch.cuda.max_memory_allocated() - base)
        sweeps += 1
        want = convert.state_to_numpy(st["cpu"])
        for k in ("card", "mono"):
            got = convert.state_to_numpy(st[k])
            for leaf in TM.STATE_LEAVES:
                np.testing.assert_array_equal(got[leaf], want[leaf],
                                              err_msg=f"{k} {leaf} {sweeps}")
    assert sweeps >= 3 and int(st["cpu"].tm_frontier_n.sum()) > 0
    assert peaks["card"] < peaks["mono"], peaks


@pytest.mark.parametrize("static_exchange", [True, False])
def test_chunked_bfs_on_card_equal_cpu(card, static_exchange):
    g = rmat_graph(11, seed=7)
    pg = partition_graph(g, th=32, p_rank=2, p_gpu=2)
    plan = TE.build_exchange_plan(pg)
    cfg = TB.BFSConfig(max_iters=32, edge_chunk=100, telemetry=True,
                       static_exchange=static_exchange,
                       comm=TC.CommConfig(nn="compressed"))
    outs = []
    for dev in (card, "cpu"):
        st = TB.run_bfs_emulated(
            TB.device_view(pg, dev), TB.init_state(pg, 3, cfg, device=dev),
            cfg, TE.device_plan(plan, dev) if static_exchange else None)
        outs.append(convert.bfs_state_to_numpy(st))
    for k in TB.STATE_LEAVES:
        np.testing.assert_array_equal(outs[0][k], outs[1][k], err_msg=k)
    assert outs[0]["tm_frontier_n"].sum() > 0


def test_telemetry_chunked_graph_block_equals_eager(card):
    """A captured block of a chunked, compressed, telemetry config (its
    block loops and codec inside the graph) equals the same sweeps run
    eagerly, and replays count their launches in ``ops.REPLAYED``."""
    from repro_torch.core import msbfs as TM
    pg, _, _ = tailed_setup()
    eng = serve_engine(pg, card)
    cfg = TM.MSBFSConfig(n_queries=4, max_iters=96, enable_targets=False,
                         edge_chunk=50, telemetry=True,
                         comm=TC.CommConfig(nn="compressed"))
    st = TM.init_multi_state(pg, [5, 3, 9, 11], cfg, device=card)
    ops.reset_launches()
    blk = TM.make_msbfs_block_emulated(cfg, 3)
    run = blk(eng.pgv, eng.plan, st, np.zeros(4, dtype=bool))
    run.wait()
    blk.runner.drain()
    assert blk.runner.graphs is not None
    assert ops.REPLAYED["ell_pull_multi"] == 3
    ref = st
    for _ in range(3):
        ref = TM.msbfs_step(eng.pgv, eng.plan, ref, cfg)
    a, b = convert.state_to_numpy(run.out), convert.state_to_numpy(ref)
    for k in TM.STATE_LEAVES:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert int(b["tm_frontier_n"].sum()) > 0


@pytest.mark.parametrize("overlap", [False, True])
def test_chunked_compressed_engine_on_card_equals_cpu(card, overlap):
    """The refill engine (overlapped: captured blocks) with ``edge_chunk``
    under the compressed nn format and a telemetry cfg: answers and every
    ServeStats field equal to the CPU engine's."""
    from repro_torch.core import msbfs as TM
    pg, _, qs = tailed_setup()
    runs = []
    for dev in (card, "cpu"):
        eng = BFSServeEngine(
            pg=pg, cfg=TM.MSBFSConfig(n_queries=4, max_iters=96,
                                      telemetry=True),
            comm=TC.CommConfig(nn="compressed"), edge_chunk=77,
            cache_capacity=0, refill=True, overlap=overlap, sweep_block=4,
            device=dev)
        if overlap and dev != "cpu":
            eng.warmup(reachability=True, targets=True)
        runs.append((eng.submit_many(qs), eng.stats.as_dict()))
    assert_answers_equal(runs[0][0], runs[1][0])
    assert runs[0][1] == runs[1][1] and runs[0][1]["wire_nn_bytes"] > 0


def test_decoded_tile_feeds_b1_on_card(card):
    """Partition 0's nd rows decoded from the compressed partition into an
    ELL tile feed B1 on the card (one counted launch): equal to the plain
    version on the same tile and words."""
    from repro_torch.core import partition as P
    pg = partition_graph(rmat_graph(11, seed=7), th=32, p_rank=1, p_gpu=2)
    ccsr = P.compress_partition(pg).nd
    k_max = int(np.diff(np.asarray(pg.nd.offsets)[0]).max()) + 1
    tile = torch.from_numpy(P.decode_ell_tile(ccsr, 0, 0, pg.n_local, k_max))
    rng = np.random.default_rng(3)
    fw, aw = words(rng, (max(pg.d, 1), 1)), words(rng, (pg.n_local, 1))
    want = ops.ell_pull_multi(tile, fw, aw)
    ops.reset_launches()
    got = ops.ell_pull_multi(tile.to(card), fw.to(card), aw.to(card))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ell_pull_multi"] == 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert (want != 0).any()


# ------------------------------------------------- observability, frontend
def test_dispatch_profiler_samples_on_cuda_events(card):
    """A sampled dispatch waits for the work the call put on the stream
    (an event recorded after it, synchronized): its time is at least the
    work's own event time, and an unsampled dispatch returns at once."""
    from repro_torch.obs import DispatchProfiler

    a = torch.randn(2048, 2048, device=card)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def work():
        ev[0].record()
        out = a
        for _ in range(20):
            out = out @ a
        ev[1].record()
        return (out, out.sum())

    work()
    torch.cuda.synchronize()
    prof = DispatchProfiler(sample_rate=0.5)
    for i in range(4):
        out = prof.timed("mm", work)
        if i % 2 == 0:                 # sampled: the work is done
            assert ev[1].query()
            work_s = ev[0].elapsed_time(ev[1]) / 1e3
            h = prof._hists["mm"]
            assert h.count == i // 2 + 1 and h.max >= work_s > 0
    torch.cuda.synchronize()
    assert prof.sampled == 2 and prof.dispatches == 4
    assert isinstance(out, tuple)


def test_trace_session_writes_a_trace(card, tmp_path):
    """One ``trace_session()`` starts a ``torch.profiler`` capture and
    writes a Chrome trace into ``trace_dir`` that holds device work."""
    import json
    from repro_torch.obs import DispatchProfiler

    prof = DispatchProfiler(trace_dir=str(tmp_path))
    a = torch.randn(512, 512, device=card)
    assert prof.start_trace() is True
    assert prof.start_trace() is False            # already tracing
    (a @ a).sum().item()
    prof.stop_trace()
    with prof.trace_session():
        (a @ a).sum().item()
    assert prof.trace_path is not None and prof.trace_path.endswith("_2.json")
    doc = json.loads(open(prof.trace_path).read())
    assert any(e.get("cat") == "kernel" for e in doc["traceEvents"])
    assert len(list(tmp_path.glob("*.json"))) == 2


def shifted_tailed_setup():
    """tailed_setup's graph and its ``v -> (v + 4) % n`` relabelling, both
    partitioned (2, 2) at th=32, with the four-kind stream."""
    from repro_torch.core.types import COOGraph
    from repro_torch.graphs.synthetic import with_tails
    core = rmat_graph(8, seed=11)
    g, _ = with_tails(core, n_tails=2, length=24, seed=2)
    g2 = COOGraph(g.n, (g.src + 4) % g.n, (g.dst + 4) % g.n)
    pg, tips, qs = tailed_setup()
    return pg, partition_graph(g2, th=32, p_rank=2, p_gpu=2), qs


def stream_runs(engines, qs, interleave: bool) -> list:
    """Each engine's stream of ``qs`` (chunks of 4, ``poll()`` after each,
    then ``drain_stream()``): the engines' chunks in turns (their sessions
    in flight at once), or each engine's whole stream before the next.
    Returns each engine's deliveries, in order."""
    out = [[] for _ in engines]
    chunks = [qs[i:i + 4] for i in range(0, len(qs), 4)]
    order = ([(i, c) for c in range(len(chunks)) for i in range(len(engines))]
             if interleave else
             [(i, c) for i in range(len(engines)) for c in range(len(chunks))])
    for i, c in order:
        engines[i].submit_stream(chunks[c])
        out[i].append(engines[i].poll())
    for i, eng in enumerate(engines):
        out[i].append(eng.drain_stream())
    return out


def test_engines_sharing_a_pool_interleave_like_back_to_back(card):
    """Two engines on different graphs share one runner_cache, so their
    captured blocks share one graph memory pool; their overlapped stream
    sessions, in flight at once, deliver the same queries and answers, in
    the same polls, with the same ServeStats, as the same streams run back
    to back on engines with private pools, and as on the CPU."""
    pg1, pg2, qs = shifted_tailed_setup()
    shared: dict = {}
    mk = lambda pg, dev, rc: serve_engine(pg, dev, overlap=True,
                                          sweep_block=4, runner_cache=rc)
    pooled = [mk(pg, card, shared) for pg in (pg1, pg2)]
    for eng in pooled:
        eng.warmup(reachability=True, targets=True)
    alone = [mk(pg, card, None) for pg in (pg1, pg2)]
    cpu = [mk(pg, "cpu", None) for pg in (pg1, pg2)]
    got = stream_runs(pooled, qs, interleave=True)
    runs = [stream_runs(alone, qs, interleave=False),
            stream_runs(cpu, qs, interleave=False)]
    pools = {id(b.pool) for e in pooled for b in e.blocks.values()}
    assert list(shared) == ["graph_pool"] and len(pools) == 1
    assert all(b.runner.graphs is not None for e in pooled
               for b in e.blocks.values())
    for want, engines in zip(runs, (alone, cpu)):
        for i in range(2):
            assert [list(d) for d in got[i]] == [list(d) for d in want[i]]
            for x, y in zip(got[i], want[i]):
                assert_answers_equal(list(x.values()), list(y.values()))
            assert pooled[i].stats.as_dict() == engines[i].stats.as_dict()


def test_obs_on_and_off_give_equal_counters_on_card(card):
    """Two engines with telemetry, one with obs and the profiler on and
    one bare, on the card, overlapped (captured blocks): equal answers,
    ServeStats, kernel launches and replays, dispatched and gated sweeps;
    the harvested per-shard wire bytes sum to the stats' wire counters."""
    from repro_torch.core import msbfs as TM
    from repro_torch.obs import Observability
    pg, _, qs = tailed_setup()
    runs = []
    for on in (True, False):
        kw = dict(obs=Observability(), profile=True) if on else {}
        eng = BFSServeEngine(pg=pg, cfg=TM.MSBFSConfig(
            n_queries=4, max_iters=96, telemetry=True), cache_capacity=0,
            refill=True, overlap=True, sweep_block=4, device=card, **kw)
        eng.warmup(reachability=True, targets=True)
        torch.cuda.synchronize()
        ops.reset_launches()
        answers = eng.submit_many(qs)
        torch.cuda.synchronize()
        blocks = {k: (b.runner.sweeps, b.runner.gated)
                  for k, b in eng.blocks.items()}
        runs.append((answers, eng.stats.as_dict(), dict(ops.LAUNCHES),
                     dict(ops.REPLAYED), blocks, eng))
    (a1, s1, l1, r1, b1, on), (a0, s0, l0, r0, b0, _) = runs
    assert_answers_equal(a1, a0)
    assert s1 == s0 and l1 == l0 and r1 == r0 and b1 == b0
    assert r1["ell_pull_multi"] > 0 and on.profiler.sampled > 0
    tel = on.last_telemetry
    assert int(tel.shard_wire_bytes().sum()) == \
        s1["wire_delegate_bytes"] + s1["wire_nn_bytes"]


@pytest.mark.parametrize("opt_name", ["sgd", "adamw"])
def test_gcn_train_step_on_card_equals_cpu(card, opt_name):
    """One distributed GCN training step (4 emulated partitions) on the
    card equals the same step on the CPU: loss within rtol 1e-5, parameters
    and optimizer moments within rtol 1e-4, atol 1e-6 (float32 scatter-adds
    summed in another order by the card's atomics)."""
    from repro_torch.graphs.synthetic import cora_like
    from repro_torch.models import gnn as G
    from repro_torch.models.common import materialize
    from repro_torch.train import gnn_batches as GB, gnn_dist as GD
    from repro_torch.train.optim import get_optimizer
    from repro_torch.tree import flatten_with_path

    g, feats, labels, mask = cora_like(n=512, avg_deg=6, d_feat=64, seed=0)
    pg = partition_graph(g, th=24, p_rank=2, p_gpu=2)
    hplan = TE.build_exchange_plan(pg)
    hw = TE.build_edge_weights(pg, g.out_degrees(), "sym")
    cfg = G.GCNConfig(n_layers=2, d_in=64, d_hidden=32, n_classes=7)
    opt = get_optimizer(opt_name, lr=5e-2)
    out = {}
    for dev in ("cpu", card):
        pgv, plan = TB.device_view(pg, dev), TE.device_plan(hplan, dev)
        w = TE.device_weights(hw, dev)
        batch = GB.batch_to_device(GB.gcn_batch(pg, feats, labels, mask), dev)
        params = materialize(G.gcn_param_specs(cfg), 0, dev)
        step = GD.make_dist_train_step(
            lambda prm, bt: GD.dist_gcn_loss(cfg, prm, pgv, plan, w, bt), opt)
        p, st, loss = step(params, opt.init(params), batch)
        out[str(dev)] = (float(loss), convert.tree_to_numpy({"p": p, "st": st}))
    (l0, t0), (l1, t1) = out["cpu"], out[str(card)]
    np.testing.assert_allclose(l1, l0, rtol=1e-5)
    want = dict(flatten_with_path(t0))
    for k, v in flatten_with_path(t1):
        np.testing.assert_allclose(v, want[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_sharded_recsys_step_world1_nccl_equals_one_card(card):
    """The sharded xDeepFM step (cold rows through the variable
    all-to-alls, the replicated leaves' all-reduce, the global clip) on a
    world of one rank under NCCL, in a spawned process, equals the
    one-card step after 3 AdamW steps, on SMOKE, on the ragged copy and
    with a clip below the gradient norm: losses rtol 1e-5, parameters
    rtol 1e-4, atol 1e-6 (float32 scatter-adds summed in another order by
    the card's atomics)."""
    import _torch_recsys_world as RW
    names = ("smoke", "ragged", "clip")
    (res,) = TC.dist.spawn(RW.one_rank_world, 1, (names,),
                           backend="nccl", timeout=240)
    for name in names:
        got, want = res[(name, "sharded")], res[(name, "one_card")]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        for k, v in want["params"].items():
            np.testing.assert_allclose(got["params"][k], v, rtol=1e-4,
                                       atol=1e-6, err_msg=f"{name} {k}")


@pytest.mark.parametrize("d_hidden", [8, 32])
def test_mace_on_card_equals_cpu(card, d_hidden):
    """MACE's loss and every gradient leaf on the card equal the CPU's
    (molecule_batch(3, 30, 64, 10)): the loss within rtol 1e-5, each leaf
    within 1e-4 of its largest |g| (float32 sums in another order; TF32
    off), unreached leaves 0 on both; and the distributed loss over 2
    emulated partitions on the card equals the CPU's, with the full and
    the positions-only fetch, within rtol 1e-5."""
    from repro_torch.core.types import COOGraph
    from repro_torch.graphs.synthetic import molecule_batch
    from repro_torch.models import equivariant as EQ, gnn as G
    from repro_torch.models.common import materialize
    from repro_torch.train import gnn_batches as GB, gnn_dist as GD
    from repro_torch.train.trainer import value_and_grad
    from repro_torch.tree import flatten_with_path

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = EQ.MACEConfig(n_layers=2, d_hidden=d_hidden, n_rbf=8, n_species=10)
    gb, energies = molecule_batch(3, 30, 64, 10, seed=2)
    valid = gb.senders < gb.nodes.shape[0]
    pg = partition_graph(COOGraph(gb.nodes.shape[0],
                                  gb.senders[valid].astype(np.int64),
                                  gb.receivers[valid].astype(np.int64)),
                         th=5, p_rank=1, p_gpu=2)
    hplan = TE.build_exchange_plan(pg)
    out = {}
    for dev in ("cpu", card):
        params = materialize(EQ.mace_param_specs(cfg), 0, dev)
        b = G.batch_to(gb, dev)
        e = torch.from_numpy(energies).to(dev)
        loss, grads = value_and_grad(lambda p: EQ.mace_loss(cfg, p, b, e),
                                     params)
        pgv, plan = TB.device_view(pg, dev), TE.device_plan(hplan, dev)
        batch = GB.batch_to_device(GB.mace_batch(pg, gb.positions, gb.species,
                                                 1.0), dev)
        with torch.no_grad():
            dist = [float(GD.dist_mace_loss(
                EQ.MACEConfig(**{**vars(cfg), "dist_fetch_pos_only": po}),
                params, pgv, plan, batch)) for po in (False, True)]
        out[str(dev)] = (float(loss), dict(flatten_with_path(
            convert.tree_to_numpy(grads))), dist)
    (l0, g0, d0), (l1, g1, d1) = out["cpu"], out[str(card)]
    np.testing.assert_allclose(l1, l0, rtol=1e-5)
    np.testing.assert_allclose(d1, d0, rtol=1e-5)
    for k, want in g0.items():
        top = float(np.abs(want).max())
        assert float(np.abs(g1[k] - want).max()) <= 1e-4 * top, k


@pytest.mark.parametrize("arch", ["gemma3-1b", "granite-34b", "kimi-k2-1t-a32b",
                                  "qwen2.5-14b", "qwen2-moe-a2.7b"])
def test_smoke_lm_on_card_equals_cpu(card, arch):
    """A smoke LM config (float32, TF32 off) on the card against the CPU,
    the same weights: logits within 1e-5 + 1e-4 |logit|, the loss within
    rtol 1e-5, each gradient leaf within 1e-3 of its largest |g|; prefill
    (``last_only``) of a 12-token prompt (past gemma's window of 8) and 8
    greedy decode steps give the same tokens."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models import lm as TL
    from repro_torch.models.common import materialize
    from repro_torch.train.trainer import value_and_grad
    from repro_torch.tree import flatten_with_path, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(arch).smoke
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 17)).astype(np.int32))
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32))
    params = materialize(TL.lm_param_specs(cfg), 0, "cpu")
    out = {}
    for dev in ("cpu", card):
        p = tree_map(lambda t: t.to(dev), params)
        batch = {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}
        with torch.no_grad():
            logits, _ = TL.forward(cfg, p, batch["tokens"])
        (loss, _), grads = value_and_grad(lambda q: TL.loss_fn(cfg, q, batch), p,
                                          has_aux=True)
        last, cache = TL.prefill(cfg, p, prompts.to(dev), max_seq=20, last_only=True)
        tok, gen = last[:, -1].argmax(-1), []
        for i in range(8):
            gen.append(tok.cpu())
            step, cache = TL.decode_step(cfg, p, cache, tok, 12 + i)
            tok = step.argmax(-1)
        out[str(dev)] = (logits.cpu(), float(loss),
                         {k: g.cpu() for k, g in flatten_with_path(grads)},
                         torch.stack(gen + [tok.cpu()]))
    (l0, s0, g0, t0), (l1, s1, g1, t1) = out["cpu"], out[str(card)]
    np.testing.assert_allclose(l1.numpy(), l0.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(s1, s0, rtol=1e-5)
    for k, want in g0.items():
        assert float((g1[k] - want).abs().max()) <= 1e-3 * float(want.abs().max()), k
    assert torch.equal(t1, t0)


# ------------------------------------------------------- the LM on a mesh
def test_lm_mesh_world1_nccl_equals_one_card(card):
    """The LM mesh step (``launch.cells.build_lm_cell``) on a world of one
    rank under NCCL, in a spawned process, equals the one-card step after
    2 steps on smoke specs (MoE with AdamW, MoE with Adafactor, dense GELU
    with Adafactor; float32, TF32 off): losses rtol 1e-5, each parameter
    leaf within 1e-3 of its change in the L2 norm."""
    import _torch_lm_world as LW
    from repro_torch.tree import flatten_with_path

    (res,) = TC.dist.spawn(LW.one_rank_world, 1, (LW.CARD_ARCHS,),
                           backend="nccl", timeout=300)
    for arch in LW.CARD_ARCHS:
        got, want = res[arch, "mesh"], res[arch, "one"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        start = dict(flatten_with_path(res[arch, "start"]))
        w = dict(flatten_with_path(want["params"]))
        for k, g in flatten_with_path(got["params"]):
            moved = float(np.linalg.norm((w[k] - start[k]).astype(np.float64)))
            diff = float(np.linalg.norm((g - w[k]).astype(np.float64)))
            assert diff <= 1e-3 * moved, (arch, k, diff, moved)


def test_lm_serve_cells_world1_nccl_equal_one_card(card):
    """gemma3-1b's prefill and decode cells (``launch.cells.build_cell``,
    smoke, float32, TF32 off) on a world of one rank under NCCL, in a
    spawned process, equal the one-card path (``models.lm`` without
    ``par``) on the same drawn arguments: logits and caches within rtol
    1e-5 and 1e-6 of the largest |value|."""
    import _torch_lm_serve_world as SW
    from repro_torch.tree import flatten_with_path

    (res,) = TC.dist.spawn(SW.one_rank_cells, 1, (), backend="nccl",
                           timeout=300)
    for shape in ("prefill_32k", "decode_32k"):
        got, want = res[shape]["cell"], res[shape]["one"]
        for (k, g), (_, w) in zip(flatten_with_path(got),
                                  flatten_with_path(want)):
            scale = max(float(np.abs(w).max()), 1.0)
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6 * scale,
                                       err_msg=f"{shape} {k}")


#: a bfloat16 mesh step against the one-card step at FULL widths: the loss
#: within 1e-4 of it (relative; read 2e-7 to 5.1e-5 with the one-card
#: rerun's spread, NVIDIA H100 80GB HBM3, 700.00 W) and each leaf's change
#: within 0.35 of the one-card step's in L2 (read 0.03 to 0.17, a rerun of
#: the one-card step alike: the split products' partial sums round before
#: the all-reduce, and the MoE combine's bfloat16 index_add rounds in the
#: atomics' order)
MESH_LOSS_REL, MESH_SHARE_MAX = 1e-4, 0.35


def test_lm_mesh_world4_nccl(card):
    """qwen2-moe-a2.7b at FULL widths, 2 of its 24 layers, B = 2, S =
    4,096 (bfloat16, AdamW from step 100) on the mesh (data 2, model 2)
    under NCCL, one card a rank: each rank's loss equals the one-card step
    (run on each rank's card first) within MESH_LOSS_REL of it, each
    leaf's change within MESH_SHARE_MAX of the one-card step's (L2), each
    rank's wire bytes equal the count from shapes; ms a step printed.
    Needs four cards: NCCL refuses two ranks on one device."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards (NCCL refuses two ranks on one card)")
    import math

    import _torch_lm_world as LW

    spec = {"arch": "qwen2-moe-a2.7b", "layers": 2, "sizes": (2, 2),
            "batch": 2, "seq": 4096, "from": 100, "timed": 3}
    ranks = TC.dist.spawn(LW.full_width_rank, 4, (spec,), backend="nccl",
                          timeout=900)
    for r in ranks:
        assert math.isfinite(r["loss"])
        assert abs(r["loss"] - r["one_loss"]) <= (MESH_LOSS_REL
                                                  * abs(r["one_loss"]))
        assert r["wire"] == r["reckoned"]
    shares = {}
    for k, (d, m) in ranks[0]["sq"].items():
        if ranks[0]["sharded"][k]:
            d = sum(r["sq"][k][0] for r in ranks)
            m = sum(r["sq"][k][1] for r in ranks)
        assert m > 0 and math.isfinite(d), k
        shares[k] = math.sqrt(d / m)
    print(f"lm mesh world 4 NCCL: losses {[r['loss'] for r in ranks]}, one "
          f"card {[r['one_loss'] for r in ranks]}; ms a step "
          f"{[[round(x, 2) for x in r['ms']] for r in ranks]}; peak "
          f"{[round(r['peak'] / 2**30, 3) for r in ranks]} GiB; wire "
          f"{ranks[0]['wire']}; each leaf's change against the one-card "
          f"step's (L2): {dict(sorted(shares.items(), key=lambda kv: -kv[1]))}")
    assert max(shares.values()) <= MESH_SHARE_MAX, shares
