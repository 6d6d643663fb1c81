"""The port's CUDA kernels and serving path on the card, held against the
plain PyTorch versions on the same inputs (exact equality: every compared
quantity is an integer). Every test here needs an NVIDIA GPU and ``nvcc``
and skips without one; the file imports no JAX, so it runs on a machine
that has PyTorch for CUDA only:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import bfs as TB, comm as TC, convert, engine as TE
from repro_torch.core.partition import partition_graph
from repro_torch.graphs.rmat import pick_sources, rmat_graph
from repro_torch.kernels import ops
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
                                      (40, 70, 300, 4)])
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
                                   (300, 7, 333), (1, 1, 32), (40, 1100, 64)])
def test_ell_pull_cuda_matches_plain(card, r, w, n):
    rng = np.random.default_rng(r * 1000 + w)
    parents = torch.from_numpy(rng.integers(-1, n, (r, w)).astype(np.int32))
    mask = TC.pack_lanes(torch.from_numpy(rng.random(n) < 0.3))
    active = torch.from_numpy(rng.integers(0, 2, r).astype(np.int32))
    want = ops.ell_pull(parents, mask, active)
    got = ops.ell_pull(parents.to(card), mask.to(card), active.to(card))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


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


@pytest.mark.parametrize("kw", [
    dict(), dict(cap_nn=-4, delegate_u8=True),
    dict(static_exchange=True, delegate_u8=True),
    dict(comm=TC.CommConfig(delegate="allgather"))])
def test_single_source_bfs_on_card_equals_cpu(card, kw):
    """A scale-10 single-source BFS: every BFSState leaf equal between the
    card (kernels) and the CPU (plain versions)."""
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
    assert la["ell_pull"] == 3 * sweeps and lb["ell_pull"] == 0
    assert la["payload_min_fold"] == (sweeps if "comm" in kw else 0)
    assert la["ell_pull_multi"] == la["mask_reduce"] == 0


def test_wrappers_reject_bad_inputs(card):
    parts = torch.zeros((2, 8), dtype=torch.int64, device=card)
    with pytest.raises(ValueError):
        ops.mask_reduce(parts, torch.zeros(8, dtype=torch.int64, device=card))
    with pytest.raises(ValueError):
        ops.mask_reduce(torch.zeros((2, 8), dtype=torch.int32),
                        torch.zeros(8, dtype=torch.int32, device=card))


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
