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

from repro_torch.core import comm as TC
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
