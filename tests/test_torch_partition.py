"""The port's host data plane against the reference package: RMAT graphs,
every partition and exchange-plan array (values and dtypes), graph ids,
the numpy oracle, and the ``convert`` round trip."""
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import engine as RE, oracle as RO
from repro.core.partition import partition_graph as ref_partition
from repro.graphs import rmat as RR
from repro.serve.engine import default_graph_id as ref_graph_id
from repro_torch.core import bfs as TB, convert, engine as TE, msbfs as TM
from repro_torch.core import oracle as TO
from repro_torch.core.partition import partition_graph
from repro_torch.graphs import rmat as TR
from repro_torch.serve.engine import default_graph_id

GEOMS = [(16, 1, 1), (16, 2, 2), (64, 1, 1), (64, 2, 2)]


@pytest.fixture(scope="module")
def graphs():
    return RR.rmat_graph(10, seed=7), TR.rmat_graph(10, seed=7)


def assert_arrays_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("scale,seed", [(9, 0), (10, 7)])
def test_rmat_edges_and_sources_equal(scale, seed):
    r, t = RR.rmat_edges(scale, seed=seed), TR.rmat_edges(scale, seed=seed)
    assert r.n == t.n
    np.testing.assert_array_equal(r.src, t.src)
    np.testing.assert_array_equal(r.dst, t.dst)
    rg, tg = RR.rmat_graph(scale, seed=seed), TR.rmat_graph(scale, seed=seed)
    np.testing.assert_array_equal(rg.src, tg.src)
    np.testing.assert_array_equal(
        RR.pick_sources(rg, 9, seed=3), TR.pick_sources(tg, 9, seed=3))


@pytest.mark.parametrize("th,p_rank,p_gpu", GEOMS)
def test_partition_plan_and_graph_id_equal(graphs, th, p_rank, p_gpu):
    rg, tg = graphs
    rpg = ref_partition(rg, th=th, p_rank=p_rank, p_gpu=p_gpu)
    tpg = partition_graph(tg, th=th, p_rank=p_rank, p_gpu=p_gpu)
    ra, rm = convert.partition_to_arrays(rpg)
    ta, tm = convert.partition_to_arrays(tpg)
    assert rm == tm
    assert_arrays_equal(ra, ta)
    rpa, rpm = convert.plan_to_arrays(RE.build_exchange_plan(rpg))
    tpa, tpm = convert.plan_to_arrays(TE.build_exchange_plan(tpg))
    assert rpm == tpm
    assert_arrays_equal(rpa, tpa)
    assert default_graph_id(tpg) == ref_graph_id(rpg)


@pytest.mark.parametrize("th,p_rank,p_gpu", GEOMS[1::2])
def test_convert_round_trip(graphs, th, p_rank, p_gpu):
    """The reference's partition and plan, carried over as numpy leaves,
    rebuild the port's objects exactly (and back)."""
    rg, tg = graphs
    rpg = ref_partition(rg, th=th, p_rank=p_rank, p_gpu=p_gpu)
    arrays, meta = convert.partition_to_arrays(rpg)
    pg = convert.partition_from_arrays(arrays, meta)
    assert_arrays_equal(convert.partition_to_arrays(pg)[0], arrays)
    assert convert.partition_to_arrays(pg)[1] == meta
    assert default_graph_id(pg) == ref_graph_id(rpg)
    parrays, pmeta = convert.plan_to_arrays(RE.build_exchange_plan(rpg))
    plan = convert.plan_from_arrays(parrays, pmeta)
    assert_arrays_equal(convert.plan_to_arrays(plan)[0], parrays)
    assert_arrays_equal(convert.plan_to_arrays(TE.build_exchange_plan(pg))[0],
                        parrays)
    st = TM.init_multi_state(pg, [1, 2], TM.MSBFSConfig(), device="cpu")
    leaves = convert.state_to_numpy(st)
    assert tuple(leaves) == TM.STATE_LEAVES
    assert all(isinstance(v, np.ndarray) for v in leaves.values())


def test_device_view_flat_indices(graphs):
    _, tg = graphs
    pg = partition_graph(tg, th=32, p_rank=2, p_gpu=2)
    pgv = TB.device_view(pg, "cpu")
    for kind, n_dst in (("dd", pg.d), ("nd", pg.d), ("dn", pg.n_local)):
        csr, dcsr = pg.subgraph(kind), pgv.subgraph(kind)
        k = np.arange(pg.p)[:, None]
        np.testing.assert_array_equal(
            dcsr.flat_rows.numpy(),
            (np.asarray(csr.rowids) + k * (csr.n_rows + 1)).reshape(-1))
        np.testing.assert_array_equal(
            dcsr.flat_cols.numpy(),
            (np.asarray(csr.cols) + k * n_dst).reshape(-1))
        assert dcsr.offsets.dtype == torch.int32
    assert tuple(pgv.delegate_vids.shape) == (pg.p, pg.d)


def test_oracle_matches_reference(graphs):
    rg, tg = graphs
    csr = TO.csr_from_coo(tg)
    for s in RR.pick_sources(rg, 4, seed=2):
        np.testing.assert_array_equal(TO.bfs_levels(tg, int(s)),
                                      RO.bfs_levels(rg, int(s)))
        np.testing.assert_array_equal(TO.bfs_levels(tg, int(s), csr),
                                      RO.bfs_levels(rg, int(s)))
        np.testing.assert_array_equal(TO.reachable_mask(tg, int(s), csr),
                                      RO.reachable_mask(rg, int(s)))
        np.testing.assert_array_equal(
            TO.bfs_levels_limited(tg, int(s), 2, csr),
            RO.bfs_levels_limited(rg, int(s), 2))
        assert TO.target_depths(tg, int(s), [1, 5, 9], csr) == \
            RO.target_depths(rg, int(s), [1, 5, 9])
