"""The port's generalized propagation engine (``core/engine.py``), its
host builders and the GNN data generators, against the JAX reference on
the same inputs.

The graph is the reference GNN tests' own (``cora_like(n=96, avg_deg=4,
d_feat=12, seed=3)`` over ``partition_graph(th=10, p_rank=2, p_gpu=2)``);
each JAX reference is computed once, in a module fixture. Exact: the
generators' arrays, ``partition_edge_values``, ``scatter_features`` /
``gather_features``, ``edge_valid_masks``, ``build_edge_weights``,
``fetch_nn_dst`` and ``edge_endpoints`` (gathers) and
``payload_round_bytes``. ``propagate`` / ``aggregate_messages`` (float
sums): ``rtol=1e-5, atol=1e-6``."""
import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from repro.core import bfs as RB, comm as RC, engine as RE
from repro.core.partition import partition_edge_values as ref_edge_values
from repro.core.partition import partition_graph as ref_partition
from repro.graphs import synthetic as RS
from repro_torch.core import bfs as TB, comm as TC, convert, engine as TE
from repro_torch.core.partition import partition_edge_values
from repro_torch.core.types import PartitionLayout
from repro_torch.graphs import synthetic as TS

SUBGRAPHS = ("nn", "nd", "dn", "dd")
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def setup():
    g, feats, labels, mask = RS.cora_like(n=96, avg_deg=4, d_feat=12, seed=3)
    rpg = ref_partition(g, th=10, p_rank=2, p_gpu=2)
    pg = convert.partition_from_arrays(*convert.partition_to_arrays(rpg))
    hplan = TE.build_exchange_plan(pg)
    return dict(g=g, feats=feats, rpg=rpg, rpgv=RB.device_view(rpg),
                rplan=RE.build_exchange_plan(rpg), pg=pg,
                pgv=TB.device_view(pg, "cpu"), hplan=hplan,
                plan=TE.device_plan(hplan, "cpu"))


def vmapped(fn):
    return jax.jit(jax.vmap(fn, axis_name="p"))


@pytest.fixture(scope="module")
def ref(setup):
    """Every reference engine output the tests compare with, once."""
    s = setup
    rw = RE.build_edge_weights(s["rpg"], s["g"].out_degrees(), "sym")
    x_n, x_d = RE.scatter_features(s["rpg"], s["feats"])
    p = s["rpg"].p
    xd = np.broadcast_to(x_d, (p,) + x_d.shape).copy()
    rng = np.random.default_rng(0)
    msgs = {k: rng.normal(size=(p, getattr(s["rpg"], k).e_max, 5)
                          ).astype(np.float32) for k in SUBGRAPHS}
    prop = vmapped(lambda pgl, pl, wl, xn, xdd: RE.propagate(
        pgl, pl, wl, xn, xdd, "p"))(s["rpgv"], s["rplan"], rw,
                                    jnp.asarray(x_n), jnp.asarray(xd))
    agg = vmapped(lambda pgl, pl, m: RE.aggregate_messages(pgl, pl, m, "p"))(
        s["rpgv"], s["rplan"], jax.tree.map(jnp.asarray, msgs))
    ends = vmapped(lambda pgl, pl, xn, xdd: RE.edge_endpoints(
        pgl, pl, xn, xdd, "p"))(s["rpgv"], s["rplan"], jnp.asarray(x_n),
                                jnp.asarray(xd))
    return dict(x_n=x_n, xd=xd, msgs=msgs,
                prop=jax.tree.map(np.asarray, prop),
                agg=jax.tree.map(np.asarray, agg),
                ends=jax.tree.map(np.asarray, ends))


def port_weights(setup, mode="sym"):
    return TE.device_weights(TE.build_edge_weights(
        setup["pg"], setup["g"].out_degrees(), mode), "cpu")


def t(a):
    return torch.from_numpy(np.asarray(a))


# --------------------------------------------------------------- generators
@pytest.mark.parametrize("n,avg_deg,d_feat,seed", [(96, 4, 12, 3),
                                                   (300, 6, 20, 0)])
def test_cora_like_matches_reference(n, avg_deg, d_feat, seed):
    want = RS.cora_like(n=n, avg_deg=avg_deg, d_feat=d_feat, seed=seed)
    got = TS.cora_like(n=n, avg_deg=avg_deg, d_feat=d_feat, seed=seed)
    assert got[0].n == want[0].n
    for a, b in ((got[0].src, want[0].src), (got[0].dst, want[0].dst),
                 *zip(got[1:], want[1:])):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rows,cols,d_node,d_edge,levels",
                         [(6, 6, 8, 4, 0), (6, 6, 5, 4, 2), (5, 7, 3, 2, 1)])
def test_mesh_batch_matches_reference(rows, cols, d_node, d_edge, levels):
    g, pos = TS.grid_mesh(rows, cols, levels)
    rg, rpos = RS.grid_mesh(rows, cols, levels)
    np.testing.assert_array_equal(g.src, rg.src)
    np.testing.assert_array_equal(g.dst, rg.dst)
    np.testing.assert_array_equal(pos, rpos)
    got = TS.mesh_batch(rows, cols, d_node, d_edge, multimesh_levels=levels)
    want = RS.mesh_batch(rows, cols, d_node, d_edge, multimesh_levels=levels)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if b is None or f.name == "n_graphs":
            assert a == b
        else:
            assert np.asarray(a).dtype == np.asarray(b).dtype, f.name
            np.testing.assert_array_equal(a, b)


def test_with_tails_still_matches_reference(setup):
    got = TS.with_tails(setup["g"], 3, 5, seed=2)
    want = RS.with_tails(setup["g"], 3, 5, seed=2)
    np.testing.assert_array_equal(got[0].src, want[0].src)
    np.testing.assert_array_equal(got[1], want[1])


# ------------------------------------------------------------ host builders
def test_partition_edge_values_matches_reference(setup):
    vals = np.random.default_rng(1).normal(size=(setup["g"].m, 3)).astype(
        np.float32)
    got = partition_edge_values(setup["pg"], vals)
    want = ref_edge_values(setup["rpg"], vals)
    for k in SUBGRAPHS:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_scatter_gather_features_match_reference(setup):
    x_n, x_d = TE.scatter_features(setup["pg"], setup["feats"])
    rx_n, rx_d = RE.scatter_features(setup["rpg"], setup["feats"])
    np.testing.assert_array_equal(x_n, rx_n)
    np.testing.assert_array_equal(x_d, rx_d)
    back = TE.gather_features(setup["pg"], x_n, x_d)
    np.testing.assert_array_equal(back, setup["feats"])
    np.testing.assert_array_equal(
        back, RE.gather_features(setup["rpg"], rx_n, rx_d))


@pytest.mark.parametrize("mode", ["sym", "mean", "sum"])
def test_build_edge_weights_matches_reference(setup, mode):
    got = TE.build_edge_weights(setup["pg"], setup["g"].out_degrees(), mode)
    want = RE.build_edge_weights(setup["rpg"], setup["g"].out_degrees(), mode)
    for k in SUBGRAPHS:
        np.testing.assert_array_equal(getattr(got, k), np.asarray(getattr(want, k)))
    dev = TE.device_weights(got, "cpu", part=2)
    np.testing.assert_array_equal(dev.nn.numpy(), getattr(got, "nn")[2:3])


def test_edge_valid_masks_match_reference(setup):
    got = TE.edge_valid_masks(setup["pgv"])
    want = vmapped(lambda pgl: RE.edge_valid_masks(pgl))(setup["rpgv"])
    for k in SUBGRAPHS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("sizes,comm", [((4,), {}), ((2, 2), {}),
                                        ((2, 2), dict(delegate="ring")),
                                        ((2, 2), dict(delegate="hier")),
                                        ((8,), dict(delegate="allgather"))])
@pytest.mark.parametrize("feat", [1, 16])
def test_payload_round_bytes_matches_reference(setup, sizes, comm, feat):
    got = TE.payload_round_bytes(setup["hplan"], axis_sizes=sizes, d=setup["pg"].d,
                                 feat=feat, comm_cfg=TC.CommConfig(**comm))
    want = RE.payload_round_bytes(setup["rplan"], axis_sizes=sizes,
                                  d=setup["rpg"].d, feat=feat,
                                  comm_cfg=RC.CommConfig(**comm))
    assert got == want


# ------------------------------------------------------------- propagation
def test_fetch_nn_dst_equals_reference_and_global_dst(setup, ref):
    got = TE.fetch_nn_dst(setup["pgv"], setup["plan"], t(ref["x_n"])).numpy()
    np.testing.assert_array_equal(got, ref["ends"]["nn"][1])
    # per-partition nn edges' global destination features
    pg = setup["pg"]
    layout = PartitionLayout(pg.n, pg.p_rank, pg.p_gpu)
    for k in range(pg.p):
        mk = int(pg.nn.m[k])
        dst = layout.global_of(pg.nn_owner[k, :mk], pg.nn.cols[k, :mk])
        np.testing.assert_array_equal(got[k, :mk], setup["feats"][dst])
        assert not got[k, mk:].any()


def test_edge_endpoints_equal_reference(setup, ref):
    got = TE.edge_endpoints(setup["pgv"], setup["plan"], t(ref["x_n"]),
                            t(ref["xd"]))
    for k in SUBGRAPHS:
        for a, b in zip(got[k], ref["ends"][k]):
            np.testing.assert_array_equal(a.numpy(), b)


def test_propagate_matches_reference(setup, ref):
    out_n, out_d = TE.propagate(setup["pgv"], setup["plan"], port_weights(setup),
                                t(ref["x_n"]), t(ref["xd"]))
    np.testing.assert_allclose(out_n.numpy(), ref["prop"][0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out_d.numpy(), ref["prop"][1], rtol=RTOL, atol=ATOL)
    # delegate rows replicated on every partition
    assert (out_d == out_d[:1]).all()


def test_propagate_is_one_spmm_of_the_global_graph(setup, ref):
    """Gathered back, one round is ``A_sym @ x`` of the whole graph."""
    g, pg = setup["g"], setup["pg"]
    out_n, out_d = TE.propagate(setup["pgv"], setup["plan"], port_weights(setup),
                                t(ref["x_n"]), t(ref["xd"]))
    got = TE.gather_features(pg, out_n.numpy(), out_d[0].numpy())
    deg = np.maximum(g.out_degrees(), 1).astype(np.float64)
    want = np.zeros_like(setup["feats"], dtype=np.float64)
    np.add.at(want, g.dst, setup["feats"][g.src]
              / np.sqrt(deg[g.src] * deg[g.dst])[:, None])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("delegate", ["allgather", "ring", "hier"])
def test_propagate_under_other_combines(setup, ref, delegate):
    cfg = TC.CommConfig(delegate=delegate)
    out_n, out_d = TE.propagate(setup["pgv"], setup["plan"], port_weights(setup),
                                t(ref["x_n"]), t(ref["xd"]), comm_cfg=cfg)
    np.testing.assert_allclose(out_n.numpy(), ref["prop"][0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out_d.numpy(), ref["prop"][1], rtol=RTOL, atol=ATOL)


def test_aggregate_messages_matches_reference(setup, ref):
    out_n, out_d = TE.aggregate_messages(
        setup["pgv"], setup["plan"], {k: t(v) for k, v in ref["msgs"].items()})
    np.testing.assert_allclose(out_n.numpy(), ref["agg"][0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out_d.numpy(), ref["agg"][1], rtol=RTOL, atol=ATOL)


def test_propagate_gradient_is_the_transpose(setup, ref):
    """Autograd through one round: <d out, dy> = <dx, A^T dy> -- the
    delegate sum's and the exchange's backward rebuild the transpose."""
    x_n = t(ref["x_n"]).requires_grad_(True)
    x_d = t(ref["xd"]).requires_grad_(True)
    w = port_weights(setup)
    out_n, out_d = TE.propagate(setup["pgv"], setup["plan"], w, x_n, x_d)
    rng = np.random.default_rng(4)
    dy_n, dy_d = t(rng.normal(size=out_n.shape).astype(np.float32)), \
        t(rng.normal(size=out_d.shape).astype(np.float32))
    gx_n, gx_d = torch.autograd.grad((out_n * dy_n).sum() + (out_d * dy_d).sum(),
                                     (x_n, x_d))
    # a linear map: <A x, dy> == <x, A^T dy>
    with torch.no_grad():
        lhs = float((out_n * dy_n).sum() + (out_d * dy_d).sum())
        rhs = float((x_n * gx_n).sum() + (x_d * gx_d).sum())
    assert abs(lhs - rhs) <= 1e-4 * max(abs(lhs), 1.0)


def test_exchange_payload_emulated_is_a_transpose():
    ids = torch.arange(24, dtype=torch.int32).reshape(2, 2, 6)
    vals = torch.arange(48.0).reshape(2, 2, 6, 2)
    r_ids, r_vals = TC.exchange_payload(ids, vals, TC.plan_for(None, 2))
    assert torch.equal(r_ids[1, 0], ids[0, 1])
    assert torch.equal(r_vals[0, 1], vals[1, 0])


def test_entry_points_raise_without_a_card(setup, monkeypatch):
    from repro_torch.models import gnn as G
    from repro_torch.models.common import materialize
    from repro_torch.train import gnn_batches as GB

    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    w = TE.build_edge_weights(setup["pg"], setup["g"].out_degrees())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TE.device_weights(w, "cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        materialize(G.gcn_param_specs(G.GCNConfig(d_in=4)), 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GB.batch_to_device({"x": np.zeros(2)}, "cuda")
