"""MACE on the port (``models/equivariant.py``, ``train/gnn_dist.py::
dist_mace_loss``, ``train/gnn_batches.py::mace_batch``,
``graphs/synthetic.py::molecule_batch``, ``configs/mace.py``) against the
JAX reference on the CPU, with the reference's own parameters carried
across (``convert.tree_from_numpy``).

Tolerances (float32 sums in another order, XLA's against PyTorch's):
Gaunt tables exact; spherical harmonics, the radial basis and the tensor
product ``rtol=1e-5, atol=1e-6``; node energies, graph energies and
losses ``rtol=1e-4, atol=1e-6``; gradients within ``1e-4`` of each leaf's
largest |g| (a leaf the reference's gradient does not reach is 0 in
both); the distributed loss against the reference's ``rtol=1e-5`` and
against the local energy ``rtol=1e-4``; the positions-only fetch equal to
the full fetch exactly (the same messages); bfloat16 messages: the
reference's ``segment_sum`` / ``psum`` against the port's ``index_add`` /
sum within ``2**-7`` of the largest |aggregate| (bfloat16's rounding),
the loss within ``rtol=2**-7`` and gradients within ``2**-4`` of each
leaf's largest |g| (bfloat16 partials through two layers); the gloo world
of 2 against the emulated run: loss ``rtol=1e-5``, parameters after the
step ``rtol=1e-5, atol=1e-6``; the symmetry twins keep the reference
tests' bounds. The JAX references are computed once per module."""
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import _torch_gnn_world as GW
from repro.configs import mace as RCM
from repro.core import bfs as RB, engine as RE
from repro.core.partition import partition_graph as ref_partition
from repro.graphs import synthetic as RS
from repro.models import equivariant as REQ
from repro.models.common import materialize as ref_materialize
from repro.train import gnn_batches as RGB, gnn_dist as RGD
from repro_torch.configs import base as TCB, mace as TCM
from repro_torch.core import bfs as TB, comm as TC, convert, engine as TE
from repro_torch.graphs import synthetic as TS
from repro_torch.models import equivariant as TEQ, gnn as TG
from repro_torch.models.common import materialize
from repro_torch.train import gnn_batches as TGB, gnn_dist as TGD
from repro_torch.train.trainer import value_and_grad
from repro_torch.tree import flatten_with_path

FWD = dict(rtol=1e-4, atol=1e-6)
PRIM = dict(rtol=1e-5, atol=1e-6)
GRAD_REL, BF16, BF16_GRAD = 1e-4, 2.0**-7, 2.0**-4


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def ref_config(cfg):
    """The reference config of a port config (same fields, JAX dtypes)."""
    kw = {k: v for k, v in vars(cfg).items()
          if k not in ("dtype", "dist_msg_dtype")}
    return REQ.MACEConfig(**kw, dist_msg_dtype=(
        jnp.bfloat16 if cfg.dist_msg_dtype == torch.bfloat16 else jnp.float32))


def grads_close(got, want, rel: float) -> None:
    """Each leaf of ``got`` within ``rel`` of ``want``'s largest |g|; a
    leaf ``want`` does not reach is 0 in ``got`` too."""
    want = dict(flatten_with_path(want))
    got = dict(flatten_with_path(convert.tree_to_numpy(got)))
    assert sorted(got) == sorted(want)
    reached = 0
    for k, w in want.items():
        top = float(np.abs(w).max())
        if top == 0:
            assert float(np.abs(got[k]).max()) == 0, k
            continue
        reached += 1
        assert float(np.abs(got[k] - w).max()) <= rel * top, k
    assert reached > len(want) // 2


# --------------------------------------------------------------- primitives
def test_gaunt_tables_equal_reference():
    ref, port = REQ.gaunt_tables(), TEQ.gaunt_tables()
    assert list(port) == list(ref)
    for k in ref:
        assert port[k].dtype == np.float32
        np.testing.assert_array_equal(port[k], np.asarray(ref[k]), err_msg=k)


def test_gaunt_l0_is_identity_scale():
    """Twin of the reference's: ``G[0, l, l] = delta_{m m'} / (2 sqrt(pi))``."""
    t = TEQ.gaunt_tables()
    c0 = 0.28209479177387814
    for l in range(3):
        np.testing.assert_allclose(t[(0, l, l)][0], np.eye(2 * l + 1) * c0,
                                   atol=1e-7)


def test_sph_harm_rbf_and_tensor_product_match_reference():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(50, 3)).astype(np.float32)
    unit = v / np.linalg.norm(v, axis=-1, keepdims=True)
    ref = REQ.real_sph_harm(jnp.asarray(unit))
    port = TEQ.real_sph_harm(torch.from_numpy(unit))
    for l in ref:
        np.testing.assert_allclose(port[l].numpy(), np.asarray(ref[l]), **PRIM)
    r = np.concatenate([[0.0, 1e-7, 5.0, 7.5],
                        rng.uniform(0.1, 6, 40)]).astype(np.float32)
    np.testing.assert_allclose(
        TEQ.bessel_rbf(torch.from_numpy(r), 8, 5.0).numpy(),
        np.asarray(REQ.bessel_rbf(jnp.asarray(r), 8, 5.0)), **PRIM)
    c = 6
    a = {l: rng.normal(size=(7, c, 2 * l + 1)).astype(np.float32)
         for l in range(3)}
    b = {l: rng.normal(size=(7, c, 2 * l + 1)).astype(np.float32)
         for l in range(3)}
    pw = {k: rng.normal(size=(c,)).astype(np.float32)
          for k in TEQ._paths()[::2]}
    for weights in (None, pw):
        ref = REQ.tensor_product(
            {l: jnp.asarray(x) for l, x in a.items()},
            {l: jnp.asarray(x) for l, x in b.items()},
            None if weights is None else
            {k: jnp.asarray(x) for k, x in weights.items()})
        port = TEQ.tensor_product(
            {l: torch.from_numpy(x) for l, x in a.items()},
            {l: torch.from_numpy(x) for l, x in b.items()},
            None if weights is None else
            {k: torch.from_numpy(x) for k, x in weights.items()})
        assert sorted(port) == sorted(ref)
        for l in ref:
            np.testing.assert_allclose(port[l].numpy(), np.asarray(ref[l]),
                                       **PRIM)


def test_molecule_batch_equals_reference():
    ref, re = RS.molecule_batch(5, 12, 100, 6, seed=9)
    port, pe = TS.molecule_batch(5, 12, 100, 6, seed=9)
    np.testing.assert_array_equal(pe, re)
    for f in ("nodes", "senders", "receivers", "node_mask", "edge_mask",
              "graph_ids", "positions", "species"):
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f),
                                      err_msg=f)
    assert port.n_graphs == ref.n_graphs == 5
    assert (port.senders == 60).any()        # padded with N


def test_configs_equal_reference():
    for port, ref in ((TCM.SMOKE, RCM.SMOKE),
                      (TCM.model_for_shape({}), RCM.model_for_shape({})),
                      (TCM.model_for_shape_opt({}),
                       RCM.model_for_shape_opt({}))):
        assert vars(ref_config(port)) == vars(ref)
    assert TCM.model_for_shape_opt({}).dist_msg_dtype == torch.bfloat16
    for name in ("mace", "mace-opt"):
        assert TCB.get_arch(name).optimizer == "adamw"
        assert TCB.get_arch(name).shapes["molecule"] == dict(
            kind="batched_small", n_nodes=30, n_edges=64, batch=128)


# ----------------------------------------------------------- local model
def local_case(cfg, n_mol: int, seed: int) -> dict:
    rcfg = ref_config(cfg)
    rparams = np_tree(ref_materialize(REQ.mace_param_specs(rcfg), seed))
    gb, energies = RS.molecule_batch(n_mol, 30, 64, cfg.n_species, seed=seed)
    jgb = jax.tree.map(jnp.asarray, gb)
    loss = lambda p: REQ.mace_loss(rcfg, p, jgb, jnp.asarray(energies))
    lval, grads = jax.jit(jax.value_and_grad(loss))(rparams)
    node, energy = jax.jit(lambda p: (
        REQ.mace_forward(rcfg, p, jgb.positions, jgb.species, jgb.senders,
                         jgb.receivers),
        REQ.mace_energy(rcfg, p, jgb)))(rparams)
    return dict(
        cfg=cfg, params=convert.tree_from_numpy(rparams, "cpu"),
        gb=TG.batch_to(TS.molecule_batch(n_mol, 30, 64, cfg.n_species,
                                         seed=seed)[0], "cpu"),
        energies=torch.from_numpy(energies), node=np.asarray(node),
        energy=np.asarray(energy), loss=float(lval), grads=np_tree(grads))


@pytest.fixture(scope="module", params=["smoke", "d128"])
def local(request):
    cfg = (TCM.SMOKE if request.param == "smoke"
           else TCM.model_for_shape({}))
    return local_case(cfg, 2, 1)


def test_forward_energy_loss_match_reference(local):
    cfg, p, gb = local["cfg"], local["params"], local["gb"]
    with torch.no_grad():
        node = TEQ.mace_forward(cfg, p, gb.positions, gb.species, gb.senders,
                                gb.receivers)
        energy = TEQ.mace_energy(cfg, p, gb)
        loss = TEQ.mace_loss(cfg, p, gb, local["energies"])
    assert node.dtype == torch.float32 and node.shape == (60,)
    np.testing.assert_allclose(node.numpy(), local["node"], **FWD)
    np.testing.assert_allclose(energy.numpy(), local["energy"], **FWD)
    np.testing.assert_allclose(float(loss), local["loss"], **FWD)


def test_loss_gradients_match_reference_grad(local):
    cfg = local["cfg"]
    loss, grads = value_and_grad(
        lambda p: TEQ.mace_loss(cfg, p, local["gb"], local["energies"]),
        local["params"])
    np.testing.assert_allclose(float(loss), local["loss"], **FWD)
    grads_close(grads, local["grads"], GRAD_REL)


# -------------------------------------- the reference's symmetry tests' twins
def random_rotation(seed):
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q.astype(np.float32)


def smoke_params(cfg, seed=0):
    return materialize(TEQ.mace_param_specs(cfg), seed, "cpu")


def test_mace_energy_rotation_invariant():
    cfg = TEQ.MACEConfig(n_layers=2, d_hidden=8, n_rbf=4, n_species=5)
    params = smoke_params(cfg)
    gb, _ = TS.molecule_batch(n_mol=3, n_atoms=10, n_edges_per=24,
                              n_species=5, seed=3)
    energy = lambda pos: TEQ.mace_energy(cfg, params, TG.batch_to(
        TG.GraphBatch(**{**gb.__dict__, "positions": pos}), "cpu")).detach()
    e0 = energy(gb.positions)
    e1 = energy(gb.positions @ random_rotation(7).T)
    np.testing.assert_allclose(e0.numpy(), e1.numpy(), rtol=2e-4, atol=2e-4)
    e2 = energy(gb.positions + np.float32(3.14))           # translation
    np.testing.assert_allclose(e0.numpy(), e2.numpy(), rtol=2e-4, atol=2e-4)


def test_mace_forces_equivariant():
    """Forces (-dE/dpos) rotate with the rotation: F(Rx) = R F(x)."""
    cfg = TEQ.MACEConfig(n_layers=1, d_hidden=8, n_rbf=4, n_species=5)
    params = smoke_params(cfg)
    gb, _ = TS.molecule_batch(n_mol=1, n_atoms=8, n_edges_per=20,
                              n_species=5, seed=5)
    tb = TG.batch_to(gb, "cpu")

    def force(pos):
        x = torch.from_numpy(pos).requires_grad_()
        e = TEQ.mace_forward(cfg, params, x, tb.species, tb.senders,
                             tb.receivers).sum()
        return torch.autograd.grad(e, x)[0].numpy()

    rot = random_rotation(11)
    np.testing.assert_allclose(force(gb.positions @ rot.T),
                               force(gb.positions) @ rot.T, rtol=2e-3,
                               atol=2e-4)


def test_mace_grad_finite():
    cfg = TEQ.MACEConfig(n_layers=2, d_hidden=8, n_rbf=4, n_species=5)
    params = smoke_params(cfg)
    gb, energies = TS.molecule_batch(n_mol=2, n_atoms=8, n_edges_per=20,
                                     n_species=5, seed=4)
    _, grads = value_and_grad(lambda p: TEQ.mace_loss(
        cfg, p, TG.batch_to(gb, "cpu"), torch.from_numpy(energies)), params)
    assert all(bool(torch.isfinite(g).all())
               for _, g in flatten_with_path(grads))


# ----------------------------------------------------------- distributed
@pytest.fixture(scope="module")
def dist_setup():
    """The reference's distributed-MACE test setup
    (``tests/test_gnn_dist.py``): cora_like(n=96) at p = 4, th = 10,
    seeded positions and species; the reference's distributed loss and
    gradients of every variant."""
    g, feats, labels, mask = RS.cora_like(n=96, avg_deg=4, d_feat=12, seed=3)
    rpg = ref_partition(g, th=10, p_rank=2, p_gpu=2)
    rpgv, rplan = RB.device_view(rpg), RE.build_exchange_plan(rpg)
    pg = convert.partition_from_arrays(*convert.partition_to_arrays(rpg))
    rng = np.random.default_rng(1)
    pos = rng.normal(size=(g.n, 3)).astype(np.float32) * 2
    spec = rng.integers(0, 5, g.n).astype(np.int32)
    rbatch = RGB.mace_batch(rpg, pos, spec, 0.5)
    # the port's every variant; the reference's full fetch in float32 and
    # bfloat16 (the positions-only fetch sends the same messages)
    cfgs = {}
    for pos_only in (False, True):
        for bf in (False, True):
            cfgs[(pos_only, bf)] = TEQ.MACEConfig(
                n_layers=2, d_hidden=4, n_rbf=4, n_species=5,
                dist_fetch_pos_only=pos_only,
                dist_msg_dtype=torch.bfloat16 if bf else torch.float32)
    rparams = np_tree(ref_materialize(
        REQ.mace_param_specs(ref_config(cfgs[(False, False)])), 2))
    ref = {}
    for bf in (False, True):
        rcfg = ref_config(cfgs[(False, bf)])
        fn = lambda prm, pgl, pl, bt: RGD.dist_mace_loss(rcfg, prm, pgl, pl,
                                                         bt, "p")
        both = lambda *a: (fn(*a), jax.lax.pmean(jax.grad(fn)(*a), "p"))
        loss, grads = jax.jit(jax.vmap(both, axis_name="p",
                                       in_axes=(None, 0, 0, 0)))(
            rparams, rpgv, rplan, jax.tree.map(jnp.asarray, rbatch))
        ref[bf] = (float(loss[0]), jax.tree.map(lambda a: np.asarray(a)[0],
                                                grads))
    local = float(np.asarray(REQ.mace_forward(
        ref_config(cfgs[(False, False)]), rparams, jnp.asarray(pos),
        jnp.asarray(spec), jnp.asarray(g.src, jnp.int32),
        jnp.asarray(g.dst, jnp.int32))).sum())
    return dict(g=g, pg=pg, pos=pos, spec=spec, rbatch=rbatch, cfgs=cfgs,
                params=convert.tree_from_numpy(rparams, "cpu"),
                pgv=TB.device_view(pg, "cpu"),
                plan=TE.device_plan(convert.plan_from_arrays(
                    *convert.plan_to_arrays(rplan)), "cpu"),
                batch=TGB.batch_to_device(TGB.mace_batch(pg, pos, spec, 0.5),
                                          "cpu"),
                ref=ref, local=local)


def test_mace_batch_equals_reference(dist_setup):
    s = dist_setup
    assert sorted(s["batch"]) == sorted(s["rbatch"])
    for k, v in s["rbatch"].items():
        np.testing.assert_array_equal(s["batch"][k].numpy(), np.asarray(v),
                                      err_msg=k)


@pytest.mark.parametrize("pos_only", [False, True], ids=["full", "pos_only"])
def test_dist_mace_loss_matches_reference_and_local(dist_setup, pos_only):
    s = dist_setup
    cfg = s["cfgs"][(pos_only, False)]
    loss, grads = value_and_grad(lambda p: TGD.dist_mace_loss(
        cfg, p, s["pgv"], s["plan"], s["batch"]), s["params"])
    want_loss, want_grads = s["ref"][False]
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    np.testing.assert_allclose(float(loss), (s["local"] - 0.5) ** 2,
                               rtol=1e-4)
    grads_close(grads, want_grads, GRAD_REL)


@pytest.mark.parametrize("pos_only", [False, True], ids=["full", "pos_only"])
def test_dist_mace_energies_sum_to_the_local_energy(dist_setup, pos_only):
    """Each partition's energy, which ``dist_mace_loss`` sums: in float32
    the partitions' sum equals the local energy within rtol 1e-5; with
    bfloat16 messages each partition's energy is the float32 one within
    2**-7 of the largest |energy| (bfloat16's rounding)."""
    s = dist_setup
    with torch.no_grad():
        e = {bf: TGD.dist_mace_energies(s["cfgs"][(pos_only, bf)],
                                        s["params"], s["pgv"], s["plan"],
                                        s["batch"]).numpy()
             for bf in (False, True)}
    assert e[False].shape == (4,)
    np.testing.assert_allclose(e[False].sum(), s["local"], rtol=1e-5)
    np.testing.assert_allclose(e[True], e[False], rtol=0,
                               atol=BF16 * np.abs(e[False]).max())


@pytest.mark.parametrize("bf", [False, True], ids=["float32", "bfloat16"])
def test_positions_only_fetch_equals_full_fetch(dist_setup, bf):
    s = dist_setup
    got = [value_and_grad(lambda p: TGD.dist_mace_loss(
        s["cfgs"][(po, bf)], p, s["pgv"], s["plan"], s["batch"]),
        s["params"]) for po in (False, True)]
    assert float(got[0][0]) == float(got[1][0])
    for (k, a), (_, b) in zip(flatten_with_path(got[0][1]),
                              flatten_with_path(got[1][1])):
        assert torch.equal(a, b), k


def test_round_bytes_of_the_two_fetches(dist_setup):
    s = dist_setup
    full, pos = (TGD.mace_round_bytes(s["cfgs"][(po, False)], s["plan"],
                                      axis_sizes=(2, 2), d=s["pg"].d)
                 for po in (False, True))
    assert pos["fetch"] < full["fetch"]
    assert (pos["delegate"], pos["nn"]) == (full["delegate"], full["nn"])
    ref = RE.payload_round_bytes(
        RE.build_exchange_plan(s["pg"]), axis_sizes=(2, 2), d=s["pg"].d,
        feat=9 * 4)
    assert (full["delegate"], full["nn"]) == (ref["delegate_bytes"],
                                             ref["nn_payload_bytes"])


@pytest.mark.parametrize("pos_only", [False, True], ids=["full", "pos_only"])
def test_bfloat16_messages_match_reference(dist_setup, pos_only):
    s = dist_setup
    cfg = s["cfgs"][(pos_only, True)]
    loss, grads = value_and_grad(lambda p: TGD.dist_mace_loss(
        cfg, p, s["pgv"], s["plan"], s["batch"]), s["params"])
    want_loss, want_grads = s["ref"][True]
    np.testing.assert_allclose(float(loss), want_loss, rtol=BF16)
    grads_close(grads, want_grads, BF16_GRAD)


def test_bfloat16_aggregation_matches_reference_segment_sum(dist_setup):
    """``aggregate_messages`` of bfloat16 messages (``index_add`` and the
    delegate sum in bfloat16) against the reference's ``segment_sum`` /
    ``psum`` in bfloat16, within 2**-7 of the largest |aggregate|."""
    s = dist_setup
    rpg = RB.device_view(ref_partition(s["g"], th=10, p_rank=2, p_gpu=2))
    rplan = RE.build_exchange_plan(ref_partition(s["g"], th=10, p_rank=2,
                                                 p_gpu=2))
    rng = np.random.default_rng(4)
    msgs = {k: rng.normal(size=(4, s["pg"].subgraph(k).e_max, 36)).astype(
        np.float32) for k in ("nn", "nd", "dn", "dd")}
    want = jax.jit(jax.vmap(
        lambda pgl, pl, m: RE.aggregate_messages(
            pgl, pl, jax.tree.map(lambda a: a.astype(jnp.bfloat16), m), "p"),
        axis_name="p"))(rpg, rplan, jax.tree.map(jnp.asarray, msgs))
    got = TE.aggregate_messages(s["pgv"], s["plan"], {
        k: torch.from_numpy(v).to(torch.bfloat16) for k, v in msgs.items()})
    for g_, w in zip(got, want):
        assert g_.dtype == torch.bfloat16
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(g_.float().numpy(), w, rtol=0,
                                   atol=BF16 * np.abs(w).max())


# ---------------------------------------------------------- world-2 mesh
@pytest.fixture(scope="module")
def mace_world():
    return TC.dist.spawn(GW.mace_world, 2, (GW.SPEC,), timeout=300.0)


def test_mesh_mace_equals_emulated(mace_world):
    """Two gloo ranks, one partition each: the distributed MACE loss and
    one AdamW step (the backward through the differentiable collectives,
    gradients averaged over the ranks) equal the emulated run's, with
    either fetch."""
    want = GW.mace_cases(GW.SPEC, "cpu")
    for variant, w in want.items():
        flat = dict(flatten_with_path(w["params"]))
        for rank, res in enumerate(mace_world):
            np.testing.assert_allclose(res[variant]["loss"], w["loss"],
                                       rtol=1e-5)
            for k, v in flatten_with_path(res[variant]["params"]):
                np.testing.assert_allclose(v, flat[k], rtol=1e-5, atol=1e-6,
                                           err_msg=f"{variant} rank {rank} {k}")
    assert want["full"]["loss"] == want["pos_only"]["loss"]
