"""xDeepFM with its cold rows sharded over the ranks of a mesh, on a gloo
world of 2 CPU processes (``tests/_torch_recsys_world.py``), against the
one-card port and the JAX reference.

Cases: SMOKE (512 cold rows, even shards), a copy with 513 cold rows
(ragged shards: 257 and 256), SMOKE under AdamW with a clip of 1e-3 (below
the world's gradient norm, so the clip scales every step), and SMOKE
under a ``table_rows`` rule over ``"model"`` alone (one shard, replicated
on both ranks). Batches of 64 with half the fields cold. One world runs
every case, once per module.

* Shard and gather round-trip, on numpy and on tensors (exact).
* The rule: the registered spec's sharded over both mesh axes, another
  rule another layout, a mesh without the rule's axes refused.
* The first step's gradients, gathered, equal ``jax.grad`` of the
  reference's ``xdeepfm_loss`` at the same parameters within 1e-6 + 1e-4
  |g| (``tests/test_torch_recsys_train.py``'s bound: float32 sums of XLA
  and PyTorch in another order).
* The world's gradient norm, which AdamW's clip reads, equals the
  one-card gradients' global norm before each step within rtol 1e-5.
* The sharded logits equal the one-card port's ``xdeepfm_logits`` within
  1e-6 (the same float32 ops on the same rows: exact here).
* Parameters and AdamW moments after 3 steps, gathered, equal the
  one-card port step's (``make_recsys_train_step``) within 1e-6 + 1e-5
  |x|, and the losses within rtol 1e-6 (float32 reordering: the
  replicated leaves' gradients are summed over the ranks).
* The wire count: each step's bytes as the collectives counted them
  equal the route's count, and both equal the count computed here from
  the batch (ids per owner, ``id % 2``).
"""
import contextlib
import dataclasses
import tempfile
import types

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import _torch_recsys_world as RW
from repro.configs import xdeepfm as RX
from repro.models import recsys as R
from repro_torch.configs import base as TCB
from repro_torch.core import comm as TC, convert
from repro_torch.models import recsys as TR
from repro_torch.train import recsys as TRT
from repro_torch.train.optim import AdamW, Adafactor, global_norm
from repro_torch.train.trainer import value_and_grad

WORLD = 2
NAMES = tuple(RW.CASES)
#: the cases with distinct gradients, logits and wire counts ("clip" is
#: "smoke" but for the optimizer)
DISTINCT = ("smoke", "ragged", "cold_replicated")
SHARDED = ("smoke", "ragged")


@pytest.fixture(scope="module")
def world():
    return TC.dist.spawn(RW.recsys_world, WORLD, (NAMES,), timeout=300.0)


@pytest.fixture(scope="module")
def one_card():
    """The one-card port on each case: the first batch's gradients and
    logits, and the 3-step AdamW run's gradient norms (before each step),
    parameters, moments and losses."""
    out = {}
    for name in NAMES:
        cfg, params, batches = RW.inputs(name)
        p = convert.tree_from_numpy(params, "cpu")
        b0 = TRT.batch_to(batches[0], "cpu")
        _, grads = value_and_grad(lambda q: TR.xdeepfm_loss(cfg, q, b0), p)
        with torch.no_grad():
            logits = TR.xdeepfm_logits(cfg, p, b0["hot_idx"], b0["cold_idx"])
        opt = RW.optimizer(name)
        step, st, losses = TRT.make_recsys_train_step(cfg, opt), opt.init(p), []
        norms = []
        for b in batches:
            b = TRT.batch_to(b, "cpu")
            _, g = value_and_grad(lambda q: TR.xdeepfm_loss(cfg, q, b), p)
            norms.append(float(global_norm(g)))
            p, st, m = step(p, st, b)
            losses.append(float(m["loss"]))
        out[name] = {"grads": convert.tree_to_numpy(grads),
                     "logits": logits.numpy(), "norms": norms,
                     "params": convert.tree_to_numpy(p),
                     "m": convert.tree_to_numpy(st["m"]),
                     "v": convert.tree_to_numpy(st["v"]), "losses": losses}
    return out


def gathered(world, name: str, key: str) -> dict:
    """The case's ``key`` dicts of one replica of each shard (the ranks at
    position 0 over the other axes), in shard order, gathered."""
    ranks = sorted((r[name]["table"][0], r[name][key]) for r in world
                   if r[name]["table"][2] == 0)
    return convert.xdeepfm_gather_params([d for _, d in ranks])


@contextlib.contextmanager
def one_rank_group():
    """A gloo world of one rank in this process."""
    import torch.distributed as dist

    init = f"file://{tempfile.mkdtemp()}/rendezvous"
    dist.init_process_group("gloo", init_method=init, rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def assert_leaves(got: dict, want: dict, atol: float, rtol: float) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=rtol,
                                   atol=atol, err_msg=k)


def test_rules_override_carries_the_reference_table_rows_rule():
    assert TCB.get_arch("xdeepfm").rules_override == RX.CONFIG.rules_override
    assert RX.CONFIG.rules_override == {"table_rows": ("data", "model")}


@pytest.mark.parametrize("axes,rules,want", [
    (("data", "model"), None, ("data", "model")),
    (("data", "model"), {"table_rows": ("data", "model")}, ("data", "model")),
    (("data", "model"), {"table_rows": ("model",)}, ("model",)),
    (("data", "model"), {"table_rows": "data"}, ("data",)),
    (("model", "data"), {"table_rows": ("data", "model")}, ("model", "data")),
    (("pod", "data", "model"), {"table_rows": ("data",)}, ("pod", "data")),
    (("rank",), {}, ("rank",)),
])
def test_table_axes_follow_the_rule(axes, rules, want):
    """The reference's ``rules_for``: ``table_rows`` defaults to every
    mesh axis, ``"data"`` stands for ``("pod", "data")`` on a mesh with a
    pod axis; the port gives them in the mesh's order."""
    assert TR.table_axes(types.SimpleNamespace(axes=axes), rules) == want


@pytest.mark.parametrize("rules", [{"table_rows": ("data", "model")},
                                   {"table_rows": ("data", "pod")},
                                   {"table_rows": ()}])
def test_table_axes_refuse_axes_the_mesh_lacks(rules):
    with pytest.raises(ValueError, match="table_rows"):
        TR.table_axes(types.SimpleNamespace(axes=("data",)), rules)


def test_mesh_without_the_rule_axes_is_refused():
    """The sharded step reads the registered spec's rule: a mesh without
    its ``("data", "model")`` axes is refused where the step is built."""
    with one_rank_group():
        mesh = TC.dist.PartitionMesh(("rank",), (1,))
        with pytest.raises(ValueError, match="table_rows"):
            TRT.make_sharded_recsys_train_step(RW.CONFIGS["smoke"], AdamW(),
                                               mesh)
        TRT.make_sharded_recsys_train_step(
            RW.CONFIGS["smoke"], AdamW(), mesh, rules={"table_rows": "rank"})


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_shard_and_gather_round_trip(p, as_tensor):
    cfg, params, _ = RW.inputs("ragged")
    if as_tensor:
        params = convert.tree_from_numpy(params, "cpu")
    shards = [convert.xdeepfm_shard_params(params, r, p) for r in range(p)]
    for r, s in enumerate(shards):
        rows = TR.cold_shard_rows(cfg.n_cold, r, p)
        assert s["emb_cold"].shape == (rows, cfg.embed_dim)
        assert s["lin_cold"].shape == (rows, 1)
        np.testing.assert_array_equal(np.asarray(s["emb_cold"])[1],
                                      np.asarray(params["emb_cold"])[r + p])
    assert sum(TR.cold_shard_rows(cfg.n_cold, r, p)
               for r in range(p)) == cfg.n_cold
    back = convert.xdeepfm_gather_params(shards)
    assert sorted(back) == sorted(params)
    for k in params:
        np.testing.assert_array_equal(np.asarray(back[k]),
                                      np.asarray(params[k]), err_msg=k)


def test_table_bytes_count_the_shards():
    cfg = RW.CONFIGS["ragged"]
    parts = [TR.xdeepfm_table_bytes(cfg, r, WORLD) for r in range(WORLD)]
    assert [b["cold"] for b in parts] == [257 * 5 * 4, 256 * 5 * 4]
    one = TR.xdeepfm_table_bytes(cfg)
    assert one["cold"] == sum(b["cold"] for b in parts)
    total = sum(int(np.prod(s)) for s, _ in TR.xdeepfm_param_specs(cfg).values())
    assert one["cold"] + one["hot"] + one["dense"] == 4 * total


@pytest.mark.parametrize("name", DISTINCT)
def test_first_step_gradients_match_reference_grad(world, name):
    cfg, params, batches = RW.inputs(name)
    rcfg = dataclasses.replace(RX.SMOKE, n_cold=cfg.n_cold)
    want = jax.grad(lambda p: R.xdeepfm_loss(
        rcfg, p, jax.tree.map(jnp.asarray, batches[0])))(
            jax.tree.map(jnp.asarray, params))
    got = gathered(world, name, "grads")
    assert_leaves(got, jax.tree.map(np.asarray, want), atol=1e-6, rtol=1e-4)
    assert np.abs(got["emb_cold"]).max() > 0 and np.abs(got["lin_cold"]).max() > 0


@pytest.mark.parametrize("name", DISTINCT)
def test_sharded_logits_equal_one_card(world, one_card, name):
    got = np.concatenate([r[name]["logits"] for r in world])
    np.testing.assert_allclose(got, one_card[name]["logits"], rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_three_adamw_steps_equal_one_card(world, one_card, name):
    want = one_card[name]
    for r in world:
        np.testing.assert_allclose(r[name]["losses"], want["losses"],
                                   rtol=1e-6)
    for key in ("params", "m", "v"):
        assert_leaves(gathered(world, name, key), want[key], atol=1e-6,
                      rtol=1e-5)
    assert want["losses"][-1] < want["losses"][0]


@pytest.mark.parametrize("name", SHARDED)
def test_wire_count_equals_bytes_sent(world, name):
    cfg, _, batches = RW.inputs(name)
    row = 4 * (cfg.embed_dim + 1)
    for s, b in enumerate(batches):
        # counts[i, j]: rank i's cold lookups owned by rank j, from numpy
        counts = np.zeros((WORLD, WORLD), np.int64)
        for i in range(WORLD):
            ids = TRT.shard_batch(b, i, WORLD)["cold_idx"].reshape(-1)
            counts[i] = np.bincount(ids[ids >= 0] % WORLD, minlength=WORLD)
        cap = counts.max()
        for r, res in enumerate(world):
            w = res[name]["wire"][s]
            np.testing.assert_array_equal(w["counts"][:, :-1], counts)
            assert w["counts"][:, -1].sum() == len(b["labels"])
            o = 1 - r
            want = {"ids": 4 * counts[r, o], "rows": row * counts[o, r],
                    "grads": row * counts[r, o], "counts": 8 * 3 * 1}
            assert {k: w["sent"][k] for k in want} == want
            assert {k: w["formula"][k] for k in want} == want
            assert w["formula"]["rows_padded"] == row * cap
            assert w["sent"]["allreduce"] > 0


@pytest.mark.parametrize("name", NAMES)
def test_world_gradient_norm_equals_one_card(world, one_card, name):
    """The norm the clip reads: the replicated leaves' squares plus each
    cold shard's, counted once whatever its replicas."""
    for r in world:
        np.testing.assert_allclose(r[name]["norms"], one_card[name]["norms"],
                                   rtol=1e-5)


def test_clip_scales_every_step(world, one_card):
    """With AdamW's clip below the norm the clip takes effect on every
    step (scale clip / norm < 1) and the steps still equal the one-card
    step (``test_three_adamw_steps_equal_one_card``); the clipped run
    ends elsewhere than the unclipped one."""
    for r in world:
        assert all(n > 10 * RW.CLIP for n in r["clip"]["norms"])
    clipped = one_card["clip"]["params"]["mlp_w0"]
    assert np.abs(clipped - one_card["smoke"]["params"]["mlp_w0"]).max() > 1e-4


def test_rule_over_model_alone_replicates_the_cold_rows(world):
    """``{"table_rows": ("model",)}`` on the (2, 1) mesh: one shard, whole,
    on both ranks (the same rows after the steps); no lookup leaves its
    rank; the row gradients are summed over ``"data"`` instead, their
    bytes the ring model's."""
    cfg, params, _ = RW.inputs("cold_replicated")
    n = cfg.n_cold * (cfg.embed_dim + 1)
    for r, res in enumerate(world):
        got = res["cold_replicated"]
        assert got["table"] == (0, 1, r)
        assert got["params"]["emb_cold"].shape == params["emb_cold"].shape
        np.testing.assert_array_equal(got["params"]["emb_cold"],
                                      world[0]["cold_replicated"]["params"]
                                      ["emb_cold"])
        for w in got["wire"]:
            assert w["sent"]["ids"] == w["sent"]["rows"] == 0
            assert w["sent"]["grads"] == 0 and w["sent"]["counts"] == 8 * 2
            assert w["sent"]["cold_allreduce"] == 2 * (WORLD - 1) * (n // 2) * 4
            assert w["formula"]["rows_padded"] == 0


def test_sharded_step_on_one_rank_equals_one_card():
    """A world of one rank in this process (gloo): every leaf, moment and
    the loss after 2 steps equal the one-card step's (the route is the
    identity there; float32 reordering in the clip's norm only)."""
    from repro_torch.core.comm.dist import PartitionMesh

    cfg, params, batches = RW.inputs("smoke")
    with one_rank_group():
        mesh = PartitionMesh(RW.AXES, (1, 1))
        opt = AdamW(lr=RW.LR)
        runs = []
        for step in (TRT.make_sharded_recsys_train_step(cfg, opt, mesh),
                     TRT.make_recsys_train_step(cfg, opt)):
            p = convert.tree_from_numpy(params, "cpu")
            st = opt.init(p)
            for b in batches[:2]:
                p, st, m = step(p, st, TRT.batch_to(b, "cpu"))
            runs.append((float(m["loss"]), convert.tree_to_numpy(
                {"p": p, "m": st["m"], "v": st["v"]})))
    (l0, t0), (l1, t1) = runs
    np.testing.assert_allclose(l0, l1, rtol=1e-6)
    for k in ("p", "m", "v"):
        assert_leaves(t0[k], t1[k], atol=1e-7, rtol=1e-6)


def test_non_elementwise_optimizer_is_refused():
    with pytest.raises(ValueError, match="elementwise"):
        TRT.make_sharded_recsys_train_step(RW.CONFIGS["smoke"], Adafactor(),
                                           mesh=None)


@pytest.mark.parametrize("p", [1, 2, 3])
def test_shard_batch_splits_the_batch_axis(p):
    b = RW.make_batch(RW.CONFIGS["smoke"], 65, 0)
    parts = [TRT.shard_batch(b, r, p) for r in range(p)]
    for k in b:
        np.testing.assert_array_equal(np.concatenate([x[k] for x in parts]),
                                      b[k])
    assert [len(x["labels"]) for x in parts] == [
        (r + 1) * 65 // p - r * 65 // p for r in range(p)]
