"""World function of the sharded xDeepFM training test, and the inputs it
shares with the parent.

Every rank of a spawned world (``repro_torch.core.comm.dist.spawn``) draws
the same numpy parameters and batches, keeps its cold shards
(``convert.xdeepfm_shard_params``) and its rows of each batch
(``train.recsys.shard_batch``), and runs the sharded step over a
``("data", "model")`` mesh of sizes ``(world, 1)``. Each case names a
config, AdamW's clip and the ``table_rows`` rule: the registered
``xdeepfm`` spec's (over both axes: one shard a rank), and one over
``"model"`` alone (one shard, replicated on every rank). It returns, as
numpy: the rank's shard position, the shard count and its position over
the other axes, the first step's global gradients, the sharded logits of
the first batch, the parameters and AdamW moments after the steps, the
losses and the world's gradient norms, and each step's wire bytes as the
collectives counted them beside the route's count. Port imports only: a
spawned rank imports no JAX."""
import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import get_arch
from repro_torch.configs.xdeepfm import SMOKE
from repro_torch.core import comm as C, convert
from repro_torch.models import recsys as R
from repro_torch.train import recsys as RT
from repro_torch.train.optim import AdamW

AXES = ("data", "model")
#: SMOKE, and a copy whose 513 cold rows leave ragged shards over 2 ranks
CONFIGS = {"smoke": SMOKE,
           "ragged": dataclasses.replace(SMOKE, name="xdeepfm-ragged",
                                         n_cold=513)}
STEPS, BATCH, LR = 3, 64, 1e-2
#: a clip below the world's gradient norm (about 0.1 here), so it scales
CLIP = 1e-3
#: case -> (config, AdamW's clip_norm, table_rows rule; None: the spec's)
CASES = {"smoke": ("smoke", 1.0, None), "ragged": ("ragged", 1.0, None),
         "clip": ("smoke", CLIP, None),
         "cold_replicated": ("smoke", 1.0, {"table_rows": ("model",)})}


def numpy_params(cfg, seed: int) -> dict:
    """A parameter dict drawn with numpy under the reference's init rules
    (normal x 0.02, scaled / sqrt(shape[-2]), zeros)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shape, init) in sorted(R.xdeepfm_param_specs(cfg).items()):
        x = rng.normal(size=shape)
        if init == "zeros":
            x = np.zeros(shape)
        elif init == "scaled":
            x /= np.sqrt(shape[-2] if len(shape) >= 2 else shape[-1])
        else:
            x *= 0.02
        out[name] = x.astype(np.float32)
    return out


def make_batch(cfg, b: int, seed: int) -> dict:
    """Half the fields hot ids, the other half cold ids (-1 in the other
    table; every owner of the cold rows drawn), 0/1 labels."""
    rng = np.random.default_rng(seed)
    shape = (b, cfg.n_sparse)
    is_hot = rng.random(shape) < 0.5
    hot = np.where(is_hot, rng.integers(0, cfg.n_hot, shape), -1)
    cold = np.where(is_hot, -1, rng.integers(0, cfg.n_cold, shape))
    hot, cold = hot.astype(np.int32), cold.astype(np.int32)
    return {"hot_idx": hot, "cold_idx": cold,
            "labels": rng.integers(0, 2, b).astype(np.int32)}


def inputs(name: str) -> tuple:
    """``(cfg, params, batches)`` of case ``name``."""
    cfg = CONFIGS[CASES[name][0]]
    return (cfg, numpy_params(cfg, 0),
            [make_batch(cfg, BATCH, s) for s in range(STEPS)])


def optimizer(name: str) -> AdamW:
    return AdamW(lr=LR, clip_norm=CASES[name][1])


def recsys_world(rank: int, world: int, names: tuple) -> dict:
    mesh = C.dist.PartitionMesh(AXES, (world, 1))
    out = {}
    for name in names:
        cfg, params, batches = inputs(name)
        rules = CASES[name][2]
        axes = R.table_axes(mesh, rules or get_arch("xdeepfm").rules_override)
        rest = tuple(a for a in AXES if a not in axes)
        s, q = mesh.index(axes), mesh.size(axes)
        shard = convert.tree_from_numpy(
            convert.xdeepfm_shard_params(params, s, q), "cpu")
        mine = [RT.batch_to(RT.shard_batch(b, rank, world), "cpu")
                for b in batches]
        _, grads, _, _ = RT.sharded_value_and_grad(cfg, shard, mine[0], mesh,
                                                   axes=axes)
        with torch.no_grad():
            logits = R.xdeepfm_logits(
                cfg, shard, mine[0]["hot_idx"], mine[0]["cold_idx"],
                route=R.route_cold(mesh, mine[0]["cold_idx"], axes))
        opt = optimizer(name)
        step = RT.make_sharded_recsys_train_step(cfg, opt, mesh, rules=rules)
        state, losses, norms, wire = opt.init(shard), [], [], []
        for b in mine:
            shard, state, m = step(shard, state, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            wire.append({"sent": m["wire"], "counts": m["route"].counts,
                         "formula": m["route"].wire_bytes(
                             4 * (cfg.embed_dim + 1))})
        out[name] = {"table": (s, q, mesh.index(rest) if rest else 0),
                     "grads": convert.tree_to_numpy(grads),
                     "logits": logits.numpy(),
                     "params": convert.tree_to_numpy(shard),
                     "m": convert.tree_to_numpy(state["m"]),
                     "v": convert.tree_to_numpy(state["v"]),
                     "losses": losses, "norms": norms, "wire": wire}
    return out


def one_rank_world(rank: int, world: int, names: tuple) -> dict:
    """A world of one rank on the card (NCCL): per case, 3 AdamW steps
    of the sharded step and of the one-card step from the same parameters
    on the same batches; returns both runs' parameters and losses."""
    device = "cuda"
    mesh = C.dist.PartitionMesh(AXES, (1, 1))
    out = {}
    for name in names:
        cfg, params, batches = inputs(name)
        opt = optimizer(name)
        for run, step in (
                ("sharded", RT.make_sharded_recsys_train_step(
                    cfg, opt, mesh, rules=CASES[name][2])),
                ("one_card", RT.make_recsys_train_step(cfg, opt))):
            p = convert.tree_from_numpy(params, device)
            st, losses = opt.init(p), []
            for b in batches:
                p, st, m = step(p, st, RT.batch_to(b, device))
                losses.append(float(m["loss"]))
            out[(name, run)] = {"params": convert.tree_to_numpy(p),
                                "losses": losses}
    return out
