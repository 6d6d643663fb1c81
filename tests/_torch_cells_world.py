"""World function of the cell tests (``test_torch_cells.py``).

One gloo rank (a world of one, mesh ``(data 1, model 1)``) builds every
cell of ``CASES`` at smoke (``launch.cells.build_cell``), draws its
arguments from ``SEED`` on the CPU (``cell.args``) and runs its step once.
It returns, as numpy, what the parent feeds the reference (the arguments
of the LM, recsys and batched GNN cells; the parent rebuilds a graph
cell's partition from the same seed) and the step's outputs. Port
imports only: a spawned rank imports no JAX."""
import numpy as np
import torch

from repro_torch.core import convert
from repro_torch.core.bfs import BFSState
from repro_torch.launch import cells, mesh as M

SEED = 0


def _np(tree):
    return convert.tree_to_numpy(tree)


def summary(cell, args, out) -> dict:
    """What the parent compares: the arguments it needs and the outputs,
    by the cell's kind."""
    kind = cell.kind
    if kind in ("train", "minibatch", "batched_small", "dist_full"):
        params, _, metrics = out
        loss = metrics["loss"] if isinstance(metrics, dict) else metrics
        res = {"loss": float(loss), "params": _np(params),
               "start": _np(args[0])}
        if kind != "dist_full":
            res["args"] = _np(args[2])
        return res
    if kind in ("prefill", "decode"):
        logits, cache = out
        res = {"logits": logits.numpy(), "cache": _np(cache),
               "params": _np(args[0])}
        if kind == "prefill":
            res["tokens"] = args[1].numpy()
        else:
            res.update(cache_in=_np(args[1]), token=args[2].numpy(),
                       pos=int(args[3]))
        return res
    if kind == "serve":
        return {"logits": out.numpy(), "params": _np(args[0]),
                "batch": _np(args[1])}
    if kind == "retrieval":
        return {"scores": out[0].numpy(), "ids": out[1].numpy(),
                "params": _np(args[0]), "batch": _np(args[1]),
                "candidates": args[2].numpy()}
    assert isinstance(out, BFSState)
    return {"state": convert.bfs_state_to_numpy(out)}


def cells_world(rank: int, world: int, cases: list) -> dict:
    mesh = M.make_test_mesh((1, 1))
    out = {}
    for arch, shape in cases:
        cell = cells.build_cell(arch, shape, mesh, smoke=True)
        # the cache a decode step writes in place: keep the drawn one
        args = cell.args(SEED, "cpu")
        if cell.kind == "decode":
            kept = [{k: v.clone() for k, v in c.items()} for c in args[1]]
            res = summary(cell, args, cell.step(*args))
            res["cache_in"] = _np(kept)
        else:
            res = summary(cell, args, cell.step(*args))
        out[arch, shape] = res
    return out
