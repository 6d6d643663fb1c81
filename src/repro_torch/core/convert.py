"""Carrying a partition, a plan, a traversal state and model weights
across packages.

The graph is this system's "weights": the partition and the exchange plan
move between the reference package and the port as plain numpy leaves
(``*_to_arrays`` read any object with the reference's attribute names), so
one partition can be fed to both and their states compared leaf by leaf
(:func:`state_to_numpy` for the msBFS state, :func:`bfs_state_to_numpy`
for the single-source state). The xDeepFM parameters keep the reference's
names and layouts, so they carry across by name
(:func:`xdeepfm_params_from_numpy`), to one card or sharded over the
ranks of a mesh (:func:`xdeepfm_shard_params`, and back:
:func:`xdeepfm_gather_params`); so do the GNN parameter trees and
the optimizer states (:func:`tree_from_numpy`, :func:`tree_to_numpy`:
MeshGraphNet's stacked ``layers`` included, nothing transposed). An LM
tree is cut into a mesh rank's shards and put back together by
:func:`lm_shard_params` and :func:`lm_gather_params`.
"""
from __future__ import annotations

import numpy as np
import torch

from .bfs import STATE_LEAVES as BFS_STATE_LEAVES, BFSState
from .engine import ExchangePlan
from .msbfs import STATE_LEAVES, MSBFSState
from repro_torch.models.recsys import COLD_LEAVES, XDeepFM, XDeepFMConfig
from repro_torch.tree import tree_map
from .types import CSR, PartitionedGraph

SUBGRAPHS = ("nn", "nd", "dn", "dd")
CSR_ARRAYS = ("offsets", "cols", "rowids", "m", "eidx")
CSR_META = ("n_rows", "e_max")
PG_ARRAYS = ("nn_owner", "delegate_vids", "normal_valid", "nd_src_mask",
             "dn_src_mask", "dd_src_mask")
PG_META = ("n", "p", "p_rank", "p_gpu", "d", "n_local", "th")
PLAN_ARRAYS = ("perm", "seg_ids", "seg_owner", "seg_pos", "seg_local",
               "recv_local")
PLAN_META = ("cap_peer", "cap_total")


def partition_to_arrays(pg) -> tuple[dict, dict]:
    """``(arrays, meta)`` of a host partition: arrays keyed ``"nn.offsets"``
    ... and ``"nn_owner"`` ..., meta the integer fields (including each
    CSR's ``"nn.n_rows"`` / ``"nn.e_max"``)."""
    arrays = {k: np.asarray(getattr(pg, k)) for k in PG_ARRAYS}
    meta = {k: int(getattr(pg, k)) for k in PG_META}
    for s in SUBGRAPHS:
        csr = getattr(pg, s)
        for a in CSR_ARRAYS:
            arrays[f"{s}.{a}"] = np.asarray(getattr(csr, a))
        for m in CSR_META:
            meta[f"{s}.{m}"] = int(getattr(csr, m))
    return arrays, meta


def partition_from_arrays(arrays: dict, meta: dict) -> PartitionedGraph:
    """The port's host :class:`PartitionedGraph` from numpy leaves."""
    csrs = {s: CSR(**{a: np.asarray(arrays[f"{s}.{a}"]) for a in CSR_ARRAYS},
                   **{m: int(meta[f"{s}.{m}"]) for m in CSR_META})
            for s in SUBGRAPHS}
    return PartitionedGraph(
        **{k: int(meta[k]) for k in PG_META},
        **{k: np.asarray(arrays[k]) for k in PG_ARRAYS}, **csrs)


def plan_to_arrays(plan) -> tuple[dict, dict]:
    return ({k: np.asarray(getattr(plan, k)) for k in PLAN_ARRAYS},
            {k: int(getattr(plan, k)) for k in PLAN_META})


def plan_from_arrays(arrays: dict, meta: dict) -> ExchangePlan:
    """The port's host :class:`ExchangePlan` from numpy leaves."""
    return ExchangePlan(**{k: np.asarray(arrays[k]) for k in PLAN_ARRAYS},
                        **{k: int(meta[k]) for k in PLAN_META})


def state_to_numpy(state: MSBFSState) -> dict:
    """Every :class:`MSBFSState` leaf as a host numpy array (lane words
    stay int32 bit patterns; ``.view(np.uint32)`` gives the reference's
    uint32), the payload plane's real-width leaves of a ``cfg.payload``
    state included."""
    return {k: getattr(state, k).detach().cpu().numpy() for k in STATE_LEAVES}


def bfs_state_to_numpy(state: BFSState) -> dict:
    """Every :class:`~repro_torch.core.bfs.BFSState` leaf
    (``BFS_STATE_LEAVES``) as a host numpy array."""
    return {k: getattr(state, k).detach().cpu().numpy()
            for k in BFS_STATE_LEAVES}


def xdeepfm_params_from_numpy(params: dict, cfg: XDeepFMConfig,
                              device="cuda") -> XDeepFM:
    """The port's :class:`XDeepFM` computing the same function as the
    reference's parameter dict ``params`` (``{name: np.ndarray}``, e.g.
    ``jax.tree.map(np.asarray, materialize(xdeepfm_param_specs(cfg)))``):
    same names, same layouts, nothing transposed."""
    return XDeepFM(cfg, device=device,
                   params={k: torch.from_numpy(np.array(v))
                           for k, v in params.items()})


def xdeepfm_shard_params(params: dict, rank: int, p: int) -> dict:
    """Shard ``rank`` of ``p`` of an xDeepFM parameter dict (numpy arrays
    or tensors, e.g. the reference's): cold row ``i`` of ``emb_cold`` /
    ``lin_cold`` goes to shard ``i % p`` at local row ``i // p`` (ragged
    shards where ``p`` does not divide ``n_cold``); every other leaf is
    replicated (returned as given). On a mesh, ``rank`` and ``p`` are a
    rank's position and count over the axes its ``table_rows`` rule
    names (:func:`repro_torch.models.recsys.table_axes`). Works on any
    dict with the parameter names, such as AdamW's ``m`` and ``v``."""
    def cut(v):
        v = v[rank::p]
        return v.contiguous() if torch.is_tensor(v) else np.ascontiguousarray(v)
    return {k: cut(v) if k in COLD_LEAVES else v for k, v in params.items()}


def xdeepfm_gather_params(shards: list) -> dict:
    """Inverse of :func:`xdeepfm_shard_params`: the shards' dicts, in
    shard order, as one dict (the cold rows interleaved back, the replicated
    leaves taken from rank 0)."""
    p = len(shards)
    out = dict(shards[0])
    for k in COLD_LEAVES:
        parts = [s[k] for s in shards]
        n = sum(x.shape[0] for x in parts)
        if torch.is_tensor(parts[0]):
            full = parts[0].new_empty((n,) + tuple(parts[0].shape[1:]))
        else:
            full = np.empty((n,) + parts[0].shape[1:], parts[0].dtype)
        for r, x in enumerate(parts):
            full[r::p] = x
        out[k] = full
    return out


def array_to_tensor(a) -> torch.Tensor:
    """A host array as a tensor of its dtype; a bfloat16 array
    (``ml_dtypes.bfloat16``, what ``np.asarray`` makes of a JAX bfloat16
    array, or its raw 2-byte ``V2`` form) is carried bit for bit through
    its int16 view, since ``torch.from_numpy`` takes no such dtype."""
    a = np.array(a)
    if a.dtype.name == "bfloat16" or a.dtype == np.dtype("V2"):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def tensor_to_array(t: torch.Tensor) -> np.ndarray:
    """Inverse of :func:`array_to_tensor`: a bfloat16 tensor comes back as
    an ``ml_dtypes.bfloat16`` array (``ml_dtypes`` is imported only for
    such a tensor)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def tree_from_numpy(tree, device="cuda"):
    """A reference parameter or optimizer-state tree of numpy arrays (e.g.
    ``jax.tree.map(np.asarray, params)``; nested dicts) as the port's:
    the same names and layouts, tensors of the same dtypes on ``device``
    (0-d arrays, such as an optimizer's ``step``, stay 0-d; bfloat16 leaves
    bit for bit, :func:`array_to_tensor`)."""
    return tree_map(lambda a: array_to_tensor(a).to(device), tree)


def tree_to_numpy(tree):
    """Inverse of :func:`tree_from_numpy`: every tensor leaf as a host
    numpy array, names and layouts unchanged (:func:`tensor_to_array`)."""
    return tree_map(tensor_to_array, tree)


def lm_shard_params(tree, cfg, rules: dict, layout):
    """A rank's shards of a whole LM parameter tree (the reference's numpy
    parameters, or the port's tensors): each leaf cut by its
    ``ParamSpec.axes`` under ``rules`` (``repro_torch.launch.sharding``)
    into the block the rank at ``layout`` (a ``MeshLayout``, or a
    ``PartitionMesh``) holds -- the slice of the one-device tree. Works on
    any tree of the parameters' structure (AdamW's ``m`` and ``v``)."""
    from repro_torch.launch.sharding import (MeshLayout, layout_of,
                                             param_shardings, shard_tree)
    from repro_torch.models.lm import lm_param_specs, lm_units

    if not isinstance(layout, MeshLayout):
        layout = layout_of(layout)
    return shard_tree(tree, param_shardings(lm_param_specs(cfg), rules,
                                            lm_units(cfg)), layout)


def lm_gather_params(shards: list, cfg, rules: dict, axes, sizes):
    """Inverse of :func:`lm_shard_params`: every rank's shards, in rank
    order, on a mesh of ``axes`` / ``sizes``, as the whole tree."""
    from repro_torch.launch.sharding import gather_tree, param_shardings
    from repro_torch.models.lm import lm_param_specs, lm_units

    return gather_tree(shards, param_shardings(lm_param_specs(cfg), rules,
                                               lm_units(cfg)), axes, sizes)
