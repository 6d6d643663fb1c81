"""Static nn exchange plan of the degree-separated engine.

The (owner, local-dst) binning of nn edges is graph-static, so the
permutation/segment structure the point-to-point exchange needs (the
paper's "uniquification", turned into a static plan) is precomputed on the
host once. Arrays equal the reference package's plan for the same
partition.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from .types import PartitionedGraph


@dataclass
class ExchangePlan:
    """Static binning of nn edges by (owner partition, local dst id).

    ``recv_local`` is the receiver-side inverse: for (peer j, slot s) the
    local id that j's slot s refers to on THIS partition -- what makes the
    1-bit static-slot exchange possible (senders ship slot words,
    receivers decode locally).

    The device view (:func:`device_plan`) adds ``flat_seg``: ``seg_ids``
    offset per partition by ``k * (cap_total + 1)`` as one int64 vector, the
    scatter index of the stacked sender-side slot fold.
    """

    perm: Any        # [p, E_nn_max] int32: edge order sorted by (owner, local)
    seg_ids: Any     # [p, E_nn_max] int32: run index of unique (owner, local)
    seg_owner: Any   # [p, cap_total] int32: owner partition per unique dst (p = invalid)
    seg_pos: Any     # [p, cap_total] int32: slot within the owner's bin
    seg_local: Any   # [p, cap_total] int32: local id at the destination
    recv_local: Any = None  # [p, p, cap_peer] int32: (peer, slot) -> my local id
    cap_peer: int = 0   # per-peer slot capacity (multiple of 32)
    cap_total: int = 0  # unique (owner, local) capacity per partition
    flat_seg: Any = None  # [p * E_nn_max] int64 (device view only)


def build_exchange_plan(pg: PartitionedGraph) -> ExchangePlan:
    """Host-side: sort each partition's nn edges by (owner, local dst) and
    record the unique-destination segments and their slots."""
    p = pg.p
    e_max = pg.nn.e_max
    cols = np.asarray(pg.nn.cols)         # local dst id at the owner
    owners = np.asarray(pg.nn_owner)      # owner partition per nn edge
    m = np.asarray(pg.nn.m)

    perms = np.tile(np.arange(e_max, dtype=np.int32), (p, 1))
    seg_ids = np.zeros((p, e_max), dtype=np.int32)
    seg_data = []
    for k in range(p):
        mk = int(m[k])
        owner = owners[k, :mk]
        local = cols[k, :mk]
        order = np.lexsort((local, owner)).astype(np.int32)
        so, sl = owner[order], local[order]
        new_seg = np.ones(mk, dtype=bool)
        if mk > 1:
            new_seg[1:] = (so[1:] != so[:-1]) | (sl[1:] != sl[:-1])
        sid = np.cumsum(new_seg) - 1
        u_owner = so[new_seg]
        u_local = sl[new_seg]
        # slot within owner's bin
        u_pos = np.zeros(u_owner.shape[0], dtype=np.int32)
        for peer in range(p):
            sel = u_owner == peer
            u_pos[sel] = np.arange(sel.sum(), dtype=np.int32)
        perms[k, :mk] = order
        # padding edges get a dedicated trash segment
        seg_ids[k, :mk] = sid
        seg_ids[k, mk:] = (sid[-1] + 1) if mk else 0
        seg_data.append((u_owner, u_pos, u_local))

    cap_peer = 1
    for u_owner, _, _ in seg_data:
        if u_owner.size:
            cap_peer = max(cap_peer, int(np.bincount(u_owner, minlength=p).max()))
    cap_peer = -(-cap_peer // 32) * 32          # word-align for bit packing
    cap_total = max(1, max((u[0].size for u in seg_data), default=1))
    seg_owner = np.full((p, cap_total), p, dtype=np.int32)
    seg_pos = np.zeros((p, cap_total), dtype=np.int32)
    seg_local = np.zeros((p, cap_total), dtype=np.int32)
    recv_local = np.full((p, p, cap_peer), -1, dtype=np.int32)
    for k, (uo, up, ul) in enumerate(seg_data):
        seg_owner[k, : uo.size] = uo
        seg_pos[k, : up.size] = up
        seg_local[k, : ul.size] = ul
        # receiver-side inverse: owner j's table gets (sender k, slot) -> local
        recv_local[uo, k, up] = ul
    return ExchangePlan(
        perm=perms, seg_ids=seg_ids, seg_owner=seg_owner, seg_pos=seg_pos,
        seg_local=seg_local, recv_local=recv_local,
        cap_peer=cap_peer, cap_total=cap_total,
    )


def local_plan(plan: ExchangePlan, part: int) -> ExchangePlan:
    """Partition ``part``'s rows of a host plan alone (leading dimension 1;
    ``cap_peer`` / ``cap_total`` unchanged): what one rank of a sharded run
    holds. Its ``recv_local`` row is the receiver-side table of every
    peer's slots into ``part``."""
    p = int(np.asarray(plan.perm).shape[0])
    if not 0 <= part < p:
        raise ValueError(f"partition {part} not in [0, {p})")
    one = lambda a: np.asarray(a)[part:part + 1]
    return dataclasses.replace(
        plan, perm=one(plan.perm), seg_ids=one(plan.seg_ids),
        seg_owner=one(plan.seg_owner), seg_pos=one(plan.seg_pos),
        seg_local=one(plan.seg_local), recv_local=one(plan.recv_local))


def device_plan(plan: ExchangePlan, device) -> ExchangePlan:
    """The plan's arrays as tensors on ``device`` (reference dtypes), plus
    the flattened slot-fold index ``flat_seg``."""
    put = lambda a: torch.as_tensor(np.asarray(a)).to(device)
    p = int(np.asarray(plan.perm).shape[0])
    seg = put(plan.seg_ids).long()
    seg = seg + (torch.arange(p, device=seg.device) * (plan.cap_total + 1))[:, None]
    return dataclasses.replace(
        plan, perm=put(plan.perm), seg_ids=put(plan.seg_ids),
        seg_owner=put(plan.seg_owner), seg_pos=put(plan.seg_pos),
        seg_local=put(plan.seg_local), recv_local=put(plan.recv_local),
        flat_seg=seg.reshape(-1))
