"""Point-to-point frontier exchange (paper Section V-B), dense format.

Normal-vertex updates travel peer-to-peer over the static (owner, local)
slot layout of the :class:`~repro_torch.core.engine.ExchangePlan`: one bit
per (slot, query), packed into lane words -- fixed volume per sweep. In
the emulated backend the all_to_all of the stacked ``[p_send, p_recv,
cap_peer, nw]`` words is a transpose of the two partition axes.
"""
from __future__ import annotations

import torch

from .base import CommPlan
from .wire import n_words, pack_lanes, unpack_lanes


def _scatter_recv_words(rlanes: torch.Tensor, loc: torch.Tensor,
                        nl: int) -> torch.Tensor:
    """Scatter received lane words onto local normal ids (-1 loc = dead).

    ``rlanes [p, ..., W]`` bool and ``loc [p, ...]`` int32 per receiving
    partition; returns ``[p, nl, W]`` bool (scatter-OR as an int32
    scatter-add followed by ``> 0``: OR is order-free, so this is
    deterministic)."""
    p, w = rlanes.shape[0], rlanes.shape[-1]
    idx = loc.reshape(p, -1).long().clamp(0, nl - 1)
    idx = (idx + torch.arange(p, device=idx.device)[:, None] * nl).reshape(-1)
    vals = (rlanes & (loc >= 0)[..., None]).reshape(-1, w)
    out = torch.zeros((p * nl, w), dtype=torch.int32, device=rlanes.device)
    out.index_add_(0, idx, vals.to(torch.int32))
    return (out > 0).reshape(p, nl, w)


def nn_exchange_words(plan: CommPlan, dense: torch.Tensor,
                      recv_local: torch.Tensor, nl: int):
    """Dense lane-word nn exchange over the stacked partitions.

    ``dense [p, p, cap_peer, W] bool`` is each sender's slot occupancy
    (row j of sender i = "slot s of peer j's bin carries these lanes");
    ``recv_local [p, p, cap_peer] int32`` the receiver-side slot -> local
    id tables. Returns ``(recv [p, nl, W] bool, wire_bytes, sparse_used,
    overflow)`` -- the last three Python ints, as the dense format's bytes
    are a static formula and it never drops a slot."""
    if plan.cfg.nn != "dense":
        raise NotImplementedError(
            f"nn={plan.cfg.nn!r} is not ported yet: ROADMAP.md queue A, "
            "item A3 (comm strategies)")
    p, _, cap, w = dense.shape
    nw = n_words(w)
    rwords = pack_lanes(dense).transpose(0, 1)          # the all_to_all
    recv = _scatter_recv_words(unpack_lanes(rwords, w), recv_local, nl)
    return recv, plan.nn_dense_words_bytes(cap, nw), 0, 0
