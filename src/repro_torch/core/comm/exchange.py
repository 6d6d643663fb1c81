"""Point-to-point frontier exchange (paper Section V-B).

Normal-vertex updates travel peer-to-peer. Two layouts:

* the static (owner, local) slot layout of the
  :class:`~repro_torch.core.engine.ExchangePlan`, dense format: one bit per
  (slot, query) packed into lane words for the batched path
  (:func:`nn_exchange_words`), one bit per slot for the single-source path
  (:func:`nn_exchange_bits`) -- fixed volume per sweep;
* the legacy runtime-binned exchange of the single-source path
  (:func:`bin_by_owner` + :func:`exchange_normal`): active destination ids
  sorted into per-owner bins of ``cap`` int32 ids.

In the emulated backend every all_to_all of a stacked ``[p_send, p_recv,
...]`` buffer is a transpose of the two partition axes.
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


def bin_by_owner(owner: torch.Tensor, local: torch.Tensor,
                 active: torch.Tensor, *, p: int, cap: int,
                 uniquify: bool = False):
    """Group active destination ids into per-owner-partition bins.

    ``owner`` / ``local`` ``[P, E]`` are the pre-split int32 destination
    coordinates of each stacked partition's edge slots, ``active [P, E]``
    bool. Returns ``(buf [P, p, cap] int32 local ids, -1 padded; overflow
    [P] int32; sent [P] int32)``, per partition exactly the reference's
    sort-and-scatter. The reference's lexsort by (owner, local) is one sort
    of the int64 key ``owner << 32 | local`` (local ids are >= 0); entries
    with equal keys carry equal values, so sort stability does not matter.
    """
    big, e = owner.shape
    key = torch.where(active, owner.long(), p)
    comb, _ = torch.sort((key << 32) | local.long(), dim=1)
    if uniquify:
        # drop duplicate (owner, local) pairs: they become key p, resorted
        # to the end
        keep = torch.ones_like(comb, dtype=torch.bool)
        keep[:, 1:] = comb[:, 1:] != comb[:, :-1]
        dropped = (p << 32) | (comb & 0xFFFFFFFF)
        comb, _ = torch.sort(torch.where(keep, comb, dropped), dim=1)
    sk, sl = comb >> 32, (comb & 0xFFFFFFFF).to(torch.int32)
    run_start = torch.searchsorted(sk, sk, side="left")
    pos = torch.arange(e, device=owner.device) - run_start
    is_real = sk < p
    in_cap = is_real & (pos < cap)
    sent = in_cap.sum(1, dtype=torch.int32)
    overflow = is_real.sum(1, dtype=torch.int32) - sent
    # scatter-max into -1 padded bins; out-of-cap entries write -1 at
    # (0, 0), a no-op under max
    flat = torch.where(in_cap, sk * cap + pos, 0)
    flat = flat + torch.arange(big, device=owner.device)[:, None] * (p * cap)
    buf = torch.full((big * p * cap,), -1, dtype=torch.int32,
                     device=owner.device)
    buf.scatter_reduce_(0, flat.reshape(-1),
                        torch.where(in_cap, sl, -1).reshape(-1), "amax",
                        include_self=True)
    return buf.reshape(big, p, cap), overflow, sent


def exchange_normal(buf: torch.Tensor) -> torch.Tensor:
    """All-to-all of the binned buffers ``[p_send, p_recv, cap]`` ->
    received ``[p_recv, p_send, cap]``."""
    return buf.transpose(0, 1)


def nn_exchange_bits(plan: CommPlan, active: torch.Tensor,
                     recv_local: torch.Tensor, nl: int):
    """Dense single-bit nn exchange over the stacked partitions (the
    single-source path).

    ``active [p, p, cap_peer] bool`` marks each sender's occupied slots
    (row j of sender i = slots of peer j's bin); ``recv_local [p, p,
    cap_peer] int32`` the receiver-side slot -> local id tables. The slot
    axis ships as a bitmask, packed like a lane axis (``cap_peer / 8``
    bytes per peer). Returns ``(recv [p, nl] bool, wire_bytes,
    sparse_used, overflow)`` -- the last three Python ints, as the dense
    format's bytes are a static formula and it never drops a slot."""
    if plan.cfg.nn != "dense":
        raise NotImplementedError(
            f"nn={plan.cfg.nn!r} is not ported yet: ROADMAP.md queue A, "
            "item A3 (comm strategies)")
    cap = active.shape[-1]
    rbits = unpack_lanes(pack_lanes(active).transpose(0, 1), cap)
    recv = _scatter_recv_words(rbits[..., None], recv_local, nl)[..., 0]
    return recv, plan.nn_dense_bits_bytes(cap), 0, 0


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
