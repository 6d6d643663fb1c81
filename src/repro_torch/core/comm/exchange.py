"""Point-to-point frontier exchange (paper Section V-B), with pluggable
wire formats, over either backend.

Normal-vertex updates travel peer-to-peer. Over the static (owner, local)
slot layout of the :class:`~repro_torch.core.engine.ExchangePlan`:

* **dense** -- one bit per (slot, query): lane words for the batched path
  (:func:`nn_exchange_words`), a slot bitmask for the single-source path
  (:func:`nn_exchange_bits`); one int32 per (slot, query) for the payload
  plane (:func:`nn_exchange_payload`, receivers fold with min); fixed
  volume per sweep;
* **sparse** -- only active slots ship, as (slot id, lane word) pairs or
  bare slot ids, capped per peer; active slots beyond the cap are dropped
  and counted in the returned overflow (a valid run needs 0);
* **adaptive** -- per sweep, sparse when every peer's active-slot count
  fits the cap and dense otherwise, agreed over all partitions through one
  scalar max. Emulated, both receive sets are computed and one is selected
  on the device (nothing crosses a real wire, and no host read breaks a
  captured sweep); distributed, the host reads the agreed scalar and ships
  only the chosen format, so the counters report exactly the bytes sent;
* **compressed** -- the adaptive transport (dense where sparse can never
  win), counted as the exact bytes of the cheaper of two varint streams of
  each peer's active slot ids (:mod:`.codec`), plus the slots' lane words
  or payload values; the sparse flag then reports which stream won (1 =
  delta ids, 0 = rle bitmap).

The generalized engine's (ids, feature rows) exchange is
:func:`exchange_payload`.

The legacy runtime-binned exchange of the single-source path
(:func:`bin_by_owner` + :func:`exchange_normal`) sorts active destination
ids into per-owner bins of ``cap`` int32 ids.

Every all_to_all of a ``[rows, p, ...]`` buffer (row ``j`` of a sender
goes to partition ``j``) is a transpose of the two partition axes when
emulated and an ``all_to_all_single`` over the mesh when distributed.
"""
from __future__ import annotations

import torch

from . import dist as D
from .base import COMBINE_SPECS, CommPlan, plan_for
from .codec import compressed_wire_bytes
from .wire import n_words, pack_lanes, unpack_lanes

#: the payload plane's "nothing arrived" value: the min_plus identity
PAY_IDENT = int(COMBINE_SPECS["min_plus"].identity)


def _a2a(plan: CommPlan, x: torch.Tensor) -> torch.Tensor:
    """``x [rows, p, ...]`` -> received ``[rows, p, ...]`` (row ``j`` of
    the result came from partition ``j``)."""
    if plan.mesh is None:
        return x.transpose(0, 1)
    return D.all_to_all(plan.mesh, x[0])[None]


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


def exchange_values(buf_vals: torch.Tensor, plan: CommPlan) -> torch.Tensor:
    """All-to-all of feature rows ``buf_vals [rows, p, cap, F]`` ->
    received, row ``j`` from partition ``j``, differentiable: emulated
    through the transpose, over a mesh through
    :class:`~repro_torch.core.comm.dist.AllToAll` (the reverse
    all-to-all)."""
    if plan.mesh is None:
        return buf_vals.transpose(0, 1)
    return D.AllToAll.apply(buf_vals[0].contiguous(), plan.mesh)[None]


def exchange_payload(buf_ids: torch.Tensor, buf_vals: torch.Tensor,
                     plan: CommPlan):
    """All-to-all of (ids, payload) pairs, for the generalized engine
    (feature vectors instead of 1-bit visited status, paper Section VI-D):
    ``buf_ids [rows, p, cap]`` int32 and ``buf_vals [rows, p, cap, F]`` ->
    received (:func:`exchange_normal`, :func:`exchange_values`)."""
    return exchange_normal(buf_ids, plan), exchange_values(buf_vals, plan)


def exchange_words(words: torch.Tensor, p) -> torch.Tensor:
    """All-to-all of packed lane words ``[rows, p * cap, nw]`` over the
    emulated axes ``p`` (an int or ``{name: size}``) or a mesh: block ``j``
    of ``cap`` slots goes to partition ``j``; returns ``[rows, p * cap,
    nw]`` whose block ``j`` came from partition ``j``. The static-slot
    analog of :func:`exchange_normal` for batched queries: ``cap_total *
    nw * 4`` bytes a partition, whatever the number of active queries."""
    plan = plan_for(None, p)
    rows, slots, nw = words.shape
    blocks = words.reshape(rows, plan.p, slots // plan.p, nw)
    return _a2a(plan, blocks).reshape(rows, slots, nw)


def exchange_normal(buf: torch.Tensor, plan: CommPlan | None = None
                    ) -> torch.Tensor:
    """All-to-all of the binned buffers ``[rows, p, cap]`` -> received
    ``[rows, p, cap]`` (a transpose when ``plan`` is None or emulated)."""
    return buf.transpose(0, 1) if plan is None else _a2a(plan, buf)


def _compact_active(act: torch.Tensor, cap_sparse: int):
    """Per peer row, the first ``cap_sparse`` active slot positions of
    ``act [rows, p, cap]``: ``(ids [rows, p, S] int32, -1 padded; valid
    [rows, p, S] bool; overflow [rows] int32)`` -- the active slots beyond
    the cap, summed over peers. The order is a stable sort (the
    reference's ``jnp.argsort``), so a pinned cap keeps the lowest slots."""
    cnt = act.sum(-1, dtype=torch.int32)                    # [rows, p]
    order = torch.argsort((~act).to(torch.uint8), dim=-1, stable=True)
    take = order[..., :cap_sparse].to(torch.int32)
    k = torch.arange(cap_sparse, dtype=torch.int32, device=act.device)
    valid = k < cnt.clamp(max=cap_sparse)[..., None]
    overflow = (cnt - cap_sparse).clamp(min=0).sum(-1, dtype=torch.int32)
    return torch.where(valid, take, -1), valid, overflow


def _received_local(recv_local: torch.Tensor, r_ids: torch.Tensor):
    """Receiver-side local ids of the received slot ids (-1 stays dead)."""
    cap = recv_local.shape[-1]
    loc = recv_local.gather(-1, r_ids.clamp(0, cap - 1).long())
    return torch.where(r_ids >= 0, loc, -1)


def _adaptive(plan: CommPlan, act: torch.Tensor, cap_sparse: int, dense,
              sparse, sparse_bytes: int, dense_bytes: int):
    """The adaptive switch: sparse iff no partition has a peer row with
    more than ``cap_sparse`` active slots. Returns ``(recv, wire_bytes,
    sparse_used, overflow)``."""
    local_max = act.sum(-1, dtype=torch.int32).amax(-1)      # [rows]
    if plan.mesh is None:
        feasible = local_max.amax() <= cap_sparse
        recv = torch.where(feasible, sparse()[0], dense())
        nbytes = torch.where(feasible, sparse_bytes, dense_bytes).to(
            torch.int32)
        return recv, nbytes, feasible.to(torch.int32), 0
    agreed = D.all_reduce(plan.mesh, local_max, "max")
    if int(agreed[0]) <= cap_sparse:            # one host read a sweep
        return sparse()[0], sparse_bytes, 1, 0
    return dense(), dense_bytes, 0, 0


def _compressed(plan: CommPlan, act: torch.Tensor, nw: int, cap_sparse: int,
                dense, sparse, sparse_bytes: int, dense_bytes: int):
    """The compressed format: the adaptive transport (dense where sparse
    can never win), counted as the codec's exact stream bytes with ``nw *
    4`` bytes per active slot. Returns ``(recv, wire_bytes [rows],
    delta_used [rows], 0)``: the adaptive switch never drops a slot."""
    wire, delta_used = compressed_wire_bytes(plan, act, nw)
    if sparse_bytes >= dense_bytes:
        recv = dense()
    else:
        recv = _adaptive(plan, act, cap_sparse, dense, sparse, sparse_bytes,
                         dense_bytes)[0]
    return recv, wire, delta_used, 0


def nn_exchange_bits(plan: CommPlan, active: torch.Tensor,
                     recv_local: torch.Tensor, nl: int):
    """Single-bit nn exchange (the single-source path).

    ``active [rows, p, cap_peer] bool`` marks each sender's occupied slots
    (row j = slots of peer j's bin); ``recv_local [rows, p, cap_peer]
    int32`` the receiver-side slot -> local id tables. Dense ships the slot
    bitmask (``cap_peer / 8`` bytes per peer), sparse the active slot ids
    (4 bytes each, capped). Returns ``(recv [rows, nl] bool, wire_bytes,
    sparse_used, overflow)``: Python ints where the format fixes them,
    tensors where the data decides (emulated adaptive: replicated scalars;
    pinned sparse: overflow ``[rows]``)."""
    cap = active.shape[-1]
    dense_bytes = plan.nn_dense_bits_bytes(cap)
    cap_sparse = plan.sparse_cap_bits(cap)
    sparse_bytes = plan.nn_sparse_bits_bytes(cap_sparse)

    def dense():
        rbits = unpack_lanes(_a2a(plan, pack_lanes(active)), cap)
        return _scatter_recv_words(rbits[..., None], recv_local, nl)[..., 0]

    def sparse():
        ids, _, overflow = _compact_active(active, cap_sparse)
        loc = _received_local(recv_local, _a2a(plan, ids))
        return (_scatter_recv_words((loc >= 0)[..., None], loc, nl)[..., 0],
                overflow)

    mode = plan.cfg.nn
    if mode == "compressed":
        return _compressed(plan, active, 0, cap_sparse, dense, sparse,
                           sparse_bytes, dense_bytes)
    if mode == "adaptive" and sparse_bytes >= dense_bytes:
        mode = "dense"                      # sparse can never win: skip it
    if mode == "dense":
        return dense(), dense_bytes, 0, 0
    if mode == "sparse":
        recv, overflow = sparse()
        return recv, sparse_bytes, 1, overflow
    return _adaptive(plan, active, cap_sparse, dense, sparse, sparse_bytes,
                     dense_bytes)


def nn_exchange_words(plan: CommPlan, dense: torch.Tensor,
                      recv_local: torch.Tensor, nl: int):
    """Lane-word nn exchange.

    ``dense [rows, p, cap_peer, W] bool`` is each sender's slot occupancy
    (row j = "slot s of peer j's bin carries these lanes");
    ``recv_local [rows, p, cap_peer] int32`` the receiver-side slot ->
    local id tables. Dense ships every slot's lane words, sparse the
    active slots as (slot id, lane words) pairs, capped per peer. Returns
    ``(recv [rows, nl, W] bool, wire_bytes, sparse_used, overflow)``, as
    :func:`nn_exchange_bits` types them."""
    cap, w = dense.shape[-2:]
    nw = n_words(w)
    dense_bytes = plan.nn_dense_words_bytes(cap, nw)
    cap_sparse = plan.sparse_cap_words(cap)
    sparse_bytes = plan.nn_sparse_words_bytes(cap_sparse, nw)
    act = dense.any(-1)                                     # [rows, p, cap]

    def dense_path():
        rwords = _a2a(plan, pack_lanes(dense))              # the all_to_all
        return _scatter_recv_words(unpack_lanes(rwords, w), recv_local, nl)

    def sparse_path():
        ids, valid, overflow = _compact_active(act, cap_sparse)
        slots = dense.gather(2, ids.clamp(min=0).long()[..., None].expand(
            ids.shape + (w,)))
        sw = pack_lanes(slots & valid[..., None])           # [rows, p, S, nw]
        loc = _received_local(recv_local, _a2a(plan, ids))
        rlanes = unpack_lanes(_a2a(plan, sw), w)
        return _scatter_recv_words(rlanes, loc, nl), overflow

    mode = plan.cfg.nn
    if mode == "compressed":
        return _compressed(plan, act, nw, cap_sparse, dense_path,
                           sparse_path, sparse_bytes, dense_bytes)
    if mode == "adaptive" and sparse_bytes >= dense_bytes:
        mode = "dense"                      # sparse can never win: skip it
    if mode == "dense":
        return dense_path(), dense_bytes, 0, 0
    if mode == "sparse":
        recv, overflow = sparse_path()
        return recv, sparse_bytes, 1, overflow
    return _adaptive(plan, act, cap_sparse, dense_path, sparse_path,
                     sparse_bytes, dense_bytes)


def _scatter_recv_payload(rvals: torch.Tensor, loc: torch.Tensor,
                          nl: int) -> torch.Tensor:
    """Scatter-min received payload rows onto local normal ids (-1 loc =
    dead slot, which carries the identity: a no-op under min).
    ``rvals [p, ..., W]`` int32 and ``loc [p, ...]`` per receiving
    partition -> ``[p, nl, W]`` int32, the identity where nothing
    arrived. Min is order-free, so the scatter is exact."""
    p, w = rvals.shape[0], rvals.shape[-1]
    idx = loc.reshape(p, -1).long().clamp(0, nl - 1)
    idx = (idx + torch.arange(p, device=idx.device)[:, None] * nl).reshape(-1)
    vals = torch.where((loc >= 0)[..., None], rvals, PAY_IDENT)
    out = torch.full((p * nl, w), PAY_IDENT, dtype=torch.int32,
                     device=rvals.device)
    out.scatter_reduce_(0, idx[:, None].expand(-1, w), vals.reshape(-1, w),
                        "amin")
    return out.reshape(p, nl, w)


def nn_exchange_payload(plan: CommPlan, dense_pay: torch.Tensor,
                        recv_local: torch.Tensor, nl: int):
    """Per-lane *payload* nn exchange (the ``min_plus`` combine).

    ``dense_pay [rows, p, cap_peer, W]`` int32 carries each slot's
    per-lane distance or label candidates (the identity for lanes with
    nothing to ship); a slot is *active* when a lane carries less than the
    identity. Dense ships ``cap_peer * W`` int32 per peer, sparse the
    active slots as (slot id, ``W`` int32) records capped per peer,
    adaptive switches as for the lane words; receivers fold duplicates
    with min. Returns ``(recv [rows, nl, W] int32 -- the identity where
    nothing arrived, wire_bytes, sparse_used, overflow)``, as
    :func:`nn_exchange_bits` types them."""
    cap, w = dense_pay.shape[-2:]
    dense_bytes = plan.nn_dense_payload_bytes(cap, w)
    cap_sparse = plan.sparse_cap_words(cap)
    sparse_bytes = plan.nn_sparse_payload_bytes(cap_sparse, w)
    act = (dense_pay < PAY_IDENT).any(-1)                   # [rows, p, cap]

    def dense_path():
        return _scatter_recv_payload(_a2a(plan, dense_pay), recv_local, nl)

    def sparse_path():
        ids, valid, overflow = _compact_active(act, cap_sparse)
        sv = dense_pay.gather(2, ids.clamp(min=0).long()[..., None].expand(
            ids.shape + (w,)))
        sv = torch.where(valid[..., None], sv, PAY_IDENT)   # [rows, p, S, W]
        loc = _received_local(recv_local, _a2a(plan, ids))
        return _scatter_recv_payload(_a2a(plan, sv), loc, nl), overflow

    mode = plan.cfg.nn
    if mode == "compressed":            # the id stream + W int32 a slot
        return _compressed(plan, act, w, cap_sparse, dense_path,
                           sparse_path, sparse_bytes, dense_bytes)
    if mode == "adaptive" and sparse_bytes >= dense_bytes:
        mode = "dense"                      # sparse can never win: skip it
    if mode == "dense":
        return dense_path(), dense_bytes, 0, 0
    if mode == "sparse":
        recv, overflow = sparse_path()
        return recv, sparse_bytes, 1, overflow
    return _adaptive(plan, act, cap_sparse, dense_path, sparse_path,
                     sparse_bytes, dense_bytes)
