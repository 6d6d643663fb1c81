"""Mixture-of-Experts layer: top-k routing with capacity-bounded dispatch
-- the port of ``repro.models.moe``.

Shared experts are the delegates of the token->expert bipartite graph:
every token touches them, so they are one dense branch with no routing;
routed experts are the normal class: each token touches k of E, dispatched
into ``[E_pad, C, D]`` buffers of at most C tokens an expert.

Which tokens survive capacity follows the reference bit for bit: top-k
ties go to the lower expert index (as ``lax.top_k``), the (token, slot)
pairs are sorted by expert with a stable sort (as ``jnp.argsort``), and
a pair's position in its expert's queue is its rank among the pairs of
that expert (``searchsorted(side="left")``). On a mesh
(:func:`moe_apply_mesh`) the same pairs survive as on one device over
the global batch.
"""
from __future__ import annotations

import math

import torch

from .common import ParamSpec, swiglu


def moe_param_specs(l: int, d: int, cfg) -> dict:
    e = cfg.n_experts_pad
    fe = cfg.d_ff_expert
    dt = cfg.dtype
    specs = {
        "router": ParamSpec((l, d, cfg.n_experts), torch.float32,
                            ("layers", "embed", ""), "scaled"),
        "we_gate": ParamSpec((l, e, d, fe), dt,
                             ("layers", "experts", "moe_embed", ""), "scaled"),
        "we_up": ParamSpec((l, e, d, fe), dt,
                           ("layers", "experts", "moe_embed", ""), "scaled"),
        "we_down": ParamSpec((l, e, fe, d), dt,
                             ("layers", "experts", "", "moe_embed"), "scaled"),
    }
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * fe
        specs.update({
            "ws_gate": ParamSpec((l, d, fs), dt, ("layers", "embed", "ff"), "scaled"),
            "ws_up": ParamSpec((l, d, fs), dt, ("layers", "embed", "ff"), "scaled"),
            "ws_down": ParamSpec((l, fs, d), dt, ("layers", "ff", "embed"), "scaled"),
        })
    return specs


def capacity(t: int, cfg) -> int:
    """Slots an expert holds for ``t`` tokens: ``t * k / E`` times the
    capacity factor, rounded up to a multiple of 8, at least 8."""
    cap = int(math.ceil(t * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return max(8, -(-cap // 8) * 8)


def top_k_lower_first(probs: torch.Tensor, k: int) -> tuple:
    """``(values, indices)`` of the ``k`` largest entries of each row, ties
    to the lower index (``lax.top_k``'s order; ``torch.topk`` breaks ties
    otherwise)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def kept_pairs(top_i: torch.Tensor, cap: int,
               offsets: torch.Tensor | None = None) -> tuple:
    """The (token, slot) pairs sorted by expert (stable): ``(order, es,
    pos, keep)`` -- the pairs' flat indices, their experts, their positions
    in their experts' queues (plus ``offsets[e]``, the pairs of expert
    ``e`` queued before this set, such as on lower data ranks) and whether
    each survives the capacity ``cap``."""
    t, k = top_i.shape
    e_flat = top_i.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    es = e_flat[order]
    pos = (torch.arange(t * k, device=es.device)
           - torch.searchsorted(es, es, side="left"))
    if offsets is not None:
        pos = pos + offsets.to(pos.dtype)[es]
    return order, es, pos, pos < cap


def dispatch(top_i: torch.Tensor, top_w: torch.Tensor, cap: int,
             e_pad: int, *, offsets: torch.Tensor | None = None,
             experts: tuple | None = None, local_slots: bool = False) -> tuple:
    """``(disp_tok [E_pad, C] int, disp_w [E_pad, C] f32)``: the token in
    each expert's slot (-1: empty) and its routing weight. The (token,
    slot) pairs are sorted by expert (stable); a pair past its expert's
    ``cap`` is dropped.

    On a mesh (:func:`kept_pairs`' ``offsets``: a pair's queue position
    counts its expert's pairs on lower data ranks): ``experts = (lo, hi)``
    keeps the rows of those experts only, and ``local_slots`` places a
    pair at its position among this set's pairs (which a kept pair's
    global position bounds)."""
    t, k = top_i.shape
    order, es, pos, keep = kept_pairs(top_i, cap, offsets)
    slot = pos - offsets.to(pos.dtype)[es] if local_slots else pos
    tok_s = order // k
    w_s = top_w.reshape(-1)[order]
    lo, hi = (0, e_pad) if experts is None else experts
    keep = keep & (es >= lo) & (es < hi)
    flat = torch.where(keep, (es - lo) * cap + slot, 0)
    rows = hi - lo
    disp_tok = torch.full((rows * cap,), -1, dtype=torch.int64,
                          device=es.device)
    disp_tok.scatter_reduce_(0, flat, torch.where(keep, tok_s, -1), "amax",
                             include_self=True)
    disp_w = torch.zeros(rows * cap, dtype=torch.float32,
                         device=es.device).index_add(
        0, flat, torch.where(keep, w_s, 0.0))
    return disp_tok.reshape(rows, cap), disp_w.reshape(rows, cap)


def _route(p: dict, x: torch.Tensor, cfg) -> tuple:
    """Router probabilities and the top-k: ``(probs [T, E], top_w, top_i)``
    (weights renormalised over the k)."""
    logits = x.float() @ p["router"]                                # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = top_k_lower_first(probs, cfg.top_k)               # [T, k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return probs, top_w, top_i


def _expert_counts(top_i: torch.Tensor, e: int) -> torch.Tensor:
    """Pairs routed to each expert (by index_add: bincount would read its
    size back from the device)."""
    return torch.zeros(e, dtype=torch.float32, device=top_i.device).index_add_(
        0, top_i.reshape(-1), torch.ones(top_i.numel(), device=top_i.device))


def _moe_routed(p: dict, x: torch.Tensor, cfg) -> tuple:
    """One routing group: x [T, D] -> ([T, D], aux_loss)."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    e_pad = cfg.n_experts_pad
    cap = capacity(t, cfg)

    probs, top_w, top_i = _route(p, x, cfg)

    # Switch-style load-balance aux loss
    f = _expert_counts(top_i, e) / (t * k)
    aux = e * torch.sum(f * probs.mean(0))

    disp_tok, disp_w = dispatch(top_i, top_w, cap, e_pad)
    gather_ok = disp_tok >= 0
    src = torch.clamp(disp_tok, min=0).reshape(-1)
    xe = (x.index_select(0, src).reshape(e_pad, cap, d)
          * gather_ok[..., None].to(x.dtype))                        # [E_pad, C, D]
    h = swiglu(torch.bmm(xe, p["we_gate"]), torch.bmm(xe, p["we_up"]))
    ye = torch.bmm(h, p["we_down"])                                  # [E_pad, C, D]
    ye = ye * disp_w[..., None].to(ye.dtype)

    out = torch.zeros((t, d), dtype=ye.dtype, device=x.device).index_add(
        0, src, ye.reshape(e_pad * cap, d)
        * gather_ok.reshape(-1, 1).to(ye.dtype))

    if cfg.n_shared_experts:
        hs = swiglu(x @ p["ws_gate"], x @ p["ws_up"])
        out = out + hs @ p["ws_down"]
    return out.to(x.dtype), aux


def moe_apply_grouped(p: dict, x: torch.Tensor, cfg) -> tuple:
    """Grouped (GShard-style) routing: x [T, D] is split into G =
    ``cfg.moe_groups`` groups of T/G tokens, and routing, top-k, capacity
    and dispatch run inside each group; aux is the groups' mean."""
    t, d = x.shape
    g = cfg.moe_groups
    outs, aux = zip(*(_moe_routed(p, xs, cfg)
                      for xs in x.reshape(g, t // g, d)))
    return torch.cat(outs), torch.stack(aux).mean()


def moe_apply(p: dict, x: torch.Tensor, cfg, par=None) -> tuple:
    """x [T, D] -> ([T, D], aux_loss). ``p`` holds one layer's weights.
    Routing is grouped when ``cfg.moe_groups > 0`` divides T (the
    reference groups under a shard function: the port has no GSPMD twin,
    so the config alone decides). On a mesh (``par``): x is this rank's
    tokens and ``p`` its shards (:func:`moe_apply_mesh`)."""
    if par is not None:
        return moe_apply_mesh(p, x, cfg, par)
    g = cfg.moe_groups
    if g > 0 and x.shape[0] % g == 0:
        return moe_apply_grouped(p, x, cfg)
    return _moe_routed(p, x, cfg)


# ------------------------------------------------------------------ on a mesh
def moe_apply_mesh(p: dict, x: torch.Tensor, cfg, par) -> tuple:
    """The MoE layer on a rank of a mesh: x [T_loc, D] this data rank's
    tokens (every model rank of a data group holds them all), the experts
    split over ``experts``' axes, each expert weight's ``moe_embed``
    dimension over its axes (FSDP: gathered whole before the products, its
    gradient reduce-scattered).

    Each model rank fills only its own experts' slots from the tokens it
    holds and the ranks' outputs are summed over the experts' axes: no
    token all-to-all. Global routing (``moe_groups == 0``) keeps exactly
    the pairs the one-device dispatch keeps on the global batch: a pair's
    queue position counts its expert's pairs on lower data ranks (one
    all-gather of the ``[E]`` counts over the data axes), the capacity is
    ``capacity(T_global)``, and the aux loss's ``f`` and ``probs.mean(0)``
    are global means. Grouped routing takes the data ranks' tokens as the
    groups (``moe_groups`` a multiple of the data size), and the aux loss
    is the groups' mean."""
    t, d = x.shape
    n_data = par.size(par.data)
    g = cfg.moe_groups
    if g > 0 and (t * n_data) % g == 0:
        if g % n_data:
            raise ValueError(f"{g} routing groups over {n_data} data ranks")
        gl = g // n_data
        outs, aux = zip(*(_moe_mesh_group(p, xs, cfg, par, False)
                          for xs in x.reshape(gl, t // gl, d)))
        aux = par.reduce(torch.stack(aux).sum(), par.data, "routing") / g
        return torch.cat(outs), aux
    return _moe_mesh_group(p, x, cfg, par, True)


def data_counts(top_i: torch.Tensor, e: int, par, axes=None) -> tuple:
    """``(counts [E] f32, offsets [E] int)``: the pairs routed to each
    expert over the ranks along ``axes`` (default ``par``'s data axes;
    ``()``: this set alone), and those on lower ranks, which queue before
    this rank's (one all-gather of the ``[E]`` counts)."""
    axes = par.data if axes is None else axes
    counts = _expert_counts(top_i, e)
    if par.size(axes) == 1:
        return counts, torch.zeros(e, dtype=torch.long, device=top_i.device)
    every = par.all_gather(counts, axes, "routing")              # [data, E]
    return every.sum(0), every[:par.index(axes)].sum(0).long()


def _moe_mesh_group(p: dict, x: torch.Tensor, cfg, par,
                    global_routing: bool) -> tuple:
    t, d = x.shape
    e, k, e_pad = cfg.n_experts, cfg.top_k, cfg.n_experts_pad
    data = par.data if global_routing else ()
    t_all = t * par.size(data)
    cap = capacity(t_all, cfg)
    probs, top_w, top_i = _route(p, x, cfg)
    counts, offsets = data_counts(top_i, e, par, data)
    psum = par.reduce(probs.sum(0), data, "routing")
    aux = e * torch.sum(counts / (t_all * k) * (psum / t_all))

    experts = par.axes("experts")
    lo, hi = par.span("experts", e_pad)
    xt = par.copy(x, experts)
    wt = par.copy(top_w, experts)
    disp_tok, disp_w = dispatch(top_i, wt, cap, e_pad, offsets=offsets,
                                experts=(lo, hi), local_slots=True)
    gather_ok = disp_tok >= 0
    src = torch.clamp(disp_tok, min=0).reshape(-1)
    rows = hi - lo
    xe = (xt.index_select(0, src).reshape(rows, cap, d)
          * gather_ok[..., None].to(x.dtype))
    fsdp = par.axes("moe_embed")
    wg, wu = (par.gather(p[w], 1, d, fsdp) for w in ("we_gate", "we_up"))
    wd = par.gather(p["we_down"], 2, d, fsdp)
    h = swiglu(torch.bmm(xe, wg), torch.bmm(xe, wu))
    ye = torch.bmm(h, wd) * disp_w[..., None].to(x.dtype)
    out = torch.zeros((t, d), dtype=ye.dtype, device=x.device).index_add(
        0, src, ye.reshape(rows * cap, d)
        * gather_ok.reshape(-1, 1).to(ye.dtype))
    if cfg.n_shared_experts:
        ff = par.axes("ff")
        xs = xt if ff == experts else par.copy(x, ff)
        shared = swiglu(xs @ p["ws_gate"], xs @ p["ws_up"]) @ p["ws_down"]
        if ff != experts:
            out = par.reduce(out, experts) + par.reduce(shared, ff)
            return out.to(x.dtype), aux
        out = out + shared
    return par.reduce(out, experts).to(x.dtype), aux
