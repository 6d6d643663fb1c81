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
that expert (``searchsorted(side="left")``).
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


def dispatch(top_i: torch.Tensor, top_w: torch.Tensor, cap: int,
             e_pad: int) -> tuple:
    """``(disp_tok [E_pad, C] int, disp_w [E_pad, C] f32)``: the token in
    each expert's slot (-1: empty) and its routing weight. The (token,
    slot) pairs are sorted by expert (stable); a pair past its expert's
    ``cap`` is dropped."""
    t, k = top_i.shape
    e_flat = top_i.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    es = e_flat[order]
    pos = (torch.arange(t * k, device=es.device)
           - torch.searchsorted(es, es, side="left"))
    tok_s = order // k
    w_s = top_w.reshape(-1)[order]
    keep = pos < cap
    flat = torch.where(keep, es * cap + pos, 0)
    disp_tok = torch.full((e_pad * cap,), -1, dtype=torch.int64,
                          device=es.device)
    disp_tok.scatter_reduce_(0, flat, torch.where(keep, tok_s, -1), "amax",
                             include_self=True)
    disp_w = torch.zeros(e_pad * cap, dtype=torch.float32,
                         device=es.device).index_add(
        0, flat, torch.where(keep, w_s, 0.0))
    return disp_tok.reshape(e_pad, cap), disp_w.reshape(e_pad, cap)


def _moe_routed(p: dict, x: torch.Tensor, cfg) -> tuple:
    """One routing group: x [T, D] -> ([T, D], aux_loss)."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    e_pad = cfg.n_experts_pad
    cap = capacity(t, cfg)

    logits = x.float() @ p["router"]                                # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = top_k_lower_first(probs, k)                       # [T, k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    # Switch-style load-balance aux loss (counts by index_add: bincount
    # would read its size back from the device)
    f = torch.zeros(e, dtype=torch.float32, device=x.device).index_add_(
        0, top_i.reshape(-1), torch.ones(t * k, device=x.device)) / (t * k)
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


def moe_apply(p: dict, x: torch.Tensor, cfg) -> tuple:
    """x [T, D] -> ([T, D], aux_loss). ``p`` holds one layer's weights.
    Routing is grouped when ``cfg.moe_groups > 0`` divides T (the
    reference groups under a shard function: the port has no GSPMD twin,
    so the config alone decides)."""
    g = cfg.moe_groups
    if g > 0 and x.shape[0] % g == 0:
        return moe_apply_grouped(p, x, cfg)
    return _moe_routed(p, x, cfg)
