"""Transformer language model: GQA/MQA, optional QKV bias, sliding-window /
global attention patterns (gemma3 5:1), dense or MoE FFN, per-layer
activation checkpointing, prefill + KV-cache decode (ring buffers for
window layers) -- the port of ``repro.models.lm``.

Parameters keep the reference's names, shapes and stacked ``[L, ...]``
layout (``lm_param_specs``), so carrying weights across is a copy
(:func:`repro_torch.core.convert.tree_from_numpy`). The attention path of
a layer is the reference's: banded when ``window and window < S``, full
when ``S <= max(q_chunk, 2048)``, chunked otherwise.

One departure, on purpose: :func:`prefill` builds a window layer's cache
as the ``min(window, max_seq)`` ring of :func:`init_cache` for every
prompt length. The reference pads it to ``max_seq`` when the prompt is no
longer than the window, and its decode then attends past the window.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.bfs import resolve_device

from . import attention as A
from .common import (ParamSpec, Parallel, cross_entropy_loss, gelu,
                     rms_norm, swiglu)
from .moe import moe_apply, moe_param_specs


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_head: int
    d_ff: int
    vocab: int
    qkv_bias: bool = False
    window: int = 0            # sliding-window size for local layers (0 = all full)
    global_period: int = 0     # every k-th layer is global (gemma3: 6)
    rope_theta: float = 10000.0
    # MoE (n_experts == 0 -> dense FFN)
    n_experts: int = 0
    n_experts_pad: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    dtype: Any = torch.bfloat16
    remat: bool = True
    scan_layers: bool = True   # the reference's lax.scan; the same loop here
    tie_embeddings: bool = True
    mlp: str = "swiglu"        # swiglu (3 mats) | gelu (2 mats, gpt-bigcode style)
    moe_groups: int = 0        # >0: grouped routing (-1: the data-axis size,
                               # resolved by the launcher)
    q_chunk: int = 1024
    kv_chunk: int = 1024

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def layer_is_global(self, i: int) -> bool:
        if self.window == 0:
            return True
        if self.global_period == 0:
            return False
        return (i % self.global_period) == self.global_period - 1

    def num_params(self) -> int:
        d, dh = self.d_model, self.d_head
        attn = d * (self.n_heads + 2 * self.n_kv) * dh + self.n_heads * dh * d
        if self.is_moe:
            ffn = self.n_experts * 3 * d * self.d_ff_expert + d * self.n_experts
            ffn += self.n_shared_experts * 3 * d * self.d_ff_expert
        else:
            ffn = (3 if self.mlp == "swiglu" else 2) * d * self.d_ff
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * (attn + ffn) + emb

    def num_active_params(self) -> int:
        if not self.is_moe:
            return self.num_params()
        d = self.d_model
        attn = (d * (self.n_heads + 2 * self.n_kv) * self.d_head
                + self.n_heads * self.d_head * d)
        ffn = ((self.top_k + self.n_shared_experts) * 3 * d * self.d_ff_expert
               + d * self.n_experts)
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * (attn + ffn) + emb


# --------------------------------------------------------------------- specs
def lm_param_specs(cfg: LMConfig) -> dict:
    l, d, dt = cfg.n_layers, cfg.d_model, cfg.dtype
    hq, hkv, dh = cfg.n_heads, cfg.n_kv, cfg.d_head
    f32 = torch.float32
    layers = {
        "ln_attn": ParamSpec((l, d), f32, ("layers", "embed"), "zeros"),
        "ln_mlp": ParamSpec((l, d), f32, ("layers", "embed"), "zeros"),
        "wq": ParamSpec((l, d, hq * dh), dt, ("layers", "embed", "heads"), "scaled"),
        "wk": ParamSpec((l, d, hkv * dh), dt, ("layers", "embed", "kv_heads"), "scaled"),
        "wv": ParamSpec((l, d, hkv * dh), dt, ("layers", "embed", "kv_heads"), "scaled"),
        "wo": ParamSpec((l, hq * dh, d), dt, ("layers", "heads", "embed"), "scaled"),
    }
    if cfg.qkv_bias:
        layers["bq"] = ParamSpec((l, hq * dh), dt, ("layers", "heads"), "zeros")
        layers["bk"] = ParamSpec((l, hkv * dh), dt, ("layers", "kv_heads"), "zeros")
        layers["bv"] = ParamSpec((l, hkv * dh), dt, ("layers", "kv_heads"), "zeros")
    if cfg.is_moe:
        layers.update(moe_param_specs(l, d, cfg))
    elif cfg.mlp == "swiglu":
        layers["wi_gate"] = ParamSpec((l, d, cfg.d_ff), dt, ("layers", "embed", "ff"), "scaled")
        layers["wi_up"] = ParamSpec((l, d, cfg.d_ff), dt, ("layers", "embed", "ff"), "scaled")
        layers["wo_mlp"] = ParamSpec((l, cfg.d_ff, d), dt, ("layers", "ff", "embed"), "scaled")
    else:
        layers["wi_up"] = ParamSpec((l, d, cfg.d_ff), dt, ("layers", "embed", "ff"), "scaled")
        layers["wo_mlp"] = ParamSpec((l, cfg.d_ff, d), dt, ("layers", "ff", "embed"), "scaled")
    specs = {
        "embed": ParamSpec((cfg.vocab, d), dt, ("vocab", "embed"), "normal"),
        "final_norm": ParamSpec((d,), f32, ("embed",), "zeros"),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        specs["head"] = ParamSpec((d, cfg.vocab), dt, ("embed", "vocab"), "scaled")
    return specs


def lm_units(cfg: LMConfig) -> dict:
    """The split unit of each logical axis whose dimension is flattened:
    ``heads`` and ``kv_heads`` split whole heads (``d_head`` columns)."""
    return {"heads": cfg.d_head, "kv_heads": cfg.d_head}


# ------------------------------------------------------------------- forward
def _axes(par: Parallel | None, logical: str) -> tuple:
    """The mesh axes ``logical`` is split over (``()`` on one device)."""
    return () if par is None else par.axes(logical)


def _layer_params(params: dict) -> list:
    """Each layer's weights ``{name: [...]}`` as views of the stacked
    ``[L, ...]`` leaves (``unbind``: one stack in the backward)."""
    cols = {k: v.unbind(0) for k, v in params["layers"].items()}
    n = len(next(iter(cols.values())))
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


def _embed(cfg: LMConfig, params: dict, tokens: torch.Tensor,
           par: Parallel | None = None) -> torch.Tensor:
    """Token rows of the embedding (ids clipped into the vocabulary, as
    ``jnp.take(mode="clip")``), in ``cfg.dtype``. With the vocabulary split
    (``par``): each rank looks up the ids of its block, zero rows for the
    others, and the rows are summed over the vocabulary's axes."""
    ids = tokens.long().clamp(0, cfg.vocab - 1)
    vocab = _axes(par, "vocab")
    if not vocab:
        x = params["embed"].index_select(0, ids.reshape(-1))
        return x.reshape(*tokens.shape, cfg.d_model).to(cfg.dtype)
    lo, hi = par.span("vocab", cfg.vocab)
    local = ids - lo
    inside = ((local >= 0) & (local < hi - lo)).reshape(-1, 1)
    x = params["embed"].index_select(0, local.clamp(0, hi - lo - 1).reshape(-1))
    x = par.reduce(torch.where(inside, x, torch.zeros_like(x)), vocab)
    return x.reshape(*tokens.shape, cfg.d_model).to(cfg.dtype)


def _qkv(cfg: LMConfig, lp: dict, h: torch.Tensor, positions: torch.Tensor,
         par: Parallel | None = None, whole_kv: bool = False):
    """q, k, v of this rank's heads. With ``heads`` split (``par``): q (and
    k, v where ``kv_heads`` is split alike) column-parallel; replicated kv
    heads are computed whole, their gradient summed over the heads' axes,
    and each local q head ``j`` reads kv head ``global_j // (n_heads /
    n_kv)``. ``whole_kv`` (no gradient: a cache to fill) also returns
    ``(k, v)`` of every kv head, gathered over ``kv_heads``' axes where
    they are split (tallied under ``"cache"``)."""
    b, s, _ = h.shape
    heads = _axes(par, "heads")
    kv_axes = _axes(par, "kv_heads")
    if kv_axes and kv_axes != heads:
        raise ValueError(f"kv heads split over {kv_axes}, q heads over "
                         f"{heads}: each rank needs its q heads' kv heads")
    h0, h1 = par.span("heads", cfg.n_heads) if heads else (0, cfg.n_heads)
    hq, grp = h1 - h0, cfg.n_heads // cfg.n_kv
    ht = par.copy(h, heads) if heads else h
    q = ht @ lp["wq"]
    if cfg.qkv_bias:
        q = q + lp["bq"]
    q = A.apply_rope(q.reshape(b, s, hq, cfg.d_head), positions, cfg.rope_theta)
    if kv_axes:
        k0, k1 = par.span("kv_heads", cfg.n_kv)
        if (h0, h1) != (k0 * grp, k1 * grp):
            raise ValueError(f"q heads [{h0}, {h1}) do not read kv heads "
                             f"[{k0}, {k1})")
    src = ht if kv_axes else h
    k, v = src @ lp["wk"], src @ lp["wv"]
    if cfg.qkv_bias:
        k, v = k + lp["bk"], v + lp["bv"]
    hk = k.shape[-1] // cfg.d_head
    k = A.apply_rope(k.reshape(b, s, hk, cfg.d_head), positions, cfg.rope_theta)
    v = v.reshape(b, s, hk, cfg.d_head)
    whole = (k, v)
    if kv_axes and whole_kv:
        from repro_torch.core.comm.dist import gather_dim

        whole = tuple(gather_dim(par.mesh, t, 2, cfg.n_kv, kv_axes, par.tally,
                                 "cache") for t in (k, v))
    if heads and not kv_axes:
        k, v = par.copy(k, heads), par.copy(v, heads)
        k, v = _kv_of_heads(k, h0, h1, grp), _kv_of_heads(v, h0, h1, grp)
    return (q, k, v, whole) if whole_kv else (q, k, v)


def _kv_of_heads(t: torch.Tensor, h0: int, h1: int, grp: int) -> torch.Tensor:
    """The kv heads (dim 2 of ``t``, every kv head) that q heads ``[h0,
    h1)`` read, one a q head where the block is not whole groups."""
    if h0 % grp == 0 and h1 % grp == 0:
        return t[:, :, h0 // grp:h1 // grp]
    return t.index_select(2, torch.arange(h0, h1, device=t.device) // grp)


def _attend(cfg: LMConfig, q, k, v, window: int) -> torch.Tensor:
    s = q.shape[1]
    if window and window < s:
        return A.banded_window_attention(q, k, v, window=window)
    if s <= max(cfg.q_chunk, 2048):
        return A.full_causal_attention(q, k, v)
    return A.chunked_causal_attention(q, k, v, q_chunk=cfg.q_chunk,
                                      kv_chunk=cfg.kv_chunk)


def _dense_ffn(cfg: LMConfig, lp: dict, h: torch.Tensor,
               par: Parallel | None = None) -> torch.Tensor:
    """The dense FFN; with ``ff`` split (``par``), column- then
    row-parallel."""
    ff = _axes(par, "ff")
    if ff:
        h = par.copy(h, ff)
    if cfg.mlp == "swiglu":
        out = swiglu(h @ lp["wi_gate"], h @ lp["wi_up"]) @ lp["wo_mlp"]
    else:
        out = gelu((h @ lp["wi_up"]).float()).to(h.dtype) @ lp["wo_mlp"]
    return par.reduce(out, ff) if ff else out


def _ffn_block(cfg: LMConfig, lp: dict, x: torch.Tensor,
               par: Parallel | None = None) -> tuple:
    b, s, d = x.shape
    h = rms_norm(x, lp["ln_mlp"])
    if cfg.is_moe:
        out, aux = moe_apply(lp, h.reshape(b * s, d), cfg, par)
        return x + out.reshape(b, s, d), aux
    return x + _dense_ffn(cfg, lp, h, par), x.new_zeros((), dtype=torch.float32)


def _layer(cfg: LMConfig, window: int, lp: dict, x: torch.Tensor,
           positions: torch.Tensor, par: Parallel | None = None) -> tuple:
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, lp, rms_norm(x, lp["ln_attn"]), positions, par)
    o = _attend(cfg, q, k, v, window)
    o = o.reshape(b, s, q.shape[2] * cfg.d_head) @ lp["wo"]
    heads = _axes(par, "heads")
    x = x + (par.reduce(o, heads) if heads else o)
    return _ffn_block(cfg, lp, x, par)


def _head(cfg: LMConfig, params: dict, x: torch.Tensor,
          par: Parallel | None = None) -> torch.Tensor:
    """Logits in float32; with the vocabulary split (``par``), this rank's
    block of them (the untied head's columns, or the tied ``embed.T``'s)."""
    x = rms_norm(x, params["final_norm"])
    vocab = _axes(par, "vocab")
    if vocab:
        x = par.copy(x, vocab)
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    return (x @ head.to(x.dtype)).float()


def forward(cfg: LMConfig, params: dict, tokens: torch.Tensor,
            par: Parallel | None = None) -> tuple:
    """tokens [B, S] -> (logits [B, S, V] f32, aux_loss). With gradients
    on and ``cfg.remat``, each layer's activations are recomputed in the
    backward (``torch.utils.checkpoint``; on a mesh the recompute repeats
    the layer's forward collectives).

    ``par`` (:class:`~repro_torch.models.common.Parallel`): this rank's
    shards of the parameters (``repro_torch.launch.sharding``) and its
    rows of the batch; the logits are its block of the vocabulary, the
    aux loss the global one."""
    x = _embed(cfg, params, tokens, par)
    positions = torch.arange(tokens.shape[1], device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = x.new_zeros((), dtype=torch.float32)
    for i, lp in enumerate(_layer_params(params)):
        window = 0 if cfg.layer_is_global(i) else cfg.window
        if remat:
            x, a = checkpoint(_layer, cfg, window, lp, x, positions, par,
                              use_reentrant=False)
        else:
            x, a = _layer(cfg, window, lp, x, positions, par)
        aux = aux + a
    return _head(cfg, params, x, par), aux


def loss_fn(cfg: LMConfig, params: dict, batch: dict,
            par: Parallel | None = None) -> tuple:
    """``(loss, {"ce", "aux"})``; on a mesh (``par``) the global ones, the
    same on every rank, from this rank's shards and rows."""
    logits, aux = forward(cfg, params, batch["tokens"], par)
    ce = cross_entropy_loss(logits, batch["labels"], batch.get("mask"), par,
                            cfg.vocab)
    return ce + cfg.aux_loss_weight * aux, {"ce": ce, "aux": aux}


# -------------------------------------------------------------------- decode
def cache_len(cfg: LMConfig, i: int, max_seq: int) -> int:
    """Slots of layer ``i``'s KV cache: ``max_seq`` on a global layer, the
    ``min(window, max_seq)`` ring on a window layer."""
    return max_seq if cfg.layer_is_global(i) else min(cfg.window, max_seq)


def init_cache_specs(cfg: LMConfig, batch: int, max_seq: int) -> list:
    """Per-layer KV cache shapes ``[{"k": (shape, dtype), "v": ...}]``
    (ring buffer for window layers)."""
    return [{name: ((batch, cache_len(cfg, i, max_seq), cfg.n_kv, cfg.d_head),
                    cfg.dtype) for name in ("k", "v")}
            for i in range(cfg.n_layers)]


def init_cache(cfg: LMConfig, batch: int, max_seq: int,
               device="cuda") -> list:
    dev = resolve_device(device)
    return [{name: torch.zeros(shape, dtype=dt, device=dev)
             for name, (shape, dt) in layer.items()}
            for layer in init_cache_specs(cfg, batch, max_seq)]


@torch.no_grad()
def decode_step(cfg: LMConfig, params: dict, cache: list,
                token: torch.Tensor, pos, par: Parallel | None = None,
                shardings: list | None = None) -> tuple:
    """One-token serve step. token [B] int, pos the current position (an
    int or a 0-d tensor). Writes this token's keys and values into
    ``cache`` in place (slot ``pos``, or ``pos % T`` on a ring) and returns
    (logits [B, V] f32, cache).

    On a mesh (``par``): ``params`` are this rank's shards, ``token`` its
    rows, ``cache`` its blocks in the decode layout ``shardings``
    (``launch.sharding.cache_shardings``, one ``{"k", "v"}`` pair a
    layer); the logits are its block of the vocabulary. The vocabulary,
    heads, ff and experts split as in :func:`forward`. Only the rank
    whose block holds the slot writes it. Where a layer's slots are split
    over ranks, attention combines their partial softmax
    (``attention.decode_attention``), reading every q head (gathered over
    the heads' axes, under ``"split_kv"``) and keeping this rank's."""
    pos = int(pos)
    b = token.shape[0]
    x = _embed(cfg, params, token[:, None], par)                   # [B,1,D]
    posv = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    heads = _axes(par, "heads")
    for i, lp in enumerate(_layer_params(params)):
        c = cache[i]
        is_global = cfg.layer_is_global(i)
        sh = shardings[i]["k"] if par is not None else None
        seq = sh.dims[1] if sh is not None else ()
        kv_split = sh is not None and par.size(sh.dims[2]) > 1
        h = rms_norm(x, lp["ln_attn"])
        if par is None or kv_split:
            q, k, v = _qkv(cfg, lp, h, posv, par)
            if kv_split:
                _check_kv_block(cfg, par, sh)
            kw, vw = k, v
        else:
            q, k, v, (kw, vw) = _qkv(cfg, lp, h, posv, par, whole_kv=True)
        t_all = sh.shape[1] if sh is not None else c["k"].shape[1]
        lo, hi = _slots(par, seq, t_all)
        # lax.dynamic_update_slice clamps the start into the cache
        slot = min(pos, t_all - 1) if is_global else pos % t_all
        if lo <= slot < hi:
            c["k"][:, slot - lo] = kw[:, 0]
            c["v"][:, slot - lo] = vw[:, 0]
        idx = torch.arange(lo, hi, device=x.device)
        valid = (idx <= pos) if is_global else ((idx <= pos) | (pos >= t_all))
        valid = valid[None].expand(b, hi - lo)
        if par is None or kv_split:
            o = A.decode_attention(q, c["k"], c["v"], valid)
        elif par.size(seq) > 1:
            qa = q
            if heads:
                from repro_torch.core.comm.dist import gather_dim

                qa = gather_dim(par.mesh, q, 2, cfg.n_heads, heads, par.tally,
                                "split_kv")
            o = A.decode_attention(qa, c["k"], c["v"], valid, par, seq)
            if heads:
                o = o[:, :, slice(*par.span("heads", cfg.n_heads))]
        else:
            h0, h1 = par.span("heads", cfg.n_heads) if heads else \
                (0, cfg.n_heads)
            grp = cfg.n_heads // cfg.n_kv
            o = A.decode_attention(q, _kv_of_heads(c["k"], h0, h1, grp),
                                   _kv_of_heads(c["v"], h0, h1, grp), valid)
        o = o.reshape(b, 1, q.shape[2] * cfg.d_head) @ lp["wo"]
        x = x + (par.reduce(o, heads) if heads else o)
        hh = rms_norm(x, lp["ln_mlp"])
        if cfg.is_moe:
            out, _ = moe_apply(lp, hh.reshape(b, cfg.d_model), cfg, par)
            x = x + out.reshape(b, 1, cfg.d_model)
        else:
            x = x + _dense_ffn(cfg, lp, hh, par)
    return _head(cfg, params, x, par)[:, 0], cache


def _slots(par: Parallel | None, seq: tuple, t: int) -> tuple:
    """``[lo, hi)``: the slots of a ``t``-slot cache this rank holds."""
    if par is None or par.size(seq) == 1:
        return 0, t
    from repro_torch.launch.sharding import dim_span

    return dim_span(t, par.size(seq), par.index(seq))


def _check_kv_block(cfg: LMConfig, par: Parallel, sh) -> None:
    """A cache split on kv heads is read by the q heads of this rank: its
    block of kv heads must be the one they read."""
    from repro_torch.launch.sharding import dim_span

    heads = _axes(par, "heads")
    k0, k1 = dim_span(cfg.n_kv, par.size(sh.dims[2]), par.index(sh.dims[2]))
    h0, h1 = par.span("heads", cfg.n_heads) if heads else (0, cfg.n_heads)
    grp = cfg.n_heads // cfg.n_kv
    if (h0, h1) != (k0 * grp, k1 * grp):
        raise ValueError(f"q heads [{h0}, {h1}) do not read the cache's kv "
                         f"heads [{k0}, {k1})")


@torch.no_grad()
def prefill(cfg: LMConfig, params: dict, tokens: torch.Tensor, max_seq: int,
            last_only: bool = False, par: Parallel | None = None,
            shardings: list | None = None) -> tuple:
    """Forward over a prompt, producing logits and a filled KV cache of
    :func:`init_cache`'s shapes: a global layer's keys padded to
    ``max_seq``, a window layer's in its ring (position p at slot p % T).

    ``last_only=True`` computes logits for the final position only (what
    a server needs; no ``[B, S, vocab]`` tensor).

    On a mesh (``par``, ``shardings`` as in :func:`decode_step`): this
    rank's rows of the prompts, its shards; the logits are its block of
    the vocabulary and the cache its blocks in the decode layout, so that
    :func:`decode_step` continues from it."""
    b, s = tokens.shape
    x = _embed(cfg, params, tokens, par)
    positions = torch.arange(s, device=x.device)
    heads = _axes(par, "heads")
    cache = []
    for i, lp in enumerate(_layer_params(params)):
        window = 0 if cfg.layer_is_global(i) else cfg.window
        sh = shardings[i]["k"] if par is not None else None
        h = rms_norm(x, lp["ln_attn"])
        if par is None or par.size(sh.dims[2]) > 1:
            q, k, v = _qkv(cfg, lp, h, positions, par)
            if par is not None:
                _check_kv_block(cfg, par, sh)
            kc, vc = k, v
        else:
            q, k, v, (kc, vc) = _qkv(cfg, lp, h, positions, par, whole_kv=True)
        o = _attend(cfg, q, k, v, window)
        t = cache_len(cfg, i, max_seq)
        if window and window < s:
            # ring-buffer layout: position p lives at slot p % t, so slot j
            # holds position s - t + ((j - s % t) % t)
            sel = s - t + (torch.arange(t, device=x.device) - s % t) % t
            ck, cv = kc[:, sel], vc[:, sel]
        else:
            # every position fits: slot p holds position p, the rest zeros
            pad = lambda a: torch.nn.functional.pad(a, (0, 0, 0, 0, 0, t - s))
            ck, cv = pad(kc), pad(vc)
        if par is not None and par.size(sh.dims[1]) > 1:
            lo, hi = _slots(par, sh.dims[1], t)
            ck, cv = ck[:, lo:hi].contiguous(), cv[:, lo:hi].contiguous()
        o = o.reshape(b, s, q.shape[2] * cfg.d_head) @ lp["wo"]
        x = x + (par.reduce(o, heads) if heads else o)
        x, _ = _ffn_block(cfg, lp, x, par)
        cache.append({"k": ck, "v": cv})
    if last_only:
        x = x[:, -1:, :]
    return _head(cfg, params, x, par), cache
