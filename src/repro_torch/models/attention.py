"""Attention variants: full causal, chunked-causal (online softmax),
banded sliding-window, and KV-cache decode -- the port of
``repro.models.attention``, in plain tensor operations as the reference's
are plain XLA operations.

Every function takes q/k/v in ``[B, S, H, Dh]`` layout; GQA folds the query
heads as ``(kv_head, group)`` pairs. Scores are float32 whatever the
inputs' dtype (the reference's ``preferred_element_type``: the inputs are
cast to float32 before the product, which is exact for bfloat16 values);
probabilities are cast back to ``v``'s dtype before they combine ``v``.
Masked scores are ``NEG_INF``, never ``-inf``, so a fully masked row gives
the reference's uniform row and not a NaN.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding; x [B, S, H, Dh], positions [B, S] or [S]."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs                  # [B, S, half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _gqa_scores(q, k):
    """q [B,S,Hq,D], k [B,T,Hkv,D] -> scores [B,Hkv,G,S,T] (f32)."""
    b, s, hq, dh = q.shape
    hkv = k.shape[2]
    qr = q.reshape(b, s, hkv, hq // hkv, dh)
    return torch.einsum("bskgd,btkd->bkgst", qr.float(), k.float())


def _gqa_combine(probs, v):
    """probs [B,Hkv,G,S,T] (dtype of v), v [B,T,Hkv,D] -> [B,S,Hq,D]."""
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    b, s, hkv, g, dh = out.shape
    return out.reshape(b, s, hkv * g, dh)


def full_causal_attention(q, k, v, *, window: int = 0) -> torch.Tensor:
    """Reference attention (small seq). window=0 -> plain causal."""
    s, dh = q.shape[1], q.shape[3]
    scores = _gqa_scores(q, k) / math.sqrt(dh)
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = j <= i
    if window:
        mask &= (i - j) < window
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return _gqa_combine(probs, v)


def chunked_causal_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, q_chunk: int = 1024,
                             kv_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention: O(S * kv_chunk) live memory.

    Each q-block runs over every kv-block carrying ``(m, l, acc)``, as the
    reference's ``lax.map`` over ``lax.scan`` does (masked kv-blocks
    included), in a Python loop. The reference needs ``S % q_chunk == 0``
    and ``T % kv_chunk == 0``; here the last block of either may be
    shorter (a prompt of any length), with the same result where the
    reference's shapes divide."""
    b, s, hq, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(dh)
    outs = []
    for q0 in range(0, s, q_chunk):
        q_blk = q[:, q0:q0 + q_chunk]
        qc = q_blk.shape[1]
        q_pos = torch.arange(q0, q0 + qc, device=q.device)
        qr = q_blk.reshape(b, qc, hkv, g, dh).float()
        m = torch.full((b, hkv, g, qc), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, hkv, g, qc), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, hkv, g, qc, dh), dtype=torch.float32,
                          device=q.device)
        for k0 in range(0, t, kv_chunk):
            k_blk, v_blk = k[:, k0:k0 + kv_chunk], v[:, k0:k0 + kv_chunk]
            k_pos = torch.arange(k0, k0 + k_blk.shape[1], device=q.device)
            sc = torch.einsum("bskgd,btkd->bkgst", qr, k_blk.float()) * scale
            mask = k_pos[None, :] <= q_pos[:, None]
            sc = torch.where(mask, sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(sc - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgst,btkd->bkgsd", p.to(v_blk.dtype), v_blk).float()
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, qc, hq, dh))
    return torch.cat(outs, dim=1).to(q.dtype)


def banded_window_attention(q, k, v, *, window: int) -> torch.Tensor:
    """Exact sliding-window causal attention with O(S * 2w) memory.

    Queries are blocked at the window size (the sequence padded to a
    multiple of it); block i attends to blocks {i-1, i}, which covers every
    position within ``window`` of the query; block 0's previous block is
    zeros, masked out."""
    b, s0, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    w = window
    s = -(-s0 // w) * w
    if s != s0:
        pad = lambda x: torch.nn.functional.pad(x, (0, 0, 0, 0, 0, s - s0))
        q, k, v = pad(q), pad(k), pad(v)
    nb = s // w
    scale = 1.0 / math.sqrt(dh)

    kb = k.reshape(b, nb, w, hkv, dh)
    vb = v.reshape(b, nb, w, hkv, dh)
    kprev = torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], dim=1)
    vprev = torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], dim=1)
    k2 = torch.cat([kprev, kb], dim=2)              # [B, nb, 2w, Hkv, D]
    v2 = torch.cat([vprev, vb], dim=2)

    qr = q.reshape(b, nb, w, hkv, g, dh)
    sc = torch.einsum("bnskgd,bntkd->bnkgst", qr.float(), k2.float()) * scale
    dev = q.device
    qpos = torch.arange(w, device=dev)[:, None]             # within block
    kpos = torch.arange(2 * w, device=dev)[None, :] - w     # block offset
    dist = qpos - kpos                                      # query - key
    mask = (dist >= 0) & (dist < w)                         # causal, window
    first_block = torch.arange(nb, device=dev) == 0
    kv_is_prev = (torch.arange(2 * w, device=dev) < w)[None, :]
    mask_nb = mask[None] & ~(first_block[:, None, None] & kv_is_prev)
    sc = torch.where(mask_nb[None, :, None, None], sc, NEG_INF)
    probs = torch.softmax(sc, dim=-1).to(v.dtype)
    out = torch.einsum("bnkgst,bntkd->bnskgd", probs, v2)
    return out.reshape(b, s, hq, dh)[:, :s0]


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, valid: torch.Tensor,
                     par=None, seq_axes: tuple = ()) -> torch.Tensor:
    """Single-token attention over a (possibly ring-buffer) KV cache:
    q [B, 1, Hq, Dh], cache_k / cache_v [B, T, Hkv, Dh], valid [B, T] bool
    (the cache entries to attend to) -> [B, 1, Hq, Dh].

    Split-KV (flash-decoding; the reference leaves it to GSPMD): with
    ``par`` (a :class:`~repro_torch.models.common.Parallel`) and the
    cache's slots split over ``seq_axes``, the cache holds this rank's
    slots. Each rank takes the partial max, the sum of exponentials and
    the exponential-weighted values over its valid slots in float32: the
    max is reduced over the axes first, each rank takes its exponentials
    against that global max, and the sums and the weighted values are
    summed over the axes in one all-reduce (both tallied under
    ``"split_kv"``). Nothing gathers the cache."""
    if par is not None and par.size(seq_axes) > 1:
        return _split_decode_attention(q, cache_k, cache_v, valid, par,
                                       seq_axes)
    b, _, hq, dh = q.shape
    hkv = cache_k.shape[2]
    qr = q.reshape(b, hkv, hq // hkv, dh)
    sc = torch.einsum("bkgd,btkd->bkgt", qr.float(),
                      cache_k.float()) / math.sqrt(dh)
    sc = torch.where(valid[:, None, None, :], sc, NEG_INF)
    probs = torch.softmax(sc, dim=-1).to(cache_v.dtype)
    out = torch.einsum("bkgt,btkd->bkgd", probs, cache_v)
    return out.reshape(b, 1, hq, dh)


def _split_decode_attention(q, cache_k, cache_v, valid, par, seq_axes):
    b, _, hq, dh = q.shape
    hkv = cache_k.shape[2]
    qr = q.reshape(b, hkv, hq // hkv, dh)
    sc = torch.einsum("bkgd,btkd->bkgt", qr.float(),
                      cache_k.float()) / math.sqrt(dh)
    sc = torch.where(valid[:, None, None, :], sc, NEG_INF)
    m_loc = sc.amax(-1)                                         # [B,Hkv,G]
    m = par.all_reduce(m_loc, seq_axes, "max", "split_kv")
    e = torch.exp(sc - m[..., None])            # exactly 0 off the valid slots
    acc = torch.einsum("bkgt,btkd->bkgd", e, cache_v.float())
    parts = par.all_reduce(torch.cat([e.sum(-1, keepdim=True), acc], -1),
                           seq_axes, "sum", "split_kv")
    out = parts[..., 1:] / parts[..., :1]
    return out.to(cache_v.dtype).reshape(b, 1, hq, dh)
