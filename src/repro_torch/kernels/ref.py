"""Plain PyTorch oracles of the kernels' reference contracts, under the
reference package's ``repro.kernels.ref`` names: written directly over the
``[R, K]`` ELL tile (or the ``[K, NW]`` partials), independent of the
chunked plain versions the wrappers run on the CPU. Words are int32 bit
patterns.

For ``cin_fused``, ``segment_bag`` and ``ell_pull_payload`` the plain
version beside the kernel is already the direct formula over the
reference's contract, so the oracle is that function under the reference
name.
"""
from __future__ import annotations

import torch

from .cin_fused import cin_fused_plain as cin_fused_ref  # noqa: F401
from .ell_pull_payload import (  # noqa: F401
    ell_pull_payload_plain as ell_pull_payload_ref)
from .mask_reduce import or_fold
from .segment_bag import segment_bag_plain as segment_bag_ref  # noqa: F401


def ell_pull_ref(parents: torch.Tensor, frontier_mask: torch.Tensor,
                 active: torch.Tensor) -> torch.Tensor:
    """Single-bit pull over an ELL tile: 1 where ``active == 1`` and some
    valid (>= 0) parent u has bit u of ``frontier_mask`` set, else 0."""
    valid = parents >= 0
    safe = parents.clamp(min=0).long()
    bit = (frontier_mask[safe >> 5] >> (safe & 31).to(torch.int32)) & 1
    hit = valid & (bit == 1)
    return (hit.any(1) & (active == 1)).to(torch.int32)


def ell_pull_multi_ref(parents: torch.Tensor, frontier_words: torch.Tensor,
                       active_words: torch.Tensor) -> torch.Tensor:
    """Lane-word pull over an ELL tile: OR of the valid (>= 0) parents'
    frontier words, masked by ``active``."""
    valid = parents >= 0
    w = frontier_words[parents.clamp(min=0).long()]       # [R, K, NW]
    w = torch.where(valid[..., None], w, 0)
    return or_fold(w, 1) & active_words


def payload_min_fold_ref(partials: torch.Tensor, prev: torch.Tensor,
                         with_count: bool = True):
    """K-way elementwise min into ``prev`` plus a 0/1 improved flag (one
    reduction over the stacked ``[K + 1, NW]``)."""
    combined = torch.cat([prev[None], partials]).amin(0)
    if not with_count:
        return combined, None
    return combined, (combined < prev).to(torch.int32)


def pack_bitmask(flags: torch.Tensor) -> torch.Tensor:
    """bool ``[n]`` -> int32 ``[ceil(n/32)]`` with bit v (of word v // 32,
    LSB first) = ``flags[v]``."""
    n = flags.shape[0]
    nw = -(-n // 32)
    padded = torch.zeros(nw * 32, dtype=torch.int64, device=flags.device)
    padded[:n] = flags.to(torch.int64)
    words = (padded.reshape(nw, 32)
             << torch.arange(32, device=flags.device)).sum(1)
    # two's-complement int32 bit pattern of each unsigned 32-bit word
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
