"""Lane-word wire format: W query bits per vertex packed into 32-bit words.

Words are int32 *bit patterns* (lane 31 is the sign bit): PyTorch's
uint32 lacks shifts, ``~`` and scatter reductions on the CPU, and the
bytes on the wire are the same four either way. Every bit extract is
therefore ``(x >> k) & 1`` (an arithmetic shift smears the sign bit, the
mask drops it), and comparing with the reference's uint32 words is a
``.view(np.uint32)`` away.
"""
from __future__ import annotations

import torch


def n_words(w: int) -> int:
    return -(-w // 32)


def _shifts(device) -> torch.Tensor:
    return torch.arange(32, dtype=torch.int32, device=device)


def pack_lanes(lanes: torch.Tensor) -> torch.Tensor:
    """bool [..., W] -> int32 [..., ceil(W/32)]; lane q -> bit q%32 of
    word q//32."""
    w = lanes.shape[-1]
    nw = n_words(w)
    pad = nw * 32 - w
    if pad:
        lanes = torch.cat(
            [lanes, lanes.new_zeros(lanes.shape[:-1] + (pad,))], dim=-1)
    grouped = lanes.reshape(lanes.shape[:-1] + (nw, 32)).to(torch.int32)
    # distinct powers of two: the sum has no carries, and bit 31's
    # negative weight lands the right two's-complement pattern
    return (grouped << _shifts(lanes.device)).sum(-1, dtype=torch.int32)


def unpack_lanes(words: torch.Tensor, w: int) -> torch.Tensor:
    """int32 [..., nw] -> bool [..., w] (inverse of :func:`pack_lanes`)."""
    bits = ((words[..., None] >> _shifts(words.device)) & 1) > 0
    return bits.reshape(words.shape[:-1] + (-1,))[..., :w]
