"""Vectorized LEB128 varints: the byte packing shared by the compressed
partition format (delta-encoded adjacency, :mod:`repro_torch.core.partition`)
and the compressed nn wire codec (:mod:`repro_torch.core.comm.codec`).

Standard little-endian base-128: each byte carries 7 value bits, the high
bit flags continuation. All functions are host-side numpy and vectorized
over the value axis -- the per-byte loop runs at most ``ceil(64/7) = 10``
iterations regardless of input size, so encoding a scale-18 partition is
a handful of array passes, not a Python loop per edge. The port's own
copy of the reference's module, and it stays on the host: values are
uint64, which torch has no arithmetic for to speak of.
"""
from __future__ import annotations

import numpy as np

_SHIFTS = tuple(range(7, 64, 7))   # thresholds 2^7, 2^14, ... 2^63


def varint_len(vals: np.ndarray) -> np.ndarray:
    """Encoded byte length per value (int64, >= 1). Values must be >= 0."""
    v = np.asarray(vals, dtype=np.uint64)
    n = np.ones(v.shape, dtype=np.int64)
    for k in _SHIFTS:
        n += (v >= np.uint64(1) << np.uint64(k)).astype(np.int64)
    return n


def varint_encode(vals: np.ndarray) -> np.ndarray:
    """Encode non-negative ints to one contiguous uint8 stream."""
    v = np.asarray(vals, dtype=np.uint64).reshape(-1)
    lens = varint_len(v)
    out = np.zeros(int(lens.sum()), dtype=np.uint8)
    if v.size == 0:
        return out
    off = np.concatenate([[0], np.cumsum(lens)[:-1]])
    rem = v.copy()
    for j in range(int(lens.max())):
        sel = lens > j
        byte = (rem[sel] & np.uint64(0x7F)).astype(np.uint8)
        more = (j + 1 < lens[sel]).astype(np.uint8)
        out[off[sel] + j] = byte | (more << 7)
        rem[sel] >>= np.uint64(7)
    return out


def varint_decode(data: np.ndarray) -> np.ndarray:
    """Decode a uint8 stream back to the int64 value array."""
    b = np.asarray(data, dtype=np.uint8).reshape(-1)
    if b.size == 0:
        return np.zeros(0, dtype=np.int64)
    is_last = (b & 0x80) == 0
    if not is_last[-1]:
        raise ValueError("truncated varint stream")
    vid = np.concatenate([[0], np.cumsum(is_last)[:-1]])
    starts = np.concatenate([[0], np.nonzero(is_last)[0][:-1] + 1])
    pos = np.arange(b.size, dtype=np.int64) - starts[vid]
    vals = np.zeros(int(is_last.sum()), dtype=np.uint64)
    np.bitwise_or.at(vals, vid,
                     (b & np.uint8(0x7F)).astype(np.uint64)
                     << (np.uint64(7) * pos.astype(np.uint64)))
    return vals.astype(np.int64)
