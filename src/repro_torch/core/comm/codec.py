"""Compressed nn wire codec: run-length bitmaps and delta-encoded slot ids.

The fourth nn wire format (``CommConfig(nn="compressed")``) ships the
per-peer active-slot set as the cheaper of two LEB128-varint byte streams:

* **rle** -- alternating run lengths over the slot bitmap, starting with
  the inactive run (a leading ``varint(0)`` = 1 byte when slot 0 is
  active). Wins at mid densities where runs are long.
* **delta** -- the sorted active slot ids, delta-encoded against the
  previous id (prev init -1, so every delta is >= 1). Wins on sparse
  frontiers; one byte per active slot while gaps stay < 128.

The lane-word path additionally ships the active slots' packed lane words
(``n_words * 4`` bytes per active slot) after the id stream, the payload
plane ``W * 4`` bytes of int32 values.

Two synchronized implementations live here, as in the reference:

* host numpy encoders and decoders (:func:`rle_encode`,
  :func:`delta_encode_ids`, ...) -- the byte-exact definition of the
  format, byte for byte the reference's;
* torch byte-length formulas (:func:`rle_stream_bytes`,
  :func:`delta_stream_bytes`) evaluated on the device inside the sweep, so
  the ``wire_nn`` counters carry the *exact* stream length the host
  encoder would produce, with no host read (a captured sweep stays
  capturable).

Static-shape collectives cannot ship variable-length byte streams, so the
transport is the dense or adaptive one (``exchange.py``); what the codec
changes is the accounting: the counters carry the bytes a byte-stream
transport would put on the wire.
"""
from __future__ import annotations

import numpy as np
import torch

from ..varint import varint_decode, varint_encode

# ---------------------------------------------------------------------------
# host-side codec (numpy), byte for byte the reference's
# ---------------------------------------------------------------------------


def rle_encode(mask: np.ndarray) -> np.ndarray:
    """Encode a bool slot bitmap as alternating varint run lengths.

    The stream starts with the *inactive* run; a mask starting active gets
    a leading zero-length run (1 byte)."""
    mask = np.asarray(mask, dtype=bool).reshape(-1)
    if mask.size == 0:
        return np.zeros(0, dtype=np.uint8)
    change = np.nonzero(mask[1:] != mask[:-1])[0] + 1
    bounds = np.concatenate([[0], change, [mask.size]])
    runs = np.diff(bounds)
    if mask[0]:
        runs = np.concatenate([[0], runs])
    return varint_encode(runs)


def rle_decode(stream: np.ndarray, n: int) -> np.ndarray:
    """Decode an rle stream back to the length-``n`` bool bitmap."""
    runs = varint_decode(stream)
    bounds = np.concatenate([[0], np.cumsum(runs)])
    if runs.size and bounds[-1] != n:
        raise ValueError(f"rle runs sum to {int(bounds[-1])}, expected {n}")
    d = np.zeros(n + 1, dtype=np.int64)
    i_act = np.arange(runs.size)[1::2]          # odd runs are active
    np.add.at(d, bounds[i_act], 1)
    np.add.at(d, bounds[i_act + 1], -1)
    return np.cumsum(d[:n]) > 0


def delta_encode_ids(ids: np.ndarray) -> np.ndarray:
    """Encode sorted unique non-negative slot ids as varint deltas
    (previous id initialized to -1, so deltas are >= 1)."""
    ids = np.asarray(ids, dtype=np.int64).reshape(-1)
    prev = np.concatenate([[-1], ids[:-1]])
    return varint_encode(ids - prev)


def delta_decode_ids(stream: np.ndarray) -> np.ndarray:
    """Decode a delta-id stream back to the sorted id array."""
    d = varint_decode(stream)
    return np.cumsum(d) - 1


def mask_stream_bytes(mask: np.ndarray) -> tuple[int, int]:
    """Host (rle_bytes, delta_bytes) of one peer-row bitmap."""
    mask = np.asarray(mask, dtype=bool).reshape(-1)
    return (int(rle_encode(mask).size),
            int(delta_encode_ids(np.nonzero(mask)[0]).size))


# ---------------------------------------------------------------------------
# byte-length formulas (torch, exact, on the device)
# ---------------------------------------------------------------------------


def _t_varint_len(v: torch.Tensor) -> torch.Tensor:
    """LEB128 length of non-negative values below 2**31 (int32)."""
    n = torch.ones_like(v, dtype=torch.int32)
    for k in (7, 14, 21, 28):
        n += (v >= (1 << k)).to(torch.int32)
    return n


def delta_stream_bytes(act: torch.Tensor) -> torch.Tensor:
    """Exact delta-id stream bytes per row of ``act [..., cap]`` bool ->
    ``[...]`` int64. Equals ``len(delta_encode_ids(nonzero(row)))``: each
    active slot's delta to the previous active one (a running max of the
    active ids)."""
    cap = act.shape[-1]
    idx = torch.arange(cap, device=act.device).expand(act.shape)
    marked = torch.where(act, idx, -1)
    prev = torch.cat([torch.full(act.shape[:-1] + (1,), -1,
                                 dtype=marked.dtype, device=act.device),
                      torch.cummax(marked, -1).values[..., :-1]], -1)
    return torch.where(act, _t_varint_len(idx - prev), 0).sum(-1)


def rle_stream_bytes(act: torch.Tensor) -> torch.Tensor:
    """Exact rle stream bytes per row of ``act [..., cap]`` bool ->
    ``[...]`` int64. Equals ``len(rle_encode(row))``: each run's length is
    the distance from its start to the next run's start (a reversed
    running min of the run starts)."""
    cap = act.shape[-1]
    idx = torch.arange(cap, device=act.device).expand(act.shape)
    start = torch.ones_like(act)
    start[..., 1:] = act[..., 1:] != act[..., :-1]
    nxt_src = torch.where(start, idx, cap)
    # next run start strictly after i: reversed inclusive cummin, shifted
    rev = torch.cummin(nxt_src.flip(-1), -1).values.flip(-1)
    nxt = torch.cat([rev[..., 1:], torch.full(act.shape[:-1] + (1,), cap,
                                              dtype=rev.dtype,
                                              device=act.device)], -1)
    bts = torch.where(start, _t_varint_len(nxt - idx), 0).sum(-1)
    # a leading zero-length inactive run when slot 0 is active: 1 byte
    return bts + act[..., 0].to(bts.dtype)


def compressed_wire_bytes(plan, act: torch.Tensor, nw: int = 0):
    """Exact compressed wire bytes of each held partition's nn send.

    ``act [rows, p, cap]`` bool is each sender's per-peer active-slot map;
    the sender's own partition index is its row plus the first partition
    the process holds (0 emulated, the rank on a mesh). Picks the cheaper
    stream summed over the p - 1 other peers, delta on ties, and adds
    ``nw * 4`` bytes per active slot sent (the lane words, or ``W``
    payload values). Returns ``(wire_bytes [rows] int32, delta_used
    [rows] int32 0/1)``."""
    rows, p, _ = act.shape
    part0 = 0 if plan.mesh is None else plan.mesh.rank
    me = torch.arange(part0, part0 + rows, device=act.device)[:, None]
    peer = torch.arange(p, device=act.device)[None, :] != me     # [rows, p]
    rle_total = torch.where(peer, rle_stream_bytes(act), 0).sum(-1)
    del_total = torch.where(peer, delta_stream_bytes(act), 0).sum(-1)
    delta_used = del_total <= rle_total
    payload = (act & peer[..., None]).sum((-2, -1)) * (nw * 4)
    wire = torch.minimum(rle_total, del_total) + payload
    return wire.to(torch.int32), delta_used.to(torch.int32)
