"""Multi-query (lane-word) pull with word-OR early exit.

Each row gathers its parents' lane words chunk by chunk, OR-accumulating
them, and stops as soon as the accumulated word covers every lane it still
needs:

    found[r] = (OR_{u in parents(r), chunks entered} frontier[u]) & need[r]
    work[r]  = parent slots of every chunk entered

Two entry points share one CUDA kernel (``csrc/ell_pull_multi.cu``):

* :func:`ell_pull_chunked_cuda` -- the main path: a stacked CSR (offsets
  ``[p, R+1]``, cols ``[p, E]``), frontier words ``[p, N, nw]``, need words
  ``[p, R, nw]``; returns found ``[p, R, nw]`` and work ``[p, R]``. One
  launch pulls one subgraph for every emulated partition.
* :func:`ell_pull_multi_cuda` -- the reference kernel's ELL contract
  (parents ``[R, K]`` -1 padded, one chunk of width K, negative columns
  skipped): ``(OR of valid parents) & active``.

:func:`ell_pull_chunked_plain` computes the main-path function in plain
PyTorch (the CPU path and the reference the kernel is held against on the
card). Words are int32 bit patterns.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .mask_reduce import or_fold

MAX_WORDS = 4      # lane words per vertex the kernel is instantiated for

_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int, ctypes.c_int,
                                     ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p)


def _check_stacked(offsets, cols, frontier, need):
    if offsets.dim() != 2 or cols.dim() != 2 or frontier.dim() != 3 or need.dim() != 3:
        raise ValueError("ell_pull: offsets [p, R+1], cols [p, E], frontier "
                         "[p, N, nw], need [p, R, nw] expected")
    p, r1 = offsets.shape
    if (cols.shape[0] != p or frontier.shape[0] != p
            or tuple(need.shape[:2]) != (p, r1 - 1)
            or need.shape[2] != frontier.shape[2]):
        raise ValueError(
            f"ell_pull: inconsistent shapes offsets {tuple(offsets.shape)}, "
            f"cols {tuple(cols.shape)}, frontier {tuple(frontier.shape)}, "
            f"need {tuple(need.shape)}")


def ell_pull_chunked_plain(offsets: torch.Tensor, cols: torch.Tensor,
                           frontier: torch.Tensor, need: torch.Tensor,
                           chunk: int):
    """Plain PyTorch chunked pull over a stacked CSR -> (found, work).

    Walks the rows that are still unsatisfied one chunk at a time (one host
    round trip per chunk, as PyTorch has no device-side loop)."""
    _check_stacked(offsets, cols, frontier, need)
    p, r1 = offsets.shape
    r, e = r1 - 1, cols.shape[1]
    n, nw = frontier.shape[1], frontier.shape[2]
    dev = offsets.device
    starts = offsets[:, :-1].reshape(-1).long()
    ends = offsets[:, 1:].reshape(-1).long()
    part = torch.arange(p, device=dev).repeat_interleave(r)
    need_f = need.reshape(p * r, nw)
    acc = torch.zeros_like(need_f)
    work = torch.zeros(p * r, dtype=torch.int32, device=dev)
    cols_f = cols.reshape(-1)
    front_f = frontier.reshape(p * n, nw)
    lanes = torch.arange(chunk, device=dev)
    rows = torch.nonzero((need_f != 0).any(1) & (ends > starts)).squeeze(1)
    k = 0
    while rows.numel():
        idx = (starts[rows] + k * chunk)[:, None] + lanes[None, :]
        in_row = idx < ends[rows][:, None]
        c = cols_f[part[rows][:, None] * e + idx.clamp(max=e - 1)]
        ok = in_row & (c >= 0)
        g = part[rows][:, None] * n + c.clamp(min=0)
        words = torch.where(ok[..., None], front_f[g], 0)   # [rows, chunk, nw]
        acc[rows] |= or_fold(words, 1)
        work[rows] += in_row.sum(1, dtype=torch.int32)
        k += 1
        keep = (((need_f[rows] & ~acc[rows]) != 0).any(1)
                & (ends[rows] > starts[rows] + k * chunk))
        rows = rows[keep]
    return (acc & need_f).reshape(p, r, nw), work.reshape(p, r)


def ell_pull_chunked_cuda(offsets: torch.Tensor, cols: torch.Tensor,
                          frontier: torch.Tensor, need: torch.Tensor,
                          chunk: int):
    """Launch ``csrc/ell_pull_multi.cu`` on the current stream -> (found,
    work). Inputs are checked here (the kernel trusts them); raises if the
    launch fails."""
    _check_stacked(offsets, cols, frontier, need)
    dev = _build.require("ell_pull_multi", torch.int32,
                         ("offsets", "cols", "frontier", "need"), offsets,
                         cols, frontier, need)
    p, r1 = offsets.shape
    nw = frontier.shape[2]
    if not 1 <= nw <= MAX_WORDS:
        raise ValueError(f"ell_pull: {nw} lane words per vertex; the kernel "
                         f"takes 1..{MAX_WORDS} (W <= {32 * MAX_WORDS})")
    if chunk <= 0:
        raise ValueError(f"ell_pull: chunk must be > 0, got {chunk}")
    found = torch.empty_like(need)
    work = torch.empty((p, r1 - 1), dtype=torch.int32, device=need.device)
    _build.launch("ell_pull_multi", _build.function(
        "ell_pull_multi", "ell_pull_chunked", _ARGTYPES), dev,
        offsets.data_ptr(), cols.data_ptr(), frontier.data_ptr(),
        need.data_ptr(), found.data_ptr(), work.data_ptr(),
        p, r1 - 1, cols.shape[1], frontier.shape[1], nw, chunk)
    return found, work


def ell_as_csr(parents: torch.Tensor):
    """The ELL contract as a one-partition stacked CSR: every row owns K
    consecutive slots (-1 padding included), pulled as one chunk of K."""
    r, k = parents.shape
    offsets = (torch.arange(r + 1, device=parents.device,
                            dtype=torch.int32) * k)[None]
    return offsets, parents.reshape(1, r * k), max(k, 1)
