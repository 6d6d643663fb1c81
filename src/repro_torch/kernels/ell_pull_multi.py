"""Multi-query (lane-word) pull with word-OR early exit.

Each row gathers its parents' lane words chunk by chunk, OR-accumulating
them, and stops as soon as the accumulated word covers every lane it still
needs:

    found[r] = (OR_{u in parents(r), chunks entered} frontier[u]) & need[r]
    work[r]  = parent slots of every chunk entered

Three entry points share one CUDA kernel (``csrc/ell_pull_multi.cu``, the
word instantiation of ``csrc/pull_rows.cuh``), scheduled by row length
(:mod:`~repro_torch.kernels.pull_schedule`):

* :func:`ell_pull_chunked_sweep_cuda` -- the main path: the three pulls of
  a sweep in one launch, each a stacked CSR (offsets ``[p, R+1]``, cols
  ``[p, E]``, its schedule), frontier words ``[p, N, nw]`` and need words
  ``[p, R, nw]``; returns found ``[p, R, nw]`` and work ``[p, R]`` for
  each.
* :func:`ell_pull_chunked_cuda` -- one subgraph, every emulated partition.
* the reference kernel's ELL contract (parents ``[R, K]`` -1 padded, one
  chunk of width K, negative columns skipped): ``(OR of valid parents) &
  active``, through :func:`ell_as_csr` in ``ops.ell_pull_multi``.

:func:`ell_pull_chunked_plain` computes the main-path function in plain
PyTorch (the CPU path and the reference the kernel is held against on the
card). Words are int32 bit patterns.
"""
from __future__ import annotations

import torch

from . import pull_schedule
from .mask_reduce import or_fold

MAX_WORDS = 4      # lane words per vertex the kernel is instantiated for


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


def ell_pull_chunked_sweep_cuda(pulls, chunk: int):
    """Launch ``csrc/ell_pull_multi.cu`` once over ``pulls`` (one to three
    ``(offsets, cols, sched, frontier, need)`` with one word count;
    ``sched`` None builds the schedule here, with one host read) on the
    current stream -> a list of ``(found, work)``. Inputs are checked here
    (the kernel trusts them); raises if the launch fails."""
    if not 1 <= len(pulls) <= pull_schedule.MAX_GRAPHS:
        raise ValueError(f"ell_pull: 1..{pull_schedule.MAX_GRAPHS} pulls a "
                         f"launch, got {len(pulls)}")
    if chunk <= 0:
        raise ValueError(f"ell_pull: chunk must be > 0, got {chunk}")
    nw = pulls[0][3].shape[-1] if pulls[0][3].dim() == 3 else 0
    if not 1 <= nw <= MAX_WORDS:
        raise ValueError(f"ell_pull: {nw} lane words per vertex; the kernel "
                         f"takes 1..{MAX_WORDS} (W <= {32 * MAX_WORDS})")
    graphs, fronts, needs, outs = [], [], [], []
    for offsets, cols, sched, frontier, need in pulls:
        _check_stacked(offsets, cols, frontier, need)
        if frontier.shape[2] != nw:
            raise ValueError("ell_pull: the pulls of one launch share their "
                             f"word count, got {nw} and {frontier.shape[2]}")
        if sched is None:
            sched = pull_schedule.build_schedule(offsets)
        graphs.append((offsets, cols, sched))
        fronts.append(frontier)
        needs.append(need)
        outs.append((torch.empty_like(need),
                     torch.empty(need.shape[:2], dtype=torch.int32,
                                 device=need.device)))
    pull_schedule.launch("ell_pull_multi", "ell_pull_words_sweep", graphs,
                         fronts, needs, outs, chunk, nw,
                         [f.shape[1] for f in fronts])
    return outs


def ell_pull_chunked_cuda(offsets: torch.Tensor, cols: torch.Tensor,
                          frontier: torch.Tensor, need: torch.Tensor,
                          chunk: int, sched=None):
    """One subgraph through :func:`ell_pull_chunked_sweep_cuda` -> (found,
    work)."""
    return ell_pull_chunked_sweep_cuda(
        [(offsets, cols, sched, frontier, need)], chunk)[0]


def ell_as_csr(parents: torch.Tensor):
    """The ELL contract as a one-partition stacked CSR: every row owns K
    consecutive slots (-1 padding included), pulled as one chunk of K.
    Returns ``(offsets, cols, chunk, sched)``, the schedule built on the
    fly (every row in one class)."""
    r, k = parents.shape
    offsets = (torch.arange(r + 1, device=parents.device,
                            dtype=torch.int32) * k)[None]
    return (offsets, parents.reshape(1, r * k), max(k, 1),
            pull_schedule.uniform_schedule(1, r, k, parents.device))
