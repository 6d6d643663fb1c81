"""Single-source bit pull with early exit (the paper's backward visit).

Each active row scans its parents chunk by chunk against a bit-packed
frontier mask and stops after the first chunk that holds a frontier
parent:

    found[r] = active[r] == 1 and some parent u, in the chunks entered,
               has bit (u & 31) of word (u >> 5) of the mask set
    work[r]  = in-row parent slots of every chunk entered

Three entry points share one CUDA kernel (``csrc/ell_pull.cu``, the bit
instantiation of ``csrc/pull_rows.cuh``), scheduled by row length
(:mod:`~repro_torch.kernels.pull_schedule`):

* :func:`ell_pull_bits_sweep_cuda` -- the main path: the three pulls of a
  sweep in one launch, each a stacked CSR (offsets ``[p, R+1]``, cols
  ``[p, E]``, its schedule), the column domain's frontier mask ``[p,
  ceil(N/32)]`` (packed by ``core.comm.pack_lanes`` over the vertex axis)
  and active rows ``[p, R]``; returns found ``[p, R]`` and work ``[p, R]``
  for each.
* :func:`ell_pull_bits_cuda` -- one subgraph, every emulated partition.
* the reference kernel's ELL contract (parents ``[R, W]`` -1 padded, one
  chunk of width W, negative columns skipped), through
  :func:`~repro_torch.kernels.ell_pull_multi.ell_as_csr` in ``ops.ell_pull``.

:func:`ell_pull_bits_plain` computes the main-path function in plain
PyTorch (the CPU path and the reference the kernel is held against on the
card). All tensors are int32; mask words are int32 bit patterns.
"""
from __future__ import annotations

import torch

from . import pull_schedule
from .ell_pull_multi import ell_pull_chunked_plain


def _check_stacked(offsets, cols, mask, active, chunk):
    if chunk <= 0:
        raise ValueError(f"ell_pull: chunk must be > 0, got {chunk}")
    if any(t.dim() != 2 for t in (offsets, cols, mask, active)):
        raise ValueError("ell_pull: offsets [p, R+1], cols [p, E], mask "
                         "[p, ceil(N/32)], active [p, R] expected")
    p, r1 = offsets.shape
    if (cols.shape[0] != p or mask.shape[0] != p
            or tuple(active.shape) != (p, r1 - 1)):
        raise ValueError(
            f"ell_pull: inconsistent shapes offsets {tuple(offsets.shape)}, "
            f"cols {tuple(cols.shape)}, mask {tuple(mask.shape)}, "
            f"active {tuple(active.shape)}")


def ell_pull_bits_plain(offsets: torch.Tensor, cols: torch.Tensor,
                        mask: torch.Tensor, active: torch.Tensor,
                        chunk: int):
    """Plain PyTorch bit pull over a stacked CSR -> (found, work).

    The single-bit pull is the lane-word pull with one lane: vertex u's
    frontier word is bit u of the mask, a row's need word is its active
    flag, and "need covered" is "found". So this runs
    :func:`~repro_torch.kernels.ell_pull_multi.ell_pull_chunked_plain` on
    those one-lane words (one host round trip per chunk)."""
    _check_stacked(offsets, cols, mask, active, chunk)
    shifts = torch.arange(32, dtype=torch.int32, device=mask.device)
    bits = (mask[..., None] >> shifts) & 1             # [p, NWm, 32]
    frontier = bits.reshape(mask.shape[0], -1, 1).contiguous()
    need = (active == 1).to(torch.int32)[..., None]
    found, work = ell_pull_chunked_plain(offsets, cols, frontier, need, chunk)
    return found[..., 0], work


def ell_pull_bits_sweep_cuda(pulls, chunk: int):
    """Launch ``csrc/ell_pull.cu`` once over ``pulls`` (one to three
    ``(offsets, cols, sched, mask, active)``; ``sched`` None builds the
    schedule here, with one host read) on the current stream -> a list of
    ``(found, work)``. Inputs are checked here (the kernel trusts them,
    column ids included: each must be < 32 * mask.shape[1]); raises if the
    launch fails."""
    if not 1 <= len(pulls) <= pull_schedule.MAX_GRAPHS:
        raise ValueError(f"ell_pull: 1..{pull_schedule.MAX_GRAPHS} pulls a "
                         f"launch, got {len(pulls)}")
    graphs, masks, actives, outs = [], [], [], []
    for offsets, cols, sched, mask, active in pulls:
        _check_stacked(offsets, cols, mask, active, chunk)
        if sched is None:
            sched = pull_schedule.build_schedule(offsets)
        graphs.append((offsets, cols, sched))
        masks.append(mask)
        actives.append(active)
        outs.append((torch.empty_like(active), torch.empty_like(active)))
    pull_schedule.launch("ell_pull", "ell_pull_bits_sweep", graphs, masks,
                         actives, outs, chunk, 1, [m.shape[1] for m in masks])
    return outs


def ell_pull_bits_cuda(offsets: torch.Tensor, cols: torch.Tensor,
                       mask: torch.Tensor, active: torch.Tensor, chunk: int,
                       sched=None):
    """One subgraph through :func:`ell_pull_bits_sweep_cuda` -> (found,
    work)."""
    return ell_pull_bits_sweep_cuda([(offsets, cols, sched, mask, active)],
                                    chunk)[0]
