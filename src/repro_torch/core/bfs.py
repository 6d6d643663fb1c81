"""Device placement and the direction-optimization pieces shared with the
single-source traversal (paper Section IV-B).

Only what the batched msBFS path needs is here: the device view of a
partitioned graph, row degrees, and the per-lane push/pull decision.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .types import CSR, PartitionedGraph


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card
    raises -- there is no silent CPU fallback (pass ``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


def _csr_view(csr: CSR, n_dst: int, device) -> CSR:
    put = lambda a: torch.as_tensor(np.asarray(a)).to(device)
    rowids, cols = put(csr.rowids), put(csr.cols)
    p = rowids.shape[0]
    ks = torch.arange(p, device=rowids.device)[:, None]
    return CSR(
        offsets=put(csr.offsets), cols=cols, rowids=rowids, m=put(csr.m),
        eidx=None, n_rows=csr.n_rows, e_max=csr.e_max,
        flat_rows=(rowids.long() + ks * (csr.n_rows + 1)).reshape(-1),
        flat_cols=(cols.long() + ks * n_dst).reshape(-1))


def device_view(pg: PartitionedGraph, device="cuda") -> PartitionedGraph:
    """All data leaves as tensors on ``device``, with a leading partition
    axis (delegate ids tiled to ``[p, d]`` int32); the host-only edge index
    (``eidx``) is stripped. Each CSR also carries its flattened sweep
    indices (see :class:`~repro_torch.core.types.CSR`)."""
    dev = resolve_device(device)
    put = lambda a: torch.as_tensor(np.asarray(a)).to(dev)
    dslots = max(pg.d, 1)
    dv = np.repeat(np.asarray(pg.delegate_vids).astype(np.int32)[None],
                   pg.p, axis=0)
    return dataclasses.replace(
        pg,
        nn=_csr_view(pg.nn, pg.n_local, dev),
        nd=_csr_view(pg.nd, dslots, dev),
        dn=_csr_view(pg.dn, pg.n_local, dev),
        dd=_csr_view(pg.dd, dslots, dev),
        nn_owner=put(pg.nn_owner), delegate_vids=put(dv),
        normal_valid=put(pg.normal_valid), nd_src_mask=put(pg.nd_src_mask),
        dn_src_mask=put(pg.dn_src_mask), dd_src_mask=put(pg.dd_src_mask))


def _row_degrees(csr: CSR) -> torch.Tensor:
    """Per-row out-degree ``[p, n_rows]`` int32 of a stacked device CSR."""
    return csr.offsets[..., 1:] - csr.offsets[..., :-1]


def _decide_direction(backward, fv, bv, f0, f1):
    """Paper Section IV-B: forward if FV <= factor0*BV else backward, with
    hysteresis through factor1 on the way back. float32 throughout, with
    the reference's expression order (``f0 * bv`` multiplies a float32
    tensor by a Python float), so no decision can flip between packages."""
    go_back = (~backward) & (fv.to(torch.float32) > f0 * bv)
    go_fwd = backward & (fv.to(torch.float32) < f1 * bv)
    return (backward | go_back) & ~go_fwd
