"""Degree separation and edge distribution (paper Sections III-A, III-B).

Host-side (numpy) construction of the four-subgraph partitioned
representation. This runs once per graph, like the paper's distributed graph
construction phase; :func:`repro_torch.core.bfs.device_view` then places the
result on a device. Arrays and dtypes equal the reference package's
partitioner for the same graph, and so do the per-edge payloads that
:func:`partition_edge_values` lays out in the subgraphs' edge order. So do the compressed-at-rest streams
(:func:`compress_partition`) and their decoders, also host numpy.
"""
from __future__ import annotations

import numpy as np

from .types import (COOGraph, CompressedCSR, CompressedPartition, CSR,
                    PartitionedGraph, PartitionLayout)
from .varint import varint_decode, varint_encode, varint_len


def select_delegates(degrees: np.ndarray, th: int) -> np.ndarray:
    """Vertices with out-degree > TH become delegates (sorted by vertex id)."""
    return np.nonzero(degrees > th)[0].astype(np.int64)


def distribute_edges(
    g: COOGraph, layout: PartitionLayout, degrees: np.ndarray, delegate_vids: np.ndarray
):
    """Algorithm 1: returns (owner_partition [m], kind [m]) per edge.

    kind: 0=nn, 1=nd, 2=dn, 3=dd.
    """
    is_del = np.zeros(g.n, dtype=bool)
    is_del[delegate_vids] = True
    u, v = g.src, g.dst
    u_del, v_del = is_del[u], is_del[v]

    kind = (u_del.astype(np.int8) * 2 + v_del.astype(np.int8))  # 0 nn, 1 nd, 2 dn, 3 dd

    owner = np.empty(g.m, dtype=np.int64)
    # u normal -> owner(u)                 (nn, nd)
    mu = ~u_del
    owner[mu] = layout.part_of(u[mu])
    # u delegate, v normal -> owner(v)     (dn)
    mv = u_del & ~v_del
    owner[mv] = layout.part_of(v[mv])
    # both delegates: lower-degree endpoint's owner; ties -> min(u, v)
    md = u_del & v_del
    du, dv = degrees[u[md]], degrees[v[md]]
    um, vm = u[md], v[md]
    pick_u = (du < dv) | ((du == dv) & (um <= vm))
    owner[md] = layout.part_of(np.where(pick_u, um, vm))
    return owner, kind


def _build_csr_stack(
    p: int, n_rows: int, rows_per_edge: np.ndarray, cols_per_edge: np.ndarray,
    owner: np.ndarray, col_dtype, edge_index: np.ndarray | None = None,
) -> CSR:
    """Build the stacked padded CSR for one subgraph type across partitions."""
    counts = np.bincount(owner, minlength=p)
    e_max = int(counts.max()) if counts.size else 0
    e_max = max(e_max, 1)
    cols = np.zeros((p, e_max), dtype=col_dtype)
    rowids = np.full((p, e_max), n_rows, dtype=np.int32)
    eidx = np.full((p, e_max), -1, dtype=np.int64)
    m = counts.astype(np.int32)

    # sort edges by (owner, row) for CSR layout, then scatter every edge to
    # its (partition, slot) in one shot: slot = global position - the
    # partition's run start
    order = np.lexsort((rows_per_edge, owner))
    ro, rr, rc = owner[order], rows_per_edge[order], cols_per_edge[order]
    starts = np.searchsorted(ro, np.arange(p))
    slot = np.arange(ro.size, dtype=np.int64) - starts[ro]
    cols[ro, slot] = rc
    rowids[ro, slot] = rr
    if edge_index is not None:
        eidx[ro, slot] = edge_index[order]
    row_counts = np.zeros((p, n_rows), dtype=np.int64)
    np.add.at(row_counts, (owner, rows_per_edge), 1)
    offsets = np.zeros((p, n_rows + 1), dtype=np.int32)
    np.cumsum(row_counts, axis=1, out=offsets[:, 1:])
    return CSR(offsets=offsets, cols=cols, rowids=rowids, m=m, eidx=eidx,
               n_rows=n_rows, e_max=e_max)


def partition_graph(
    g: COOGraph, th: int, p_rank: int = 1, p_gpu: int = 1
) -> PartitionedGraph:
    """Full pipeline: degree separation + Algorithm 1 + four CSR subgraphs.

    ``g`` must already be symmetric (see ``COOGraph.symmetrized``) for
    direction-optimized BFS correctness, as the paper assumes.
    """
    layout = PartitionLayout(g.n, p_rank, p_gpu)
    p, n_local = layout.p, layout.n_local
    degrees = g.out_degrees()
    delegate_vids = select_delegates(degrees, th)
    d = int(delegate_vids.shape[0])
    dslots = max(d, 1)

    # global vid -> delegate id (dense search on sorted delegate vids)
    def to_del_id(v):
        return np.searchsorted(delegate_vids, v).astype(np.int64)

    owner, kind = distribute_edges(g, layout, degrees, delegate_vids)
    u, v = g.src, g.dst
    all_eidx = np.arange(g.m, dtype=np.int64)

    sub = {}
    # nn: rows local(u), cols pre-split (owner, local) int32 pairs -- the
    # owner partition and the local id are all any sweep derives from a
    # global destination id
    m = kind == 0
    sub["nn"] = _build_csr_stack(p, n_local, layout.local_of(u[m]), layout.local_of(v[m]),
                                 owner[m], np.int32, all_eidx[m])
    nn_owner_edge = layout.part_of(v[m]).astype(np.int32)
    # nd: rows local(u), cols delegate id
    m = kind == 1
    sub["nd"] = _build_csr_stack(p, n_local, layout.local_of(u[m]), to_del_id(v[m]), owner[m], np.int32, all_eidx[m])
    # dn: rows delegate id, cols local(v)
    m = kind == 2
    sub["dn"] = _build_csr_stack(p, dslots, to_del_id(u[m]), layout.local_of(v[m]), owner[m], np.int32, all_eidx[m])
    # dd: rows delegate id, cols delegate id
    m = kind == 3
    sub["dd"] = _build_csr_stack(p, dslots, to_del_id(u[m]), to_del_id(v[m]), owner[m], np.int32, all_eidx[m])

    # validity and direction-optimization source masks: every vertex slot
    # exists; only non-delegate slots are "normal"
    vids = np.arange(g.n, dtype=np.int64)
    normal_valid = np.zeros((p, n_local), dtype=bool)
    parts, locs = layout.part_of(vids), layout.local_of(vids)
    is_del = np.zeros(g.n, dtype=bool)
    is_del[delegate_vids] = True
    normal_valid[parts[~is_del], locs[~is_del]] = True

    def row_mask(csr: CSR) -> np.ndarray:
        deg = csr.offsets[:, 1:] - csr.offsets[:, :-1]
        return deg > 0

    nd_src_mask = row_mask(sub["nd"])
    dn_src_mask = row_mask(sub["dn"])
    dd_src_mask = row_mask(sub["dd"])

    # per-nn-edge owner partition, aligned with the nn CSR edge order:
    # invert the original-edge-index -> subset-position map with one scatter
    nn_owner = np.full((p, sub["nn"].e_max), p, dtype=np.int32)
    eidx_nn = np.asarray(sub["nn"].eidx)
    nn_orig_idx = all_eidx[kind == 0]
    inv = np.zeros(g.m, dtype=np.int64)
    inv[nn_orig_idx] = np.arange(nn_orig_idx.size, dtype=np.int64)
    valid = eidx_nn >= 0
    nn_owner[valid] = nn_owner_edge[inv[eidx_nn[valid]]]

    return PartitionedGraph(
        n=g.n, p=p, p_rank=p_rank, p_gpu=p_gpu, d=d, n_local=n_local, th=th,
        nn=sub["nn"], nd=sub["nd"], dn=sub["dn"], dd=sub["dd"], nn_owner=nn_owner,
        delegate_vids=delegate_vids if d else np.zeros(1, np.int64),
        normal_valid=normal_valid,
        nd_src_mask=nd_src_mask, dn_src_mask=dn_src_mask, dd_src_mask=dd_src_mask,
    )


def partition_edge_values(pg: PartitionedGraph, values: np.ndarray) -> dict:
    """Distribute per-edge payloads [m, Fe] (edge features, weights) into the
    four subgraphs' padded edge order. Padding slots get zeros."""
    out = {}
    for kind in ("nn", "nd", "dn", "dd"):
        eidx = np.asarray(pg.subgraph(kind).eidx)
        vals = values[np.maximum(eidx, 0)]
        vals[eidx < 0] = 0
        out[kind] = vals.astype(values.dtype)
    return out


# -----------------------------------------------------------------------------
# Compressed-at-rest partition (delta + varint adjacency streams)
#
# Per CSR row the adjacency is sorted ascending and delta-encoded (first
# value raw, then consecutive differences -- all >= 0), then packed with
# LEB128 varints into one byte stream per partition. Delegate stacks
# (dn/dd: long rows, small dense deltas) and normal stacks (nn/nd: short
# rows dominated by the first value) compress separately, as degree
# separation already split them. The nn stack merges its (owner, local)
# int32 column pair into one key ``owner * n_local + local`` so a single
# stream round-trips both halves.


def compress_csr(csr: CSR, key_split: int = 0,
                 values: np.ndarray | None = None) -> CompressedCSR:
    """Compress one stacked host CSR into per-partition delta/varint
    streams. ``values`` overrides ``csr.cols`` as the per-edge value (the
    nn stack's merged owner/local keys); ``key_split`` is recorded so
    decoders know how to split the key back."""
    offsets = np.asarray(csr.offsets)
    rowids_all = np.asarray(csr.rowids)
    vals_all = np.asarray(values if values is not None
                          else csr.cols).astype(np.int64)
    m = np.asarray(csr.m).astype(np.int64)
    p, n_rows = offsets.shape[0], csr.n_rows

    streams, row_offs = [], []
    for k in range(p):
        mk = int(m[k])
        r = rowids_all[k, :mk].astype(np.int64)
        v = vals_all[k, :mk]
        order = np.lexsort((v, r))        # CSR rows are contiguous; sort cols
        r, v = r[order], v[order]
        first = np.ones(mk, dtype=bool)
        first[1:] = r[1:] != r[:-1]
        delta = np.empty(mk, dtype=np.int64)
        delta[1:] = v[1:] - v[:-1]
        delta[first] = v[first]
        if mk and delta.min() < 0:
            raise ValueError("negative delta: adjacency values must be >= 0")
        streams.append(varint_encode(delta))
        row_bytes = np.bincount(r, weights=varint_len(delta),
                                minlength=n_rows)[:n_rows].astype(np.int64)
        ro = np.zeros(n_rows + 1, dtype=np.uint32)
        ro[1:] = np.cumsum(row_bytes)
        row_offs.append(ro)

    nbytes = np.array([s.size for s in streams], dtype=np.int64)
    b_max = max(1, int(nbytes.max()) if p else 1)
    data = np.zeros((p, b_max), dtype=np.uint8)
    for k, s in enumerate(streams):
        data[k, : s.size] = s
    return CompressedCSR(data=data, row_off=np.stack(row_offs), nbytes=nbytes,
                         m=m.astype(np.int32), n_rows=n_rows, b_max=b_max,
                         key_split=int(key_split))


def decode_rows(ccsr: CompressedCSR, k: int, row0: int = 0,
                row1: int | None = None):
    """Decode rows ``[row0, row1)`` of partition ``k``: ``(rowids,
    values)`` int64 in (row, value-ascending) order -- values are merged
    keys when ``key_split > 0``."""
    ro = np.asarray(ccsr.row_off[k]).astype(np.int64)
    if row1 is None:
        row1 = ccsr.n_rows
    b0, b1 = int(ro[row0]), int(ro[row1])
    deltas = varint_decode(np.asarray(ccsr.data[k, b0:b1]))
    if deltas.size == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    # the encoder is canonical, so each decoded value's encoded length is
    # its varint_len: per-value byte starts, then row ids
    lens = varint_len(deltas)
    byte_start = b0 + np.concatenate([[0], np.cumsum(lens)[:-1]])
    rows = np.searchsorted(ro, byte_start, side="right") - 1
    # undo the per-row delta chains: a segment cumsum with forward-filled
    # bases
    first = np.ones(deltas.size, dtype=bool)
    first[1:] = rows[1:] != rows[:-1]
    cs = np.cumsum(deltas)
    idx = np.arange(deltas.size, dtype=np.int64)
    seg_first = np.maximum.accumulate(np.where(first, idx, 0))
    base = (cs - deltas)[seg_first]
    return rows, cs - base


def decode_ell_tile(ccsr: CompressedCSR, k: int, row0: int, n_rows_tile: int,
                    k_max: int) -> np.ndarray:
    """An ELL tile ``[n_rows_tile, k_max]`` int32 (-1 padded) of partition
    ``k``'s rows from ``row0``, decoded on demand: the out-of-core input of
    ``kernels.ops.ell_pull_multi``. Values are merged keys when
    ``key_split > 0``; a row of degree above ``k_max`` raises."""
    row1 = min(row0 + n_rows_tile, ccsr.n_rows)
    rows, vals = decode_rows(ccsr, k, row0, row1)
    tile = np.full((n_rows_tile, k_max), -1, dtype=np.int32)
    if rows.size == 0:
        return tile
    r = rows - row0
    first = np.ones(rows.size, dtype=bool)
    first[1:] = rows[1:] != rows[:-1]
    starts = np.maximum.accumulate(np.where(first, np.arange(rows.size), 0))
    slot = np.arange(rows.size) - starts
    if slot.max() >= k_max:
        raise ValueError(
            f"row degree {int(slot.max()) + 1} exceeds k_max={k_max}")
    tile[r, slot] = vals.astype(np.int32)
    return tile


def compress_partition(pg: PartitionedGraph) -> CompressedPartition:
    """Compress all four subgraph stacks of a host partition (nn merges
    its owner/local keys)."""
    nl = pg.n_local
    nn_keys = (np.asarray(pg.nn_owner).astype(np.int64) * nl
               + np.asarray(pg.nn.cols).astype(np.int64))
    return CompressedPartition(
        nn=compress_csr(pg.nn, key_split=nl, values=nn_keys),
        nd=compress_csr(pg.nd),
        dn=compress_csr(pg.dn),
        dd=compress_csr(pg.dd),
    )


def edge_kind_stats(g: COOGraph, th: int) -> dict:
    """Fractions of nn/nd/dn/dd edges and delegates for a threshold TH
    (the quantities of paper Fig. 5 / Fig. 12), without building the
    partitioned structure."""
    is_del = g.out_degrees() > th
    u_del = is_del[g.src]
    v_del = is_del[g.dst]
    m = g.m
    return {
        "th": th,
        "frac_delegates": float(is_del.sum()) / g.n,
        "frac_nn": float((~u_del & ~v_del).sum()) / m,
        "frac_nd": float((~u_del & v_del).sum()) / m,
        "frac_dn": float((u_del & ~v_del).sum()) / m,
        "frac_dd": float((u_del & v_del).sum()) / m,
        "n_delegates": int(is_del.sum()),
    }
