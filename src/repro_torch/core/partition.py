"""Degree separation and edge distribution (paper Sections III-A, III-B).

Host-side (numpy) construction of the four-subgraph partitioned
representation. This runs once per graph, like the paper's distributed graph
construction phase; :func:`repro_torch.core.bfs.device_view` then places the
result on a device. Arrays and dtypes equal the reference package's
partitioner for the same graph.
"""
from __future__ import annotations

import numpy as np

from .types import COOGraph, CSR, PartitionedGraph, PartitionLayout


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
