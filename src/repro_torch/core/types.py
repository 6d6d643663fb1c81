"""Core datatypes for the degree-separated distributed graph engine.

Terminology follows the paper (Pan, Pearce, Owens 2018):

* ``delegates``       -- vertices with out-degree > TH, replicated on every
                         partition, identified by a dense delegate id in
                         ``[0, d)``.
* ``normal vertices`` -- vertices with out-degree <= TH, owned by exactly one
                         partition, identified locally by ``v // p``.
* four subgraphs per partition: ``nn``, ``nd``, ``dn``, ``dd`` by the
  (source, destination) vertex classes, each in CSR.

Per-partition arrays are stacked along a leading ``p`` axis and padded to
the per-type maximum. On the host the leaves are numpy arrays with the
reference package's dtypes (so partitions built by either package are
array-equal); :func:`repro_torch.core.bfs.device_view` turns them into
tensors on a device, where the emulated collectives run over the stacked
``p`` axis.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

INF_LEVEL = np.int32(2**30)  # "unvisited" marker for BFS levels


@dataclass(frozen=True)
class COOGraph:
    """Host-side edge list. Directed edge pairs; symmetrize for undirected."""

    n: int
    src: np.ndarray  # int64 [m]
    dst: np.ndarray  # int64 [m]

    @property
    def m(self) -> int:
        return int(self.src.shape[0])

    def symmetrized(self) -> "COOGraph":
        """Undirected graph via edge doubling (paper Section VI-A3)."""
        src = np.concatenate([self.src, self.dst])
        dst = np.concatenate([self.dst, self.src])
        return COOGraph(self.n, src, dst)

    def deduped(self) -> "COOGraph":
        """Duplicate (src, dst) pairs dropped, edges in (src, dst) order."""
        key = (self.src.astype(np.uint64) * np.uint64(self.n)
               + self.dst.astype(np.uint64))
        _, idx = np.unique(key, return_index=True)
        return COOGraph(self.n, self.src[idx], self.dst[idx])

    def without_self_loops(self) -> "COOGraph":
        keep = self.src != self.dst
        return COOGraph(self.n, self.src[keep], self.dst[keep])

    def out_degrees(self) -> np.ndarray:
        return np.bincount(self.src, minlength=self.n).astype(np.int64)


@dataclass(frozen=True)
class PartitionLayout:
    """Mapping between global vertex ids and (partition, local id).

    Follows Algorithm 1: ``P(v) = v mod p_rank``, ``G(v) = (v / p_rank) mod
    p_gpu``; flat partition = ``P(v) * p_gpu + G(v)``; local id = ``v // p``.
    """

    n: int
    p_rank: int
    p_gpu: int

    @property
    def p(self) -> int:
        return self.p_rank * self.p_gpu

    @property
    def n_local(self) -> int:
        """Max normal-vertex slots per partition."""
        return -(-self.n // self.p)

    def part_of(self, v: np.ndarray) -> np.ndarray:
        r = v % self.p_rank
        g = (v // self.p_rank) % self.p_gpu
        return (r * self.p_gpu + g).astype(np.int64)

    def local_of(self, v: np.ndarray) -> np.ndarray:
        return (v // self.p).astype(np.int64)

    def global_of(self, part: np.ndarray, local: np.ndarray) -> np.ndarray:
        """Inverse of (:meth:`part_of`, :meth:`local_of`)."""
        r = part // self.p_gpu
        g = part % self.p_gpu
        return (np.asarray(r) + self.p_rank * np.asarray(g)
                + self.p * np.asarray(local)).astype(np.int64)


@dataclass
class CSR:
    """Stacked padded CSR: one subgraph type across all partitions.

    offsets[k, r] .. offsets[k, r+1] index ``cols``/``rowids`` of partition k.
    ``rowids`` repeats the row index per edge (edge-parallel sweeps);
    padding edges (index >= m_k) carry rowid = n_rows and col = 0.

    The device view (:func:`repro_torch.core.bfs.device_view`) adds two
    flattened int64 index vectors over all partitions' edge slots, so the
    stacked sweeps gather and scatter with one index per edge:
    ``flat_rows = rowids + k * (n_rows + 1)`` (into the frontier rows
    extended by one empty row) and ``flat_cols = cols + k * n_dst``; on a
    card, the three pulled subgraphs also get the rows' pull schedule
    ``sched`` (:class:`repro_torch.kernels.pull_schedule.PullSchedule`:
    rows grouped by length for the early-exit pull kernels).
    """

    offsets: Any  # [p, n_rows+1] int32
    cols: Any     # [p, E_max]   int32
    rowids: Any   # [p, E_max]   int32
    m: Any        # [p]          int32 -- valid edge count per partition
    eidx: Any = None  # [p, E_max] int64 -- index into the source COO arrays
    n_rows: int = 0
    e_max: int = 0
    flat_rows: Any = None  # [p * E_max] int64 (device view only)
    flat_cols: Any = None  # [p * E_max] int64 (device view only)
    sched: Any = None      # PullSchedule (device view of dd/dn/nd on a card)


@dataclass
class CompressedCSR:
    """Delta-encoded, varint-packed adjacency for one subgraph stack.

    Per partition ``k`` and row ``r``, the byte range
    ``data[k, row_off[k, r] : row_off[k, r + 1]]`` is the LEB128 varint
    stream of the row's adjacency *sorted ascending and delta-encoded*:
    first the smallest neighbor id, then successive differences.
    ``nbytes[k]`` is the valid stream length (``data`` is padded to the
    stacked ``b_max``). For ``nn`` the stored value is the merged key
    ``owner * key_split + local`` (``key_split = n_local``), so one stream
    round-trips both halves of the pre-split destination pair. Host numpy
    arrays, equal to the reference's for the same partition.
    """

    data: Any        # [p, b_max] uint8 -- varint streams, padded
    row_off: Any     # [p, n_rows+1] uint32 -- byte offset per row
    nbytes: Any      # [p] int64 -- valid stream bytes per partition
    m: Any           # [p] int32 -- encoded edge count per partition
    n_rows: int = 0
    b_max: int = 0
    key_split: int = 0   # 0 = plain ids; > 0 = values are owner*split+local

    def memory_bytes(self) -> int:
        """Measured bytes: the streams plus the 4 B/row byte offsets."""
        ro = np.asarray(self.row_off)
        return int(np.sum(np.asarray(self.nbytes))) + int(
            ro.shape[0] * ro.shape[1] * 4)


@dataclass
class CompressedPartition:
    """All four subgraph stacks in the compressed-at-rest format (built by
    :func:`repro_torch.core.partition.compress_partition`; decoded on
    demand into ELL tiles by
    :func:`repro_torch.core.partition.decode_ell_tile`)."""

    nn: CompressedCSR
    nd: CompressedCSR
    dn: CompressedCSR
    dd: CompressedCSR

    def subgraph(self, kind: str) -> CompressedCSR:
        return {"nn": self.nn, "nd": self.nd, "dn": self.dn, "dd": self.dd}[kind]

    def memory_bytes(self) -> dict:
        per = {k: self.subgraph(k).memory_bytes()
               for k in ("nn", "nd", "dn", "dd")}
        return {"per_subgraph": per, "total": sum(per.values())}


@dataclass
class PartitionedGraph:
    """The paper's four-subgraph representation, stacked over partitions."""

    # -- static metadata ---------------------------------------------------
    n: int            # global vertex count
    p: int            # number of partitions
    p_rank: int
    p_gpu: int
    d: int            # number of delegates
    n_local: int      # normal-vertex slots per partition
    th: int           # degree threshold TH

    # -- per-partition subgraphs ------------------------------------------
    nn: CSR           # rows: local normal ids, cols: LOCAL dst ids at the owner
    nn_owner: Any     # [p, E_nn_max] int32: owner partition per nn edge
    nd: CSR           # rows: local normal ids, cols: delegate ids
    dn: CSR           # rows: delegate ids,     cols: local normal ids
    dd: CSR           # rows: delegate ids,     cols: delegate ids

    # -- replicated delegate data ------------------------------------------
    delegate_vids: Any   # [d] int64, sorted -- delegate id -> global vertex id

    # -- per-partition masks / degrees --------------------------------------
    normal_valid: Any    # [p, n_local] bool: slot holds a real normal vertex
    nd_src_mask: Any     # [p, n_local] bool: normal vertex has nd edges
    dn_src_mask: Any     # [p, d] bool: delegate has dn edges on this partition
    dd_src_mask: Any     # [p, d] bool: delegate has dd edges on this partition

    def subgraph(self, kind: str) -> CSR:
        return {"nn": self.nn, "nd": self.nd, "dn": self.dn, "dd": self.dd}[kind]

    def memory_bytes(self, compressed: CompressedPartition | None = None
                     ) -> dict:
        """Table I memory accounting in bytes (paper Section III-C): per
        subgraph ``(offsets, edges)`` of the unpadded layout, beside the
        16m edge list and the 8n + 8m CSR. Given a
        :class:`CompressedPartition`, also its *measured* at-rest sizes
        (streams + row byte offsets) and their ratio to the raw layout.
        The dict equals the reference's (host leaves only)."""
        p, nl, d = self.p, self.n_local, self.d
        enn, end, edn, edd = (int(np.sum(np.asarray(self.subgraph(k).m)))
                              for k in ("nn", "nd", "dn", "dd"))
        usage = {
            "nn": (p * (nl + 1) * 4, enn * 8),
            "nd": (p * (nl + 1) * 4, end * 4),
            "dn": (p * (d + 1) * 4, edn * 4),
            "dd": (p * (d + 1) * 4, edd * 4),
        }
        total = sum(a + b for a, b in usage.values())
        m = enn + end + edn + edd
        out = {
            "per_subgraph": usage,
            "total": total,
            "edge_list_16m": 16 * m,
            "csr_8n_8m": 8 * self.n + 8 * m,
            "m": m,
            "e_nn": enn,
        }
        if compressed is not None:
            cmem = compressed.memory_bytes()
            out["compressed_per_subgraph"] = cmem["per_subgraph"]
            out["compressed_total"] = cmem["total"]
            out["bytes_per_edge_raw"] = total / max(m, 1)
            out["bytes_per_edge_compressed"] = cmem["total"] / max(m, 1)
            out["compressed_vs_raw"] = cmem["total"] / max(total, 1)
        return out
