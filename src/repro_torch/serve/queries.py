"""Typed traversal queries compiled onto the batched msBFS substrate.

| kind               | per-lane params | lane early exit          | result |
|--------------------|-----------------|--------------------------|--------|
| ``LEVELS``         | --              | frontier empties         | ``[n] int32`` hop distances |
| ``REACHABILITY``   | --              | frontier empties         | ``[n] bool`` reachable mask |
| ``DISTANCE_LIMITED``| ``max_depth``  | depth cap folded into the lane_active word | ``[n] int32``, ``INF_LEVEL`` beyond the cap |
| ``MULTI_TARGET``   | ``targets``     | retires the sweep the last target is hit | ``{target: depth}`` (``INF_LEVEL`` if unreached) |
| ``WEIGHTED_SSSP``  | --              | no vertex pending        | ``[n] int32`` distances over the synthetic edge weights |
| ``COMPONENTS``     | --              | no vertex pending        | ``[n] int32`` min vertex id of each vertex's component |
| ``KHOP_SAMPLE``    | ``max_depth`` (= k) | depth cap            | sorted ``int64`` ids within k hops |

``WEIGHTED_SSSP`` and ``COMPONENTS`` (:data:`PAYLOAD_KINDS`) ride the
int32 payload plane (``MSBFSConfig(payload=True)``); a batch holding one
runs the payload variant. A batch that is homogeneously ``REACHABILITY``
runs the levels-free msBFS variant (``MSBFSConfig(track_levels=False)``).

Cache identity is the full query descriptor: ``(graph_id, kind, params,
source)``.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np

from repro_torch.core.types import INF_LEVEL


class QueryValidationError(ValueError):
    """A query descriptor violates a static serving limit (e.g. more
    targets than ``Query.MAX_TARGETS``); the message names the limit."""


class QueryKind(enum.Enum):
    LEVELS = "levels"
    REACHABILITY = "reachability"
    DISTANCE_LIMITED = "distance_limited"
    MULTI_TARGET = "multi_target"
    WEIGHTED_SSSP = "weighted_sssp"
    COMPONENTS = "components"
    KHOP_SAMPLE = "khop_sample"


#: the kinds that ride the int32 payload plane instead of frontier bits
PAYLOAD_KINDS = frozenset({QueryKind.WEIGHTED_SSSP, QueryKind.COMPONENTS})


@dataclass(frozen=True)
class Query:
    """One typed traversal query (hashable: doubles as its own dedup and
    cache identity, see :meth:`key`)."""

    MAX_TARGETS = 8

    source: int
    kind: QueryKind = QueryKind.LEVELS
    max_depth: int | None = None      # DISTANCE_LIMITED / KHOP_SAMPLE (= k)
    targets: tuple | None = None      # MULTI_TARGET only (canonicalized)

    def __post_init__(self):
        object.__setattr__(self, "source", int(self.source))
        if self.kind in (QueryKind.DISTANCE_LIMITED, QueryKind.KHOP_SAMPLE):
            if self.max_depth is None or int(self.max_depth) < 0:
                raise ValueError(f"{self.kind.name} needs max_depth >= 0")
            object.__setattr__(self, "max_depth", int(self.max_depth))
        elif self.max_depth is not None:
            raise ValueError(f"{self.kind.name} takes no max_depth")
        if self.kind is QueryKind.MULTI_TARGET:
            if not self.targets:
                raise ValueError("MULTI_TARGET needs >= 1 target")
            tgts = tuple(sorted({int(t) for t in self.targets}))
            if len(tgts) > Query.MAX_TARGETS:
                raise QueryValidationError(
                    f"{len(tgts)} targets exceed the per-query limit "
                    f"Query.MAX_TARGETS={Query.MAX_TARGETS}")
            object.__setattr__(self, "targets", tgts)
        elif self.targets is not None:
            raise ValueError(f"{self.kind.name} takes no targets")

    @property
    def params(self) -> tuple:
        """Canonical hashable parameter tuple (part of the cache key)."""
        if self.kind is QueryKind.DISTANCE_LIMITED:
            return ("max_depth", self.max_depth)
        if self.kind is QueryKind.KHOP_SAMPLE:
            return ("k", self.max_depth)
        if self.kind is QueryKind.MULTI_TARGET:
            return ("targets",) + self.targets
        return ()

    @property
    def depth_cap(self):
        """Per-lane depth cap for the msBFS state (None = unlimited)."""
        if self.kind in (QueryKind.DISTANCE_LIMITED, QueryKind.KHOP_SAMPLE):
            return self.max_depth
        return None

    @property
    def payload_mode(self):
        """The msBFS payload-lane mode (None: an ordinary bit lane)."""
        if self.kind is QueryKind.WEIGHTED_SSSP:
            return "sssp"
        if self.kind is QueryKind.COMPONENTS:
            return "components"
        return None

    def key(self, graph_id: str) -> tuple:
        """Cache key: ``(graph_id, kind, params, source)``."""
        return (graph_id, self.kind.value, self.params, self.source)


MAX_TARGETS = Query.MAX_TARGETS


def as_query(q) -> Query:
    """Coerce a raw vertex id (the classic API) into a LEVELS query."""
    if isinstance(q, Query):
        return q
    return Query(source=int(q))


def dedupe(queries) -> tuple:
    """Order-preserving exact-descriptor dedup: ``(unique, n_dropped)``."""
    unique = list(dict.fromkeys(queries))
    return unique, len(queries) - len(unique)


def warm_queries(sources, kinds=(QueryKind.LEVELS,
                                 QueryKind.REACHABILITY)) -> list:
    """Landmark-warming descriptors: one query per (source, kind).

    Only the parameter-free kinds are warmable -- a DISTANCE_LIMITED,
    MULTI_TARGET or KHOP_SAMPLE entry is keyed by its params, so one
    guess would warm a key real traffic almost never asks for. The
    frontend's warmer builds its pre-compute batches here, so warm
    entries are the same descriptors as the live queries that hit them.
    """
    kinds = tuple(kinds)
    for k in kinds:
        if k in (QueryKind.DISTANCE_LIMITED, QueryKind.MULTI_TARGET,
                 QueryKind.KHOP_SAMPLE):
            raise ValueError(
                f"{k.value} queries are parameterized and cannot be "
                "pre-warmed; warm LEVELS/REACHABILITY instead")
    return [Query(int(s), kind=k) for s in sources for k in kinds]


def oracle_check(g, q: Query, answer, csr=None) -> None:
    """Assert ``answer`` matches the numpy oracle
    (:mod:`repro_torch.core.oracle`) for ``q`` on graph ``g``; ``csr``
    (``oracle.csr_from_coo(g)``) saves rebuilding it per call."""
    from repro_torch.core import oracle as O

    if q.kind is QueryKind.LEVELS:
        np.testing.assert_array_equal(answer, O.bfs_levels(g, q.source, csr))
    elif q.kind is QueryKind.REACHABILITY:
        np.testing.assert_array_equal(answer,
                                      O.reachable_mask(g, q.source, csr))
    elif q.kind is QueryKind.DISTANCE_LIMITED:
        np.testing.assert_array_equal(
            answer, O.bfs_levels_limited(g, q.source, q.max_depth, csr))
    elif q.kind is QueryKind.MULTI_TARGET:
        assert answer == O.target_depths(g, q.source, q.targets, csr), (
            q, answer)
    elif q.kind is QueryKind.WEIGHTED_SSSP:
        np.testing.assert_array_equal(answer,
                                      O.dijkstra_levels(g, q.source, csr))
    elif q.kind is QueryKind.COMPONENTS:
        np.testing.assert_array_equal(answer, O.component_labels(g))
    elif q.kind is QueryKind.KHOP_SAMPLE:
        np.testing.assert_array_equal(
            answer, O.khop_nodes(g, q.source, q.max_depth, csr))
    else:  # pragma: no cover - new kinds must extend this dispatch
        raise NotImplementedError(q.kind)


def unpack_result(q: Query, row: np.ndarray, *, packed_reach: bool = False):
    """Per-kind result from one unpacked lane column ``row`` [n].

    ``packed_reach`` marks rows coming from the levels-free reachability
    variant (already bool). Array results own their memory.
    """
    if q.kind is QueryKind.REACHABILITY:
        return np.array(row if packed_reach else row != INF_LEVEL)
    if q.kind is QueryKind.MULTI_TARGET:
        return {t: int(row[t]) for t in q.targets}
    if q.kind is QueryKind.KHOP_SAMPLE:
        # the k-hop seed pool: sorted ids the depth-capped lane reached
        return np.nonzero(row != INF_LEVEL)[0].astype(np.int64)
    # LEVELS / DISTANCE_LIMITED (capped) / WEIGHTED_SSSP distances /
    # COMPONENTS labels: absolute [n] int32 columns
    return np.array(row)
