"""Typed traversal queries compiled onto the batched msBFS substrate.

| kind               | per-lane params | lane early exit          | result |
|--------------------|-----------------|--------------------------|--------|
| ``LEVELS``         | --              | frontier empties         | ``[n] int32`` hop distances |
| ``REACHABILITY``   | --              | frontier empties         | ``[n] bool`` reachable mask |
| ``DISTANCE_LIMITED``| ``max_depth``  | depth cap folded into the lane_active word | ``[n] int32``, ``INF_LEVEL`` beyond the cap |
| ``MULTI_TARGET``   | ``targets``     | retires the sweep the last target is hit | ``{target: depth}`` (``INF_LEVEL`` if unreached) |

The descriptors of ``WEIGHTED_SSSP``, ``COMPONENTS`` and ``KHOP_SAMPLE``
exist (so cache keys and validation equal the reference's), but this
slice of the port does not serve them: the engine raises
``NotImplementedError`` at submit (ROADMAP.md queue A, item A9).

A batch that is homogeneously ``REACHABILITY`` runs the levels-free msBFS
variant (``MSBFSConfig(track_levels=False)``).

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


#: kinds whose descriptors exist but which this slice does not serve
DEFERRED_KINDS = frozenset({QueryKind.WEIGHTED_SSSP, QueryKind.COMPONENTS,
                            QueryKind.KHOP_SAMPLE})


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


def unpack_result(q: Query, row: np.ndarray, *, packed_reach: bool = False):
    """Per-kind result from one unpacked lane column ``row`` [n].

    ``packed_reach`` marks rows coming from the levels-free reachability
    variant (already bool). Array results own their memory.
    """
    if q.kind is QueryKind.REACHABILITY:
        return np.array(row if packed_reach else row != INF_LEVEL)
    if q.kind is QueryKind.MULTI_TARGET:
        return {t: int(row[t]) for t in q.targets}
    return np.array(row)
