"""msBFS serving: typed queries (the bit kinds and the payload kinds),
result cache, lane scheduling, engine (batch, lane-refill, overlapped and
streaming modes)."""
from .batcher import LaneAssignment, LaneScheduler, QueryBatcher, pack_sources
from .cache import LRUCache
from .engine import BFSServeEngine, ServeStats, default_graph_id
from .queries import (MAX_TARGETS, PAYLOAD_KINDS, Query, QueryKind,
                      QueryValidationError, as_query, dedupe, unpack_result)

__all__ = ["BFSServeEngine", "LRUCache", "LaneAssignment", "LaneScheduler",
           "MAX_TARGETS", "PAYLOAD_KINDS", "Query", "QueryBatcher",
           "QueryKind", "QueryValidationError", "ServeStats", "as_query",
           "dedupe", "default_graph_id", "pack_sources", "unpack_result"]
