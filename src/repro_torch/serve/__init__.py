"""msBFS serving: typed queries (the bit kinds and the payload kinds),
result cache, lane scheduling, engine (batch, lane-refill, overlapped and
streaming modes), and the multi-tenant frontend (``ServeFrontend``: many
tenant stream sessions over a catalog of graphs, SLO-class admission,
quotas, cross-session sharing, traffic-skew cache warming)."""
from .batcher import LaneAssignment, LaneScheduler, QueryBatcher, pack_sources
from .cache import LRUCache
from .engine import BFSServeEngine, ServeStats, default_graph_id
from .frontend import (SLO_CLASSES, SLO_LATENCY, SLO_THROUGHPUT,
                       QuotaExceeded, ServeFrontend, StreamSession,
                       TenantStats)
from .queries import (MAX_TARGETS, PAYLOAD_KINDS, Query, QueryKind,
                      QueryValidationError, as_query, dedupe, oracle_check,
                      unpack_result, warm_queries)

__all__ = [
    "BFSServeEngine", "LRUCache", "LaneAssignment", "LaneScheduler",
    "MAX_TARGETS", "PAYLOAD_KINDS", "Query", "QueryBatcher", "QueryKind",
    "QueryValidationError", "QuotaExceeded", "SLO_CLASSES", "SLO_LATENCY",
    "SLO_THROUGHPUT", "ServeFrontend", "ServeStats", "StreamSession",
    "TenantStats", "as_query", "default_graph_id", "dedupe", "oracle_check",
    "pack_sources", "unpack_result", "warm_queries",
]
