"""Batch-mode msBFS serving: typed queries, result cache, engine."""
from .cache import LRUCache
from .engine import BFSServeEngine, ServeStats, default_graph_id
from .queries import (MAX_TARGETS, Query, QueryKind, QueryValidationError,
                      as_query, dedupe, unpack_result)

__all__ = ["BFSServeEngine", "LRUCache", "MAX_TARGETS", "Query", "QueryKind",
           "QueryValidationError", "ServeStats", "as_query", "dedupe",
           "default_graph_id", "unpack_result"]
