"""Retrieval engine: MemoryStore + SearchRequest/SearchResult +
RetrievalEngine (unsharded)."""

from repro_torch.engine.api import SearchRequest, SearchResult
from repro_torch.engine.engine import IDEAL_FUSED_MIN_ROWS, RetrievalEngine
from repro_torch.engine.store import MemoryStore

__all__ = ["IDEAL_FUSED_MIN_ROWS", "MemoryStore", "RetrievalEngine",
           "SearchRequest", "SearchResult"]
