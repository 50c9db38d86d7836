"""Retrieval engine: MemoryStore + SearchRequest/SearchResult +
RetrievalEngine, the router (logical partitions, `nprobe`), the
mesh-sharded search (`shard(mesh, axes)`, engine/sharded.py), TenantStore
(multi-tenant search) and ShardPager (host-resident shards)."""

from repro_torch.engine.api import SearchRequest, SearchResult
from repro_torch.engine.engine import IDEAL_FUSED_MIN_ROWS, RetrievalEngine
from repro_torch.engine.pager import ShardPager
from repro_torch.engine.router import (ROUTER_BUCKETS, build_sketch,
                                       route_scores, top_shards)
from repro_torch.engine.store import MemoryStore
from repro_torch.engine.tenant import TenantStore, tenant_query_rank

__all__ = ["IDEAL_FUSED_MIN_ROWS", "MemoryStore", "ROUTER_BUCKETS",
           "RetrievalEngine", "SearchRequest", "SearchResult", "ShardPager",
           "TenantStore", "build_sketch", "route_scores", "tenant_query_rank",
           "top_shards"]
