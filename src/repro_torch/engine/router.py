"""Phase-0 coarse router (port of `repro.engine.router`): per-shard
class-bucket sketches of a partitioned store, scored against the queries
to pick the shards a routed search (`SearchRequest.nprobe`) visits.

Every sketch is integer-exact: int32 sums and counts per (shard, bucket
label % ROUTER_BUCKETS) of valid rows, round-half-up integer centroids in
the store's level domain, projected through the store's own LUT, so the
scores are integer-valued f32 below 2**24 and the same in both packages.
Empty buckets carry SHORTLIST_MASK_PENALTY, the shortlist's mask.
"""

from __future__ import annotations

import torch

from repro_torch.core.encodings import Encoding
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.shortlist import SHORTLIST_MASK_PENALTY

#: class buckets per shard sketch (label % ROUTER_BUCKETS)
ROUTER_BUCKETS = 8


def bucket_sums(values: torch.Tensor, labels: torch.Tensor,
                n_buckets: int = ROUTER_BUCKETS
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-bucket int32 (sums (R, d), counts (R,)) of valid rows: rows
    bucket by label % n_buckets, label -1 rows contribute nothing. Integer
    `index_add_`, exact in any order."""
    lab = labels.to(torch.int64)
    keep = lab >= 0
    bucket = torch.remainder(lab[keep], n_buckets)
    sums = torch.zeros(n_buckets, values.shape[1], dtype=torch.int64,
                       device=values.device)
    sums.index_add_(0, bucket, values[keep].to(torch.int64))
    counts = torch.zeros(n_buckets, dtype=torch.int64, device=values.device)
    counts.index_add_(0, bucket, torch.ones_like(bucket))
    return sums.to(torch.int32), counts.to(torch.int32)


def build_sketch(values: torch.Tensor, labels: torch.Tensor, n_shards: int,
                 n_buckets: int = ROUTER_BUCKETS
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-store sketch: (S, R, d) int32 sums and (S, R) int32 counts over
    `n_shards` contiguous row blocks."""
    n = values.shape[0]
    if n % n_shards:
        raise ValueError(f"{n} rows do not split into {n_shards} shards")
    rows = n // n_shards
    parts = [bucket_sums(values[i * rows:(i + 1) * rows],
                         labels[i * rows:(i + 1) * rows], n_buckets)
             for i in range(n_shards)]
    return (torch.stack([p[0] for p in parts]),
            torch.stack([p[1] for p in parts]))


def sketch_centroids(sums: torch.Tensor, counts: torch.Tensor,
                     levels: int) -> torch.Tensor:
    """Integer bucket centroids: exact round-half-up mean, clamped to the
    level grid [0, levels). Empty buckets give level 0 (`route_scores`
    masks them)."""
    c = torch.clamp(counts, min=1).to(torch.int64)[..., None]
    cent = torch.div(2 * sums.to(torch.int64) + c, 2 * c,
                     rounding_mode="floor")
    return torch.clamp(cent, 0, levels - 1).to(torch.int32)


def route_scores(q_values: torch.Tensor, sketch_sums: torch.Tensor,
                 sketch_counts: torch.Tensor, enc: Encoding) -> torch.Tensor:
    """(B, S) router scores: per shard, the least exact LUT distance from
    each query's words to the shard's non-empty bucket centroids. One
    (B, 4d) x (4d, S R) f32 product of integers, exact below 2**24."""
    s, r, d = sketch_sums.shape
    cent = sketch_centroids(sketch_sums, sketch_counts, enc.levels)
    # through the store's bf16 projection, as the reference rounds it
    proj = kernel_ops.support_projection(cent.reshape(s * r, d),
                                         enc).to(torch.float32)
    q1h = kernel_ops.query_onehot(q_values, torch.float32).to(proj.device)
    dist = q1h @ proj.T                                    # (B, S*R)
    mask = torch.where(sketch_counts > 0, 0.0,
                       SHORTLIST_MASK_PENALTY).reshape(s, r)
    return (dist.reshape(-1, s, r) + mask[None]).amin(dim=-1)


def top_shards(scores: torch.Tensor, nprobe: int) -> torch.Tensor:
    """(B, nprobe) int64 shard ids a query, ascending: the smallest scores,
    ties to the lowest shard id (a stable sort on the score), then sorted
    by id, so the visited blocks concatenate in global row order."""
    order = torch.sort(scores, dim=1, stable=True).indices[:, :nprobe]
    return torch.sort(order, dim=1).values
