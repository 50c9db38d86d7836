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

import functools

import torch

from repro_torch.core.encodings import Encoding
from repro_torch.kernels import _build
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.shortlist import SHORTLIST_MASK_PENALTY

#: class buckets per shard sketch (label % ROUTER_BUCKETS)
ROUTER_BUCKETS = 8


#: rows a product of `bucket_sums` sums: 255 * 2**16 < 2**24, so every
#: partial sum of octets stays an integer that float32 holds exactly
_OCTET_ROWS = 1 << 16


def bucket_sums(values: torch.Tensor, labels: torch.Tensor,
                n_buckets: int = ROUTER_BUCKETS
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-bucket int32 (sums (R, d), counts (R,)) of valid rows: rows
    bucket by label % n_buckets, label -1 rows contribute nothing.

    The reference's one-hot product, scatter-free, so the multi-shard
    write-through runs no scatter (analysis/contracts.py), in a fixed
    number of launches that read nothing back to the host. The card has
    no integer product, so each int32 value is split into its four
    octets (a byte view, no copy) and the (R, N) one-hot multiplies the
    (N, 4d) octets in float32, exactly, _OCTET_ROWS rows a product; the
    octet sums recombine in int64 and wrap to int32 as the reference's
    int32 product does."""
    n, d = values.shape
    lab = labels.to(torch.int64)
    bucket = torch.where(lab >= 0, torch.remainder(lab, n_buckets), -1)
    hit = bucket[:, None] == torch.arange(n_buckets, device=bucket.device)
    onehot = hit.to(torch.float32)                              # (N, R)
    octets = values.to(torch.int32).contiguous().reshape(-1).view(
        torch.uint8).reshape(n, 4 * d)                          # (N, 4d)
    parts = [(onehot[a:a + _OCTET_ROWS].T
              @ octets[a:a + _OCTET_ROWS].to(torch.float32)).to(torch.int64)
             for a in range(0, max(n, 1), _OCTET_ROWS)]         # (R, 4d)
    octet_sums = functools.reduce(torch.add, parts).reshape(n_buckets, d, 4)
    shifts = torch.arange(0, 32, 8, device=bucket.device)
    sums = (octet_sums << shifts).sum(-1)
    return sums.to(torch.int32), hit.sum(0).to(torch.int32)


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


#: the profiler range around `route_scores`
ROUTER_TAG = "router_sketch"


def route_scores(q_values: torch.Tensor, sketch_sums: torch.Tensor,
                 sketch_counts: torch.Tensor, enc: Encoding) -> torch.Tensor:
    """(B, S) router scores: per shard, the least exact LUT distance from
    each query's words to the shard's non-empty bucket centroids. One
    (B, 4d) x (4d, S R) f32 product of integers, exact below 2**24. Runs
    in the profiler range ROUTER_TAG (the reference's
    `jax.named_scope`) while a trace or a profiler records, which
    analysis/contracts.py looks for."""
    with _build.profiler_range(ROUTER_TAG):
        return _route_scores(q_values, sketch_sums, sketch_counts, enc)


def _route_scores(q_values, sketch_sums, sketch_counts, enc):
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
