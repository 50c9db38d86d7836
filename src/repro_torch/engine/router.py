"""Per-shard class-bucket sketch leaves of the store (port of
`bucket_sums` / `build_sketch` from `repro.engine.router`). The store keeps
its S=1 sketch bit-exact so the routed search can build on it; routing
itself is not ported yet (ROADMAP Queue A6)."""

from __future__ import annotations

import torch

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
