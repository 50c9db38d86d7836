"""Multi-tenant retrieval serving (port of `TenantServer`, `serve_tenants`
and the `--tenants` path of `repro.launch.serve`).

`TenantServer` coalesces concurrent per-tenant queries into one batch,
searched once over a stacked `TenantStore` by
`RetrievalEngine.search_tenants`, and hands each ticket its row. The
standalone demo, on the card unless `--device cpu`:

    PYTHONPATH=src python -m repro_torch.launch.serve --tenants 8 --steps 16

The LM decode loop of the reference's `serve` (with its `--retrieval`
head) is not ported yet (ROADMAP Queue A10); without `--tenants` this
entry point raises NotImplementedError.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.engine.api import SearchRequest, SearchResult
from repro_torch.engine.store import _not_ported
from repro_torch.kernels import _build


class TenantServer:
    """Coalesce concurrent per-tenant queries into one search.

    `submit(tenant_id, query)` enqueues a query and returns its ticket;
    `flush()` stacks the queue into one (B, d) batch with its (B,) tenant
    ids, runs one `search_tenants`, and returns each ticket's row. Writes
    go through `TenantStore.write_at`, which keeps every leaf's shape.

    JAX's contract is one compiled program whatever the tenant mix and
    writes. Its analogue here, which `cache_entries` counts, is that a
    flush launches the same kernels the same number of times for any mix
    of tenants and any writes between flushes."""

    def __init__(self, engine, tstore, request: SearchRequest) -> None:
        self.engine = engine
        self.tstore = tstore
        self.request = request
        self._queue: list[tuple[torch.Tensor, int]] = []
        self._signatures: set[tuple] = set()
        self.flushes = 0

    def submit(self, tenant_id: int, query) -> int:
        """Enqueue one query for one tenant; returns its ticket, the row
        the next `flush()` hands back for it."""
        self._queue.append((torch.as_tensor(query), int(tenant_id)))
        return len(self._queue) - 1

    def flush(self) -> dict[int, SearchResult]:
        """Run the queued queries as one batch and return {ticket: its
        one-query SearchResult} (batch axis kept, so `.predict()` works
        per ticket). An empty queue returns {} and searches nothing."""
        if not self._queue:
            return {}
        q = torch.stack([query for query, _ in self._queue])
        tids = torch.tensor([t for _, t in self._queue], dtype=torch.int64)
        self._queue = []
        before = dict(_build.LAUNCHES)
        res = self.engine.search_tenants(self.tstore, q, tids, self.request)
        launches = tuple(sorted((k, v - before.get(k, 0))
                                for k, v in _build.LAUNCHES.items()))
        self._signatures.add((tuple(q.shape), launches))
        self.flushes += 1
        return {i: SearchResult(res.votes[i:i + 1], res.dist[i:i + 1],
                                res.indices[i:i + 1], res.labels[i:i + 1],
                                res.iterations)
                for i in range(q.shape[0])}

    def write(self, tenant_id: int, vectors, labels) -> None:
        """Ring write into one tenant; every leaf keeps its shape."""
        self.tstore = self.tstore.write_at(tenant_id, vectors, labels)

    def cache_entries(self) -> int:
        """The number of distinct (batch shape, kernel launches) pairs the
        flushes have had, the launches read from the kernel wrappers'
        counters (`kernels/_build.LAUNCHES`) around each search. One batch
        shape whose flushes all launched the same kernels the same number
        of times, whatever their tenants, counts 1. On the CPU no kernel
        launches, so it counts batch shapes, as JAX's jit cache does."""
        return len(self._signatures)


def demo_stores(n_tenants: int, dim: int = 16, capacity: int = 32,
                seed: int = 0, device: torch.device | str | None = None):
    """The demo's tenant stores, each calibrated on and written with its
    own rows drawn with numpy from `seed`, and the generator, whose later
    draws give the demo's traffic. The reference pins use_kernel="ref";
    here it is "auto", so on the card the searches run the kernels (the
    same results)."""
    from repro_torch.core.avss import SearchConfig
    from repro_torch.core.memory import MemoryConfig
    from repro_torch.engine import MemoryStore
    from repro_torch.engine.store import resolve_device
    dev = resolve_device(device)
    scfg = SearchConfig("mtmc", cl=8, mode="avss")
    mem_cfg = MemoryConfig(capacity=capacity, dim=dim, search=scfg)
    rng = np.random.default_rng(seed)
    stores = []
    for _ in range(n_tenants):
        vecs = rng.standard_normal((capacity, dim), dtype=np.float32)
        labs = rng.integers(0, 16, capacity)
        stores.append(MemoryStore.create(mem_cfg, device=dev)
                      .calibrate(vecs).write(vecs, labs))
    return stores, rng


def demo_step(rng: np.random.Generator, step: int, n_tenants: int,
              batch: int, dim: int):
    """One flush of the demo's traffic: (tenant ids, queries, and after
    every 4th flush a ring write (tenant, vectors, labels), else None)."""
    tids = rng.integers(0, n_tenants, batch)
    q = rng.standard_normal((batch, dim), dtype=np.float32)
    write = None
    if step % 4 == 3:
        write = (int(tids[0]), rng.standard_normal((2, dim),
                                                   dtype=np.float32), [3, 5])
    return tids, q, write


def serve_tenants(n_tenants: int, steps: int, batch: int, dim: int = 16,
                  capacity: int = 32, mode: str = "two_phase",
                  backend: str = "auto", k: int = 8, seed: int = 0,
                  device: torch.device | str | None = None) -> torch.Tensor:
    """The standalone multi-tenant demo: `demo_stores`, then `steps`
    coalesced flushes of `batch` queries with a ring write into one
    tenant after every 4th (`demo_step`); prints the throughput and
    `cache_entries()`, which must be 1. Returns the last flush's
    predictions."""
    from repro_torch.engine import RetrievalEngine, TenantStore
    stores, rng = demo_stores(n_tenants, dim, capacity, seed, device)
    dev = stores[0].device
    server = TenantServer(RetrievalEngine(stores[0].cfg.search,
                                          backend=backend),
                          TenantStore.stack(stores),
                          SearchRequest(mode=mode, k=k))
    t0 = time.perf_counter()
    for step in range(steps):
        tids, q, write = demo_step(rng, step, n_tenants, batch, dim)
        q = torch.from_numpy(q)
        tickets = [server.submit(int(tids[i]), q[i]) for i in range(batch)]
        out = server.flush()
        assert sorted(out) == tickets
        if write is not None:  # interleaved ring writes keep the launches
            server.write(*write)
    preds = torch.cat([out[i].predict() for i in sorted(out)]).cpu()
    dt = time.perf_counter() - t0
    entries = server.cache_entries()
    print(f"tenants={n_tenants}: {steps} flushes x {batch} queries in "
          f"{dt:.2f}s ({steps * batch / dt:.1f} q/s) on {dev}, "
          f"cache entries={entries}")
    assert entries == 1, f"flush launches depend on the mix: {entries}"
    return preds


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tenants", type=int, default=None,
                    help="run the multi-tenant retrieval demo with this "
                         "many tenant stores")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--retrieval-backend", default="auto",
                    choices=["auto", "ref", "pallas", "mxu", "fused"])
    ap.add_argument("--retrieval-k", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    if args.tenants is None:
        raise _not_ported("the LM decode loop of serve (--arch, "
                          "--retrieval)", "A10")
    serve_tenants(args.tenants, args.steps, args.batch,
                  backend=args.retrieval_backend, k=args.retrieval_k,
                  seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
