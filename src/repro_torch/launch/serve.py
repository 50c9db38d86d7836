"""Serving launcher (port of `repro.launch.serve`): a batched-request LM
decode loop with the optional kNN-LM head over an MCAM store, and
multi-tenant retrieval serving. On the card unless `--device cpu`:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b \
        --batch 4 --steps 16 [--retrieval [--retrieval-mode ideal] ...]

`--smoke` is on by default, as in the reference (a `store_true` flag with
default True): the command line runs an arch's smoke config, and
`serve(arch, smoke=False, ...)` its full width.

`TenantServer` coalesces concurrent per-tenant queries into one batch,
searched once over a stacked `TenantStore` by
`RetrievalEngine.search_tenants`, and hands each ticket its row:

    PYTHONPATH=src python -m repro_torch.launch.serve --tenants 8 --steps 16
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import load_config
from repro_torch.engine.api import SearchRequest, SearchResult
from repro_torch.engine.store import resolve_device
from repro_torch.kernels import _build
from repro_torch.launch import steps as steps_lib
from repro_torch.models import transformer as tfm


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


def demo_store(cfg, seed: int = 0,
               device: torch.device | str | None = None):
    """The serve loop's token store: 1,024 slots at d = min(48, d_model),
    MTMC CL = 8 AVSS, calibrated on and written with 256 random vectors
    labelled with random token ids, drawn with numpy from `seed`. Returns
    (mem_cfg, store). The reference draws them from jax.random and pins
    use_kernel="ref"; here it is "auto", so on the card the head's
    searches run the kernels (the same results)."""
    from repro_torch.core.avss import SearchConfig
    from repro_torch.core.memory import MemoryConfig
    from repro_torch.engine import MemoryStore
    mem_cfg = MemoryConfig(capacity=1024, dim=min(48, cfg.d_model),
                           search=SearchConfig("mtmc", cl=8, mode="avss"))
    rng = np.random.default_rng(seed + 7)
    vecs = rng.standard_normal((256, mem_cfg.dim), dtype=np.float32)
    toks = rng.integers(0, cfg.vocab_size, 256)
    # programmed once at write time (values, proj, s_grid)
    store = MemoryStore.create(mem_cfg, device=device).calibrate(vecs) \
        .write(vecs, toks)
    return mem_cfg, store


def serve(arch: str, smoke: bool, batch: int, steps: int, prompt_len: int,
          retrieval: bool = False, retrieval_mode: str = "two-phase",
          retrieval_backend: str = "auto", retrieval_k: int = 32,
          retrieval_fused_min_rows: int | None = None,
          retrieval_shards: int | None = None,
          retrieval_nprobe: int | None = None, *, seed: int = 0,
          device: torch.device | str | None = None) -> np.ndarray:
    """Decode `steps` tokens for `batch` random requests after a random
    prompt of `prompt_len` tokens fed through the decode step, with random
    weights drawn on the device from `seed` (the reference draws from
    jax.random). With `retrieval`, every step mixes the kNN-LM head over
    `demo_store` ("dense", "two-phase" or "ideal"; `retrieval_shards`
    partitions the store, `retrieval_nprobe` routes it). Prints the
    throughput, asserts the last logits finite, and returns the decoded
    tokens (batch, steps)."""
    dev = resolve_device(device)
    cfg = load_config(arch, smoke=smoke)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = tfm.init(gen, cfg)
    caches = tfm.init_cache(cfg, batch, prompt_len + steps, dev)
    # the loop hands its caches over each step: rows are written in place
    step_fn = steps_lib.make_serve_step(cfg, inplace=True)

    store = None
    if retrieval:
        from repro_torch.engine import RetrievalEngine
        mem_cfg, store = demo_store(cfg, seed, dev)
        if retrieval_shards:
            # logical row partition; with nprobe < shards each step routes
            # through the per-shard sketch (engine/router.py)
            store = store.shard(n_shards=retrieval_shards)
        eng_kw = {} if retrieval_fused_min_rows is None else \
            {"fused_min_rows": retrieval_fused_min_rows}
        engine = (RetrievalEngine(mem_cfg.search, backend=retrieval_backend,
                                  **eng_kw)
                  if retrieval_mode in ("two-phase", "ideal") else None)
        mode = "ideal" if retrieval_mode == "ideal" else "two_phase"
        step_fn = steps_lib.make_serve_step_with_mcam(
            cfg, mem_cfg, engine=engine, k=retrieval_k, mode=mode,
            nprobe=retrieval_nprobe, inplace=True)

    def step(tok, caches, pos):
        args = (params, caches, {"tokens": tok}, pos)
        return step_fn(*args, store) if retrieval else step_fn(*args)

    rng = np.random.default_rng(seed + 1)

    def random_tokens():
        return torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (batch, 1))).to(dev)
    tok = random_tokens()
    for t in range(prompt_len):  # warm the cache with a random prompt
        logits, caches = step(tok, caches, t)
        tok = random_tokens()
    t0 = time.perf_counter()
    toks = []
    for i in range(steps):
        logits, caches = step(tok, caches, prompt_len + i)
        tok = torch.argmax(logits[:, 0], -1)[:, None]
        toks.append(tok.cpu().numpy())
    dt = time.perf_counter() - t0
    if not torch.isfinite(logits.float()).all():
        raise RuntimeError(f"serve {arch}: non-finite logits")
    print(f"{arch}: {steps} steps x {batch} reqs in {dt:.2f}s "
          f"({steps * batch / dt:.1f} tok/s) on {dev}")
    return np.concatenate(toks, 1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--retrieval", action="store_true")
    ap.add_argument("--retrieval-mode", default="two-phase",
                    choices=["dense", "two-phase", "ideal"],
                    help="dense: softmax over the whole store; two-phase: "
                         "engine shortlist + exact noisy rescore; ideal: "
                         "engine top-k by exact digital distance only")
    ap.add_argument("--retrieval-backend", default="auto",
                    choices=["auto", "ref", "pallas", "mxu", "fused"])
    ap.add_argument("--retrieval-k", type=int, default=32)
    ap.add_argument("--retrieval-fused-min-rows", type=int, default=None,
                    help="override the fused-shortlist row threshold "
                         "(results are the same either way)")
    ap.add_argument("--retrieval-shards", type=int, default=None,
                    help="partition the serve store into this many logical "
                         "row shards; prerequisite for --retrieval-nprobe")
    ap.add_argument("--retrieval-nprobe", type=int, default=None,
                    help="shards visited per query on a partitioned store "
                         "(default: every shard)")
    ap.add_argument("--tenants", type=int, default=None,
                    help="run the multi-tenant retrieval demo with this "
                         "many tenant stores instead of the decode loop")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    if args.tenants is not None:
        serve_tenants(args.tenants, args.steps, args.batch,
                      backend=args.retrieval_backend, k=args.retrieval_k,
                      seed=args.seed, device=args.device)
        return
    serve(args.arch, args.smoke, args.batch, args.steps, args.prompt_len,
          args.retrieval, args.retrieval_mode, args.retrieval_backend,
          args.retrieval_k, args.retrieval_fused_min_rows,
          args.retrieval_shards, args.retrieval_nprobe, seed=args.seed,
          device=args.device)


if __name__ == "__main__":
    main()
