"""ShardPager: host-resident shards paged onto the device on demand (port
of `repro.engine.pager`).

A partitioned store with `residency="host"` (`MemoryStore.shard(
n_shards=S, residency="host")`) keeps its row blocks in host memory,
pinned where the store came from the card; only `slots` blocks at a time
live in device slot tables (slots, rows, ...). Per batch:

1. the router (engine/router.py) scores the store's sketch on the host,
   where the store, its sketch and the queries are, and picks each query's
   top-nprobe shards;
2. the shards of the batch that are not resident are copied into slots,
   the least recently used slots not in the batch evicted first
   (`non_blocking` copies from pinned memory, on the search's stream);
3. the routed search core that `RetrievalEngine.search(nprobe=p)` runs
   (`_routed_block_search`) searches the slot tables, with the slot ->
   shard map as key bases, so the result equals the routed search of a
   device-resident twin bit for bit;
4. the best shard the batch did not visit (by its queries' next picks) is
   staged into a spare buffer on a side stream while the search runs; a
   later batch that needs it installs it with a device-to-device copy
   (the stream waits for the staging copy's event).

Device memory holds O(slots x rows) rows and no sketch, whatever S. In
steady state a batch whose shards are all resident copies only the query
batch (words, visit lists, key bases) to the device; `transfers` counts
every byte the pager copies.

>>> import torch
>>> from repro_torch.core.avss import SearchConfig
>>> from repro_torch.engine import (MemoryStore, RetrievalEngine,
...                                 SearchRequest, ShardPager)
>>> cfg = SearchConfig("mtmc", cl=4, mode="avss", use_kernel="ref")
>>> vals = (torch.arange(64).reshape(32, 2) * 3) % 10
>>> store = MemoryStore.from_quantized(vals, torch.arange(32) % 8, cfg,
...                                    device="cpu")
>>> req = SearchRequest(mode="two_phase", k=4, nprobe=2)
>>> pager = ShardPager(store.shard(n_shards=4, residency="host"),
...                    RetrievalEngine(cfg), slots=3, device="cpu")
>>> res = pager.search(torch.tensor([[1, 2]]), req)
>>> ref = RetrievalEngine(cfg).search(store.shard(n_shards=4),
...                                   torch.tensor([[1, 2]]), req)
>>> bool(torch.equal(res.votes, ref.votes))
True
>>> len(pager.resident())
2
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Iterable

import torch

from repro_torch.engine import router as router_lib
from repro_torch.engine.api import SearchRequest, SearchResult
from repro_torch.engine.engine import BlockTable, RetrievalEngine
from repro_torch.engine.store import MemoryStore, resolve_device

#: the block leaves a slot holds (what a routed search reads)
_BLOCK_FIELDS = ("proj", "proj_packed", "s_grid", "labels")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class ShardPager:
    """LRU pager over a partitioned MemoryStore (module docstring).

    store: a store partitioned by `shard(n_shards=S, ...)`, S >= 2;
    `residency="host"` is the intended placement. engine: the engine whose
    routed core, backend and fused threshold the search runs. slots:
    device slot tables (default min(S, 4)); a batch's visited-shard union
    must fit in them, and room beyond it lets the prefetch stage a shard.
    prefetch: stage the next shard after each search (step 4). device:
    where the slots live (default: the card).

    Counters: `pages_in` blocks installed into slots; `transfers` bytes
    copied to the device as `blocks` (at a miss), `staged` (the
    prefetch's copies) and `batch` (query words, visit lists, key bases;
    the result stays on the device for the caller); `hits` / `misses` /
    `staged_hits` the batches' shard lookups."""

    def __init__(self, store: MemoryStore, engine: RetrievalEngine,
                 slots: int | None = None, prefetch: bool = True,
                 device: torch.device | str | None = None) -> None:
        if store.mesh is not None:
            raise ValueError(
                "ShardPager: pass a logically partitioned store "
                "(MemoryStore.shard(n_shards=S[, residency='host'])); "
                "mesh-sharded stores are already device-resident")
        if store.n_shards < 2:
            raise ValueError(
                "ShardPager: pass a partitioned store "
                "(MemoryStore.shard(n_shards=S[, residency='host'])), S >= 2")
        self.store = store
        self.engine = engine
        self.device = resolve_device(device)
        self.n_shards = store.n_shards
        self.rows = store.capacity // self.n_shards
        self.slots = min(self.n_shards, 4) if slots is None else slots
        if not 1 <= self.slots <= self.n_shards:
            raise ValueError(f"ShardPager: slots={self.slots} must be in "
                             f"[1, n_shards={self.n_shards}]")
        self.prefetch = prefetch
        self.pages_in = 0
        self.hits = self.misses = self.staged_hits = 0
        self.transfers = {"blocks": 0, "staged": 0, "batch": 0}
        s = self.n_shards
        self._host = {f: getattr(store, f).reshape(
            (s, self.rows) + tuple(getattr(store, f).shape[1:]))
            for f in _BLOCK_FIELDS if getattr(store, f) is not None}
        self._tables = {f: torch.zeros((self.slots,) + tuple(h.shape[1:]),
                                       dtype=h.dtype, device=self.device)
                        for f, h in self._host.items()}
        self._lru: OrderedDict[int, int] = OrderedDict()   # shard -> slot
        # shard -> (device blocks, the event their copy records)
        self._staged: dict[int, tuple[dict[str, torch.Tensor], object]] = {}
        self._side = (torch.cuda.Stream(self.device)
                      if self.device.type == "cuda" else None)

    # -- residency ----------------------------------------------------------

    def resident(self) -> list[int]:
        """Resident shard ids, ascending."""
        return sorted(self._lru)

    def _stage(self, shard: int) -> None:
        """Start copying one shard's blocks into fresh device buffers on
        the side stream (synchronously where the slots are on the CPU)."""
        if shard in self._lru or shard in self._staged:
            return
        event = None
        if self._side is None:
            blocks = {f: h[shard].clone() for f, h in self._host.items()}
        else:
            # allocated from the side stream's pool, so no block a pending
            # kernel of the search's stream still reads is handed out here
            with torch.cuda.stream(self._side):
                blocks = {f: h[shard].to(self.device, non_blocking=True)
                          for f, h in self._host.items()}
                event = torch.cuda.Event()
                event.record(self._side)
        self.transfers["staged"] += sum(_nbytes(b) for b in blocks.values())
        self._staged[shard] = (blocks, event)

    def ensure(self, shard_ids: Iterable[int]) -> dict[int, int]:
        """Page the given shards in (evicting the least recently used
        slots not among them) and return the shard -> slot map. Raises if
        they do not fit in the slots at once."""
        want = sorted({int(s) for s in shard_ids})
        if len(want) > self.slots:
            raise ValueError(
                f"ShardPager: {len(want)} shards requested at once but "
                f"only {self.slots} device slots (raise `slots` or lower "
                f"`nprobe`)")
        for shard in want:
            if shard in self._lru:
                self._lru.move_to_end(shard)
                self.hits += 1
                continue
            if len(self._lru) < self.slots:
                slot = len(self._lru)
            else:
                victim = next(s for s in self._lru if s not in want)
                slot = self._lru.pop(victim)
            staged = self._staged.pop(shard, None)
            if staged is not None:
                blocks, event = staged
                if event is not None:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(event)
                for f, block in blocks.items():
                    self._tables[f][slot].copy_(block)
                    if event is not None:   # freed only after this copy
                        block.record_stream(stream)
                self.staged_hits += 1
            else:
                for f, h in self._host.items():
                    self._tables[f][slot].copy_(h[shard], non_blocking=True)
                    self.transfers["blocks"] += _nbytes(h[shard])
                self.misses += 1
            self._lru[shard] = slot
            self.pages_in += 1
        return {s: self._lru[s] for s in want}

    # -- search --------------------------------------------------------------

    def search(self, queries, request: SearchRequest) -> SearchResult:
        """The routed search over the paged store: equal, bit for bit, to
        `RetrievalEngine.search(device_twin, queries, request)` with the
        same nprobe. The result lies on the pager's device."""
        p = request.nprobe
        if p is None or not 1 <= p <= self.n_shards:
            raise ValueError(
                f"ShardPager.search: request.nprobe must be in "
                f"[1, n_shards={self.n_shards}], got {p}")
        if p > self.slots:
            raise ValueError(f"ShardPager.search: nprobe={p} exceeds the "
                             f"{self.slots} device slots")
        store = self.store
        eng = self.engine.with_backend(request.backend).with_noisy(
            request.noisy)
        q = store.quantize_queries(queries)
        scores = router_lib.route_scores(q, store.sketch_sums,
                                         store.sketch_counts, eng.cfg.enc)
        order = torch.sort(scores, dim=1, stable=True).indices
        visited = torch.sort(order[:, :p], dim=1).values    # (B, p) shards
        slot_map = self.ensure(visited.unique().tolist())
        slot_of = torch.zeros(self.n_shards, dtype=torch.int64,
                              device=visited.device)
        slot_of[list(slot_map)] = torch.tensor(list(slot_map.values()),
                                               device=visited.device)
        base = torch.zeros(self.slots, dtype=torch.int64)
        for shard, slot in self._lru.items():
            base[slot] = shard * self.rows
        batch = [q.to(torch.int32), slot_of[visited], base]
        self.transfers["batch"] += sum(_nbytes(t) for t in batch)
        q_dev, ids_dev, base_dev = (t.to(self.device, non_blocking=True)
                                    for t in batch)
        table = BlockTable(proj=self._tables["proj"],
                           proj_packed=self._tables.get("proj_packed"),
                           s_grid=self._tables["s_grid"],
                           labels=self._tables["labels"],
                           pack_bits=store.pack_bits)
        res = eng._routed_block_search(q_dev, ids_dev, base_dev, table,
                                       request)
        if self.prefetch and p < self.n_shards and len(self._staged) < 2:
            # while the search runs: the shard the most queries would
            # visit next, by their (p+1)-th pick
            nxt = int(torch.bincount(order[:, p],
                                     minlength=self.n_shards).argmax())
            self._stage(nxt)
        return res
