"""The RetrievalEngine: `search(store, queries, SearchRequest) ->
SearchResult` (port of `repro.engine.engine`).

Every backend gives the same results: phase-1 distances are integers
below 2**24, selected by one exact (distance, row) key, and phase-2 noise
is a counter hash of absolute (query, string, cell) coordinates, so the
rescore of a row does not depend on which kernel evaluates it. The search
runs on the store's device: on a CUDA store the kernel wrappers launch
the kernels of `csrc/`, on a CPU store their plain versions.

`episode_votes` / `episode_scores` are the differentiable training twin
of `search(mode="full")`: the straight-through estimators wrapped around
the same quantizer, encoder, layout and physics, so that the votes equal
the served ones bit for bit for the same embeddings and range.

Three searches rank rows of per-query lists of row blocks, through one
core (`_routed_block_search`) and one kernel entry
(`kernels/shortlist.lut_shortlist_blocks`):

  search(nprobe=p)   a partitioned store's top-p shards by the router
                     sketch (engine/router.py); key rows are global rows
  ShardPager.search  the device slots holding those shards
                     (engine/pager.py); key rows are global rows
  search_tenants     each query's tenant in a stacked TenantStore
                     (engine/tenant.py); key rows are rows of the tenant

A mesh-sharded store (`store.shard(mesh, axes)`) is searched shard by
shard through engine/sharded.py: `two_phase` and `ideal` run each shard's
block through the kernels on its device and merge the (distance, global
row, label) triplets on the first shard's device; a routed search
(`nprobe` < S) runs `_routed_block_search` over each shard's own block
for the queries whose visit lists name it, then the same merge by
distance (each candidate's vote merged with it); `full` searches the
rows assembled with `.full()`. `SearchRequest.axes`
overrides the store's axes on a mesh store and is ignored on an
unsharded one, as in the reference. Every result equals the unsharded
store's bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Hashable

import numpy as np
import torch

from repro_torch.core import avss as avss_lib
from repro_torch.core import encodings as enc_lib
from repro_torch.core import mcam as mcam_lib
from repro_torch.core import quantization as quant_lib
from repro_torch.core.avss import SearchConfig
from repro_torch.engine.api import SearchRequest, SearchResult
from repro_torch.engine import router as router_lib
from repro_torch.engine import sharded as sharded_lib
from repro_torch.engine import tenant as tenant_lib
from repro_torch.engine.backends import resolve_backend
from repro_torch.engine.sharded import _use_fused
from repro_torch.engine.store import MemoryStore
from repro_torch.engine.tenant import TenantStore
from repro_torch.kernels import _build
from repro_torch.kernels import mcam_dist
from repro_torch.kernels import mcam_episode
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import ref as ref_kernels
from repro_torch.kernels import shortlist as shortlist_kernel

# Row threshold at and above which shortlists (`ideal`, and phase 1 of
# `two_phase`) go through the fused shortlist kernel instead of a dense
# (B, N) distance matrix. Kept at the JAX package's 1024 so both packages
# dispatch the same way. That value was measured with Pallas in CPU
# interpret mode; it has not been measured on the card. Override it per
# engine (`fused_min_rows=`) or per request (`SearchRequest.fused_min_rows`).
IDEAL_FUSED_MIN_ROWS = 1024

#: profiler ranges (`_build.profiler_range`) of a search: the whole call,
#: the query and support grids with the physics constants put on the card
#: (`_grids`), and the label gather and vote mask of an unsharded search
SEARCH_TAG = "engine.search"
GRIDS_TAG = "engine.grids"
LABELS_TAG = "engine.labels"


def noise_stream(key) -> int | None:
    """Fold a key (an int, or an integer array such as the two uint32
    words of `jax.random.key_data(k)`) into one uint32 noise-stream
    coordinate, as `repro.engine.engine._noise_stream` folds it: s =
    golden, then s = mix(s ^ word) for each word. None passes through: the
    stream-less coordinates are the serving ones."""
    if key is None:
        return None
    words = np.atleast_1d(np.asarray(key)).ravel().astype(np.int64)
    s = torch.tensor(0x9E3779B9, dtype=torch.int64)
    for w in words:
        s = mcam_lib._mix(s ^ (int(w) & 0xFFFFFFFF))
    return int(s)


# Added on the dense block route to the rows of blocks a query does not
# visit: above every visited row (real distances and the mask penalty stay
# below 2**23), and every sum stays integer-exact in f32 (< 2**24).
SHORTLIST_UNVISITED_PENALTY = 2.0 ** 23


@dataclasses.dataclass(frozen=True)
class BlockTable:
    """M row blocks of `rows` rows that per-query visit lists select from:
    a partitioned store's shards, a pager's device slots or a tenant
    stack's tenants. proj (M, rows, 4d), proj_packed (M, rows, dp) or
    None, s_grid (M, rows, seg, L, sl), labels (M, rows); pack_bits the
    width `proj_packed` was packed with."""

    proj: torch.Tensor
    proj_packed: torch.Tensor | None
    s_grid: torch.Tensor
    labels: torch.Tensor
    pack_bits: int

    @property
    def rows(self) -> int:
        return self.proj.shape[1]

    def flat(self, leaf: str) -> torch.Tensor:
        """A leaf with its block and row axes merged: table rows."""
        t = getattr(self, leaf)
        return t.reshape((-1,) + tuple(t.shape[2:]))


def _table_rows(key_rows: torch.Tensor, ids: torch.Tensor,
                base: torch.Tensor, rows: int) -> torch.Tensor:
    """(B, k) key rows -> rows of the flattened table: each key row lies
    in the visited block with the largest base at or below it (the visit
    lists ascend in base)."""
    vbase = base[ids]
    j = torch.searchsorted(vbase, key_rows, right=True) - 1
    return ids.gather(1, j) * rows + (key_rows - vbase.gather(1, j))


@dataclasses.dataclass(frozen=True)
class RetrievalEngine:
    """Dispatches AVSS / SVSS searches to a backend.

    cfg: the search configuration. backend: 'auto' | 'ref' | 'pallas' |
    'mxu' | 'fused' (see engine/backends.py); overrides cfg.use_kernel
    when not 'auto'. fused_min_rows: row threshold of the fused shortlist
    ('fused' always fuses, 'ref' never does)."""

    cfg: SearchConfig
    backend: str = "auto"
    fused_min_rows: int = IDEAL_FUSED_MIN_ROWS

    @property
    def resolved_backend(self) -> str:
        return resolve_backend(self.backend, self.cfg.use_kernel)

    def _cached_replace(self, key: Hashable,
                        **changes: Any) -> "RetrievalEngine":
        """dataclasses.replace cached per instance, so per-request
        overrides return the same engine object on every call."""
        cache = self.__dict__.get("_backend_cache")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_backend_cache", cache)
        eng = cache.get(key)
        if eng is None:
            eng = dataclasses.replace(self, **changes)
            cache[key] = eng
        return eng

    def with_backend(self, backend: str) -> "RetrievalEngine":
        """Engine with a per-request backend override; 'auto' and the
        current backend return self."""
        if backend in ("auto", self.backend):
            return self
        return self._cached_replace(backend, backend=backend)

    def with_noisy(self, noisy: bool | None) -> "RetrievalEngine":
        """Engine whose SearchConfig has `noisy` overridden; None and the
        current setting return self."""
        if noisy is None or noisy == self.cfg.noisy:
            return self
        return self._cached_replace(
            ("noisy", noisy), cfg=dataclasses.replace(self.cfg, noisy=noisy))

    def _fused_threshold(self, request: SearchRequest | None = None) -> int:
        if request is not None and request.fused_min_rows is not None:
            return request.fused_min_rows
        return self.fused_min_rows

    # -- unified entry point -----------------------------------------------

    def search(self, store: MemoryStore, queries,
               request: SearchRequest | None = None) -> SearchResult:
        """Search a programmed MemoryStore, on the store's device.

        queries: (B, dim) float embeddings (quantized with the store's
        calibrated range) or pre-quantized integer words. A mesh store is
        searched shard by shard (module docstring); results are on its
        first shard's device."""
        with _build.profiler_range(SEARCH_TAG):
            req = request if request is not None else SearchRequest()
            if store.residency == "host":
                raise ValueError(
                    "RetrievalEngine.search: this store's shards live in "
                    "host memory (shard(..., residency='host')); search it "
                    "through repro_torch.engine.pager.ShardPager, which "
                    "pages the visited shards onto the device, or re-shard "
                    "with residency='device'.")
            eng = self.with_backend(req.backend).with_noisy(req.noisy)
            q = store.quantize_queries(queries)
            # routing engages iff the request visits fewer shards than
            # the store has; nprobe=None and nprobe >= n_shards are the
            # exhaustive search below, byte for byte
            if (req.nprobe is not None and req.mode != "full"
                    and req.nprobe < store.n_shards):
                return eng._search_routed(store, q, req)
            if store.mesh is None:
                return eng._search_unsharded(store, q, req)
            if req.mode == "full":
                return eng._search_unsharded(store.assembled(), q, req)
            return eng._search_mesh(store, q, req)

    def _search_mesh(self, store: MemoryStore, q: torch.Tensor,
                     req: SearchRequest) -> SearchResult:
        """Exhaustive two_phase / ideal of a mesh store: per-shard
        shortlists (the fused kernel once a shard's rows reach the fused
        threshold) and, for two_phase, per-shard rescores, merged by
        engine/sharded.py; `req.axes` overrides the store's axes."""
        axes = tuple(req.axes) if req.axes is not None else store.axes
        common = dict(k=req.k, backend=self.resolved_backend,
                      fused_min_rows=self._fused_threshold(req),
                      packed=store.proj_packed, pack_bits=store.pack_bits)
        if req.mode == "two_phase":
            res = sharded_lib.sharded_two_phase_search(
                q, store.values, self.cfg, store.mesh, axes,
                valid=store.valid, labels=store.labels, s_grid=store.s_grid,
                proj=store.proj, **common)
        else:
            res = sharded_lib.sharded_ideal_search(
                q, store.proj, store.labels, store.mesh, axes, **common)
        votes = torch.where(res["labels"] >= 0, res["votes"], float("-inf"))
        return SearchResult(votes, res["dist"], res["indices"], res["labels"],
                            self._iterations(q.shape[-1]))

    # -- routed search -----------------------------------------------------

    def _search_routed(self, store: MemoryStore, q: torch.Tensor,
                       req: SearchRequest) -> SearchResult:
        """nprobe-routed search of a partitioned store: the router sketch
        picks each query's top-p shards (engine/router.py), and phase 1 /
        2 rank only their rows, equal to the exhaustive search restricted
        to the visited shards. `self` carries the request's overrides;
        `q` is quantized."""
        s = store.n_shards
        rows = store.capacity // s
        sums, counts = store.sketch_sums, store.sketch_counts
        if store.mesh is not None:      # (S, R, d): one block a shard
            sums, counts = sums.full(store.device), counts.full(store.device)
        scores = router_lib.route_scores(q, sums, counts, self.cfg.enc)
        ids = router_lib.top_shards(scores, req.nprobe)
        if store.mesh is not None:
            return self._routed_mesh(store, q, ids, req)

        def blocks(t: torch.Tensor) -> torch.Tensor:
            return t.reshape((s, rows) + tuple(t.shape[1:]))

        table = BlockTable(proj=blocks(store.proj),
                           proj_packed=(None if store.proj_packed is None
                                        else blocks(store.proj_packed)),
                           s_grid=blocks(store.s_grid),
                           labels=blocks(store.labels),
                           pack_bits=store.pack_bits)
        base = torch.arange(s, device=store.device) * rows
        return self._routed_block_search(q, ids, base, table, req)

    def _routed_block_search(self, q: torch.Tensor, ids: torch.Tensor,
                             base: torch.Tensor, table: BlockTable,
                             req: SearchRequest,
                             noise_qidx: torch.Tensor | None = None
                             ) -> SearchResult:
        """The core of the routed, paged and tenant searches (port of
        `repro.engine.engine._routed_block_search`). q (B, d) words; ids
        (B, p) int64 the table blocks each query visits, ascending in
        base; base (M,) int64 the key row of each block's row 0: the
        global row of a shard (routed, paged), 0 for a tenant; both on the
        table's device. Phase 1 ranks each query's
        visited rows by (distance, key row); phase 2 rescores the
        candidates with their key rows as noise rows and `noise_qidx`
        (default arange(B)) as query coordinates, so routed votes equal
        the full search's at the same (query, row). Returns indices = key
        rows."""
        if self.cfg.mode != "avss":
            raise ValueError("routed searches shortlist the AVSS LUT "
                             "(mode='avss')")
        k = min(req.k, ids.shape[1] * table.rows)
        dist, key_rows = self._block_shortlist(
            q, table, ids, base, k, self._fused_threshold(req))
        rows = _table_rows(key_rows, ids, base, table.rows)
        labels = table.flat("labels")[rows]
        if req.mode == "two_phase":
            q_grid, s_grid, weights, thresholds = self._grids(
                q, None, table.flat("s_grid"))
            rescore = (kernel_ops.rescore_shortlist_plain
                       if self.resolved_backend == "ref"
                       else kernel_ops.rescore_shortlist)
            votes = rescore(q_grid, s_grid, rows, weights, self.cfg,
                            thresholds, noise_idx=key_rows,
                            noise_qidx=noise_qidx)
        else:
            votes = -dist
        votes = torch.where(labels >= 0, votes, float("-inf"))
        return SearchResult(votes, dist, key_rows, labels,
                            self._iterations(q.shape[-1]))

    def _block_shortlist(self, q: torch.Tensor, table: BlockTable,
                         ids: torch.Tensor, base: torch.Tensor, k: int,
                         fused_min_rows: int | None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
        """Each query's k best (distance, key row) over its visited blocks:
        the block-table entry of the fused kernel (`_use_fused` on the p
        rows-a-block a query ranks), else the dense route: the LUT product
        of every table row once, the mask penalty, and
        SHORTLIST_UNVISITED_PENALTY on the blocks a query does not visit
        (k <= p rows keeps the selection inside the visited rows)."""
        valid = table.labels >= 0
        rows = table.rows
        if _use_fused(self.resolved_backend, ids.shape[1] * rows,
                      fused_min_rows):
            if table.proj_packed is not None:
                return shortlist_kernel.lut_shortlist_blocks(
                    q, None, k, base=base, ids=ids, valid=valid,
                    packed=table.proj_packed, pack_bits=table.pack_bits)
            return shortlist_kernel.lut_shortlist_blocks(
                q, table.proj, k, base=base, ids=ids, valid=valid)
        m = table.proj.shape[0]
        dist = self._lut_dist(q, table.flat("proj")).reshape(-1, m, rows)
        visited = torch.zeros(dist.shape[:2], dtype=torch.bool,
                              device=dist.device).scatter_(1, ids, True)
        dist = (dist + torch.where(valid, 0.0,
                                   kernel_ops.SHORTLIST_MASK_PENALTY)[None]
                + torch.where(visited, 0.0,
                              SHORTLIST_UNVISITED_PENALTY)[:, :, None])
        every = torch.arange(m, device=dist.device).expand(dist.shape[0], m)
        keys = shortlist_kernel.block_keys(dist.reshape(len(dist), -1), base,
                                           every, rows)
        top = torch.topk(keys, k, dim=1, largest=False, sorted=True).values
        return shortlist_kernel.split_keys(top)

    def _routed_mesh(self, store: MemoryStore, q: torch.Tensor,
                     ids: torch.Tensor, req: SearchRequest) -> SearchResult:
        """The routed search of a mesh store, equal to the unsharded
        store's: each shard runs `_routed_block_search` over its own
        block (a one-block table: the block-table entry on the shard's
        device) for the queries whose visit lists `ids` name it, with
        their batch positions as noise coordinates; the shards'
        candidates (distance, global row, label and vote, k_loc = min(k,
        rows) each) merge on the first shard's device by a stable sort on
        distance, the unvisited shards' slots at +inf. A store without
        `proj_packed` streams each shard's wide projection, as the
        logical partition does."""
        s, dev0, B = store.n_shards, store.device, q.shape[0]
        rows = store.capacity // s
        k = min(req.k, ids.shape[1] * rows)
        dist = torch.full((B, s, min(k, rows)), float("inf"), device=dev0)
        votes = torch.zeros_like(dist)
        key_rows = torch.full_like(dist, -1, dtype=torch.int64)
        labels = torch.full_like(dist, -1, dtype=torch.int32)
        for i in range(s):
            sel = torch.nonzero((ids == i).any(dim=1))[:, 0]
            if not len(sel):
                continue
            table = BlockTable(
                proj=store.proj.block(i)[None],
                proj_packed=(None if store.proj_packed is None
                             else store.proj_packed.block(i)[None]),
                s_grid=store.s_grid.block(i)[None],
                labels=store.labels.block(i)[None],
                pack_bits=store.pack_bits)
            dev = table.proj.device
            res = self._routed_block_search(
                q[sel].to(dev),
                torch.zeros(len(sel), 1, dtype=torch.int64, device=dev),
                torch.full((1,), i * rows, dtype=torch.int64, device=dev),
                table, req, noise_qidx=sel.to(dev))
            for buf, part in ((dist, res.dist), (votes, res.votes),
                              (key_rows, res.indices), (labels, res.labels)):
                buf[sel, i] = part.to(dev0)
        take = sharded_lib._merge(dist.reshape(B, -1), k)
        return SearchResult(*(take(t.reshape(B, -1))
                              for t in (votes, dist, key_rows, labels)),
                            self._iterations(q.shape[-1]))

    def _lut_dist(self, q: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
        """(B, N) exact LUT distances of query words against projection
        rows: the `mcam_dist` kernel, or its plain version on 'ref'."""
        q1h = kernel_ops.query_onehot(q, proj.dtype).to(proj.device)
        fn = (mcam_dist.lut_dist_matmul_plain
              if self.resolved_backend == "ref"
              else mcam_dist.lut_dist_matmul)
        return fn(q1h.contiguous(), proj.contiguous())

    # -- multi-tenant search -----------------------------------------------

    def search_tenants(self, tstore: TenantStore, queries,
                       tenant_ids, request: SearchRequest | None = None
                       ) -> SearchResult:
        """One search over a batch of queries from many tenants of a
        stacked TenantStore (engine/tenant.py), equal per tenant, bit for
        bit, to `search(tstore.tenant(t), its queries in batch order)`.

        queries: (B, dim) float embeddings, each quantized against its own
        tenant's range, or integer words. tenant_ids: (B,) each query's
        tenant. Noise coordinates: a query's rank within its tenant group
        (`tenant_query_rank`) and its candidates' rows within the tenant,
        exactly the solo search's. Results span the stack's padded
        capacity: a ragged tenant's pad rows behave as never-written slots.

        Every mode launches the same kernels the same number of times for
        any mix of tenants: two_phase / ideal through the block-table
        shortlist (one block a query) and the gathered physics; full
        through the gathered physics over every row of the query's tenant
        (rows t n_pad + r, noise rows r), the entry that returns each
        pair's dist too ('ref': the reference loop a query)."""
        req = request if request is not None else SearchRequest()
        eng = self.with_backend(req.backend).with_noisy(req.noisy)
        tids = torch.as_tensor(tenant_ids).to(device=tstore.device,
                                              dtype=torch.int64)
        q = tstore.quantize_queries(queries, tids)
        rank = tenant_lib.tenant_query_rank(tids)
        if req.mode == "full":
            return eng._tenants_full(tstore, q, tids, rank)
        table = BlockTable(proj=tstore.proj, proj_packed=tstore.proj_packed,
                           s_grid=tstore.s_grid, labels=tstore.labels,
                           pack_bits=tstore.pack_bits)
        base = torch.zeros(tstore.n_tenants, dtype=torch.int64,
                           device=tstore.device)
        return eng._routed_block_search(q, tids[:, None], base, table, req,
                                        noise_qidx=rank)

    def _tenants_full(self, tstore: TenantStore, q: torch.Tensor,
                      tids: torch.Tensor, rank: torch.Tensor
                      ) -> SearchResult:
        """`full` of each query against every row of its tenant."""
        n_pad = tstore.n_pad
        dev = tstore.device
        r = torch.arange(n_pad, device=dev)
        s_flat = tstore.s_grid.reshape((-1,) + tuple(tstore.s_grid.shape[2:]))
        q_grid, _, weights, thresholds = self._grids(q, None, s_flat)
        if self.resolved_backend == "ref":
            per_query = [avss_lib._search_one_query(
                q_grid[b], tstore.s_grid[tids[b]], rank[b], weights,
                self.cfg, thresholds) for b in range(q_grid.shape[0])]
            votes = torch.stack([v for v, _ in per_query])
            dist = torch.stack([d for _, d in per_query])
        else:
            rows = tids[:, None] * n_pad + r
            votes, dist = kernel_ops.rescore_shortlist(
                q_grid, s_flat, rows, weights, self.cfg, thresholds,
                noise_idx=r.expand(rows.shape), noise_qidx=rank,
                with_dist=True)
        labels = tstore.labels[tids]
        votes = torch.where(labels >= 0, votes, float("-inf"))
        return SearchResult(votes, dist, r.expand(votes.shape), labels,
                            self._iterations(q.shape[-1]))

    # -- differentiable episodic forward (hardware-aware training) ---------

    def episode_votes(self, q_emb: torch.Tensor, s_emb: torch.Tensor, *,
                      clip_std: float = 2.5, sa_tau: float = 0.02,
                      key=None, noisy: bool | None = None,
                      rng_range: tuple[torch.Tensor, torch.Tensor] | None
                      = None) -> dict[str, Any]:
        """Differentiable end-to-end MCAM forward on float embeddings, on
        their device: asymmetric STE fake-quant, STE word encoding, the
        write-time string layout and the string physics
        (`kernels/mcam_episode.py`: the dense search kernel forward and the
        episodic backward kernel on the card, autograd through the plain
        version on the CPU).

        Given the same embeddings and range, the votes and dist equal
        `search(mode="full")` on a store programmed with the same supports,
        bit for bit: noiseless, and noisy when `key` is None (the noise
        then has the serving coordinates). A key (int or integer array) is
        folded into a leading noise-stream coordinate (`noise_stream`):
        fresh noise a training step.

        q_emb (B, dim), s_emb (N, dim); rng_range: an explicit (lo, hi),
        e.g. a store's calibrated range; noisy overrides cfg.noisy.
        Returns {votes (B, N), dist (B, N), iterations}."""
        cfg = self.cfg
        q, s, weights, thresholds = self.episode_grids(
            q_emb, s_emb, clip_std=clip_std, rng_range=rng_range)
        votes, dist = mcam_episode.episode_physics(
            q, s, weights, thresholds, cfg.mcam,
            noisy=cfg.noisy if noisy is None else noisy,
            stream=noise_stream(key), tau=sa_tau)
        return {"votes": votes, "dist": dist,
                "iterations": self._iterations(q_emb.shape[-1])}

    def episode_grids(self, q_emb: torch.Tensor, s_emb: torch.Tensor, *,
                      clip_std: float = 2.5,
                      rng_range: tuple[torch.Tensor, torch.Tensor] | None
                      = None) -> tuple[torch.Tensor, ...]:
        """The episodic forward's inputs to the physics: straight-through
        string grids q (B, S, sl) and s (N, S, sl) (float, integer cell
        values, differentiable in the embeddings), per-string weights (S,)
        and the sense-amp thresholds."""
        cfg = self.cfg
        enc = cfg.enc
        sl = cfg.mcam.string_len
        if cfg.mode == "avss":
            q, v = quant_lib.quantize_asymmetric(
                q_emb, s_emb, enc.levels, clip_std, 4, rng=rng_range)
        else:
            v, _, rng = quant_lib.fake_quant(
                s_emb, quant_lib.QuantSpec(enc.levels, clip_std), rng_range)
            q, _, _ = quant_lib.fake_quant(
                q_emb, quant_lib.QuantSpec(enc.levels, clip_std), rng)
        s_grid = avss_lib.layout_support_words(
            enc_lib.encode_words_ste(v, enc), sl)          # (N, seg, L, sl)
        if cfg.mode == "avss":
            q_grid = avss_lib.layout_query(q, enc, "avss", sl)
        else:
            q_grid = avss_lib.layout_support_words(
                enc_lib.encode_words_ste(q, enc), sl)
        seg, L = s_grid.shape[1], s_grid.shape[2]
        dev = s_grid.device
        return (kernel_ops.flatten_strings(
                    kernel_ops.broadcast_query(q_grid, L)),
                kernel_ops.flatten_strings(s_grid),
                enc.weights_array(device=dev).repeat(seg),
                torch.as_tensor(cfg.mcam.thresholds(), device=dev))

    def episode_scores(self, q_emb: torch.Tensor, s_emb: torch.Tensor,
                       s_labels: torch.Tensor, n_classes: int, *,
                       clip_std: float = 2.5, sa_tau: float = 0.02,
                       key=None, noisy: bool | None = None,
                       rng_range: tuple[torch.Tensor, torch.Tensor] | None
                       = None) -> torch.Tensor:
        """Per-class episodic logits (B, n_classes): `episode_votes`
        aggregated by `avss.class_mean_votes`, the head HAT's loss trains
        and the served evaluation reuses."""
        votes = self.episode_votes(
            q_emb, s_emb, clip_std=clip_std, sa_tau=sa_tau, key=key,
            noisy=noisy, rng_range=rng_range)["votes"]
        return avss_lib.class_mean_votes(votes, s_labels.to(votes.device),
                                         n_classes)

    def _search_unsharded(self, store: MemoryStore, q: torch.Tensor,
                          req: SearchRequest,
                          noise_qidx: torch.Tensor | None = None
                          ) -> SearchResult:
        """The unsharded search body: `self` already carries the request's
        backend and noisy overrides, `q` is already quantized."""
        valid = store.valid
        iters = self._iterations(q.shape[-1])
        if req.mode == "full":
            res = self.full(q, store.values, s_grid=store.s_grid,
                            noise_qidx=noise_qidx)
            with _build.profiler_range(LABELS_TAG):
                votes = torch.where(valid[None, :], res["votes"],
                                    float("-inf"))
                indices = torch.arange(store.capacity, device=store.device
                                       ).expand(votes.shape)
                labels = store.labels.expand(votes.shape)
            return SearchResult(votes, res["dist"], indices, labels,
                                res["iterations"])
        if req.mode == "two_phase":
            res = self.two_phase(q, store.values, k=req.k, valid=valid,
                                 s_grid=store.s_grid, proj=store.proj,
                                 packed=store.proj_packed,
                                 pack_bits=store.pack_bits,
                                 fused_min_rows=self._fused_threshold(req),
                                 noise_qidx=noise_qidx)
            with _build.profiler_range(LABELS_TAG):
                labels = store.labels[res["indices"]]
                votes = torch.where(labels >= 0, res["votes"],
                                    float("-inf"))
            return SearchResult(votes, res["dist"], res["indices"], labels,
                                res["iterations"])
        # ideal: phase 1 alone, votes -dist
        dist, idx = self.shortlist(q, store.values, req.k, valid=valid,
                                   proj=store.proj, packed=store.proj_packed,
                                   pack_bits=store.pack_bits,
                                   fused_min_rows=self._fused_threshold(req))
        with _build.profiler_range(LABELS_TAG):
            labels = store.labels[idx]
            votes = torch.where(labels >= 0, -dist, float("-inf"))
        return SearchResult(votes, dist, idx, labels, iters)

    # -- helpers -----------------------------------------------------------

    def _grids(self, q_values: torch.Tensor, s_values: torch.Tensor,
               s_grid: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
        cfg = self.cfg
        enc = cfg.enc
        sl = cfg.mcam.string_len
        with _build.profiler_range(GRIDS_TAG):
            if s_grid is None:
                s_grid = avss_lib.layout_support(s_values, enc, sl)
            q_grid = avss_lib.layout_query(q_values, enc, cfg.mode, sl)
            dev = s_grid.device
            return (q_grid, s_grid, enc.weights_array(device=dev),
                    torch.as_tensor(cfg.mcam.thresholds(), device=dev))

    def _iterations(self, d: int) -> int:
        cfg = self.cfg
        return avss_lib.search_iterations(d, cfg.enc, cfg.mode,
                                          cfg.mcam.string_len)

    # -- full exact search -------------------------------------------------

    def full(self, q_values: torch.Tensor, s_values: torch.Tensor, *,
             s_grid: torch.Tensor | None = None,
             noise_qidx: torch.Tensor | None = None) -> dict[str, Any]:
        """Exact noisy MCAM search of every store row -> {votes (B, N),
        dist (B, N), iterations}. noise_qidx: optional (B,) per-query noise
        coordinates (default arange(B))."""
        cfg = self.cfg
        q_grid, s_grid, weights, thresholds = self._grids(q_values, s_values,
                                                          s_grid)
        dev = s_grid.device
        if noise_qidx is None:
            noise_qidx = torch.arange(q_grid.shape[0], device=dev)
        if self.resolved_backend == "ref":
            per_query = [avss_lib._search_one_query(
                q_grid[b], s_grid, noise_qidx[b], weights, cfg, thresholds)
                for b in range(q_grid.shape[0])]
            votes = torch.stack([v for v, _ in per_query]) if per_query \
                else torch.zeros(0, s_grid.shape[0], device=dev)
            dist = torch.stack([d for _, d in per_query]) if per_query \
                else torch.zeros(0, s_grid.shape[0], device=dev)
        else:  # pallas / mxu / fused: the dense string-search kernel
            votes, dist = kernel_ops.mcam_search(
                q_grid, s_grid, weights, cfg, thresholds, qidx=noise_qidx)
        return {"votes": votes, "dist": dist,
                "iterations": self._iterations(q_values.shape[-1])}

    # -- phase-1 shortlist -------------------------------------------------

    def shortlist(self, q_values: torch.Tensor, s_values: torch.Tensor,
                  k: int, valid: torch.Tensor | None = None,
                  proj: torch.Tensor | None = None,
                  packed: torch.Tensor | None = None,
                  pack_bits: int | None = None,
                  fused_min_rows: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """Top-k supports by ideal digital AVSS distance -> (dist (B, k),
        rows (B, k)), ascending by (distance, row), ties included.

        The fused kernel engages by `_use_fused` (on 'fused', and on any
        kernel backend once N reaches `fused_min_rows`); below it 'pallas'
        / 'mxu' take the LUT product kernel and 'ref' the plain LUT gather,
        each followed by the exact key selection."""
        cfg = self.cfg
        if cfg.mode != "avss":
            raise ValueError("shortlists use the AVSS LUT (mode='avss')")
        n = s_values.shape[0]
        k = min(k, n)
        backend = self.resolved_backend
        if fused_min_rows is None:
            fused_min_rows = self.fused_min_rows
        if _use_fused(backend, n, fused_min_rows):
            return kernel_ops.lut_shortlist(q_values, s_values, cfg.enc, k,
                                            valid=valid, proj=proj,
                                            packed=packed,
                                            pack_bits=pack_bits)
        if backend == "ref":
            lut = torch.as_tensor(enc_lib.avss_sum_lut(cfg.enc))
            dist = ref_kernels.avss_dist_ref(q_values, s_values, lut)
        else:  # pallas / mxu: the LUT product kernel
            dist = kernel_ops.avss_ideal_dist(q_values, s_values, cfg.enc,
                                              proj=proj)
        if valid is not None:
            dist = dist + torch.where(
                valid, 0.0, kernel_ops.SHORTLIST_MASK_PENALTY)[None]
        return shortlist_kernel.select_topk(dist, k)

    # -- two-phase search --------------------------------------------------

    def two_phase(self, q_values: torch.Tensor, s_values: torch.Tensor,
                  k: int = 64, valid: torch.Tensor | None = None, *,
                  s_grid: torch.Tensor | None = None,
                  proj: torch.Tensor | None = None,
                  packed: torch.Tensor | None = None,
                  pack_bits: int | None = None,
                  fused_min_rows: int | None = None,
                  noise_qidx: torch.Tensor | None = None) -> dict[str, Any]:
        """Shortlist + exact noisy rescore -> {votes (B, k), dist (B, k),
        indices (B, k), iterations}. Votes equal `full`'s for every
        shortlisted row."""
        dist, idx = self.shortlist(q_values, s_values, k, valid=valid,
                                   proj=proj, packed=packed,
                                   pack_bits=pack_bits,
                                   fused_min_rows=fused_min_rows)
        q_grid, s_grid, weights, thresholds = self._grids(q_values, s_values,
                                                          s_grid)
        if self.resolved_backend == "ref":
            votes = kernel_ops.rescore_shortlist_plain(
                q_grid, s_grid, idx, weights, self.cfg, thresholds,
                noise_qidx=noise_qidx)
        else:
            votes = kernel_ops.rescore_shortlist(
                q_grid, s_grid, idx, weights, self.cfg, thresholds,
                noise_qidx=noise_qidx)
        return {"votes": votes, "dist": dist, "indices": idx,
                "iterations": self._iterations(q_values.shape[-1])}

    # -- sharded two-phase search ------------------------------------------

    def sharded_two_phase(self, q_values: torch.Tensor, s_values, mesh,
                          axes=("data",), k: int = 64,
                          valid=None) -> dict[str, Any]:
        """Two-phase search with the supports row-sharded over `axes` of
        `mesh` (a tensor is split into the shards' blocks here), bit-
        identical to `two_phase`: each shard shortlists its rows (the
        fused kernel at and above the engine's `fused_min_rows`), rescores
        its candidates with global rows as noise coordinates, and the
        candidates merge by (distance, global row) (engine/sharded.py)."""
        return sharded_lib.sharded_two_phase_search(
            q_values, s_values, self.cfg, mesh, axes=axes, k=k, valid=valid,
            backend=self.resolved_backend,
            fused_min_rows=self.fused_min_rows)
