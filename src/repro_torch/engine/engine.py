"""The RetrievalEngine: `search(store, queries, SearchRequest) ->
SearchResult` over an unsharded store (port of `repro.engine.engine`).

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

Not ported yet (they raise NotImplementedError): the sharded and routed
searches (`SearchRequest.axes` / `nprobe`) and `search_tenants`.
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
from repro_torch.engine.backends import resolve_backend
from repro_torch.engine.store import MemoryStore, _not_ported
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


def _local_shortlist(q: torch.Tensor, proj: torch.Tensor,
                     valid: torch.Tensor, k: int, *, kernel: bool
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense shortlist of query words q (B, d) against the projection:
    the (B, N) LUT distance matrix (through the `mcam_dist` kernel
    wrapper when `kernel`, else its plain version), the mask penalty, then
    the exact (distance, row) top-k."""
    q1h = kernel_ops.query_onehot(q, proj.dtype).to(proj.device)
    fn = mcam_dist.lut_dist_matmul if kernel \
        else mcam_dist.lut_dist_matmul_plain
    dist = fn(q1h.contiguous(), proj.contiguous())
    dist += torch.where(valid, 0.0,
                        kernel_ops.SHORTLIST_MASK_PENALTY)[None]
    return shortlist_kernel.select_topk(dist, k)


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
        calibrated range) or pre-quantized integer words."""
        req = request if request is not None else SearchRequest()
        if req.nprobe is not None:
            raise _not_ported("SearchRequest.nprobe (routed search)", "A6")
        if req.axes is not None:
            raise _not_ported("SearchRequest.axes (sharded search)", "A9")
        eng = self.with_backend(req.backend).with_noisy(req.noisy)
        q = store.quantize_queries(queries)
        return eng._search_unsharded(store, q, req)

    def search_tenants(self, *args, **kwargs) -> SearchResult:
        raise _not_ported("RetrievalEngine.search_tenants", "A7")

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
            labels = store.labels[res["indices"]]
            votes = torch.where(labels >= 0, res["votes"], float("-inf"))
            return SearchResult(votes, res["dist"], res["indices"], labels,
                                res["iterations"])
        # ideal: top-k by the exact digital distance against the write-time
        # projection, masked rows carrying the mask penalty
        k = min(req.k, store.capacity)
        backend = self.resolved_backend
        if backend != "ref" and (store.capacity >= self._fused_threshold(req)
                                 or backend == "fused"):
            dist, idx = kernel_ops.lut_shortlist(
                q, store.values, self.cfg.enc, k, valid=valid,
                proj=store.proj, packed=store.proj_packed,
                pack_bits=store.pack_bits)
        else:
            dist, idx = _local_shortlist(q, store.proj, valid, k,
                                         kernel=backend != "ref")
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

        The fused kernel engages on 'fused', and on any kernel backend once
        N reaches `fused_min_rows`; below it 'pallas' / 'mxu' take the LUT
        product kernel and 'ref' the plain LUT gather, each followed by
        the exact key selection."""
        cfg = self.cfg
        if cfg.mode != "avss":
            raise ValueError("shortlists use the AVSS LUT (mode='avss')")
        n = s_values.shape[0]
        k = min(k, n)
        backend = self.resolved_backend
        if fused_min_rows is None:
            fused_min_rows = self.fused_min_rows
        if backend == "fused" or (backend != "ref" and n >= fused_min_rows):
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
