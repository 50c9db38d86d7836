"""Wrappers around the MCAM kernels: layout, projection, packing, dispatch
(port of `repro.kernels.ops`).

  mcam_search(q_grid, s_grid, weights, cfg, thresholds)
      exact noisy search of every store row (csrc/mcam_search.cu, dense).
  avss_ideal_dist(q_values, s_values, enc)
      ideal AVSS distance matrix through the LUT product (csrc/mcam_dist.cu).
  rescore_shortlist(q_grid, s_grid, short_idx, weights, cfg, thresholds)
      exact noisy votes of per-query candidates (csrc/mcam_search.cu,
      gathered): phase 2 of two_phase, with no (B, k, S, sl) intermediates.
  lut_shortlist(q_values, s_values, enc, k)
      fused ideal distance + exact top-k (csrc/shortlist.cu).
  two_phase_search(q_values, s_values, cfg, k)
      the historical two-phase API over raw words: an anonymous store
      searched by RetrievalEngine on the `mxu` backend.

No counterpart, by design: `mcam_search_tile_b` / `mcam_search_tile_n`,
the Pallas string search's tile sizes.
"""

from __future__ import annotations

import torch

from repro_torch.core import encodings as enc_lib
from repro_torch.core.encodings import Encoding
from repro_torch.kernels import _build
from repro_torch.kernels import mcam_dist
from repro_torch.kernels import mcam_search as mcam_search_kernel
from repro_torch.kernels import shortlist as shortlist_kernel
from repro_torch.kernels.shortlist import SHORTLIST_MASK_PENALTY  # noqa: F401

#: profiler ranges (`_build.profiler_range`) of the physics entries: phase
#: 2's rescore (its string operands and the gathered launch, on every
#: route) and the dense entry (its operands and launch)
RESCORE_TAG = "kernels.rescore"
DENSE_TAG = "kernels.dense"


def flatten_strings(grid: torch.Tensor) -> torch.Tensor:
    """(X, seg, L, sl) -> (X, seg*L, sl)."""
    x, seg, L, sl = grid.shape
    return grid.reshape(x, seg * L, sl)


def broadcast_query(q_grid: torch.Tensor, L: int) -> torch.Tensor:
    """(B, seg, Lq, sl) -> (B, seg, L, sl); AVSS queries have Lq == 1."""
    if q_grid.shape[2] == L:
        return q_grid
    if q_grid.shape[2] != 1:
        raise ValueError(f"query grid has {q_grid.shape[2]} words per "
                         f"segment; expected 1 or {L}")
    return q_grid.expand(q_grid.shape[0], q_grid.shape[1], L,
                         q_grid.shape[3])


def _string_weights(weights: torch.Tensor, seg: int,
                    device) -> torch.Tensor:
    """(L,) per-word weights -> (seg*L,) per-string float32 weights."""
    return weights.to(device=device, dtype=torch.float32).repeat(seg)


def mcam_search(q_grid: torch.Tensor, s_grid: torch.Tensor,
                weights: torch.Tensor, cfg, thresholds: torch.Tensor,
                qidx: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact noisy search of q_grid (B, seg, Lq, sl) against every row of
    s_grid (N, seg, L, sl) -> votes, dist (B, N). qidx: optional (B,)
    per-query noise coordinates (default arange(B)). cfg: SearchConfig."""
    seg, L = s_grid.shape[1], s_grid.shape[2]
    dev = s_grid.device
    with _build.profiler_range(DENSE_TAG):
        q = flatten_strings(broadcast_query(q_grid, L)).to(
            torch.int8).contiguous()
        s = flatten_strings(s_grid).to(torch.int8).contiguous()
        return mcam_search_kernel.mcam_search(
            q, s, _string_weights(weights, seg, dev),
            thresholds.to(device=dev, dtype=torch.float32).contiguous(),
            cfg.mcam, noisy=cfg.noisy, qidx=qidx)


# ---------------------------------------------------------------------------
# LUT path.
# ---------------------------------------------------------------------------


def support_projection(s_values: torch.Tensor, enc: Encoding,
                       dtype=torch.bfloat16) -> torch.Tensor:
    """(N, d) int values -> (N, 4*d) LUT projection, column 4 d + q holding
    LUT[q, v[n, d]]. bf16 is exact for LUT entries < 256 (MTMC with
    CL <= 85); pass dtype=torch.float32 for long weighted encodings."""
    lut = torch.as_tensor(enc_lib.avss_sum_lut(enc), device=s_values.device)
    proj = lut.T[s_values.to(torch.int64)]               # (N, d, 4)
    return proj.reshape(s_values.shape[0], -1).to(dtype)


def projection_pack_bits(enc: Encoding, dtype=torch.bfloat16) -> int:
    """Field width (4/8/16/32 bits) of the packed projection for `enc`:
    the smallest that holds every LUT entry as stored in a `dtype`
    projection (bf16 rounds entries >= 256)."""
    lut = torch.as_tensor(enc_lib.avss_sum_lut(enc))
    m = float(lut.to(dtype).to(torch.float32).max())
    for bits in (4, 8, 16):
        if m < (1 << bits):
            return bits
    return 32


def pack_projection(proj: torch.Tensor, enc: Encoding) -> torch.Tensor:
    """(N, C) integer-valued LUT projection -> (N, ceil(C/wpi)) int32, with
    wpi = 32 / projection_pack_bits(enc, proj.dtype) fields per word:
    column m of the packed word holds projection columns {w*dp + m}.

    The fields are packed in int64 and wrapped to int32 explicitly: with
    4-bit fields the top field reaches bit 31 and the word is negative, as
    the reference's modular int32 sum makes it."""
    bits = projection_pack_bits(enc, proj.dtype)
    wpi = 32 // bits
    p = proj.to(torch.int64)
    n, c = p.shape
    dp = -(-c // wpi)
    if c != dp * wpi:
        p = torch.nn.functional.pad(p, (0, dp * wpi - c))
    parts = p.reshape(n, wpi, dp)
    shifts = (torch.arange(wpi, dtype=torch.int64, device=p.device)
              * bits)[None, :, None]
    words = (parts << shifts).sum(dim=1) & 0xFFFFFFFF
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def query_onehot(q_values: torch.Tensor, dtype=torch.bfloat16
                 ) -> torch.Tensor:
    """(B, d) ints in [0, 4) -> (B, 4*d) one-hot."""
    oh = torch.nn.functional.one_hot(q_values.to(torch.int64),
                                     enc_lib.CELL_STATES)
    return oh.reshape(q_values.shape[0], -1).to(dtype)


def avss_ideal_dist(q_values: torch.Tensor, s_values: torch.Tensor,
                    enc: Encoding, dtype=torch.bfloat16,
                    proj: torch.Tensor | None = None) -> torch.Tensor:
    """(B, N) exact ideal AVSS distances through the LUT product kernel.
    proj: the write-time projection (MemoryStore.proj), identical to
    recomputing it from s_values."""
    sp = support_projection(s_values, enc, dtype) if proj is None \
        else proj.to(dtype)
    q1h = query_onehot(q_values, dtype).to(sp.device)
    return mcam_dist.lut_dist_matmul(q1h.contiguous(), sp.contiguous())


# ---------------------------------------------------------------------------
# Two-phase search: shortlist + exact rescore.
# ---------------------------------------------------------------------------


def rescore_shortlist(q_grid: torch.Tensor, s_grid: torch.Tensor,
                      short_idx: torch.Tensor, weights: torch.Tensor,
                      cfg, thresholds: torch.Tensor, *,
                      noise_idx: torch.Tensor | None = None,
                      noise_qidx: torch.Tensor | None = None,
                      with_dist: bool = False):
    """Exact noisy votes for per-query shortlists: q_grid (B, seg, Lq, sl),
    s_grid (N, seg, L, sl), short_idx (B, K) rows of s_grid -> votes
    (B, K). noise_idx (B, K): the global row of each candidate for the
    noise counters (default short_idx); noise_qidx (B,): each query's
    noise coordinate (default arange(B)). Votes equal `mcam_search`'s for
    the same (query, global row); with `with_dist`, (votes, dist), dist
    as `mcam_search` gives it (a tenant's `full`)."""
    with _build.profiler_range(RESCORE_TAG):
        return mcam_search_kernel.mcam_rescore(
            *_rescore_args(q_grid, s_grid, short_idx, weights, thresholds),
            cfg.mcam, noisy=cfg.noisy, noise_rows=noise_idx,
            qidx=noise_qidx, with_dist=with_dist)


def rescore_shortlist_plain(q_grid: torch.Tensor, s_grid: torch.Tensor,
                            short_idx: torch.Tensor, weights: torch.Tensor,
                            cfg, thresholds: torch.Tensor, *,
                            noise_idx: torch.Tensor | None = None,
                            noise_qidx: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """`rescore_shortlist` through the kernel's plain version on any
    device (the `ref` backend's phase 2)."""
    with _build.profiler_range(RESCORE_TAG):
        return mcam_search_kernel.mcam_rescore_plain(
            *_rescore_args(q_grid, s_grid, short_idx, weights, thresholds),
            cfg.mcam, noisy=cfg.noisy, noise_rows=noise_idx,
            qidx=noise_qidx)


def _rescore_args(q_grid, s_grid, short_idx, weights, thresholds) -> tuple:
    """(q strings, s strings, rows, per-string weights, thresholds)."""
    seg, L = s_grid.shape[1], s_grid.shape[2]
    dev = s_grid.device
    q = flatten_strings(broadcast_query(q_grid, L)).to(torch.int8).contiguous()
    s = flatten_strings(s_grid).to(torch.int8).contiguous()
    return (q, s, short_idx, _string_weights(weights, seg, dev),
            thresholds.to(device=dev, dtype=torch.float32).contiguous())


def lut_shortlist(q_values: torch.Tensor, s_values: torch.Tensor | None,
                  enc: Encoding, k: int, dtype=torch.bfloat16,
                  valid: torch.Tensor | None = None,
                  proj: torch.Tensor | None = None,
                  packed: torch.Tensor | None = None,
                  pack_bits: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused shortlist: (B, k) distances + rows without a (B, N) distance
    matrix (csrc/shortlist.cu). valid: optional (N,) bool row mask. proj:
    the write-time projection; packed / pack_bits: its bit-packed form,
    streamed instead of it when given (pack_bits is the width `packed` was
    packed with)."""
    if packed is not None:
        bits = pack_bits if pack_bits is not None else projection_pack_bits(
            enc, proj.dtype if proj is not None else dtype)
        return shortlist_kernel.lut_shortlist(q_values, None, k, valid=valid,
                                              packed=packed, pack_bits=bits)
    sp = support_projection(s_values, enc, dtype) if proj is None \
        else proj.to(dtype)
    return shortlist_kernel.lut_shortlist(q_values, sp.contiguous(), k,
                                          valid=valid)


def two_phase_search(q_values: torch.Tensor, s_values: torch.Tensor, cfg,
                     k: int = 64) -> dict[str, torch.Tensor]:
    """Shortlist + exact noisy rescore of raw words, the historical API.
    cfg: a `core.avss.SearchConfig` (avss). The supports are programmed
    into an anonymous `MemoryStore` (labels 0) on `s_values`' device and
    searched through `RetrievalEngine.search` on the `mxu` backend: on a
    CUDA tensor phase 1 launches csrc/mcam_dist.cu (csrc/shortlist.cu from
    `fused_min_rows` rows on) and phase 2 the gathered entry of
    csrc/mcam_search.cu; on a CPU tensor their plain versions run.
    Returns {votes, dist, indices (B, min(k, N)), iterations}."""
    from repro_torch.engine import MemoryStore, RetrievalEngine, SearchRequest
    s = torch.as_tensor(s_values)
    store = MemoryStore.from_quantized(
        s, torch.zeros(s.shape[0], dtype=torch.int32), cfg, device=s.device)
    res = RetrievalEngine(cfg, backend="mxu").search(
        store, q_values, SearchRequest(mode="two_phase", k=k))
    return {"votes": res.votes, "dist": res.dist, "indices": res.indices,
            "iterations": res.iterations}
