"""Symmetric (SVSS) and Asymmetric (AVSS) vector similarity search on MCAM
(PyTorch port of `repro.core.avss`).

A support vector with d dimensions, encoded into L code words per
dimension, occupies a (n_seg, L) grid of NAND strings, n_seg =
ceil(d / string_len); string (seg, c) holds the c-th code word of the
`string_len` dimensions of segment seg. AVSS keeps one 4-level query word
per dimension, shared by the L strings of a segment: n_seg word-line
iterations per query instead of SVSS's n_seg * L.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.core import mcam as mcam_lib
from repro_torch.core.encodings import Encoding, make_encoding
from repro_torch.core.mcam import MCAMConfig

Mode = str  # 'svss' | 'avss'


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """End-to-end VSS configuration (same fields as the JAX package)."""

    encoding: str = "mtmc"
    cl: int = 8
    mode: Mode = "avss"
    mcam: MCAMConfig = dataclasses.field(default_factory=MCAMConfig)
    noisy: bool = True          # device/read noise on (paper-faithful)
    use_kernel: str = "auto"    # 'ref' | 'pallas' | 'mxu' | 'fused' | 'auto'
    query_chunk: int = 8        # reference-path chunking over queries

    @property
    def enc(self) -> Encoding:
        return make_encoding(self.encoding, self.cl)


def n_segments(d: int, string_len: int = mcam_lib.DEFAULT_STRING_LEN) -> int:
    return math.ceil(d / string_len)


def search_iterations(d: int, enc: Encoding, mode: Mode,
                      string_len: int = mcam_lib.DEFAULT_STRING_LEN) -> int:
    """Word-line cycles per query (paper Sec. 3.2)."""
    seg = n_segments(d, string_len)
    return seg if mode == "avss" else seg * enc.length


def strings_per_support(d: int, enc: Encoding,
                        string_len: int = mcam_lib.DEFAULT_STRING_LEN) -> int:
    return n_segments(d, string_len) * enc.length


# ---------------------------------------------------------------------------
# Layout helpers.
# ---------------------------------------------------------------------------


def _segment_dims(x: torch.Tensor, string_len: int) -> torch.Tensor:
    """(..., d) -> (..., n_seg, string_len), zero-padded."""
    d = x.shape[-1]
    seg = n_segments(d, string_len)
    pad = seg * string_len - d
    if pad:
        x = F.pad(x, (0, pad))
    return x.reshape(*x.shape[:-1], seg, string_len)


def layout_support_words(words: torch.Tensor,
                         string_len: int = mcam_lib.DEFAULT_STRING_LEN
                         ) -> torch.Tensor:
    """Code words (..., d, L) -> string grid (..., n_seg, L, string_len)."""
    codes = torch.movedim(words, -1, -2)         # (..., L, d)
    codes = _segment_dims(codes, string_len)     # (..., L, seg, sl)
    return torch.movedim(codes, -3, -2)          # (..., seg, L, sl)


def layout_support(values: torch.Tensor, enc: Encoding,
                   string_len: int = mcam_lib.DEFAULT_STRING_LEN
                   ) -> torch.Tensor:
    """Quantized support values (N, d) -> string grid (N, n_seg, L,
    string_len). Padding dimensions store code 0 (zero mismatch against
    query word 0). Write-time work: `MemoryStore.write` runs it once."""
    return layout_support_words(enc.encode(values), string_len)


def layout_query(values: torch.Tensor, enc: Encoding, mode: Mode,
                 string_len: int = mcam_lib.DEFAULT_STRING_LEN
                 ) -> torch.Tensor:
    """Quantized query (B, d) -> word-line grid (B, n_seg, L_q, string_len);
    AVSS: L_q == 1, SVSS: L_q == enc.length."""
    if mode == "avss":
        return _segment_dims(values, string_len)[..., :, None, :]
    return layout_support(values, enc, string_len)


# ---------------------------------------------------------------------------
# Reference search (plain torch).
# ---------------------------------------------------------------------------


def _string_ids(n: int, seg: int, L: int,
                device: torch.device | str | None = None) -> torch.Tensor:
    """(N, seg, L) absolute string ids (int64 holding uint32): the
    noise-counter coordinates shared by the reference search and the
    rescore path."""
    ids = (torch.arange(n, dtype=torch.int64, device=device)[:, None, None]
           * (seg * L)
           + torch.arange(seg, dtype=torch.int64, device=device)[None, :, None]
           * L
           + torch.arange(L, dtype=torch.int64, device=device)[None, None, :])
    return ids & 0xFFFFFFFF


def votes_from_mismatch(mm: torch.Tensor, qidx, weights: torch.Tensor,
                        cfg: SearchConfig, thresholds: torch.Tensor, *,
                        noisy: bool | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The mismatch-grid -> (votes, dist) forward of the reference.

    mm: (..., N, seg, L, sl) per-cell mismatch levels (float). qidx:
    integer query coordinates broadcastable to mm.shape[:-1]. noisy
    overrides cfg.noisy when not None. The training-side arguments of the
    JAX function (noise_stream, step_fn) wait for the HAT slice."""
    n, seg, L, sl = mm.shape[-4:]
    if noisy is None:
        noisy = cfg.noisy
    if noisy:
        coords = (qidx, _string_ids(n, seg, L, mm.device))
        cur = mcam_lib.string_current(mm, cfg.mcam, noise_idx=coords)
    else:
        cur = mcam_lib.string_current(mm, cfg.mcam)
    votes = mcam_lib.sa_votes(cur, cfg.mcam, thresholds)
    w = weights.to(mm.device)[None, None, :]
    votes = (votes * w).sum((-1, -2))
    dist = (mm.sum(-1) * w).sum((-1, -2))
    return votes, dist


def _search_one_query(q_grid: torch.Tensor, s_grid: torch.Tensor, qidx,
                      weights: torch.Tensor, cfg: SearchConfig,
                      thresholds: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """q_grid (seg, Lq, sl); s_grid (N, seg, L, sl) -> votes (N,), dist (N,)."""
    mm = torch.abs(q_grid[None].to(torch.int32) - s_grid.to(torch.int32))
    return votes_from_mismatch(mm.to(torch.float32), qidx, weights, cfg,
                               thresholds)


# ---------------------------------------------------------------------------
# Prediction heads.
# ---------------------------------------------------------------------------


def best_support(result: dict[str, torch.Tensor]) -> torch.Tensor:
    """Argmax by (votes desc, ideal distance asc, index asc). `argmin`
    returns the first minimum, which is the index tie-break."""
    votes, dist = result["votes"], result["dist"]
    top = votes.max(dim=-1, keepdim=True).values
    return torch.argmin(torch.where(votes == top, dist,
                                    torch.full_like(dist, float("inf"))),
                        dim=-1)


def predict_1nn(result: dict[str, torch.Tensor],
                labels: torch.Tensor) -> torch.Tensor:
    """Label of the most-similar support (the paper's retrieval rule)."""
    return labels[best_support(result)]
