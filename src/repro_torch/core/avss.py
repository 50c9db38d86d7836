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
from repro_torch.kernels import _build

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


#: the profiler range around `layout_support`
LAYOUT_TAG = "layout_support"


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
    query word 0). Write-time work: `MemoryStore.write` runs it once. The
    profiler range LAYOUT_TAG (the reference's `jax.named_scope`), open
    while a trace or a profiler records, shows where a search lays
    supports out at read time (analysis/contracts.py)."""
    with _build.profiler_range(LAYOUT_TAG):
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
                        noisy: bool | None = None, noise_stream=None,
                        step_fn=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The mismatch-grid -> (votes, dist) forward of the reference.

    mm: (..., N, seg, L, sl) per-cell mismatch levels (float). qidx:
    integer query coordinates broadcastable to mm.shape[:-1]. noisy
    overrides cfg.noisy when not None. noise_stream: an optional leading
    noise coordinate (a uint32 value; None gives the serving noise).
    step_fn: a differentiable sense-amp step (`mcam.ste_step`), forward
    equal to the hard comparison."""
    n, seg, L, sl = mm.shape[-4:]
    if noisy is None:
        noisy = cfg.noisy
    if noisy:
        coords = (qidx, _string_ids(n, seg, L, mm.device))
        if noise_stream is not None:
            coords = (noise_stream,) + coords
        cur = mcam_lib.string_current(mm, cfg.mcam, noise_idx=coords)
    else:
        cur = mcam_lib.string_current(mm, cfg.mcam)
    votes = mcam_lib.sa_votes(cur, cfg.mcam, thresholds, step_fn=step_fn)
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


def score_supports(result: dict[str, torch.Tensor]) -> torch.Tensor:
    """Votes with an infinitesimal ideal-distance tie-break, (B, N): for
    class-vote sums only (the 1e-6 falls below an f32 ulp once votes
    reach ~16; rank with `best_support`)."""
    return result["votes"] - 1e-6 * result["dist"]


def _onehot(labels: torch.Tensor, n_classes: int,
            dtype: torch.dtype) -> torch.Tensor:
    return F.one_hot(labels.to(torch.int64), n_classes).to(dtype)


def class_scores(result: dict[str, torch.Tensor], labels: torch.Tensor,
                 n_classes: int) -> torch.Tensor:
    """Per-class vote sums (B, n_classes) with distance tie-breaking."""
    scores = score_supports(result)
    return scores @ _onehot(labels, n_classes, scores.dtype)


def class_mean_votes(votes: torch.Tensor, labels: torch.Tensor,
                     n_classes: int) -> torch.Tensor:
    """Mean vote score per class (B, n_classes): HAT's episodic logits and
    the served evaluation's head, so the two agree exactly when the votes
    do. The division is tensor by tensor and rounds once, as JAX's."""
    onehot = _onehot(labels, n_classes, votes.dtype)
    counts = onehot.sum(0) + 1e-8
    return torch.div(votes @ onehot, counts)


def predict_class_vote(result: dict[str, torch.Tensor], labels: torch.Tensor,
                       n_classes: int) -> torch.Tensor:
    return torch.argmax(class_scores(result, labels, n_classes), dim=-1)


def accuracy(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred == target.to(pred.device)).to(torch.float32).mean()
