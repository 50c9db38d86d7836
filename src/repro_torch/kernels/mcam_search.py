"""Noisy MCAM string search (port of `repro.kernels.mcam_search`, plus the
gathered-candidate twin that replaces the jnp math of
`repro.kernels.ops.rescore_shortlist`).

For query b, support row n (its noise row r, = n unless given), string s
of S and cell of sl, see `kernels/ref.py` for the semantics. Two entries:

  mcam_search   dense: q (B, S, sl) x s (N, S, sl) -> votes, dist (B, N)
  mcam_rescore  gathered: candidate rows (B, k) of s, their noise rows and
                per-query noise coordinates -> votes (B, k)

Both run the same per-pair arithmetic, so the votes of a row are the same
whichever entry scored it. The CUDA kernels are in `csrc/mcam_search.cu`;
`*_plain` are their plain versions, which sum each string's cell
resistances in cell order, as the kernel does.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import mcam as mcam_lib
from repro_torch.core.encodings import MAX_MISMATCH
from repro_torch.core.mcam import MCAMConfig, f32
from repro_torch.kernels import _build
from repro_torch.kernels.ref import READ_SEED_OFFSET

_PLAIN_CELLS = 1 << 26   # cells per plain-version block (bounds its memory)

_P, _I = ctypes.c_void_p, ctypes.c_int
_PHYSICS = [_I, ctypes.c_uint, ctypes.c_float, ctypes.c_float, ctypes.c_float]
_SIGNATURES = {
    "mcam_search_dense": [_P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I,
                          *_PHYSICS, _P],
    "mcam_search_gathered": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I,
                             _I, _I, *_PHYSICS, _P],
}


def _pairs_plain(q: torch.Tensor, s: torch.Tensor, qidx: torch.Tensor,
                 rows: torch.Tensor, weights: torch.Tensor,
                 thresholds: torch.Tensor, cfg: MCAMConfig, noisy: bool
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """q, s (..., S, sl) int8 (broadcasting); qidx, rows int64 broadcastable
    to (...,) -> votes, dist (...,)."""
    S, sl = s.shape[-2:]
    m = torch.abs(q.to(torch.int32) - s.to(torch.int32)).to(torch.float32)
    sid = (rows.to(torch.int64)[..., None] * S
           + torch.arange(S, dtype=torch.int64, device=s.device)) & 0xFFFFFFFF
    b = qidx.to(torch.int64)[..., None]
    log_rho = f32(np.log(cfg.rho))
    r = None
    for c in range(sl):
        mc = m[..., c]
        if noisy:
            dev = mcam_lib.hash_normal(b, sid, c, seed=cfg.seed)
            mc = torch.clamp(mc + f32(cfg.sigma_device) * dev, 0.0,
                             float(MAX_MISMATCH))
        e = torch.exp(mc * log_rho)
        r = e if r is None else r + e
    cur = float(sl) / r
    if noisy:
        rd = mcam_lib.hash_normal(b, sid, seed=cfg.seed + READ_SEED_OFFSET)
        cur = cur * (1.0 + f32(cfg.sigma_read) * rd)
    w = weights.to(torch.float32)
    count = (cur[..., None] > thresholds.to(torch.float32)).sum(-1)
    votes = (count.to(torch.float32) * w).sum(-1)
    dist = (m.sum(-1) * w).sum(-1)
    return votes, dist


def mcam_search_plain(q_strings, s_strings, weights, thresholds,
                      cfg: MCAMConfig, *, noisy: bool = True, qidx=None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `mcam_search`, in row blocks of bounded size."""
    B, S, sl = q_strings.shape
    N = s_strings.shape[0]
    dev = s_strings.device
    if qidx is None:
        qidx = torch.arange(B, device=dev)
    step = max(1, _PLAIN_CELLS // max(1, B * S * sl))
    votes, dist = [], []
    for n0 in range(0, N, step):
        s = s_strings[n0:n0 + step]
        rows = torch.arange(n0, n0 + s.shape[0], device=dev)
        v, d = _pairs_plain(q_strings[:, None], s[None], qidx[:, None],
                            rows[None], weights, thresholds, cfg, noisy)
        votes.append(v)
        dist.append(d)
    if not votes:
        empty = torch.zeros(B, 0, dtype=torch.float32, device=dev)
        return empty, empty.clone()
    return torch.cat(votes, 1), torch.cat(dist, 1)


def mcam_rescore_plain(q_strings, s_strings, rows, weights, thresholds,
                       cfg: MCAMConfig, *, noisy: bool = True,
                       noise_rows=None, qidx=None) -> torch.Tensor:
    """Plain version of `mcam_rescore`."""
    B = q_strings.shape[0]
    if noise_rows is None:
        noise_rows = rows
    if qidx is None:
        qidx = torch.arange(B, device=s_strings.device)
    votes, _ = _pairs_plain(q_strings[:, None], s_strings[rows],
                            qidx[:, None], noise_rows, weights, thresholds,
                            cfg, noisy)
    return votes


def _physics_args(cfg: MCAMConfig, noisy: bool) -> list:
    return [ctypes.c_int(int(noisy)), ctypes.c_uint(cfg.seed & 0xFFFFFFFF),
            ctypes.c_float(cfg.sigma_device), ctypes.c_float(cfg.sigma_read),
            ctypes.c_float(f32(np.log(cfg.rho)))]


def _check_strings(name, q_strings, s_strings, weights, thresholds) -> None:
    if q_strings.dtype != torch.int8 or s_strings.dtype != torch.int8:
        raise TypeError(f"{name}: string grids must be int8")
    if q_strings.dim() != 3 or s_strings.dim() != 3 \
            or q_strings.shape[1:] != s_strings.shape[1:]:
        raise ValueError(f"{name}: shapes {tuple(q_strings.shape)} and "
                         f"{tuple(s_strings.shape)}; expected (B, S, sl) and "
                         f"(N, S, sl)")
    if weights.dtype != torch.float32 or weights.shape != (q_strings.shape[1],):
        raise ValueError(f"{name}: weights must be ({q_strings.shape[1]},) "
                         f"float32")
    if thresholds.dtype != torch.float32 or thresholds.dim() != 1:
        raise ValueError(f"{name}: thresholds must be 1-D float32")


def _qidx(qidx, B: int, device) -> torch.Tensor:
    if qidx is None:
        return torch.arange(B, dtype=torch.int64, device=device)
    return qidx.to(device=device, dtype=torch.int64).contiguous()


def mcam_search(q_strings: torch.Tensor, s_strings: torch.Tensor,
                weights: torch.Tensor, thresholds: torch.Tensor,
                cfg: MCAMConfig, *, noisy: bool = True,
                qidx: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """q (B, S, sl) int8, s (N, S, sl) int8, weights (S,) f32 per string,
    thresholds (K,) f32 -> votes (B, N), dist (B, N) float32. qidx: (B,)
    per-query noise coordinates (default arange(B)).

    A CPU tensor runs the plain version; a CUDA tensor launches the dense
    kernel (or raises)."""
    _check_strings("mcam_search", q_strings, s_strings, weights, thresholds)
    if s_strings.device.type == "cpu" and q_strings.device.type == "cpu":
        return mcam_search_plain(q_strings, s_strings, weights, thresholds,
                                 cfg, noisy=noisy, qidx=qidx)
    if s_strings.device.type != "cuda":
        raise ValueError(f"mcam_search: unsupported device "
                         f"{s_strings.device}")
    B, S, sl = q_strings.shape
    N = s_strings.shape[0]
    qi = _qidx(qidx, B, q_strings.device)
    if qi.shape != (B,):
        raise ValueError(f"mcam_search: qidx {tuple(qi.shape)} for B={B}")
    _build.require_cuda("mcam_search", q_strings, s_strings, weights,
                        thresholds, qi)
    votes = torch.empty(B, N, dtype=torch.float32, device=s_strings.device)
    dist = torch.empty_like(votes)
    lib = _build.load("mcam_search", _SIGNATURES)
    err = lib.mcam_search_dense(
        _build.ptr(q_strings), _build.ptr(s_strings), _build.ptr(weights),
        _build.ptr(thresholds), ctypes.c_int(thresholds.shape[0]),
        _build.ptr(qi), _build.ptr(votes), _build.ptr(dist),
        ctypes.c_int(B), ctypes.c_int(N), ctypes.c_int(S), ctypes.c_int(sl),
        *_physics_args(cfg, noisy), _build.stream_ptr(s_strings.device))
    _build.check(lib, err, "mcam_search_dense")
    _build.count_launch("mcam_search")
    return votes, dist


def mcam_rescore(q_strings: torch.Tensor, s_strings: torch.Tensor,
                 rows: torch.Tensor, weights: torch.Tensor,
                 thresholds: torch.Tensor, cfg: MCAMConfig, *,
                 noisy: bool = True, noise_rows: torch.Tensor | None = None,
                 qidx: torch.Tensor | None = None) -> torch.Tensor:
    """Votes of per-query candidate rows: q (B, S, sl) int8, s (N, S, sl)
    int8, rows (B, k) rows of s; noise_rows (B, k) the global rows feeding
    the noise counters (default rows); qidx (B,) query coordinates
    (default arange(B)) -> votes (B, k) float32.

    A CPU tensor runs the plain version; a CUDA tensor launches the
    gathered kernel (or raises)."""
    _check_strings("mcam_rescore", q_strings, s_strings, weights, thresholds)
    if s_strings.device.type == "cpu" and q_strings.device.type == "cpu":
        return mcam_rescore_plain(q_strings, s_strings, rows, weights,
                                  thresholds, cfg, noisy=noisy,
                                  noise_rows=noise_rows, qidx=qidx)
    if s_strings.device.type != "cuda":
        raise ValueError(f"mcam_rescore: unsupported device "
                         f"{s_strings.device}")
    B, S, sl = q_strings.shape
    N = s_strings.shape[0]
    if rows.dim() != 2 or rows.shape[0] != B:
        raise ValueError(f"mcam_rescore: rows {tuple(rows.shape)} for B={B}")
    K = rows.shape[1]
    r = rows.to(torch.int64).contiguous()
    nr = r if noise_rows is None else \
        noise_rows.to(torch.int64).contiguous()
    if nr.shape != r.shape:
        raise ValueError(f"mcam_rescore: noise_rows {tuple(nr.shape)} vs "
                         f"rows {tuple(r.shape)}")
    qi = _qidx(qidx, B, q_strings.device)
    if qi.shape != (B,):
        raise ValueError(f"mcam_rescore: qidx {tuple(qi.shape)} for B={B}")
    _build.require_cuda("mcam_rescore", q_strings, s_strings, r, nr,
                        weights, thresholds, qi)
    votes = torch.empty(B, K, dtype=torch.float32, device=s_strings.device)
    lib = _build.load("mcam_search", _SIGNATURES)
    err = lib.mcam_search_gathered(
        _build.ptr(q_strings), _build.ptr(s_strings), _build.ptr(r),
        _build.ptr(nr), _build.ptr(weights), _build.ptr(thresholds),
        ctypes.c_int(thresholds.shape[0]), _build.ptr(qi), _build.ptr(votes),
        ctypes.c_int(B), ctypes.c_int(K), ctypes.c_int(N), ctypes.c_int(S),
        ctypes.c_int(sl), *_physics_args(cfg, noisy),
        _build.stream_ptr(s_strings.device))
    _build.check(lib, err, "mcam_search_gathered")
    _build.count_launch("mcam_rescore")
    return votes
