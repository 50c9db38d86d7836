"""Noisy MCAM string search (port of `repro.kernels.mcam_search`, plus the
gathered-candidate twin that replaces the jnp math of
`repro.kernels.ops.rescore_shortlist`).

For query b, support row n (its noise row r, = n unless given), string s
of S and cell of sl, see `kernels/ref.py` for the semantics. Two entries:

  mcam_search   dense: q (B, S, sl) x s (N, S, sl) -> votes, dist (B, N),
                optionally with a leading noise-stream coordinate (HAT's
                episodic forward; `kernels/mcam_episode.py`)
  mcam_rescore  gathered: candidate rows (B, k) of s, their noise rows and
                per-query noise coordinates -> votes (B, k)

Both run the same per-pair arithmetic, so the votes of a row are the same
whichever entry scored it. The CUDA kernels are in `csrc/mcam_search.cu`;
`*_plain` are their plain versions, which sum each string's cell
resistances in cell order and divide once, as the kernel does: on the card
the two agree bit for bit. Each entry has a compile-time instance for
strings of `SPECIALISED_SL` cells and a generic one; `search_instance`
picks it by shape.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import kinks
from repro_torch.core import mcam as mcam_lib
from repro_torch.core.encodings import MAX_MISMATCH
from repro_torch.core.mcam import MCAMConfig, f32
from repro_torch.kernels import _build
from repro_torch.kernels.ref import READ_SEED_OFFSET

PLAIN_CELLS = 1 << 26   # cells per plain-version block (bounds its memory)

#: the string length of the kernels' unrolled instance (the main path's:
#: `string_len` 24); csrc/mcam_search.cu SPECIALISED_SL
SPECIALISED_SL = 24

#: what `prove_forms` counts, in the order of csrc/mcam_search.cu
PROVED_FORMS = ("uniform", "angle", "radius", "cos", "byte_float",
                "abs_diff")

_P, _I = ctypes.c_void_p, ctypes.c_int
_PHYSICS = [_I, ctypes.c_uint, ctypes.c_float, ctypes.c_float, ctypes.c_float]
#: the noise-stream arguments of the dense entry: has_stream, stream
STREAM_ARGS = [_I, ctypes.c_uint]
_SIGNATURES = {
    "mcam_search_dense": [_P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I,
                          *_PHYSICS, *STREAM_ARGS, _P],
    "mcam_search_gathered": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I,
                             _I, _I, _I, _I, *_PHYSICS, _P],
    "mcam_search_prove_forms": [_P, _P],
}


def search_instance(sl: int, *grids: torch.Tensor) -> int:
    """The kernel instance for strings of `sl` cells: `SPECIALISED_SL`
    (cells unrolled, a string read as three 8-byte words) when sl is that
    and every grid starts on an 8-byte boundary, else 0 (the generic cell
    loop over byte loads)."""
    if sl == SPECIALISED_SL and all(g.data_ptr() % 8 == 0 for g in grids):
        return SPECIALISED_SL
    return 0


def _pairs_plain(q: torch.Tensor, s: torch.Tensor, qidx: torch.Tensor,
                 rows: torch.Tensor, weights: torch.Tensor,
                 thresholds: torch.Tensor, cfg: MCAMConfig, noisy: bool, *,
                 stream: int | None = None, step_fn=None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """q, s (..., S, sl) int8, or float holding integer cell values
    (broadcasting); qidx, rows int64 broadcastable to (...,) -> votes,
    dist (...,).

    stream: a leading noise coordinate (uint32 value), as HAT's episodic
    forward draws it; None gives the serving noise. step_fn: a
    differentiable sense-amp step (`core.mcam.ste_step`) whose forward is
    the comparison `x > 0`. With float grids that require grad, the
    function is differentiable, and |q - s| and the clip take jax.grad's
    rules at their kinks (core/kinks.py): this is the plain version of the
    episodic backward kernel (kernels/mcam_episode.py)."""
    S, sl = s.shape[-2:]
    m = kinks.abs(q.to(torch.float32) - s.to(torch.float32))
    sid = (rows.to(torch.int64)[..., None] * S
           + torch.arange(S, dtype=torch.int64, device=s.device)) & 0xFFFFFFFF
    b = qidx.to(torch.int64)[..., None]
    coords = (b, sid) if stream is None else (stream, b, sid)
    log_rho = f32(np.log(cfg.rho))
    r = None
    for c in range(sl):
        mc = m[..., c]
        if noisy:
            dev = mcam_lib.hash_normal(*coords, c, seed=cfg.seed)
            mc = kinks.clip(mc + f32(cfg.sigma_device) * dev, 0.0,
                            float(MAX_MISMATCH))
        e = torch.exp(mc * log_rho)
        r = e if r is None else r + e
    cur = torch.div(torch.tensor(float(sl)), r)
    if noisy:
        rd = mcam_lib.hash_normal(*coords, seed=cfg.seed + READ_SEED_OFFSET)
        cur = cur * (1.0 + f32(cfg.sigma_read) * rd)
    w = weights.to(torch.float32)
    th = thresholds.to(torch.float32)
    if step_fn is None:
        count = (cur[..., None] > th).sum(-1).to(torch.float32)
    else:
        count = step_fn(cur[..., None] - th).sum(-1)
    votes = (count * w).sum(-1)
    dist = (m.sum(-1) * w).sum(-1)
    return votes, dist


def mcam_search_plain(q_strings, s_strings, weights, thresholds,
                      cfg: MCAMConfig, *, noisy: bool = True, qidx=None,
                      stream: int | None = None, step_fn=None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `mcam_search`, in row blocks of bounded size
    (`step_fn`: see `_pairs_plain`)."""
    B, S, sl = q_strings.shape
    N = s_strings.shape[0]
    dev = s_strings.device
    if qidx is None:
        qidx = torch.arange(B, device=dev)
    step = max(1, PLAIN_CELLS // max(1, B * S * sl))
    votes, dist = [], []
    for n0 in range(0, N, step):
        s = s_strings[n0:n0 + step]
        rows = torch.arange(n0, n0 + s.shape[0], device=dev)
        v, d = _pairs_plain(q_strings[:, None], s[None], qidx[:, None],
                            rows[None], weights, thresholds, cfg, noisy,
                            stream=stream, step_fn=step_fn)
        votes.append(v)
        dist.append(d)
    if not votes:
        empty = torch.zeros(B, 0, dtype=torch.float32, device=dev)
        return empty, empty.clone()
    return torch.cat(votes, 1), torch.cat(dist, 1)


def mcam_rescore_plain(q_strings, s_strings, rows, weights, thresholds,
                       cfg: MCAMConfig, *, noisy: bool = True,
                       noise_rows=None, qidx=None, with_dist: bool = False):
    """Plain version of `mcam_rescore`, in query blocks of bounded size."""
    B = q_strings.shape[0]
    if noise_rows is None:
        noise_rows = rows
    if qidx is None:
        qidx = torch.arange(B, device=s_strings.device)
    S, sl = s_strings.shape[1:]
    step = max(1, PLAIN_CELLS // max(1, rows.shape[1] * S * sl))
    votes, dist = [], []
    for b0 in range(0, B, step):
        sel = slice(b0, b0 + step)
        v, d = _pairs_plain(q_strings[sel, None], s_strings[rows[sel]],
                            qidx[sel, None], noise_rows[sel], weights,
                            thresholds, cfg, noisy)
        votes.append(v)
        dist.append(d)
    if not votes:
        empty = torch.zeros(0, rows.shape[1], dtype=torch.float32,
                            device=s_strings.device)
        votes, dist = [empty], [empty.clone()]
    if with_dist:
        return torch.cat(votes), torch.cat(dist)
    return torch.cat(votes)


def physics_args(cfg: MCAMConfig, noisy: bool) -> list:
    return [ctypes.c_int(int(noisy)), ctypes.c_uint(cfg.seed & 0xFFFFFFFF),
            ctypes.c_float(cfg.sigma_device), ctypes.c_float(cfg.sigma_read),
            ctypes.c_float(f32(np.log(cfg.rho)))]


def stream_args(stream: int | None) -> list:
    """has_stream, stream of a C entry that takes a noise stream."""
    if stream is None:
        return [ctypes.c_int(0), ctypes.c_uint(0)]
    return [ctypes.c_int(1), ctypes.c_uint(int(stream) & 0xFFFFFFFF)]


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
                qidx: torch.Tensor | None = None, stream: int | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """q (B, S, sl) int8, s (N, S, sl) int8, weights (S,) f32 per string,
    thresholds (K,) f32 -> votes (B, N), dist (B, N) float32. qidx: (B,)
    per-query noise coordinates (default arange(B)). stream: a leading
    noise coordinate (a uint32 value; None: the serving coordinates).

    A CPU or meta tensor runs the plain version; a CUDA tensor launches
    the dense kernel (or raises)."""
    _check_strings("mcam_search", q_strings, s_strings, weights, thresholds)

    def shapes():
        return dict(b=q_strings.shape[0], n=s_strings.shape[0],
                    s=s_strings.shape[1], sl=s_strings.shape[2])
    if _build.off_card(q_strings, s_strings):
        return _build.plain_route("mcam_search", shapes, lambda: (
            mcam_search_plain(q_strings, s_strings, weights, thresholds,
                              cfg, noisy=noisy, qidx=qidx, stream=stream)))
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
        ctypes.c_int(search_instance(sl, q_strings, s_strings)),
        *physics_args(cfg, noisy), *stream_args(stream),
        _build.stream_ptr(s_strings.device))
    _build.check(lib, err, "mcam_search_dense")
    _build.count_launch("mcam_search", shapes)
    return votes, dist


def mcam_rescore(q_strings: torch.Tensor, s_strings: torch.Tensor,
                 rows: torch.Tensor, weights: torch.Tensor,
                 thresholds: torch.Tensor, cfg: MCAMConfig, *,
                 noisy: bool = True, noise_rows: torch.Tensor | None = None,
                 qidx: torch.Tensor | None = None, with_dist: bool = False):
    """Votes of per-query candidate rows: q (B, S, sl) int8, s (N, S, sl)
    int8, rows (B, k) rows of s; noise_rows (B, k) the global rows feeding
    the noise counters (default rows); qidx (B,) query coordinates
    (default arange(B)) -> votes (B, k) float32, and with `with_dist` also
    dist (B, k), the dense entry's dist of each pair (a tenant's `full`).

    A CPU or meta tensor runs the plain version; a CUDA tensor launches
    the gathered kernel (or raises)."""
    _check_strings("mcam_rescore", q_strings, s_strings, weights, thresholds)

    def shapes():
        return dict(b=rows.shape[0], k=rows.shape[1], s=s_strings.shape[1],
                    sl=s_strings.shape[2],
                    uniq=None if rows.device.type == "meta"
                    else int(torch.unique(rows).numel()))
    if _build.off_card(q_strings, s_strings):
        return _build.plain_route("mcam_rescore", shapes, lambda: (
            mcam_rescore_plain(q_strings, s_strings, rows, weights,
                               thresholds, cfg, noisy=noisy,
                               noise_rows=noise_rows, qidx=qidx,
                               with_dist=with_dist)))
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
    dist = torch.empty_like(votes) if with_dist else None
    lib = _build.load("mcam_search", _SIGNATURES)
    err = lib.mcam_search_gathered(
        _build.ptr(q_strings), _build.ptr(s_strings), _build.ptr(r),
        _build.ptr(nr), _build.ptr(weights), _build.ptr(thresholds),
        ctypes.c_int(thresholds.shape[0]), _build.ptr(qi), _build.ptr(votes),
        _build.ptr(dist) if with_dist else ctypes.c_void_p(0),
        ctypes.c_int(B), ctypes.c_int(K), ctypes.c_int(N), ctypes.c_int(S),
        ctypes.c_int(sl), ctypes.c_int(search_instance(sl, q_strings,
                                                       s_strings)),
        *physics_args(cfg, noisy), _build.stream_ptr(s_strings.device))
    _build.check(lib, err, "mcam_search_gathered")
    _build.count_launch("mcam_rescore", shapes)
    return (votes, dist) if with_dist else votes


def prove_forms(device) -> dict[str, int]:
    """Runs the kernels' check of their cheaper arithmetic forms (the
    Box-Muller pieces without unreachable branches, the byte conversions)
    against the plain version's arithmetic on all 2**32 hash words, on
    the card. Returns, per form, the number of words where any bit
    differs; the kernels are exact only where every count is 0."""
    diffs = torch.zeros(len(PROVED_FORMS), dtype=torch.int64, device=device)
    lib = _build.load("mcam_search", _SIGNATURES)
    err = lib.mcam_search_prove_forms(_build.ptr(diffs),
                                      _build.stream_ptr(diffs.device))
    _build.check(lib, err, "mcam_search_prove_forms")
    return dict(zip(PROVED_FORMS, diffs.tolist()))
