"""HAT's episodic MCAM physics, differentiable: votes and dist of every
(query, support) pair of an episode and their gradient with respect to
both string grids.

JAX differentiates its jnp physics with `jax.grad`
(`repro.engine.engine.RetrievalEngine.episode_votes`), which keeps the
(B, N, S, sl) mismatch grid and several tensors of its size alive; at the
paper's Omniglot episode that is 9.8 GB each. Here:

  episode_physics(q, s, weights, thresholds, cfg, ...) -> votes, dist (B, N)

q (B, S, sl) and s (N, S, sl) are float grids holding integer cell values
in [0, 3] (the straight-through code words). A CPU tensor takes the plain
route: autograd through the plain forward (`mcam_search._pairs_plain`
with the STE step, `|q - s|` and the clip at jax.grad's kink rules). A
CUDA tensor runs `EpisodePhysics`: its forward is the dense entry of
`csrc/mcam_search.cu` (the same bits, with the noise-stream coordinate),
its backward the kernel of `csrc/mcam_episode.cu`, which recomputes each
string's current once with the forward's device code, sends its cell
gradients into dq and ds at once and sums in a fixed order (partial sums
per row tile and query chunk in a workspace, then a second launch over
them: `episode_tiling`). `episode_backward_plain` is the backward kernel's
plain version:
the same autograd through the plain forward, which the tests and
chip_smoke.py hold the kernel against.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import mcam as mcam_lib
from repro_torch.core.mcam import MCAMConfig, f32
from repro_torch.kernels import _build
from repro_torch.kernels import mcam_search as search_kernel

#: the longest string the generic instance takes (csrc/mcam_episode.cu)
MAX_GENERIC_SL = 64
#: rows of the backward kernel's tile: a warp's lanes (csrc ROWS)
ROW_TILE = 32
#: the most queries a block of the backward kernel walks (csrc MAX_CHUNK)
QUERY_CHUNK = 128

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "mcam_episode_backward": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _I, ctypes.c_uint,
                              ctypes.c_float, ctypes.c_float, ctypes.c_float,
                              *search_kernel.STREAM_ARGS, ctypes.c_float,
                              _P],
}


def episode_tiling(B: int, N: int) -> tuple[int, int, int]:
    """(row tiles, query chunks, queries a chunk) of the backward kernel
    for B queries and N rows: a warp owns ROW_TILE rows of one string and
    walks one chunk of queries, the chunks as even as QUERY_CHUNK allows.
    dq is summed over the tiles' partial sums, ds over the chunks'; both
    depend on the shape alone, so a shape has one summation order."""
    tiles = -(-N // ROW_TILE)
    chunks = -(-B // QUERY_CHUNK)
    return tiles, chunks, -(-B // chunks) if chunks else 1


def _step(tau: float):
    return lambda x: mcam_lib.ste_step(x, tau)


def episode_physics_plain(q: torch.Tensor, s: torch.Tensor,
                          weights: torch.Tensor, thresholds: torch.Tensor,
                          cfg: MCAMConfig, *, noisy: bool,
                          qidx: torch.Tensor | None = None,
                          stream: int | None = None, tau: float = 0.02
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain route: the dense physics' plain version with the STE
    step, differentiable in q and s."""
    return search_kernel.mcam_search_plain(
        q, s, weights, thresholds, cfg, noisy=noisy, qidx=qidx,
        stream=stream, step_fn=_step(tau))


def episode_backward_plain(q8: torch.Tensor, s8: torch.Tensor,
                           g_votes: torch.Tensor, g_dist: torch.Tensor,
                           weights: torch.Tensor, thresholds: torch.Tensor,
                           cfg: MCAMConfig, *, noisy: bool,
                           qidx: torch.Tensor | None = None,
                           stream: int | None = None, tau: float = 0.02
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `episode_backward`: autograd through the plain
    forward -> (dq (B, S, sl), ds (N, S, sl)) float32. It runs in blocks of
    support rows (the plain forward's block size), taking each block's
    gradient before the next, so its memory is bounded at any episode
    size; dq sums the blocks in row order."""
    B, S, sl = q8.shape
    N = s8.shape[0]
    dev = s8.device
    qi = torch.arange(B, device=dev) if qidx is None else qidx.to(dev)
    q = q8.to(torch.float32).requires_grad_(True)
    dq = torch.zeros(B, S, sl, dtype=torch.float32, device=dev)
    ds = torch.empty(N, S, sl, dtype=torch.float32, device=dev)
    step = max(1, search_kernel.PLAIN_CELLS // max(1, B * S * sl))
    for n0 in range(0, N, step):
        s = s8[n0:n0 + step].to(torch.float32).requires_grad_(True)
        rows = torch.arange(n0, n0 + s.shape[0], device=dev)
        with torch.enable_grad():
            votes, dist = search_kernel._pairs_plain(
                q[:, None], s[None], qi[:, None], rows[None], weights,
                thresholds, cfg, noisy, stream=stream, step_fn=_step(tau))
            gq, gs = torch.autograd.grad(
                (votes, dist), (q, s),
                (g_votes[:, n0:n0 + step], g_dist[:, n0:n0 + step]))
        dq += gq
        ds[n0:n0 + step] = gs
    return dq, ds


def episode_backward(q8: torch.Tensor, s8: torch.Tensor,
                     g_votes: torch.Tensor, g_dist: torch.Tensor,
                     weights: torch.Tensor, thresholds: torch.Tensor,
                     cfg: MCAMConfig, *, noisy: bool,
                     qidx: torch.Tensor | None = None,
                     stream: int | None = None, tau: float = 0.02
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Gradient of the episodic votes and dist with respect to the string
    grids: q8 (B, S, sl), s8 (N, S, sl) int8 cell values in [0, 3],
    g_votes, g_dist (B, N) float32 -> dq (B, S, sl), ds (N, S, sl)
    float32.

    A CPU tensor runs the plain version; a CUDA tensor launches the
    backward kernel (or raises)."""
    if q8.dtype != torch.int8 or s8.dtype != torch.int8:
        raise TypeError("episode_backward: string grids must be int8")
    if q8.dim() != 3 or s8.dim() != 3 or q8.shape[1:] != s8.shape[1:]:
        raise ValueError(f"episode_backward: shapes {tuple(q8.shape)} and "
                         f"{tuple(s8.shape)}; expected (B, S, sl) and "
                         f"(N, S, sl)")
    B, S, sl = q8.shape
    N = s8.shape[0]
    for name, g in (("g_votes", g_votes), ("g_dist", g_dist)):
        if g.shape != (B, N) or g.dtype != torch.float32:
            raise ValueError(f"episode_backward: {name} must be ({B}, {N}) "
                             f"float32, got {tuple(g.shape)} {g.dtype}")
    if weights.dtype != torch.float32 or weights.shape != (S,):
        raise ValueError(f"episode_backward: weights must be ({S},) float32")
    if thresholds.dtype != torch.float32 or thresholds.dim() != 1:
        raise ValueError("episode_backward: thresholds must be 1-D float32")
    if q8.device.type == "cpu" and s8.device.type == "cpu":
        return episode_backward_plain(q8, s8, g_votes, g_dist, weights,
                                      thresholds, cfg, noisy=noisy,
                                      qidx=qidx, stream=stream, tau=tau)
    if s8.device.type != "cuda":
        raise ValueError(f"episode_backward: unsupported device {s8.device}")
    if not 1 <= sl <= MAX_GENERIC_SL:
        raise ValueError(f"episode_backward: strings of {sl} cells; the "
                         f"kernel takes 1..{MAX_GENERIC_SL}")
    qi = (torch.arange(B, dtype=torch.int64, device=q8.device)
          if qidx is None else qidx.to(device=q8.device, dtype=torch.int64))
    if qi.shape != (B,):
        raise ValueError(f"episode_backward: qidx {tuple(qi.shape)} for "
                         f"B={B}")
    _build.require_cuda("episode_backward", q8, s8, g_votes, g_dist,
                        weights, thresholds, qi)
    dev = q8.device
    dq = torch.empty(B, S, sl, dtype=torch.float32, device=dev)
    ds = torch.empty(N, S, sl, dtype=torch.float32, device=dev)
    # the partial sums: dq's per row tile, then ds's per query chunk; ds's
    # start 4 * dq_len bytes in, a multiple of 16 at sl = 24, where the
    # unrolled instance stores them as float4
    tiles, chunks, per_chunk = episode_tiling(B, N)
    dq_len = tiles * B * S * sl
    work = torch.empty(dq_len + chunks * N * S * sl, dtype=torch.float32,
                       device=dev)
    lib = _build.load("mcam_episode", _SIGNATURES)
    err = lib.mcam_episode_backward(
        _build.ptr(q8), _build.ptr(s8), _build.ptr(g_votes),
        _build.ptr(g_dist), _build.ptr(weights), _build.ptr(thresholds),
        ctypes.c_int(thresholds.shape[0]), _build.ptr(qi),
        _build.ptr(dq), _build.ptr(ds), _build.ptr(work),
        ctypes.c_void_p(work.data_ptr() + 4 * dq_len),
        ctypes.c_int(B), ctypes.c_int(N), ctypes.c_int(S), ctypes.c_int(sl),
        ctypes.c_int(search_kernel.search_instance(sl, q8, s8)),
        ctypes.c_int(per_chunk),
        *search_kernel.physics_args(cfg, noisy),
        *search_kernel.stream_args(stream), ctypes.c_float(f32(tau)),
        _build.stream_ptr(dev))
    _build.check(lib, err, "mcam_episode_backward")
    _build.count_launch("mcam_episode")
    return dq, ds


class EpisodePhysics(torch.autograd.Function):
    """The card's route: the dense search kernel forward, the episodic
    backward kernel backward."""

    @staticmethod
    def forward(ctx, q, s, weights, thresholds, qidx, cfg, noisy, stream,
                tau):
        q8 = q.detach().to(torch.int8).contiguous()
        s8 = s.detach().to(torch.int8).contiguous()
        votes, dist = search_kernel.mcam_search(
            q8, s8, weights, thresholds, cfg, noisy=noisy, qidx=qidx,
            stream=stream)
        ctx.save_for_backward(q8, s8, weights, thresholds, qidx)
        ctx.physics = (cfg, noisy, stream, tau)
        return votes, dist

    @staticmethod
    def backward(ctx, g_votes, g_dist):
        q8, s8, weights, thresholds, qidx = ctx.saved_tensors
        cfg, noisy, stream, tau = ctx.physics
        dq, ds = episode_backward(
            q8, s8, g_votes.contiguous(), g_dist.contiguous(), weights,
            thresholds, cfg, noisy=noisy, qidx=qidx, stream=stream, tau=tau)
        return dq, ds, None, None, None, None, None, None, None


def episode_physics(q: torch.Tensor, s: torch.Tensor, weights: torch.Tensor,
                    thresholds: torch.Tensor, cfg: MCAMConfig, *,
                    noisy: bool, qidx: torch.Tensor | None = None,
                    stream: int | None = None, tau: float = 0.02
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Votes, dist (B, N) of q (B, S, sl) against s (N, S, sl), float grids
    of integer cell values in [0, 3], differentiable in both (see the
    module docstring). tau: the sense-amp STE's temperature."""
    if q.device.type == "cpu" and s.device.type == "cpu":
        return episode_physics_plain(q, s, weights, thresholds, cfg,
                                     noisy=noisy, qidx=qidx, stream=stream,
                                     tau=tau)
    if s.device.type != "cuda":
        raise ValueError(f"episode_physics: unsupported device {s.device}")
    qi = (torch.arange(q.shape[0], dtype=torch.int64, device=q.device)
          if qidx is None else qidx.to(device=q.device, dtype=torch.int64))
    return EpisodePhysics.apply(q, s, weights.contiguous(),
                                thresholds.contiguous(), qi.contiguous(),
                                cfg, noisy, stream, tau)

