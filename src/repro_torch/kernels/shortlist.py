"""Fused AVSS shortlist: exact LUT distance + exact top-k (port of
`repro.kernels.shortlist`).

    dist[b, n] = sum_d proj[n, 4 d + q[b, d]]  (+ SHORTLIST_MASK_PENALTY
                                                 on rows with valid == 0)

then the k smallest in (distance, row) lexicographic order, ties included
-- the order `jax.lax.top_k(-dist)` gives. The query enters as its words
q (B, d) in [0, 4): the one-hot product of the JAX kernel is a gather of
one LUT column per dimension. The support operand is either the write-time
projection (N, 4d) bf16 / f32, or its bit-packed form (N, ceil(4d/wpi))
int32 from `ops.pack_projection`, whose fields are `pack_bits` wide.

The CUDA kernel is `csrc/shortlist.cu`; `lut_shortlist_plain` is its plain
version. Both select on one int64 key per candidate, uint64(dist) << 32 |
row, which is exact because dist + penalty < 2**24, so the result never
depends on how a sort orders equal values.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"shortlist_launch": [_P, _P, _I, _I, _I, _P, _I, _I, _I, _I,
                                     _P, _P, _P, _P],
               "shortlist_chunk_rows": []}

# Added to the phase-1 distance of masked-out rows (never-written slots).
# A power of two, exact in bf16 / f32, above any real LUT distance, and
# small enough that dist + penalty stays integer-exact in f32 (< 2**24).
SHORTLIST_MASK_PENALTY = 2.0 ** 22

_KIND_PACKED, _KIND_BF16, _KIND_F32 = 0, 1, 2
_CHUNK = 2048           # rows per pass-1 block (csrc/shortlist.cu CHUNK)
MAX_K = _CHUNK // 2     # largest k the kernel takes
_MAX_D = 4096


def unpack_projection(packed: torch.Tensor, pack_bits: int,
                      width: int) -> torch.Tensor:
    """(N, dp) int32 packed words -> (N, width) float32 projection columns.
    Column w * dp + m is field w of word m; shift first, then mask, so an
    arithmetic shift of a negative word does no harm."""
    wpi = 32 // pack_bits
    if wpi == 1:
        cols = [packed]
    else:
        mask = (1 << pack_bits) - 1
        cols = [(packed >> (pack_bits * w)) & mask for w in range(wpi)]
    return torch.cat(cols, dim=1)[:, :width].to(torch.float32)


def shortlist_dist_plain(q_words: torch.Tensor, s_proj: torch.Tensor | None,
                         valid: torch.Tensor | None = None, *,
                         packed: torch.Tensor | None = None,
                         pack_bits: int | None = None) -> torch.Tensor:
    """(B, N) float32 distances with the mask penalty: one LUT-column
    gather per dimension, summed in dimension order (exact)."""
    q = q_words.to(torch.int64)
    B, d = q.shape
    proj = (unpack_projection(packed, pack_bits, 4 * d) if packed is not None
            else s_proj.to(torch.float32))
    table = proj.reshape(proj.shape[0], d, 4)
    dist = torch.zeros(B, proj.shape[0], dtype=torch.float32,
                       device=proj.device)
    for dim in range(d):
        dist += table[:, dim, :].T[q[:, dim]]
    if valid is not None:
        dist += torch.where(valid, 0.0, SHORTLIST_MASK_PENALTY)[None]
    return dist


def keys_from_dist(dist: torch.Tensor) -> torch.Tensor:
    """(B, N) integer-valued f32 distances -> unique int64 keys
    dist << 32 | row."""
    rows = torch.arange(dist.shape[1], dtype=torch.int64, device=dist.device)
    return (dist.to(torch.int64) << 32) | rows[None]


def split_keys(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int64 keys -> (dist float32, row int64)."""
    return (keys >> 32).to(torch.float32), keys & 0xFFFFFFFF


def select_topk(dist: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The k smallest (distance, row) pairs of each row of a (B, N)
    integer-valued distance matrix, ascending: a top-k over unique int64
    keys, so ties resolve by row exactly as `lax.top_k(-dist)` does."""
    keys = torch.topk(keys_from_dist(dist), k, dim=1, largest=False,
                      sorted=True).values
    return split_keys(keys)


def lut_shortlist_plain(q_words: torch.Tensor, s_proj: torch.Tensor | None,
                        k: int, *, valid: torch.Tensor | None = None,
                        packed: torch.Tensor | None = None,
                        pack_bits: int | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `lut_shortlist`."""
    return select_topk(shortlist_dist_plain(q_words, s_proj, valid,
                                            packed=packed,
                                            pack_bits=pack_bits), k)


def _check_args(q_words, s_proj, k, packed, pack_bits) -> int:
    """Validate shapes; returns N."""
    if q_words.dim() != 2:
        raise ValueError(f"lut_shortlist: query words must be (B, d), got "
                         f"{tuple(q_words.shape)}")
    width = 4 * q_words.shape[1]
    if packed is not None:
        if pack_bits not in (4, 8, 16, 32):
            raise ValueError(f"lut_shortlist: pack_bits={pack_bits}")
        if packed.dtype != torch.int32 or packed.dim() != 2:
            raise TypeError("lut_shortlist: packed must be (N, dp) int32")
        if packed.shape[1] * (32 // pack_bits) < width:
            raise ValueError(f"lut_shortlist: packed width "
                             f"{packed.shape[1]} x {32 // pack_bits} < "
                             f"{width} columns")
        n = packed.shape[0]
    else:
        if s_proj is None:
            raise ValueError("lut_shortlist: need s_proj or packed")
        if s_proj.dim() != 2 or s_proj.shape[1] != width:
            raise ValueError(f"lut_shortlist: projection {tuple(s_proj.shape)}"
                             f" does not match {width} query columns")
        n = s_proj.shape[0]
    if not 0 < k <= n:
        raise ValueError(f"lut_shortlist: need 0 < k <= N, got k={k}, N={n}")
    return n


def lut_shortlist(q_words: torch.Tensor, s_proj: torch.Tensor | None,
                  k: int, *, valid: torch.Tensor | None = None,
                  packed: torch.Tensor | None = None,
                  pack_bits: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, d) query words x (N, 4d) projection (or its packed form) ->
    (dist (B, k) float32, rows (B, k) int64), ascending by (distance, row).

    valid: optional (N,) bool; masked rows carry SHORTLIST_MASK_PENALTY in
    their distance and rank after every valid row. Requires 0 < k <= N
    (and k <= MAX_K on the card). A CPU tensor runs the plain version; a
    CUDA tensor launches the kernel (or raises)."""
    n = _check_args(q_words, s_proj, k, packed, pack_bits)
    operand = packed if packed is not None else s_proj
    if q_words.device.type == "cpu" and operand.device.type == "cpu":
        return lut_shortlist_plain(q_words, s_proj, k, valid=valid,
                                   packed=packed, pack_bits=pack_bits)
    if q_words.device.type != "cuda":
        raise ValueError(f"lut_shortlist: unsupported device "
                         f"{q_words.device}")
    B, d = q_words.shape
    if k > MAX_K:
        raise ValueError(f"lut_shortlist: k={k} exceeds the kernel's "
                         f"{MAX_K}")
    if B > 65535 or d > _MAX_D:
        raise ValueError(f"lut_shortlist: B={B}, d={d} exceed the kernel's "
                         f"65535 queries / {_MAX_D} dimensions")
    q = q_words.to(torch.int32).contiguous()
    if packed is not None:
        kind, bits, words = _KIND_PACKED, pack_bits, packed
    elif s_proj.dtype == torch.bfloat16:
        kind, bits, words = _KIND_BF16, 16, s_proj.view(torch.int32)
    elif s_proj.dtype == torch.float32:
        kind, bits, words = _KIND_F32, 32, s_proj.view(torch.int32)
    else:
        raise TypeError(f"lut_shortlist: projection dtype {s_proj.dtype}; "
                        f"expected bf16 or f32")
    tensors = [q, words]
    if valid is not None:
        if valid.shape != (n,):
            raise ValueError(f"lut_shortlist: valid {tuple(valid.shape)} "
                             f"for N={n}")
        valid_u8 = valid.to(torch.uint8).contiguous()
        tensors.append(valid_u8)
    _build.require_cuda("lut_shortlist", *tensors)
    chunks = -(-n // _CHUNK)
    group = _CHUNK // k
    scratch_a = torch.empty(B * chunks * k, dtype=torch.int64,
                            device=q.device)
    scratch_b = torch.empty(B * max(1, -(-chunks // group)) * k,
                            dtype=torch.int64, device=q.device)
    keys = torch.empty(B, k, dtype=torch.int64, device=q.device)
    lib = _build.load("shortlist", _SIGNATURES)
    if lib.shortlist_chunk_rows() != _CHUNK:
        raise RuntimeError(f"csrc/shortlist.cu has {lib.shortlist_chunk_rows()}"
                           f"-row chunks; the wrapper sizes its scratch for "
                           f"{_CHUNK}")
    err = lib.shortlist_launch(
        _build.ptr(q), _build.ptr(words), ctypes.c_int(kind),
        ctypes.c_int(bits), ctypes.c_int(words.shape[1]),
        _build.ptr(valid_u8) if valid is not None else ctypes.c_void_p(0),
        ctypes.c_int(B), ctypes.c_int(n), ctypes.c_int(d), ctypes.c_int(k),
        _build.ptr(scratch_a), _build.ptr(scratch_b), _build.ptr(keys),
        _build.stream_ptr(q.device))
    _build.check(lib, err, "shortlist_launch")
    _build.count_launch("shortlist")
    return split_keys(keys)
