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

The CUDA kernel is `csrc/shortlist.cu` (a warp takes 4 queries over a
slice of staged rows, sums each row's fields as packed dot products with
the query's one-hot mask, and keeps a running top-k per query that sorts
only the rows below its k-th key; merge rounds fold the slices), cut by
`shortlist_plan`; `lut_shortlist_plain` is its plain version. Both select
on one int64 key per candidate, uint64(dist) << 32 | row, which is exact
because dist + penalty < 2**24, so the result never depends on how a sort
orders equal values.

`lut_shortlist_blocks` is the block-table entry of the same kernel: every
query selects over its own list of row blocks of a table (M, rows, ...) --
the routed search's shards, the pager's device slots, a tenant stack's
blocks -- with key rows base[block] + row (`shortlist_blocks_plan` cuts
it; `lut_shortlist_blocks_plain` is its plain version).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"shortlist_launch": [_P, _P, _I, _I, _I, _P, _I, _I, _I, _I,
                                     _I, _I, _I, _I, _P, _P, _P, _P],
               "shortlist_blocks_launch": [_P, _P, _I, _I, _I, _P, _P, _P,
                                           _I, _I, _I, _I, _I, _I, _I, _I,
                                           _I, _I, _I, _P, _P, _P, _P, _P],
               "shortlist_merge_keys": []}

# Added to the phase-1 distance of masked-out rows (never-written slots).
# A power of two, exact in bf16 / f32, above any real LUT distance, and
# small enough that dist + penalty stays integer-exact in f32 (< 2**24).
SHORTLIST_MASK_PENALTY = 2.0 ** 22

_KIND_PACKED, _KIND_BF16, _KIND_F32 = 0, 1, 2
_MERGE_KEYS = 2048      # keys per merge block (csrc/shortlist.cu MERGE_KEYS)
MAX_K = _MERGE_KEYS // 2  # largest k the kernel takes
_ROWS = 64              # rows per staged tile: 2 per lane
_QW = 4                 # queries per warp
# shared memory one H100 block may use, less the select pass's static
# part (csrc/shortlist.cu SELECT_STATIC_SMEM: a query and a list a slot)
_SMEM_MAX = 232448 - 4 * _QW * 12
_SM_SMEM = 233472       # shared memory of one H100 SM
_SMS = 132              # SMs of an H100


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _stage_stride(window: int) -> int:
    """Words per staged row (csrc/shortlist.cu stage_stride): a multiple of
    4 with an odd quarter, so 16-byte loads of 32 rows hit every bank
    group."""
    return 4 * (_cdiv(window, 4) | 1)


def _select_smem(warps: int, keys: int, window: int) -> int:
    """Dynamic shared memory of one select block (csrc/shortlist.cu
    select_smem): per query its keys and mask words, and two staged
    tiles."""
    return (warps * _QW * (keys * 8 + 4 * _cdiv(window, 4) * 4)
            + 2 * _ROWS * _stage_stride(window) * 4)


@dataclass(frozen=True)
class ShortlistPlan:
    """How csrc/shortlist.cu cuts one call: `warps` per select block (4
    queries each), `slice_rows` rows per block in `slices` slices, rows
    staged `window` words at a time, `keys` = top-k + candidate slots per
    query, `smem` bytes of dynamic shared memory per select block."""
    warps: int
    slice_rows: int
    slices: int
    window: int
    keys: int
    smem: int

    def scratch(self, b: int, k: int) -> tuple[int, int]:
        """Keys of the two merge scratch buffers (ping and pong)."""
        return (b * self.slices * k,
                b * max(1, _cdiv(self.slices, _MERGE_KEYS // k)) * k)


def _select_block(queries: int, row_words: int, k: int
                  ) -> tuple[int, int, int, int]:
    """(warps, window, keys, smem) of a select block: up to 4 warps of 4
    queries while the block's shared memory (top-k and candidates, mask
    words, two staged tiles) fits; whole rows staged when they fit, else
    windows of words (a multiple of 4)."""
    keys = max(128, 2 * (1 << (k - 1).bit_length()))
    for warps in range(min(4, _cdiv(queries, _QW)), 0, -1):
        window = row_words
        while window > 4 and _select_smem(warps, keys, window) > _SMEM_MAX:
            window = 4 * (window // 8)
        if _select_smem(warps, keys, window) <= _SMEM_MAX:
            break
    else:
        raise ValueError(f"lut_shortlist: k={k} leaves no shared memory to "
                         f"stage rows")
    return warps, window, keys, _select_smem(warps, keys, window)


def _slices(rows: int, k: int, warps: int, smem: int, tiles: int) -> int:
    """Rows a slice, so that `tiles` query tiles x the slices fill the SMs
    once at the occupancy that shared memory allows, each slice at least
    k rows (and one 64-row tile)."""
    per_sm = min(2048 // (32 * warps), _SM_SMEM // (smem + 1024))
    slices = max(1, min(_cdiv(rows, max(_ROWS, k)), per_sm * _SMS // tiles))
    return _ROWS * _cdiv(_cdiv(rows, slices), _ROWS)


def shortlist_plan(b: int, n: int, row_words: int, k: int) -> ShortlistPlan:
    """The select pass's cut for B queries over N rows of `row_words`
    32-bit words (`_select_block`, `_slices`)."""
    warps, window, keys, smem = _select_block(b, row_words, k)
    slice_rows = _slices(n, k, warps, smem, _cdiv(b, _QW * warps))
    return ShortlistPlan(warps=warps, slice_rows=slice_rows,
                         slices=_cdiv(n, slice_rows), window=window,
                         keys=keys, smem=smem)


@dataclass(frozen=True)
class BlocksPlan:
    """How csrc/shortlist.cu cuts one block-table call: a select block per
    (tile of up to 4 `warps` x 4 (query, visit) pairs of one table block,
    slice of `slice_rows` of its rows), `tiles` tile slots in the grid (at
    least what any mix of the B p pairs over M blocks needs), `lists` =
    p x slices sorted lists a query for the merge; window, keys, smem as
    ShortlistPlan."""
    warps: int
    slice_rows: int
    slices: int
    tiles: int
    lists: int
    window: int
    keys: int
    smem: int

    def scratch(self, b: int, k: int) -> tuple[int, int]:
        """Keys of the two merge scratch buffers (ping and pong)."""
        return (b * self.lists * k,
                b * max(1, _cdiv(self.lists, _MERGE_KEYS // k)) * k)


def shortlist_blocks_plan(b: int, p: int, m: int, rows: int, row_words: int,
                          k: int) -> BlocksPlan:
    """The block-table entry's cut for B queries visiting p of M blocks of
    `rows` rows each. A table block's pairs fill ceil(pairs / qb) tiles,
    so every mix needs at most ceil(B p / qb) + min(M + 1, B p) tiles (the
    + 1: the virtual block of ids outside [0, M)); the slices fill the SMs
    for that many tiles."""
    pairs = b * p
    warps, window, keys, smem = _select_block(pairs, row_words, k)
    tiles = _cdiv(pairs, _QW * warps) + min(m + 1, pairs)
    slice_rows = _slices(rows, k, warps, smem, tiles)
    slices = _cdiv(rows, slice_rows)
    return BlocksPlan(warps=warps, slice_rows=slice_rows, slices=slices,
                      tiles=tiles, lists=p * slices, window=window,
                      keys=keys, smem=smem)


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


def _operand_words(s_proj, packed, pack_bits) -> tuple[int, int, torch.Tensor]:
    """(kind, field bits, the operand read as 32-bit words)."""
    if packed is not None:
        return _KIND_PACKED, pack_bits, packed
    if s_proj.dtype == torch.bfloat16:
        return _KIND_BF16, 16, s_proj.view(torch.int32)
    if s_proj.dtype == torch.float32:
        return _KIND_F32, 32, s_proj.view(torch.int32)
    raise TypeError(f"lut_shortlist: projection dtype {s_proj.dtype}; "
                    f"expected bf16 or f32")


def _scratch_keys(device, plan_scratch: tuple[int, int], b: int, k: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The merge's ping and pong scratch and the (B, k) output keys."""
    return (torch.empty(plan_scratch[0], dtype=torch.int64, device=device),
            torch.empty(plan_scratch[1], dtype=torch.int64, device=device),
            torch.empty(b, k, dtype=torch.int64, device=device))


def _load() -> ctypes.CDLL:
    lib = _build.load("shortlist", _SIGNATURES)
    if lib.shortlist_merge_keys() != _MERGE_KEYS:
        raise RuntimeError(f"csrc/shortlist.cu merges "
                           f"{lib.shortlist_merge_keys()} keys a block; the "
                           f"wrapper sizes its scratch for {_MERGE_KEYS}")
    return lib


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
    if B > 65535:
        raise ValueError(f"lut_shortlist: B={B} exceeds the kernel's 65535 "
                         f"queries")
    q = q_words.to(torch.int32).contiguous()
    kind, bits, words = _operand_words(s_proj, packed, pack_bits)
    tensors = [q, words]
    if valid is not None:
        if valid.shape != (n,):
            raise ValueError(f"lut_shortlist: valid {tuple(valid.shape)} "
                             f"for N={n}")
        valid_u8 = valid.to(torch.uint8).contiguous()
        tensors.append(valid_u8)
    _build.require_cuda("lut_shortlist", *tensors)
    plan = shortlist_plan(B, n, words.shape[1], k)
    scratch_a, scratch_b, keys = _scratch_keys(q.device, plan.scratch(B, k),
                                               B, k)
    lib = _load()
    err = lib.shortlist_launch(
        _build.ptr(q), _build.ptr(words), ctypes.c_int(kind),
        ctypes.c_int(bits), ctypes.c_int(words.shape[1]),
        _build.ptr(valid_u8) if valid is not None else ctypes.c_void_p(0),
        ctypes.c_int(B), ctypes.c_int(n), ctypes.c_int(d), ctypes.c_int(k),
        ctypes.c_int(plan.warps), ctypes.c_int(plan.slice_rows),
        ctypes.c_int(plan.window), ctypes.c_int(plan.keys),
        _build.ptr(scratch_a), _build.ptr(scratch_b), _build.ptr(keys),
        _build.stream_ptr(q.device))
    _build.check(lib, err, "shortlist_launch")
    _build.count_launch("shortlist")
    return split_keys(keys)


# ---------------------------------------------------------------------------
# The block-table entry: each query over its own list of row blocks.
# ---------------------------------------------------------------------------


def block_keys(dist: torch.Tensor, base: torch.Tensor, ids: torch.Tensor,
               rows: int) -> torch.Tensor:
    """(B, p rows) integer-valued f32 distances of each query's visited
    blocks, in visit order -> int64 keys dist << 32 | (base[block] + row)
    (the key row taken to 32 bits, as the kernel's key holds it)."""
    r = torch.arange(rows, dtype=torch.int64, device=dist.device)
    key_rows = (base.to(torch.int64)[ids.to(torch.int64)][:, :, None]
                + r) & 0xFFFFFFFF
    return (dist.to(torch.int64) << 32) | key_rows.reshape(dist.shape)


def lut_shortlist_blocks_plain(q_words: torch.Tensor,
                               s_proj: torch.Tensor | None, k: int, *,
                               base: torch.Tensor, ids: torch.Tensor,
                               valid: torch.Tensor | None = None,
                               packed: torch.Tensor | None = None,
                               pack_bits: int | None = None
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `lut_shortlist_blocks`: the distances of every
    table row (`shortlist_dist_plain`, mask penalty included), the visited
    blocks' gathered in visit order, then the k smallest keys."""
    table = packed if packed is not None else s_proj
    m, rows = table.shape[:2]
    dist = shortlist_dist_plain(
        q_words, None if s_proj is None else s_proj.reshape(m * rows, -1),
        None if valid is None else valid.reshape(m * rows),
        packed=None if packed is None else packed.reshape(m * rows, -1),
        pack_bits=pack_bits)
    ids64 = ids.to(device=dist.device, dtype=torch.int64)
    cols = (ids64[:, :, None] * rows
            + torch.arange(rows, device=dist.device)).reshape(len(ids), -1)
    keys = block_keys(dist.gather(1, cols), base.to(dist.device), ids64,
                      rows)
    top = torch.topk(keys, k, dim=1, largest=False, sorted=True).values
    return split_keys(top)


def _check_blocks(q_words, s_proj, k, base, ids, valid, packed,
                  pack_bits) -> tuple[int, int]:
    """Validate a block-table call; returns (M, rows)."""
    table = packed if packed is not None else s_proj
    if table is None or table.dim() != 3:
        raise ValueError("lut_shortlist_blocks: the table must be (M, rows, "
                         "width)")
    m, rows = table.shape[:2]
    _check_args(q_words, None if s_proj is None else s_proj[0], 1,
                None if packed is None else packed[0], pack_bits)
    if ids.dim() != 2 or ids.shape[0] != q_words.shape[0]:
        raise ValueError(f"lut_shortlist_blocks: ids {tuple(ids.shape)} for "
                         f"B={q_words.shape[0]}")
    if base.shape != (m,):
        raise ValueError(f"lut_shortlist_blocks: base {tuple(base.shape)} "
                         f"for M={m}")
    if valid is not None and valid.shape != (m, rows):
        raise ValueError(f"lut_shortlist_blocks: valid {tuple(valid.shape)} "
                         f"for ({m}, {rows})")
    if not 0 < k <= ids.shape[1] * rows:
        raise ValueError(f"lut_shortlist_blocks: need 0 < k <= p * rows, "
                         f"got k={k}, p={ids.shape[1]}, rows={rows}")
    return m, rows


def lut_shortlist_blocks(q_words: torch.Tensor, s_proj: torch.Tensor | None,
                         k: int, *, base: torch.Tensor, ids: torch.Tensor,
                         valid: torch.Tensor | None = None,
                         packed: torch.Tensor | None = None,
                         pack_bits: int | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each query's k best rows over its own visited blocks of a table:
    q (B, d) words; the table s_proj (M, rows, 4d) bf16 / f32, or packed
    (M, rows, dp) int32 with `pack_bits` fields; valid (M, rows) bool;
    base (M,) the key row of each block's row 0; ids (B, p) the blocks
    each query visits, ascending in base -> (dist (B, k) float32, key rows
    (B, k) int64), ascending by (distance, key row), key row base[block] +
    row. With distinct key rows that is JAX's order over the concatenation
    of the visited blocks (`jax.vmap` of lut_shortlist_pallas). Requires
    0 < k <= p * rows (k <= MAX_K on the card) and base + rows <= 2**32.

    A CPU tensor runs the plain version; a CUDA tensor launches the
    grouping, select and merge passes of csrc/shortlist.cu (or raises). An
    id outside [0, M) reads nothing on the card (its lists hold the
    all-ones key) and raises in the plain version."""
    m, rows = _check_blocks(q_words, s_proj, k, base, ids, valid, packed,
                            pack_bits)
    operand = packed if packed is not None else s_proj
    if q_words.device.type == "cpu" and operand.device.type == "cpu":
        return lut_shortlist_blocks_plain(q_words, s_proj, k, base=base,
                                          ids=ids, valid=valid, packed=packed,
                                          pack_bits=pack_bits)
    if q_words.device.type != "cuda":
        raise ValueError(f"lut_shortlist_blocks: unsupported device "
                         f"{q_words.device}")
    B, d = q_words.shape
    p = ids.shape[1]
    if k > MAX_K:
        raise ValueError(f"lut_shortlist_blocks: k={k} exceeds the kernel's "
                         f"{MAX_K}")
    if B > 65535:
        raise ValueError(f"lut_shortlist_blocks: B={B} exceeds the kernel's "
                         f"65535 queries")
    dev = q_words.device
    q = q_words.to(torch.int32).contiguous()
    kind, bits, words = _operand_words(s_proj, packed, pack_bits)
    words = words.contiguous()
    row_words = words.shape[2]
    tensors = [q, words, base.to(device=dev, dtype=torch.int64).contiguous(),
               ids.to(device=dev, dtype=torch.int32).contiguous()]
    if valid is not None:
        tensors.append(valid.to(torch.uint8).contiguous())
    _build.require_cuda("lut_shortlist_blocks", *tensors)
    plan = shortlist_blocks_plan(B, p, m, rows, row_words, k)
    group = torch.empty(4 * plan.tiles + m + 1 + B * p + 1,
                        dtype=torch.int32, device=dev)
    scratch_a, scratch_b, keys = _scratch_keys(dev, plan.scratch(B, k), B, k)
    lib = _load()
    err = lib.shortlist_blocks_launch(
        _build.ptr(q), _build.ptr(words), ctypes.c_int(kind),
        ctypes.c_int(bits), ctypes.c_int(row_words),
        _build.ptr(tensors[4]) if valid is not None else ctypes.c_void_p(0),
        _build.ptr(tensors[2]), _build.ptr(tensors[3]), ctypes.c_int(B),
        ctypes.c_int(m), ctypes.c_int(rows), ctypes.c_int(d),
        ctypes.c_int(p), ctypes.c_int(k), ctypes.c_int(plan.warps),
        ctypes.c_int(plan.slice_rows), ctypes.c_int(plan.window),
        ctypes.c_int(plan.keys), ctypes.c_int(plan.tiles),
        _build.ptr(group), _build.ptr(scratch_a), _build.ptr(scratch_b),
        _build.ptr(keys), _build.stream_ptr(dev))
    _build.check(lib, err, "shortlist_blocks_launch")
    _build.count_launch("shortlist_blocks")
    return split_keys(keys)
