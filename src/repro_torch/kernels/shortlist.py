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

`lut_shortlist_blocks` is the block-table entry of the same source, with
kernels of its own: every query selects over its own list of row blocks
of a table (M, rows, ...) -- the routed search's shards, the pager's
device slots, a tenant stack's blocks -- with key rows base[block] + row.
A grouping pass lays the (query, visit) pairs out by block in work units
of up to 16 pairs and a row range; a unit builds its pairs' masks once,
stages rows in K-chunks, sums 8-bit fields on the tensor cores (mma.sync)
and selects under a bound each query shares through global memory
(`shortlist_blocks_plan` cuts it; `lut_shortlist_blocks_plain` is its
plain version).

No counterpart, by design (the Pallas kernel's knobs): `DEFAULT_TILE_B`,
`DEFAULT_TILE_N`, `LANE` and `lut_shortlist_pallas` with its `tile_*`
and `interpret` arguments; the plans above size the CUDA kernel.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"shortlist_launch": [_P, _P, _I, _I, _I, _P, _I, _I, _I, _I,
                                     _I, _I, _I, _I, _P, _P, _P, _P],
               "shortlist_blocks_launch": [_P, _P, _I, _I, _I, _P, _P, _P]
                                          + [_I] * 14 + [_P] * 6,
               "shortlist_merge_keys": []}

# Added to the phase-1 distance of masked-out rows (never-written slots).
# A power of two, exact in bf16 / f32, above any real LUT distance, and
# small enough that dist + penalty stays integer-exact in f32 (< 2**24).
SHORTLIST_MASK_PENALTY = 2.0 ** 22

#: the profiler range around both entries (the reference's
#: `jax.named_scope("shortlist_fused")`), entered while a trace or a
#: profiler records (`_build.profiler_range`): present iff the fused
#: shortlist ran, which analysis/contracts.py holds against the dispatch
#: rule
FUSED_TAG = "shortlist_fused"

_KIND_PACKED, _KIND_BF16, _KIND_F32 = 0, 1, 2
_MERGE_KEYS = 2048      # keys per merge block (csrc/shortlist.cu MERGE_KEYS)
MAX_K = _MERGE_KEYS // 2  # largest k the kernel takes
_ROWS = 64              # rows per staged tile: 2 per lane
_QW = 4                 # queries per warp
# the select pass's static shared memory (csrc/shortlist.cu
# SELECT_STATIC_SMEM: a query and a list a slot), and what one H100 block
# may use beside it
_SELECT_STATIC = 4 * _QW * 12
_SMEM_MAX = 232448 - _SELECT_STATIC
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
    once at the occupancy that shared memory allows (a block's dynamic and
    static shared memory and the runtime's 1 KB), each slice at least k
    rows (and one 64-row tile)."""
    per_sm = min(2048 // (32 * warps),
                 _SM_SMEM // (smem + _SELECT_STATIC + 1024))
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


# the block-table entry (csrc/shortlist.cu): pairs a unit at most (the
# MMA's M), words a pair of the distance tile, bound slots a query, words
# of a staged K-chunk at most, and its select pass's static shared memory
_BQ = 4 * _QW
_DSTRIDE = 72
_SLOTS = 32
_CHUNK_MAX = 64
_BLOCKS_STATIC = _BQ * (4 + 8 + 4 + 4)
_BLOCKS_SMEM_MAX = 232448 - _BLOCKS_STATIC
# the units a mix is spread over, in waves of the SMs at the plan's
# occupancy: whole rows half a wave, so a query has fewer, longer lists
# and every unit runs at once; rows staged in K-chunks (wider than
# _CHUNK_MAX words) one and a half, whose staging then overlaps across
# units (launch/time_blocks.py --variants times each constant's values)
_BLOCKS_WAVES = 0.5
_BLOCKS_WAVES_CHUNKED = 1.5
# the ring's depth for K-chunked rows (whole rows take two stages)
_BLOCKS_STAGES_CHUNKED = 3


def _blocks_stride(words: int) -> int:
    """Words a mask or staged row takes (csrc/shortlist.cu blocks_stride):
    the width rounded up to 8 words, plus 4, so 8 rows' 16-byte segments
    lie in 8 different bank groups."""
    return 8 * _cdiv(words, 8) + 4


def _blocks_smem(warps: int, keys: int, row_words: int, chunk: int,
                 stages: int, mma: bool) -> int:
    """Dynamic shared memory of one block-table select block
    (csrc/shortlist.cu blocks_smem): per pair slot its keys, the masks of
    the whole row (16 rows for the MMA), the ring of staged K-chunks, and
    the MMA's distance tile."""
    return (warps * _QW * keys * 8
            + (_BQ if mma else warps * _QW) * _blocks_stride(row_words) * 4
            + stages * _ROWS * _blocks_stride(chunk) * 4
            + (_BQ * _DSTRIDE * 4 if mma else 0))


def _unit_rows(rows: int, s: int) -> int:
    """Rows of each range of a tile cut in s (whole 64-row tiles)."""
    return _ROWS * _cdiv(_cdiv(rows, s), _ROWS)


def _row_cost(row_words: int) -> int:
    """A staged row's cost in pair-rows of selection (csrc/shortlist.cu
    row_cost): the rows dominate a unit at every width measured."""
    return _cdiv(row_words, 4)


@dataclass(frozen=True)
class BlocksPlan:
    """How csrc/shortlist.cu cuts one block-table call: select blocks of
    `warps` warps (4 pairs each), each on one unit -- up to 4 x `warps`
    (query, visit) pairs of one table block and a range of its rows --
    with `keys` = 2 x the kept keys of a list, rows staged in K-chunks of
    `chunk` words through a ring of `stages`, `smem` bytes of dynamic
    shared memory; each tile of a block that c pairs visit cut into
    `ranges(c, rows)` row ranges (about `work` cost a unit, at most
    `split`); `tiles` tile slots and `units` unit slots in the grid (at
    least what any mix of the B p pairs over M blocks needs); `lists` =
    p x split list slots a query for the merge; `ctas_per_sm` select
    blocks an SM at this shared memory. `mma`: 8-bit fields summed on the
    tensor cores."""
    warps: int
    keys: int
    chunk: int
    stages: int
    row_words: int
    work: int
    split: int
    tiles: int
    units: int
    lists: int
    smem: int
    ctas_per_sm: int
    mma: bool

    def ranges(self, c: int, rows: int) -> int:
        """Row ranges of each tile of a block that c pairs visit
        (csrc/shortlist.cu ranges_of): rows x (row cost + its first
        tile's pairs) over `work`."""
        cc = min(c, 4 * self.warps)
        s = min(self.split, max(1, _cdiv(
            rows * (_row_cost(self.row_words) + cc), self.work)))
        return _cdiv(rows, _unit_rows(rows, s))

    def units_in_use(self, counts, rows: int) -> int:
        """Units the grouping pass lays out for `counts` (M + 1,): the
        pairs that visit each block, the last entry the virtual block's
        (ids outside [0, M), one range a tile)."""
        qb = _QW * self.warps
        return sum(_cdiv(c, qb) * (1 if g == len(counts) - 1
                                   else self.ranges(c, rows))
                   for g, c in enumerate(int(c) for c in counts) if c)

    def range_rows(self, rows: int, ranges: int) -> int:
        """Rows of each range of a tile cut in `ranges`."""
        return _unit_rows(rows, ranges)

    def scratch(self, b: int, k: int) -> tuple[int, int]:
        """Keys of the two merge scratch buffers (ping and pong): a merge
        block takes MERGE_KEYS / pow2(k) lists."""
        group = _MERGE_KEYS // (1 << (k - 1).bit_length())
        return (b * self.lists * k, b * max(1, _cdiv(self.lists, group)) * k)

    def group_words(self, b: int, p: int, m: int) -> int:
        """int32 words of the grouping pass's scratch: the unit table (4 a
        unit), each block's count and cursor, the grouped pairs, each
        query's list count, the units in use."""
        return 4 * self.units + 2 * (m + 1) + b * p + b + 1


def shortlist_blocks_plan(b: int, p: int, m: int, rows: int, row_words: int,
                          k: int, mma: bool) -> BlocksPlan:
    """The block-table entry's cut for B queries visiting p of M blocks of
    `rows` rows of `row_words` 32-bit words. Up to 4 warps while shared
    memory fits one block; the K-chunk is the row (two stages) when it
    fits CHUNK_MAX words, else CHUNK_MAX words in three. A block's pairs
    fill ceil(pairs / qb) tiles, so every mix needs at most ceil(B p / qb)
    + min(M + 1, B p) tiles (the + 1: the virtual block of ids outside
    [0, M)). A unit costs its rows x (row cost + pairs); `work` spreads a
    mix's typical cost (half the blocks' tiles partial) over
    _BLOCKS_WAVES (_BLOCKS_WAVES_CHUNKED) waves of units, and the units of
    any mix stay below
    floor(rows (row cost x tiles + 2 B p) / work) + tiles."""
    pairs = b * p
    keys = max(128, 2 * (1 << (k - 1).bit_length()))
    chunk = min(8 * _cdiv(row_words, 8), _CHUNK_MAX)
    stages = 2 if chunk >= row_words else _BLOCKS_STAGES_CHUNKED
    most = 4 if pairs > 2 * _QW else (2 if pairs > _QW else 1)
    for warps in (4, 2, 1):
        smem = _blocks_smem(warps, keys, row_words, chunk, stages, mma)
        if warps <= most and smem <= _BLOCKS_SMEM_MAX:
            break
    else:
        raise ValueError(f"lut_shortlist_blocks: k={k} with {row_words}-word "
                         f"rows leaves no shared memory for one pair tile")
    qb = warps * _QW
    alpha = _row_cost(row_words)
    per_sm = min(2048 // (32 * warps),
                 _SM_SMEM // (smem + _BLOCKS_STATIC + 1024))
    waves = _BLOCKS_WAVES if stages == 2 else _BLOCKS_WAVES_CHUNKED
    target = max(1, int(per_sm * _SMS * waves))
    typical = _cdiv(pairs, qb) + min(m + 1, pairs) // 2
    work = max(1, _cdiv(rows * (alpha * typical + pairs), target))
    s = min(_cdiv(rows, _ROWS), _cdiv(rows * (alpha + qb), work))
    split = _cdiv(rows, _unit_rows(rows, s))
    tiles = _cdiv(pairs, qb) + min(m + 1, pairs)
    units = min(tiles * split,
                rows * (alpha * tiles + 2 * pairs) // work + tiles)
    return BlocksPlan(warps=warps, keys=keys, chunk=chunk, stages=stages,
                      row_words=row_words, work=work, split=split,
                      tiles=tiles, units=units, lists=p * split, smem=smem,
                      ctas_per_sm=per_sm, mma=mma)


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
    (and k <= MAX_K on the card). A CPU or meta tensor runs the plain
    version; a CUDA tensor launches the kernel (or raises)."""
    n = _check_args(q_words, s_proj, k, packed, pack_bits)
    operand = packed if packed is not None else s_proj
    B, d = q_words.shape

    def shapes():
        return dict(b=B, n=n, d=d, k=k, masked=valid is not None,
                    row_words=_row_words(d, s_proj, packed))
    with _build.profiler_range(FUSED_TAG):
        if _build.off_card(q_words, operand):
            return _build.plain_route("shortlist", shapes, lambda: (
                lut_shortlist_plain(q_words, s_proj, k, valid=valid,
                                    packed=packed, pack_bits=pack_bits)))
        return _shortlist_cuda(q_words, s_proj, k, valid, packed, pack_bits,
                               n, shapes)


def _row_words(d: int, s_proj, packed) -> int:
    """32-bit words a row of the operand the kernel streams."""
    if packed is not None:
        return packed.shape[-1]
    return d * s_proj.element_size()


def _shortlist_cuda(q_words, s_proj, k, valid, packed, pack_bits, n,
                    shapes):
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
    _build.count_launch("shortlist", shapes)
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

    A CPU or meta tensor runs the plain version; a CUDA tensor launches
    the grouping, select and merge passes of csrc/shortlist.cu (or
    raises). An
    id outside [0, M) reads nothing on the card (its lists hold the
    all-ones key) and raises in the plain version."""
    m, rows = _check_blocks(q_words, s_proj, k, base, ids, valid, packed,
                            pack_bits)
    operand = packed if packed is not None else s_proj

    def shapes():
        inside = ids[(ids >= 0) & (ids < m)]
        return dict(b=ids.shape[0], d=q_words.shape[1], p=ids.shape[1], m=m,
                    rows=rows, k=k, row_words=_row_words(
                        q_words.shape[1], s_proj, packed),
                    visited=None if ids.device.type == "meta"
                    else int(torch.unique(inside).numel()))
    with _build.profiler_range(FUSED_TAG):
        if _build.off_card(q_words, operand):
            return _build.plain_route("shortlist_blocks", shapes, lambda: (
                lut_shortlist_blocks_plain(q_words, s_proj, k, base=base,
                                           ids=ids, valid=valid,
                                           packed=packed,
                                           pack_bits=pack_bits)))
        return _blocks_cuda(q_words, s_proj, k, base, ids, valid, packed,
                            pack_bits, m, rows, shapes)


def _blocks_cuda(q_words, s_proj, k, base, ids, valid, packed, pack_bits, m,
                 rows, shapes):
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
    # ids are read as int64 and a bool mask as bytes: no conversion where
    # they come so
    tensors = [q, words, base.to(device=dev, dtype=torch.int64).contiguous(),
               ids.to(device=dev, dtype=torch.int64).contiguous()]
    if valid is not None:
        tensors.append(valid.contiguous().view(torch.uint8)
                       if valid.dtype == torch.bool
                       else valid.to(torch.uint8).contiguous())
    _build.require_cuda("lut_shortlist_blocks", *tensors)
    plan = shortlist_blocks_plan(B, p, m, rows, row_words, k,
                                 kind == _KIND_PACKED and bits == 8)
    group = torch.empty(plan.group_words(B, p, m), dtype=torch.int32,
                        device=dev)
    bounds = torch.empty(B * (1 + _SLOTS), dtype=torch.int64, device=dev)
    scratch_a, scratch_b, keys = _scratch_keys(dev, plan.scratch(B, k), B, k)
    lib = _load()
    ints = (B, m, rows, d, p, k, plan.warps, plan.keys, plan.chunk,
            plan.stages, plan.work, plan.split, plan.tiles, plan.units)
    err = lib.shortlist_blocks_launch(
        _build.ptr(q), _build.ptr(words), ctypes.c_int(kind),
        ctypes.c_int(bits), ctypes.c_int(row_words),
        _build.ptr(tensors[4]) if valid is not None else ctypes.c_void_p(0),
        _build.ptr(tensors[2]), _build.ptr(tensors[3]),
        *(ctypes.c_int(v) for v in ints),
        _build.ptr(group), _build.ptr(bounds), _build.ptr(scratch_a),
        _build.ptr(scratch_b), _build.ptr(keys), _build.stream_ptr(dev))
    _build.check(lib, err, "shortlist_blocks_launch")
    _build.count_launch("shortlist_blocks", shapes)
    return split_keys(keys)
