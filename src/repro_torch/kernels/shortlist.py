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

The CUDA kernel is `csrc/shortlist.cu`. For 8-bit packed fields (every
MTMC and CUB store) its one-table entry runs the one-hot products on the
tensor cores, in one of two selects chosen from k and the row's width
(`wgmma_route`): at k <= 64 with rows of whole 16-byte segments (the main
path's), persistent blocks of 128 queries take rows through a TMA ring
into `wgmma` products; otherwise blocks of up to 64 queries (16 a warp)
stream rows through a `cp.async` ring into `mma.sync` products. Either
way each query keeps a running top-k that sorts only the rows below its
k-th key, and merge rounds fold the slices. `shortlist_plan` cuts both,
once per shape; each select's launches are counted under its own name
(`_build.SELECT_PATHS`). Other operand kinds take the block-table entry
as one block of N rows that every query visits. `lut_shortlist_plain` is
the plain version. Every route selects
on one int64 key per candidate, uint64(dist) << 32 | row (the select
packs it in 32 bits while it works), which is exact because dist +
penalty < 2**24, so the result never depends on how a sort orders equal
values.

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
import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"shortlist_launch": [_P, _P, _I, _P] + [_I] * 10 + [_P] * 5,
               "shortlist_wgmma_launch": [_P, _P, _I, _P] + [_I] * 8
                                         + [_P] * 5,
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
_ROWS = 64              # rows per staged tile
_QW = 4                 # pairs per warp of the block-table select
_SM_SMEM = 233472       # shared memory of one H100 SM
_SMS = 132              # SMs of an H100
_BLOCK_SMEM = 232448    # shared memory one H100 block may use
# the one-table select (csrc/shortlist.cu shortlist_select): queries a warp
# (the MMA's M), no static shared memory, the widest row (words) staged
# whole with the block's masks resident, and the K-chunk words and ring
# depth of wider rows (launch/time_blocks.py --variants times them)
_TQ = 16
_SELECT_STATIC = 0
_SMEM_MAX = _BLOCK_SMEM - _SELECT_STATIC
_WHOLE_MAX = 64
_ONE_CHUNK = 32
_ONE_STAGES = 2
# a compact key of the one-table select: the penalty bit, the distance
# and the row within its slice in 32 bits; the penalty stays above any
# distance of 8-bit fields while 255 d < 2**22
_KEY_BITS = 31
_PENALTY_BITS = 22
# the wgmma select (csrc/shortlist.cu shortlist_wgmma), for k up to a
# list's sorted keys and rows of whole 16-byte segments: blocks of 128
# queries (two warpgroups of wgmma's M = 64) and a producer warp, one an
# SM, walking (query tile, slice) units; tiles of 128 rows (wgmma's N)
# where a row is at most 3 TMA box columns of 64 bytes (the masks then
# resident), else of 256 rows in 64-byte K-columns beside the masks';
# lists of 64 sorted keys and 128 candidate slots; a ring of _WG_STAGES
# slots; the units cut so that the last round leaves at most _WG_IDLE of
# the SMs idle (launch/time_blocks.py --variants times the constants)
_WG_KMAX = 64
_WG_QB = 128
_WG_WARPS = 8
_WG_N = 128
_WG_BOX = 64
_WG_WHOLE_BOXES = 3
_WG_KEYS = 64 + 128
_WG_STAGES = 4
_WG_IDLE = 0.05


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _keys(k: int) -> int:
    """Keys a list of either select: sorted H = P / 2 >= max(k, 64) and as
    many candidate slots, P a power of two."""
    return max(2 * _ROWS, 2 * (1 << (k - 1).bit_length()))


def _select_smem(warps: int, keys: int, row_words: int, chunk: int,
                 stages: int) -> int:
    """Dynamic shared memory of one one-table select block
    (csrc/shortlist.cu select_smem): `keys` 32-bit keys a query, a ring of
    `stages` slots of 64 staged rows (with the block's masks of the same
    words for K-chunked rows), and whole rows' masks once beside the
    ring."""
    qb = _TQ * warps
    whole = chunk >= row_words
    return (qb * keys * 4 + 4 * _blocks_stride(chunk)
            * (stages * (_ROWS + (0 if whole else qb)) + (qb if whole else 0)))


def wgmma_route(row_words: int, k: int) -> bool:
    """Whether a tensor-core one-table call takes the wgmma select (k up
    to a list's 64 sorted keys, rows of whole 16-byte segments, which the
    TMA boxes need) rather than the mma.sync one: a choice of shared
    memory and layout, from k and the row's width alone."""
    return k <= _WG_KMAX and row_words % 4 == 0


def _wgmma_smem(whole: bool, stages: int) -> int:
    """Dynamic shared memory of one wgmma select block (csrc/shortlist.cu
    wg_smem): a ring of `stages` 1 KB aligned slots (whole rows: the
    tile's 128 rows in 3 columns of 64 bytes, zeros past a narrower row;
    else one 64-byte column of the 128 masks and of the tile's 256 rows;
    then the tile's valid bytes), whole rows' masks beside it, 128 lists
    of _WG_KEYS keys, the mbarriers, and 1 KB to align the base."""
    data = (3 * _WG_N if whole else _WG_QB + 2 * _WG_N) * _WG_BOX
    stage = _cdiv(data + (_WG_N if whole else 2 * _WG_N), 1024) * 1024
    masks = 3 * _WG_QB * _WG_BOX if whole else 0
    return (stages * stage + masks + _WG_QB * _WG_KEYS * 4
            + (2 * stages + 2) * 8 + 1024)


@dataclass(frozen=True)
class ShortlistPlan:
    """How csrc/shortlist.cu's one-table select cuts one call (8-bit
    packed fields). `path`: "wgmma" (`wgmma_route`) or "mma". Blocks of
    `warps` warps of 16 queries (the wgmma select's consumer warps), `keys`
    = sorted keys + candidate slots a query (32-bit compact keys), rows
    staged `tile_rows` at a time in K-chunks of `chunk` words (the whole
    row, padded to 8 words on the mma path; the mma path's masks resident
    when the row fits _WHOLE_MAX, the wgmma path's when `chunk` is the
    row: `whole`) through a ring of `stages`, `smem` bytes of dynamic
    shared memory a block and `ctas_per_sm` blocks an SM at it, `slice_rows`
    rows a unit in `slices` slices, `blocks` persistent blocks walking
    the (query tile, slice) units, and `mask_words` words of each query's
    mask in the scratch."""
    path: str
    warps: int
    keys: int
    chunk: int
    whole: bool
    stages: int
    tile_rows: int
    slice_rows: int
    slices: int
    blocks: int
    smem: int
    ctas_per_sm: int
    mask_words: int

    @property
    def queries(self) -> int:
        """Queries a select block."""
        return _TQ * self.warps

    def units(self, b: int) -> int:
        """(query tile, slice) units of B queries."""
        return _cdiv(b, self.queries) * self.slices

    def scratch(self, b: int, k: int) -> tuple[int, int]:
        """Keys of the two merge scratch buffers (ping and pong): a merge
        block takes MERGE_KEYS / pow2(k) lists."""
        group = _MERGE_KEYS // (1 << (k - 1).bit_length())
        return (b * self.slices * k,
                b * max(1, _cdiv(self.slices, group)) * k)


def _max_slice_rows(row_words: int) -> int:
    """The most rows a slice may have: a compact key holds the penalty
    bit, a distance of up to 255 d (d <= row_words for 8-bit fields) and
    the row within the slice, and a real key is never all ones."""
    return 1 << (_KEY_BITS - (255 * row_words + 1).bit_length())


def _persistent_units(b: int, n: int, row_words: int, queries: int,
                      tile: int, slots: int) -> tuple[int, int]:
    """(slice_rows, slices) of the wgmma select: slices of whole tiles,
    at most `_max_slice_rows` rows and at least one tile each; the fewest
    whose (query tile, slice) units leave at most _WG_IDLE of the `slots`
    resident blocks idle in the last round, else the least idle."""
    tiles_q = _cdiv(b, queries)
    lo = _cdiv(n, _max_slice_rows(row_words) // tile * tile)
    hi = min(max(lo, _cdiv(n, tile)), lo + 2 * slots)
    best = None
    for s in range(lo, hi + 1):
        rows = tile * _cdiv(_cdiv(n, s), tile)
        slices = _cdiv(n, rows)
        units = tiles_q * slices
        idle = _cdiv(units, slots) * slots - units
        if best is None or idle < best[0]:
            best = (idle, rows, slices)
        if idle <= _WG_IDLE * slots:
            break
    return best[1], best[2]


@functools.lru_cache(maxsize=256)
def shortlist_plan(b: int, n: int, row_words: int, k: int) -> ShortlistPlan:
    """The one-table select's cut for B queries over N rows of `row_words`
    words of 8-bit fields (255 row_words < 2**22), computed once per
    shape. The wgmma path (`wgmma_route`): one block an SM, the row whole
    where it fits _WG_WHOLE_BOXES columns of 64 bytes and the block's
    shared memory, and the units cut by `_persistent_units`. The mma
    path: up to 4 warps (no more than the queries fill) while the block's
    shared memory fits; then slices of whole 64-row tiles, each at least k
    rows and at most `_max_slice_rows`, so that the query tiles x the
    slices fill the 132 SMs once at the occupancy shared memory allows (a
    block's shared memory and the runtime's 1 KB); where the key's row
    bits need more slices, the blocks of that wave walk the rest."""
    if 255 * row_words >= 1 << _PENALTY_BITS:
        raise ValueError(f"lut_shortlist: distances over {row_words} words "
                         f"of 8-bit fields reach the mask penalty")
    mask_words = 8 * _cdiv(row_words, 8)
    if wgmma_route(row_words, k):
        whole = _cdiv(4 * row_words, _WG_BOX) <= _WG_WHOLE_BOXES and \
            _wgmma_smem(True, _WG_STAGES) <= _SMEM_MAX
        smem = _wgmma_smem(whole, _WG_STAGES)
        tile = _WG_N if whole else 2 * _WG_N
        slots = _SMS * (_SM_SMEM // (smem + 1024))
        slice_rows, slices = _persistent_units(b, n, row_words, _WG_QB,
                                               tile, slots)
        return ShortlistPlan(
            path="wgmma", warps=_WG_WARPS, keys=_WG_KEYS,
            chunk=row_words if whole else _WG_BOX // 4, whole=whole,
            stages=_WG_STAGES,
            tile_rows=tile, slice_rows=slice_rows, slices=slices,
            blocks=min(_cdiv(b, _WG_QB) * slices, slots), smem=smem,
            ctas_per_sm=slots // _SMS, mask_words=mask_words)
    keys = _keys(k)
    whole = row_words <= _WHOLE_MAX
    chunk = mask_words if whole else _ONE_CHUNK
    stages = _ONE_STAGES
    most = min(4, _cdiv(b, _TQ))
    for warps in (4, 2, 1):
        smem = _select_smem(warps, keys, row_words, chunk, stages)
        if warps <= most and smem <= _SMEM_MAX:
            break
    else:
        raise ValueError(f"lut_shortlist: k={k} with {row_words}-word rows "
                         f"leaves no shared memory for one select block")
    per_sm = min(2048 // (32 * warps),
                 _SM_SMEM // (smem + _SELECT_STATIC + 1024))
    tiles = _cdiv(b, _TQ * warps)
    slices = max(1, min(_cdiv(n, max(_ROWS, k)), per_sm * _SMS // tiles),
                 _cdiv(n, _max_slice_rows(row_words)))
    slice_rows = _ROWS * _cdiv(_cdiv(n, slices), _ROWS)
    slices = _cdiv(n, slice_rows)
    return ShortlistPlan(path="mma", warps=warps, keys=keys, chunk=chunk,
                         whole=whole, stages=stages, tile_rows=_ROWS,
                         slice_rows=slice_rows, slices=slices,
                         blocks=min(tiles * slices, per_sm * _SMS),
                         smem=smem, ctas_per_sm=per_sm,
                         mask_words=mask_words)


def tensor_core_route(kind: int, bits: int, row_words: int) -> bool:
    """Whether a one-table call takes a tensor-core select (8-bit packed
    fields whose distances stay below the penalty, 255 row_words < 2**22)
    rather than the block-table entry."""
    return (kind == _KIND_PACKED and bits == 8
            and 255 * row_words < 1 << _PENALTY_BITS)


# the block-table entry (csrc/shortlist.cu): pairs a unit at most (the
# MMA's M), words a pair of the distance tile, bound slots a query, words
# of a staged K-chunk at most, and its select pass's static shared memory
_BQ = 4 * _QW
_DSTRIDE = 72
_SLOTS = 32
_CHUNK_MAX = 64
_BLOCKS_STATIC = _BQ * (4 + 8 + 4 + 4)
_BLOCKS_SMEM_MAX = _BLOCK_SMEM - _BLOCKS_STATIC
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
    keys = _keys(k)
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


def _split_words(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`split_keys` for keys whose rows are below 2**31 (the one-table
    entry's: rows of an N < 2**31 table), through the keys' two int32
    words: two copies, one launch each on the card, the same arrays."""
    words = keys.view(torch.int32).view(*keys.shape, 2)
    return words[..., 1].to(torch.float32), words[..., 0].to(torch.int64)


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
                    row_words=_row_words(d, s_proj, packed),
                    bits=_field_bits(s_proj, pack_bits))
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


def _field_bits(s_proj, pack_bits) -> int:
    """Bits of one LUT entry of the operand: its packed fields', else its
    dtype's."""
    return pack_bits if s_proj is None else 8 * s_proj.element_size()


def _valid_bytes(valid: torch.Tensor) -> torch.Tensor:
    """A row mask as the kernels read it: one byte a row, a bool mask
    viewed as bytes without a copy."""
    return (valid.contiguous().view(torch.uint8) if valid.dtype == torch.bool
            else valid.to(torch.uint8).contiguous())


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
    dev = q_words.device
    q = q_words.to(torch.int32).contiguous()
    kind, bits, words = _operand_words(s_proj, packed, pack_bits)
    words = words.contiguous()
    row_words = words.shape[1]
    valid_u8 = None
    if valid is not None:
        if valid.shape != (n,):
            raise ValueError(f"lut_shortlist: valid {tuple(valid.shape)} "
                             f"for N={n}")
        valid_u8 = _valid_bytes(valid)
    _build.require_cuda("lut_shortlist", q, words,
                        *([] if valid_u8 is None else [valid_u8]))
    if not tensor_core_route(kind, bits, row_words):
        # one block of N rows that every query visits: the same keys
        keys = _blocks_keys(
            q, words.reshape(1, n, row_words), kind, bits,
            None if valid_u8 is None else valid_u8.reshape(1, n),
            torch.zeros(1, dtype=torch.int64, device=dev),
            torch.zeros(B, 1, dtype=torch.int64, device=dev), k)
        _build.count_launch("shortlist", shapes)
        return split_keys(keys)
    plan = shortlist_plan(B, n, row_words, k)
    # the masks, and on the wgmma path each query's shared bound
    masks = torch.empty(B * (plan.mask_words + (plan.path == "wgmma")),
                        dtype=torch.int32, device=dev)
    scratch_a, scratch_b, keys = _scratch_keys(dev, plan.scratch(B, k), B, k)
    lib = _load()
    if plan.path == "wgmma":
        # the TMA boxes read from 16-byte aligned addresses
        words, valid_u8 = (t if t is None or t.data_ptr() % 16 == 0
                           else t.clone() for t in (words, valid_u8))
        entry = "shortlist_wgmma_launch"
        ints = (B, n, d, k, int(plan.whole), plan.stages, plan.slice_rows,
                plan.blocks)
    else:
        entry = "shortlist_launch"
        ints = (B, n, d, k, plan.warps, plan.keys, plan.chunk, plan.stages,
                plan.slice_rows, plan.blocks)
    err = getattr(lib, entry)(
        _build.ptr(q), _build.ptr(words), ctypes.c_int(row_words),
        _build.ptr(valid_u8) if valid_u8 is not None else ctypes.c_void_p(0),
        *(ctypes.c_int(v) for v in ints), _build.ptr(masks),
        _build.ptr(scratch_a), _build.ptr(scratch_b), _build.ptr(keys),
        _build.stream_ptr(dev))
    _build.check(lib, err, entry)
    _build.count_launch("shortlist", shapes)
    _build.count_launch(f"shortlist_{plan.path}")
    return _split_words(keys)


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
                    bits=_field_bits(s_proj, pack_bits),
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
    # ids are read as int64 and a bool mask as bytes: no conversion where
    # they come so
    keys = _blocks_keys(
        q, words.contiguous(), kind, bits,
        None if valid is None else _valid_bytes(valid),
        base.to(device=dev, dtype=torch.int64).contiguous(),
        ids.to(device=dev, dtype=torch.int64).contiguous(), k)
    _build.count_launch("shortlist_blocks", shapes)
    return split_keys(keys)


def _blocks_keys(q, words, kind, bits, valid_u8, base, ids, k):
    """The block-table entry's (B, k) keys: q (B, d) int32, words (M,
    rows, row_words) 32-bit words of the operand, valid_u8 (M, rows) or
    None, base (M,) and ids (B, p) int64, all contiguous on one card."""
    B, d = q.shape
    p = ids.shape[1]
    m, rows, row_words = words.shape
    dev = q.device
    tensors = [q, words, base, ids] + ([] if valid_u8 is None
                                       else [valid_u8])
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
        _build.ptr(valid_u8) if valid_u8 is not None else ctypes.c_void_p(0),
        _build.ptr(base), _build.ptr(ids),
        *(ctypes.c_int(v) for v in ints),
        _build.ptr(group), _build.ptr(bounds), _build.ptr(scratch_a),
        _build.ptr(scratch_b), _build.ptr(keys), _build.stream_ptr(dev))
    _build.check(lib, err, "shortlist_blocks_launch")
    return keys
