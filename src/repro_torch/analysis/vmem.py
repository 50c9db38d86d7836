"""Shared-memory and register budget model of the shortlist kernel
(counterpart of `repro.analysis.vmem`, the Pallas kernel's VMEM model).

On Hopper the shortlist (`csrc/shortlist.cu`) keeps its working set in
shared memory, sized on the host by the plans of `kernels/shortlist.py`.
The one-table entry (8-bit fields on the tensor cores) has two selects,
chosen from k and the row's width (`shortlist.wgmma_route`). A wgmma
select block (two consumer warpgroups of 64 queries and a producer warp,
one block an SM) holds

    keys     128 x keys x 4 B   each query's 64 sorted keys and 128
             candidate slots, 32 for each lane of its quad (32-bit compact
             keys)
    masks    3 x 128 x 64 B, once a unit, for whole rows (up to 3 TMA
             columns of 64 bytes); wider rows carry theirs in the ring
    stages   stages x slot   1 KB aligned TMA slots: 128 rows x 3 columns
             (whole) or one column of the 128 masks and 256 rows, then
             the tile's valid bytes
    tile     (2 stages + 2) x 8 B of mbarriers and 1 KB to align the base

and an mma.sync select block of `warps` warps of 16 queries

    keys     warps x 16 x keys x 4 B   each query's top-k and candidates
             (32-bit compact keys)
    masks    warps x 16 x blocks_stride(chunk) x 4 B, once for a whole
             row (chunk >= row words), else once a ring slot: the
             queries' one-hot mask words of the staged K-chunk
    stages   stages x 64 x blocks_stride(chunk) x 4 B   the ring's rows

and a block-table select block (one unit: up to 16 (query, visit) pairs)

    keys     warps x 4 x keys x 8 B
    masks    (16 if mma else 4 warps) x blocks_stride(row_words) x 4 B
    stages   stages x 64 x blocks_stride(chunk) x 4 B   the K-chunk ring
    tile     16 x 72 x 4 B (mma only)   the tensor cores' distance tile

plus each kernel's static shared memory (none for the one-table select;
`BLOCKS_STATIC_SMEM` of csrc/shortlist.cu). `shortlist_smem` and
`blocks_smem` are these closed forms, with the plans' own choice of
warps, keys, chunk and stages; they equal the plans exactly
(tests/test_torch_vmem.py), and the static part equals what ptxas
reports (chip_smoke.py's `[vmem]` lines, which also hold the wgmma
select's block of 288 threads within one SM's registers).

`validate_config` is the static gate: a plan's total against one
block's 227 KB and the blocks an SM runs at the plan's occupancy against
its 228 KB (H100), and, when the kernel's registers a thread are given,
that occupancy against the SM's 64 K registers. Its consumer is
`launch/time_blocks.py --variants` (the counterpart of the reference's
`benchmarks/autotune_shortlist.py`, which is not ported), which rejects
an over-budget variant before timing it.

No counterpart, by design (the TPU's names): `TPU_VMEM_BYTES`,
`SORT_LIVE_PAIRS`, `VmemEstimate`, `shortlist_vmem`, and
`validate_config`'s Pallas tile arguments (`tile_b`, `tile_n`, `k`,
`width`, `k_pad`, `pack_bits`, `q_dtype_bytes`, `masked`, `use_network`,
`budget_bytes`); it takes a plan of `kernels/shortlist.py`.
"""

from __future__ import annotations

import dataclasses

from repro_torch.kernels import shortlist as sl

#: shared memory one H100 block may use (opt-in maximum), bytes
H100_BLOCK_SMEM = 227 * 1024
#: shared memory of one H100 SM, bytes
H100_SM_SMEM = 228 * 1024
#: 32-bit registers of one H100 SM
H100_SM_REGS = 64 * 1024
#: threads one H100 SM runs at most
H100_SM_THREADS = 2048
#: shared memory the runtime reserves a block, bytes
BLOCK_RESERVED_SMEM = 1024
#: static shared memory of the select kernels (csrc/shortlist.cu): none
#: for the one-table select; a pair slot's query, list, bound slot and
#: shared-bound flag (4 + 8 + 4 + 4 B) for the block-table select
SELECT_STATIC_SMEM = sl._SELECT_STATIC
BLOCKS_STATIC_SMEM = sl._BLOCKS_STATIC


@dataclasses.dataclass(frozen=True)
class SmemEstimate:
    """The shared memory of one select block of a plan: its parts, the
    dynamic bytes the launch asks for, the static bytes, their total,
    and the blocks an SM runs at the plan's occupancy."""
    entry: str                 # "select_wgmma" | "select" | "blocks_select"
    warps: int
    keys: int
    chunk: int                 # words of a staged K-chunk of a row
    stages: int
    key_bytes: int
    mask_bytes: int
    stage_bytes: int
    tile_bytes: int
    dynamic_bytes: int
    static_bytes: int
    total_bytes: int
    ctas_per_sm: int

    @property
    def threads(self) -> int:
        """A block's threads: its warps, and the wgmma select's producer
        warp."""
        return 32 * (self.warps + (self.entry == "select_wgmma"))


@dataclasses.dataclass(frozen=True)
class ConfigCheck:
    """Verdict of `validate_config`: ok, the estimate, the budgets it was
    held against and a reason when not ok."""
    ok: bool
    estimate: SmemEstimate
    block_budget: int
    sm_budget: int
    reason: str


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _occupancy(warps: int, total: int) -> int:
    """Select blocks an SM runs: by threads (`warps` a block), and by
    shared memory (a block's dynamic and static bytes and the runtime's
    reserve)."""
    return min(H100_SM_THREADS // (32 * warps),
               H100_SM_SMEM // (total + BLOCK_RESERVED_SMEM))


def _wgmma_parts(whole: bool, stages: int) -> tuple[int, ...]:
    """(keys, masks, stages, tile) bytes of a wgmma select block."""
    data = sl._WG_BOX * (3 * sl._WG_N if whole
                         else sl._WG_QB + 2 * sl._WG_N)
    slot = _cdiv(data + (sl._WG_N if whole else 2 * sl._WG_N), 1024) * 1024
    return (sl._WG_QB * sl._WG_KEYS * 4,
            3 * sl._WG_QB * sl._WG_BOX if whole else 0,
            stages * slot, (2 * stages + 2) * 8 + 1024)


def wgmma_smem(b: int, n: int, row_words: int, k: int,
               stages: int | None = None) -> SmemEstimate:
    """The wgmma select block of `shortlist_plan(b, n, row_words, k)`
    (its ring's depth unless given): the row whole where it fits
    _WG_WHOLE_BOXES columns of 64 bytes and the block, else in 64-byte
    K-columns."""
    stages = sl._WG_STAGES if stages is None else stages
    whole = (_cdiv(4 * row_words, sl._WG_BOX) <= sl._WG_WHOLE_BOXES
             and sum(_wgmma_parts(True, stages)) + SELECT_STATIC_SMEM
             <= H100_BLOCK_SMEM)
    key_b, mask_b, stage_b, tile_b = _wgmma_parts(whole, stages)
    dynamic = key_b + mask_b + stage_b + tile_b
    return SmemEstimate(
        entry="select_wgmma", warps=sl._WG_WARPS, keys=sl._WG_KEYS,
        chunk=row_words if whole else sl._WG_BOX // 4, stages=stages,
        key_bytes=key_b, mask_bytes=mask_b, stage_bytes=stage_b,
        tile_bytes=tile_b, dynamic_bytes=dynamic,
        static_bytes=SELECT_STATIC_SMEM,
        total_bytes=dynamic + SELECT_STATIC_SMEM,
        ctas_per_sm=_occupancy(sl._WG_WARPS + 1,
                               dynamic + SELECT_STATIC_SMEM))


def _stride(words: int) -> int:
    """Words a staged row or mask takes (csrc/shortlist.cu
    blocks_stride)."""
    return 8 * _cdiv(words, 8) + 4


def _select_parts(warps: int, keys: int, row_words: int, chunk: int,
                  stages: int) -> tuple[int, ...]:
    queries = warps * sl._TQ
    stride = _stride(chunk)
    whole = chunk >= row_words
    return (queries * keys * 4,
            queries * stride * 4 * (1 if whole else stages),
            stages * sl._ROWS * stride * 4)


def shortlist_smem(b: int, n: int, row_words: int, k: int,
                   warps: int | None = None, chunk: int | None = None,
                   stages: int | None = None) -> SmemEstimate:
    """The one-table select block of `shortlist_plan(b, n, row_words, k)`:
    the wgmma select's (`wgmma_smem`, its stages unless given) where the
    plan takes it, else the mma.sync select's (its warps, chunk and
    stages unless given): keys = max(128, 2 pow2(k)); a row of up to the
    plan's _WHOLE_MAX words staged whole (padded to 8 words) with the
    masks resident, a wider one in K-chunks of _ONE_CHUNK words through
    _ONE_STAGES slots; up to 4 warps of 16 queries, no more than the
    queries fill, while the block fits."""
    if sl.wgmma_route(row_words, k):
        return wgmma_smem(b, n, row_words, k, stages)
    keys = max(128, 2 * (1 << (k - 1).bit_length()))
    if chunk is None:
        chunk = (8 * _cdiv(row_words, 8) if row_words <= sl._WHOLE_MAX
                 else sl._ONE_CHUNK)
    stages = sl._ONE_STAGES if stages is None else stages
    budget = H100_BLOCK_SMEM - SELECT_STATIC_SMEM
    if warps is None:
        most = min(4, _cdiv(b, sl._TQ))
        warps = next((w for w in (4, 2, 1) if w <= most and sum(
            _select_parts(w, keys, row_words, chunk, stages)) <= budget),
            None)
        if warps is None:
            raise ValueError(f"shortlist_smem: k={k} leaves no one-table "
                             f"select block")
    key_b, mask_b, stage_b = _select_parts(warps, keys, row_words, chunk,
                                           stages)
    dynamic = key_b + mask_b + stage_b
    return SmemEstimate(
        entry="select", warps=warps, keys=keys, chunk=chunk, stages=stages,
        key_bytes=key_b, mask_bytes=mask_b, stage_bytes=stage_b,
        tile_bytes=0, dynamic_bytes=dynamic,
        static_bytes=SELECT_STATIC_SMEM,
        total_bytes=dynamic + SELECT_STATIC_SMEM,
        ctas_per_sm=_occupancy(warps, dynamic + SELECT_STATIC_SMEM))


def _blocks_parts(warps: int, keys: int, row_words: int, chunk: int,
                  stages: int, mma: bool) -> tuple[int, ...]:
    return (warps * sl._QW * keys * 8,
            (sl._BQ if mma else warps * sl._QW) * _stride(row_words) * 4,
            stages * sl._ROWS * _stride(chunk) * 4,
            sl._BQ * sl._DSTRIDE * 4 if mma else 0)


def blocks_smem(b: int, p: int, m: int, rows: int, row_words: int, k: int,
                mma: bool, *, chunk_max: int | None = None,
                stages_chunked: int | None = None) -> SmemEstimate:
    """The block-table select block of `shortlist_blocks_plan(b, p, m,
    rows, row_words, k, mma)`: the K-chunk is the row (two stages) when it
    fits `chunk_max` words (default the plan's _CHUNK_MAX), else
    `chunk_max` words in `stages_chunked` stages; up to 4 warps as the
    pairs allow while the block fits."""
    chunk_max = sl._CHUNK_MAX if chunk_max is None else chunk_max
    stages_chunked = (sl._BLOCKS_STAGES_CHUNKED if stages_chunked is None
                      else stages_chunked)
    pairs = b * p
    keys = max(128, 2 * (1 << (k - 1).bit_length()))
    chunk = min(8 * _cdiv(row_words, 8), chunk_max)
    stages = 2 if chunk >= row_words else stages_chunked
    most = 4 if pairs > 2 * sl._QW else (2 if pairs > sl._QW else 1)
    budget = H100_BLOCK_SMEM - BLOCKS_STATIC_SMEM
    for warps in (4, 2, 1):
        parts = _blocks_parts(warps, keys, row_words, chunk, stages, mma)
        if warps <= most and sum(parts) <= budget:
            break
    key_b, mask_b, stage_b, tile_b = parts
    dynamic = sum(parts)
    return SmemEstimate(
        entry="blocks_select", warps=warps, keys=keys, chunk=chunk,
        stages=stages, key_bytes=key_b, mask_bytes=mask_b,
        stage_bytes=stage_b, tile_bytes=tile_b, dynamic_bytes=dynamic,
        static_bytes=BLOCKS_STATIC_SMEM,
        total_bytes=dynamic + BLOCKS_STATIC_SMEM,
        ctas_per_sm=_occupancy(warps, dynamic + BLOCKS_STATIC_SMEM))


def validate_config(est: SmemEstimate, *,
                    block_budget: int = H100_BLOCK_SMEM,
                    sm_budget: int = H100_SM_SMEM,
                    regs_per_thread: int | None = None,
                    sm_regs: int = H100_SM_REGS) -> ConfigCheck:
    """Static accept / reject of a plan's select block: its total shared
    memory within `block_budget`, the `ctas_per_sm` blocks the plan
    assumes (each with the runtime's reserve) within `sm_budget`, and,
    with `regs_per_thread` (ptxas's count), those blocks' threads within
    `sm_regs` registers."""
    reasons = []
    if est.total_bytes > block_budget:
        reasons.append(f"{est.total_bytes} B of shared memory a block "
                       f"exceeds {block_budget} B (keys {est.key_bytes}, "
                       f"masks {est.mask_bytes}, stages {est.stage_bytes},"
                       f" tile {est.tile_bytes}, static "
                       f"{est.static_bytes})")
    per_sm = est.ctas_per_sm * (est.total_bytes + BLOCK_RESERVED_SMEM)
    if est.ctas_per_sm < 1 or per_sm > sm_budget:
        reasons.append(f"{est.ctas_per_sm} blocks an SM take {per_sm} B, "
                       f"over the SM's {sm_budget} B")
    if regs_per_thread is not None:
        regs = est.ctas_per_sm * est.threads * regs_per_thread
        if regs > sm_regs:
            reasons.append(f"{est.ctas_per_sm} blocks of {est.threads} "
                           f"threads x {regs_per_thread} registers = "
                           f"{regs} exceed the SM's {sm_regs}")
    return ConfigCheck(ok=not reasons, estimate=est,
                       block_budget=block_budget, sm_budget=sm_budget,
                       reason="; ".join(reasons))
