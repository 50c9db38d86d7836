"""Shared-memory and register budget model of the shortlist kernel
(counterpart of `repro.analysis.vmem`, the Pallas kernel's VMEM model).

On Hopper the shortlist (`csrc/shortlist.cu`) keeps its working set in
shared memory, sized on the host by the plans of `kernels/shortlist.py`:
a one-table select block of `warps` warps of 4 queries holds

    keys     warps x 4 x keys x 8 B    each query's top-k and candidates
    masks    warps x 4 x ceil(window / 4) x 16 B   its one-hot mask words
    stages   2 x 64 x stage_stride(window) x 4 B   two staged row tiles

and a block-table select block (one unit: up to 16 (query, visit) pairs)

    keys     warps x 4 x keys x 8 B
    masks    (16 if mma else 4 warps) x blocks_stride(row_words) x 4 B
    stages   stages x 64 x blocks_stride(chunk) x 4 B   the K-chunk ring
    tile     16 x 72 x 4 B (mma only)   the tensor cores' distance tile

plus each kernel's static shared memory (`SELECT_STATIC_SMEM`,
`BLOCKS_STATIC_SMEM` of csrc/shortlist.cu). `shortlist_smem` and
`blocks_smem` are these closed forms, with the plans' own choice of
warps, window, keys, chunk and stages; they equal the plans exactly
(tests/test_torch_vmem.py), and the static part equals what ptxas
reports (chip_smoke.py's `[vmem]` lines).

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
#: static shared memory of the select kernels (csrc/shortlist.cu): a
#: query slot's query and list (4 + 8 B); a pair slot's query, list,
#: bound slot and shared-bound flag (4 + 8 + 4 + 4 B)
SELECT_STATIC_SMEM = sl._SELECT_STATIC
BLOCKS_STATIC_SMEM = sl._BLOCKS_STATIC


@dataclasses.dataclass(frozen=True)
class SmemEstimate:
    """The shared memory of one select block of a plan: its parts, the
    dynamic bytes the launch asks for, the static bytes, their total,
    and the blocks an SM runs at the plan's occupancy."""
    entry: str                 # "select" | "blocks_select"
    warps: int
    keys: int
    window: int                # words staged a row (the K-chunk, blocks)
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
        return 32 * self.warps


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
    """Select blocks an SM runs: by threads, and by shared memory (a
    block's dynamic and static bytes and the runtime's reserve)."""
    return min(H100_SM_THREADS // (32 * warps),
               H100_SM_SMEM // (total + BLOCK_RESERVED_SMEM))


def _select_parts(warps: int, keys: int, window: int) -> tuple[int, ...]:
    stride = 4 * (_cdiv(window, 4) | 1)
    return (warps * sl._QW * keys * 8,
            warps * sl._QW * _cdiv(window, 4) * 16,
            2 * sl._ROWS * stride * 4)


def shortlist_smem(b: int, n: int, row_words: int, k: int,
                   warps: int | None = None,
                   window: int | None = None) -> SmemEstimate:
    """The one-table select block of `shortlist_plan(b, n, row_words, k)`
    (its warps and window unless given): keys = max(128, 2 pow2(k)); up
    to 4 warps of 4 queries while the block fits, whole rows staged when
    they fit, else windows halved (a multiple of 4 words)."""
    keys = max(128, 2 * (1 << (k - 1).bit_length()))
    budget = H100_BLOCK_SMEM - SELECT_STATIC_SMEM
    if warps is None or window is None:
        for w in range(min(4, _cdiv(b, sl._QW)), 0, -1):
            win = row_words
            while win > 4 and sum(_select_parts(w, keys, win)) > budget:
                win = 4 * (win // 8)
            if sum(_select_parts(w, keys, win)) <= budget:
                break
        warps = w if warps is None else warps
        window = win if window is None else window
    key_b, mask_b, stage_b = _select_parts(warps, keys, window)
    dynamic = key_b + mask_b + stage_b
    return SmemEstimate(
        entry="select", warps=warps, keys=keys, window=window, stages=2,
        key_bytes=key_b, mask_bytes=mask_b, stage_bytes=stage_b,
        tile_bytes=0, dynamic_bytes=dynamic,
        static_bytes=SELECT_STATIC_SMEM,
        total_bytes=dynamic + SELECT_STATIC_SMEM,
        ctas_per_sm=_occupancy(warps, dynamic + SELECT_STATIC_SMEM))


def _blocks_parts(warps: int, keys: int, row_words: int, chunk: int,
                  stages: int, mma: bool) -> tuple[int, ...]:
    def stride(words: int) -> int:
        return 8 * _cdiv(words, 8) + 4
    return (warps * sl._QW * keys * 8,
            (sl._BQ if mma else warps * sl._QW) * stride(row_words) * 4,
            stages * sl._ROWS * stride(chunk) * 4,
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
        entry="blocks_select", warps=warps, keys=keys, window=chunk,
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
