"""The port's shared-memory and register budget model of the shortlist
kernel (`repro_torch.analysis.vmem`), on the CPU: it equals the host
plans of `kernels/shortlist.py` exactly over a sweep of (B, N, row words,
k) and of the block-table entry's (B, p, M, rows, row words, k, MMA),
and `validate_config` rejects an over-budget plan and honours a custom
budget. On the card chip_smoke.py holds its static part and the plan's
occupancy against ptxas (`[vmem]`)."""

import itertools

import pytest

from repro_torch.analysis import vmem
from repro_torch.kernels import shortlist as sl

SELECT_SWEEP = list(itertools.product(
    (1, 5, 16, 256), (64, 1000, 65536), (3, 12, 48, 96, 240, 480, 1920),
    (1, 7, 64, 128, 1024)))
BLOCKS_SWEEP = list(itertools.product(
    (1, 5, 256), (1, 8), (8, 64), (64, 1024), (12, 48, 96, 480),
    (1, 64, 1024), (False, True)))


@pytest.mark.parametrize("k", (1, 7, 64, 128, 1024))
def test_select_model_equals_the_plan(k):
    checked = 0
    for b, n, words, kk in SELECT_SWEEP:
        if kk != k:
            continue
        plan = sl.shortlist_plan(b, n, words, k)
        est = vmem.shortlist_smem(b, n, words, k)
        assert (est.warps, est.chunk, est.stages, est.keys,
                est.dynamic_bytes, est.ctas_per_sm) == (
            plan.warps, plan.chunk, plan.stages, plan.keys, plan.smem,
            plan.ctas_per_sm), (b, n, words)
        assert est.entry == ("select_wgmma" if plan.path == "wgmma"
                             else "select")
        assert est.dynamic_bytes == (
            sl._wgmma_smem(plan.whole, est.stages) if plan.path == "wgmma"
            else sl._select_smem(est.warps, est.keys, words, est.chunk,
                                 est.stages))
        assert est.total_bytes <= vmem.H100_BLOCK_SMEM
        assert est.static_bytes == vmem.SELECT_STATIC_SMEM == 0
        assert vmem.validate_config(est).ok
        checked += 1
    assert checked


@pytest.mark.parametrize("mma", [False, True])
@pytest.mark.parametrize("words", (12, 48, 96, 480))
def test_blocks_model_equals_the_plan(words, mma):
    checked = 0
    for b, p, m, rows, w, k, mm in BLOCKS_SWEEP:
        if (w, mm) != (words, mma):
            continue
        try:
            plan = sl.shortlist_blocks_plan(b, p, m, rows, w, k, mma)
        except ValueError:
            continue
        est = vmem.blocks_smem(b, p, m, rows, w, k, mma)
        assert (est.warps, est.chunk, est.stages, est.keys,
                est.dynamic_bytes, est.ctas_per_sm) == (
            plan.warps, plan.chunk, plan.stages, plan.keys, plan.smem,
            plan.ctas_per_sm), (b, p, m, rows, k)
        assert est.dynamic_bytes == sl._blocks_smem(
            est.warps, est.keys, w, est.chunk, est.stages, mma)
        assert est.static_bytes == vmem.BLOCKS_STATIC_SMEM == 320
        assert vmem.validate_config(est).ok
        checked += 1
    assert checked


def test_the_budgets_are_the_kernel_plans():
    assert vmem.H100_BLOCK_SMEM - vmem.SELECT_STATIC_SMEM == sl._SMEM_MAX
    assert (vmem.H100_BLOCK_SMEM - vmem.BLOCKS_STATIC_SMEM
            == sl._BLOCKS_SMEM_MAX)
    assert vmem.H100_SM_SMEM == sl._SM_SMEM


def test_validate_rejects_over_budget_and_honours_a_custom_budget():
    est = vmem.shortlist_smem(256, 65536, 480, 1024)
    assert vmem.validate_config(est).ok
    tight = vmem.validate_config(est, block_budget=est.total_bytes - 1)
    assert not tight.ok and "exceeds" in tight.reason
    assert vmem.validate_config(est, block_budget=est.total_bytes).ok
    # a forced block too wide for one block's shared memory
    wide = vmem.shortlist_smem(256, 65536, 1920, 1024, warps=4, chunk=1920)
    check = vmem.validate_config(wide)
    assert not check.ok and wide.total_bytes > vmem.H100_BLOCK_SMEM
    # the SM's registers at the plan's occupancy
    small = vmem.shortlist_smem(256, 65536, 48, 64)
    regs = vmem.H100_SM_REGS // (small.ctas_per_sm * small.threads)
    assert vmem.validate_config(small, regs_per_thread=regs).ok
    over = vmem.validate_config(small, regs_per_thread=regs + 1)
    assert not over.ok and "registers" in over.reason
    # a variant's stages past the budget (launch/time_blocks.py's gate)
    ring = vmem.blocks_smem(256, 8, 64, 1024, 480, 1024, True,
                            chunk_max=64, stages_chunked=64)
    assert not vmem.validate_config(ring).ok
