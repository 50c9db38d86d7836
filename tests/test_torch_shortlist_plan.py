"""The one-table shortlist's host plan (`kernels/shortlist.shortlist_plan`,
the cut of csrc/shortlist.cu's tensor-core selects for 8-bit fields), on
the CPU, over a grid of B, N, row words and k and the benchmark cells'
shapes: the path (wgmma or mma.sync) chosen from k and the row's width
alone, shared memory within one block, every row in exactly one slice
and every (query tile, slice) unit walked once by the persistent blocks,
which fit one wave, a row's index within a compact key's row bits, merge
scratch for every round, the last round of units leaving under 5% of the
SMs idle at the cells' shapes, and the conditions each C entry checks
(`select_ok`, `wgmma_ok`) true on the host. The plain version at 480
words is held against the JAX package's Pallas kernel in interpret mode.
On the card tests/test_torch_cuda.py and chip_smoke.py hold the kernels
themselves.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.shortlist import lut_shortlist_pallas
from repro_torch.kernels import shortlist as sl

torch.set_num_threads(1)

SMEM_MAX = 232448       # csrc/shortlist.cu SMEM_MAX: one block's shared memory
SM_SMEM = 233472        # one H100 SM's
SMS = 132
MERGE_KEYS = 2048
ROWS = 64
CHUNK_MAX = 64

GRID = list(itertools.product((1, 200, 256, 1000), ("k", "ragged", 65536),
                              (12, 48, 480, 960), (1, 7, 64, 1024)))
# the benchmark's two_phase cells: omniglot-2p-4m and the CUB cells
CELLS = [(1024, 4194304, 48, 64), (1024, 262144, 480, 64)]


def _rows(n, k: int) -> int:
    """N of the grid: k itself, 5,017 (no multiple of the 64-row tile) or
    a number."""
    return {"k": k, "ragged": 5017}.get(n, n)


def select_ok(b, n, d, k, row_words, warps, keys, chunk, stages,
              slice_rows) -> bool:
    """csrc/shortlist.cu select_ok (the mma.sync select), on the host."""
    stride = 8 * -(-chunk // 8) + 4
    whole = chunk >= row_words
    qb = 16 * warps
    smem = qb * keys * 4 + 4 * stride * (stages * (ROWS + (0 if whole
                                                            else qb))
                                         + (qb if whole else 0))
    row_bits = (slice_rows - 1).bit_length()
    return (1 <= b <= 65535 and 1 <= k <= MERGE_KEYS // 2 and k <= n
            and d >= 1 and 255 * d < 2**22 and slice_rows >= ROWS
            and 255 * d + 1 < 2 ** (31 - row_bits)
            and row_words >= d and warps in (1, 2, 4)
            and keys >= 2 * ROWS and keys & (keys - 1) == 0
            and keys // 2 >= k and chunk >= 8 and chunk % 8 == 0
            and (chunk >= row_words or chunk <= CHUNK_MAX)
            and 2 <= stages <= 4 and slice_rows >= ROWS
            and slice_rows % ROWS == 0 and smem <= SMEM_MAX)


def wgmma_smem(whole: bool, stages: int) -> int:
    """csrc/shortlist.cu wg_smem(...).total: 1 KB aligned ring slots
    (whole rows: 128 rows x 3 columns of 64 bytes; else one column of the
    128 masks and of 256 rows; then the tile's valid bytes), whole rows'
    masks, 128 lists of 64 + 128 keys, 2 stages + 2 mbarriers, 1 KB of
    alignment."""
    data = 3 * 128 * 64 if whole else (128 + 256) * 64
    stage = -(-(data + (128 if whole else 256)) // 1024) * 1024
    masks = 3 * 128 * 64 if whole else 0
    return (stages * stage + masks + 128 * (64 + 128) * 4
            + (2 * stages + 2) * 8 + 1024)


def wgmma_ok(b, n, d, k, row_words, whole, stages, slice_rows,
             blocks) -> bool:
    """csrc/shortlist.cu wgmma_ok (the wgmma select), on the host, for
    16-byte aligned operands."""
    tile = 128 if whole else 256
    n_box = -(-4 * row_words // 64)
    row_bits = (slice_rows - 1).bit_length()
    return (1 <= b <= 65535 and n >= 1 and 1 <= k <= 64 and k <= n
            and d >= 1 and 255 * d < 2**22 and row_words >= d
            and row_words % 4 == 0 and (not whole or n_box <= 3)
            and 3 <= stages <= 8 and slice_rows >= tile
            and slice_rows % tile == 0 and slice_rows <= 2**24
            and 255 * d + 1 < 2 ** (31 - row_bits) and blocks >= 1
            and wgmma_smem(whole, stages) <= SMEM_MAX)


def merge_fits(b: int, lists: int, k: int, scratch: tuple[int, int]) -> bool:
    """The merge rounds (csrc/shortlist.cu merge_lists) write each
    round's (B, m_out, k) lists into the scratch buffer they ping-pong to
    (the last round into the output): every such buffer is large enough."""
    group = MERGE_KEYS // (1 << (k - 1).bit_length())
    sizes = {"a": scratch[0], "b": scratch[1]}
    if sizes["a"] < b * lists * k:
        return False
    m, src = lists, "a"
    while m > 1:
        m_out = -(-m // group)
        if m_out > 1:
            dst = "b" if src == "a" else "a"
            if sizes[dst] < b * m_out * k:
                return False
            src = dst
        m = m_out
    return True


@pytest.mark.parametrize("b,n,row_words,k", GRID + CELLS)
def test_plan_fits_and_covers_every_row(b, n, row_words, k):
    n = _rows(n, k)
    d = row_words                       # 8-bit fields: d words a row
    assert sl.tensor_core_route(0, 8, row_words)
    plan = sl.shortlist_plan(b, n, row_words, k)
    # the path from k and the row's width alone
    path = "wgmma" if k <= 64 and row_words % 4 == 0 else "mma"
    assert plan.path == path == sl.shortlist_plan(7, 300 + k, row_words,
                                                  k).path
    assert sl.wgmma_route(row_words, k) == (path == "wgmma")
    # shared memory within one block
    if path == "wgmma":
        n_box = -(-4 * row_words // 64)
        assert plan.whole == (n_box <= 3)
        assert wgmma_ok(b, n, d, k, row_words, plan.whole, plan.stages,
                        plan.slice_rows, plan.blocks)
        assert plan.smem == wgmma_smem(plan.whole, plan.stages) \
            <= SMEM_MAX
        assert plan.tile_rows == (128 if plan.whole else 256)
        assert plan.queries == 128 and plan.keys == 64 + 128
        assert plan.ctas_per_sm == SM_SMEM // (plan.smem + 1024) == 1
    else:
        assert select_ok(b, n, d, k, row_words, plan.warps, plan.keys,
                         plan.chunk, plan.stages, plan.slice_rows)
        assert plan.smem == sl._select_smem(
            plan.warps, plan.keys, row_words, plan.chunk, plan.stages) \
            <= SMEM_MAX
        assert plan.tile_rows == ROWS
        assert plan.ctas_per_sm == min(2048 // (32 * plan.warps),
                                       SM_SMEM // (plan.smem + 1024)) >= 1
    if row_words == 480 and k <= 64:
        assert not plan.whole and plan.chunk < row_words
    # every row in exactly one slice of whole tiles, each slice at least k
    # rows where there is more than one and the key's row bits allow it
    assert plan.slice_rows % plan.tile_rows == 0
    assert (plan.slices - 1) * plan.slice_rows < n <= \
        plan.slices * plan.slice_rows
    most = 2 ** (31 - (255 * d + 1).bit_length())
    assert plan.slice_rows <= most
    assert plan.slices == 1 or plan.slice_rows >= min(k, most)
    # every (query tile, slice) unit walked once by one persistent block,
    # the blocks one wave of the resident slots
    units = plan.units(b)
    assert units == -(-b // plan.queries) * plan.slices
    slots = plan.ctas_per_sm * SMS
    assert 1 <= plan.blocks <= min(units, slots)
    walked = sorted(u for x in range(plan.blocks)
                    for u in range(x, units, plan.blocks))
    assert walked == list(range(units))
    if (b, n, row_words, k) in CELLS:
        # the last round of units leaves under 5% of the slots idle
        idle = -(-units // slots) * slots - units
        assert path == "wgmma" and idle < 0.05 * slots
    assert plan.mask_words == 8 * -(-row_words // 8)
    assert merge_fits(b, plan.slices, k, plan.scratch(b, k))


def pack8(proj: np.ndarray) -> np.ndarray:
    """8-bit fields in `ops.pack_projection`'s layout: byte f of word w
    holds column f dp + w."""
    n, c = proj.shape
    dp = -(-c // 4)
    p = np.zeros((n, 4 * dp), np.int64)
    p[:, :c] = proj
    words = (p.reshape(n, 4, dp) << (np.arange(4) * 8)[None, :, None]).sum(1)
    return (words & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("k,masked", [(1, False), (7, True), (64, True)])
def test_plain_at_480_words_equals_the_pallas_kernel(k, masked):
    """d = 480 (480 words of 8-bit fields, CUB's rows): the plain version
    the CPU runs equals the Pallas kernel's (distance, row) lists."""
    rng = np.random.default_rng(480 + k)
    n, d = 200, 480
    proj = rng.integers(0, 256, size=(n, 4 * d))
    q = rng.integers(0, 4, size=(6, d)).astype(np.int32)
    valid = rng.random(n) > 0.3 if masked else None
    words = pack8(proj)
    assert words.shape == (n, d)
    q1h = jax.nn.one_hot(jnp.asarray(q), 4, dtype=jnp.float32).reshape(
        q.shape[0], -1)
    jd, ji = lut_shortlist_pallas(
        q1h, None, k, valid=None if valid is None else jnp.asarray(valid),
        packed=jnp.asarray(words), pack_bits=8, interpret=True)
    td, ti = sl.lut_shortlist(
        torch.as_tensor(q), None, k,
        valid=None if valid is None else torch.as_tensor(valid),
        packed=torch.as_tensor(words), pack_bits=8)
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
