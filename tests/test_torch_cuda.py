"""The hand-written CUDA kernels of `repro_torch` against their plain
PyTorch versions, on an NVIDIA GPU. Every test here needs the card and
skips where there is none; the module imports torch and numpy only, so it
runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda.py

(`--noconftest` because tests/conftest.py imports JAX.)
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.core import avss as avss_lib
from repro_torch.core.encodings import make_encoding
from repro_torch.core.memory import MemoryConfig
from repro_torch.engine import MemoryStore, RetrievalEngine, SearchRequest
from repro_torch.core.mcam import MCAMConfig
from repro_torch.kernels import _build, mcam_dist, mcam_episode, mcam_search
from repro_torch.kernels import ops
from repro_torch.kernels import shortlist

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)

# card vs CPU votes, per (query, row): libdevice and the CPU's libm may
# differ by ulps, so a current on a threshold may vote differently. On the
# card the kernels equal their plain versions bit for bit.
PHYSICS_MIN_AGREEMENT = 0.999


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def pack_words(proj: np.ndarray, bits: int) -> np.ndarray:
    """`ops.pack_projection`'s layout for an arbitrary integer table."""
    wpi = 32 // bits
    n, c = proj.shape
    dp = -(-c // wpi)
    p = np.zeros((n, dp * wpi), np.int64)
    p[:, :c] = proj
    words = (p.reshape(n, wpi, dp)
             << (np.arange(wpi, dtype=np.int64) * bits)[None, :, None])
    return (words.sum(1) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


# operand form -> (pack_bits or None, stored dtype, largest LUT entry)
OPERANDS = {"packed4": (4, None, 15), "packed8": (8, None, 255),
            "packed16": (16, None, 4000), "packed32": (32, None, 60000),
            "bf16": (None, torch.bfloat16, 255),
            "f32": (None, torch.float32, 60000)}


@pytest.mark.parametrize("n,d,ks", [(257, 12, (1, 7, 257)),
                                    (5000, 48, (64, 1024)),
                                    (20000, 8, (100,))],
                         ids=["one_chunk", "two_merge_rounds", "many_chunks"])
@pytest.mark.parametrize("operand", list(OPERANDS))
def test_shortlist_kernel_matches_plain(dev, operand, n, d, ks):
    bits, dtype, vmax = OPERANDS[operand]
    rng = np.random.default_rng(n + d)
    proj = rng.integers(0, min(vmax + 1, 1 << 20), size=(n, 4 * d))
    if n == 20000:
        proj //= max(1, vmax // 3)          # tie-heavy: few distinct values
    q = torch.as_tensor(rng.integers(0, 4, size=(9, d)).astype(np.int32))
    valid = torch.as_tensor(rng.random(n) > 0.2)
    if bits is not None:
        kw = {"packed": torch.as_tensor(pack_words(proj, bits)),
              "pack_bits": bits}
        sp = None
    else:
        kw, sp = {}, torch.as_tensor(proj).to(dtype)
    on_dev = {a: (b.to(dev) if isinstance(b, torch.Tensor) else b)
              for a, b in kw.items()}
    for k in ks:
        want = shortlist.lut_shortlist(q, sp, k, valid=valid, **kw)
        got = shortlist.lut_shortlist(q.to(dev),
                                      None if sp is None else sp.to(dev), k,
                                      valid=valid.to(dev), **on_dev)
        torch.cuda.synchronize()
        assert torch.equal(got[0].cpu(), want[0]), k
        assert torch.equal(got[1].cpu(), want[1]), k


@pytest.mark.parametrize("operand", ["packed8", "packed4", "bf16"])
def test_shortlist_kernel_at_the_cub_width(dev, operand):
    """d = 480 (4d = 1,920 LUT columns), B = 256, k = 64 and 1024: 8-bit
    fields (MTMC CL = 25, B4E) give 480-word rows, which the wgmma select
    streams in 64-byte K-columns beside the masks at k = 64 and the
    mma.sync select in K-chunks at k = 1,024; 4-bit fields (SRE) 240-word
    rows and bf16 960 words take the block-table route."""
    bits, dtype, _ = OPERANDS[operand]
    vmax = 12 if bits == 4 else 75
    n, d = 5000, 480
    rng = np.random.default_rng(480 + (bits or 0))
    proj = rng.integers(0, vmax + 1, size=(n, 4 * d))
    q = torch.as_tensor(rng.integers(0, 4, size=(256, d)).astype(np.int32))
    valid = torch.as_tensor(rng.random(n) > 0.1)
    if bits is not None:
        kw = {"packed": torch.as_tensor(pack_words(proj, bits)).to(dev),
              "pack_bits": bits}
        sp = None
    else:
        kw, sp = {}, torch.as_tensor(proj).to(dtype).to(dev)
    if operand == "packed8":
        plan = shortlist.shortlist_plan(256, n, kw["packed"].shape[1], 64)
        assert plan.path == "wgmma" and not plan.whole
        plan = shortlist.shortlist_plan(256, n, kw["packed"].shape[1], 1024)
        assert plan.path == "mma" and plan.chunk < kw["packed"].shape[1]
    for k in (64, 1024):
        got = shortlist.lut_shortlist(q.to(dev), sp, k, valid=valid.to(dev),
                                      **kw)
        want = shortlist.lut_shortlist_plain(q.to(dev), sp, k,
                                             valid=valid.to(dev), **kw)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_shortlist_kernel_refuses_k_above_its_limit(dev):
    q = torch.zeros(2, 4, dtype=torch.int32, device=dev)
    proj = torch.zeros(4096, 16, device=dev)
    with pytest.raises(ValueError, match="exceeds"):
        shortlist.lut_shortlist(q, proj, shortlist.MAX_K + 1)


# order -> distance of row n of an (n_rows,) store, the same for every query
ORDERS = {"descending": lambda n: np.arange(n)[::-1] * 3,   # all candidates
          "ties": lambda n: np.full(n, 5),                  # no candidate
          "masked": lambda n: np.arange(n) % 7}             # all rows masked


@pytest.mark.parametrize("order,b,n,k", [
    ("descending", 1, 5017, 1), ("descending", 300, 5017, 1024),
    ("descending", 16, 65537, 64), ("ties", 300, 5017, 64),
    ("ties", 1, 4099, 1024), ("masked", 1, 5017, 1024),
    ("masked", 300, 4099, 7)])
def test_shortlist_kernel_on_adversarial_orders(dev, order, b, n, k):
    """Every row of a fixed per-row distance, for every query: the running
    threshold admits every row (descending), no row after the first k
    (ties), or every row with the mask penalty (masked). N is no multiple
    of the staged tile or of a slice."""
    per_row = ORDERS[order](n)
    d = 8
    proj = np.zeros((n, 4 * d), np.int64)
    proj[:, 0::4] = per_row[:, None] // d    # query word 0 in every dim:
    proj[:, 0] += per_row % d                # the row sums to per_row
    proj[:, 1::4] = 9
    q = torch.zeros(b, d, dtype=torch.int32, device=dev)
    valid = torch.full((n,), order != "masked", device=dev)
    packed = torch.as_tensor(pack_words(proj, 16)).to(dev)
    got = shortlist.lut_shortlist(q, None, k, valid=valid, packed=packed,
                                  pack_bits=16)
    want = shortlist.lut_shortlist_plain(q, None, k, valid=valid,
                                         packed=packed, pack_bits=16)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# the tensor-core select's shapes (d, B, N): B no multiple of its 64-query
# tile, N no multiple of its 64-row tile; rows whole (d = 48), in K-chunks
# (d = 480), and of a width no multiple of 4 words (copied a word at a
# time) and of 8 (the last k-step reads past the row, where the masks are
# 0)
TC_SHAPES = {"d48": (48, 200, 5017), "d480": (480, 100, 4099),
             "d13": (13, 70, 1100)}


def uniform8(per_row: np.ndarray, d: int) -> np.ndarray:
    """(N, 4d) 8-bit LUT entries whose every column of a dimension holds
    one value, so that a row's distance is per_row (<= 255 d) whatever the
    query: per_row spread over the dimensions, each within a byte."""
    per_dim = (per_row[:, None] // d
               + (np.arange(d)[None] < per_row[:, None] % d))
    return np.repeat(per_dim, 4, axis=1)


@pytest.mark.parametrize("k", (1, 64, 1024))
@pytest.mark.parametrize("store", ["random", "descending", "ties",
                                   "masked"])
@pytest.mark.parametrize("shape", list(TC_SHAPES))
def test_shortlist_tensor_core_select_matches_plain(dev, shape, store, k):
    """8-bit packed fields, the main path's operand: the one-table select
    on the tensor cores against the plain version bit for bit, on both
    paths (wgmma at k <= 64 with rows of whole 16-byte segments, whole at
    d = 48 and in 64-byte K-columns at d = 480; mma.sync at k = 1,024,
    one warp of 16 queries a block, and at d = 13), on random rows with
    a fifth masked, rows in descending distance (every row a candidate;
    ties in groups at d = 48, where 255 d < N), all rows tied, and all
    rows masked; the path that ran is counted under its own name."""
    d, b, n = TC_SHAPES[shape]
    rng = np.random.default_rng(d + b + n + k)
    if store in ("random", "masked"):
        proj = rng.integers(0, 256, size=(n, 4 * d))
    else:
        per_row = (np.arange(n)[::-1] * 255 * d // n if store == "descending"
                   else np.full(n, 5 * d))
        proj = uniform8(per_row, d)
    valid = {"random": rng.random(n) > 0.2, "masked": np.zeros(n, bool)
             }.get(store, np.ones(n, bool))
    q = torch.as_tensor(rng.integers(0, 4, size=(b, d)).astype(np.int32),
                        device=dev)
    kw = {"valid": torch.as_tensor(valid, device=dev),
          "packed": torch.as_tensor(pack_words(proj, 8), device=dev),
          "pack_bits": 8}
    assert kw["packed"].shape[1] == d
    _build.reset_launches()
    got = shortlist.lut_shortlist(q, None, k, **kw)
    path = "wgmma" if k <= 64 and d % 4 == 0 else "mma"
    assert shortlist.shortlist_plan(b, n, d, k).path == path
    assert {p: _build.LAUNCHES[p] for p in _build.SELECT_PATHS} == {
        f"shortlist_{p}": int(p == path) for p in ("wgmma", "mma")}
    want = shortlist.lut_shortlist_plain(q, None, k, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_shortlist_wgmma_select_at_the_omniglot_cell(dev):
    """The `omniglot-2p-4m` cell's geometry: B 1,024 queries over
    4,194,304 + 37 rows of 48 words of 8-bit fields, a fifth masked, k 64
    (the wgmma path, whole rows, 33 slices). A sample of 64 queries is
    held bit for bit against the plain version, in chunks of 16 queries
    so that its (16, N) distances fit."""
    b, n, d, k = 1024, 4194304 + 37, 48, 64
    g = torch.Generator(device=dev)
    g.manual_seed(4194341)
    packed = torch.randint(-2**31, 2**31 - 1, (n, d), dtype=torch.int32,
                           device=dev, generator=g)
    valid = torch.rand(n, device=dev, generator=g) > 0.2
    q = torch.randint(0, 4, (b, d), dtype=torch.int32, device=dev,
                      generator=g)
    kw = {"valid": valid, "packed": packed, "pack_bits": 8}
    assert shortlist.shortlist_plan(b, n, d, k).path == "wgmma"
    _build.reset_launches()
    dist, rows = shortlist.lut_shortlist(q, None, k, **kw)
    assert _build.LAUNCHES["shortlist_wgmma"] == 1
    assert _build.LAUNCHES["shortlist_mma"] == 0
    sample = torch.randperm(b, device=dev, generator=g)[:64]
    for chunk in sample.split(16):
        want = shortlist.lut_shortlist_plain(q[chunk], None, k, **kw)
        assert torch.equal(dist[chunk], want[0])
        assert torch.equal(rows[chunk], want[1])


def _block_table(rng, m, rows, d, operand, order=None):
    """A table of m blocks of `rows` rows: (s_proj or None, kwargs) of the
    operand form; `order` as ORDERS gives every row a fixed distance for
    query word 0 (rows in descending distance or all tied)."""
    bits, dtype, vmax = OPERANDS[operand]
    if order is None:
        proj = rng.integers(0, min(vmax + 1, 1 << 20), size=(m * rows, 4 * d))
    else:
        per_row = ORDERS[order](m * rows)
        proj = np.zeros((m * rows, 4 * d), np.int64)
        proj[:, 0::4] = per_row[:, None] // d
        proj[:, 0] += per_row % d
        proj[:, 1::4] = 9
    if bits is not None:
        words = torch.as_tensor(pack_words(proj, bits))
        return None, {"packed": words.reshape(m, rows, -1),
                      "pack_bits": bits}
    return torch.as_tensor(proj).to(dtype).reshape(m, rows, -1), {}


def _visits(rng, b, p, m, base):
    """(B, p) distinct blocks a query, ascending in base."""
    ids = np.stack([rng.choice(m, size=p, replace=False) for _ in range(b)])
    order = np.argsort(base[ids], axis=1, kind="stable")
    return torch.as_tensor(np.take_along_axis(ids, order, 1).astype(np.int32))


# (b, p, m, rows, d, k, operand, order, valid_share)
BLOCK_CASES = {
    "k_above_rows": (40, 3, 8, 96, 12, 200, "packed8", None, 0.8),
    "k_is_p_rows": (33, 2, 6, 100, 12, 200, "packed8", None, 0.8),
    "rows_not_64": (70, 4, 9, 37, 16, 20, "packed4", None, 0.7),
    "visited_all_masked": (20, 2, 5, 130, 12, 64, "packed8", None, 0.0),
    "all_rows_tied": (50, 3, 7, 300, 8, 64, "packed16", "ties", 1.0),
    "descending": (50, 3, 7, 300, 8, 64, "packed16", "descending", 1.0),
    "p_is_m": (30, 6, 6, 128, 12, 64, "bf16", None, 0.9),
    "many_queries_one_block": (600, 1, 2, 1024, 48, 64, "packed8", None, 0.9),
    "tenants_p1": (256, 1, 64, 300, 48, 64, "packed8", None, 0.6),
    "f32": (40, 3, 8, 200, 12, 64, "f32", None, 0.8),
    "packed32": (40, 3, 8, 200, 12, 32, "packed32", None, 0.8),
    "large_k": (16, 4, 8, 512, 12, 1024, "packed8", None, 0.9),
    # the redesigned entry's edges: one pair over a 4,096-row block (its
    # rows split over units), blocks of 80 visitors (5 tiles) over
    # 700 rows, 480-word rows on the MMA without windows, 4- and 16-bit
    # fields at d = 480 on the CUDA cores, and descending rows under a
    # shared bound (8 visits x 8 ranges: 64 lists a query)
    "one_pair_4096_rows": (1, 1, 4, 4096, 48, 64, "packed8", None, 0.9),
    "blocks_of_80_pairs": (80, 2, 2, 700, 48, 64, "packed8", None, 0.9),
    "cub_rows_mma": (64, 4, 16, 256, 480, 64, "packed8", None, 0.9),
    "cub_packed4": (40, 3, 8, 200, 480, 64, "packed4", None, 0.9),
    "cub_packed16": (40, 3, 8, 200, 480, 64, "packed16", None, 0.9),
    "descending_shared_bound": (50, 8, 16, 512, 8, 64, "packed16",
                                "descending", 1.0),
}


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_block_entry_matches_plain(dev, case):
    """The block-table entry against its plain version, bit for bit, on
    each of its edges: lists shorter than k, k up to p * rows, ragged
    tiles, masked and tied and descending rows, every block visited, one
    block visited by every query, p = 1 (a tenant stack), k = MAX_K, and
    the operand forms. Key bases are a permutation of the blocks' row
    offsets (a pager's slot -> shard map), so key rows differ from table
    rows."""
    b, p, m, rows, d, k, operand, order, share = BLOCK_CASES[case]
    rng = np.random.default_rng(len(case) + b)
    sp, kw = _block_table(rng, m, rows, d, operand, order)
    base_np = rng.permutation(m).astype(np.int64) * rows
    if case == "tenants_p1":                 # a tenant stack's key rows
        base_np[:] = 0
    ids = _visits(rng, b, p, m, base_np)
    base = torch.as_tensor(base_np)
    valid = torch.as_tensor(rng.random((m, rows)) < share)
    q = torch.as_tensor(rng.integers(0, 4, size=(b, d)).astype(np.int32))
    if order is not None:
        q.zero_()
    on = {a: (v.to(dev) if isinstance(v, torch.Tensor) else v)
          for a, v in kw.items()}
    args = dict(base=base.to(dev), ids=ids.to(dev), valid=valid.to(dev),
                **on)
    spd = None if sp is None else sp.to(dev)
    _build.reset_launches()
    got = shortlist.lut_shortlist_blocks(q.to(dev), spd, k, **args)
    assert _build.LAUNCHES["shortlist_blocks"] == 1
    want = shortlist.lut_shortlist_blocks_plain(q.to(dev), spd, k, **args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    cpu = shortlist.lut_shortlist_blocks(q, sp, k, base=base, ids=ids,
                                         valid=valid, **kw)
    assert torch.equal(got[0].cpu(), cpu[0]) and torch.equal(got[1].cpu(),
                                                             cpu[1])


@pytest.mark.parametrize("operand", ["packed8", "packed4", "bf16"])
def test_block_entry_at_the_cub_width(dev, operand):
    """d = 480: 480-word rows (8-bit fields) staged in windows, 240-word
    rows (4-bit) whole, 960 bf16 words; 256 queries visiting 8 of 64
    blocks of 256 rows."""
    b, p, m, rows, d = 256, 8, 64, 256, 480
    rng = np.random.default_rng(480)
    bits, dtype, _ = OPERANDS[operand]
    vmax = 12 if bits == 4 else 75
    proj = rng.integers(0, vmax + 1, size=(m * rows, 4 * d))
    if bits is not None:
        sp, kw = None, {"packed": torch.as_tensor(pack_words(proj, bits))
                        .reshape(m, rows, -1).to(dev), "pack_bits": bits}
    else:
        sp, kw = torch.as_tensor(proj).to(dtype).reshape(m, rows, -1).to(
            dev), {}
    base_np = np.arange(m, dtype=np.int64) * rows
    args = dict(base=torch.as_tensor(base_np).to(dev),
                ids=_visits(rng, b, p, m, base_np).to(dev),
                valid=torch.as_tensor(rng.random((m, rows)) > 0.1).to(dev),
                **kw)
    q = torch.as_tensor(rng.integers(0, 4, size=(b, d)).astype(np.int32)
                        ).to(dev)
    for k in (64, 1024):
        got = shortlist.lut_shortlist_blocks(q, sp, k, **args)
        want = shortlist.lut_shortlist_blocks_plain(q, sp, k, **args)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_block_entry_launch_shape_does_not_depend_on_the_mix(dev):
    """One grouping, one select and the same merge launches whatever the
    visit lists: every query on one block, spread over all of them, or a
    tenant stack's one block a query; and a visit id outside the table
    reads nothing."""
    rng = np.random.default_rng(7)
    m, rows, d, b = 16, 256, 12, 64
    sp, kw = _block_table(rng, m, rows, d, "packed8")
    kw = {a: (v.to(dev) if isinstance(v, torch.Tensor) else v)
          for a, v in kw.items()}
    base = (torch.arange(m, dtype=torch.int64) * rows).to(dev)
    q = torch.as_tensor(rng.integers(0, 4, size=(b, d)).astype(np.int32)
                        ).to(dev)
    for ids in (torch.zeros(b, 1, dtype=torch.int32),
                torch.arange(b, dtype=torch.int32)[:, None] % m):
        _build.reset_launches()
        got = shortlist.lut_shortlist_blocks(q, sp, 64, base=base,
                                             ids=ids.to(dev), **kw)
        assert _build.LAUNCHES["shortlist_blocks"] == 1
        want = shortlist.lut_shortlist_blocks_plain(q, sp, 64, base=base,
                                                    ids=ids.to(dev), **kw)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    outside = torch.full((b, 1), m, dtype=torch.int32, device=dev)
    got = shortlist.lut_shortlist_blocks(q, sp, 64, base=base, ids=outside,
                                         **kw)
    torch.cuda.synchronize()
    assert (got[1] == 0xFFFFFFFF).all()
    # a tenant stack's mix: one block a query, a few queries a block, key
    # rows within the block
    tenants = torch.as_tensor(rng.integers(0, m, size=(b, 1)))
    zero = torch.zeros(m, dtype=torch.int64, device=dev)
    _build.reset_launches()
    got = shortlist.lut_shortlist_blocks(q, sp, 64, base=zero,
                                         ids=tenants.to(dev), **kw)
    assert _build.LAUNCHES["shortlist_blocks"] == 1
    want = shortlist.lut_shortlist_blocks_plain(q, sp, 64, base=zero,
                                                ids=tenants.to(dev), **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_block_entry_reads_nothing_for_ids_outside_the_table(dev):
    """Visits outside [0, M) (-1 or M) among real ones: each query's result
    is the plain version's over its real visits alone (k <= its real
    visits x rows), and the outside ids' lists hold only the all-ones
    key, which the merge drops."""
    rng = np.random.default_rng(11)
    m, rows, d, b, p, k = 12, 300, 48, 40, 4, 64
    sp, kw = _block_table(rng, m, rows, d, "packed8")
    kw = {a: (v.to(dev) if isinstance(v, torch.Tensor) else v)
          for a, v in kw.items()}
    base_np = np.arange(m, dtype=np.int64) * rows
    ids = _visits(rng, b, p, m, base_np).to(torch.int64)
    ids[::3, 0] = -1
    ids[1::3, p - 1] = m
    valid = torch.as_tensor(rng.random((m, rows)) < 0.9).to(dev)
    q = torch.as_tensor(rng.integers(0, 4, size=(b, d)).astype(np.int32))
    base = torch.as_tensor(base_np).to(dev)
    got = shortlist.lut_shortlist_blocks(q.to(dev), sp, k, base=base,
                                         ids=ids.to(dev), valid=valid, **kw)
    torch.cuda.synchronize()
    for i in range(b):
        real = ids[i][(ids[i] >= 0) & (ids[i] < m)][None]
        want = shortlist.lut_shortlist_blocks_plain(
            q[i:i + 1].to(dev), sp, k, base=base, ids=real.to(dev),
            valid=valid, **kw)
        assert torch.equal(got[0][i:i + 1], want[0])
        assert torch.equal(got[1][i:i + 1], want[1])


@pytest.mark.parametrize("operand", ["packed8", "packed16"])
def test_block_entry_virtual_units_repeat_bit_for_bit(dev, operand):
    """Five of each query's eight visits outside [0, M): the virtual block
    then has units whose every warp holds pairs (no rows, no staging).
    Fifty calls in a row each equal the plain version over the real
    visits: every warp writes its pairs' all-ones lists where the grouping
    pass numbered them, never over another query's list."""
    rng = np.random.default_rng(23)
    m, rows, d, b, k = 16, 256, 48, 64, 64
    sp, kw = _block_table(rng, m, rows, d, operand)
    kw = {a: (v.to(dev) if isinstance(v, torch.Tensor) else v)
          for a, v in kw.items()}
    base_np = np.arange(m, dtype=np.int64) * rows
    real = _visits(rng, b, 3, m, base_np).to(torch.int64)
    outside = torch.where(torch.arange(5) % 2 == 0, -1, m).expand(b, 5)
    ids = torch.cat([real, outside], 1).to(dev)
    valid = torch.as_tensor(rng.random((m, rows)) < 0.9).to(dev)
    q = torch.as_tensor(rng.integers(0, 4, size=(b, d)).astype(np.int32)
                        ).to(dev)
    base = torch.as_tensor(base_np).to(dev)
    want = shortlist.lut_shortlist_blocks_plain(
        q, sp, k, base=base, ids=real.to(dev), valid=valid, **kw)
    for _ in range(50):
        got = shortlist.lut_shortlist_blocks(q, sp, k, base=base, ids=ids,
                                             valid=valid, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("k", [64, 1024])
def test_block_entry_keeps_both_copies_of_a_block_visited_twice(dev, k):
    """Each query visits each of 4 blocks of descending rows 4 times (16
    visits: the shared bound is on). The plain version holds 4 copies of
    each best key, so the key equal to a query's bound may be in the
    result more than once, and the entry keeps every copy."""
    rng = np.random.default_rng(k)
    m, rows, d, b, p = 4, 512, 8, 50, 16
    sp, kw = _block_table(rng, m, rows, d, "packed16", "descending")
    kw = {a: (v.to(dev) if isinstance(v, torch.Tensor) else v)
          for a, v in kw.items()}
    args = dict(base=(torch.arange(m, dtype=torch.int64) * rows).to(dev),
                ids=torch.arange(p, device=dev).repeat(b, 1) // 4,
                valid=torch.ones(m, rows, dtype=torch.bool, device=dev),
                **kw)
    q = torch.zeros(b, d, dtype=torch.int32, device=dev)
    got = shortlist.lut_shortlist_blocks(q, sp, k, **args)
    want = shortlist.lut_shortlist_blocks_plain(q, sp, k, **args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("b,n,k,dtype,vmax", [
    (37, 1001, 190, torch.bfloat16, 96),     # ragged route: K % 8 != 0
    (16, 1001, 188, torch.bfloat16, 255),    # ragged route, B < 64
    (300, 4099, 400, torch.bfloat16, 96),    # ragged route, 7 K blocks
    (256, 4096, 192, torch.bfloat16, 96),    # TMA route, the main shapes
    (300, 4099, 384, torch.bfloat16, 96),    # TMA route, ring refilled
    (5, 130, 8, torch.bfloat16, 255),        # TMA route, one short K block
    (64, 512, 192, torch.float32, 96),
    (37, 1001, 190, torch.float32, 60000),   # f32 entries above 2**11
    (256, 4099, 1920, torch.bfloat16, 75),   # TMA, CUB's K = 4d, 30 K blocks
    (40, 1001, 1916, torch.bfloat16, 75),    # ragged route at CUB's depth
    (64, 515, 1920, torch.float32, 75)])     # f32 at CUB's depth
def test_lut_dist_kernel_matches_plain(dev, b, n, k, dtype, vmax):
    rng = np.random.default_rng(b + k)
    a = torch.as_tensor(rng.integers(0, 2, size=(b, k))).to(dtype)
    s = torch.as_tensor(rng.integers(0, vmax + 1, size=(n, k))).to(dtype)
    got = mcam_dist.lut_dist_matmul(a.to(dev), s.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), mcam_dist.lut_dist_matmul(a, s))


def test_lut_dist_kernel_takes_an_unaligned_view(dev):
    """A row-offset view whose base is not 16-byte aligned goes the plain-
    load route and gives the same product."""
    rng = np.random.default_rng(3)
    a = torch.as_tensor(rng.integers(0, 2, size=(9, 64))).to(torch.bfloat16)
    s = torch.as_tensor(rng.integers(0, 97, size=(301, 64))).to(
        torch.bfloat16)
    flat = s.to(dev).reshape(-1)
    view = torch.cat([flat[:3], flat]).narrow(0, 3, flat.numel()).view(
        301, 64)
    assert view.data_ptr() % 16 != 0
    got = mcam_dist.lut_dist_matmul(a.to(dev), view)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), mcam_dist.lut_dist_matmul(a, s))


def _grids(seed, n=300, b=8, cl=8, d=48):
    enc = make_encoding("mtmc", cl)
    rng = np.random.default_rng(seed)
    v = torch.as_tensor(rng.integers(0, enc.levels, size=(n, d)))
    q = torch.as_tensor(rng.integers(0, 4, size=(b, d)))
    return (enc, avss_lib.layout_query(q, enc, "avss").to(torch.int8),
            avss_lib.layout_support(v, enc).to(torch.int8))


@pytest.mark.parametrize("noisy", [False, True])
def test_physics_kernels_match_plain(dev, noisy):
    """Votes and dist equal the plain version run on the card, bit for
    bit; the gathered entry equals the dense entry at the same (query,
    global row), noise rows and query coordinates included."""
    enc, qg, sg = _grids(13)
    cfg = avss_lib.SearchConfig("mtmc", cl=8, noisy=noisy)
    th = torch.as_tensor(cfg.mcam.thresholds(), device=dev)
    w = enc.weights_array(device=dev)
    qidx = torch.tensor([3, 2**31 + 1, 0, 9, 4, 5, 6, 7], device=dev)
    qs = ops.flatten_strings(ops.broadcast_query(qg, enc.length)).to(dev)
    ss = ops.flatten_strings(sg).to(dev)
    ws = w.repeat(qs.shape[1] // w.shape[0])
    pv, pd = mcam_search.mcam_search_plain(qs, ss, ws, th, cfg.mcam,
                                           noisy=noisy, qidx=qidx)
    kv, kd = ops.mcam_search(qg.to(dev), sg.to(dev), w, cfg, th, qidx=qidx)
    torch.cuda.synchronize()
    assert torch.equal(kd, pd)
    assert torch.equal(kv, pv)
    rows = torch.topk(-kd, 16, dim=1).indices
    rv = ops.rescore_shortlist(qg.to(dev), sg.to(dev), rows, w, cfg, th,
                               noise_qidx=qidx)
    torch.cuda.synchronize()
    assert torch.equal(rv, torch.take_along_dim(kv, rows, dim=1))
    # shard-local rows with global noise rows: equal to the dense search
    # of a store in which those rows sit at their global position
    big = torch.zeros((400,) + tuple(sg.shape[1:]), dtype=torch.int8)
    big[100:] = sg
    bv, _ = ops.mcam_search(qg.to(dev), big.to(dev), w, cfg, th, qidx=qidx)
    lv = ops.rescore_shortlist(qg.to(dev), sg.to(dev), rows, w, cfg, th,
                               noise_idx=rows + 100, noise_qidx=qidx)
    torch.cuda.synchronize()
    assert torch.equal(lv, torch.take_along_dim(bv, rows + 100, dim=1))


# (B, N, S, sl, noisy, grid values): both instances (sl = 24 and not),
# S below / not a multiple of 32, B = 1 and 300, N of no round size, the
# noiseless path, and int8 values beyond the 2-bit cell codes
PHYSICS_CASES = [(16, 1001, 64, 24, True, 4), (1, 517, 64, 24, True, 4),
                 (300, 67, 40, 24, True, 4), (7, 333, 64, 20, True, 4),
                 (5, 129, 33, 24, False, 4), (3, 250, 64, 13, False, 4),
                 (9, 257, 64, 24, True, 256),
                 # CUB's 500 strings a support (d = 480, MTMC CL = 25),
                 # B4E's 6 and SRE's 8 at d = 48
                 (4, 1001, 500, 24, True, 4), (3, 130, 500, 24, False, 4),
                 (33, 301, 6, 24, True, 4), (17, 301, 8, 24, True, 4)]


def _physics_case(dev, b, n, S, sl, values, seed):
    rng = np.random.default_rng(seed)
    lo = 0 if values == 4 else -128
    q = torch.as_tensor(rng.integers(lo, lo + values, size=(b, S, sl)),
                        dtype=torch.int8).to(dev)
    s = torch.as_tensor(rng.integers(lo, lo + values, size=(n, S, sl)),
                        dtype=torch.int8).to(dev)
    w = torch.as_tensor(rng.integers(1, 4, size=S), dtype=torch.float32,
                        device=dev)
    qidx = torch.as_tensor(rng.integers(0, 2**32, size=b), device=dev)
    qidx[0] = 2**32 - 1
    return q, s, w, qidx


@pytest.mark.parametrize("b,n,S,sl,noisy,values", PHYSICS_CASES)
def test_dense_physics_kernel_equals_plain_bit_for_bit(dev, b, n, S, sl,
                                                       noisy, values):
    q, s, w, qidx = _physics_case(dev, b, n, S, sl, values, b + n + sl)
    cfg = MCAMConfig(string_len=sl, seed=7)
    th = torch.as_tensor(cfg.thresholds(), device=dev)
    got = mcam_search.mcam_search(q, s, w, th, cfg, noisy=noisy, qidx=qidx)
    want = mcam_search.mcam_search_plain(q, s, w, th, cfg, noisy=noisy,
                                         qidx=qidx)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])


@pytest.mark.parametrize("b,n,S,sl,noisy,values", PHYSICS_CASES)
def test_gathered_physics_kernel_equals_plain_bit_for_bit(dev, b, n, S, sl,
                                                          noisy, values):
    """Rows outside [0, N) give NaN; every other candidate equals the plain
    version with its global noise row."""
    q, s, w, qidx = _physics_case(dev, b, n, S, sl, values, b * n + sl)
    cfg = MCAMConfig(string_len=sl, seed=3)
    th = torch.as_tensor(cfg.thresholds(), device=dev)
    rng = np.random.default_rng(n)
    rows = torch.as_tensor(rng.integers(-2, n + 2, size=(b, 11)), device=dev)
    noise = rows + 5000
    got = mcam_search.mcam_rescore(q, s, rows, w, th, cfg, noisy=noisy,
                                   noise_rows=noise, qidx=qidx)
    inside = (rows >= 0) & (rows < n)
    want = mcam_search.mcam_rescore_plain(
        q, s, torch.where(inside, rows, 0), w, th, cfg, noisy=noisy,
        noise_rows=noise, qidx=qidx)
    torch.cuda.synchronize()
    assert torch.isnan(got[~inside]).all()
    assert torch.equal(got[inside], want[inside])


def test_gathered_entry_returns_the_dense_entrys_dist(dev):
    """with_dist: each candidate's dist equals the dense entry's at that
    (query, row), and its votes too, given the same noise coordinates."""
    q, s, w, qidx = _physics_case(dev, 9, 200, 64, 24, 4, 31)
    cfg = MCAMConfig(seed=5)
    th = torch.as_tensor(cfg.thresholds(), device=dev)
    rows = torch.arange(200, device=dev).expand(9, 200)
    votes, dist = mcam_search.mcam_rescore(q, s, rows, w, th, cfg,
                                           qidx=qidx, with_dist=True)
    dv, dd = mcam_search.mcam_search(q, s, w, th, cfg, qidx=qidx)
    pv, pd = mcam_search.mcam_rescore_plain(q, s, rows, w, th, cfg,
                                            qidx=qidx, with_dist=True)
    torch.cuda.synchronize()
    assert torch.equal(votes, dv) and torch.equal(dist, dd)
    assert torch.equal(votes, pv) and torch.equal(dist, pd)


def test_shifted_grid_takes_the_generic_instance_with_the_same_result(dev):
    """A 24-cell grid off an 8-byte boundary runs the generic cell loop and
    gives the same bits as the aligned copy through the unrolled one."""
    q, s, w, qidx = _physics_case(dev, 4, 100, 64, 24, 4, 5)
    flat = torch.cat([torch.zeros(1, dtype=torch.int8, device=dev),
                      s.reshape(-1)])
    shifted = flat[1:].view(s.shape)
    assert mcam_search.search_instance(24, q, shifted) == 0
    assert mcam_search.search_instance(24, q, s) == 24
    cfg = MCAMConfig()
    th = torch.as_tensor(cfg.thresholds(), device=dev)
    a = mcam_search.mcam_search(q, s, w, th, cfg, qidx=qidx)
    b = mcam_search.mcam_search(q, shifted, w, th, cfg, qidx=qidx)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_cheaper_forms_equal_the_plain_arithmetic_on_every_word(dev):
    forms = mcam_search.prove_forms(dev)
    assert forms == {k: 0 for k in mcam_search.PROVED_FORMS}


def test_wrappers_count_one_launch_per_call_and_check_inputs(dev):
    enc, qg, sg = _grids(14, n=64, b=2)
    cfg = avss_lib.SearchConfig("mtmc", cl=8)
    th = torch.as_tensor(cfg.mcam.thresholds(), device=dev)
    w = enc.weights_array(device=dev)
    _build.reset_launches()
    ops.mcam_search(qg.to(dev), sg.to(dev), w, cfg, th)
    ops.rescore_shortlist(qg.to(dev), sg.to(dev),
                          torch.zeros(2, 3, dtype=torch.int64, device=dev),
                          w, cfg, th)
    q = torch.zeros(2, 48, dtype=torch.int32, device=dev)
    proj = torch.zeros(64, 192, dtype=torch.bfloat16, device=dev)
    shortlist.lut_shortlist(q, proj, 5)
    mcam_dist.lut_dist_matmul(ops.query_onehot(q), proj)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {"shortlist": 1, "shortlist_blocks": 0,
                               "mcam_dist": 1, "mcam_search": 1,
                               "mcam_rescore": 1, "mcam_episode": 0,
                               "shortlist_wgmma": 0, "shortlist_mma": 0}
    with pytest.raises(ValueError, match="contiguous"):
        mcam_dist.lut_dist_matmul(ops.query_onehot(q), proj.T.contiguous().T)
    with pytest.raises(TypeError):
        mcam_dist.lut_dist_matmul(ops.query_onehot(q).half(), proj.half())
    assert _build.LAUNCHES["mcam_dist"] == 1


@pytest.mark.parametrize("mode,fmr", [("two_phase", None), ("two_phase", 1),
                                      ("ideal", None), ("ideal", 1),
                                      ("full", None)])
def test_engine_on_the_card_matches_the_cpu(dev, mode, fmr):
    """One store, programmed on the CPU and carried to the card: rows,
    distances and labels equal; votes on >= 99.9% of candidates."""
    rng = np.random.default_rng(15)
    x = rng.standard_normal((300, 48)).astype(np.float32)
    lab = rng.integers(0, 30, size=300).astype(np.int32)
    cfg = MemoryConfig(capacity=320, dim=48,
                       search=avss_lib.SearchConfig("mtmc", cl=32))
    cpu = MemoryStore.create(cfg, device="cpu").calibrate(x).write(x, lab)
    gpu = MemoryStore.from_numpy(cpu.to_numpy(), cfg)
    assert gpu.device.type == "cuda"
    eng = RetrievalEngine(cfg.search)
    req = SearchRequest(mode=mode, k=32, fused_min_rows=fmr)
    a = eng.search(gpu, x[:12], req)
    b = eng.search(cpu, x[:12], req)
    torch.cuda.synchronize()
    for f in ("dist", "indices", "labels"):
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f
    assert float((a.votes.cpu() == b.votes).float().mean()) \
        >= PHYSICS_MIN_AGREEMENT


@pytest.mark.parametrize("enc,cl,mode,req_mode", [
    ("b4e", 3, "avss", "two_phase"), ("b4e", 3, "avss", "ideal"),
    ("b4e", 3, "avss", "full"), ("sre", 4, "avss", "two_phase"),
    ("sre", 4, "avss", "full"), ("mtmc", 32, "svss", "full")])
def test_engine_on_the_card_matches_the_cpu_for_every_code(dev, enc, cl,
                                                           mode, req_mode):
    """The evaluation matrix's other codes through the engine: B4E (6
    strings a support at d = 48, 8-bit LUT fields) and SRE (8 strings,
    4-bit fields) on the fused route, and an SVSS full search (a query
    grid of L words a segment); as test_engine_on_the_card_matches_the_cpu
    holds MTMC."""
    rng = np.random.default_rng(16)
    x = rng.standard_normal((1100, 48)).astype(np.float32)
    lab = rng.integers(0, 30, size=1100).astype(np.int32)
    cfg = MemoryConfig(capacity=1100, dim=48,
                       search=avss_lib.SearchConfig(enc, cl=cl, mode=mode))
    cpu = MemoryStore.create(cfg, device="cpu").calibrate(x).write(x, lab)
    gpu = MemoryStore.from_numpy(cpu.to_numpy(), cfg)
    eng = RetrievalEngine(cfg.search)
    req = SearchRequest(mode=req_mode, k=32)
    _build.reset_launches()
    a = eng.search(gpu, x[:12], req)
    b = eng.search(cpu, x[:12], req)
    torch.cuda.synchronize()
    want = {"full": ("mcam_search",), "ideal": ("shortlist",),
            "two_phase": ("shortlist", "mcam_rescore")}[req_mode]
    assert all(_build.LAUNCHES[k] == 1 for k in want), _build.LAUNCHES
    for f in ("dist", "indices", "labels"):
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f
    assert float((a.votes.cpu() == b.votes).float().mean()) \
        >= PHYSICS_MIN_AGREEMENT


# -- the episodic physics of hardware-aware training --------------------------

# (B, N, S, sl, noisy): ragged B and N, S = 33, the unrolled sl = 24 and the
# generic instance at 13 cells, noisy and noiseless; three span several of
# the backward kernel's row tiles (32 rows) with a ragged edge, and two of
# them several query chunks (B > 128), S = 9 a string group of 8 with one
# string in it; the last has CUB's 500 strings
EPISODE_CASES = [(37, 101, 64, 24, True), (5, 67, 33, 24, True),
                 (12, 40, 64, 13, True), (9, 70, 33, 24, False),
                 (3, 17, 40, 13, False), (130, 300, 64, 24, True),
                 (70, 257, 33, 13, True), (300, 40, 9, 24, True),
                 (20, 70, 500, 24, True)]           # CUB's 500 strings
# backward kernel vs autograd through the plain forward: the same terms,
# summed in another order (the kernel: ds over b in order, dq over a
# warp's rows in a fixed tree, then over row tiles in order; autograd:
# torch's reductions), so relative to the largest gradient entry
EPISODE_GRAD_RTOL = 1e-4
EPISODE_GRAD_MIN_COSINE = 0.99999


def _episode_case(dev, b, n, S, sl, seed):
    """Grids of cell values in [0, 3] where about half the cells match
    (|q - s| = 0, the kink of abs), weights, gradients and qidx."""
    rng = np.random.default_rng(seed)
    q = torch.as_tensor(rng.integers(0, 4, size=(b, S, sl)),
                        dtype=torch.int8)
    s = torch.as_tensor(rng.integers(0, 4, size=(n, S, sl)),
                        dtype=torch.int8)
    same = torch.as_tensor(rng.random((n, S, sl)) < 0.5)
    s = torch.where(same, q[torch.arange(n) % b], s)
    w = torch.as_tensor(rng.integers(1, 4, size=S), dtype=torch.float32)
    gv = torch.as_tensor(rng.standard_normal((b, n)), dtype=torch.float32)
    gd = torch.as_tensor(rng.standard_normal((b, n)), dtype=torch.float32)
    qidx = torch.as_tensor(rng.integers(0, 2**32, size=b))
    return [t.to(dev) for t in (q, s, w, gv, gd, qidx)]


def _close(got, want):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    cos = float(torch.nn.functional.cosine_similarity(
        got.reshape(1, -1).double(), want.reshape(1, -1).double()))
    return err <= EPISODE_GRAD_RTOL * scale and cos >= \
        EPISODE_GRAD_MIN_COSINE, (err, scale, cos)


@pytest.mark.parametrize("stream", [None, 0, 0xDEADBEEF])
@pytest.mark.parametrize("b,n,S,sl,noisy", EPISODE_CASES)
def test_stream_forward_equals_plain_bit_for_bit(dev, b, n, S, sl, noisy,
                                                 stream):
    """The dense entry with a noise stream equals its plain version; the
    stream moves the noise (a noisy search with a stream differs from the
    one without), and without it the bits are the serving ones."""
    q, s, w, _, _, qidx = _episode_case(dev, b, n, S, sl, b + n)
    cfg = MCAMConfig(string_len=sl, seed=5)
    th = torch.as_tensor(cfg.thresholds(), device=dev)
    got = mcam_search.mcam_search(q, s, w, th, cfg, noisy=noisy, qidx=qidx,
                                  stream=stream)
    want = mcam_search.mcam_search_plain(q, s, w, th, cfg, noisy=noisy,
                                         qidx=qidx, stream=stream)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if stream is not None and noisy:
        base = mcam_search.mcam_search(q, s, w, th, cfg, qidx=qidx)
        torch.cuda.synchronize()
        assert not torch.equal(base[0], got[0])


@pytest.mark.parametrize("stream", [None, 77])
@pytest.mark.parametrize("b,n,S,sl,noisy", EPISODE_CASES)
def test_episode_backward_kernel_matches_plain_autograd(dev, b, n, S, sl,
                                                        noisy, stream):
    """dq and ds of the backward kernel against autograd through the plain
    forward on the card (same physics, jax.grad's kink rules), within
    EPISODE_GRAD_RTOL of the largest entry and EPISODE_GRAD_MIN_COSINE; a
    second run gives the same bits. tau = 0.5 keeps most strings on the
    sigmoid's slope."""
    q, s, w, gv, gd, qidx = _episode_case(dev, b, n, S, sl, 3 * b + n)
    cfg = MCAMConfig(string_len=sl, seed=11)
    th = torch.as_tensor(cfg.thresholds(), device=dev)
    kw = dict(noisy=noisy, qidx=qidx, stream=stream, tau=0.5)
    _build.reset_launches()
    dq, ds = mcam_episode.episode_backward(q, s, gv, gd, w, th, cfg, **kw)
    dq2, ds2 = mcam_episode.episode_backward(q, s, gv, gd, w, th, cfg, **kw)
    pq, ps = mcam_episode.episode_backward_plain(q, s, gv, gd, w, th, cfg,
                                                 **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["mcam_episode"] == 2
    assert torch.equal(dq, dq2) and torch.equal(ds, ds2)
    ok, why = _close(dq, pq)
    assert ok, ("dq", why)
    ok, why = _close(ds, ps)
    assert ok, ("ds", why)


def test_episode_backward_at_the_cub_episode(dev):
    """The backward kernel at the paper's CUB episode (50-way 5-shot, 4
    queries a class: B = 200, N = 250; d = 480, MTMC CL = 25: S = 500),
    8 row tiles x 2 query chunks, against autograd through the plain
    forward; a second run gives the same bits."""
    b, n, S, sl = 200, 250, 500, 24
    assert mcam_episode.episode_tiling(b, n) == (8, 2, 100)
    q, s, w, gv, gd, qidx = _episode_case(dev, b, n, S, sl, 500)
    cfg = MCAMConfig(sigma_device=0.15, sigma_read=0.05)
    th = torch.as_tensor(cfg.thresholds(), device=dev)
    kw = dict(noisy=True, qidx=qidx, stream=3, tau=0.02)
    dq, ds = mcam_episode.episode_backward(q, s, gv, gd, w, th, cfg, **kw)
    dq2, ds2 = mcam_episode.episode_backward(q, s, gv, gd, w, th, cfg, **kw)
    pq, ps = mcam_episode.episode_backward_plain(q, s, gv, gd, w, th, cfg,
                                                 **kw)
    torch.cuda.synchronize()
    assert torch.equal(dq, dq2) and torch.equal(ds, ds2)
    for got, want in ((dq, pq), (ds, ps)):
        ok, why = _close(got, want)
        assert ok, why


def test_shifted_grids_take_the_generic_backward_with_close_results(dev):
    """24-cell grids off an 8-byte boundary take the backward kernel's
    generic instance (byte loads, another reduction order): dq and ds
    agree with the plain version as the unrolled instance's do, and with
    the unrolled instance's on the same values within the same bounds."""
    q, s, w, gv, gd, qidx = _episode_case(dev, 40, 70, 16, 24, 5)
    cfg = MCAMConfig(string_len=24, seed=3)
    th = torch.as_tensor(cfg.thresholds(), device=dev)
    kw = dict(noisy=True, qidx=qidx, stream=5, tau=0.5)

    def shifted(g):
        buf = torch.empty(g.numel() + 1, dtype=torch.int8, device=dev)
        out = buf[1:].view(g.shape)
        out.copy_(g)
        return out
    qs, ss = shifted(q), shifted(s)
    assert mcam_search.search_instance(24, qs, ss) == 0
    dq, ds = mcam_episode.episode_backward(qs, ss, gv, gd, w, th, cfg, **kw)
    uq, us = mcam_episode.episode_backward(q, s, gv, gd, w, th, cfg, **kw)
    pq, ps = mcam_episode.episode_backward_plain(q, s, gv, gd, w, th, cfg,
                                                 **kw)
    torch.cuda.synchronize()
    for got, want in ((dq, pq), (ds, ps), (dq, uq), (ds, us)):
        ok, why = _close(got, want)
        assert ok, why


@pytest.fixture
def trainer_settings(monkeypatch):
    """The trainer's deterministic settings for one test, then torch's
    settings as they were."""
    from repro_torch.launch import train as train_lib
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", train_lib.CUBLAS_WORKSPACE)
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    train_lib.make_deterministic()
    yield
    torch.use_deterministic_algorithms(saved[0])
    torch.backends.cudnn.deterministic = saved[1]
    torch.backends.cudnn.benchmark = saved[2]


def test_meta_steps_repeat_bit_for_bit_on_the_card(dev, trainer_settings):
    """Two runs of `make_hat_train_steps`' meta step from clones of one
    state (parameters and AdamW state), two steps each on the trainer's
    step keys, give the same losses and every parameter and optimizer leaf
    bit for bit."""
    from repro_torch import tree as tree_lib
    from repro_torch.configs.omniglot_conv4 import get_smoke_config
    from repro_torch.data.fsl import EpisodeSampler, OmniglotLike
    from repro_torch.launch import train as train_lib
    from repro_torch.launch.steps import make_hat_train_steps
    from repro_torch.models.controller import apply_conv4
    from repro_torch.optim import adamw
    fsl = get_smoke_config()
    ds = OmniglotLike(24, image_size=fsl.image_size, seed=0)
    ep = EpisodeSampler(ds, np.arange(24), n_way=8, k_shot=4, n_query=4,
                        seed=2).episode(0)
    opt = adamw(1e-3)
    _, meta_step, place = make_hat_train_steps(
        apply_conv4, train_lib.hat_config(fsl), opt, n_way=8, device=dev)
    arrays = place({f: getattr(ep, f) for f in (
        "support_images", "support_labels", "query_images",
        "query_labels")})
    params = {"backbone": train_lib.init_params(fsl, 24, 0, 16,
                                                dev)["backbone"]}
    start = (params, opt.init(params))

    def run():
        p, st = tree_lib.tree_map(torch.clone, start)
        losses = []
        for step in range(2):
            p, st, loss = meta_step(p, st, arrays,
                                    train_lib.step_key(0, step))
            losses.append(float(loss))
        torch.cuda.synchronize()
        return losses, (p, st)

    def bits(x):
        return x.view(torch.int32) if x.dtype == torch.float32 else x
    a, b = run(), run()
    assert np.isfinite(a[0]).all()
    assert a[0] == b[0]
    names, xs = tree_lib.flatten_with_names(a[1])
    differ = [n for n, x, y in zip(names, xs, tree_lib.leaves(b[1]))
              if not torch.equal(bits(x), bits(y))]
    assert not differ, differ


@pytest.mark.parametrize("mode", ["avss", "svss"])
def test_episode_votes_on_the_card_match_the_plain_route(dev, mode,
                                                         monkeypatch):
    """The engine's episodic forward and backward on the card (the dense
    kernel and the backward kernel) against the same function through the
    plain route on the card: votes and dist bit for bit, the embedding
    gradients within EPISODE_GRAD_RTOL (AVSS sums the query's gradient over
    the L strings of a segment outside the kernel)."""
    from repro_torch.core.avss import SearchConfig
    rng = np.random.default_rng(21)
    qe = np.maximum(rng.standard_normal((10, 48)), 0).astype(np.float32)
    se = np.maximum(rng.standard_normal((30, 48)), 0).astype(np.float32)
    se[:10] = qe
    eng = RetrievalEngine(SearchConfig("mtmc", cl=8, mode=mode))
    R = torch.as_tensor(rng.standard_normal((10, 30)), dtype=torch.float32,
                        device=dev)

    def run():
        q = torch.tensor(qe, device=dev, requires_grad=True)
        s = torch.tensor(se, device=dev, requires_grad=True)
        r = eng.episode_votes(q, s, key=9, sa_tau=0.5)
        ((r["votes"] * R).sum() + 0.01 * (r["dist"] * R).sum()).backward()
        torch.cuda.synchronize()
        return r["votes"].detach(), r["dist"].detach(), q.grad, s.grad
    _build.reset_launches()
    kernel = run()
    assert _build.LAUNCHES["mcam_search"] == 1
    assert _build.LAUNCHES["mcam_episode"] == 1
    monkeypatch.setattr(mcam_episode, "episode_physics",
                        mcam_episode.episode_physics_plain)
    plain = run()
    assert torch.equal(kernel[0], plain[0])
    assert torch.equal(kernel[1], plain[1])
    for a, b in zip(kernel[2:], plain[2:]):
        ok, why = _close(a, b)
        assert ok, why


def test_episode_backward_refuses_what_it_does_not_take(dev):
    q, s, w, gv, gd, qidx = _episode_case(dev, 4, 20, 64, 24, 1)
    cfg = MCAMConfig()
    th = torch.as_tensor(cfg.thresholds(), device=dev)
    kw = dict(noisy=True, qidx=qidx)
    with pytest.raises(ValueError, match="contiguous"):
        mcam_episode.episode_backward(q, s.transpose(0, 1).contiguous()
                                      .transpose(0, 1), gv, gd, w, th, cfg,
                                      **kw)
    with pytest.raises(ValueError, match="tensors on"):
        mcam_episode.episode_backward(q, s, gv.cpu(), gd, w, th, cfg, **kw)
    with pytest.raises(ValueError, match="cells"):
        long_q = torch.zeros(4, 2, 65, dtype=torch.int8, device=dev)
        long_s = torch.zeros(20, 2, 65, dtype=torch.int8, device=dev)
        mcam_episode.episode_backward(long_q, long_s, gv, gd, w[:2], th,
                                      cfg, **kw)
    with pytest.raises(TypeError):
        mcam_episode.episode_backward(q.float(), s, gv, gd, w, th, cfg, **kw)


def test_train_hat_on_the_card_closes_the_loop(dev, tmp_path,
                                               trainer_settings):
    """The trainer on the card at a few steps of the smoke configuration:
    finite losses, both episodic kernels launched, the served class
    scores equal to the in-training head bit for bit, checkpoints
    written."""
    from repro_torch.launch import train as train_lib
    _build.reset_launches()
    out = train_lib.train_hat(pretrain_steps=2, meta_steps=2, n_way=4,
                              k_shot=2, n_query=2, eval_episodes=1,
                              ckpt_dir=str(tmp_path), log_every=1)
    torch.cuda.synchronize()
    assert out["parity"]
    assert np.isfinite(out["pre_losses"]).all()
    assert np.isfinite(out["meta_losses"]).all()
    assert _build.LAUNCHES["mcam_episode"] == 2
    assert _build.LAUNCHES["mcam_search"] >= 2
    assert (tmp_path / "store").is_dir()


def test_scalar_divisors_round_once_on_the_card(dev):
    """ROADMAP C.P7: CUDA divides by a CPU scalar as a multiplication by
    its reciprocal, which rounds twice. The straight-through encoders'
    gradients (g / CL, g / length) take their divisor on the gradient's
    device, so on the card they equal the CPU's bit for bit, also where
    1 / CL is not exact (CL = 25, length 3)."""
    from repro_torch.core import encodings as enc_lib
    rng = np.random.default_rng(25)
    v = torch.as_tensor(rng.integers(0, 76, size=(64, 480)),
                        dtype=torch.float32)
    g = torch.as_tensor(rng.standard_normal((64, 480, 25)),
                        dtype=torch.float32)
    for enc in (enc_lib.make_encoding("mtmc", 25),
                enc_lib.make_encoding("b4e", 3)):
        vv = v if enc.name == "mtmc" else v.clamp(max=enc.levels - 1)
        gg = g[..., :enc.length].clone()
        gg[..., 1:] = 0     # one word's gradient: sums of it are exact
        grads = []
        for d in ("cpu", dev):
            x = vv.to(d).requires_grad_(True)
            out = enc_lib.encode_words_ste(x, enc)
            (grad,) = torch.autograd.grad(out, x, gg.to(d))
            grads.append((out.detach().cpu(), grad.cpu()))
        torch.cuda.synchronize()
        assert torch.equal(grads[0][0], grads[1][0])
        assert torch.equal(grads[0][1], grads[1][1]), enc.name


# -- the routed, tenant and paged searches ---------------------------------------


def _routed_pair(dev, n=4096, shards=16, d=48, cl=32, seed=41):
    """One partitioned store programmed on the CPU and carried to the card,
    and float queries near its rows."""
    rng = np.random.default_rng(seed)
    cfg = MemoryConfig(capacity=n, dim=d,
                       search=avss_lib.SearchConfig("mtmc", cl=cl))
    x = rng.standard_normal((n, d)).astype(np.float32)
    cpu = MemoryStore.create(cfg, device="cpu").calibrate(x).write(
        x, rng.integers(0, 64, n))
    gpu = MemoryStore.from_numpy(cpu.to_numpy(), cfg)
    q = (x[rng.choice(n, 40)] + 0.3 * rng.standard_normal((40, d))).astype(
        np.float32)
    return cpu.shard(n_shards=shards), gpu.shard(n_shards=shards), q


def _same_ranks(a, b, ctx):
    for f in ("dist", "indices", "labels"):
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), (ctx, f)
    agree = float((a.votes.cpu() == b.votes).float().mean())
    assert agree >= PHYSICS_MIN_AGREEMENT, (ctx, agree)


@pytest.mark.parametrize("mode", ["two_phase", "ideal"])
@pytest.mark.parametrize("backend,fmr", [("auto", None), ("mxu", 1 << 20)])
def test_routed_search_on_the_card_matches_the_cpu(dev, mode, backend, fmr):
    """Every nprobe, the fused block route (256-row shards a query: 1,024+
    rows from nprobe 4) and the dense route: ranks equal the CPU's, votes
    on >= 99.9%; routed two_phase votes equal the full search's at the
    same global rows on the card."""
    cpu, gpu, q = _routed_pair(dev)
    eng = RetrievalEngine(gpu.cfg.search)
    for p in (1, 4, 15, 16, None):
        req = SearchRequest(mode=mode, k=64, nprobe=p, backend=backend,
                            fused_min_rows=fmr)
        _same_ranks(eng.search(gpu, q, req), eng.search(cpu, q, req),
                    (mode, backend, p))
    if mode == "two_phase":
        full = eng.search(gpu, q[:8], SearchRequest(mode="full"))
        tp = eng.search(gpu, q[:8], SearchRequest(mode="two_phase", k=64,
                                                  nprobe=2))
        torch.cuda.synchronize()
        assert torch.equal(torch.take_along_dim(full.votes, tp.indices, 1),
                           tp.votes)


def _tenant_pair(dev, caps=(300, 1024, 77, 512), d=48, seed=43):
    from repro_torch.engine import TenantStore
    rng = np.random.default_rng(seed)
    stores = []
    for i, c in enumerate(caps):
        cfg = MemoryConfig(capacity=c, dim=d,
                           search=avss_lib.SearchConfig("mtmc", cl=32))
        x = rng.standard_normal((c, d)).astype(np.float32)
        st = MemoryStore.create(cfg, device="cpu").calibrate(x)
        n = c if i % 2 == 0 else c // 2            # some slots unwritten
        stores.append(st.write(x[:n], rng.integers(0, 9, n)))
    cpu = TenantStore.stack(stores)
    gpu = TenantStore.stack([MemoryStore.from_numpy(s.to_numpy(), s.cfg)
                             for s in stores])
    q = rng.standard_normal((50, d)).astype(np.float32)
    tids = rng.integers(0, len(caps), 50)
    return cpu, gpu, stores, q, tids


@pytest.mark.parametrize("mode,backend", [("two_phase", "auto"),
                                          ("two_phase", "mxu"),
                                          ("ideal", "fused"),
                                          ("full", "auto")])
def test_tenant_search_on_the_card_matches_the_cpu(dev, mode, backend):
    """The coalesced search of 4 ragged tenants on the card: ranks equal
    the CPU's, votes on >= 99.9%; and each tenant's rows equal its solo
    search on the card bit for bit."""
    cpu, gpu, stores, q, tids = _tenant_pair(dev)
    eng = RetrievalEngine(stores[0].cfg.search, backend=backend)
    req = SearchRequest(mode=mode, k=64)
    got = eng.search_tenants(gpu, q, tids, req)
    _same_ranks(got, eng.search_tenants(cpu, q, tids, req), (mode, backend))
    for t in range(gpu.n_tenants):
        sel = np.where(tids == t)[0]
        solo = eng.search(gpu.tenant(t), q[sel], req)
        w = solo.votes.shape[1]
        for f in ("votes", "dist", "indices", "labels"):
            assert torch.equal(getattr(got, f)[sel][:, :w],
                               getattr(solo, f)), (t, f)


@pytest.mark.parametrize("mode", ["two_phase", "full"])
def test_tenant_flush_launches_do_not_depend_on_the_mix(dev, mode):
    """TenantServer on the card: every flush of 64 queries launches the
    same kernels the same number of times, whatever its tenants, one
    tenant or all of them, with writes between flushes."""
    from repro_torch.launch.serve import TenantServer
    _, gpu, stores, q, _ = _tenant_pair(dev)
    server = TenantServer(RetrievalEngine(stores[0].cfg.search), gpu,
                          SearchRequest(mode=mode, k=64))
    rng = np.random.default_rng(3)
    mixes = [np.zeros(64, int), np.arange(64) % 4, rng.integers(0, 4, 64),
             np.full(64, 3)]
    for i, mix in enumerate(mixes):
        for b, t in enumerate(mix):
            server.submit(int(t), torch.as_tensor(q[b % len(q)]))
        server.flush()
        server.write(0, rng.standard_normal((5, 48)).astype(np.float32),
                     [1, 2, 3, 4, 5])
    torch.cuda.synchronize()
    assert server.cache_entries() == 1
    assert server.flushes == len(mixes)


def test_paged_search_on_the_card_matches_the_device_twin(dev):
    """A store of the card in host memory (pinned), paged through 6 slots
    by batches whose shards overlap: every result equals the routed
    search of the device twin bit for bit and the CPU pager's ranks (votes
    on >= 99.9%), a warm batch copies no block, and the prefetch stages
    shards."""
    from repro_torch.engine import ShardPager
    cpu, gpu, q = _routed_pair(dev)
    host = gpu.shard(n_shards=16, residency="host")
    assert host.values.device.type == "cpu" and host.values.is_pinned()
    eng = RetrievalEngine(gpu.cfg.search)
    pager = ShardPager(host, eng, slots=6)
    cpu_pager = ShardPager(cpu.shard(n_shards=16, residency="host"), eng,
                           slots=6, device="cpu")
    req = SearchRequest(mode="two_phase", k=64, nprobe=2)
    for b0 in range(0, 40, 5):
        got = pager.search(q[b0:b0 + 2], req)
        want = eng.search(gpu, q[b0:b0 + 2], req)
        torch.cuda.synchronize()
        for f in ("votes", "dist", "indices", "labels"):
            assert torch.equal(getattr(got, f), getattr(want, f)), (b0, f)
        _same_ranks(got, cpu_pager.search(q[b0:b0 + 2], req), b0)
    blocks = pager.transfers["blocks"]
    pager.search(q[35:37], req)
    assert pager.transfers["blocks"] == blocks
    assert pager.transfers["staged"] > 0


# -- the mesh-sharded store (engine/sharded.py), 8 positions on the card ------


def _card_mesh(dev, shape=(8,), names=("data",)):
    from repro_torch.launch.mesh import Mesh
    return Mesh.repeat(dev, shape, names)


@pytest.mark.parametrize("shape,names,axes", [
    ((8,), ("data",), ("data",)),
    ((4, 2), ("data", "model"), ("data", "model")),
    ((4, 2), ("data", "model"), ("data",))])
@pytest.mark.parametrize("mode", ["two_phase", "ideal", "full"])
def test_sharded_search_on_the_card_equals_unsharded(dev, shape, names,
                                                     axes, mode):
    """A 4,096-row store on 8 positions of the card (fused shortlists of
    512-row shards, per-shard rescores): every result equals the
    unsharded store's search on the card bit for bit, each shard
    launching its own kernels; routed at nprobe 2 equals the logical
    partition's."""
    _, gpu, q = _routed_pair(dev)
    base = gpu._unpad()
    ms = base.shard(_card_mesh(dev, shape, names), axes)
    eng = RetrievalEngine(base.cfg.search, fused_min_rows=256)
    req = SearchRequest(mode=mode, k=64)
    want = eng.search(base, q, req)
    _build.reset_launches()
    got = eng.search(ms, q, req)
    torch.cuda.synchronize()
    for f in ("votes", "dist", "indices", "labels"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    if mode != "full":
        assert _build.LAUNCHES["shortlist"] == ms.n_shards
        assert _build.LAUNCHES["mcam_rescore"] == (
            ms.n_shards if mode == "two_phase" else 0)
        routed = SearchRequest(mode=mode, k=64, nprobe=2)
        got = eng.search(ms, q, routed)
        want = eng.search(base.shard(n_shards=ms.n_shards), q, routed)
        torch.cuda.synchronize()
        for f in ("votes", "dist", "indices", "labels"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_sharded_write_on_the_card_equals_unsharded(dev):
    """The shard-local write-through on the card (capacity 4,004 padded to
    4,008 over 8; three batches, the last wrapping across shard
    boundaries) equals the unsharded write in every leaf, its sketch the
    logical partition's."""
    rng = np.random.default_rng(5)
    cfg = MemoryConfig(capacity=4004, dim=48,
                       search=avss_lib.SearchConfig("mtmc", cl=32))
    x = rng.standard_normal((5000, 48)).astype(np.float32)
    lab = rng.integers(0, 256, 5000)
    base = MemoryStore.create(cfg, device=dev).calibrate(x)
    ms = base.shard(_card_mesh(dev))
    assert ms.capacity == 4008
    for a, b in ((0, 1500), (1500, 3000), (3000, 5000)):
        base = base.write(x[a:b], lab[a:b])
        ms = ms.write(x[a:b], lab[a:b])
    want = base.shard(n_shards=8)
    torch.cuda.synchronize()
    for f in ("values", "proj", "proj_packed", "s_grid", "labels",
              "sketch_sums", "sketch_counts"):
        assert torch.equal(getattr(ms, f).full(dev), getattr(want, f)), f
    assert int(ms.size) == 5000


# -- the LM serving path (launch/serve, the kNN-LM head) ------------------------

# card vs CPU logits of a bf16 dense smoke model: cuBLAS and the CPU round
# the same products in another order (the parity tests' BF16_LOGIT_ATOL);
# the MoE model runs in float32 (TF32 off), where a last-bit difference
# cannot move a token's experts, within LM_F32_TOL
LM_BF16_ATOL = 0.0625
LM_F32_TOL = 1e-4


@pytest.mark.parametrize("arch,dtype", [("starcoder2-3b", "bfloat16"),
                                        ("deepseek-moe-16b", "float32"),
                                        ("hymba-1.5b", "float32"),
                                        ("xlstm-350m", "float32"),
                                        ("deepseek-v3-671b", "float32"),
                                        ("musicgen-medium", "float32"),
                                        ("qwen2-vl-7b", "float32")])
def test_lm_decode_on_the_card_matches_the_cpu(dev, arch, dtype):
    """A smoke model's forward and a prefill + 6-step decode on the card
    against the same weights on the CPU, every family (attention with
    Mamba, mLSTM / sLSTM, MLA with MoE, embedding inputs with sinusoidal
    positions or M-RoPE's position streams); on the card, decoding the
    prompt gives the forward's logits."""
    import dataclasses

    from repro_torch.configs import load_config
    from repro_torch.models import transformer as tfm
    from repro_torch import tree as tree_lib
    cfg = dataclasses.replace(load_config(arch, True), dtype=dtype,
                              param_dtype=dtype)
    cpu = tfm.init(torch.Generator().manual_seed(0), cfg)
    gpu = tree_lib.tree_map(lambda a: a.to(dev), cpu)
    rng = np.random.default_rng(0)
    if cfg.input_mode == "tokens":
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (3, 10)))}
    else:
        batch = {"embeddings": torch.from_numpy(rng.standard_normal(
            (3, 10, cfg.d_model)).astype(np.float32))}
        if cfg.rope_type == "mrope":
            batch["positions3"] = torch.from_numpy(
                rng.integers(0, 30, (3, 10, 3)).astype(np.int32))
    atol = LM_BF16_ATOL if dtype == "bfloat16" else LM_F32_TOL
    rtol = 0 if dtype == "bfloat16" else LM_F32_TOL

    def close(a, b):
        np.testing.assert_allclose(a.float().cpu().numpy(),
                                   b.float().cpu().numpy(), rtol=rtol,
                                   atol=atol)

    def part(sl, d):
        return {k: v[:, sl].to(d) for k, v in batch.items()}
    fwd = tfm.forward(gpu, cfg, part(slice(0, 4), dev))[0]
    close(fwd, tfm.forward(cpu, cfg, part(slice(0, 4), "cpu"))[0])
    cc = tfm.init_cache(cfg, 3, 10, "cpu")
    gc = tfm.init_cache(cfg, 3, 10, dev)
    for pos in range(10):
        sl = slice(pos, pos + 1)
        gl, gc = tfm.decode_step(gpu, cfg, part(sl, dev), gc, pos)
        cl, cc = tfm.decode_step(cpu, cfg, part(sl, "cpu"), cc, pos)
        assert gl.device.type == dev.type
        close(gl, cl)
        if pos < 4:
            close(gl[:, 0], fwd[:, pos])


def test_lm_divisions_round_once_on_the_card(dev, monkeypatch):
    """ROADMAP C.P8: the LM's divisions by a Python number round once on
    the card, as on the CPU (CUDA would multiply by the reciprocal). With
    tanh taken out (it is no division, and libdevice's may differ from
    the CPU's by an ulp) and inputs whose other arithmetic is exact, the
    soft-capped smoke config's logits (`_logits_out`) and attention
    scores (`dot_attention`), each `tanh_cap(s, 30)`, the MoE
    load-balance aux at top_k = 6 and mLSTM's bf16 key scale
    (/ sqrt(512)) are equal on the card and the CPU bit for bit."""
    import dataclasses

    from repro_torch.configs import load_config
    from repro_torch.models import layers as L
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tfm
    monkeypatch.setattr(torch, "tanh", lambda x: x)
    monkeypatch.setattr(L, "apply_norm", lambda p, x, cfg: x)
    caps = []
    real_cap = L.tanh_cap
    monkeypatch.setattr(L, "tanh_cap",
                        lambda s, c: caps.append(real_cap(s, c)) or caps[-1])
    cfg = dataclasses.replace(load_config("starcoder2-3b", True),
                              dtype="float32", param_dtype="float32",
                              logit_softcap=30.0)
    rng = np.random.default_rng(8)
    # integer activations and weights: every product and sum exact
    x = torch.from_numpy(rng.integers(-8, 9, (3, 5, cfg.d_model)).astype(
        np.float32))
    params = {"final_norm": {}, "embed": torch.from_numpy(rng.integers(
        -8, 9, (cfg.vocab_size, cfg.d_model)).astype(np.float32))}
    q, k, v = (torch.from_numpy(rng.integers(-4, 5, (2, 6, 4, 16)).astype(
        np.float32)) for _ in range(3))
    pos = torch.arange(6, dtype=torch.int32)
    for d in ("cpu", dev):
        tfm._logits_out({n: (t.to(d) if torch.is_tensor(t) else t)
                         for n, t in params.items()}, cfg, x.to(d))
        L.dot_attention(q.to(d), k.to(d), v.to(d), qpos=pos.to(d),
                        kpos=pos.to(d), softcap=30.0)
    assert len(caps) == 4
    for a, b in ((caps[0], caps[2]), (caps[1], caps[3])):
        assert b.device.type == dev.type
        assert torch.equal(a, b.cpu())
    # the aux: two experts hold all of the (dyadic) router mass, so its
    # sums are exact and only the division by top_k rounds
    m = dataclasses.replace(load_config("deepseek-moe-16b", True).moe,
                            top_k=6)
    for trial in range(64):
        probs = np.zeros((2, 8, m.n_routed), np.float32)
        probs[..., :2] = rng.integers(0, 9, (2, 8, 2)) / 8
        sel = rng.integers(0, 2, (2, 8, m.top_k, m.n_routed)).astype(
            np.int32)
        got = [moe_lib.load_balance(torch.from_numpy(probs).to(d),
                                    torch.from_numpy(sel).to(d), m)
               for d in ("cpu", dev)]
        assert torch.equal(got[0], got[1].cpu()), trial
    kb = torch.from_numpy(rng.standard_normal(4096).astype(
        np.float32)).to(torch.bfloat16)
    assert torch.equal(L.div(kb, math.sqrt(512)),
                       L.div(kb.to(dev), math.sqrt(512)).cpu())


@pytest.mark.parametrize("mode,shards,fmr", [("two_phase", None, None),
                                             ("ideal", None, None),
                                             ("two_phase", 8, 256)])
def test_knn_head_on_the_card_equals_the_cpu(dev, mode, shards, fmr):
    """The kNN-LM head of 5 decode steps on the card: its searches launch
    the kernels, and their labels and votes equal those of the same store
    searched on the CPU (backend "ref") with the same hidden rows, bit for
    bit; the mixed log-probabilities are finite."""
    from repro_torch.configs import load_config
    from repro_torch.launch import serve as serve_lib
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import transformer as tfm
    cfg = load_config("starcoder2-3b", True)
    params = tfm.init(torch.Generator(device=dev).manual_seed(0), cfg)
    mem_cfg, gpu = serve_lib.demo_store(cfg, 0, dev)
    cpu = MemoryStore.from_numpy(gpu.to_numpy(), mem_cfg, device="cpu")
    nprobe = None
    if shards:
        gpu, cpu, nprobe = (gpu.shard(n_shards=shards),
                            cpu.shard(n_shards=shards), 2)
    eng = RetrievalEngine(mem_cfg.search,
                          **({} if fmr is None else {"fused_min_rows": fmr}))
    ref = RetrievalEngine(mem_cfg.search, backend="ref")
    req = SearchRequest(mode=mode, k=32, nprobe=nprobe)
    caches = tfm.init_cache(cfg, 4, 5, dev)
    tok = torch.zeros((4, 1), dtype=torch.int64, device=dev)
    _build.reset_launches()
    for pos in range(5):
        logits, caches, hidden = tfm.decode_step(
            params, cfg, {"tokens": tok}, caches, pos, return_hidden=True)
        q = hidden[:, 0][:, :mem_cfg.dim]
        got = eng.search(gpu, q, req)
        want = ref.search(cpu, q.cpu(), req)
        for f in ("labels", "votes", "indices"):
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), \
                (pos, f)
        mixed = steps_lib.knn_lm_head(logits, hidden, gpu, mem_cfg.dim,
                                      cfg.vocab_size, 0.3, eng, req)
        assert torch.isfinite(mixed).all()
        tok = torch.argmax(mixed[:, 0], -1)[:, None]
    torch.cuda.synchronize()
    needs = {"ideal": ("shortlist",)}.get(
        mode, ("shortlist_blocks" if shards else "shortlist",
               "mcam_rescore"))
    assert all(_build.LAUNCHES[k] > 0 for k in needs), dict(_build.LAUNCHES)


# -- LM training (launch/steps.make_train_step) ----------------------------------

# card vs CPU after two float32 train steps (TF32 off): losses within
# LM_TRAIN_RTOL and grad norms within LM_TRAIN_NORM_RTOL (measured: 6.9e-4,
# xlstm-350m, whose normaliser amplifies libdevice's last bits); every
# parameter within LM_TRAIN_RTOL of its leaf's largest entry plus
# LM_TRAIN_LR_ATOL x lr x steps, but for at most LM_TRAIN_OUTLIERS of a
# leaf's entries (one at least), which stay within the steps' update
# budget (2 x lr a step): AdamW moves a weight by about lr x g / |g|, so
# a weight whose gradient is rounding noise moves by a share of lr that
# the noise decides (measured: one entry of 16,384 at 0.08 lr,
# deepseek-v3-671b's embedding); optimizer state within
# LM_TRAIN_STATE_RTOL of its leaf's largest entry (floored at 1e-3 of the
# largest of its kind), the same share allowed within 10% of it. xLSTM's
# normaliser (1 / max(|n.q|, exp(-m))) amplifies libdevice's last bits
# into its gradients (the grad norms 6.9e-4 apart), so its moments get
# LM_TRAIN_STATE_RTOL_XLSTM (its second run on the card: 71 of 24,576
# entries of one moment beyond 1e-3)
LM_TRAIN_RTOL = 5e-4
LM_TRAIN_NORM_RTOL = 2e-3
LM_TRAIN_LR_ATOL = 0.05
LM_TRAIN_STATE_RTOL = 1e-3
LM_TRAIN_STATE_RTOL_XLSTM = 1e-2
LM_TRAIN_OUTLIERS = 1e-3
LM_TRAIN_ARCHS = ("starcoder2-3b", "llama3-405b", "qwen1.5-110b",
                  "command-r-plus-104b", "deepseek-moe-16b",
                  "deepseek-v3-671b", "xlstm-350m", "hymba-1.5b",
                  "musicgen-medium", "qwen2-vl-7b")


def _lm_train_setup(arch: str, dtype: str = "float32"):
    import dataclasses

    from repro_torch.configs import load_config
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import transformer as tfm
    cfg = dataclasses.replace(load_config(arch, True), dtype=dtype,
                              param_dtype=dtype)
    cfg = steps_lib.adapt_config(cfg, ShapeConfig("s", 16, 4, "train"))
    step, opt = steps_lib.make_train_step(cfg, TrainConfig(
        learning_rate=1e-3))
    params = tfm.init(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(1)
    batches = []
    for _ in range(2):
        lead = (2, 2, 16)
        if cfg.input_mode == "tokens":
            b = {"tokens": torch.from_numpy(rng.integers(
                0, cfg.vocab_size, lead))}
        else:
            b = {"embeddings": torch.from_numpy(rng.standard_normal(
                lead + (cfg.d_model,)).astype(np.float32))}
            if cfg.rope_type == "mrope":
                b["positions3"] = torch.from_numpy(rng.integers(
                    0, 48, lead + (3,)).astype(np.int32))
        b["labels"] = torch.from_numpy(rng.integers(-1, cfg.vocab_size,
                                                    lead))
        batches.append(b)
    return cfg, step, opt, params, batches


def _run_train(step, opt, params, batches, device):
    from repro_torch import tree as tree_lib
    p = tree_lib.tree_map(lambda a: a.clone().to(device), params)
    s = opt.init(p)
    metrics = []
    for b in batches:
        p, s, m = step(p, s, {k: v.to(device) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return p, s, metrics


@pytest.mark.parametrize("arch", LM_TRAIN_ARCHS)
def test_lm_train_step_on_the_card_matches_the_cpu(dev, arch):
    """Two float32 train steps (accumulation over 2 microbatches, labels
    with -1) of every smoke family on the card against the CPU."""
    from repro_torch import tree as tree_lib
    _, step, opt, params, batches = _lm_train_setup(arch)
    gp, gs, gm = _run_train(step, opt, params, batches, dev)
    cp, cs, cm = _run_train(step, opt, params, batches, "cpu")
    for a, b in zip(gm, cm):
        assert a["applied"] == b["applied"] == 1.0
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=LM_TRAIN_RTOL)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"],
                                   rtol=LM_TRAIN_NORM_RTOL)
    lr, steps = 1e-3, len(batches)
    pnames, pleaves = tree_lib.flatten_with_names(gp)
    for n, g, c in zip(pnames, pleaves, tree_lib.leaves(cp)):
        assert g.device.type == dev.type
        w = c.float().numpy()
        tight = LM_TRAIN_RTOL * np.abs(w).max() + LM_TRAIN_LR_ATOL * lr * steps
        _mostly_close(n, g, w, tight, tight + 2 * lr * steps)
    names, gl = tree_lib.flatten_with_names(gs)
    cl = tree_lib.leaves(cs)
    tops = {}
    for n, c in zip(names, cl):
        tops[n.split("//")[0]] = max(tops.get(n.split("//")[0], 0.0),
                                     float(c.float().abs().max()))
    for n, g, c in zip(names, gl, cl):
        w = c.float().numpy()
        scale = max(np.abs(w).max(), 1e-3 * tops[n.split("//")[0]])
        rtol = (LM_TRAIN_STATE_RTOL_XLSTM if arch == "xlstm-350m"
                else LM_TRAIN_STATE_RTOL)
        _mostly_close(n, g, w, rtol * scale, 0.1 * scale)


def _mostly_close(name: str, got: torch.Tensor, want: np.ndarray,
                  tight: float, loose: float) -> None:
    """Every entry within `loose`, and all but LM_TRAIN_OUTLIERS of them
    (one at least) within `tight`."""
    diff = np.abs(got.float().cpu().numpy() - want)
    assert diff.max() <= loose, (name, float(diff.max()), loose)
    off = int((diff > tight).sum())
    assert off <= max(1, int(LM_TRAIN_OUTLIERS * diff.size)), (name, off)


@pytest.mark.parametrize("arch", ["starcoder2-3b", "deepseek-moe-16b",
                                  "xlstm-350m", "hymba-1.5b"])
def test_lm_train_steps_repeat_bit_for_bit_on_the_card(dev, arch,
                                                       trainer_settings):
    """Under `make_deterministic`, two runs of two bf16 train steps from
    the same start give the same metrics and every parameter and
    optimizer leaf bit for bit."""
    from repro_torch import tree as tree_lib
    _, step, opt, params, batches = _lm_train_setup(arch, "bfloat16")
    runs = [_run_train(step, opt, params, batches, dev) for _ in range(2)]
    assert runs[0][2] == runs[1][2]
    for a, b in zip(tree_lib.leaves(runs[0][:2]),
                    tree_lib.leaves(runs[1][:2])):
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))


def test_train_step_divisions_round_once_on_the_card(dev):
    """ROADMAP C.P7 / C.P8 in the train step: `g / accum` at accum 3 and
    the int8 codec's `/ 127` are once-rounded divisions on the card (a
    multiplication by the reciprocal would round twice), equal to the
    CPU's bit for bit."""
    from repro_torch.models import layers as L
    from repro_torch.runtime import compression
    rng = np.random.default_rng(5)
    for dt in (torch.float32, torch.bfloat16):
        g = torch.from_numpy(rng.standard_normal(1 << 16).astype(
            np.float32)).to(dt)
        assert torch.equal(L.div(g, 3), L.div(g.to(dev), 3).cpu())
    # the reciprocal's product differs somewhere: the test can fail
    assert not torch.equal(L.div(g.float(), 3), g.float() * (1 / 3))
    x = {"a": torch.from_numpy((rng.standard_normal(4096) * 3).astype(
        np.float32))}
    qc, sc = compression.compress(x)
    qg, sg = compression.compress({"a": x["a"].to(dev)})
    assert torch.equal(sc["a"], sg["a"].cpu())
    assert torch.equal(qc["a"], qg["a"].cpu())
    amax = x["a"].abs().amax()
    assert torch.equal(sc["a"], torch.div(amax, torch.tensor(127.0))
                       + 1e-20)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_placed_train_step_on_the_card_equals_unplaced(dev, optimizer,
                                                      trainer_settings):
    """starcoder2-3b smoke in bf16, 3 steps: the step with parameters,
    state and batch placed on a (2, 2, 2) mesh of positions of the card
    (`param_shardings` / `opt_shardings` / `input_specs`, under
    `active_mesh`) equals the unplaced step on the card bit for bit
    (adamw updates block by block, adafactor assembled)."""
    from repro_torch import tree as tree_lib
    from repro_torch.configs import load_config
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.models.sharding import (Placed, active_mesh, place,
                                             rules_for_mesh)
    cfg = load_config("starcoder2-3b", smoke=True)
    tc = TrainConfig(learning_rate=1e-3, optimizer=optimizer)
    mesh = Mesh.repeat(dev, (2, 2, 2), ("pod", "data", "model"))
    rules = rules_for_mesh(mesh)
    rng = np.random.default_rng(4)
    batch = {k: torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 4, 32)).astype(np.int32)).to(dev)
        for k in ("tokens", "labels")}
    params0 = tfm.init(torch.Generator(device=dev).manual_seed(0), cfg)
    runs = []
    for placed in (False, True):
        with active_mesh(mesh, rules):
            step, opt = S.make_train_step(cfg, tc,
                                          rules=rules if placed else None)
            p = tree_lib.tree_map(torch.clone, params0)
            s = opt.init(p)
            b = batch
            if placed:
                aps = tfm.abstract_params(cfg)
                psh = S.param_shardings(cfg, mesh, rules)
                p = place(p, psh)
                s = place(s, S.opt_shardings(opt.init(aps), aps, psh, mesh,
                                             rules))
                specs = S.input_specs(cfg, ShapeConfig("c", 32, 8, "train",
                                                       4), mesh, rules)
                b = place(batch, {k: v.sharding for k, v in specs.items()})
            metrics = []
            for _ in range(3):
                p, s, m = step(p, s, b)
                metrics.append({k: float(v) for k, v in m.items()})
        if placed:      # one block a key: the positions share the card
            assert all(len(reps) == 1 for x in tree_lib.leaves((p, s))
                       for reps in x.tiles.values())
        leaves = [x.full() if isinstance(x, Placed) else x
                  for x in tree_lib.leaves((p, s))]
        runs.append((metrics, leaves))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert a.device.type == dev.type
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))


def test_pipeline_on_the_card_equals_the_sequential_loop(dev):
    """`pipeline_apply` over a (4,) "pipe" mesh of positions of the card
    (S = 4 tanh(h @ W) stages, M = 6 microbatches) equals the sequential
    loop over each microbatch on the card bit for bit."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.runtime.pipeline import pipeline_apply
    gen = torch.Generator(device=dev).manual_seed(0)
    Ws = torch.randn((4, 256, 256), generator=gen, device=dev) / 16.0
    x = torch.randn((6, 64, 256), generator=gen, device=dev)
    got = pipeline_apply(lambda W, h: torch.tanh(h @ W), Ws, x,
                         Mesh.repeat(dev, (4,), ("pipe",)))
    assert got.device.type == dev.type
    for m in range(6):
        h = x[m]
        for i in range(4):
            h = torch.tanh(h @ Ws[i])
        assert torch.equal(got[m], h), m


def test_hat_place_on_the_card_equals_unplaced(dev, trainer_settings):
    """The HAT meta step on a smoke episode placed over a (4,) "data" mesh
    of positions of the card equals the unplaced meta step on the card
    bit for bit, launching the same kernels."""
    from repro_torch import tree as tree_lib
    from repro_torch.configs.omniglot_conv4 import get_smoke_config
    from repro_torch.data.fsl import EpisodeSampler, OmniglotLike
    from repro_torch.launch import steps as S
    from repro_torch.launch import train as t_train
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.controller import apply_conv4
    from repro_torch.models.sharding import Placed
    from repro_torch.optim import adamw
    fsl = get_smoke_config()
    ds = OmniglotLike(n_classes=fsl.n_train_classes, image_size=fsl.image_size,
                      seed=0)
    ep = EpisodeSampler(ds, np.arange(fsl.n_train_classes), n_way=fsl.n_way,
                        k_shot=fsl.k_shot, n_query=4, seed=1).episode(0)
    arrays = {k: getattr(ep, k) for k in ("support_images", "support_labels",
                                          "query_images", "query_labels")}
    runs = []
    for mesh in (None, Mesh.repeat(dev, (4,), ("data",))):
        opt = adamw(1e-4)
        _, meta, place_fn = S.make_hat_train_steps(
            apply_conv4, t_train.hat_config(fsl), opt, n_way=fsl.n_way,
            device=dev, mesh=mesh)
        params = {"backbone": t_train.init_params(
            fsl, fsl.n_train_classes, 0, 8, dev)["backbone"]}
        state = opt.init(params)
        placed = place_fn(arrays)
        assert all(isinstance(v, Placed) for v in placed.values()) == (
            mesh is not None)
        _build.reset_launches()
        params, state, loss = meta(params, state, placed,
                                   t_train.step_key(0, 0))
        torch.cuda.synchronize()
        runs.append((float(loss), dict(_build.LAUNCHES),
                     tree_lib.leaves((params, state))))
    assert runs[0][0] == runs[1][0] and runs[0][1] == runs[1][1]
    for a, b in zip(runs[0][2], runs[1][2]):
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))


@pytest.mark.parametrize("tf32", [False, True])
def test_router_bucket_sums_on_the_card_equal_the_cpus(dev, tf32):
    """The sketch's one-hot product of int32 octets in float32 is exact
    on the card too, with TF32 products allowed or not, past one
    product's 65,536 rows and with int32 sums that wrap."""
    from repro_torch.engine import router
    rng = np.random.default_rng(5)
    for lo, hi in ((0, 97), (-(1 << 31), 1 << 31)):
        values = torch.from_numpy(rng.integers(lo, hi, size=(70_000, 48))
                                  .astype(np.int32))
        labels = torch.from_numpy(rng.integers(-1, 4096, size=(70_000,))
                                  .astype(np.int32))
        want = router.bucket_sums(values, labels)
        kept = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            got = router.bucket_sums(values.to(dev), labels.to(dev))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = kept
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
