"""Parity of the port's kernel layer (`repro_torch.kernels`) with the JAX
package's, on the CPU.

On the CPU each wrapper runs its kernel's plain PyTorch version, so the
cases below hold the plain versions against the JAX functions: the
shortlist and the LUT product against their Pallas kernels in interpret
mode, the string physics against `kernels/ref.py::mcam_search_ref` (the
Pallas string-search kernel does not run on the installed JAX: it calls
`pl.load`). The CUDA kernels are held against these plain versions on
the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import avss as j_avss
from repro.core import encodings as j_enc
from repro.kernels import mcam_dist as j_mcam_dist
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.kernels.shortlist import lut_shortlist_pallas
from repro_torch.core import avss as t_avss
from repro_torch.core import encodings as t_enc
from repro_torch.kernels import _build, mcam_dist, mcam_search
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels import shortlist

torch.set_num_threads(1)


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def pack_words(proj: np.ndarray, bits: int) -> np.ndarray:
    """The packed layout of `ops.pack_projection`, in numpy: column m of a
    word holds projection columns {w * dp + m}."""
    wpi = 32 // bits
    n, c = proj.shape
    dp = -(-c // wpi)
    p = np.zeros((n, dp * wpi), np.int64)
    p[:, :c] = proj
    parts = p.reshape(n, wpi, dp)
    shifts = (np.arange(wpi, dtype=np.int64) * bits)[None, :, None]
    words = (parts << shifts).sum(1) & 0xFFFFFFFF
    return words.astype(np.uint32).view(np.int32)


# -- fused shortlist -----------------------------------------------------------

# operand form -> (pack_bits or None, stored dtype, largest LUT entry)
OPERANDS = {"packed4": (4, None, 15), "packed8": (8, None, 255),
            "packed16": (16, None, 4000), "packed32": (32, None, 60000),
            "bf16": (None, torch.bfloat16, 255),
            "f32": (None, torch.float32, 60000)}

# case -> (N, d, k, fraction of rows masked, distinct LUT values)
CASES = {"k1": (300, 12, 1, 0.0, None),
         "k7_masked_in_topk": (40, 12, 7, 0.9, None),
         "ties_k_eq_n": (64, 6, 64, 0.3, 2),
         "ragged_n": (257, 12, 7, 0.2, None)}


def _shortlist_inputs(operand, case, seed=0):
    bits, dtype, vmax = OPERANDS[operand]
    n, d, k, masked, distinct = CASES[case]
    rng = np.random.default_rng(seed)
    hi = (distinct or vmax + 1)
    proj = rng.integers(0, hi, size=(n, 4 * d)).astype(np.int64)
    q = rng.integers(0, 4, size=(5, d)).astype(np.int32)
    valid = rng.random(n) >= masked if masked else None
    if valid is not None and case == "k7_masked_in_topk":
        valid[:] = False
        valid[[3, 17, 30]] = True        # 3 valid rows < k: masked rows rank
    return bits, dtype, proj, q, valid, k  # after them inside the top-k


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("operand", list(OPERANDS))
def test_lut_shortlist_matches_pallas_interpret(operand, case):
    """Distances and rows equal the Pallas kernel's, in (distance, row)
    order with ties, masked rows and ragged N (exact: integer distances)."""
    bits, dtype, proj, q, valid, k = _shortlist_inputs(operand, case)
    q1h = jax.nn.one_hot(jnp.asarray(q), 4, dtype=jnp.float32).reshape(
        q.shape[0], -1)
    jvalid = None if valid is None else jnp.asarray(valid)
    tvalid = None if valid is None else torch.as_tensor(valid)
    if bits is not None:
        words = pack_words(proj, bits)
        jd, ji = lut_shortlist_pallas(q1h, None, k, valid=jvalid,
                                      packed=jnp.asarray(words),
                                      pack_bits=bits)
        td, ti = shortlist.lut_shortlist(
            torch.as_tensor(q), None, k, valid=tvalid,
            packed=torch.as_tensor(words), pack_bits=bits)
    else:
        jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
        jd, ji = lut_shortlist_pallas(q1h.astype(jdt),
                                      jnp.asarray(proj, jdt), k, valid=jvalid)
        td, ti = shortlist.lut_shortlist(
            torch.as_tensor(q), torch.as_tensor(proj).to(dtype), k,
            valid=tvalid)
    assert td.dtype == torch.float32 and ti.dtype == torch.int64
    np.testing.assert_array_equal(np.asarray(jd), _np(td))
    np.testing.assert_array_equal(np.asarray(ji), _np(ti))


def test_selection_orders_ties_by_row_not_by_topk():
    """Trap: torch.topk promises no order among equal values. The port
    selects on one int64 key (distance << 32 | row): all-equal distances
    come back in row order."""
    dist = torch.zeros(2, 50)
    dist[1, ::2] = 1.0
    d, rows = shortlist.select_topk(dist, 50)
    assert rows[0].tolist() == list(range(50))
    assert rows[1].tolist() == list(range(1, 50, 2)) + list(range(0, 50, 2))
    assert d[1].tolist() == [0.0] * 25 + [1.0] * 25


def test_lut_shortlist_rejects_what_it_does_not_take():
    q = torch.zeros(2, 3, dtype=torch.int32)
    proj = torch.zeros(10, 12)
    with pytest.raises(ValueError):
        shortlist.lut_shortlist(q, proj, 11)              # k > N
    with pytest.raises(ValueError):
        shortlist.lut_shortlist(q, proj, 0)
    with pytest.raises(ValueError):
        shortlist.lut_shortlist(q, torch.zeros(10, 8), 2)  # width != 4d
    with pytest.raises(ValueError):
        shortlist.lut_shortlist(q, None, 2, packed=torch.zeros(
            10, 2, dtype=torch.int32), pack_bits=8)        # 12 cols > 2 x 4
    with pytest.raises(TypeError):
        shortlist.lut_shortlist(q, None, 2, packed=torch.zeros(10, 3),
                                pack_bits=32)


@pytest.mark.parametrize("b,n,row_words,k", [
    (256, 65536, 48, 64), (16, 65536, 48, 64), (1, 5017, 16, 1024),
    (300, 257, 12, 7), (256, 65536, 192, 1024), (4, 10000, 16384, 1024)],
    ids=["main_path", "b16", "b1_kmax", "b300_ragged", "f32_kmax",
         "windowed"])
def test_shortlist_plan_fits_a_block_and_covers_every_row(b, n, row_words,
                                                          k):
    """The one-table select's cut (host side of csrc/shortlist.cu, 8-bit
    fields on the tensor cores). The wgmma path (k <= 64, rows of whole
    16-byte segments): 128 queries a block in two warpgroups, rows whole
    in tiles of 128 where they fit 3 columns of 64 bytes (else 256-row
    tiles in 64-byte K-columns), a ring of 4 slots, one block an SM. The
    mma path: 16 queries a warp, P >= 2 max(k, 64) keys a query, whole
    rows of up to 64 words staged with the masks resident and wider rows
    in K-chunks of whole k-steps. Both: shared memory within one block's
    227 KB, slices of whole tiles that cover N exactly once, at least k
    rows a slice where a compact key's row bits allow it (at most 2**(31
    - bits(255 row words + 1)) rows), persistent blocks within one wave,
    and merge scratch for every slice's list."""
    plan = shortlist.shortlist_plan(b, n, row_words, k)
    assert plan.path == ("wgmma" if k <= 64 and row_words % 4 == 0
                         else "mma")
    if plan.path == "wgmma":
        boxes = -(-4 * row_words // 64)
        assert plan.whole == (boxes <= 3)
        assert plan.chunk == (row_words if plan.whole else 16)
        assert plan.warps == 8 and plan.queries == 128
        assert plan.stages == shortlist._WG_STAGES == 4
        assert plan.tile_rows == (128 if plan.whole else 256)
        assert plan.keys == 64 + 128 and plan.ctas_per_sm == 1
        assert plan.smem == shortlist._wgmma_smem(plan.whole,
                                                  plan.stages) <= 232448
    else:
        whole = row_words <= 64
        assert plan.whole == whole
        assert plan.chunk == (8 * -(-row_words // 8) if whole
                              else shortlist._ONE_CHUNK)
        assert plan.chunk % 8 == 0 and plan.stages == shortlist._ONE_STAGES
        stride = plan.chunk + 4
        qb = 16 * plan.warps
        assert plan.queries == qb and plan.tile_rows == 64
        assert plan.smem == (qb * plan.keys * 4 + 4 * stride * (
            plan.stages * (64 + (0 if whole else qb)) + (qb if whole else 0))
        ) <= 232448
        assert plan.warps in (1, 2, 4) and plan.warps <= max(1, -(-b // 16))
        assert plan.keys >= 2 * max(k, 64)
        assert plan.keys & (plan.keys - 1) == 0
        assert plan.ctas_per_sm == min(2048 // (32 * plan.warps),
                                       233472 // (plan.smem + 1024)) >= 1
    assert plan.mask_words == 8 * -(-row_words // 8)
    assert plan.slice_rows % plan.tile_rows == 0
    assert (plan.slices - 1) * plan.slice_rows < n <= \
        plan.slices * plan.slice_rows
    most = 1 << (31 - (255 * row_words + 1).bit_length())
    assert plan.slice_rows <= most
    assert plan.slices == 1 or plan.slice_rows >= min(k, most)
    assert plan.blocks <= min(plan.units(b), plan.ctas_per_sm * 132)
    group = 2048 // (1 << (k - 1).bit_length())
    a, bb = plan.scratch(b, k)
    assert a == b * plan.slices * k
    assert bb == b * max(1, -(-plan.slices // group)) * k
    if (b, n, k) == (256, 65536, 64):
        # the main path: the wgmma select, 2 query tiles x 64 slices of
        # 1,024 rows: 128 units, one round of the 132 SMs
        assert plan.path == "wgmma" and plan.whole
        assert plan.units(b) == plan.blocks == 128


def test_shortlist_plan_refuses_what_no_block_can_hold():
    with pytest.raises(ValueError, match="shared"):
        shortlist.shortlist_plan(1, 4096, 4, 4096)


def _blocks_mixes(rng, b, p, m):
    """Visit lists (B, p) that stress the block entry's unit grid: spread
    at random, every query on the same p blocks, each block's count just
    above a tile (most partial tiles), and a quarter of the ids outside
    [0, M) (the virtual block)."""
    spread = np.stack([rng.choice(m, size=min(p, m), replace=False)
                       for _ in range(b)])
    same = np.tile(np.arange(p) % m, (b, 1))
    ragged = (np.arange(b * p) // 17 % m).reshape(b, p)
    outside = spread.copy()
    outside[rng.random(outside.shape) < 0.25] = m
    return {"spread": spread, "same": same, "ragged": ragged,
            "outside": outside}


@pytest.mark.parametrize("b,p,m,rows,row_words,k", [
    (256, 8, 64, 1024, 48, 64), (256, 1, 64, 1024, 48, 64),
    (256, 1, 64, 4096, 48, 64), (256, 8, 64, 1024, 480, 64),
    (256, 8, 64, 1024, 48, 1024)],
    ids=["omniglot_nprobe8", "nprobe1", "tenant_stack", "cub_nprobe8",
         "k_max"])
def test_block_plan_fits_a_block_and_covers_every_row(b, p, m, rows,
                                                      row_words, k):
    """The block-table entry's cut (host side of csrc/shortlist.cu): the
    select block's shared memory within one block's 227 KB, 8-bit fields
    on the MMA with its 16 mask rows; the units of any mix cover every row
    of every visited block exactly once, once per tile of up to 4 x warps
    pairs, and fit the grid's unit slots; each query's lists fit the
    merge scratch."""
    plan = shortlist.shortlist_blocks_plan(b, p, m, rows, row_words, k,
                                           mma=True)
    static = 16 * (4 + 8 + 4 + 4)
    stride = 8 * -(-row_words // 8) + 4
    chunk_stride = 8 * -(-plan.chunk // 8) + 4
    assert plan.smem == (plan.warps * 4 * plan.keys * 8 + 16 * stride * 4
                         + plan.stages * 64 * chunk_stride * 4
                         + 16 * 72 * 4) <= 232448 - static
    assert plan.warps in (1, 2, 4) and plan.keys // 2 >= k
    assert plan.ctas_per_sm == min(2048 // (32 * plan.warps),
                                   233472 // (plan.smem + static + 1024)) >= 1
    assert plan.chunk % 8 == 0 and plan.chunk <= 64
    assert plan.stages == (2 if plan.chunk >= row_words else 3)
    qb = 4 * plan.warps
    assert plan.tiles == -(-b * p // qb) + min(m + 1, b * p)
    group = 2048 // (1 << (k - 1).bit_length())
    assert plan.scratch(b, k) == (b * plan.lists * k,
                                  b * max(1, -(-plan.lists // group)) * k)
    rng = np.random.default_rng(b + p + rows + k)
    for name, ids in _blocks_mixes(rng, b, p, m).items():
        counts = np.bincount(ids.reshape(-1), minlength=m + 1)
        units = 0
        for g, c in enumerate(counts):
            if c == 0:
                continue
            ranges = 1 if g == m else plan.ranges(int(c), rows)
            units += -(-c // qb) * ranges
            if g == m:
                continue
            assert 1 <= ranges <= plan.split
            ur = plan.range_rows(rows, ranges)
            assert ur % 64 == 0
            covered = np.zeros(rows, np.int64)
            for r in range(ranges):
                covered[r * ur:min(rows, (r + 1) * ur)] += 1
            assert (covered == 1).all(), (name, g)
        assert units == plan.units_in_use(counts, rows), name
        assert units <= plan.units, name
        lists = [sum(1 if g == m else plan.ranges(int(counts[g]), rows)
                     for g in row) for row in ids]
        assert max(lists) <= plan.lists, name


# -- the LUT product -----------------------------------------------------------


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_lut_dist_matmul_matches_pallas_interpret(dtype):
    rng = np.random.default_rng(1)
    q = rng.integers(0, 4, size=(8, 48))
    s = rng.integers(0, 97 if dtype == "bf16" else 5000,
                     size=(300, 192)).astype(np.float32)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))
    q1h_j = jax.nn.one_hot(jnp.asarray(q), 4, dtype=jdt).reshape(8, -1)
    ref = j_mcam_dist.lut_dist_matmul(q1h_j, jnp.asarray(s, jdt))
    got = mcam_dist.lut_dist_matmul(t_ops.query_onehot(torch.as_tensor(q),
                                                       tdt),
                                    torch.as_tensor(s).to(tdt))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(ref), _np(got))


def test_lut_dist_matmul_plain_is_the_product_on_ragged_shapes():
    rng = np.random.default_rng(2)
    a = torch.as_tensor(rng.integers(0, 3, size=(37, 190)).astype(np.float32))
    b = torch.as_tensor(rng.integers(0, 90, size=(101, 190))
                        .astype(np.float32))
    np.testing.assert_array_equal(_np(mcam_dist.lut_dist_matmul(a, b)),
                                  _np(a.double() @ b.double().T))
    with pytest.raises(TypeError):
        mcam_dist.lut_dist_matmul(a, b.to(torch.bfloat16))
    with pytest.raises(ValueError):
        mcam_dist.lut_dist_matmul(a, b[:, :10])


def test_lut_dist_route_follows_the_shapes():
    """bf16 goes to the tensor cores, through TMA only where a descriptor
    can describe the rows (depth a multiple of 8, 16-byte aligned bases);
    f32 stays on the exact SIMT route."""
    bf, f32 = torch.bfloat16, torch.float32
    assert mcam_dist.dist_route(bf, 192, 0, 4096) == mcam_dist.ROUTE_TMA
    for k, addr in ((190, 4096), (188, 4096), (192, 4102), (0, 4096)):
        assert mcam_dist.dist_route(bf, k, 0, addr) == mcam_dist.ROUTE_RAGGED
    assert mcam_dist.dist_route(f32, 192, 0, 4096) == \
        mcam_dist.ROUTE_SIMT_F32


def test_avss_ideal_dist_matches_reference():
    je, te = j_enc.make_encoding("mtmc", 8), t_enc.make_encoding("mtmc", 8)
    rng = np.random.default_rng(3)
    v = rng.integers(0, je.levels, size=(64, 48)).astype(np.int32)
    q = rng.integers(0, 4, size=(8, 48)).astype(np.int32)
    ref = jax.jit(lambda q, v: j_ops.avss_ideal_dist(q, v, je))(
        jnp.asarray(q), jnp.asarray(v))
    got = t_ops.avss_ideal_dist(torch.as_tensor(q), torch.as_tensor(v), te)
    np.testing.assert_array_equal(np.asarray(ref), _np(got))
    lut = j_enc.avss_sum_lut(je)
    np.testing.assert_array_equal(
        np.asarray(j_ref.avss_dist_ref(jnp.asarray(q), jnp.asarray(v),
                                       jnp.asarray(lut))),
        _np(t_ref.avss_dist_ref(torch.as_tensor(q), torch.as_tensor(v),
                                torch.as_tensor(lut))))


# -- projection, packing, one-hot ----------------------------------------------

# encodings whose bf16 projection packs into 4 / 8 / 16 / 32-bit fields
PACKINGS = [("mtmc", 4, 4), ("mtmc", 32, 8), ("b4e", 5, 16), ("b4e", 8, 32)]


@pytest.mark.parametrize("name,cl,bits", PACKINGS)
def test_projection_and_pack_match_reference(name, cl, bits):
    """Trap: with 4-bit fields the top field reaches bit 31 and the int32
    word goes negative; torch.sum over int32 would promote to int64. The
    port packs in int64 and wraps explicitly; words must be equal."""
    je, te = j_enc.make_encoding(name, cl), t_enc.make_encoding(name, cl)
    rng = np.random.default_rng(bits)
    d = 6 if bits == 32 else 11
    v = rng.integers(0, je.levels, size=(40, d)).astype(np.int32)
    if bits == 4:
        v[0] = 0                       # LUT[3, 0] = 12 lands in bit 31
    jp = j_ops.support_projection(jnp.asarray(v), je)
    tp = t_ops.support_projection(torch.as_tensor(v), te)
    assert tp.dtype == torch.bfloat16
    np.testing.assert_array_equal(np.asarray(jp, np.float32),
                                  _np(tp.float()))
    for dt in (torch.bfloat16, torch.float32):
        jdt = jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32
        assert t_ops.projection_pack_bits(te, dt) == \
            j_ops.projection_pack_bits(je, jdt)
    assert t_ops.projection_pack_bits(te) == bits
    jw = np.asarray(j_ops.pack_projection(jp, je))
    tw = _np(t_ops.pack_projection(tp, te))
    assert tw.dtype == np.int32
    np.testing.assert_array_equal(jw, tw)
    if bits == 4:
        assert (tw < 0).any()
    back = shortlist.unpack_projection(torch.as_tensor(tw), bits, 4 * d)
    np.testing.assert_array_equal(_np(back), _np(tp.float()))


def test_query_onehot_and_string_helpers_match():
    rng = np.random.default_rng(4)
    q = rng.integers(0, 4, size=(5, 7)).astype(np.int32)
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float32, torch.float32)):
        np.testing.assert_array_equal(
            np.asarray(j_ops.query_onehot(jnp.asarray(q), jdt), np.float32),
            _np(t_ops.query_onehot(torch.as_tensor(q), tdt).float()))
    g = rng.integers(0, 4, size=(3, 2, 1, 24)).astype(np.int8)
    np.testing.assert_array_equal(
        np.asarray(j_ops.flatten_strings(
            j_ops.broadcast_query(jnp.asarray(g), 5))),
        _np(t_ops.flatten_strings(t_ops.broadcast_query(
            torch.as_tensor(g), 5))))


# -- string physics ------------------------------------------------------------


def _physics_inputs(seed, n=40, b=3, cl=8, d=48):
    je, te = j_enc.make_encoding("mtmc", cl), t_enc.make_encoding("mtmc", cl)
    rng = np.random.default_rng(seed)
    v = rng.integers(0, je.levels, size=(n, d)).astype(np.int32)
    q = rng.integers(0, 4, size=(b, d)).astype(np.int32)
    sg = _np(t_avss.layout_support(torch.as_tensor(v), te)).astype(np.int8)
    qg = _np(t_avss.layout_query(torch.as_tensor(q), te, "avss")
             ).astype(np.int8)
    return je, te, qg, sg


@pytest.mark.parametrize("noisy", [False, True])
def test_mcam_search_matches_ref_oracle(noisy):
    """The dense string search against `kernels/ref.py::mcam_search_ref`.
    dist is exact (integer mismatch sums). Votes: exp() and the cell sum
    order differ from XLA's by ulps, so a current within ulps of a
    threshold may flip one string's vote; >= 99% of (query, row) pairs
    agree (measured: all). Trap: the physics uses exp(m * f32(log rho)),
    as the Pallas kernel does, never rho ** m."""
    je, te, qg, sg = _physics_inputs(10)
    jcfg = j_avss.SearchConfig("mtmc", cl=8, noisy=noisy)
    tcfg = t_avss.SearchConfig("mtmc", cl=8, noisy=noisy)
    th = jcfg.mcam.thresholds()
    L = sg.shape[2]
    qs = np.array(j_ops.flatten_strings(
        j_ops.broadcast_query(jnp.asarray(qg), L)))
    ss = sg.reshape(sg.shape[0], -1, sg.shape[-1])
    w = np.tile(np.asarray(je.weights, np.float32), sg.shape[1])
    jv, jd = jax.jit(lambda *a: j_ref.mcam_search_ref(
        *a, jcfg.mcam, noisy=noisy))(jnp.asarray(qs), jnp.asarray(ss),
                                     jnp.asarray(w), jnp.asarray(th))
    tv, td = t_ops.mcam_search(torch.as_tensor(qg), torch.as_tensor(sg),
                               te.weights_array(), tcfg,
                               torch.as_tensor(th))
    np.testing.assert_array_equal(np.asarray(jd), _np(td))
    assert (np.asarray(jv) == _np(tv)).mean() >= 0.99
    # the port's own oracle is the same function
    rv, rd = t_ref.mcam_search_ref(torch.as_tensor(qs), torch.as_tensor(ss),
                                   torch.as_tensor(w), torch.as_tensor(th),
                                   tcfg.mcam, noisy=noisy)
    np.testing.assert_array_equal(_np(rd), _np(td))
    assert (_np(rv) == _np(tv)).mean() >= 0.99


def test_search_instance_follows_length_and_alignment():
    """The unrolled instance takes strings of SPECIALISED_SL cells whose
    grids start on an 8-byte boundary; any other length or a shifted view
    takes the generic cell loop."""
    sl = mcam_search.SPECIALISED_SL
    g = torch.zeros(9, 4, sl, dtype=torch.int8)
    assert mcam_search.search_instance(sl, g, g) == sl
    assert mcam_search.search_instance(sl, g[3:], g) == sl   # 3 * 96 bytes
    shifted = torch.zeros(4 * sl + 1, dtype=torch.int8)[1:].view(1, 4, sl)
    assert shifted.data_ptr() % 8 != 0
    assert mcam_search.search_instance(sl, g, shifted) == 0
    for other in (sl - 1, sl + 1, 16, 32):
        h = torch.zeros(2, 4, other, dtype=torch.int8)
        assert mcam_search.search_instance(other, h, h) == 0


_FAKE_NVCC = """#!/bin/sh
# stands in for nvcc: writes the -o file unless the source name holds
# "bad", and reports when it started and ended
out=""; src=""
while [ $# -gt 0 ]; do
  case "$1" in -o) out="$2"; shift;; *.cu) src="$1";; esac; shift
done
echo "start $(date +%s.%N)"
sleep 1
echo "end $(date +%s.%N)"
case "$src" in *bad*) echo "error in $src"; exit 2;; esac
echo "ptxas info    : Used 8 registers" && touch "$out"
"""


def test_build_runs_every_nvcc_together(tmp_path, monkeypatch):
    """The sources build in parallel: every nvcc starts before any ends.
    A failing source raises with its log, leaves no library, and does
    not keep the others from being built."""
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("one", "two", "three", "four", "bad"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    logs = _build.build(("one", "two", "three"))
    assert set(logs) == {"one", "two", "three"}
    starts = [float(t.split()[1]) for t in logs.values()
              for t in t.splitlines() if t.startswith("start")]
    ends = [float(t.split()[1]) for t in logs.values()
            for t in t.splitlines() if t.startswith("end")]
    assert max(starts) < min(ends)
    assert all(_build.library_path(n).exists() for n in logs)
    assert _build.ptxas_report(logs["one"]) == [
        "ptxas info    : Used 8 registers"]
    assert _build.build(("one", "two")) == {}        # cached by content
    with pytest.raises(RuntimeError, match="error in .*bad.cu"):
        _build.build(("bad", "four"))
    assert not _build.library_path("bad").exists()
    assert _build.library_path("four").exists()
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_rescore_shortlist_with_noise_coordinates_matches_reference():
    """Gathered candidates with global noise rows (shard offsets) and
    per-query coordinates (one >= 2**31): votes agree with the JAX rescore
    on >= 99% of candidates, and equal the port's own dense search at the
    same (query, global row) exactly -- the two_phase == full contract."""
    je, te, qg, sg = _physics_inputs(11, n=50, b=4)
    jcfg = j_avss.SearchConfig("mtmc", cl=8)
    tcfg = t_avss.SearchConfig("mtmc", cl=8)
    th = jcfg.mcam.thresholds()
    rng = np.random.default_rng(12)
    idx = np.stack([rng.choice(50, 9, replace=False) for _ in range(4)])
    nidx = idx + 100
    nq = np.array([5, 2**31 + 3, 0, 77], np.uint32)
    jv = jax.jit(lambda q, s, i, w, t, ni, nq: j_ops.rescore_shortlist(
        q, s, i, w, jcfg, t, noise_idx=ni, noise_qidx=nq))(
            jnp.asarray(qg), jnp.asarray(sg), jnp.asarray(idx),
            je.weights_array(), jnp.asarray(th), jnp.asarray(nidx),
            jnp.asarray(nq))
    tv = t_ops.rescore_shortlist(
        torch.as_tensor(qg), torch.as_tensor(sg), torch.as_tensor(idx),
        te.weights_array(), tcfg, torch.as_tensor(th),
        noise_idx=torch.as_tensor(nidx),
        noise_qidx=torch.as_tensor(nq.astype(np.int64)))
    assert tv.shape == (4, 9)
    assert (np.asarray(jv) == _np(tv)).mean() >= 0.99
    # the same rows through the dense entry (noise row = global row)
    big = np.zeros((150,) + sg.shape[1:], np.int8)
    big[100:] = sg
    dv, _ = t_ops.mcam_search(torch.as_tensor(qg), torch.as_tensor(big),
                              te.weights_array(), tcfg, torch.as_tensor(th),
                              qidx=torch.as_tensor(nq.astype(np.int64)))
    np.testing.assert_array_equal(np.take_along_axis(_np(dv), nidx, 1),
                                  _np(tv))


# -- dispatch ------------------------------------------------------------------


def test_kernel_wrappers_refuse_a_device_they_do_not_run_on():
    """Tensors split between the CPU and another device, or on a device
    that is neither the CPU nor a CUDA device, raise; no wrapper quietly
    runs the plain version instead. Only on the meta device, where a
    trace runs on shapes alone (analysis/cost.py), do the wrappers run
    their plain versions -- for shapes, onto meta outputs."""
    meta = torch.empty(4, 3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        shortlist.lut_shortlist(meta, torch.empty(6, 12), 2)
    with pytest.raises(ValueError, match="device"):
        mcam_dist.lut_dist_matmul(torch.empty(4, 8, device="meta"),
                                  torch.empty(5, 8))
    g = torch.empty(2, 4, 24, dtype=torch.int8, device="meta")
    gc = torch.zeros(2, 4, 24, dtype=torch.int8)
    w, th = torch.ones(4), torch.ones(8)
    cfg = t_avss.SearchConfig().mcam
    with pytest.raises(ValueError, match="device"):
        mcam_search.mcam_search(g, gc, w, th, cfg)
    with pytest.raises(ValueError, match="device"):
        mcam_search.mcam_rescore(gc, g, torch.zeros(2, 1, dtype=torch.int64),
                                 w, th, cfg)
    # the meta device: shapes only
    d, r = shortlist.lut_shortlist(meta, torch.empty(6, 12, device="meta"),
                                   2)
    assert d.device.type == r.device.type == "meta"
    assert tuple(d.shape) == tuple(r.shape) == (4, 2)
    out = mcam_dist.lut_dist_matmul(torch.empty(4, 8, device="meta"),
                                    torch.empty(5, 8, device="meta"))
    assert out.device.type == "meta" and tuple(out.shape) == (4, 5)


def test_cuda_request_without_a_card_raises(monkeypatch):
    """Without a card the default-device store and a failed kernel build
    raise; nothing gives way to the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.core.memory import MemoryConfig
    from repro_torch.engine import MemoryStore
    cfg = MemoryConfig(capacity=4, dim=8)
    for call in (lambda: MemoryStore.create(cfg),
                 lambda: MemoryStore.create(cfg, device="cuda"),
                 lambda: MemoryStore.from_quantized(
                     np.zeros((2, 8), np.int32), np.zeros(2, np.int32),
                     cfg.search)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(_build, "BUILD_DIR",
                        _build.BUILD_DIR.parent / "build-never-created")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(("mcam_dist",))
    assert not _build.BUILD_DIR.exists()


@pytest.mark.parametrize("B,N", [(800, 2000), (80, 200), (130, 300),
                                 (70, 257), (300, 40), (1, 1), (0, 5),
                                 (5, 0), (16383, 33), (20000, 7)])
def test_episode_tiling_covers_every_query_and_row(B, N):
    """The backward kernel's tiling: the row tiles cover the N rows, the
    query chunks cover the B queries, none is empty, and a chunk is at
    most QUERY_CHUNK queries (the kernel's shared-memory hash prefixes);
    at the paper's episode 63 tiles and 7 chunks of 115 queries."""
    from repro_torch.kernels import mcam_episode
    tiles, chunks, per = mcam_episode.episode_tiling(B, N)
    assert tiles * mcam_episode.ROW_TILE >= N > (tiles - 1) * 32 or N == 0
    assert 1 <= per <= mcam_episode.QUERY_CHUNK
    assert chunks * per >= B and (chunks == 0) == (B == 0)
    assert chunks == 0 or (chunks - 1) * per < B      # the last is not empty
    if (B, N) == (800, 2000):
        assert (tiles, chunks, per) == (63, 7, 115)


# -- the legacy raw-word search wrappers ---------------------------------------


@pytest.fixture(scope="module")
def legacy_words():
    """64 support rows and 8 queries of d = 48 words (MTMC CL = 8), the
    geometry of the reference's test_two_phase_matches_full_search."""
    rng = np.random.default_rng(11)
    levels = t_enc.make_encoding("mtmc", 8).levels
    return (rng.integers(0, 4, size=(8, 48)).astype(np.int32),
            rng.integers(0, levels, size=(64, 48)).astype(np.int32))


def test_search_quantized_equals_the_reference(legacy_words):
    """`core.avss.search_quantized` (the dense string search of raw words)
    equals the reference's bit for bit in votes and dist, with the same
    iteration count; the reference runs its `ref` backend (C.R1)."""
    q, s = legacy_words
    jcfg = j_avss.SearchConfig("mtmc", cl=8, mode="avss", use_kernel="ref")
    want = jax.jit(lambda a, b: j_avss.search_quantized(a, b, jcfg))(
        jnp.asarray(q), jnp.asarray(s))
    got = t_avss.search_quantized(torch.from_numpy(q), torch.from_numpy(s),
                                  t_avss.SearchConfig("mtmc", cl=8,
                                                      mode="avss"))
    for f in ("votes", "dist"):
        assert got[f].shape == (8, 64), f
        np.testing.assert_array_equal(_np(got[f]), _np(want[f]), err_msg=f)
    assert got["iterations"] == int(want["iterations"])


@pytest.mark.parametrize("k", [64, 24])
def test_two_phase_search_equals_the_reference(legacy_words, k):
    """`kernels.ops.two_phase_search` (an anonymous store searched on the
    `mxu` backend) equals the reference's bit for bit in votes, dist and
    indices, at k = N (every row rescored) and k < N."""
    q, s = legacy_words
    jcfg = j_avss.SearchConfig("mtmc", cl=8, mode="avss", use_kernel="ref")
    want = jax.jit(lambda a, b: j_ops.two_phase_search(a, b, jcfg, k=k))(
        jnp.asarray(q), jnp.asarray(s))
    got = t_ops.two_phase_search(torch.from_numpy(q), torch.from_numpy(s),
                                 t_avss.SearchConfig("mtmc", cl=8,
                                                     mode="avss"), k=k)
    for f in ("votes", "dist", "indices"):
        assert got[f].shape == (8, k), f
        np.testing.assert_array_equal(_np(got[f]), _np(want[f]), err_msg=f)
    assert got["iterations"] == int(want["iterations"])
