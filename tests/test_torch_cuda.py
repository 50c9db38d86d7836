"""The hand-written CUDA kernels of `repro_torch` against their plain
PyTorch versions, on an NVIDIA GPU. Every test here needs the card and
skips where there is none; the module imports torch and numpy only, so it
runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda.py

(`--noconftest` because tests/conftest.py imports JAX.)
"""

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


@pytest.mark.parametrize("b,n,k,dtype,vmax", [
    (37, 1001, 190, torch.bfloat16, 96),     # ragged route: K % 8 != 0
    (16, 1001, 188, torch.bfloat16, 255),    # ragged route, B < 64
    (300, 4099, 400, torch.bfloat16, 96),    # ragged route, 7 K blocks
    (256, 4096, 192, torch.bfloat16, 96),    # TMA route, the main shapes
    (300, 4099, 384, torch.bfloat16, 96),    # TMA route, ring refilled
    (5, 130, 8, torch.bfloat16, 255),        # TMA route, one short K block
    (64, 512, 192, torch.float32, 96),
    (37, 1001, 190, torch.float32, 60000)])  # f32 entries above 2**11
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
                 (9, 257, 64, 24, True, 256)]


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
    assert _build.LAUNCHES == {"shortlist": 1, "mcam_dist": 1,
                               "mcam_search": 1, "mcam_rescore": 1,
                               "mcam_episode": 0}
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


# -- the episodic physics of hardware-aware training --------------------------

# (B, N, S, sl, noisy): ragged B and N, S = 33, the unrolled sl = 24 and the
# generic instance at 13 cells, noisy and noiseless; the last three span
# several of the backward kernel's row tiles (32 rows) with a ragged edge,
# and two of them several query chunks (B > 128), S = 9 a string group of
# 8 with one string in it
EPISODE_CASES = [(37, 101, 64, 24, True), (5, 67, 33, 24, True),
                 (12, 40, 64, 13, True), (9, 70, 33, 24, False),
                 (3, 17, 40, 13, False), (130, 300, 64, 24, True),
                 (70, 257, 33, 13, True), (300, 40, 9, 24, True)]
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
