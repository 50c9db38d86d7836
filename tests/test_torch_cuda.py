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
from repro_torch.kernels import _build, mcam_dist, ops
from repro_torch.kernels import shortlist

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)

PHYSICS_MIN_AGREEMENT = 0.999   # kernel vs plain votes, per (query, row)


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


@pytest.mark.parametrize("b,n,k,dtype", [(37, 1001, 190, torch.bfloat16),
                                         (64, 512, 192, torch.float32),
                                         (256, 4096, 192, torch.bfloat16)])
def test_lut_dist_kernel_matches_plain(dev, b, n, k, dtype):
    rng = np.random.default_rng(b)
    a = torch.as_tensor(rng.integers(0, 2, size=(b, k))).to(dtype)
    s = torch.as_tensor(rng.integers(0, 97, size=(n, k))).to(dtype)
    got = mcam_dist.lut_dist_matmul(a.to(dev), s.to(dev))
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
    """dist exact; votes on >= 99.9% of pairs (precise libdevice against
    the CPU's libm); the gathered entry equals the dense entry at the same
    (query, global row), noise rows and query coordinates included."""
    enc, qg, sg = _grids(13)
    cfg = avss_lib.SearchConfig("mtmc", cl=8, noisy=noisy)
    th = torch.as_tensor(cfg.mcam.thresholds())
    w = enc.weights_array()
    qidx = torch.tensor([3, 2**31 + 1, 0, 9, 4, 5, 6, 7])
    pv, pd = ops.mcam_search(qg, sg, w, cfg, th, qidx=qidx)
    kv, kd = ops.mcam_search(qg.to(dev), sg.to(dev), w.to(dev), cfg,
                             th.to(dev), qidx=qidx.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(kd.cpu(), pd)
    assert float((kv.cpu() == pv).float().mean()) >= PHYSICS_MIN_AGREEMENT
    rows = torch.topk(-kd, 16, dim=1).indices
    rv = ops.rescore_shortlist(qg.to(dev), sg.to(dev), rows, w.to(dev), cfg,
                               th.to(dev), noise_qidx=qidx.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(rv, torch.take_along_dim(kv, rows, dim=1))
    # shard-local rows with global noise rows: equal to the dense search
    # of a store in which those rows sit at their global position
    big = torch.zeros((400,) + tuple(sg.shape[1:]), dtype=torch.int8)
    big[100:] = sg
    bv, _ = ops.mcam_search(qg.to(dev), big.to(dev), w.to(dev), cfg,
                            th.to(dev), qidx=qidx.to(dev))
    lv = ops.rescore_shortlist(qg.to(dev), sg.to(dev), rows, w.to(dev), cfg,
                               th.to(dev), noise_idx=rows + 100,
                               noise_qidx=qidx.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(lv, torch.take_along_dim(bv, rows + 100, dim=1))


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
                               "mcam_search": 1, "mcam_rescore": 1}
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
