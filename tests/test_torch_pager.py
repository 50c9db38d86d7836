"""Parity of the port's host pager (`repro_torch.engine.pager.ShardPager`,
`MemoryStore.shard(residency="host")`) with the JAX package's, on the CPU.

Mirrors tests/test_pager.py case by case: every paged search equals the
routed search of a device-resident twin and the JAX pager's result, bit
for bit; the LRU, the prefetch and the residency sets follow the JAX
pager's; and a paged store goes through save -> restore in both packages.
JAX's "transfer-guard clean" steady state becomes a count: after warm-up
a batch whose shards are all resident copies no block, only the query
batch (`ShardPager.transfers`).
"""

import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.avss import SearchConfig as JSearchConfig
from repro.engine import MemoryStore as JStore
from repro.engine import RetrievalEngine as JEngine
from repro.engine import SearchRequest as JRequest
from repro.engine.pager import ShardPager as JPager
from repro_torch.core.avss import SearchConfig
from repro_torch.engine import (MemoryStore, RetrievalEngine, SearchRequest,
                                ShardPager)

torch.set_num_threads(1)

N, DIM, S = 144, 12, 8
LEAVES = ("votes", "dist", "indices", "labels")


@pytest.fixture(scope="module")
def paged_fixture():
    """(host store, device twin, engine, jax store, queries): one store of
    8 shards in both residencies, with masked labels."""
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 16, (N, DIM))
    labs = np.arange(N) % 9
    labs[labs % 4 == 3] = -1
    tcfg = SearchConfig("mtmc", cl=8, mode="avss", use_kernel="mxu")
    jcfg = JSearchConfig("mtmc", cl=8, mode="avss", use_kernel="mxu")
    store = MemoryStore.from_quantized(vals, labs, tcfg, device="cpu")
    js = JStore.from_quantized(jnp.asarray(vals), jnp.asarray(labs), jcfg)
    q = rng.integers(0, 4, (5, DIM))
    return (store.shard(n_shards=S, residency="host"),
            store.shard(n_shards=S), RetrievalEngine(tcfg),
            js.shard(n_shards=S, residency="host"), q)


def _pager(host, eng, **kw):
    return ShardPager(host, eng, device="cpu", **kw)


def _assert_equal(a, b, ctx=""):
    for f in LEAVES:
        got = getattr(a, f)
        want = getattr(b, f)
        if isinstance(want, torch.Tensor):
            assert torch.equal(got, want), (ctx, f)
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"{ctx}: {f}")


@pytest.fixture(scope="module")
def jax_pager(paged_fixture):
    """One JAX pager of S slots (it compiles its search per instance)."""
    js = paged_fixture[3]
    return JPager(js, JEngine(js.cfg.search), slots=S)


@pytest.mark.parametrize("mode", ["two_phase", "ideal"])
@pytest.mark.parametrize("nprobe", [1, 3, S])
def test_paged_search_bit_identical_to_device_twin(paged_fixture, jax_pager,
                                                   mode, nprobe):
    host, dev, eng, _, q = paged_fixture
    req = dict(mode=mode, k=10, nprobe=nprobe)
    got = _pager(host, eng, slots=S).search(q, SearchRequest(**req))
    _assert_equal(got, eng.search(dev, q, SearchRequest(**req)), "twin")
    _assert_equal(got, jax_pager.search(jnp.asarray(q), JRequest(**req)),
                  "jax")


def test_host_store_leaves_live_on_the_host(paged_fixture):
    host, dev, _, _, _ = paged_fixture
    assert host.residency == "host" and host.n_shards == S
    assert all(getattr(host, f).device.type == "cpu"
               for f in ("values", "proj", "proj_packed", "s_grid"))
    for f in ("values", "proj", "proj_packed", "s_grid", "labels",
              "sketch_sums", "sketch_counts"):
        assert torch.equal(getattr(host, f), getattr(dev, f)), f


def test_steady_state_copies_only_the_batch(paged_fixture):
    """After warm-up, a batch whose shards are resident copies no block,
    only its query words, visit lists and key bases; a batch whose shards
    were evicted pages them back in, with the same results."""
    host, dev, eng, _, q = paged_fixture
    pager = _pager(host, eng, slots=4, prefetch=False)
    req = SearchRequest(mode="two_phase", k=8, nprobe=2)
    pager.search(q, req)                          # warm-up: pages in
    blocks = pager.transfers["blocks"]
    assert blocks > 0
    batch = pager.transfers["batch"]
    res = pager.search(q, req)
    assert pager.transfers["blocks"] == blocks    # all resident: no block
    assert pager.transfers["batch"] - batch == (
        q.size * 4 + q.shape[0] * 2 * 8 + pager.slots * 8)
    _assert_equal(res, eng.search(dev, q, req))
    pager.ensure([s for s in range(S) if s not in pager.resident()][:4])
    before = pager.pages_in
    _assert_equal(pager.search(q, req), eng.search(dev, q, req))
    assert pager.pages_in > before and pager.transfers["blocks"] > blocks


def test_lru_eviction_and_warm_hits(paged_fixture):
    """2 slots, one-query batches: shards page in and out, residency
    follows the JAX pager's, repeats are warm hits."""
    host, dev, eng, js, _ = paged_fixture
    rng = np.random.default_rng(1)
    pager = _pager(host, eng, slots=2, prefetch=False)
    jpager = JPager(js, JEngine(js.cfg.search), slots=2, prefetch=False)
    req = dict(mode="two_phase", k=6, nprobe=1)
    queries = [rng.integers(0, 4, (1, DIM)) for _ in range(8)]
    seen = set()
    for q1 in queries:
        _assert_equal(pager.search(q1, SearchRequest(**req)),
                      eng.search(dev, q1, SearchRequest(**req)))
        jpager.search(jnp.asarray(q1), JRequest(**req))
        assert pager.resident() == jpager.resident()
        assert len(pager.resident()) <= 2
        seen.update(pager.resident())
    assert len(seen) > 2, "the fixture never evicted"
    assert pager.pages_in == jpager.pages_in
    before = pager.pages_in
    pager.search(queries[-1], SearchRequest(**req))
    assert pager.pages_in == before and pager.hits > 0


def test_prefetch_stages_a_spare_shard(paged_fixture):
    """With room, the shard the batch would visit next is staged after
    the search (the JAX pager's pick); consuming it installs it."""
    host, _, eng, js, q = paged_fixture
    pager = _pager(host, eng, slots=4, prefetch=True)
    jpager = JPager(js, JEngine(js.cfg.search), slots=4, prefetch=True)
    pager.search(q[:1], SearchRequest(mode="ideal", k=6, nprobe=2))
    jpager.search(jnp.asarray(q[:1]), JRequest(mode="ideal", k=6, nprobe=2))
    assert sorted(pager._staged) == sorted(jpager._staged)
    assert len(pager._staged) == 1
    staged = next(iter(pager._staged))
    assert staged not in pager.resident()
    pager.ensure([staged])
    assert staged in pager.resident() and not pager._staged
    assert pager.staged_hits == 1 and pager.transfers["staged"] > 0


def test_batch_union_exceeding_slots_raises(paged_fixture):
    host, _, eng, _, q = paged_fixture
    pager = _pager(host, eng, slots=2)
    with pytest.raises(ValueError, match="device slots"):
        pager.search(q, SearchRequest(mode="ideal", k=6, nprobe=2))


def test_constructor_validation(paged_fixture):
    host, _, eng, _, _ = paged_fixture
    with pytest.raises(ValueError, match="slots"):
        _pager(host, eng, slots=S + 1)
    with pytest.raises(ValueError, match="partitioned"):
        _pager(host._unpad(), eng)


def test_nprobe_required_and_bounded(paged_fixture):
    host, _, eng, _, q = paged_fixture
    pager = _pager(host, eng, slots=4)
    with pytest.raises(ValueError, match="nprobe"):
        pager.search(q, SearchRequest(mode="ideal", k=4))
    with pytest.raises(ValueError, match="nprobe"):
        pager.search(q, SearchRequest(mode="ideal", k=4, nprobe=S + 1))
    with pytest.raises(ValueError, match="nprobe"):
        _pager(host, eng, slots=2).search(q, SearchRequest(mode="ideal", k=4,
                                                           nprobe=3))


def test_paged_store_save_restore_across_packages(paged_fixture):
    """save() -> restore() -> shard(residency="host") reproduces every
    leaf and every paged search, whichever package wrote the files."""
    host, _, eng, js, q = paged_fixture
    req = dict(mode="two_phase", k=10, nprobe=2)
    want = _pager(host, eng, slots=S).search(q, SearchRequest(**req))
    for writer in ("torch", "jax"):
        with tempfile.TemporaryDirectory() as td:
            (host if writer == "torch" else js).save(td, 0)
            back = MemoryStore.restore(td, host.cfg, device="cpu").shard(
                n_shards=S, residency="host")
            jback = JStore.restore(td, js.cfg).shard(n_shards=S,
                                                     residency="host")
        for f in ("values", "proj", "proj_packed", "s_grid", "labels",
                  "sketch_sums", "sketch_counts", "lo", "hi", "size"):
            assert torch.equal(getattr(host, f), getattr(back, f)), f
            np.testing.assert_array_equal(
                getattr(host, f).float().numpy(),
                np.asarray(getattr(jback, f), np.float32), err_msg=f)
        assert back.residency == "host" and back.n_shards == S
        _assert_equal(_pager(back, eng, slots=S).search(
            q, SearchRequest(**req)), want, writer)


def test_write_on_a_host_store_keeps_it_paged(paged_fixture):
    """A ring write on a host store stays in host memory and rebuilds the
    sketch; the pager over it equals the device twin written alike."""
    host, dev, eng, _, q = paged_fixture
    rng = np.random.default_rng(5)
    x = rng.normal(size=(20, DIM)).astype(np.float32)
    lab = rng.integers(0, 9, 20)
    cal = MemoryStore.create(host.cfg, device="cpu").calibrate(x)
    h2 = cal.write(x, lab).shard(n_shards=S, residency="host")
    d2 = cal.write(x, lab).shard(n_shards=S)
    h2 = h2.write(x[:5], lab[:5])
    d2 = d2.write(x[:5], lab[:5])
    assert h2.residency == "host" and h2.values.device.type == "cpu"
    req = SearchRequest(mode="two_phase", k=6, nprobe=3)
    _assert_equal(_pager(h2, eng, slots=S).search(q, req),
                  eng.search(d2, q, req))
