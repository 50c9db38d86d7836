"""Parity of the port's router and logical partitions
(`repro_torch.engine.router`, `MemoryStore.shard(n_shards=S)`,
`RetrievalEngine.search(nprobe=p)`) with the JAX package's, on the CPU.

Mirrors tests/test_router.py case by case. Every leaf is compared bit for
bit: sketches, router scores and picks, and the routed search's votes,
dist, indices and labels (noisy two_phase votes included: the JAX side
runs under `jax.jit`, and at these sizes every vote agrees). The fixture
is tie-heavy (every row repeated 9x across the shard boundaries) and has
masked rows inside the top-k, so only an exact (distance, global row)
order over the visited shards passes.
"""

import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.avss import SearchConfig as JSearchConfig
from repro.core.memory import MemoryConfig as JMemoryConfig
from repro.engine import MemoryStore as JStore
from repro.engine import RetrievalEngine as JEngine
from repro.engine import SearchRequest as JRequest
from repro.engine import router as j_router
from repro_torch.core.avss import SearchConfig
from repro_torch.core.memory import MemoryConfig
from repro_torch.engine import (MemoryStore, RetrievalEngine, SearchRequest,
                                build_sketch, route_scores, top_shards)
from repro_torch.engine import router as t_router

torch.set_num_threads(1)

N_SHARDS = 8
ROWS = 72          # 9 rows a shard
DIM = 20
K = 12
LEAVES = ("votes", "dist", "indices", "labels")


def _cfgs(backend="ref", cl=8):
    return (JSearchConfig("mtmc", cl=cl, mode="avss", use_kernel=backend),
            SearchConfig("mtmc", cl=cl, mode="avss", use_kernel=backend))


@functools.cache
def _jax_search(search_cfg, request):
    return jax.jit(lambda store, q: JEngine(search_cfg).search(store, q,
                                                               request))


def jax_search(store, q, **req):
    return _jax_search(store.cfg.search, JRequest(**req))(store,
                                                          jnp.asarray(q))


def assert_same(jres, tres, ctx=""):
    for f in LEAVES:
        want = np.asarray(getattr(jres, f))
        got = getattr(tres, f).numpy()
        assert got.shape == want.shape, (ctx, f)
        np.testing.assert_array_equal(got, want, err_msg=f"{ctx}: {f}")
    np.testing.assert_array_equal(tres.predict().numpy(),
                                  np.asarray(jres.predict()), err_msg=ctx)


def assert_torch_same(a, b, ctx=""):
    for f in LEAVES:
        assert torch.equal(getattr(a, f), getattr(b, f)), (ctx, f)


@pytest.fixture(scope="module")
def routed_fixture():
    """{backend: (jax store, port store)} of the 72-row tie-heavy store in
    8 shards, and 5 query words."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, 16, (8, DIM))
    vals = np.concatenate([base] * 9)                        # ties galore
    labs = np.arange(ROWS) % 9
    labs[labs % 4 == 0] = -1                                 # masked rows
    q = rng.integers(0, 4, (5, DIM))
    stores = {}
    for backend in ("ref", "mxu", "fused"):
        jcfg, tcfg = _cfgs(backend)
        stores[backend] = (
            JStore.from_quantized(jnp.asarray(vals), jnp.asarray(labs),
                                  jcfg).shard(n_shards=N_SHARDS),
            MemoryStore.from_quantized(vals, labs, tcfg, device="cpu")
            .shard(n_shards=N_SHARDS))
    return stores, q


@pytest.mark.parametrize("backend", ["ref", "mxu", "fused"])
@pytest.mark.parametrize("mode", ["two_phase", "ideal"])
@pytest.mark.parametrize("nprobe", [1, 4, 7])
def test_routed_bit_identical_to_restricted_brute_force(
        routed_fixture, backend, mode, nprobe):
    """The routed search equals the JAX package's, and the exhaustive
    search filtered to the visited shards, on every leaf."""
    stores, q = routed_fixture
    js, ts = stores[backend]
    fmr = 1 if backend == "fused" else None
    req = dict(mode=mode, k=K, nprobe=nprobe, fused_min_rows=fmr)
    routed = RetrievalEngine(ts.cfg.search).search(ts, q,
                                                   SearchRequest(**req))
    assert_same(jax_search(js, q, **req), routed, f"{backend}/{mode}")
    full = RetrievalEngine(ts.cfg.search).search(ts, q, SearchRequest(
        mode=mode, k=ts.capacity, fused_min_rows=fmr))
    sids = top_shards(route_scores(ts.quantize_queries(q), ts.sketch_sums,
                                   ts.sketch_counts, ts.cfg.search.enc),
                      nprobe)
    rows = ts.capacity // N_SHARDS
    for b in range(q.shape[0]):
        keep = torch.isin(full.indices[b] // rows, sids[b])
        for f in LEAVES:
            assert torch.equal(getattr(routed, f)[b],
                               getattr(full, f)[b][keep][:K]), (b, f)


@pytest.mark.parametrize("mode", ["two_phase", "ideal"])
def test_nprobe_none_and_all_shards_byte_identical(routed_fixture, mode):
    """nprobe=None, = S and > S are the exhaustive search, byte for byte,
    and equal the JAX package's."""
    stores, q = routed_fixture
    js, ts = stores["mxu"]
    eng = RetrievalEngine(ts.cfg.search)
    base = eng.search(ts, q, SearchRequest(mode=mode, k=K))
    assert_same(jax_search(js, q, mode=mode, k=K), base, mode)
    for p in (N_SHARDS, N_SHARDS + 3):
        assert_torch_same(base, eng.search(ts, q, SearchRequest(
            mode=mode, k=K, nprobe=p)), f"nprobe={p}")


def test_nprobe_on_unpartitioned_store_is_exhaustive(routed_fixture):
    """S = 1: any nprobe is the plain search."""
    _, q = routed_fixture
    rng = np.random.default_rng(3)
    _, tcfg = _cfgs("mxu")
    store = MemoryStore.from_quantized(rng.integers(0, 16, (24, DIM)),
                                       rng.integers(0, 5, (24,)), tcfg,
                                       device="cpu")
    assert store.n_shards == 1
    eng = RetrievalEngine(tcfg)
    assert_torch_same(
        eng.search(store, q, SearchRequest(mode="two_phase", k=6)),
        eng.search(store, q, SearchRequest(mode="two_phase", k=6, nprobe=1)))


def test_router_prefers_the_matching_shard():
    """A query at one shard's class centroid routes there first, and
    nprobe=1 then retrieves the right class."""
    _, tcfg = _cfgs("ref")
    vals = np.array([[2] * DIM] * 4 + [[13] * DIM] * 4)
    store = MemoryStore.from_quantized(vals, [0] * 4 + [1] * 4, tcfg,
                                       device="cpu").shard(n_shards=2)
    q = torch.tensor([[0] * DIM, [3] * DIM])
    sids = top_shards(route_scores(q, store.sketch_sums,
                                   store.sketch_counts, tcfg.enc), 1)
    assert sids[:, 0].tolist() == [0, 1]
    res = RetrievalEngine(tcfg).search(store, q, SearchRequest(
        mode="ideal", k=2, nprobe=1))
    assert res.predict().tolist() == [0, 1]


def test_router_functions_match_reference():
    """Sketch sums / counts, centroids, scores and top-p picks exact
    against the JAX package, with tied scores and empty buckets."""
    jcfg, tcfg = _cfgs("ref", cl=32)
    rng = np.random.default_rng(9)
    vals = rng.integers(0, tcfg.enc.levels, (96, DIM))
    labs = rng.integers(-1, 11, (96,))
    labs[:12] = -1                                    # an empty shard
    js, jc = j_router.build_sketch(jnp.asarray(vals), jnp.asarray(labs), 8)
    ts, tc = build_sketch(torch.as_tensor(vals), torch.as_tensor(labs), 8)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(
        t_router.sketch_centroids(ts, tc, tcfg.enc.levels).numpy(),
        np.asarray(j_router.sketch_centroids(js, jc, jcfg.enc.levels)))
    q = rng.integers(0, 4, (7, DIM))
    q[3] = q[2]
    want = np.asarray(jax.jit(lambda q_: j_router.route_scores(
        q_, js, jc, jcfg.enc))(jnp.asarray(q)))
    got = route_scores(torch.as_tensor(q), ts, tc, tcfg.enc)
    np.testing.assert_array_equal(got.numpy(), want)
    tied = torch.tensor([[5.0, 3.0, 3.0, 5.0, 3.0, 9.0, 0.5, 3.0]])
    for scores in (got, tied):
        for p in (1, 3, 8):
            np.testing.assert_array_equal(
                top_shards(scores, p).numpy(),
                np.asarray(j_router.top_shards(jnp.asarray(scores.numpy()),
                                               p)))


def _programmed(rng, capacity, n_write=16):
    """(jax store, port store) created, calibrated on a dyadic sample
    (exact reductions in float32) and written with the same rows."""
    jcfg, tcfg = _cfgs("ref")
    sample = (rng.integers(-24, 25, (n_write, DIM)) / 4.0).astype(
        np.float32)
    sample = np.concatenate([sample, -sample])
    labs = rng.integers(0, 6, (2 * n_write,))
    js = jax.jit(lambda x, lab: JStore.create(JMemoryConfig(
        capacity=capacity, dim=DIM, search=jcfg)).calibrate(x).write(
            x, lab))(jnp.asarray(sample), jnp.asarray(labs))
    ts = MemoryStore.create(MemoryConfig(capacity=capacity, dim=DIM,
                                         search=tcfg), device="cpu"
                            ).calibrate(sample).write(sample, labs)
    return js, ts


def _same_leaves(js, ts, fields=("values", "proj_packed", "s_grid", "labels",
                                 "size", "sketch_sums", "sketch_counts")):
    for f in fields:
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)


def test_sketch_tracks_scatter_writes_through_wraparound():
    """The unpartitioned store's incremental sketch equals the JAX
    package's and a rebuild after ring writes that overwrite and wrap."""
    rng = np.random.default_rng(1)
    js, ts = _programmed(rng, 40)
    write = jax.jit(lambda st, x, lab: st.write(x, lab))
    for n in (5, 5, 7, 30):
        x = rng.normal(size=(n, DIM)).astype(np.float32)
        lab = rng.integers(-1, 6, (n,))
        js = write(js, jnp.asarray(x), jnp.asarray(lab))
        ts = ts.write(x, lab)
        _same_leaves(js, ts)
        want = build_sketch(ts.values, ts.labels, 1)
        assert torch.equal(ts.sketch_sums, want[0])
        assert torch.equal(ts.sketch_counts, want[1])


def test_sketch_tracks_writes_on_partitioned_store():
    """Writes on a partitioned, ragged store (38 rows in 8 shards: 2 pad
    rows) that wrap the ring rebuild the per-shard sketch exactly and
    never touch the pad rows, as the JAX package does."""
    rng = np.random.default_rng(2)
    js, ts = _programmed(rng, 38)
    js, ts = js.shard(n_shards=N_SHARDS), ts.shard(n_shards=N_SHARDS)
    assert ts.capacity == 40 and ts.n_shards == N_SHARDS
    _same_leaves(js, ts)
    write = jax.jit(lambda st, x, lab: st.write(x, lab))
    for n in (6, 20):                                   # 32 + 26: wraps
        x = rng.normal(size=(n, DIM)).astype(np.float32)
        lab = rng.integers(0, 6, (n,))
        js = write(js, jnp.asarray(x), jnp.asarray(lab))
        ts = ts.write(x, lab)
        _same_leaves(js, ts)
    assert (ts.labels[38:] == -1).all()
    want = build_sketch(ts.values, ts.labels, N_SHARDS)
    assert torch.equal(ts.sketch_sums, want[0])


@pytest.mark.parametrize("n_shards", [3, 5, 38])
def test_ragged_shards_pad_and_search_like_the_reference(n_shards):
    """Ragged splits pad with label -1 rows; re-sharding starts from the
    logical rows (idempotent); routed searches at every nprobe equal the
    JAX package's."""
    rng = np.random.default_rng(n_shards)
    js, ts = _programmed(rng, 38)
    js = js.shard(n_shards=n_shards)
    ts = ts.shard(n_shards=7).shard(n_shards=n_shards)
    assert ts.capacity == js.capacity and ts.n_shards == n_shards
    _same_leaves(js, ts)
    q = rng.integers(0, 4, (4, DIM))
    for p in (1, n_shards - 1):
        for mode in ("two_phase", "ideal"):
            req = dict(mode=mode, k=5, nprobe=p)
            assert_same(jax_search(js, q, **req), RetrievalEngine(
                ts.cfg.search).search(ts, q, SearchRequest(**req)),
                f"S={n_shards} p={p} {mode}")


def test_partitioned_save_restore_across_packages():
    """A partitioned store saves its logical rows; restored in either
    package and partitioned again, it holds the same leaves and answers
    the same routed searches."""
    rng = np.random.default_rng(4)
    js, ts = _programmed(rng, 38)
    js, ts = js.shard(n_shards=5), ts.shard(n_shards=5)
    q = rng.integers(0, 4, (4, DIM))
    req = dict(mode="two_phase", k=6, nprobe=2)
    for writer in ("jax", "torch"):
        with tempfile.TemporaryDirectory() as td:
            (js if writer == "jax" else ts).save(td, 3)
            back = MemoryStore.restore(td, ts.cfg, device="cpu").shard(
                n_shards=5)
            jback = JStore.restore(td, js.cfg).shard(n_shards=5)
        _same_leaves(js, back)
        _same_leaves(jback, ts)
        assert_same(jax_search(jback, q, **req), RetrievalEngine(
            back.cfg.search).search(back, q, SearchRequest(**req)), writer)


def test_request_validation():
    with pytest.raises(ValueError, match="nprobe routes the shortlist"):
        SearchRequest(mode="full", nprobe=2)
    with pytest.raises(ValueError, match="nprobe must be >= 1"):
        SearchRequest(mode="ideal", nprobe=0)
    _, tcfg = _cfgs()
    st = MemoryStore.from_quantized(np.zeros((8, DIM), np.int32),
                                    np.arange(8), tcfg, device="cpu")
    with pytest.raises(ValueError, match="n_shards >= 1"):
        st.shard()
    with pytest.raises(ValueError, match="residency"):
        st.shard(n_shards=2, residency="disk")
    with pytest.raises(TypeError, match="must be a repro_torch.launch.mesh"):
        st.shard(object())


def test_host_residency_must_go_through_the_pager(routed_fixture):
    stores, q = routed_fixture
    host = stores["ref"][1].shard(n_shards=4, residency="host")
    assert host.residency == "host" and host.n_shards == 4
    eng = RetrievalEngine(host.cfg.search)
    with pytest.raises(ValueError, match="ShardPager"):
        eng.search(host, q, SearchRequest(mode="ideal", k=4, nprobe=2))
    back = host.shard(n_shards=N_SHARDS)
    assert back.residency == "device"
    assert_torch_same(eng.search(back, q, SearchRequest(mode="ideal", k=4)),
                      eng.search(stores["ref"][1], q,
                                 SearchRequest(mode="ideal", k=4)))


def test_empty_shard_never_outranks_real_rows():
    """A shard of label -1 rows carries the mask penalty in every bucket
    and is routed last."""
    _, tcfg = _cfgs("ref")
    rng = np.random.default_rng(4)
    store = MemoryStore.from_quantized(rng.integers(0, 16, (12, DIM)),
                                       [3] * 6 + [-1] * 6, tcfg,
                                       device="cpu").shard(n_shards=2)
    sids = top_shards(route_scores(torch.as_tensor(
        rng.integers(0, 4, (3, DIM))), store.sketch_sums,
        store.sketch_counts, tcfg.enc), 1)
    assert (sids == 0).all()
