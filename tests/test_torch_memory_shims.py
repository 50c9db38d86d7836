"""The port's legacy dict-state memory API (`repro_torch.core.memory`:
`init_memory`, `calibrate`, `write`, `quantize_queries`, `search`,
`predict`, `shard_state`, `distributed_search`), the twin of
tests/test_deprecations.py, on the CPU.

Each shim equals the new API (`MemoryStore` + `RetrievalEngine.search`)
bit for bit, and the JAX package's shims too (its dict states, searches
and predictions, run on one JAX device). `search` and
`distributed_search` warn once per process each. `distributed_search`
on a mesh of CPU positions is anchored on the unsharded two_phase search:
the reference's own raises on this JAX (ROADMAP C.R8).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import memory as jmem
from repro.core.avss import SearchConfig as JSearchConfig
from repro_torch.core import memory as mem
from repro_torch.core.avss import SearchConfig
from repro_torch.engine import MemoryStore, RetrievalEngine, SearchRequest
from repro_torch.engine.sharded import ShardedRows
from repro_torch.launch.mesh import Mesh

torch.set_num_threads(1)

LEAVES = ("votes", "dist", "indices", "labels")
STATE = ("values", "proj", "s_grid", "labels", "size", "lo", "hi")


def _cfgs(capacity=16):
    return (jmem.MemoryConfig(capacity=capacity, dim=8, search=JSearchConfig(
                "mtmc", cl=4, mode="avss", use_kernel="ref")),
            mem.MemoryConfig(capacity=capacity, dim=8,
                             search=SearchConfig("mtmc", cl=4, mode="avss")))


def _np(x):
    x = x.full("cpu") if isinstance(x, ShardedRows) else x
    return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()


@pytest.fixture()
def toy():
    """The reference test's toy store, written through both packages'
    shims from the same vectors."""
    jcfg, tcfg = _cfgs()
    vecs = np.array(jax.random.normal(jax.random.PRNGKey(0),
                                      (12, tcfg.dim)))
    labs = np.arange(12, dtype=np.int32) % 4
    js = jmem.write(jmem.calibrate(jmem.init_memory(jcfg), vecs, jcfg),
                    vecs, labs, jcfg)
    ts = mem.write(mem.calibrate(mem.init_memory(tcfg, device="cpu"), vecs,
                                 tcfg), vecs, labs, tcfg)
    return jcfg, tcfg, js, ts, vecs[:3] + 0.02


def _deprecations(records):
    return [w for w in records if issubclass(w.category, DeprecationWarning)
            and "repro_torch.core.memory" in str(w.message)]


def test_dict_state_shims_equal_the_reference(toy):
    """init_memory / calibrate / write give the reference's state leaves,
    and quantize_queries its words, bit for bit."""
    jcfg, tcfg, js, ts, q = toy
    assert set(ts) == set(STATE)
    for k in STATE:
        want = np.asarray(js[k], np.float32 if k == "proj" else None)
        np.testing.assert_array_equal(_np(ts[k]), want, err_msg=k)
    np.testing.assert_array_equal(mem.quantize_queries(ts, q).numpy(),
                                  np.asarray(jmem.quantize_queries(js, q)))


def test_search_shim_warns_once_and_is_bit_identical(toy):
    """`search` (full and two_phase) equals `RetrievalEngine.search` on
    `MemoryStore.from_state` and the reference's shim; it warns once, a
    repeat with another batch size included; `predict` agrees across the
    result types."""
    jcfg, tcfg, js, ts, q = toy
    mem._WARNED.discard("search")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        old_full = mem.search(ts, q, tcfg)
        old_tp = mem.search(ts, q, tcfg, two_phase=True, k=4)
        mem.search(ts, q[:2], tcfg, two_phase=True, k=4)
    assert len(_deprecations(rec)) == 1, [str(w.message) for w in rec]

    eng = RetrievalEngine(tcfg.search)
    store = MemoryStore.from_state(ts, tcfg, "cpu")
    new_full = eng.search(store, q, SearchRequest(mode="full"))
    new_tp = eng.search(store, q, SearchRequest(mode="two_phase", k=4))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        j_full = jax.jit(lambda s, qq: jmem.search(s, qq, jcfg))(
            js, jnp.asarray(q))
        j_tp = jax.jit(lambda s, qq: jmem.search(s, qq, jcfg, two_phase=True,
                                                 k=4))(js, jnp.asarray(q))
    for key in ("votes", "dist", "labels"):
        assert torch.equal(old_full[key], getattr(new_full, key)), key
        np.testing.assert_array_equal(old_full[key].numpy(),
                                      np.asarray(j_full[key]), err_msg=key)
    for key in LEAVES:
        assert torch.equal(old_tp[key], getattr(new_tp, key)), key
        np.testing.assert_array_equal(old_tp[key].numpy(),
                                      np.asarray(j_tp[key]), err_msg=key)
    assert torch.equal(mem.predict(old_tp), new_tp.predict())
    assert torch.equal(mem.predict(new_tp), new_tp.predict())
    np.testing.assert_array_equal(mem.predict(old_tp).numpy(),
                                  np.asarray(jmem.predict(j_tp)))


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("shape,names,axes", [
    ((1,), ("data",), ("data",)),
    ((8,), ("data",), ("data",)),
    ((4, 2), ("data", "model"), ("data", "model")),
    ((4, 2), ("data", "model"), ("data",))])
def test_distributed_shim_warns_once_and_equals_unsharded(toy, shape, names,
                                                          axes, exact):
    """`distributed_search` on a mesh of CPU positions equals the
    unsharded two_phase (exact) or ideal search bit for bit, and the new
    API on `MemoryStore.shard(mesh, axes)`; it warns once."""
    jcfg, tcfg, js, ts, q = toy
    mesh = Mesh.repeat("cpu", shape, names)
    mem._WARNED.discard("distributed_search")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        old = mem.distributed_search(ts, q, tcfg, mesh, axes=axes, k=4,
                                     exact=exact)
        mem.distributed_search(ts, q[:2], tcfg, mesh, axes=axes, k=4,
                               exact=exact)
    assert len(_deprecations(rec)) == 1, [str(w.message) for w in rec]
    mode = "two_phase" if exact else "ideal"
    eng = RetrievalEngine(tcfg.search)
    store = MemoryStore.from_state(ts, tcfg, "cpu")
    flat = eng.search(store, q, SearchRequest(mode=mode, k=4))
    new = eng.search(store.shard(mesh, axes), q, SearchRequest(mode=mode,
                                                               k=4))
    for key in LEAVES:
        assert torch.equal(old[key], getattr(flat, key)), key
        assert torch.equal(old[key], getattr(new, key)), key


def test_shard_state_is_the_store_shard_and_refuses_ragged_without_cfg():
    """`shard_state` gives `MemoryStore.shard`'s leaves (row leaves as
    ShardedRows); a ragged split needs cfg= (the reference's error), with
    which its pad rows land as the store's and `distributed_search` of the
    sharded state still equals the unsharded search."""
    jcfg, tcfg = _cfgs(capacity=15)
    rng = np.random.default_rng(2)
    vecs = rng.standard_normal((15, 8)).astype(np.float32)
    labs = np.arange(15, dtype=np.int32) % 5
    ts = mem.write(mem.calibrate(mem.init_memory(tcfg, device="cpu"), vecs,
                                 tcfg), vecs, labs, tcfg)
    mesh = Mesh.repeat("cpu", (4,), ("data",))
    with pytest.raises(ValueError, match="do not divide over 4 shards"):
        mem.shard_state(ts, mesh, ("data",))
    ss = mem.shard_state(ts, mesh, ("data",), cfg=tcfg)
    want = MemoryStore.from_state(ts, tcfg, "cpu").shard(mesh, ("data",))
    for k in STATE:
        got = ss[k]
        assert isinstance(got, ShardedRows) == (k in ("values", "proj",
                                                      "s_grid", "labels")), k
        np.testing.assert_array_equal(_np(got), _np(getattr(want, k)),
                                      err_msg=k)
    assert ss["values"].shape[0] == 16
    q = vecs[:4] + 0.01
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        got = mem.distributed_search(ss, q, tcfg, mesh, axes=("data",), k=6)
    flat = RetrievalEngine(tcfg.search).search(
        MemoryStore.from_state(ts, tcfg, "cpu"), q,
        SearchRequest(mode="two_phase", k=6))
    for key in LEAVES:
        assert torch.equal(got[key], getattr(flat, key)), key
    # divisible splits keep the reference's 3-argument form
    jcfg16, tcfg16 = _cfgs()
    t16 = mem.init_memory(tcfg16, device="cpu")
    assert mem.shard_state(t16, mesh, ("data",))["values"].shape[0] == 16
