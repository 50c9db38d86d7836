"""Parity of the port's mesh-sharded retrieval (`repro_torch.launch.mesh`,
`repro_torch.engine.sharded`, `MemoryStore.shard(mesh, axes)`, the
shard-local write-through, the tiled checkpoint writer) with the JAX
package, on the CPU.

The anchor is the JAX package's UNSHARDED store and search, computed in
this process on one JAX device under `jax.jit`: the reference's own
sharded search equals it bit for bit (ROADMAP R8), while its dict shim
`core.memory.distributed_search` fails on this JAX (C.R2). The port runs
on CPU meshes of 8 positions (`Mesh.repeat("cpu", ...)`), where every
kernel wrapper runs its plain version. Every comparison is bit for bit:
votes (noisy two_phase ones included), dist, indices, labels and
predict(), every store leaf and the router sketch. One subprocess test
runs the reference's own sharded store on 8 forced host devices, and
its checkpoints cross with the port's both ways.
"""

import functools
import os
import subprocess
import sys
import textwrap

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
from repro_torch.core.avss import SearchConfig
from repro_torch.core.memory import MemoryConfig
from repro_torch.engine import (MemoryStore, RetrievalEngine, SearchRequest,
                                ShardPager, TenantStore)
from repro_torch.engine.sharded import ShardedRows
from repro_torch.launch.mesh import (Mesh, make_host_mesh,
                                     make_production_mesh)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM = 20
ROWS = 96            # 12 rows a shard over 8, 24 over 4
K = 12
LEAVES = ("votes", "dist", "indices", "labels")
SHARDED = ("values", "proj", "proj_packed", "s_grid", "labels",
           "sketch_sums", "sketch_counts")
# (mesh shape, mesh axes, the store's shard axes)
MESHES = {"8": ((8,), ("data",), ("data",)),
          "4x2": ((4, 2), ("data", "model"), ("data", "model")),
          "4x2-data": ((4, 2), ("data", "model"), ("data",))}


def _cfgs(cl=8):
    return (JSearchConfig("mtmc", cl=cl, mode="avss", use_kernel="ref"),
            SearchConfig("mtmc", cl=cl, mode="avss"))


def _mesh(name):
    shape, names, axes = MESHES[name]
    return Mesh.repeat("cpu", shape, names), axes


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
        assert got.shape == want.shape, (ctx, f, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=f"{ctx}: {f}")
    np.testing.assert_array_equal(tres.predict().numpy(),
                                  np.asarray(jres.predict()), err_msg=ctx)


def assert_same_fields(jstore, tstore, fields=SHARDED + ("size", "lo", "hi")):
    """Every leaf of a (padded) JAX store against the port's mesh store's
    assembled leaves."""
    for f in fields:
        got = getattr(tstore, f)
        got = got.full("cpu") if isinstance(got, ShardedRows) else got
        want = np.asarray(getattr(jstore, f),
                          np.float32 if f == "proj" else None)
        got = got.float() if f == "proj" else got
        assert tuple(got.shape) == want.shape, (f, got.shape, want.shape)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f)


@pytest.fixture(scope="module")
def stores():
    """{data: (JAX unsharded store, port unsharded store)}: "mask", random
    words with every 5th row masked (label -1); "ties", 12 rows repeated
    once per shard of the 8-shard mesh (every distance appears 8 times:
    only the (distance, global row) order keeps the shards in agreement,
    the data of tests/test_engine.py's tie stress); and 7 query words."""
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(0)
    levels = tcfg.enc.levels
    vals = rng.integers(0, levels, (ROWS, DIM))
    labs = np.arange(ROWS) % 11
    labs[np.arange(ROWS) % 5 == 0] = -1
    data = {"mask": (vals, labs),
            "ties": (np.concatenate([vals[:12]] * 8),
                     np.tile(np.arange(12), 8))}
    out = {name: (JStore.from_quantized(jnp.asarray(v), jnp.asarray(lab),
                                        jcfg),
                  MemoryStore.from_quantized(v, lab, tcfg, device="cpu"))
           for name, (v, lab) in data.items()}
    return out, rng.integers(0, 4, (7, DIM))


@pytest.mark.parametrize("backend", ["ref", "auto"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("mode", ["two_phase", "ideal"])
@pytest.mark.parametrize("data", ["mask", "ties"])
def test_sharded_search_bit_identical_to_jax_unsharded(
        stores, data, mode, mesh_name, backend):
    """Each mode, mesh and backend ('auto' with fused_min_rows 4: every
    shard's phase 1 takes the fused kernel's route, here its plain
    version) equals the JAX package's unsharded search."""
    (js, ts), q = stores[0][data], stores[1]
    mesh, axes = _mesh(mesh_name)
    ms = ts.shard(mesh, axes)
    assert ms.n_shards == int(np.prod([mesh.shape[a] for a in axes]))
    fmr = 4 if backend == "auto" else None
    got = RetrievalEngine(ms.cfg.search, backend=backend).search(
        ms, q, SearchRequest(mode=mode, k=K, fused_min_rows=fmr))
    assert_same(jax_search(js, q, mode=mode, k=K), got,
                f"{data}/{mode}/{mesh_name}/{backend}")


@pytest.mark.parametrize("backend", ["ref", "auto"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_full_search_of_a_mesh_store(stores, mesh_name, backend):
    """`full` of a mesh store (its rows assembled with `.full()`; on
    'auto' the dense physics route, here its plain version) equals the
    JAX package's unsharded `full`."""
    (js, ts), q = stores[0]["mask"], stores[1]
    mesh, axes = _mesh(mesh_name)
    got = RetrievalEngine(ts.cfg.search, backend=backend).search(
        ts.shard(mesh, axes), q, SearchRequest(mode="full"))
    assert_same(jax_search(js, q, mode="full"), got, f"{mesh_name}/{backend}")


@pytest.mark.parametrize("mode", ["two_phase", "ideal", "full"])
def test_request_axes_override_and_unsharded_ignore(stores, mode):
    """`SearchRequest.axes` searches a mesh store over other axes (the
    (4, 2) store sharded on both axes, searched over "data": its blocks
    assembled and split in 4), and is ignored on an unsharded store, as
    the reference ignores it."""
    (js, ts), q = stores[0]["mask"], stores[1]
    mesh, _ = _mesh("4x2")
    eng = RetrievalEngine(ts.cfg.search)
    want = jax_search(js, q, mode=mode, k=K)
    assert_same(want, eng.search(ts, q, SearchRequest(mode=mode, k=K,
                                                      axes=("data",))))
    ms = ts.shard(mesh, ("data", "model"))
    assert_same(want, eng.search(ms, q, SearchRequest(mode=mode, k=K,
                                                      axes=("data",))))


@pytest.mark.parametrize("nprobe", [1, 3])
@pytest.mark.parametrize("mode", ["two_phase", "ideal"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("backend", ["ref", "auto"])
def test_routed_search_on_a_mesh_store(stores, backend, mesh_name, mode,
                                       nprobe):
    """nprobe < S on a mesh store (each shard's block-table entry for the
    queries that visit it, then the merge by distance) equals the JAX
    package's routed search of the logical partition in as many
    shards."""
    (js, ts), q = stores[0]["mask"], stores[1]
    mesh, axes = _mesh(mesh_name)
    ms = ts.shard(mesh, axes)
    fmr = 4 if backend == "auto" else None
    got = RetrievalEngine(ts.cfg.search, backend=backend).search(
        ms, q, SearchRequest(mode=mode, k=K, nprobe=nprobe,
                             fused_min_rows=fmr))
    assert_same(jax_search(js.shard(n_shards=ms.n_shards), q, mode=mode,
                           k=K, nprobe=nprobe), got,
                f"{mesh_name}/{mode}/{nprobe}")


@pytest.mark.parametrize("mesh_name", ["8", "4x2"])
def test_raw_array_sharded_two_phase(stores, mesh_name):
    """`RetrievalEngine.sharded_two_phase` over a plain (N, d) tensor, with
    and without a validity mask, equals the JAX package's `two_phase`."""
    (js, ts), q = stores[0]["mask"], stores[1]
    mesh, axes = _mesh(mesh_name)
    jcfg, tcfg = _cfgs()
    sv = ts.values
    valid = torch.arange(ROWS) % 5 != 0
    jeng = JEngine(jcfg, backend="ref")
    for mask in (None, valid):
        want = jeng.two_phase(jnp.asarray(q), jnp.asarray(sv.numpy()), k=K,
                              valid=None if mask is None
                              else jnp.asarray(mask.numpy()))
        got = RetrievalEngine(tcfg, fused_min_rows=4).sharded_two_phase(
            torch.as_tensor(q), sv, mesh, axes=axes, k=K, valid=mask)
        for f in ("votes", "dist", "indices"):
            np.testing.assert_array_equal(got[f].numpy(),
                                          np.asarray(want[f]), err_msg=f)


def _ragged(jcfg, tcfg):
    """tests/test_store.py's streamed-write data: capacity 100, calibrated
    on a symmetric sample of quarter values (exact in f32 in both
    packages), 90 rows then 40 more, so the second batch wraps 30 rows
    past the ring's end, across the 13-row shards of the store padded to
    104 over 8."""
    rng = np.random.default_rng(3)
    x = (rng.integers(-24, 25, (130, 24)) / 4.0).astype(np.float32)
    labs = (np.arange(130) % 9).astype(np.int32)
    sample = np.concatenate([x, -x])
    jbase = JStore.create(jcfg).calibrate(jnp.asarray(sample))
    tbase = MemoryStore.create(tcfg, device="cpu").calibrate(sample)
    return x, labs, jbase, tbase


def test_streamed_write_ragged_wraparound_equals_reference():
    """The write-through of a ragged mesh store equals the reference's
    unsharded write, padded and sketched at 8 shards (the JAX package's
    `shard(n_shards=8)`), in every leaf; its searches equal the unsharded
    store's; `full` spans the 104 padded rows as the reference's does."""
    jsc, tsc = _cfgs()
    jcfg = JMemoryConfig(capacity=100, dim=24, search=jsc)
    tcfg = MemoryConfig(capacity=100, dim=24, search=tsc)
    x, labs, jbase, tbase = _ragged(jcfg, tcfg)
    mesh, axes = _mesh("8")
    write = jax.jit(lambda st, v, lab: st.write(v, lab))
    junsharded = write(write(jbase, jnp.asarray(x[:90]),
                             jnp.asarray(labs[:90])),
                       jnp.asarray(x[90:]), jnp.asarray(labs[90:]))
    ms = tbase.shard(mesh, axes)
    assert ms.capacity == 104 and ms.cfg.capacity == 100
    first = ms.write(x[:90], labs[:90])
    streamed = first.write(x[90:], labs[90:])
    assert int(streamed.size) == 130
    assert_same_fields(junsharded.shard(n_shards=8), streamed)
    q = x[95:101] + 0.25
    for mode in ("two_phase", "ideal"):
        assert_same(jax_search(junsharded, q, mode=mode, k=16),
                    RetrievalEngine(tsc).search(streamed, q, SearchRequest(
                        mode=mode, k=16)), mode)
    assert_same(jax_search(junsharded.shard(n_shards=8), q, mode="full"),
                RetrievalEngine(tsc).search(streamed, q,
                                            SearchRequest(mode="full")))


def test_reshard_is_idempotent_and_single_shard_scatters():
    """shard(mesh_a).shard(mesh_b) equals shard(mesh_b) in every leaf
    (padding starts from the logical rows each time), and a one-shard
    mesh store writes through the scatter path to the same bits."""
    _, tsc = _cfgs()
    tcfg = MemoryConfig(capacity=100, dim=24, search=tsc)
    jsc, _ = _cfgs()
    x, labs, _, tbase = _ragged(
        JMemoryConfig(capacity=100, dim=24, search=jsc), tcfg)
    store = tbase.write(x[:90], labs[:90])
    m8, _ = _mesh("8")
    m42, _ = _mesh("4x2")
    for a, b in (((m8, ("data",)), (m42, ("data", "model"))),
                 ((m42, ("data",)), (m8, ("data",))),
                 ((m8, ("data",)), (m42, ("data",)))):
        twice, once = store.shard(*a).shard(*b), store.shard(*b)
        assert twice.capacity == once.capacity
        for f in SHARDED:
            assert torch.equal(getattr(twice, f).full("cpu"),
                               getattr(once, f).full("cpu")), (a[1], b[1], f)
    back = store.shard(m8).shard(n_shards=4)
    assert back.mesh is None and back.n_shards == 4
    assert torch.equal(back.values[:100], store.values)
    one = store.shard(make_host_mesh(device="cpu"), ("data", "model"))
    assert one.n_shards == 1 and len(one.values.blocks) == 1
    wrote = one.write(x[90:], labs[90:])
    want = store.write(x[90:], labs[90:])
    for f in ("values", "proj", "proj_packed", "s_grid", "labels",
              "sketch_sums", "sketch_counts"):
        assert torch.equal(getattr(wrote, f).full("cpu"),
                           getattr(want, f)), f


def test_mesh_builders_and_sharded_fields_refuse_tensor_reads():
    """make_host_mesh / make_production_mesh as the reference's; a mesh
    store's row fields raise when read as one tensor; tenant stacks and
    the pager refuse mesh stores with the reference's messages."""
    mesh = make_host_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.axis_names == ("data", "model")
    with pytest.raises(RuntimeError, match="needs 256 devices"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="needs 512 devices"):
        make_production_mesh(multi_pod=True)
    _, tcfg = _cfgs()
    st = MemoryStore.from_quantized(np.zeros((16, DIM), np.int64),
                                    np.arange(16), tcfg, device="cpu")
    ms = st.shard(Mesh.repeat("cpu", (8,), ("data",)))
    for read in (lambda: ms.values[:2], lambda: ms.labels >= 0,
                 lambda: torch.equal(ms.values, st.values),
                 lambda: np.asarray(ms.values), ms.to_numpy):
        with pytest.raises((TypeError, AttributeError), match="not one "
                                                              "tensor"):
            read()
    with pytest.raises(TypeError, match="Mesh"):
        st.shard(object())
    with pytest.raises(ValueError, match="not axes of the mesh"):
        st.shard(ms.mesh, ("model",))
    with pytest.raises(ValueError, match="device-resident"):
        st.shard(ms.mesh, residency="host")
    with pytest.raises(ValueError, match="is sharded; stack unsharded"):
        TenantStore.stack([st, ms])
    with pytest.raises(ValueError, match="mesh-sharded stores are already"):
        ShardPager(ms, RetrievalEngine(tcfg), device="cpu")


_REFERENCE = """
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.checkpoint import ckpt
    from repro.core.avss import SearchConfig
    from repro.core.memory import MemoryConfig
    from repro.engine import MemoryStore, RetrievalEngine, SearchRequest

    out, port_dir, ref_dir = sys.argv[1:4]
    d = np.load(out + ".in.npz")
    search = SearchConfig("mtmc", cl=8, mode="avss", use_kernel="ref")
    cfg = MemoryConfig(capacity=104, dim=24, search=search)
    mesh = jax.make_mesh((8,), ("data",))
    write = jax.jit(lambda st, v, lab: st.write(v, lab))
    st = MemoryStore.create(cfg).calibrate(jnp.asarray(d["sample"]))
    st = st.shard(mesh, ("data",))
    st = write(st, jnp.asarray(d["x"][:90]), jnp.asarray(d["labs"][:90]))
    st = write(st, jnp.asarray(d["x"][90:]), jnp.asarray(d["labs"][90:]))
    res = {f: np.asarray(getattr(st, f), np.float32 if f == "proj"
                         else None)
           for f in ("values", "proj", "proj_packed", "s_grid", "labels",
                     "sketch_sums", "sketch_counts", "size")}
    for mode in ("two_phase", "ideal"):
        r = jax.jit(lambda s, q: RetrievalEngine(search).search(
            s, q, SearchRequest(mode=mode, k=16)))(st, jnp.asarray(d["q"]))
        for f in ("votes", "dist", "indices", "labels"):
            res[mode + "." + f] = np.asarray(getattr(r, f))
    # MemoryStore.save of a mesh store raises on this JAX (ROADMAP R8):
    # its sharded leaves go through the tiled writer itself
    ckpt.save(ref_dir, 0, st.to_state())
    back = MemoryStore.restore(port_dir, MemoryConfig(
        capacity=100, dim=24, search=search))
    for f in ("values", "proj", "s_grid", "labels", "size", "lo", "hi"):
        res["port_ckpt." + f] = np.asarray(getattr(back, f),
                                           np.float32 if f == "proj"
                                           else None)
    np.savez(out, **res)
"""


def test_reference_sharded_store_and_tiled_checkpoints_both_ways(tmp_path):
    """The reference's own mesh store on 8 forced host devices (capacity
    104, 13 rows a shard; 90 rows, then 40 wrapping past the ring's end),
    written through its write-through and searched, equals the port's
    mesh store leaf by leaf and result by result; the reference's tiled
    checkpoint of its sharded leaves restores in the port, and the port's
    tiled save of a ragged mesh store (capacity 100 padded to 104: 8
    tiles a row leaf keyed by global start, the last cut to 9 rows)
    restores in the reference."""
    jsc, tsc = _cfgs()
    cfgs = {c: MemoryConfig(capacity=c, dim=24, search=tsc)
            for c in (100, 104)}
    x, labs, _, _ = _ragged(JMemoryConfig(capacity=100, dim=24, search=jsc),
                            cfgs[100])
    sample = np.concatenate([x, -x])
    mesh, axes = _mesh("8")
    ms = {c: MemoryStore.create(cfg, device="cpu").calibrate(sample).shard(
        mesh, axes).write(x[:90], labs[:90]).write(x[90:], labs[90:])
        for c, cfg in cfgs.items()}
    q = x[95:101] + 0.25
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    ms[100].save(str(port_dir))
    step = port_dir / "step_0000000000"
    leaves = sorted(os.listdir(step))
    assert sum(f.startswith("leaf00001.") for f in leaves) == 8   # labels
    assert "leaf00004.91_0_0_0.npy" in leaves       # s_grid's last tile
    assert np.load(step / "leaf00001.91.npy").shape == (9,)   # 100 - 91
    out = str(tmp_path / "ref_out")
    np.savez(out + ".in.npz", x=x, labs=labs, q=q, sample=sample)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_REFERENCE), out,
         str(port_dir), str(ref_dir)],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = np.load(out + ".npz")
    for f in SHARDED + ("size",):
        got = getattr(ms[104], f)
        got = got.full("cpu") if isinstance(got, ShardedRows) else got
        got = got.float() if f == "proj" else got
        np.testing.assert_array_equal(got.numpy(), ref[f], err_msg=f)
    for mode in ("two_phase", "ideal"):
        res = RetrievalEngine(tsc).search(ms[104], q, SearchRequest(
            mode=mode, k=16))
        for f in LEAVES:
            np.testing.assert_array_equal(getattr(res, f).numpy(),
                                          ref[f"{mode}.{f}"],
                                          err_msg=f"{mode}.{f}")
    logical = ms[100]._unpad()
    for f in ("values", "proj", "s_grid", "labels", "size", "lo", "hi"):
        got = getattr(logical, f)
        got = got.float() if f == "proj" else got
        np.testing.assert_array_equal(got.numpy(), ref[f"port_ckpt.{f}"],
                                      err_msg=f)
    restored = MemoryStore.restore(str(ref_dir), cfgs[104], device="cpu")
    assert len([f for f in os.listdir(ref_dir / "step_0000000000")
                if f.startswith("leaf00006.")]) == 8            # values
    again = restored.shard(mesh, axes)
    for f in SHARDED:
        assert torch.equal(getattr(again, f).full("cpu"),
                           getattr(ms[104], f).full("cpu")), f
