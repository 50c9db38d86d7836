"""The port's checkpoints (`repro_torch.checkpoint.ckpt`, `MemoryStore.save
/ restore`) against the JAX package's `repro.checkpoint.ckpt`: one on-disk
format, so a store saved by either package restores in the other and
searches to the same bits. Everything here is exact: leaves are integers
or stored floats, and a search of two stores with equal leaves is the same
computation."""

import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.core.avss import SearchConfig as JSearchConfig
from repro.core.memory import MemoryConfig as JMemoryConfig
from repro.engine import MemoryStore as JStore
from repro.engine import RetrievalEngine as JEngine
from repro.engine import SearchRequest as JRequest
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import ckpt
from repro_torch.core.avss import SearchConfig
from repro_torch.core.memory import MemoryConfig
from repro_torch.engine import MemoryStore, RetrievalEngine, SearchRequest

torch.set_num_threads(1)

STATE = ("values", "proj", "s_grid", "labels", "size", "lo", "hi")


def _nested():
    """A nested tree of every leaf kind a checkpoint holds, keys inserted
    out of order."""
    rng = np.random.default_rng(0)
    return {
        "zeta": torch.tensor(rng.standard_normal((3, 4)), dtype=torch.float32),
        "alpha": [torch.arange(5, dtype=torch.int32),
                  {"w": torch.tensor(rng.standard_normal(7),
                                     dtype=torch.bfloat16),
                   "b": torch.tensor(-3, dtype=torch.int8)}],
        "mid": {"step": torch.tensor(9, dtype=torch.int32),
                "empty": torch.zeros(0, 2), "none": None},
    }


def test_round_trip_keeps_every_leaf_bit_for_bit(tmp_path):
    tree = _nested()
    ckpt.save(str(tmp_path), 4, tree)
    back = ckpt.restore(str(tmp_path), tree)
    names, want = tree_lib.flatten_with_names(tree)
    got = tree_lib.leaves(back)
    assert len(got) == len(want) == 6
    for n, a, b in zip(names, want, got):
        assert a.dtype == b.dtype and a.shape == b.shape, n
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b), n
    assert back["mid"]["none"] is None
    man = json.loads((tmp_path / "step_0000000004" / "manifest.json")
                     .read_text())
    assert man["step"] == 4
    assert [m["dtype"] for m in man["leaves"]] == \
        ["int32", "int8", "bfloat16", "float32", "int32", "float32"]
    # the bf16 tile is what np.save writes for JAX's bfloat16: 2-byte void
    raw = np.load(tmp_path / "step_0000000004" / "leaf00002.0.npy")
    assert raw.dtype.kind == "V" and raw.dtype.itemsize == 2


def test_leaf_names_and_order_match_the_reference():
    """The same nested dict flattens to the same names in the same order
    as `jax.tree_util` (through repro.checkpoint.ckpt) flattens it."""
    tree = _nested()
    as_np = tree_lib.tree_map(
        lambda t: t.float().numpy() if t.dtype == torch.bfloat16
        else t.numpy(), tree)
    jnames, _, _ = jckpt._flatten_with_names(as_np)
    names, _ = tree_lib.flatten_with_names(tree)
    assert names == jnames
    assert names[0] == "alpha//0" and names[2] == "alpha//1//w"


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """A tree JAX saved (bf16 included) restores in the port with the same
    bits, and the port's tree restores in JAX."""
    rng = np.random.default_rng(1)
    jtree = {"p": {"w": jnp.asarray(rng.standard_normal((4, 6)),
                                    jnp.bfloat16),
                   "b": jnp.arange(6, dtype=jnp.int32)},
             "step": jnp.int32(3)}
    jckpt.save(str(tmp_path / "j"), 3, jtree)
    target = {"p": {"w": 0, "b": 0}, "step": 0}
    got = ckpt.restore(str(tmp_path / "j"), target)
    assert got["p"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["p"]["w"].view(torch.int16).numpy(),
        np.asarray(jtree["p"]["w"]).view(np.int16))
    np.testing.assert_array_equal(got["p"]["b"].numpy(),
                                  np.asarray(jtree["p"]["b"]))
    assert int(got["step"]) == 3
    ckpt.save(str(tmp_path / "t"), 3, got)
    back = jckpt.restore(str(tmp_path / "t"), jtree)
    assert back["p"]["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back["p"]["w"]).view(np.int16),
                                  np.asarray(jtree["p"]["w"]).view(np.int16))
    assert ml_dtypes.bfloat16 == np.asarray(back["p"]["w"]).dtype


def test_tiles_of_a_sharded_writer_are_assembled(tmp_path):
    """A leaf written as row tiles (what a sharded writer leaves, keyed by
    each tile's start offsets) is assembled in place."""
    d = tmp_path / "step_0000000001"
    d.mkdir()
    full = np.arange(24, dtype=np.float32).reshape(6, 4)
    np.save(d / "leaf00000.0_0.npy", full[:2])
    np.save(d / "leaf00000.2_0.npy", full[2:])
    (d / "manifest.json").write_text(json.dumps(
        {"step": 1, "leaves": [{"name": "x", "shape": [6, 4],
                                "dtype": "float32"}]}))
    got = ckpt.restore(str(tmp_path), {"x": 0})
    np.testing.assert_array_equal(got["x"].numpy(), full)


def test_checkpoint_manager_keeps_the_newest_and_skips_partial_steps(
        tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), every=2, keep=2)
    for step in range(1, 8):
        mgr.maybe_save(step, {"s": torch.tensor(step)})
    mgr.wait()
    assert ckpt.all_steps(str(tmp_path)) == [4, 6]
    mgr.maybe_save(7, {"s": torch.tensor(7)}, force=True)
    mgr.wait()
    assert mgr.latest_step() == 7
    assert ckpt.all_steps(str(tmp_path)) == [6, 7]
    # a step directory without its manifest (a writer that died) is not a
    # checkpoint; nor is the staging directory
    os.makedirs(tmp_path / "step_0000000009")
    os.makedirs(tmp_path / ".tmp-10-0")
    assert mgr.latest_step() == 7
    assert int(mgr.restore({"s": 0})["s"]) == 7
    assert int(mgr.restore({"s": 0}, step=6)["s"]) == 6
    with pytest.raises(KeyError, match="missing leaf"):
        mgr.restore({"t": 0})
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), {"s": 0})


# -- stores across the packages ------------------------------------------------


def _configs(capacity, d=20, cl=8):
    return (JMemoryConfig(capacity=capacity, dim=d,
                          search=JSearchConfig("mtmc", cl=cl)),
            MemoryConfig(capacity=capacity, dim=d,
                         search=SearchConfig("mtmc", cl=cl)))


def _data(seed, n=24, d=20, b=5):
    """Dyadic embeddings (exact float32 reductions, so both packages
    calibrate the same (lo, hi)) and labels, queries."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-24, 25, size=(n // 2, d)) / 4.0).astype(np.float32)
    x = np.concatenate([x, -x])
    q = (rng.integers(-24, 25, size=(b, d)) / 4.0).astype(np.float32)
    return x, rng.integers(0, 6, size=n).astype(np.int32), q


REQUESTS = [dict(mode="full"), dict(mode="two_phase", k=8),
            dict(mode="ideal", k=8), dict(mode="full", noisy=False)]


def _port_results(store, cfg, q):
    eng = RetrievalEngine(cfg.search)
    return [eng.search(store, q, SearchRequest(**r)) for r in REQUESTS]


def _same_results(a, b):
    for ra, rb in zip(a, b):
        for f in ("votes", "dist", "indices", "labels"):
            assert torch.equal(getattr(ra, f), getattr(rb, f)), f


def test_store_saved_by_the_reference_restores_in_the_port(tmp_path):
    """A store JAX programmed (32 slots, 24 written, so 8 stay empty) and
    saved restores in the port: every persisted leaf equal (proj's bf16
    bits too), calibrated, and its searches give the same bits as the same
    leaves carried across in memory, with the reference's rows and
    distances."""
    jcfg, tcfg = _configs(32)
    x, lab, q = _data(2)
    js = jax.jit(lambda a, b: JStore.create(jcfg).calibrate(a).write(a, b))(
        jnp.asarray(x), jnp.asarray(lab))
    js.save(str(tmp_path), step=5)
    ts = MemoryStore.restore(str(tmp_path), tcfg, device="cpu")
    assert ts.calibrated
    for f in STATE:
        want = np.asarray(getattr(js, f))
        got = getattr(ts, f)
        if f == "proj":
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          want.view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f)
    carried = MemoryStore.from_numpy(
        {f: np.asarray(getattr(js, f), np.float32 if f == "proj" else None)
         for f in MemoryStore.__dataclass_fields__ if f not in ("cfg",)},
        tcfg, device="cpu")
    for f in ("proj_packed", "sketch_sums", "sketch_counts"):
        assert torch.equal(getattr(ts, f), getattr(carried, f)), f
    _same_results(_port_results(ts, tcfg, q), _port_results(carried, tcfg, q))
    jr = jax.jit(lambda st, a: JEngine(jcfg.search).search(
        st, a, JRequest(mode="two_phase", k=8)))(js, jnp.asarray(q))
    tr = _port_results(ts, tcfg, q)[1]
    for f in ("dist", "indices", "labels"):
        np.testing.assert_array_equal(np.asarray(getattr(jr, f)),
                                      getattr(tr, f).numpy(), err_msg=f)


def test_store_saved_by_the_port_restores_in_the_reference(tmp_path):
    """The reverse: a store the port programmed and saved restores in JAX
    with every leaf equal, and JAX's searches of it give the same bits as
    its searches of the store JAX programs from the same data."""
    jcfg, tcfg = _configs(32)
    x, lab, q = _data(3)
    ts = MemoryStore.create(tcfg, device="cpu").calibrate(x).write(x, lab)
    ts.save(str(tmp_path), step=2)
    js = JStore.restore(str(tmp_path), jcfg)
    ref = jax.jit(lambda a, b: JStore.create(jcfg).calibrate(a).write(
        a, b))(jnp.asarray(x), jnp.asarray(lab))
    for f in STATE:
        np.testing.assert_array_equal(
            np.asarray(getattr(js, f)).view(np.int16) if f == "proj"
            else np.asarray(getattr(js, f)),
            getattr(ts, f).view(torch.int16).numpy() if f == "proj"
            else getattr(ts, f).numpy(), err_msg=f)
    for r in (JRequest(mode="two_phase", k=8), JRequest(mode="ideal", k=8)):
        search = jax.jit(lambda st, a, r=r: JEngine(jcfg.search).search(
            st, a, r))
        a = jax.device_get(search(js, jnp.asarray(q)))
        b = jax.device_get(search(ref, jnp.asarray(q)))
        for f in ("votes", "dist", "indices", "labels"):
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          np.asarray(getattr(b, f)))


def test_store_round_trip_in_the_port(tmp_path):
    """save -> restore in the port alone: every leaf and every search
    equal, a ring that wrapped included."""
    _, tcfg = _configs(16)
    x, lab, q = _data(4)
    ts = MemoryStore.create(tcfg, device="cpu").calibrate(x).write(
        x[:12], lab[:12]).write(x[12:], lab[12:])
    assert int(ts.size) == 24
    ts.save(str(tmp_path))
    back = MemoryStore.restore(str(tmp_path), tcfg, device="cpu")
    for f in MemoryStore.__dataclass_fields__:
        if f not in ("cfg", "calibrated", "residency", "mesh", "axes"):
            assert torch.equal(getattr(back, f), getattr(ts, f)), f
    assert back.residency == ts.residency == "device"
    assert back.mesh is ts.mesh is None and back.axes == ts.axes == ()
    _same_results(_port_results(back, tcfg, q), _port_results(ts, tcfg, q))
