"""Parity of the port's serving slice (`repro_torch.engine`) with the JAX
package's `repro.engine`, on the CPU: programming a store, its leaves,
and `RetrievalEngine.search` in every mode and backend.

Integer-valued results (store leaves, shortlist rows and distances,
labels, predictions) must be equal. Noisy votes go through exp() and the
Box-Muller log / cos of two different libms, so a string current within
ulps of a sense-amp threshold may flip a vote: they are held to an
agreement rate, stated where it is asserted. For `full`, the JAX side runs
`backend="ref"`: its Pallas string-search kernel calls `pl.load`, which
the installed JAX no longer has.
"""

import ast
import dataclasses
import functools
import pathlib
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.avss import SearchConfig as JSearchConfig
from repro.core.memory import MemoryConfig as JMemoryConfig
from repro.engine import MemoryStore as JStore
from repro.engine import RetrievalEngine as JEngine
from repro.engine import SearchRequest as JRequest
from repro.engine import backends as j_backends
from repro_torch.core.avss import SearchConfig
from repro_torch.core.memory import MemoryConfig
from repro_torch.engine import (IDEAL_FUSED_MIN_ROWS, MemoryStore,
                                RetrievalEngine, SearchRequest, SearchResult)
from repro_torch.engine import backends as t_backends
from repro_torch.engine import store as t_store

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIELDS = t_store.STATE_FIELDS
VOTE_AGREEMENT = 0.99    # noisy votes, per (query, candidate)


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jax_leaves(store) -> dict:
    """The JAX store's leaves and its `calibrated` flag, as numpy."""
    return {f: np.asarray(getattr(store, f), np.float32 if f == "proj"
                          else None) for f in FIELDS}


def assert_same_leaves(jstore, tstore):
    got = tstore.to_numpy()
    for f, want in _jax_leaves(jstore).items():
        assert got[f].shape == want.shape, f
        np.testing.assert_array_equal(got[f], want, err_msg=f)


# The JAX side runs under jax.jit: the same functions, compiled once per
# configuration instead of op by op, which is what keeps these tests cheap.


@functools.cache
def _jax_program(jcfg):
    return jax.jit(lambda sample, x, lab: JStore.create(jcfg).calibrate(
        sample).write(x, lab))


def jax_program(jcfg, sample, x, lab):
    """JAX `create -> calibrate(sample) -> write(x, lab)`."""
    return _jax_program(jcfg)(jnp.asarray(sample), jnp.asarray(x),
                              jnp.asarray(lab))


@functools.cache
def _jax_search(search_cfg, backend, request):
    return jax.jit(lambda store, q: JEngine(search_cfg, backend=backend)
                   .search(store, q, request))


def jax_search(search_cfg, store, queries, request, backend="auto"):
    return _jax_search(search_cfg, backend, request)(store,
                                                     jnp.asarray(queries))


def _configs(capacity, d=48, cl=8, **kw):
    return (JMemoryConfig(capacity=capacity, dim=d,
                          search=JSearchConfig("mtmc", cl=cl, **kw)),
            MemoryConfig(capacity=capacity, dim=d,
                         search=SearchConfig("mtmc", cl=cl, **kw)))


def _dyadic_sample(seed, n=512, d=32):
    """Calibration sample whose reductions are exact in float32: 2**14
    quarter values in [-6, 6], symmetric (mean 0), so every partial sum of
    x and x**2 is representable and both packages compute the same
    (lo, hi) bits."""
    x = (np.random.default_rng(seed).integers(-24, 25, size=(n // 2, d))
         / 4.0).astype(np.float32)
    return np.concatenate([x, -x])


def _clustered(seed, classes, shots, d=48, noise=0.3):
    """examples/quickstart.py's data: class centres x 2.0, supports and
    one query per class at noise 0.3."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((classes, d)).astype(np.float32) * 2.0
    labels = np.repeat(np.arange(classes, dtype=np.int32), shots)
    support = (centres[labels] + noise * rng.standard_normal(
        (classes * shots, d))).astype(np.float32)
    queries = (centres + noise * rng.standard_normal((classes, d))
               ).astype(np.float32)
    return support, labels, queries


@pytest.fixture(scope="module")
def programmed():
    """One store programmed by both packages from the same inputs, at the
    quickstart's geometry (20-way 10-shot, d=48, MTMC CL=32, capacity
    512): 200 rows written, so 312 never-written slots stay masked. The
    range is calibrated on a dyadic sample, so the leaves can be held
    exact."""
    jcfg, tcfg = _configs(512, cl=32)
    sample = _dyadic_sample(0)
    support, labels, queries = _clustered(1, 20, 10)
    js = jax_program(jcfg, sample, support, labels)
    ts = MemoryStore.create(tcfg, device="cpu").calibrate(sample).write(
        support, labels)
    return jcfg, tcfg, js, ts, queries


@pytest.fixture(scope="module")
def full_results(programmed):
    """`full` of the 20 queries: JAX on backend `ref`, the port on its
    default backend (the dense string-search kernel's plain version)."""
    jcfg, tcfg, js, ts, queries = programmed
    jr = jax_search(jcfg.search, js, queries, JRequest(mode="full"),
                    backend="ref")
    tr = RetrievalEngine(tcfg.search).search(ts, queries,
                                             SearchRequest(mode="full"))
    return jr, tr


# -- programming ---------------------------------------------------------------


def test_from_quantized_leaves_are_exact():
    jcfg, tcfg = _configs(512, cl=32)
    rng = np.random.default_rng(2)
    v = rng.integers(0, 97, size=(512, 48)).astype(np.int32)
    lab = rng.integers(0, 20, size=512).astype(np.int32)
    js = jax.jit(lambda v, lab: JStore.from_quantized(v, lab, jcfg.search))(
        jnp.asarray(v), jnp.asarray(lab))
    ts = MemoryStore.from_quantized(v, lab, tcfg.search, device="cpu")
    assert ts.capacity == 512 and ts.dim == 48 and ts.n_shards == 1
    assert ts.pack_bits == js.pack_bits == 8
    assert ts.proj.dtype == torch.bfloat16
    assert_same_leaves(js, ts)


def test_calibrate_write_leaves_are_exact(programmed):
    _, _, js, ts, _ = programmed
    assert float(ts.lo) == float(js.lo) and float(ts.hi) == float(js.hi)
    assert_same_leaves(js, ts)
    np.testing.assert_array_equal(_np(ts.valid), np.asarray(js.valid))


def test_ring_wraparound_matches_reference():
    jcfg, tcfg = _configs(16)
    sample = _dyadic_sample(3)
    js = jax.jit(lambda x: JStore.create(jcfg).calibrate(x))(
        jnp.asarray(sample))
    ts = MemoryStore.create(tcfg, device="cpu").calibrate(sample)
    rng = np.random.default_rng(4)
    write = jax.jit(lambda st, x, lab: st.write(x, lab))
    for _ in range(3):                # slots 10.. wrap at 16, then at 32
        x = rng.standard_normal((10, 48)).astype(np.float32) * 3
        lab = rng.integers(0, 9, size=10).astype(np.int32)
        js = write(js, jnp.asarray(x), jnp.asarray(lab))
        ts = ts.write(x, lab)
        assert_same_leaves(js, ts)
    assert int(ts.size) == 30


def test_constant_calibration_stores_words_like_the_reference():
    """Calibrating on constant data gives hi == lo and NaN words, which
    the reference's int cast stores as 0 (torch's would be INT_MIN)."""
    jcfg, tcfg = _configs(16)
    x = np.ones((2, 48), np.float32)
    js = jax_program(jcfg, x, x, np.array([0, 1], np.int32))
    ts = MemoryStore.create(tcfg, device="cpu").calibrate(x).write(x, [0, 1])
    assert_same_leaves(js, ts)
    np.testing.assert_array_equal(_np(ts.quantize_queries(x)),
                                  np.asarray(js.quantize_queries(
                                      jnp.asarray(x))))


def test_store_lifecycle_errors():
    _, tcfg = _configs(8)
    fresh = MemoryStore.create(tcfg, device="cpu")
    x = np.arange(96, dtype=np.float32).reshape(2, 48)
    with pytest.raises(ValueError, match="never-calibrated"):
        fresh.write(x, [0, 1])
    with pytest.raises(ValueError, match="never-calibrated"):
        fresh.quantize_queries(x)
    written = fresh.calibrate(x).write(x, [0, 1])
    with pytest.raises(ValueError, match="already holds"):
        written.calibrate(x)
    with pytest.raises(ValueError, match="exceeds capacity"):
        written.write(np.ones((9, 48), np.float32), np.zeros(9))
    words = torch.tensor([[1, 2, 3] * 16])
    assert written.quantize_queries(words) is words or torch.equal(
        written.quantize_queries(words), words)


def test_unported_features_name_their_roadmap_item():
    """The retrieval half of ROADMAP A9 is ported (A9a): `shard` takes a
    `launch/mesh.Mesh` and refuses anything else, and
    `SearchRequest.axes` is ignored on an unsharded store, as the
    reference ignores it (tests/test_torch_sharded.py holds the sharded
    searches against the JAX package); the LM half (A9b) is ported too
    (tests/test_torch_sharding.py)."""
    jcfg, tcfg = _configs(8)
    st = MemoryStore.create(tcfg, device="cpu")
    eng = RetrievalEngine(tcfg.search)
    q = np.zeros((1, 48), np.int32)
    with pytest.raises(TypeError, match="must be a repro_torch.launch.mesh"):
        st.shard(object())
    plain = eng.search(st, q, SearchRequest())
    axes = eng.search(st, q, SearchRequest(axes=("data",)))
    for f in ("votes", "dist", "indices", "labels"):
        assert torch.equal(getattr(plain, f), getattr(axes, f)), f


def test_carry_across_with_from_numpy(programmed):
    """A store the JAX package programmed, carried across as numpy arrays
    (proj as float32, cast back to bf16 exactly), holds the same leaves
    and answers the same searches."""
    jcfg, tcfg, js, _, queries = programmed
    ts = MemoryStore.from_numpy(_jax_leaves(js), tcfg, device="cpu")
    assert ts.calibrated and ts.proj.dtype == torch.bfloat16
    assert_same_leaves(js, ts)
    for mode in ("two_phase", "ideal"):
        jr = jax_search(jcfg.search, js, queries, JRequest(mode=mode, k=16))
        tr = RetrievalEngine(tcfg.search).search(ts, queries,
                                                 SearchRequest(mode=mode,
                                                               k=16))
        for f in ("dist", "indices", "labels"):
            np.testing.assert_array_equal(np.asarray(getattr(jr, f)),
                                          _np(getattr(tr, f)), err_msg=f)
        np.testing.assert_array_equal(np.asarray(jr.predict()),
                                      _np(tr.predict()))
    with pytest.raises(ValueError, match="missing leaves"):
        MemoryStore.from_numpy({"values": np.zeros((4, 48))}, tcfg,
                               device="cpu")


@pytest.mark.parametrize("calibrate", [False, True])
def test_numpy_round_trip_keeps_calibration(calibrate):
    """`from_numpy(to_numpy())` keeps whether the store was calibrated: a
    never-calibrated `from_quantized` store still refuses float queries
    after the round trip, and a calibrated one keeps its range."""
    _, tcfg = _configs(8)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((8, 48)).astype(np.float32)
    if calibrate:
        st = MemoryStore.create(tcfg, device="cpu").calibrate(x).write(
            x, np.arange(8))
    else:
        v = rng.integers(0, 25, size=(8, 48)).astype(np.int32)
        st = MemoryStore.from_quantized(v, np.arange(8), tcfg.search,
                                        device="cpu")
    back = MemoryStore.from_numpy(st.to_numpy(), st.cfg, device="cpu")
    assert back.calibrated is calibrate
    for f in t_store.DATA_FIELDS:
        assert torch.equal(getattr(back, f), getattr(st, f)), f
    if calibrate:
        assert torch.equal(back.quantize_queries(x), st.quantize_queries(x))
    else:
        with pytest.raises(ValueError, match="never-calibrated"):
            back.quantize_queries(x)


# -- search --------------------------------------------------------------------

BACKENDS = ("auto", "ref", "mxu", "fused")


@pytest.mark.parametrize("fused_min_rows", [None, 64],
                         ids=["below_threshold", "above_threshold"])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", ["two_phase", "ideal"])
def test_search_matches_reference(programmed, mode, backend,
                                  fused_min_rows):
    """Rows, distances and labels exact on both sides of fused_min_rows
    (512 rows: below the default 1024, above 64), noisy and noiseless;
    votes exact for `ideal` (-dist) and at >= 99% agreement for
    `two_phase`."""
    jcfg, tcfg, js, ts, queries = programmed
    noisy_cases = (None, False) if mode == "two_phase" else (None,)
    for noisy in noisy_cases:
        jreq = JRequest(mode=mode, k=16, backend=backend,
                        fused_min_rows=fused_min_rows, noisy=noisy)
        treq = SearchRequest(mode=mode, k=16, backend=backend,
                             fused_min_rows=fused_min_rows, noisy=noisy)
        jr = jax_search(jcfg.search, js, queries, jreq)
        tr = RetrievalEngine(tcfg.search).search(ts, queries, treq)
        assert tr.iterations == jr.iterations
        for f in ("dist", "indices", "labels"):
            np.testing.assert_array_equal(np.asarray(getattr(jr, f)),
                                          _np(getattr(tr, f)), err_msg=f)
        jv, tv = np.asarray(jr.votes), _np(tr.votes)
        if mode == "ideal":
            np.testing.assert_array_equal(jv, tv)
        else:
            assert (jv == tv).mean() >= VOTE_AGREEMENT
        np.testing.assert_array_equal(np.asarray(jr.predict()),
                                      _np(tr.predict()))


def test_full_matches_reference_ref_backend(programmed, full_results):
    """`full` on the port's default backend and (for the first 4 queries,
    whose noise coordinates are their batch positions either way) on
    `ref`, against the JAX `ref` backend: dist, rows and labels exact,
    votes at >= 99% agreement; and the two_phase votes of every
    shortlisted row equal the full votes of that row (the engine's
    contract)."""
    _, tcfg, _, ts, queries = programmed
    jr, full = full_results
    eng = RetrievalEngine(tcfg.search)
    ref = eng.search(ts, queries[:4], SearchRequest(mode="full",
                                                    backend="ref"))
    for tr, b in ((full, 20), (ref, 4)):
        for f in ("dist", "indices", "labels"):
            np.testing.assert_array_equal(np.asarray(getattr(jr, f))[:b],
                                          _np(getattr(tr, f)), err_msg=f)
        assert (np.asarray(jr.votes)[:b] == _np(tr.votes)).mean() \
            >= VOTE_AGREEMENT
        np.testing.assert_array_equal(np.asarray(jr.predict())[:b],
                                      _np(tr.predict()))
    tp = eng.search(ts, queries, SearchRequest(mode="two_phase", k=16))
    np.testing.assert_array_equal(
        np.take_along_axis(_np(full.votes), _np(tp.indices), 1),
        _np(tp.votes))


@pytest.mark.parametrize("backend", BACKENDS)
def test_empty_store_predicts_sentinel(backend):
    _, tcfg = _configs(40)
    st = MemoryStore.create(tcfg, device="cpu").calibrate(_dyadic_sample(5))
    q = np.random.default_rng(6).standard_normal((3, 48)).astype(np.float32)
    eng = RetrievalEngine(tcfg.search)
    for mode in ("full", "two_phase", "ideal"):
        for fmr in (None, 1):
            res = eng.search(st, q, SearchRequest(mode=mode, k=8,
                                                  backend=backend,
                                                  fused_min_rows=fmr))
            assert _np(res.predict()).tolist() == [-1, -1, -1], (mode, fmr)
            assert np.isneginf(_np(res.votes)).all()


def test_quickstart_shaped_run_predicts_the_same(programmed, full_results):
    """examples/quickstart.py end to end (20-way 10-shot, d=48, MTMC
    CL=32, capacity 512; full, then two_phase k=32): both packages predict
    the same labels, all of them right. Calibrating on the supports, as
    the quickstart does, gives the same range to rtol 1e-6 and the same
    words."""
    jcfg, tcfg, js, ts, queries = programmed
    jr, tr = full_results
    np.testing.assert_array_equal(np.asarray(jr.predict()), _np(tr.predict()))
    assert _np(tr.predict()).tolist() == list(range(20))
    req = dict(mode="two_phase", k=32)
    jp = jax_search(jcfg.search, js, queries, JRequest(**req)).predict()
    tp = RetrievalEngine(tcfg.search).search(ts, queries,
                                             SearchRequest(**req)).predict()
    np.testing.assert_array_equal(np.asarray(jp), _np(tp))
    assert _np(tp).tolist() == list(range(20))
    support, labels, _ = _clustered(1, 20, 10)
    jc = jax_program(jcfg, support, support, labels)
    tc = MemoryStore.create(tcfg, device="cpu").calibrate(support).write(
        support, labels)
    np.testing.assert_allclose(float(tc.lo), float(jc.lo), rtol=1e-6)
    np.testing.assert_allclose(float(tc.hi), float(jc.hi), rtol=1e-6)
    np.testing.assert_array_equal(_np(tc.values), np.asarray(jc.values))


# -- the API surface -----------------------------------------------------------


def test_request_result_and_backends_match_reference():
    for b in ("auto", "ref", "pallas", "mxu", "fused"):
        for uk in ("auto", "ref", "fused"):
            assert t_backends.resolve_backend(b, uk) == \
                j_backends.resolve_backend(b, uk)
    assert t_backends.BACKENDS == j_backends.BACKENDS
    with pytest.raises(ValueError):
        t_backends.resolve_backend("tpu")
    for bad in ({"mode": "dense"}, {"mode": "full", "nprobe": 2},
                {"nprobe": 0}):
        with pytest.raises(ValueError):
            SearchRequest(**bad)
    from repro.engine.api import SearchRequest as JReq
    assert [f.name for f in dataclasses.fields(SearchRequest)] == \
        [f.name for f in dataclasses.fields(JReq)]
    r = SearchResult(votes=torch.tensor([[1.0, 3.0, 3.0]]),
                     dist=torch.tensor([[0.0, 2.0, 1.0]]),
                     indices=torch.tensor([[0, 1, 2]]),
                     labels=torch.tensor([[5, 7, 9]]))
    assert r.best().tolist() == [2] and r.predict().tolist() == [9]
    assert set(r.asdict()) == {"votes", "dist", "indices", "labels",
                               "iterations"}
    assert IDEAL_FUSED_MIN_ROWS == 1024


def test_engine_overrides_are_cached():
    cfg = SearchConfig("mtmc", cl=8)
    eng = RetrievalEngine(cfg)
    assert eng.with_backend("auto") is eng
    assert eng.with_backend("mxu") is eng.with_backend("mxu")
    assert eng.with_backend("mxu").resolved_backend == "mxu"
    assert eng.with_noisy(None) is eng and eng.with_noisy(True) is eng
    quiet = eng.with_noisy(False)
    assert quiet is eng.with_noisy(False) and quiet.cfg.noisy is False
    assert eng._fused_threshold(SearchRequest(fused_min_rows=5)) == 5
    assert eng._fused_threshold() == IDEAL_FUSED_MIN_ROWS


# -- the port stands alone -----------------------------------------------------


def test_port_and_chip_smoke_load_no_jax_and_no_repro():
    """Importing every repro_torch module, and chip_smoke.py, in a fresh
    interpreter loads no `jax` and no module of the JAX package; no source
    of theirs names either in an import."""
    pkg = ROOT / "src" / "repro_torch"
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(pkg).with_suffix("").parts)
        for p in pkg.rglob("*.py") if p.name != "__init__.py")
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        "import importlib\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    assert {"repro_torch.checkpoint.ckpt", "repro_torch.core.hat",
            "repro_torch.core.kinks", "repro_torch.core.prng",
            "repro_torch.core.costmodel",
            "repro_torch.configs.omniglot_conv4",
            "repro_torch.configs.cub_resnet12",
            "repro_torch.data.fsl", "repro_torch.kernels.mcam_episode",
            "repro_torch.launch.steps", "repro_torch.launch.train",
            "repro_torch.launch.serve", "repro_torch.engine.router",
            "repro_torch.engine.tenant", "repro_torch.engine.pager",
            "repro_torch.models.controller", "repro_torch.optim.optimizers",
            "repro_torch.examples.quickstart",
            "repro_torch.examples.fsl_omniglot",
            "repro_torch.examples.serve_retrieval",
            "repro_torch.configs.base",
            "repro_torch.configs.starcoder2_3b",
            "repro_torch.configs.deepseek_moe_16b",
            "repro_torch.models.layers", "repro_torch.models.moe",
            "repro_torch.models.ssm", "repro_torch.models.transformer",
            "repro_torch.data.lm", "repro_torch.runtime.compression",
            "repro_torch.runtime.ft", "repro_torch.examples.train_llm",
            "repro_torch.tree", "repro_torch.models.sharding",
            "repro_torch.runtime.pipeline", "repro_torch.core.memory",
            "repro_torch.launch.mesh"} <= set(mods)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    for path in list(pkg.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                    (path, n)
