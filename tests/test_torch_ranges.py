"""The port's profiler ranges at the layer boundaries of the search and
write paths (`kernels/_build.profiler_range`), on the CPU: each is closed
outside a profiler, and under one every stage of a search or a write opens
inside its root range. The write's stages, reordered so that each is one
range, program the same store bit for bit as the interleaved order."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.avss import SearchConfig
from repro_torch.core.memory import MemoryConfig
from repro_torch.engine import MemoryStore, RetrievalEngine, SearchRequest
from repro_torch.engine import api
from repro_torch.engine import engine as engine_lib
from repro_torch.engine import router as router_lib
from repro_torch.engine import store as store_lib
from repro_torch.kernels import _build
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import shortlist
from repro_torch.launch.mesh import Mesh

SEARCH_STAGES = {
    "two_phase": [store_lib.QUERY_TAG, shortlist.FUSED_TAG,
                  engine_lib.GRIDS_TAG, kernel_ops.RESCORE_TAG,
                  engine_lib.LABELS_TAG],
    "full": [store_lib.QUERY_TAG, engine_lib.GRIDS_TAG, kernel_ops.DENSE_TAG,
             engine_lib.LABELS_TAG],
    "ideal": [store_lib.QUERY_TAG, shortlist.FUSED_TAG,
              engine_lib.LABELS_TAG],
}
WRITE_STAGES = [store_lib.QUANTIZE_TAG, store_lib.CURSOR_TAG,
                store_lib.PROJECTION_TAG, store_lib.PACK_TAG,
                store_lib.GRID_TAG, store_lib.COMMIT_TAG,
                store_lib.SKETCH_TAG]
NEW_TAGS = [engine_lib.SEARCH_TAG, engine_lib.GRIDS_TAG,
            engine_lib.LABELS_TAG, api.PREDICT_TAG, kernel_ops.RESCORE_TAG,
            kernel_ops.DENSE_TAG, store_lib.QUERY_TAG, store_lib.WRITE_TAG,
            *WRITE_STAGES]


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _store(capacity=128, d=16, classes=12, shots=5, seed=0, shard=None):
    cfg = MemoryConfig(capacity=capacity, dim=d,
                       search=SearchConfig("mtmc", cl=8))
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((classes, d)).astype(np.float32) * 2
    labels = np.repeat(np.arange(classes, dtype=np.int32), shots)
    x = centres[labels] + 0.3 * rng.standard_normal(
        (labels.size, d)).astype(np.float32)
    store = MemoryStore.create(cfg, device="cpu").calibrate(x)
    if shard:
        store = store.shard(**shard)
    return store, x, labels, centres


def _ranges(prof, names) -> list[tuple[str, int, int]]:
    """(name, start, end) of every host range named in `names`, by start."""
    out = [(e.name(), e.start_ns(), e.end_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name() in names and e.device_type().name == "CPU"]
    return sorted(out, key=lambda r: r[1])


def _profile(fn):
    prof = torch.profiler
    with prof.profile(activities=[prof.ProfilerActivity.CPU]) as p:
        out = fn()
    return p, out


def _inside(stage, root) -> bool:
    return root[1] <= stage[1] and stage[2] <= root[2]


@pytest.mark.parametrize("tag", NEW_TAGS)
def test_range_is_closed_outside_a_profiler(tag):
    assert isinstance(_build.profiler_range(tag), contextlib.nullcontext)


def test_range_names_are_distinct_and_keep_the_read_ones():
    assert len(set(NEW_TAGS)) == len(NEW_TAGS)
    assert shortlist.FUSED_TAG == "shortlist_fused"
    assert not {shortlist.FUSED_TAG, "layout_support",
                "router_sketch"} & set(NEW_TAGS)


@pytest.mark.parametrize("mode", ["two_phase", "full", "ideal"])
def test_search_stages_open_inside_the_search_range(mode):
    store, x, labels, centres = _store()
    store = store.write(x, labels)
    engine = RetrievalEngine(store.cfg.search, backend="fused")
    request = SearchRequest(mode=mode, k=8)
    p, res = _profile(lambda: engine.search(store, centres, request))
    names = set(SEARCH_STAGES[mode]) | {engine_lib.SEARCH_TAG}
    got = _ranges(p, names)
    roots = [r for r in got if r[0] == engine_lib.SEARCH_TAG]
    assert len(roots) == 1
    stages = [r for r in got if r[0] != engine_lib.SEARCH_TAG]
    assert [r[0] for r in stages] == SEARCH_STAGES[mode]
    assert all(_inside(r, roots[0]) for r in stages)
    p, pred = _profile(res.predict)
    assert [r[0] for r in _ranges(p, {api.PREDICT_TAG})] == [
        api.PREDICT_TAG]
    assert torch.equal(pred, res.predict())


def test_rescore_range_covers_every_route():
    """The routed search rescores through the same wrapper, on `ref` its
    plain twin: each call opens `kernels.rescore`."""
    store, x, labels, centres = _store(shard={"n_shards": 4})
    store = store.write(x, labels)
    for backend in ("fused", "ref"):
        engine = RetrievalEngine(store.cfg.search, backend=backend)
        request = SearchRequest(mode="two_phase", k=8, nprobe=2)
        p, _ = _profile(lambda: engine.search(store, centres, request))
        got = _ranges(p, {engine_lib.SEARCH_TAG, kernel_ops.RESCORE_TAG})
        assert [r[0] for r in got] == [engine_lib.SEARCH_TAG,
                                       kernel_ops.RESCORE_TAG], backend
        assert _inside(got[1], got[0])


def test_write_stages_open_inside_the_write_range():
    store, x, labels, _ = _store()
    p, written = _profile(lambda: store.write(x, labels))
    got = _ranges(p, set(WRITE_STAGES) | {store_lib.WRITE_TAG})
    assert got[0][0] == store_lib.WRITE_TAG
    assert [r[0] for r in got[1:]] == WRITE_STAGES
    assert all(_inside(r, got[0]) for r in got[1:])
    assert int(written.size) == x.shape[0]


def test_streamed_write_stages_open_inside_the_write_range():
    store, x, labels, _ = _store(
        shard={"mesh": Mesh.repeat("cpu", (4,), ("data",)),
               "axes": ("data",)})
    p, written = _profile(lambda: store.write(x, labels))
    got = _ranges(p, set(WRITE_STAGES) | {store_lib.WRITE_TAG})
    assert got[0][0] == store_lib.WRITE_TAG
    assert [r[0] for r in got[1:]] == WRITE_STAGES
    assert all(_inside(r, got[0]) for r in got[1:])
    flat, *_ = _store()
    flat = flat.write(x, labels)
    for f in store_lib.ROW_FIELDS:
        assert torch.equal(getattr(written, f).full(torch.device("cpu")),
                           getattr(flat, f)), f


def _interleaved_program(self, idx, v, lab):
    """`MemoryStore._program` in its order before the stages were ranged:
    each leaf's put beside the computing of its value."""
    enc = self.cfg.search.enc
    proj = kernel_ops.support_projection(v, enc)
    s, r = self.sketch_sums.shape[:2]

    def put(old, new):
        return old.index_put((idx,), new.to(old.dtype))

    values, labels = put(self.values, v), put(self.labels, lab)
    if s == 1:
        ds_new, dc_new = router_lib.bucket_sums(v, lab, r)
        ds_old, dc_old = router_lib.bucket_sums(self.values[idx],
                                                self.labels[idx], r)
        sk_sums = self.sketch_sums + (ds_new - ds_old)[None]
        sk_counts = self.sketch_counts + (dc_new - dc_old)[None]
    else:
        sk_sums, sk_counts = router_lib.build_sketch(values, labels, s, r)
    return dataclasses.replace(
        self, values=values, proj=put(self.proj, proj),
        proj_packed=put(self.proj_packed,
                        kernel_ops.pack_projection(proj, enc)),
        s_grid=put(self.s_grid, store_lib._layout(v, self.cfg)),
        labels=labels, sketch_sums=sk_sums, sketch_counts=sk_counts,
        size=self.size + idx.shape[0])


@pytest.mark.parametrize("shards", [None, 4])
def test_staged_program_equals_the_interleaved_one(monkeypatch, shards):
    """Three writes, the third wrapping the ring, through the staged and
    the interleaved `_program`: every leaf equal, bit for bit."""
    shard = {"n_shards": shards} if shards else None
    base, x, labels, _ = _store(capacity=64, shard=shard)
    batches = [(x[:30], labels[:30]), (x[30:55], labels[30:55]),
               (x[5:40], labels[5:40] + 100)]

    def program():
        st = base
        for xb, lb in batches:
            st = st.write(xb, lb)
        return st

    staged = program()
    monkeypatch.setattr(MemoryStore, "_program", _interleaved_program)
    before = program()
    for f in store_lib.DATA_FIELDS:
        assert torch.equal(getattr(staged, f), getattr(before, f)), f
