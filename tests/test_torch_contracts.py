"""The port's contract registry and checks (`repro_torch.analysis.registry`
/ `contracts`), on the CPU.

The registry holds the reference's matrix: the same `entry|config` keys
with the same invariants as `repro.analysis.registry.build_cells()` (the
JAX cells are listed without being built, with the 8 devices the
reference's CLI forces). Every cell passes here, a broken invariant
fails, and `diff` exits non-zero on a new failure.

Two faults the contracts found in the port, each pinned here (both
failed on the parent tree): the router's `bucket_sums` summed with
`index_add_` over boolean-indexed rows, a scatter inside the multi-shard
write-through the reference keeps scatter-free (and a read back to the
host on the card), and a routed search of a partitioned store without
its packed projection raised instead of streaming the wide one.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import registry as j_registry
from repro.core.avss import SearchConfig as JSearchConfig
from repro.engine import MemoryStore as JStore
from repro.engine import RetrievalEngine as JEngine
from repro.engine import SearchRequest as JRequest
from repro.engine import router as j_router
from repro_torch.analysis import contracts as hc
from repro_torch.analysis import cost as cost_lib
from repro_torch.analysis import registry
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.core.avss import SearchConfig
from repro_torch.engine import MemoryStore, RetrievalEngine, SearchRequest
from repro_torch.engine import router as router_lib

torch.set_num_threads(1)


def _reference_cells(monkeypatch):
    monkeypatch.setattr(jax, "devices", lambda *a, **k: [None] * 8)
    return j_registry.build_cells()


def test_registry_keys_and_invariants_equal_the_reference(monkeypatch):
    want = [(c.key, c.invariants) for c in _reference_cells(monkeypatch)]
    monkeypatch.undo()
    got = [(c.key, c.invariants) for c in registry.build_cells("cpu")]
    assert got == want
    assert not any(c.skip for c in registry.build_cells("cpu"))
    assert set(registry.INVARIANTS) == set(j_registry.INVARIANTS)


_CELLS = {c.key: c for c in registry.build_cells("cpu")}
SUBSET = [
    'engine.search|{"backend": "fused", "fused_min_rows": 1, '
    '"mode": "ideal", "packed": true, "sharded": false}',
    'engine.search|{"backend": "mxu", "fused_min_rows": 1073741824, '
    '"mode": "two_phase", "packed": true, "sharded": false}',
    'engine.search|{"backend": "fused", "fused_min_rows": 1073741824, '
    '"mode": "two_phase", "packed": false, "sharded": true}',
    'engine.search|{"backend": "mxu", "fused_min_rows": 1073741824, '
    '"mode": "two_phase", "n_shards": 8, "nprobe": 2, "packed": true}',
    'engine.search|{"backend": "mxu", "fused_min_rows": 1073741824, '
    '"mode": "two_phase", "n_shards": 8, "nprobe": 8, "packed": true}',
    'engine.search_tenants|{"backend": "fused", "fused_min_rows": 1, '
    '"mode": "ideal", "packed": false}',
    'MemoryStore.write|{"n_shards": 8, "path": "multi_shard"}',
    'MemoryStore.write|{"n_shards": 1, "path": "unsharded"}',
    'episode_votes|{}',
    'engine.two_phase(raw-arrays)|{"control": "read-time layout"}',
    'engine.search|{"check": "jit cache"}',
]


@pytest.mark.parametrize("key", SUBSET)
def test_cells_pass(key):
    cell = _CELLS[key]
    report = registry.run_cells([cell])
    assert report["summary"] == {"pass": len(cell.invariants), "fail": 0,
                                 "error": 0, "skip": 0}, report["cells"]


def test_fused_cells_record_their_kernel_and_buffers():
    cell = _CELLS[SUBSET[0]]
    art = cell.build()
    assert art["expect_fused"] and art["trace"]["launches"] == {
        "shortlist": 1}
    assert art["hbm"]["strict"] is False
    assert art["hbm"]["measured_bytes"] == art["trace"]["temp_bytes"]
    dense = _CELLS[SUBSET[1]].build()
    assert dense["trace"]["launches"] == {"mcam_dist": 1, "mcam_rescore": 1}
    assert hc.FUSED_SCOPE_TAG not in dense["trace"]["tags"]


def test_registry_detects_broken_invariant():
    """A cell whose artifacts violate its invariant FAILS: feed the
    inverted expectation to a real cell."""
    art = _CELLS[SUBSET[0]].build()
    assert registry.INVARIANTS["fused_tag_iff_dispatch_rule"](
        {**art, "expect_fused": False})
    assert registry.INVARIANTS["no_layout_ops"](
        _CELLS[SUBSET[9]].build())
    with pytest.raises(AssertionError, match="fused-shortlist"):
        hc.assert_fused_tag(art["trace"], False)
    with pytest.raises(AssertionError, match="crossed"):
        hc.assert_no_collectives({"collectives": {"all-gather": 8}})
    with pytest.raises(AssertionError, match="per tenant count"):
        hc.assert_single_jit_entry_across_tenants({1: 1, 5: 2})


def test_cli_run_passes_every_cell(tmp_path, capsys):
    out = tmp_path / "report.json"
    assert analysis_main(["run", "--device", "cpu", "--out",
                          str(out)]) == 0
    report = json.loads(out.read_text())
    n = sum(len(c.invariants) for c in registry.build_cells("cpu"))
    assert report["summary"] == {"pass": n, "fail": 0, "error": 0,
                                 "skip": 0}
    for row in report["cells"]:
        assert {"entry", "config", "invariant", "status", "detail",
                "matched"} <= set(row)


def _report(failing_keys):
    return {"meta": {}, "summary": {},
            "cells": [{"entry": e, "config": {}, "invariant": i,
                       "status": "fail", "detail": "", "matched": []}
                      for e, i in failing_keys]}


def test_cli_diff_new_failure_is_red(tmp_path, capsys):
    old = tmp_path / "old.json"
    new = tmp_path / "new.json"
    old.write_text(json.dumps(_report([("a", "no_f64_promotion")])))
    new.write_text(json.dumps(_report([("a", "no_f64_promotion"),
                                       ("b", "no_collectives")])))
    assert analysis_main(["diff", str(old), str(new)]) == 1
    assert "NEW FAILURE" in capsys.readouterr().out
    assert analysis_main(["diff", str(new), str(old)]) == 0
    assert "fixed" in capsys.readouterr().out


def test_bucket_sums_are_scatter_free_and_exact():
    """The router sketch's bucket sums: no scatter under any spelling and
    no read back to the host, equal to the reference's
    (`repro.engine.router.bucket_sums`) on the same arrays, labels of -1,
    empty buckets, more rows than one float32 product sums exactly and
    int32 sums that wrap included."""
    rng = np.random.default_rng(0)
    for n, lo, top in ((50, 0, 4), (300, 0, 97), (7, 0, 1 << 20), (0, 0, 4),
                       (70_000, 0, 97), (40, -(1 << 31), 1 << 31)):
        values = rng.integers(lo, top, size=(n, 6)).astype(np.int32)
        labels = rng.integers(-1, 30, size=(n,)).astype(np.int32)
        labels[: n // 5] = -1
        out, rec = cost_lib.trace(router_lib.bucket_sums,
                                  torch.from_numpy(values),
                                  torch.from_numpy(labels))
        hc.assert_no_scatter_any_spelling(rec)
        assert "aten.nonzero" not in rec["op_census"]
        assert rec["host_syncs"] == 0
        want = jax.jit(j_router.bucket_sums)(jnp.asarray(values),
                                              jnp.asarray(labels))
        assert out[0].dtype == torch.int32 and out[1].dtype == torch.int32
        assert np.array_equal(out[0].numpy(), np.asarray(want[0])), n
        assert np.array_equal(out[1].numpy(), np.asarray(want[1])), n


@pytest.mark.parametrize("mode", ["two_phase", "ideal"])
def test_routed_search_streams_the_unpacked_table(mode):
    """A partitioned store without its packed projection routes through
    the wide one: equal to the reference's routed search of the same
    store without its packed projection, and to the port's packed store's
    routed search."""
    import dataclasses
    rng = np.random.default_rng(1)
    values = rng.integers(0, 97, size=(64, 20))
    labels = np.arange(64) % 9
    labels[labels % 4 == 0] = -1
    q = rng.integers(0, 4, size=(5, 20))
    cfg = SearchConfig("mtmc", cl=32, mode="avss", use_kernel="ref")
    store = MemoryStore.from_quantized(values, labels, cfg,
                                       device="cpu").shard(n_shards=8)
    jcfg = JSearchConfig("mtmc", cl=32, mode="avss", use_kernel="ref")
    jstore = JStore.from_quantized(jnp.asarray(values), jnp.asarray(labels),
                                   jcfg).shard(n_shards=8)
    assert jstore.proj_packed is not None
    req = SearchRequest(mode=mode, k=8, nprobe=2)
    got = RetrievalEngine(cfg, backend="fused").search(
        dataclasses.replace(store, proj_packed=None), torch.from_numpy(q),
        req)
    jreq = JRequest(mode=mode, k=8, nprobe=2)
    want = jax.jit(lambda s_, q_: JEngine(jcfg, backend="fused").search(
        s_, q_, jreq))(dataclasses.replace(jstore, proj_packed=None),
                       jnp.asarray(q))
    packed = RetrievalEngine(cfg, backend="fused").search(
        store, torch.from_numpy(q), req)
    for f in ("votes", "dist", "indices", "labels"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
        assert torch.equal(getattr(got, f), getattr(packed, f)), f


def test_profiler_ranges_open_only_while_recorded():
    """The package's profiler ranges cost the serving path nothing: none
    is entered unless a trace or a profiler records, and both see the
    fused shortlist's."""
    import contextlib
    from repro_torch.kernels import _build, shortlist
    assert isinstance(_build.profiler_range(shortlist.FUSED_TAG),
                      contextlib.nullcontext)
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.integers(0, 4, size=(3, 6)))
    proj = torch.from_numpy(rng.integers(0, 9, size=(20, 24))).to(
        torch.bfloat16)
    prof = torch.profiler
    with prof.profile(activities=[prof.ProfilerActivity.CPU]) as p:
        want = shortlist.lut_shortlist(q, proj, 4)
    assert shortlist.FUSED_TAG in {e.name for e in p.events()}
    got, rec = cost_lib.trace(shortlist.lut_shortlist, q, proj, 4)
    assert rec["tags"] == [shortlist.FUSED_TAG]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
