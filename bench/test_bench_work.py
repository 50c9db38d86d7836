"""bench/work.py's bounds against the hand-checked figures of PERF.md's
kernel table (65,536 rows, B 256, k 64; `full` at B 16) and at the cells'
shapes. Imports nothing of the program."""

import ast
import json
from pathlib import Path

import pytest

from bench import work


@pytest.mark.parametrize("b, n, d, want_us", [
    (256, 65536, 48, 3.85), (256, 65536, 480, 37.8),
    (256, 1048576, 48, 60.5), (256, 262144, 480, 150.5)])
def test_shortlist_bound(b, n, d, want_us):
    got = work.shortlist(b, n, d, 64)
    assert got["bound_by"] == "bytes"
    assert got["bound_ms"] * 1e3 == pytest.approx(want_us, abs=0.05)


@pytest.mark.parametrize("s, want_us", [(64, 16.9), (500, 132.0)])
def test_rescore_bound(s, want_us):
    got = work.rescore(256, 64, s, 24)
    assert got["bound_by"] == "operations"
    assert got["bound_ms"] * 1e3 == pytest.approx(want_us, rel=0.005)


@pytest.mark.parametrize("n, want_ms", [(65536, 1.082), (1048576, 17.3)])
def test_dense_bound(n, want_ms):
    got = work.dense(16, n, 64, 24)
    assert got["bound_by"] == "operations"
    assert got["bound_ms"] == pytest.approx(want_ms, rel=0.005)


def test_cells_work_from_their_files():
    from bench.harness import load_cell
    bench = json.loads((Path(work.__file__).parent.parent
                        / "BENCHMARK.json").read_text())
    seen = {}
    for w in bench["workloads"]:
        cell = load_cell(w["name"])
        seen[w["name"]] = {k: v["bound_ms"] for k, v in cell.family.work(
            cell.config, cell.traffic).items()}
    # batches of 1,024: the shortlist's one-hot product binds, but where
    # a routed query ranks an eighth of the rows and the batch reads them
    # all; the bounds of the first four cells as they were before the
    # family interface, to the bit
    want = {"omniglot-2p-4m": {"shortlist": 0.8333842555149065,
                               "rescore": 0.06760967641791045},
            "cub-2p-256k": {"shortlist": 0.5208651596968166,
                            "rescore": 0.5282005970149254},
            "cub-ingest-256k": {"shortlist": 0.5208651596968166,
                                "rescore": 0.5282005970149254},
            "omniglot-full-1m": {"dense": 17.308077162985075},
            "omniglot-routed-4m": {
                "shortlist": pytest.approx(0.2419, abs=5e-5),
                "rescore": 0.06760967641791045}}
    for name, bounds in want.items():
        assert seen[name] == bounds, name
    routed = load_cell("omniglot-routed-4m")
    got = routed.family.work(routed.config, routed.traffic)["shortlist"]
    assert got["bound_by"] == "bytes"
    assert got["ops"] == 2 * 1024 * 524288 * 192
    assert got["bytes"] == 4194304 * 193 + 1024 * 48 * 4 + 1024 * 64 * 12


@pytest.mark.parametrize("nprobe, b, rows_read", [
    (8, 1024, 4194304), (1, 16, 16 * 65536), (8, 2, 16 * 65536)])
def test_routed_bytes_are_the_distinct_rows_a_batch_can_read(nprobe, b,
                                                              rows_read):
    from bench.harness import load_cell
    cell = load_cell("omniglot-routed-4m")
    traffic = dict(cell.traffic, nprobe=nprobe, batch=b)
    got = cell.family.work(cell.config, traffic)["shortlist"]
    assert got["ops"] == 2 * b * nprobe * 65536 * 192
    assert got["bytes"] == rows_read * 193 + b * 48 * 4 + b * 64 * 12


def test_work_imports_no_program():
    tree = ast.parse(Path(work.__file__).read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert not names & {"repro", "repro_torch", "jax", "jaxlib"}
