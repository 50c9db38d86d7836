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
        seen[w["name"]] = {k: v["bound_ms"] for k, v in
                           work.cell_work(cell.config, cell.traffic).items()}
    # batches of 1,024: the shortlist's one-hot product binds
    want = {"omniglot-2p-4m": {"shortlist": 0.8333, "rescore": 0.0676},
            "cub-2p-256k": {"shortlist": 0.5209, "rescore": 0.5282},
            "cub-ingest-256k": {"shortlist": 0.5209, "rescore": 0.5282},
            "omniglot-full-1m": {"dense": 17.31}}
    for name, bounds in want.items():
        assert seen[name] == pytest.approx(bounds, rel=0.002), name


def test_work_imports_no_program():
    tree = ast.parse(Path(work.__file__).read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert not names & {"repro", "repro_torch", "jax", "jaxlib"}
