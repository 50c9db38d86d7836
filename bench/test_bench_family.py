"""The harness drives a program family it does not name. A stub family,
written with its own configuration, mix, cell, NUMBERS and plain
reference into a temporary benchmark beside copies of the readers it
reports, runs through harness.run at its dry size; bench/harness.py,
bench/run.py and bench/control.py name no family, configuration, mix,
cell, loop or metric; and the cells that were there before the
interface read as they did: their compared numbers and limits, their
metrics and (bench/test_bench_work.py) their work."""

import ast
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

from bench import harness

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())

STUB = '''"""A stub family: scores of seeded queries against a seeded table."""
import importlib.util
from pathlib import Path

import torch

from bench.trace import SEARCH_SPAN

_spec = importlib.util.spec_from_file_location(
    "stub_reference", Path(__file__).parent.parent / "reference" / "stub.py")
reference = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(reference)

NUMBERS = ("scores_wrong", "answers_wrong")


class Program:
    def __init__(self, dtype):
        self.dtype = dtype

    def __call__(self, table, q):
        return (q.to(self.dtype) @ table.to(self.dtype).T).to(torch.float64)


def _table(config, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return gen, torch.randn(config["rows"], config["dim"], generator=gen,
                            device=device, dtype=torch.float64)


def setup(config, traffic, seed, device, program=None):
    gen, table = _table(config, seed, device)
    return {"gen": gen, "table": table, "traffic": traffic, "config": config,
            "program": program or Program(torch.float64)}


def issue(state, no, span):
    t = state["traffic"]
    q = torch.randn(t["batch"], state["config"]["dim"], generator=state["gen"],
                    device=state["table"].device, dtype=torch.float64)
    with span(SEARCH_SPAN):
        out = state["program"](state["table"], q)
    return t["batch"], out.argmax(1), {"q": q, "out": out}, no


def deliver(home):
    return home.clone()


def replay(state, seed, device):
    return _table(state["config"], seed, device)[1]


def check(state, table, sampled, device):
    out = dict.fromkeys(NUMBERS, 0)
    for kept, delivered, _ in sampled.values():
        want = reference.scores(table, kept["q"])
        out["scores_wrong"] += int((kept["out"] != want).sum())
        out["answers_wrong"] += int((delivered != want.argmax(1)).sum())
    return out


def control(config, device):
    return Program(torch.float32)


def dry(config, traffic):
    return dict(config, rows=config["rows"] // 4), dict(traffic, batch=4)


def size(config, traffic):
    return {"rows": config["rows"]}


def work(config, traffic):
    return {}
'''

REFERENCE = '''"""The stub family's plain reference."""
import torch


def scores(table, q):
    return q.to(torch.float64) @ table.to(torch.float64).T
'''


@pytest.fixture
def stub_root(tmp_path):
    bench = tmp_path / "bench"
    for d in ("configs", "traffic", "workloads", "families", "reference",
              "loops", "metrics"):
        (bench / d).mkdir(parents=True)
    (bench / "families" / "stub.py").write_text(STUB)
    (bench / "reference" / "stub.py").write_text(REFERENCE)
    for kind, name in (("loops", "closed"), ("metrics", "qps"),
                       ("metrics", "setup_s")):
        shutil.copy(ROOT / "bench" / kind / f"{name}.py", bench / kind)
    (bench / "configs" / "stub-config.json").write_text(json.dumps(
        {"name": "stub-config", "program": "stub", "rows": 256, "dim": 8}))
    (bench / "traffic" / "stub-mix.json").write_text(json.dumps(
        {"loop": "closed", "batch": 16, "in_flight": 2, "warmup_batches": 1,
         "trace_seconds": 1, "check_batches": 3}))
    (bench / "workloads" / "stub-cell.json").write_text(json.dumps(
        {"config": "stub-config", "traffic": "stub-mix", "chips": 1,
         "why": "a stub", "limits": {"scores_wrong": 0,
                                     "answers_wrong": 0}}))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(
        {"end_to_end": [{"name": "qps", "unit": "queries/s"},
                        {"name": "setup_s", "unit": "s"}],
         "per_layer": []}))
    return tmp_path


def test_a_stub_family_runs_through_the_harness(stub_root):
    cell = harness.dry(harness.load_cell("stub-cell", stub_root))
    assert cell.config["rows"] == 64 and cell.traffic["batch"] == 4
    assert cell.traffic["check_batches"] == 2
    out = harness.run(cell, 2**33 + 1, 0.2, False, "cpu")
    assert out["correct"] and out["attempted"] % 4 == 0
    assert set(out["metrics"]) == {"qps", "setup_s"}
    assert list(out["compared"]) == ["scores_wrong", "answers_wrong"]
    control = harness.run(cell, 2**33 + 1, 0.2, False, "cpu",
                          program=cell.family.control(cell.config, "cpu"))
    assert not control["correct"]
    assert control["compared"]["scores_wrong"]["value"] > 0


def _names_in_code(path: Path) -> set[str]:
    """The string constants (docstrings left out) and identifiers of a
    module."""
    tree = ast.parse(path.read_text())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
            and n.body and isinstance(n.body[0], ast.Expr)
            and isinstance(n.body[0].value, ast.Constant)}
    out = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Constant) and isinstance(n.value, str) \
                and id(n) not in docs:
            out.add(n.value)
        elif isinstance(n, ast.Name):
            out.add(n.id)
        elif isinstance(n, ast.Attribute):
            out.add(n.attr)
    return out


@pytest.mark.parametrize("module", ["harness.py", "run.py", "control.py"])
def test_the_harness_names_no_family_cell_or_metric(module):
    bench = ROOT / "bench"
    names = {p.stem for d in ("families", "configs", "traffic", "workloads",
                              "loops", "metrics")
             for p in (bench / d).iterdir() if p.suffix in (".py", ".json")}
    names |= {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    names |= {w["name"] for w in BENCH["workloads"]}
    # every cell reports the set-up time, which the harness itself takes
    names.discard("setup_s")
    words = _names_in_code(bench / module)
    assert not {w for w in words for n in names if n in w.split()}, module
    assert not words & names, module


BEFORE = {
    "omniglot-2p-4m": ["search_host_ms", "launches_per_batch",
                       "syncs_per_batch", "shortlist_roofline",
                       "rescore_roofline", "idle_pct", "search_wait_ms",
                       "search_dispatch_ms", "rescore_device_ms"],
    "cub-2p-256k": ["search_host_ms", "launches_per_batch",
                    "syncs_per_batch", "shortlist_roofline",
                    "rescore_roofline", "idle_pct", "search_wait_ms",
                    "search_dispatch_ms", "rescore_device_ms"],
    "omniglot-full-1m": ["search_host_ms", "launches_per_batch",
                         "syncs_per_batch", "dense_roofline", "idle_pct",
                         "search_wait_ms", "search_dispatch_ms"],
    "cub-ingest-256k": ["search_host_ms", "launches_per_batch",
                        "syncs_per_batch", "shortlist_roofline",
                        "rescore_roofline", "write_device_ms", "idle_pct",
                        "search_wait_ms", "search_dispatch_ms",
                        "rescore_device_ms", "write_copy_ms",
                        "write_wait_ms", "write_dispatch_ms"]}
COMPARED = ["query_words_wrong", "rows_wrong", "dist_wrong", "votes_wrong",
            "labels_wrong", "predictions_wrong", "store_wrong"]


@pytest.mark.parametrize("cell", sorted(BEFORE))
def test_the_cells_before_the_interface_read_as_they_did(cell):
    c = harness.load_cell(cell)
    assert [m["name"] for m in c.end_to_end] == ["qps", "p95_ms", "setup_s"]
    assert [m["name"] for m in c.per_layer] == BEFORE[cell]
    torch.set_num_threads(2)
    out = harness.run(harness.dry(c), 4000000003, 0.2, False, "cpu")
    assert out["correct"] and list(out["metrics"]) == ["qps", "p95_ms",
                                                       "setup_s"]
    assert out["compared"] == {k: {"value": 0, "limit": 0}
                               for k in COMPARED}
    assert list(out["compared"]) == COMPARED
