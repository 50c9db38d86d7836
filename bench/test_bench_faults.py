"""The check has to fail what it guards against. The harness runs on the
CPU at the dry size (bench/run.py --dry) with the search or the write
broken underneath, or with the control in the program's place, and
`correct` comes out false; the unbroken program comes out true."""

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

from bench import harness
from bench.reference.program import Reference

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


@pytest.fixture(autouse=True)
def _few_threads():
    """The tests' tensors are small: two threads a test process keep
    parallel test workers from oversubscribing the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(cell: str, seed: int = 7, program=None) -> dict:
    return harness.run(harness.dry(harness.load_cell(cell)), seed, 0.3,
                       False, "cpu", program=program)


@pytest.mark.parametrize("cell", ["omniglot-2p-4m", "cub-ingest-256k"])
def test_sound_program_is_correct(cell):
    assert _run(cell)["correct"]


def test_skewed_classes_are_served_correctly():
    c = harness.dry(harness.load_cell("cub-ingest-256k"))
    c = dataclasses.replace(c, traffic=dict(c.traffic, class_skew=1.1))
    assert harness.run(c, 11, 0.3, False, "cpu")["correct"]


@pytest.mark.parametrize("cell", ["omniglot-2p-4m", "cub-2p-256k",
                                  "omniglot-full-1m", "cub-ingest-256k"])
def test_bfloat16_control_is_not_correct(cell):
    c = harness.dry(harness.load_cell(cell))
    c = dataclasses.replace(c, traffic=dict(c.traffic, warmup_batches=0))
    out = harness.run(c, 5, 0.3, False, "cpu",
                      program=Reference(c.config, "cpu", torch.bfloat16))
    assert not out["correct"]
    assert out["compared"]["votes_wrong"]["value"] > 0


def test_write_that_leaves_the_store_unchanged_is_caught(monkeypatch):
    from repro_torch.engine import MemoryStore
    real, calls = MemoryStore.write, [0]

    def write(self, x, labels):
        calls[0] += 1            # the dry store is programmed in 2 writes
        return self if calls[0] > 2 else real(self, x, labels)
    monkeypatch.setattr(MemoryStore, "write", write)
    out = _run("cub-ingest-256k")
    assert calls[0] > 2 and not out["correct"]
    assert out["compared"]["store_wrong"]["value"] > 0


@pytest.mark.parametrize("cell", ["omniglot-2p-4m", "omniglot-full-1m"])
def test_half_the_batch_left_out_is_caught(monkeypatch, cell):
    from repro_torch.engine import RetrievalEngine, SearchResult
    real = RetrievalEngine.search

    def search(self, store, queries, request=None):
        half = real(self, store, queries[:queries.shape[0] // 2], request)
        return SearchResult(*(torch.cat([t, t]) for t in (
            half.votes, half.dist, half.indices, half.labels)),
            half.iterations)
    monkeypatch.setattr(RetrievalEngine, "search", search)
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("cell", ["cub-2p-256k", "omniglot-full-1m"])
def test_an_altered_answer_is_caught(monkeypatch, cell):
    from repro_torch.engine import SearchResult
    real = SearchResult.predict

    def predict(self):
        pred = real(self).clone()
        pred[-1] += 1
        return pred
    monkeypatch.setattr(SearchResult, "predict", predict)
    out = _run(cell)
    assert not out["correct"]
    assert out["compared"]["predictions_wrong"]["value"] > 0
