"""The check has to fail what it guards against. The harness runs on the
CPU at the dry size (bench/run.py --dry) with the search, the route or
the write broken underneath, or with the control in the program's place,
and `correct` comes out false; the unbroken program comes out true."""

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

from bench import harness

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


@pytest.mark.parametrize("cell", ["omniglot-2p-4m", "cub-ingest-256k",
                                  "omniglot-routed-4m"])
def test_sound_program_is_correct(cell):
    assert _run(cell)["correct"]


def test_skewed_classes_are_served_correctly():
    c = harness.dry(harness.load_cell("cub-ingest-256k"))
    c = dataclasses.replace(c, traffic=dict(c.traffic, class_skew=1.1))
    assert harness.run(c, 11, 0.3, False, "cpu")["correct"]


@pytest.mark.parametrize("cell", ["omniglot-2p-4m", "cub-2p-256k",
                                  "omniglot-full-1m", "cub-ingest-256k",
                                  "omniglot-routed-4m"])
def test_bfloat16_control_is_not_correct(cell):
    c = harness.dry(harness.load_cell(cell))
    c = dataclasses.replace(c, traffic=dict(c.traffic, warmup_batches=0))
    out = harness.run(c, 5, 0.3, False, "cpu",
                      program=c.family.control(c.config, "cpu"))
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


@pytest.mark.parametrize("cell", ["omniglot-2p-4m", "omniglot-full-1m",
                                  "omniglot-routed-4m"])
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


@pytest.mark.parametrize("cell", ["cub-2p-256k", "omniglot-full-1m",
                                  "omniglot-routed-4m"])
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


def _misroute(monkeypatch, position: int) -> list:
    """The router's shard at `position` of each query's visited ids, in
    the order of their scores (0 the nearest, -1 the last), swapped for
    the next shard the query does not visit; returns the calls' count."""
    from repro_torch.engine import router
    real, calls = router.top_shards, [0]

    def top_shards(scores, nprobe):
        ids = real(scores, nprobe)
        calls[0] += 1
        ranked = scores.gather(1, ids).argsort(dim=1, stable=True)
        ids = ids.gather(1, ranked)
        bad = ids[:, position:][:, :1]
        for _ in range(scores.shape[1]):
            bad = torch.where((bad == ids).any(1, keepdim=True),
                              (bad + 1) % scores.shape[1], bad)
        ids[:, position % nprobe] = bad[:, 0]
        return ids.sort(1).values
    monkeypatch.setattr(router, "top_shards", top_shards)
    return calls


def test_a_route_to_the_wrong_last_shard_is_caught(monkeypatch):
    """Each query's last visited shard swapped for the next one it does
    not visit. k covers every visited row, so every row of the wrong
    shard reaches the shortlist."""
    calls = _misroute(monkeypatch, -1)
    c = harness.dry(harness.load_cell("omniglot-routed-4m"))
    per = c.config["capacity"] // c.config["n_shards"]
    c = dataclasses.replace(c, traffic=dict(
        c.traffic, k=c.traffic["nprobe"] * per))
    out = harness.run(c, 7, 0.3, False, "cpu")
    assert calls[0] > 0 and not out["correct"]
    assert out["compared"]["rows_wrong"]["value"] > 0


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_a_route_without_the_nearest_shard_is_caught_at_the_cells_k(
        monkeypatch, seed):
    """At the cell's own k, each query's nearest shard swapped for one it
    does not visit: on a store sorted by alphabet that shard holds the
    query's class, so its rows leave the shortlist."""
    calls = _misroute(monkeypatch, 0)
    out = harness.run(harness.dry(harness.load_cell("omniglot-routed-4m")),
                      seed, 0.3, False, "cpu")
    assert calls[0] > 0 and not out["correct"]
    assert out["compared"]["rows_wrong"]["value"] > 0
