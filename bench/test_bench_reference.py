"""The plain reference (bench/reference/mcam.py) against the port at tiny
sizes of both configurations, on the CPU: the programmed ring (with a
write that wraps), `two_phase`, `full` and `ideal` searches, and the
routed `two_phase` of a partitioned store (shard ids, rows, distances,
votes, labels), ties between shard scores included. The test imports
both; the reference imports neither the port nor JAX, which a fresh
interpreter shows."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench import harness
from bench.reference import mcam

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
FAMILY = harness.load_cell("omniglot-2p-4m").family


@pytest.fixture(autouse=True)
def _few_threads():
    """The tests' tensors are small: two threads a test process keep
    parallel test workers from oversubscribing the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _config(name: str, rows: int) -> dict:
    cfg = json.loads((ROOT / "bench" / "configs" / f"{name}.json").read_text())
    return dict(cfg, capacity=rows, classes=rows // cfg["shots"] - 1)


def _stores(cfg: dict, writes: int):
    """The port's store and the reference's, programmed alike: the
    initial supports, then `writes` writes of 3 new classes each."""
    inputs = FAMILY.Inputs(cfg, {"write_classes": 3, "class_skew": 0},
                           seed=11, device="cpu")
    x, labels = inputs.supports()
    port = FAMILY.Port(cfg, "cpu")
    store = port.create().calibrate(x).write(x, labels)
    ref = mcam.Store(cfg, "cpu")
    ref.calibrate(x)
    ref.write(x, labels)
    for _ in range(writes):
        w = inputs.new_classes(3)
        store = store.write(*w)
        ref.write(*w)
    return port, store, ref, inputs


@pytest.mark.parametrize("name, rows, writes", [
    ("omniglot-mtmc-1m", 1024, 0), ("omniglot-mtmc-1m", 1024, 40),
    ("cub-mtmc-256k", 64, 0), ("cub-mtmc-256k", 64, 6)])
def test_ring_equals_port(name, rows, writes):
    _, store, ref, _ = _stores(_config(name, rows), writes)
    assert torch.equal(store.values.to(torch.int64), ref.words)
    assert torch.equal(store.labels.to(torch.int64), ref.labels)
    assert int(store.size) == ref.size
    assert torch.equal(store.lo, ref.lo) and torch.equal(store.hi, ref.hi)
    if writes:
        assert ref.size > rows          # the ring has wrapped


@pytest.mark.parametrize("name, rows, writes", [
    ("omniglot-mtmc-1m", 1024, 0), ("omniglot-mtmc-1m", 1024, 40),
    ("cub-mtmc-256k", 256, 0), ("cub-mtmc-256k", 256, 20)])
def test_two_phase_and_ideal_equal_port(name, rows, writes):
    port, store, ref, inputs = _stores(_config(name, rows), writes)
    q = inputs.queries(6)
    res = port.search(store, q, port.request("two_phase", 8))
    want = mcam.two_phase(q, ref, 8)
    assert torch.equal(store.quantize_queries(q).to(torch.int64),
                       want["words"])
    assert torch.equal(res.indices, want["rows"])
    assert torch.equal(res.dist, want["dist"])
    assert torch.equal(res.votes, want["votes"])
    assert torch.equal(res.labels.to(torch.int64), want["labels"])
    assert torch.equal(res.predict().to(torch.int64), want["pred"])
    ideal = port.search(store, q, port.request("ideal", 8))
    dist, rows_ = mcam.shortlist(want["words"], ref, 8)
    assert torch.equal(ideal.indices, rows_) and torch.equal(ideal.dist, dist)


@pytest.mark.parametrize("name, rows", [("omniglot-mtmc-1m", 128),
                                        ("cub-mtmc-256k", 24)])
def test_full_equals_port(name, rows):
    port, store, ref, inputs = _stores(_config(name, rows), 0)
    q = inputs.queries(3)
    res = port.search(store, q, port.request("full", 1))
    pos = torch.tensor([0, 2])
    want = mcam.full(q[pos], ref, pos)
    assert torch.equal(res.votes[pos], want["votes"])
    assert torch.equal(res.dist[pos], want["dist"])
    assert torch.equal(res.predict()[pos].to(torch.int64), want["pred"])


def test_never_written_rows_rank_last():
    cfg = _config("omniglot-mtmc-1m", 1024)
    _, store, ref, inputs = _stores(cfg, 0)
    assert int((ref.labels < 0).sum()) == 1024 - cfg["classes"] * cfg["shots"]
    words = ref.query_words(inputs.queries(2))
    dist, rows = mcam.shortlist(words, ref, 1024)
    empty = ref.labels[rows] < 0
    assert bool(empty[:, -int(empty[0].sum()):].all())
    assert bool((dist[empty] >= mcam.MASK_PENALTY).all())


def test_reference_and_dry_run_load_no_jax_nor_program():
    code = (
        "import sys; sys.path[:0] = [{root!r}];"
        "import bench.reference.mcam;"
        "from bench import harness;"
        "harness.load_cell('omniglot-routed-4m').family.control({{}}, 'cpu');"
        "bad = sorted({{m.split('.')[0] for m in sys.modules}}"
        " & {{'jax', 'jaxlib', 'flax', 'repro', 'repro_torch'}});"
        "print(bad); sys.exit(1 if bad else 0)").format(root=str(ROOT))
    ref = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert ref.returncode == 0, ref.stdout + ref.stderr
    run = subprocess.run(
        [sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
         "omniglot-2p-4m", "--seed", "4000000001", "--seconds", "0.3",
         "--trace", "0", "--dry"], capture_output=True, text=True,
        timeout=300, cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert run.returncode == 0, run.stderr[-2000:]
    assert json.loads(run.stdout.strip().splitlines()[-1])["correct"]


def _routed(cfg: dict, x: torch.Tensor, labels: torch.Tensor, shards: int):
    """The port's store and the reference's, programmed with (x, labels)
    and partitioned into `shards`."""
    port = FAMILY.Port(cfg, "cpu")
    store = port.create().calibrate(x).write(x, labels).shard(
        n_shards=shards)
    ref = mcam.Store(cfg, "cpu")
    ref.calibrate(x)
    ref.write(x, labels)
    return port, store, ref


def _same_route(port, store, ref, q, shards, nprobe, k):
    from repro_torch.engine import router
    qw = store.quantize_queries(q)
    scores = router.route_scores(qw, store.sketch_sums, store.sketch_counts,
                                 port.engine.cfg.enc)
    want = mcam.two_phase(q, ref, k, route_by=(shards, nprobe))
    assert torch.equal(router.top_shards(scores, nprobe), want["shards"])
    res = port.search(store, q, port.request("two_phase", k, nprobe))
    assert torch.equal(res.indices, want["rows"])
    assert torch.equal(res.dist, want["dist"])
    assert torch.equal(res.votes, want["votes"])
    assert torch.equal(res.labels.to(torch.int64), want["labels"])
    assert torch.equal(res.predict().to(torch.int64), want["pred"])
    return scores


@pytest.mark.parametrize("nprobe, k", [(8, 8), (8, 128), (3, 48), (1, 16)])
def test_routed_two_phase_equals_port(nprobe, k):
    """The routed cell at its dry size: 64 shards of 16 rows, some empty."""
    cell = harness.dry(harness.load_cell("omniglot-routed-4m"))
    cfg, shards = cell.config, cell.config["n_shards"]
    inputs = FAMILY.Inputs(cfg, cell.traffic, seed=13, device="cpu")
    port, store, ref = _routed(cfg, *inputs.supports(), shards)
    _same_route(port, store, ref, inputs.queries(12), shards, nprobe, k)


@pytest.mark.parametrize("nprobe", [6, 8])
def test_routed_ties_go_to_the_lower_shard(nprobe):
    """Every shard of 16 rows has three copies (the same words and label
    buckets), so every score is tied four ways and the route takes the
    lower ids of the group that nprobe cuts; the rows of the copies tie by
    distance and rank by global row. The centres are drawn without
    alphabets, so that shards of different supports tie too and a group
    of copies is cut at nprobe 6 and 8."""
    cell = harness.dry(harness.load_cell("omniglot-routed-4m"))
    cfg, shards = cell.config, cell.config["n_shards"]
    cfg = dict(cfg, embedding={"centre_scale": 2.0, "spread": 0.3})
    inputs = FAMILY.Inputs(cfg, cell.traffic, seed=17, device="cpu")
    x, _ = inputs.supports()
    x = x[:256].repeat(4, 1)
    labels = torch.arange(1024, dtype=torch.int32)
    port, store, ref = _routed(cfg, x, labels, shards)
    q = inputs.queries(8)
    scores = _same_route(port, store, ref, q, shards, nprobe, 32)
    ids = mcam.two_phase(q, ref, 32, route_by=(shards, nprobe))["shards"]
    assert torch.equal(scores[:, :16].repeat(1, 4), scores)
    cut = scores.gather(1, ids).amax(1, keepdim=True)
    # a tie at the cut: a shard scored as the last visited one is left out
    assert bool(((scores == cut).sum(1) > (scores.gather(1, ids) == cut
                                             ).sum(1)).any())
