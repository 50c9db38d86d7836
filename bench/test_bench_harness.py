"""The harness's arithmetic and its files, on the CPU: the end-to-end
readers take every batch of the window, the trace readers' idle share and
attribution on a synthetic timeline, and every cell, configuration, mix
and metric that BENCHMARK.json names is a file that loads."""

import json
import re
import statistics
from pathlib import Path

import pytest
import torch

from bench import harness
from bench.trace import (LAUNCH_CALLS, SEARCH_SPAN, WRITE_SPAN, Event,
                         Timeline, breakdown)

ROOT = Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _run(lat, done, seconds, timeline=None, cell="omniglot-2p-4m"):
    c = harness.load_cell(cell)
    return harness.Run(c, seconds, 1.0, lat, done,
                       [c.traffic["batch"]] * len(lat), timeline)


def test_p95_takes_every_batch_so_one_stall_moves_it():
    lat = [0.002] * 200
    lat[100:112] = [0.040] * 12             # one stall holds 12 batches
    run = _run(lat, [i * 0.002 for i in range(200)], 1.0)
    p95 = harness.reader("p95_ms")(run)
    assert p95 == pytest.approx(40.0)
    chunks = [harness.percentile(lat[i:i + 20], 95)
              for i in range(0, 200, 20)]
    assert statistics.median(chunks) * 1e3 == pytest.approx(2.0)


def test_qps_counts_only_labels_home_inside_the_window():
    run = _run([0.01] * 10, [0.1 * i for i in range(1, 11)], 0.75)
    # 7 batches are home by 0.75 s
    b = run.cell.traffic["batch"]
    assert harness.reader("qps")(run) == pytest.approx(7 * b / 0.75)


def _timeline():
    spans = [Event(SEARCH_SPAN, 0, 400), Event(WRITE_SPAN, 450, 500),
             Event(SEARCH_SPAN, 500, 900)]
    host = spans + [Event("shortlist_fused", 10, 60),
                    Event("shortlist_fused", 510, 560)]
    runtime = [Event("cudaLaunchKernel", 20, 25, 1),
               Event("cudaLaunchKernel", 30, 35, 2),
               Event("cudaStreamSynchronize", 70, 300, 3),
               Event("cudaLaunchKernel", 460, 465, 4),
               Event("cudaLaunchKernel", 520, 525, 5),
               Event("cudaLaunchKernel", 600, 605, 6)]
    device = [Event("shortlist_select", 100, 300, 1),
              Event("shortlist_merge", 250, 400, 2),
              Event("index_put", 470, 490, 4),
              Event("shortlist_select", 600, 700, 5),
              Event("search_gathered<24>", 700, 750, 6)]
    return Timeline(host, runtime, device)


def test_idle_share_of_a_synthetic_timeline():
    tl = _timeline()
    assert tl.window() == (0, 900)
    # busy: [100, 400] + [470, 490] + [600, 750] = 470 of 900
    assert tl.busy_ns() == 470
    run = _run([], [], 1.0, tl)
    assert harness.reader("idle_pct")(run) == pytest.approx(
        100 * (1 - 470 / 900))


def test_trace_readers_attribute_by_correlation():
    run = _run([], [], 1.0, _timeline(), cell="cub-ingest-256k")
    assert harness.reader("launches_per_batch")(run) == 2.0
    assert harness.reader("syncs_per_batch")(run) == 0.5
    assert harness.reader("write_device_ms")(run) == pytest.approx(20e-6)
    assert harness.reader("search_host_ms")(run) == pytest.approx(400e-6)
    # shortlist_fused launched corr 1, 2 and 5: 200 + 150 + 100 ns, 2 calls
    want = run.work["shortlist"]["bound_ms"] / (450e-6 / 2) * 100
    assert harness.reader("shortlist_roofline")(run) == pytest.approx(want)
    want = run.work["rescore"]["bound_ms"] / 50e-6 * 100
    assert harness.reader("rescore_roofline")(run) == pytest.approx(want)
    assert harness.reader("dense_roofline")(run) is None
    out = breakdown(run.timeline)
    assert out["device_ops"][0] == ["shortlist_select", 300e-9]
    assert sum(v for _, v in out["idle_gaps"]) == pytest.approx(430e-9)
    assert len(out["device_ops"]) <= 10 and len(out["idle_gaps"]) <= 10


def test_readers_of_an_untraced_run_read_nothing():
    run = _run([0.01], [0.01], 1.0)
    for m in BENCH["per_layer"]:
        assert harness.reader(m["name"])(run) is None, m["name"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load_and_match_benchmark_json(cell):
    c = harness.load_cell(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert {k: c.spec[k] for k in ("config", "traffic", "chips", "why")} \
        == {k: entry[k] for k in ("config", "traffic", "chips", "why")}
    assert c.config["name"] == entry["config"]
    assert set(c.spec["limits"]) == set(c.family.NUMBERS)
    for m in c.end_to_end + c.per_layer:
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer


def test_benchmark_json_keeps_to_its_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench"] and BENCH["command"][1] == \
        "bench/run.py"
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and NAME.match(c["name"])
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] == 1
        assert w["config"] in {c["name"] for c in BENCH["configs"]}
    # a full check of 24 cells fits its 43,200 seconds
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("mix", sorted(p.stem for p in
                                       (ROOT / "bench" / "traffic").glob(
                                           "*.json")))
def test_traffic_mixes_are_data(mix):
    t = json.loads((ROOT / "bench" / "traffic" / f"{mix}.json").read_text())
    assert (ROOT / "bench" / "loops" / f"{t['loop']}.py").is_file()
    assert t["mode"] in ("two_phase", "full")
    assert t["class_skew"] >= 0
    assert t["batch"] > 0 and t["in_flight"] >= 1
    assert t["check_batches"] >= 1
    assert (t.get("write_every", 0) > 0) == (t.get("write_classes", 0) > 0)


def test_launch_calls_name_the_runtime_launches():
    assert "cudaLaunchKernel" in LAUNCH_CALLS


@pytest.mark.parametrize("skew", [0, 1.2])
def test_query_classes_follow_the_mix_skew(skew):
    cell = harness.load_cell("omniglot-2p-4m")
    Inputs = cell.family.Inputs
    config = dict(cell.config, dim=16, classes=1000, capacity=10_000)
    traffic = {"write_classes": 0, "class_skew": skew}
    inputs = Inputs(config, traffic, 3, "cpu")
    cls = torch.cdist(inputs.queries(4000), inputs.centres[:1000]).argmin(1)
    newest = float((cls >= 990).float().mean())
    # uniform: 1% of the queries ask the newest ten classes; Zipf 1.2 over
    # 1,000 ranks: about two thirds
    assert (newest < 0.03) if skew == 0 else (newest > 0.5)
    again = Inputs(config, traffic, 3, "cpu")
    assert torch.equal(again.queries(4000), Inputs(
        config, traffic, 3, "cpu").queries(4000))


def test_control_runs_on_a_card_or_says_it_is_dry(monkeypatch, capsys):
    from bench import control
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert control.main(["--workload", "cub-2p-256k", "--seeds", "1"]) != 0
    assert capsys.readouterr().out == ""
    torch.set_num_threads(2)
    assert control.main(["--workload", "cub-2p-256k", "--seeds", "1",
                         "--seconds", "0.2", "--dry"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (line["device"], line["rows"], line["batch"]) == ("cpu", 1024, 4)
    assert not line["correct"]


def test_alphabets_keep_the_centres_spread_and_group_them():
    """A configuration with alphabets draws class centres of the same
    spread, nearer within an alphabet (a run of consecutive classes) than
    across; one without them draws exactly as before."""
    cell = harness.load_cell("omniglot-routed-4m")
    Inputs = cell.family.Inputs
    config = dict(cell.config, dim=48, classes=640, capacity=6400)
    c = Inputs(config, {"class_skew": 0}, 3, "cpu").centres[:640]
    assert abs(float(c.var()) - 4.0) < 0.4
    by = c.reshape(64, 10, 48)
    within = float(torch.cdist(by, by).pow(2).mean()) * 10 / 9
    across = float(torch.cdist(c, c).pow(2).mean())
    # half the variance is the alphabet's: 2 (1 - share) 4 48 = 192 apart
    # within an alphabet, 2 4 48 = 384 across
    assert 160 < within < 224 and 340 < across < 430
    plain = dict(config, embedding={"centre_scale": 2.0, "spread": 0.3})
    gen = torch.Generator().manual_seed(3)
    assert torch.equal(Inputs(plain, {"class_skew": 0}, 3, "cpu").centres[
        :640], torch.randn(640, 48, generator=gen) * 2.0)


def test_recall_of_a_route_over_every_shard_is_whole(capsys):
    from bench import recall
    torch.set_num_threads(2)
    assert recall.main(["--workload", "omniglot-routed-4m", "--seeds", "5",
                        "--nprobe", "2", "64", "--batches", "2",
                        "--dry"]) == 0
    lines = [json.loads(x) for x in
             capsys.readouterr().out.strip().splitlines()]
    assert [x["nprobe"] for x in lines] == [2, 64]
    assert lines[1]["recall_at_k"] == lines[1]["top1_label"] == 1.0
    assert 0 < lines[0]["recall_at_k"] <= 1
