"""The readers of the program's own ranges, on the CPU: a hand-built
timeline of nested ranges, synchronising runtime calls and device work
tied to its launches by correlation id gives each reader's number; a
timeline without the ranges (a program that opens none) reads nothing;
and a dry traced run of the ingest cell prints the host metrics."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from bench import harness
from bench.trace import SEARCH_SPAN, WRITE_SPAN, Event, Timeline

ROOT = Path(__file__).resolve().parent.parent
NEW = ("search_wait_ms", "search_dispatch_ms", "rescore_device_ms",
       "write_copy_ms", "write_wait_ms", "write_dispatch_ms")
HOST = ("search_wait_ms", "search_dispatch_ms", "write_wait_ms",
        "write_dispatch_ms")


def _timeline():
    """Two search calls and a write between them, in ns."""
    host = [
        Event(SEARCH_SPAN, 0, 1000),
        Event("engine.search", 10, 900),
        Event("engine.quantize", 20, 50),
        Event("shortlist_fused", 60, 200),
        Event("engine.grids", 210, 500),
        Event("kernels.rescore", 510, 600),
        Event("engine.labels", 610, 650),
        Event("engine.predict", 910, 990),
        Event(WRITE_SPAN, 1100, 1600),
        Event("store.write", 1110, 1590),
        Event("store.quantize", 1120, 1140),
        Event("store.cursor", 1150, 1300),
        Event("store.commit", 1350, 1450),
        Event("store.sketch", 1460, 1500),
        Event(SEARCH_SPAN, 1700, 2300),
        Event("engine.search", 1710, 2200),
        Event("engine.grids", 1780, 2050),
        Event("kernels.rescore", 2100, 2150),
    ]
    runtime = [
        Event("cudaLaunchKernel", 70, 75, 1),
        Event("cudaLaunchKernel", 80, 85, 2),
        Event("cudaStreamSynchronize", 250, 450, 3),
        Event("cudaMemcpyAsync", 240, 245, 13),     # no wait of its own
        Event("cudaLaunchKernel", 520, 525, 4),
        Event("cudaLaunchKernel", 530, 535, 5),
        Event("cudaStreamSynchronize", 920, 980, 14),   # in predict
        Event("cudaStreamSynchronize", 1160, 1290, 6),
        Event("cudaLaunchKernel", 1360, 1365, 7),
        Event("cudaLaunchKernel", 1370, 1375, 8),
        Event("cudaLaunchKernel", 1470, 1475, 9),
        Event("cudaStreamSynchronize", 1800, 1900, 10),
        Event("cudaStreamSynchronize", 1950, 2000, 11),
        Event("cudaLaunchKernel", 2110, 2115, 12),
    ]
    device = [
        Event("shortlist_select", 90, 400, 1),
        Event("shortlist_merge", 400, 440, 2),
        Event("elementwise_kernel", 700, 800, 4),
        Event("search_gathered<24>", 800, 820, 5),
        Event("Memcpy DtoD", 1400, 1500, 7),
        Event("Memcpy DtoD", 1500, 1560, 8),
        Event("reduce_kernel", 1560, 1570, 9),
        Event("search_gathered<24>", 2250, 2300, 12),
    ]
    return Timeline(host, runtime, device)


def _read(metric, timeline, cell="cub-ingest-256k"):
    run = harness.Run(harness.load_cell(cell), 1.0, 1.0, [], [], [],
                      timeline)
    return harness.reader(metric)(run)


def test_search_wait_counts_the_syncs_inside_the_search_range():
    # 200 + 100 + 50 ns of synchronisation over 2 calls; the copy that
    # does not wait and the sync in predict are not the search's
    assert _read("search_wait_ms", _timeline()) == pytest.approx(175e-6)


def test_search_wait_and_dispatch_add_up_to_the_mean_call():
    tl = _timeline()
    wait = _read("search_wait_ms", tl)
    dispatch = _read("search_dispatch_ms", tl)
    assert dispatch == pytest.approx((890 + 490 - 350) / 2 / 1e6)
    assert wait + dispatch == pytest.approx((890 + 490) / 2 / 1e6)


def test_rescore_device_time_is_the_work_launched_in_its_range():
    # corr 4 and 5 (100 + 20 ns) in the first range, 12 (50) in the second
    assert _read("rescore_device_ms", _timeline()) == pytest.approx(85e-6)


def test_write_readers_isolate_the_commit_and_the_wait():
    tl = _timeline()
    # the commit launched corr 7 and 8; the sketch's corr 9 is not a copy
    assert _read("write_copy_ms", tl) == pytest.approx(160e-6)
    assert _read("write_wait_ms", tl) == pytest.approx(130e-6)
    assert _read("write_dispatch_ms", tl) == pytest.approx(350e-6)
    assert _read("write_wait_ms", tl) + _read("write_dispatch_ms", tl) == \
        pytest.approx(480e-6)


@pytest.mark.parametrize("metric", NEW)
def test_readers_without_the_programs_ranges_read_nothing(metric):
    """A program that opens none of the ranges (the benchmark's spans
    alone) gives no number, and raises nothing."""
    tl = _timeline()
    bench_only = Timeline([e for e in tl.host
                           if e.name in (SEARCH_SPAN, WRITE_SPAN)],
                          tl.runtime, tl.device)
    assert _read(metric, bench_only) is None
    assert _read(metric, None) is None


def test_device_readers_without_device_work_read_nothing():
    tl = _timeline()
    host_only = Timeline(tl.host, tl.runtime, [])
    assert _read("rescore_device_ms", host_only) is None
    assert _read("write_copy_ms", host_only) is None
    assert _read("search_wait_ms", host_only) == pytest.approx(175e-6)


@pytest.mark.parametrize("metric", NEW)
def test_new_metrics_are_declared_for_their_cells(metric):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(m for m in bench["per_layer"] if m["name"] == metric)
    assert entry["unit"] == "ms" and entry["better"] == "lower"
    assert entry["source"] == ("host_clock" if metric in HOST
                               else "device_trace")
    for cell in entry["workloads"]:
        assert metric in {m["name"] for m in
                          harness.load_cell(cell).per_layer}


def test_dry_traced_ingest_run_prints_the_host_metrics():
    """On the CPU the program's ranges are there and no runtime call is:
    the host metrics read (the wait 0), the device ones are left out."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "cub-ingest-256k",
         "--seed", str(2**33 + 7), "--seconds", "0.5", "--dry", "--trace",
         "1"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    metrics = {k: v["value"] for k, v in line["metrics"].items()}
    assert line["correct"]
    for name in HOST:
        assert isinstance(metrics[name], float), name
    assert metrics["search_wait_ms"] == 0 and metrics["write_wait_ms"] == 0
    assert metrics["search_dispatch_ms"] > 0
    assert metrics["write_dispatch_ms"] > 0
    assert "rescore_device_ms" not in metrics
    assert "write_copy_ms" not in metrics
