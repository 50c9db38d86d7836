"""One run of one cell: set-up, the measured window, the check.

A cell (bench/workloads/<cell>.json) names a configuration
(bench/configs/<config>.json) and a traffic mix (bench/traffic/<mix>.json);
the mix names the loop that serves it (bench/loops/<loop>.py), and
BENCHMARK.json names the metrics each cell reports, each read by
bench/metrics/<metric>.py. Nothing here names a cell, a configuration, a
mix, a loop or a metric.

A loop drives `Server.issue` (one batch enqueued: the write due before it,
its queries, the search, its labels copied without blocking into pinned
host memory behind an event of its own) and `Server.deliver` (the batch's
labels on the host), and times each batch from the start of its enqueue
to the return of its event wait.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import random
import sys
import time
from pathlib import Path

import torch

from bench import check
from bench import trace as trace_lib
from bench import work
from bench.data import Inputs

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "bench"
#: after settling, a profiler session has seen every launch (see run())
PROFILER_SETTLE_S = 0.05


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    spec: dict
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def load_cell(name: str, benchmark: Path = ROOT / "BENCHMARK.json") -> Cell:
    spec = _json(BENCH / "workloads" / f"{name}.json")
    bench = _json(benchmark)

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]
    return Cell(name, spec, _json(BENCH / "configs" / f"{spec['config']}.json"),
                _json(BENCH / "traffic" / f"{spec['traffic']}.json"),
                mine(bench["end_to_end"]), mine(bench["per_layer"]))


def _module(kind: str, name: str):
    """bench/<kind>/<name>.py, loaded by its path."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """`read(run)` of bench/metrics/<metric>.py."""
    return _module("metrics", metric).read


def serve(loop: str):
    """`serve(server, seconds, batches, sample)` of bench/loops/<loop>.py:
    -> (latencies, completion times since the start)."""
    return _module("loops", loop).serve


@dataclasses.dataclass
class Run:
    """What a reader reads: the window's batches and, traced, its trace."""
    cell: Cell
    seconds: float
    setup_s: float
    latencies_s: list[float]
    done_s: list[float]
    timeline: trace_lib.Timeline | None = None

    @property
    def work(self) -> dict[str, dict]:
        return work.cell_work(self.cell.config, self.cell.traffic)


class _Reservoir:
    """A uniform sample of `size` of the batch numbers offered, drawn from
    the seed, each held in one of `size` slots."""

    def __init__(self, size: int, seed: int):
        self.size, self.rng, self.seen = size, random.Random(seed), 0
        self.kept: list[int] = []

    def offer(self, no: int) -> tuple[int | None, int | None]:
        """-> (the slot that keeps `no`, or None; the batch it evicts)."""
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept.append(no)
            return len(self.kept) - 1, None
        j = self.rng.randrange(self.seen)
        if j < self.size:
            out, self.kept[j] = self.kept[j], no
            return j, out
        return None, None


class _Done:
    def synchronize(self) -> None:
        pass


def _mark(device: torch.device):
    if device.type != "cuda":
        return _Done()
    ev = torch.cuda.Event()
    ev.record()
    return ev


class Server:
    """The closed loop over the program: the store, the inputs and what the
    check needs of the window (the order of the inputs drawn, the sampled
    batches)."""

    def __init__(self, program, store, inputs: Inputs, traffic: dict,
                 seed: int, spans: bool):
        self.program, self.store, self.inputs = program, store, inputs
        self.traffic = traffic
        self.request = program.request(traffic["mode"], traffic["k"])
        # the order of the inputs drawn (("q" | "w", count)): the check
        # draws the writes again from the seed (`replay_writes`), so the
        # window keeps no tensor of its own on the device
        self.log: list[tuple[str, int]] = []
        self.n_writes = 0
        # {batch no: (slot, delivered labels, writes before it)}; a slot
        # holds a sampled batch's queries and results, copied on the card
        # into buffers made before the window, so the window keeps nothing
        # the program allocated
        self.sampled: dict[int, tuple] = {}
        self.reservoir = _Reservoir(traffic["check_batches"], seed)
        self.slots: list[dict[str, torch.Tensor]] = []
        self.span = (torch.profiler.record_function if spans
                     else lambda name: contextlib.nullcontext())
        self.host: list[torch.Tensor] = []

    def _write(self) -> None:
        n = self.traffic["write_classes"]
        x, labels = self.inputs.new_classes(n)
        self.log.append(("w", n))
        self.n_writes += 1
        with self.span(trace_lib.WRITE_SPAN):
            self.store = self.store.write(x, labels)

    def issue(self, no: int, sample: bool) -> tuple:
        """Enqueue batch `no` -> (its event, its pinned labels, whether the
        check keeps it); the write due before it first."""
        t = self.traffic
        every, depth = t["write_every"], t["in_flight"]
        dev = self.inputs.device
        if every and no % every == every - 1:
            self._write()
        q = self.inputs.queries(t["batch"])
        self.log.append(("q", t["batch"]))
        with self.span(trace_lib.SEARCH_SPAN):
            res = self.program.search(self.store, q, self.request)
            pred = res.predict()
        if len(self.host) < depth:
            self.host.append(torch.empty(
                pred.shape, dtype=pred.dtype,
                pin_memory=dev.type == "cuda"))
        buf = self.host[no % depth]
        buf.copy_(pred, non_blocking=True)
        ev = _mark(dev)
        kept = {"queries": q, "votes": res.votes, "dist": res.dist,
                "indices": res.indices, "labels": res.labels}
        if not self.slots:
            self.slots = [{k: torch.empty(v.shape, dtype=v.dtype,
                                          device=v.device)
                           for k, v in kept.items()}
                          for _ in range(t["check_batches"])]
        keep = False
        if sample:
            slot, out = self.reservoir.offer(no)
            if out is not None:
                del self.sampled[out]
            if slot is not None:
                keep = True
                for k, v in kept.items():
                    self.slots[slot][k].copy_(v)
                self.sampled[no] = (slot, None, self.n_writes)
        return ev, buf, keep

    def deliver(self, no: int, buf: torch.Tensor, keep: bool) -> None:
        """Batch `no`'s labels are on the host (its event has returned)."""
        if keep and no in self.sampled:
            slot, _, n_writes = self.sampled[no]
            self.sampled[no] = (slot, buf.numpy().copy(), n_writes)

    def loop(self, seconds: float | None = None, batches: int | None = None,
             sample: bool = False) -> tuple[list[float], list[float]]:
        """Serve by the mix's loop until `seconds` have passed or `batches`
        were issued -> (latencies, completion times since the start)."""
        return serve(self.traffic["loop"])(self, seconds, batches, sample)


def replay_writes(config: dict, traffic: dict, seed: int, device, log,
                  supports: torch.Tensor) -> list:
    """Every write of a run, drawn again from the seed in the order of
    `log`; the supports drawn again must equal the run's."""
    inputs = Inputs(config, traffic, seed, device)
    if not torch.equal(inputs.supports()[0], supports):
        raise RuntimeError("bench: the seed did not give the same inputs "
                           "twice")
    writes = []
    for kind, n in log:
        if kind == "w":
            writes.append(inputs.new_classes(n))
        else:
            inputs.queries(n)
    return writes


def memory_peak(device: torch.device) -> int:
    if device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def run(cell: Cell, seed: int, seconds: float, traced: bool, device,
        program=None, t_start: float | None = None) -> dict:
    """One run -> the result line's fields (correct, attempted, failed,
    metrics, device, breakdown, compared)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    config, traffic = cell.config, cell.traffic
    if program is None:
        from bench.program import Port
        program = Port(config, device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    inputs = Inputs(config, traffic, seed, device)
    x, labels = inputs.supports()
    t_program = time.perf_counter()
    store = program.create().calibrate(x)
    step = config["program_rows"]
    for r0 in range(0, x.shape[0], step):
        store = store.write(x[r0:r0 + step], labels[r0:r0 + step])
    _log(f"store of {x.shape[0]} supports programmed in "
         f"{time.perf_counter() - t_program:.3f} s")
    server = Server(program, store, inputs, traffic, seed, spans=traced)
    server.loop(batches=traffic["warmup_batches"])
    if traced:
        with torch.profiler.profile(activities=_activities(device)):
            pass
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    window = min(seconds, traffic["trace_seconds"]) if traced else seconds
    timeline = None
    setup_s = time.perf_counter() - t_start
    if traced:
        with torch.profiler.profile(activities=_activities(device)) as prof:
            time.sleep(PROFILER_SETTLE_S)
            lat, done = server.loop(window, sample=True)
        timeline = trace_lib.Timeline.from_profiler(prof)
    else:
        lat, done = server.loop(window, sample=True)
    peak = memory_peak(device)
    rec = Run(cell, window, setup_s, lat, done, timeline)
    issued = len(lat) * traffic["batch"]
    store, log = server.store, server.log
    sampled = {no: (server.slots[slot], delivered, n_writes)
               for no, (slot, delivered, n_writes) in server.sampled.items()}
    del server
    if device.type == "cuda":
        torch.cuda.empty_cache()
    writes = replay_writes(config, traffic, seed, device, log, x)
    _log(f"set-up {setup_s:.3f} s; window {window} s: {len(lat)} batches, "
         f"{len(writes)} writes in all, {len(sampled)} checked; memory peak "
         f"{peak} B")
    t_check = time.perf_counter()
    compared = check.compare(config, traffic, (x, labels), writes, sampled,
                             store, device)
    _log(f"check {time.perf_counter() - t_check:.3f} s")
    limits = cell.spec["limits"]
    correct = all(compared[k] <= limits[k] for k in check.NUMBERS)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": issued, "failed": 0,
           "metrics": metrics, "device": dev}
    if timeline is not None:
        start, end = timeline.window()
        dev["busy_s"] = timeline.busy_ns() / 1e9
        dev["window_s"] = (end - start) / 1e9
        out["breakdown"] = trace_lib.breakdown(timeline)
    out["compared"] = {k: {"value": compared[k], "limit": limits[k]}
                       for k in check.NUMBERS}
    return out


def _log(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def _activities(device: torch.device) -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def percentile(values: list[float], p: float) -> float:
    """The p-th percentile (0-100) of all values, interpolated between the
    closest ranks."""
    s = sorted(values)
    if not s:
        return math.nan
    pos = (len(s) - 1) * p / 100
    lo = math.floor(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


#: rows of a cell's store in a dry run (bench/run.py --dry): the fused
#: shortlist's threshold, so that a shortlist takes the main path's route;
#: `full`, which has no shortlist, at a quarter of it
DRY_ROWS = 1024


def dry(cell: Cell) -> Cell:
    """The cell at a size the CPU runs in seconds: DRY_ROWS rows (the last
    class left out, so some slots stay empty), batches of 4, k <= 8, small
    writes; the widths, encoding and physics are the configuration's."""
    t = cell.traffic
    rows = DRY_ROWS if t["mode"] != "full" else DRY_ROWS // 4
    config = dict(cell.config, capacity=rows,
                  classes=rows // cell.config["shots"] - 1,
                  program_rows=rows // 2)
    traffic = dict(t, batch=4, k=min(t["k"], 8),
                   write_classes=min(t["write_classes"], 8),
                   write_every=min(t["write_every"], 2), warmup_batches=2,
                   check_batches=2)
    return dataclasses.replace(cell, config=config, traffic=traffic)
