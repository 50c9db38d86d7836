"""One run of one cell: set-up, the measured window, the check.

A cell (bench/workloads/<cell>.json) names a configuration
(bench/configs/<config>.json) and a traffic mix (bench/traffic/<mix>.json);
the configuration names the program family it drives (`program`: the
module bench/families/<program>.py), the mix the loop that serves it
(bench/loops/<loop>.py), and BENCHMARK.json the metrics each cell
reports, each read by bench/metrics/<metric>.py. Nothing here names a
family, a cell, a configuration, a mix, a loop or a metric.

A family module supplies:

  setup(config, traffic, seed, device, program=None) -> state
      the inputs drawn from the seed and the program built and loaded
      (`program`: another program in its place, such as the control)
  issue(state, no, span) -> (count, home, kept, note)
      batch `no` enqueued, its work inside `span(bench.trace.SEARCH_SPAN)`
      (and WRITE_SPAN): the queries it counts, the tensor to copy home,
      the tensors the check keeps by name, and what else the check needs
      of the batch
  deliver(home) -> what the check keeps of the tensor copied home
  replay(state, seed, device) -> the run's inputs drawn again
  check(state, replayed, sampled, device) -> {number: value}, each number
      of NUMBERS, against the family's plain reference (bench/reference/)
  NUMBERS: the names of the numbers the check compares
  control(config, device) -> the program the check's control runs
  dry(config, traffic) -> (config, traffic) at a size the CPU runs
  size(config, traffic) -> {name: value}, the sizes a control line names
  work(config, traffic) -> {kernel: bound} (bench/work.py) a batch drives

The harness keeps the rest: the loop drives `Server.issue` (the family's
batch, its home tensor copied without blocking into pinned host memory
behind an event of its own, the sampled batches' tensors copied into
slots made before the window) and `Server.deliver` (the home tensor on
the host), and times each batch from the start of its enqueue to the
return of its event wait; the window, the profiler, the set-up time, the
memory peak, the metrics and the result line. A mix gives the loop's
keys: `loop`, `in_flight`, `warmup_batches`, `trace_seconds` (the traced
window) and `check_batches` (the batches of the window the check
compares, drawn from the seed).
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
from types import ModuleType

import torch

from bench import trace as trace_lib

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
    family: ModuleType
    bench: Path = BENCH


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of the benchmark at `root` (its BENCHMARK.json and
    bench/)."""
    bench_dir = Path(root) / "bench"
    spec = _json(bench_dir / "workloads" / f"{name}.json")
    bench = _json(Path(root) / "BENCHMARK.json")
    config = _json(bench_dir / "configs" / f"{spec['config']}.json")

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]
    return Cell(name, spec, config,
                _json(bench_dir / "traffic" / f"{spec['traffic']}.json"),
                mine(bench["end_to_end"]), mine(bench["per_layer"]),
                _module("families", config["program"], bench_dir),
                bench_dir)


def _module(kind: str, name: str, bench: Path = BENCH) -> ModuleType:
    """bench/<kind>/<name>.py, loaded by its path (and entered in
    sys.modules under bench_<kind>_<name>, which its dataclasses need)."""
    path = bench / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, bench: Path = BENCH):
    """`read(run)` of bench/metrics/<metric>.py."""
    return _module("metrics", metric, bench).read


def serve(loop: str, bench: Path = BENCH):
    """`serve(server, seconds, batches, sample)` of bench/loops/<loop>.py:
    -> (latencies, completion times since the start)."""
    return _module("loops", loop, bench).serve


@dataclasses.dataclass
class Run:
    """What a reader reads: the window's batches (their latencies,
    completion times and the queries each counts, in the order issued)
    and, traced, its trace."""
    cell: Cell
    seconds: float
    setup_s: float
    latencies_s: list[float]
    done_s: list[float]
    counts: list[int]
    timeline: trace_lib.Timeline | None = None

    @property
    def work(self) -> dict[str, dict]:
        return self.cell.family.work(self.cell.config, self.cell.traffic)


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
    """The loop's view of the program: the family's state, and what the
    check needs of the window (the sampled batches)."""

    def __init__(self, cell: Cell, state, seed: int, device: torch.device,
                 spans: bool):
        self.family, self.state, self.device = cell.family, state, device
        self.traffic, self.bench = cell.traffic, cell.bench
        self.counts: list[int] = []
        # {batch no: (slot, delivered, note)}; a slot holds a sampled
        # batch's kept tensors, copied on the card into buffers made
        # before the window, so the window keeps nothing the program
        # allocated
        self.sampled: dict[int, tuple] = {}
        self.reservoir = _Reservoir(self.traffic["check_batches"], seed)
        self.slots: list[dict[str, torch.Tensor]] = []
        self.span = (torch.profiler.record_function if spans
                     else lambda name: contextlib.nullcontext())
        self.host: list[torch.Tensor] = []

    def issue(self, no: int, sample: bool) -> tuple:
        """Enqueue batch `no` -> (its event, its pinned home tensor,
        whether the check keeps it)."""
        depth = self.traffic["in_flight"]
        count, home, kept, note = self.family.issue(self.state, no,
                                                    self.span)
        self.counts.append(count)
        if len(self.host) < depth:
            self.host.append(torch.empty(
                home.shape, dtype=home.dtype,
                pin_memory=self.device.type == "cuda"))
        buf = self.host[no % depth]
        buf.copy_(home, non_blocking=True)
        ev = _mark(self.device)
        if not self.slots:
            self.slots = [{k: torch.empty(v.shape, dtype=v.dtype,
                                          device=v.device)
                           for k, v in kept.items()}
                          for _ in range(self.traffic["check_batches"])]
        keep = False
        if sample:
            slot, out = self.reservoir.offer(no)
            if out is not None:
                del self.sampled[out]
            if slot is not None:
                keep = True
                for k, v in kept.items():
                    self.slots[slot][k].copy_(v)
                self.sampled[no] = (slot, None, note)
        return ev, buf, keep

    def deliver(self, no: int, buf: torch.Tensor, keep: bool) -> None:
        """Batch `no`'s home tensor is on the host (its event has
        returned)."""
        if keep and no in self.sampled:
            slot, _, note = self.sampled[no]
            self.sampled[no] = (slot, self.family.deliver(buf), note)

    def loop(self, seconds: float | None = None, batches: int | None = None,
             sample: bool = False) -> tuple[list[float], list[float],
                                            list[int]]:
        """Serve by the mix's loop until `seconds` have passed or `batches`
        were issued -> (latencies, completion times since the start, the
        queries each batch counts)."""
        first = len(self.counts)
        lat, done = serve(self.traffic["loop"], self.bench)(
            self, seconds, batches, sample)
        return lat, done, self.counts[first:]


def memory_peak(device: torch.device) -> int:
    if device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def run(cell: Cell, seed: int, seconds: float, traced: bool, device,
        program=None, t_start: float | None = None) -> dict:
    """One run -> the result line's fields (correct, attempted, failed,
    metrics, device, breakdown, compared). `program`: another program in
    the family's place (the control)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    family, traffic = cell.family, cell.traffic
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state = family.setup(cell.config, traffic, seed, device, program)
    server = Server(cell, state, seed, device, spans=traced)
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
            lat, done, counts = server.loop(window, sample=True)
        timeline = trace_lib.Timeline.from_profiler(prof)
    else:
        lat, done, counts = server.loop(window, sample=True)
    peak = memory_peak(device)
    rec = Run(cell, window, setup_s, lat, done, counts, timeline)
    sampled = {no: (server.slots[slot], delivered, note)
               for no, (slot, delivered, note) in server.sampled.items()}
    del server
    if device.type == "cuda":
        torch.cuda.empty_cache()
    replayed = family.replay(state, seed, device)
    _log(f"set-up {setup_s:.3f} s; window {window} s: {len(lat)} batches, "
         f"{len(sampled)} checked; memory peak {peak} B")
    t_check = time.perf_counter()
    compared = family.check(state, replayed, sampled, device)
    _log(f"check {time.perf_counter() - t_check:.3f} s")
    limits = cell.spec["limits"]
    correct = all(compared[k] <= limits[k] for k in family.NUMBERS)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = reader(m["name"], cell.bench)(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": sum(counts), "failed": 0,
           "metrics": metrics, "device": dev}
    if timeline is not None:
        start, end = timeline.window()
        dev["busy_s"] = timeline.busy_ns() / 1e9
        dev["window_s"] = (end - start) / 1e9
        out["breakdown"] = trace_lib.breakdown(timeline)
    out["compared"] = {k: {"value": compared[k], "limit": limits[k]}
                       for k in family.NUMBERS}
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


def dry(cell: Cell) -> Cell:
    """The cell at a size the CPU runs in seconds: the family's dry size,
    2 warm-up batches and 2 checked ones."""
    config, traffic = cell.family.dry(cell.config, cell.traffic)
    traffic = dict(traffic, warmup_batches=2, check_batches=2)
    return dataclasses.replace(cell, config=config, traffic=traffic)
