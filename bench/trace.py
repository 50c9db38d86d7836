"""A traced window as plain records, and the arithmetic the per-layer
readers share.

`Timeline.from_profiler` turns torch.profiler's events into three lists
of `Event`s, every time in nanoseconds on the profiler's clock:

  host     what the host ran: the benchmark's spans (`bench.search`
           around each search call and its prediction, `bench.write`
           around each write), the program's own ranges (`shortlist_fused`)
           and torch's operators
  runtime  CUDA runtime calls (launches, copies, synchronisations),
           with the correlation id of the device work they started
  device   what the card ran: kernels, copies and memsets, each with the
           correlation id of the runtime call that started it

Spans are the benchmark's: the program is traced only through its own
ranges and the device work its calls start.
"""

from __future__ import annotations

import bisect
import dataclasses
import re

SEARCH_SPAN = "bench.search"
WRITE_SPAN = "bench.write"
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
_RUNTIME = re.compile(r"cu(da)?[A-Z]")


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    start: int
    end: int
    corr: int = 0


@dataclasses.dataclass
class Timeline:
    host: list[Event]
    runtime: list[Event]
    device: list[Event]

    @classmethod
    def from_profiler(cls, prof) -> "Timeline":
        host, runtime, device = [], [], []
        for e in prof.profiler.kineto_results.events():
            ev = Event(e.name(), e.start_ns(), e.end_ns(), e.correlation_id())
            if e.device_type().name == "CUDA":
                if not e.is_user_annotation():
                    device.append(ev)
            elif _RUNTIME.match(e.name()):
                runtime.append(ev)
            else:
                host.append(ev)
        return cls(host, runtime, device)

    def spans(self, name: str) -> list[Event]:
        return sorted((e for e in self.host if e.name == name),
                      key=lambda e: e.start)

    def runtime_in(self, spans: list[Event], names=None) -> list[Event]:
        """Runtime calls that start inside one of `spans` (sorted by start,
        not overlapping), named `names` if given."""
        starts = [s.start for s in spans]
        out = []
        for r in self.runtime:
            if names is not None and r.name not in names:
                continue
            i = bisect.bisect_right(starts, r.start) - 1
            if i >= 0 and r.start <= spans[i].end:
                out.append(r)
        return out

    def device_of(self, spans: list[Event]) -> list[Event]:
        """Device work started by a runtime call inside one of `spans`."""
        corr = {r.corr for r in self.runtime_in(spans)}
        return [d for d in self.device if d.corr in corr]

    def window(self) -> tuple[int, int]:
        """From the first benchmark span's start to the end of the last
        device work or span."""
        spans = self.spans(SEARCH_SPAN) + self.spans(WRITE_SPAN)
        if not spans:
            return 0, 0
        start = min(s.start for s in spans)
        end = max([s.end for s in spans] + [d.end for d in self.device])
        return start, end

    def busy_ns(self) -> int:
        """Nanoseconds of the window in which the device ran anything."""
        start, end = self.window()
        return sum(b - a for a, b in union(self.device, start, end))


def union(events: list[Event], start: int, end: int) -> list[tuple[int, int]]:
    """The device's busy intervals: the union of the events' intervals,
    cut to [start, end]."""
    out: list[list[int]] = []
    for e in sorted(events, key=lambda e: e.start):
        a, b = max(e.start, start), min(e.end, end)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def gaps(tl: Timeline) -> list[tuple[int, int]]:
    """The idle intervals of the window."""
    start, end = tl.window()
    out, t = [], start
    for a, b in union(tl.device, start, end):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if end > t:
        out.append((t, end))
    return out


def _covering(events: list[Event], starts: list[int], t: int,
              reach: int = 5000) -> Event | None:
    """The latest-starting of `events` (sorted by start, their `starts`)
    that is under way at t: with nested events, the innermost."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - reach), -1):
        if events[j].end >= t:
            return events[j]
    return None


def breakdown(tl: Timeline, top: int = 10) -> dict:
    """The device work that took most time, by name, and the idle time by
    what the host was doing: the benchmark span around it and the
    innermost host operation or runtime call under way, in seconds."""
    ops: dict[str, float] = {}
    for d in tl.device:
        ops[d.name[:80]] = ops.get(d.name[:80], 0.0) + (d.end - d.start) / 1e9
    spans = sorted(tl.spans(SEARCH_SPAN) + tl.spans(WRITE_SPAN),
                   key=lambda e: e.start)
    inner = sorted((e for e in tl.host + tl.runtime
                    if e.name not in (SEARCH_SPAN, WRITE_SPAN)),
                   key=lambda e: e.start)
    span_starts = [e.start for e in spans]
    inner_starts = [e.start for e in inner]
    idle: dict[str, float] = {}
    for a, b in gaps(tl):
        mid = (a + b) // 2
        outer = _covering(spans, span_starts, mid)
        what = _covering(inner, inner_starts, mid)
        key = (f"{outer.name if outer else 'between calls'} / "
               f"{what.name[:60] if what else 'python'}")
        idle[key] = idle.get(key, 0.0) + (b - a) / 1e9
    return {"device_ops": sorted(([k, v] for k, v in ops.items()),
                                 key=lambda r: -r[1])[:top],
            "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                                key=lambda r: -r[1])[:top]}

