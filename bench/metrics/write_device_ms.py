"""Device time of the work launched inside the benchmark's span around
each write (`bench.write`: MemoryStore.write's quantisation, projection,
packing, layout and leaf copies), per write, in ms."""

from bench.trace import WRITE_SPAN


def read(run):
    if run.timeline is None:
        return None
    spans = run.timeline.spans(WRITE_SPAN)
    work = run.timeline.device_of(spans)
    if not spans or not work:
        return None
    return sum(d.end - d.start for d in work) / 1e6 / len(spans)
