"""Host time a search call spends waiting for the card, in ms: the
synchronising runtime calls (`bench.trace.SYNC_CALLS`) that start inside
the program's `engine.search` range, summed over the window, per call."""

from bench.trace import SYNC_CALLS

RANGE = "engine.search"


def read(run):
    if run.timeline is None:
        return None
    ranges = run.timeline.spans(RANGE)
    if not ranges:
        return None
    waits = run.timeline.runtime_in(ranges, SYNC_CALLS)
    return sum(w.end - w.start for w in waits) / 1e6 / len(ranges)
