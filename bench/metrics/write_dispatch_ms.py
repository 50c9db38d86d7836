"""Host time a write spends on its own work, in ms: the mean duration of
the program's `store.write` range less `write_wait_ms`, so that the two
add up to the mean write."""

from bench.harness import reader

RANGE = "store.write"


def read(run):
    wait = reader("write_wait_ms")(run)
    if wait is None:
        return None
    ranges = run.timeline.spans(RANGE)
    return sum(r.end - r.start for r in ranges) / 1e6 / len(ranges) - wait
