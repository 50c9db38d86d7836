"""Host time a search call spends on its own work, in ms: the mean
duration of the program's `engine.search` range less `search_wait_ms`,
so that the two add up to the mean call."""

from bench.harness import reader

RANGE = "engine.search"


def read(run):
    wait = reader("search_wait_ms")(run)
    if wait is None:
        return None
    ranges = run.timeline.spans(RANGE)
    return sum(r.end - r.start for r in ranges) / 1e6 / len(ranges) - wait
