"""Median host time of the benchmark's span around each search call and
its prediction (`bench.search`), in ms: the engine's query quantisation
and dispatch, and any wait for the card inside the call."""

import statistics

from bench.trace import SEARCH_SPAN


def read(run):
    if run.timeline is None:
        return None
    spans = run.timeline.spans(SEARCH_SPAN)
    if not spans:
        return None
    return statistics.median((s.end - s.start) / 1e6 for s in spans)
