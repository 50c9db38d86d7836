"""Kernel launches (CUDA runtime launch calls) inside the `bench.search`
spans, per batch."""

from bench.trace import LAUNCH_CALLS, SEARCH_SPAN


def read(run):
    if run.timeline is None:
        return None
    spans = run.timeline.spans(SEARCH_SPAN)
    if not spans:
        return None
    return len(run.timeline.runtime_in(spans, LAUNCH_CALLS)) / len(spans)
