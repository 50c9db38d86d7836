"""Calls that make the host wait for the card (stream, device and event
synchronisations, blocking copies) inside the `bench.search` spans, per
batch."""

from bench.trace import SEARCH_SPAN, SYNC_CALLS


def read(run):
    if run.timeline is None:
        return None
    spans = run.timeline.spans(SEARCH_SPAN)
    if not spans:
        return None
    return len(run.timeline.runtime_in(spans, SYNC_CALLS)) / len(spans)
