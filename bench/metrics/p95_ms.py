"""The 95th percentile of the latencies of every batch of the window, from
the start of its enqueue to the return of its event wait, in ms."""

from bench.harness import percentile


def read(run):
    if not run.latencies_s:
        return None
    return percentile(run.latencies_s, 95) * 1e3
