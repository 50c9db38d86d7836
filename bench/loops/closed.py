"""The closed loop: one serving process, one stream, `in_flight` batches
queued. Batch i+1 is enqueued before the host waits on batch i's event, so
the card is handed the next batch while the host collects the last. A
batch's latency runs from the start of its enqueue (before the write that
precedes it, in a mix that writes) to the return of its event wait."""

from __future__ import annotations

import collections
import time


def serve(server, seconds: float | None = None, batches: int | None = None,
          sample: bool = False) -> tuple[list[float], list[float]]:
    """Serve until `seconds` have passed or `batches` were issued ->
    (latencies, completion times since the start)."""
    depth = server.traffic["in_flight"]
    pending: collections.deque = collections.deque()
    lat, done = [], []
    t0 = time.perf_counter()
    no = 0

    def finish():
        i, start, ev, buf, keep = pending.popleft()
        ev.synchronize()
        end = time.perf_counter()
        lat.append(end - start)
        done.append(end - t0)
        server.deliver(i, buf, keep)

    while (no < batches if batches is not None
           else time.perf_counter() - t0 < seconds):
        start = time.perf_counter()
        pending.append((no, start, *server.issue(no, sample)))
        if len(pending) >= depth:
            finish()
        no += 1
    while pending:
        finish()
    return lat, done
