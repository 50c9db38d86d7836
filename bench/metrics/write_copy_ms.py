"""Device time of a write's leaf copies, in ms: the work launched inside
the program's `store.commit` range (each leaf put out of place), summed
over the window, per `store.write` range."""

RANGE = "store.commit"
ROOT = "store.write"


def read(run):
    if run.timeline is None:
        return None
    writes = run.timeline.spans(ROOT)
    work = run.timeline.device_of(run.timeline.spans(RANGE))
    if not writes or not work:
        return None
    return sum(d.end - d.start for d in work) / 1e6 / len(writes)
