"""Device time of the published router, in ms: the work launched inside
the program's `lm.router` range (scores, groups, top-k, gates), per
call."""

RANGE = "lm.router"


def read(run):
    if run.timeline is None:
        return None
    ranges = run.timeline.spans(RANGE)
    work = run.timeline.device_of(ranges)
    if not ranges or not work:
        return None
    return sum(d.end - d.start for d in work) / 1e6 / len(ranges)
