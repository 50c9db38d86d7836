"""Device time of phase 2, in ms: the work launched inside the program's
`kernels.rescore` range (the query broadcast and string operands, the
per-string weights, the gathered kernel), per range."""

RANGE = "kernels.rescore"


def read(run):
    if run.timeline is None:
        return None
    ranges = run.timeline.spans(RANGE)
    work = run.timeline.device_of(ranges)
    if not ranges or not work:
        return None
    return sum(d.end - d.start for d in work) / 1e6 / len(ranges)
