"""The one-table shortlist's share of its roofline, in %: bench/work.py's
bound at the cell's shapes over the device time of the work launched
inside the program's `shortlist_fused` range, per call."""

RANGE = "shortlist_fused"


def read(run):
    if run.timeline is None or "shortlist" not in run.work:
        return None
    ranges = run.timeline.spans(RANGE)
    work = run.timeline.device_of(ranges)
    if not ranges or not work:
        return None
    ms = sum(d.end - d.start for d in work) / 1e6 / len(ranges)
    return 100.0 * run.work["shortlist"]["bound_ms"] / ms
