"""The held-expert layer's share of its roofline, in %: bench/work_lm.py's
bound of one MoE layer at the cell's shapes (the held and shared experts'
and the router's weights read once, or the routed pairs' operations)
over the device time of the work launched inside the program's `lm.moe`
range (the router and the experts), per call."""

RANGE = "lm.moe"


def read(run):
    if run.timeline is None or "moe" not in run.work:
        return None
    ranges = run.timeline.spans(RANGE)
    work = run.timeline.device_of(ranges)
    if not ranges or not work:
        return None
    ms = sum(d.end - d.start for d in work) / 1e6 / len(ranges)
    return 100.0 * run.work["moe"]["bound_ms"] / ms
