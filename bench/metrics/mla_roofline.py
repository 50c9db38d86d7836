"""The latent attention's share of its roofline, in %: bench/work_lm.py's
bound of one layer's MLA at the cell's shapes (its weights and latent
cache read once, or its operations) over the device time of the work
launched inside the program's `lm.mla` range, per call."""

RANGE = "lm.mla"


def read(run):
    if run.timeline is None or "mla" not in run.work:
        return None
    ranges = run.timeline.spans(RANGE)
    work = run.timeline.device_of(ranges)
    if not ranges or not work:
        return None
    ms = sum(d.end - d.start for d in work) / 1e6 / len(ranges)
    return 100.0 * run.work["mla"]["bound_ms"] / ms
