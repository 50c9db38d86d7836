"""The dense physics entry's share of its roofline (`full`'s noisy search
of every row), in %: bench/work.py's bound at the cell's shapes over the
kernel's device time per launch."""

KERNEL = "search_dense"


def read(run):
    if run.timeline is None or "dense" not in run.work:
        return None
    work = [d for d in run.timeline.device if KERNEL in d.name]
    if not work:
        return None
    ms = sum(d.end - d.start for d in work) / 1e6 / len(work)
    return 100.0 * run.work["dense"]["bound_ms"] / ms
