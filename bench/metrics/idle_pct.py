"""The share of the traced window in which the card ran nothing, in %:
the window from the first benchmark span to the last device work, less
the union of every kernel, copy and memset."""


def read(run):
    if run.timeline is None:
        return None
    start, end = run.timeline.window()
    if end <= start or not run.timeline.device:
        return None
    return 100.0 * (1.0 - run.timeline.busy_ns() / (end - start))
