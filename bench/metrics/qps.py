"""Queries whose predicted labels reached the host inside the window,
over the window's seconds."""


def read(run):
    done = sum(n for n, t in zip(run.counts, run.done_s) if t <= run.seconds)
    return done / run.seconds
