"""Queries whose predicted labels reached the host inside the window,
over the window's seconds."""


def read(run):
    done = sum(1 for t in run.done_s if t <= run.seconds)
    return done * run.cell.traffic["batch"] / run.seconds
