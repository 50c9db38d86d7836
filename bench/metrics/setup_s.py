"""Seconds from the start of the process to the first timed batch: the
imports, the card's start, the kernels' libraries (built in a checkout's
first run), the inputs, programming the store and the warm-up."""


def read(run):
    return run.setup_s
