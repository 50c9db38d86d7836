"""The decode step's share of the card's dense bfloat16 peak, in %: the
step's model operations (bench/work_lm.py, from the cell's shapes) times
the steps a second that reached the host inside the traced window, over
work_lm.BF16_OPS_PER_S."""

from bench.work_lm import BF16_OPS_PER_S


def read(run):
    work = run.work.get("decode")
    if run.timeline is None or work is None or not run.counts:
        return None
    steps = sum(1 for t in run.done_s if t <= run.seconds) / run.seconds
    return 100.0 * work["ops"] * steps / BF16_OPS_PER_S
