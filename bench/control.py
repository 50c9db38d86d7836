"""The check's control: the program the cell's family gives for it (the
plain reference put in the program's place, in the nearest precision
below the configuration's), driven through the same loop and held to the
same check. It has to come out not correct.

    python3 bench/control.py --workload <cell> --seeds 1 2 3 [--seconds 1]

Prints one JSON line a seed with the compared numbers, the device it ran
on, the queries attempted and the sizes it ran at (the family's `size`).
Runs no warm-up (the control is not timed); give it the seconds a run
needs to fill the check's batches. Exits non-zero, and prints nothing,
without a CUDA device: its readings are upper readings of the cell's
limits only at the cell's own size on the card. `--dry` runs it on the
CPU at the size a test holds (bench/run.py --dry), and says so in each
line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control(cell, seed: int, seconds: float, device) -> dict:
    from bench import harness
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic,
                                                  warmup_batches=0))
    out = harness.run(cell, seed, seconds, False, device,
                      program=cell.family.control(cell.config, device))
    return {k: v["value"] for k, v in out["compared"].items()} | {
        "correct": out["correct"], "attempted": out["attempted"],
        "device": out["device"]["kind"]} | cell.family.size(cell.config,
                                                           cell.traffic)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--dry", action="store_true")
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from bench import harness
    cell = harness.load_cell(args.workload)
    if args.dry:
        cell, device = harness.dry(cell), "cpu"
    elif torch.cuda.is_available():
        device = "cuda"
    else:
        print("bench: the control runs at the cell's size on a CUDA device; "
              "torch sees none (--dry runs it on the CPU at the dry size)",
              file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **control(cell, seed, args.seconds, device)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
