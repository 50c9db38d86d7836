"""How near a routed search comes to the exhaustive one on a cell's own
store and queries: recall@k and top-1 agreement at each nprobe.

    python3 bench/recall.py --workload <cell> --seeds 1 2 3 --nprobe 1 2 4 8 [--batches 4]

From the root of a checkout, on a CUDA device at the cell's size (`--dry`:
on the CPU at the size a test holds). Prints one JSON line a seed and
nprobe. The cell's family supplies `recall`; nothing here is timed, and
no run of the benchmark runs it: it is how a routed cell's nprobe is
chosen.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--nprobe", type=int, nargs="+", required=True)
    p.add_argument("--batches", type=int, default=4)
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
        print("bench: recall runs at the cell's size on a CUDA device; "
              "torch sees none (--dry runs it on the CPU)", file=sys.stderr)
        return 2
    for seed in args.seeds:
        got = cell.family.recall(cell.config, cell.traffic, seed, device,
                                 args.nprobe, args.batches)
        for nprobe, numbers in got.items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "nprobe": nprobe, "batches": args.batches,
                              "dry": args.dry, **numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
