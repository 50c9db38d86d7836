"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout; the program is `src/repro_torch`, which this
script puts on the path. With --trace 0 the line's metrics are the cell's
end-to-end metrics, with --trace 1 its per-layer ones, read from a
torch.profiler trace of the window. The last line of standard output is
one JSON object (correct, attempted, failed, metrics, device, breakdown
when traced, and `compared`: each number the check compared, with its
limit); the compared numbers are also the last lines of standard error.

Exits non-zero, and prints no result, where CUDA is not available, where
the program cannot be imported, or where a module whose top-level name is
jax, jaxlib, flax or repro was loaded. `--dry` runs the cell on the CPU at
a size that a test can hold (the plain versions of the program's kernels),
for the benchmark's own tests.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--dry", action="store_true")
    args = p.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from bench import harness
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("bench: no src/repro_torch in this checkout", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    if args.dry:
        cell = harness.dry(cell)
        device = "cpu"
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < \
                cell.spec["chips"]:
            print(f"bench: the cell needs {cell.spec['chips']} CUDA "
                  f"device(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda"
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      device, t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"bench: the run loaded {found}; the benchmark runs the port "
              f"alone", file=sys.stderr)
        return 3
    if device == "cuda":
        out["device"]["power_limit"] = power_limit()
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
