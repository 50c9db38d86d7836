"""Time the store's write paths on one NVIDIA GPU.

    python3 src/repro_torch/launch/time_write.py [--src DIR]
        [--capacity 65536] [--seed 0] [--reps 5]

Run it from the root of a checkout: it takes its data, its write batches
and its timers from chip_smoke.py there. It imports the repro_torch
package under DIR (default: this checkout's src; another checkout's src,
such as a parent commit's, times that tree's writes on the same data and
card), and times on the host clock, with the card synchronised after each
call (medians of --reps calls after a warm-up):

  program    [program]: create, calibrate and write the main store
             (--capacity rows, d = 48, MTMC CL = 32) in one batch
  unsharded  [sharded write]: SHARDED_WRITE_CAPACITY rows in
             SHARDED_WRITE_BATCHES, the last wrapping past the ring's
             end, into one store
  mesh8      the same batches into the store sharded over (8,) positions
             of the card (the shard-local write-through, which rebuilds
             each shard's router sketch)

Each path's result is held against the unsharded write in every leaf.
One JSON object, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--src", type=Path, default=ROOT / "src",
                   help="the directory that holds the repro_torch to time")
    p.add_argument("--capacity", type=int, default=65536)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_write: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(args.src.resolve()), str(ROOT)]
    import chip_smoke as smoke
    from repro_torch.core.avss import SearchConfig
    from repro_torch.core.memory import MemoryConfig
    from repro_torch.engine import MemoryStore
    from repro_torch.launch.mesh import Mesh

    t = smoke.timers(torch)
    _, labels_np, support_np, _, _ = smoke.clustered(
        args.seed, args.capacity, 48, 256)
    support = torch.from_numpy(support_np).to(t.dev)
    labels = torch.from_numpy(labels_np).to(t.dev)
    cfg = MemoryConfig(capacity=args.capacity, dim=48,
                       search=SearchConfig("mtmc", cl=32, mode="avss"))

    def program():
        return MemoryStore.create(cfg).calibrate(support).write(support,
                                                                labels)

    wcfg = dataclasses.replace(cfg, capacity=smoke.SHARDED_WRITE_CAPACITY)
    batches, a = [], 0
    for b in smoke.SHARDED_WRITE_BATCHES:
        idx = torch.arange(a, a + b, device=t.dev) % support.shape[0]
        batches.append((support[idx], labels[idx]))
        a += b

    def written(st):
        for x, lab in batches:
            st = st.write(x, lab)
        return st
    base = MemoryStore.create(wcfg).calibrate(support)
    mbase = base.shard(Mesh.repeat(t.dev, (8,), ("data",)))
    want = written(base).shard(n_shards=8)
    got = written(mbase)
    for f in ("values", "proj", "proj_packed", "s_grid", "labels",
              "sketch_sums", "sketch_counts"):
        if not torch.equal(getattr(got, f).full(t.dev), getattr(want, f)):
            smoke.fail(f"time_write: the (8,) write's {f} differs from the "
                       f"unsharded write's")
    out = {"src": str(args.src),
           "program": t.host_ms(program, reps=args.reps),
           "unsharded": t.host_ms(lambda: written(base), reps=args.reps),
           "mesh8": t.host_ms(lambda: written(mbase), reps=args.reps)}
    card = smoke.gpu_line()
    t.log(json.dumps({**out, "card": card}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
