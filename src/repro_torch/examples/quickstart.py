"""Quickstart: the paper's MCAM vector-similarity search (twin of the JAX
package's `examples/quickstart.py`).

    python -m repro_torch.examples.quickstart [--device cpu]

1. Build an MCAM-backed external memory (MTMC-encoded, AVSS search mode).
2. Write clustered support embeddings; search noisy queries.
3. Compare iteration counts / throughput of AVSS vs SVSS (paper Table 2),
   from the cost model of the simulated flash device.
4. Two-phase search: LUT shortlist + exact noisy rescore.

It runs on the CUDA device unless `--device cpu` is given. The clustered
data are numpy's normals (seed 0), not jax.random's, so the accuracies
are the reference's in kind, not bit for bit; the iteration, throughput
and capacity lines are the same numbers.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import costmodel
from repro_torch.core.avss import SearchConfig, search_iterations
from repro_torch.core.memory import MemoryConfig
from repro_torch.engine import MemoryStore, RetrievalEngine, SearchRequest
from repro_torch.engine.store import resolve_device


def main(argv=None) -> dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n_way, k_shot, dim, cl = 20, 10, 48, 32

    rng = np.random.default_rng(0)
    centers = rng.standard_normal((n_way, dim), dtype=np.float32) * 2.0
    s_lab = np.repeat(np.arange(n_way, dtype=np.int32), k_shot)
    support = centers[s_lab] + 0.3 * rng.standard_normal(
        (n_way * k_shot, dim), dtype=np.float32)
    queries = centers + 0.3 * rng.standard_normal(centers.shape,
                                                  dtype=np.float32)
    target = torch.arange(n_way, device=dev)

    cfg = MemoryConfig(capacity=512, dim=dim,
                       search=SearchConfig("mtmc", cl=cl, mode="avss"))
    # program once: quantized values, MTMC LUT projection AND string-grid
    # layout are all materialised at write time (real MCAM programming)
    store = MemoryStore.create(cfg, device=dev).calibrate(support).write(
        support, s_lab)
    engine = RetrievalEngine(cfg.search)

    res = engine.search(store, queries, SearchRequest(mode="full"))
    acc = float((res.predict() == target).float().mean())
    print(f"[full search]      accuracy {acc:.2%} "
          f"({n_way}-way {k_shot}-shot, MTMC CL={cl}, noisy MCAM)")

    res2 = engine.search(store, queries, SearchRequest(mode="two_phase",
                                                       k=32))
    acc2 = float((res2.predict() == target).float().mean())
    print(f"[two-phase search] accuracy {acc2:.2%} "
          f"(MXU LUT shortlist k=32 + exact rescore)")

    enc = cfg.search.enc
    it_avss = search_iterations(dim, enc, "avss")
    it_svss = search_iterations(dim, enc, "svss")
    print(f"[iterations]       SVSS {it_svss}  vs  AVSS {it_avss}  "
          f"({it_svss // it_avss}x fewer word-line cycles)")
    print(f"[throughput]       SVSS "
          f"{costmodel.throughput_searches_per_s(dim, enc, 'svss'):.1f}/s vs "
          f"AVSS {costmodel.throughput_searches_per_s(dim, enc, 'avss'):.0f}/s")
    print(f"[capacity]         {costmodel.strings_used(dim, enc, len(s_lab))}"
          f" NAND strings used of 131072 per block")
    return {"full": acc, "two_phase": acc2}


if __name__ == "__main__":
    main()
