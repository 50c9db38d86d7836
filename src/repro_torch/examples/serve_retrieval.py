"""End-to-end serving example, the twin of `examples/serve_retrieval.py`: a
small LM (an arch's smoke config, random weights) decodes batched
requests with an MCAM-backed kNN memory fused into the logits
(`make_serve_step_with_mcam`, the dense head, as the reference's example
uses). On the card unless `--device cpu`:

    PYTHONPATH=src python -m repro_torch.examples.serve_retrieval \\
        [--arch starcoder2-3b] [--batch 4] [--steps 12] [--lam 0.3] \\
        [--device cpu]

The reference draws its weights, prompts and store from jax.random; the
twin draws them from a seeded torch generator (weights) and numpy (the
rest), and its store's search config keeps use_kernel="auto" where the
reference pins "ref" (the dense head runs no search kernel either way).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import load_config
from repro_torch.engine.store import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.serve import demo_store
from repro_torch.models import transformer as tfm


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--lam", type=float, default=0.3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = load_config(args.arch, smoke=True)
    params = tfm.init(torch.Generator(device=dev).manual_seed(args.seed), cfg)
    B, P = args.batch, args.prompt_len
    max_seq = P + args.steps

    # the MCAM memory: a token-labelled embedding store (kNN-LM head),
    # programmed once at write time
    mem_cfg, store = demo_store(cfg, args.seed, dev)
    serve_step = steps_lib.make_serve_step_with_mcam(cfg, mem_cfg,
                                                     lam=args.lam)
    plain_step = steps_lib.make_serve_step(cfg)

    # batched requests: prefill through the decode path, then decode
    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                            (B, P))).to(dev)
    caches = tfm.init_cache(cfg, B, max_seq, dev)
    print(f"prefilling {B} requests of {P} tokens ...")
    t0 = time.perf_counter()
    for t in range(P):  # teacher-forced prefill through the decode path
        logits, caches = plain_step(params, caches,
                                    {"tokens": prompts[:, t:t + 1]}, t)
    print(f"  prefill {time.perf_counter() - t0:.1f}s")

    tok = torch.argmax(logits[:, 0], -1)[:, None]
    outs = [tok]
    t0 = time.perf_counter()
    for i in range(args.steps):
        logits, caches = serve_step(params, caches, {"tokens": tok}, P + i,
                                    store)
        tok = torch.argmax(logits[:, 0], -1)[:, None]
        outs.append(tok)
    gen = torch.cat(outs, 1).cpu().numpy()
    dt = time.perf_counter() - t0
    print(f"decoded {args.steps} steps x {B} requests in {dt:.1f}s "
          f"({args.steps * B / dt:.1f} tok/s on {dev}, MCAM-fused logits)")
    for b in range(B):
        print(f"  req{b}: {gen[b].tolist()}")
    if not torch.isfinite(logits).all():
        raise RuntimeError("serve_retrieval: non-finite logits")
    print("OK: serve_step_with_mcam end-to-end")
    return {"tokens": gen, "logits": logits}


if __name__ == "__main__":
    main()
