"""Paper-faithful end-to-end example: Conv4 controller + HAT on procedural
Omniglot-like data, then the paper's evaluation matrix (twin of the JAX
package's `examples/fsl_omniglot.py`).

    python -m repro_torch.examples.fsl_omniglot [--device cpu] \\
        [--pretrain-steps 150] [--meta-steps 120] [--n-way 8] [--full] \\
        [--two-phase-eval --engine-backend fused] [--shortlist-k 64]

Two-stage HAT training (paper Sec. 3.3):
  stage 1: controller + linear classifier, plain CE on all training classes;
  stage 2: episodic meta-training THROUGH the simulated MCAM (asymmetric
           fake-quant, MTMC STE, string currents + noise, sigmoid-STE SA,
           vote-based CE); meta step `step` draws the noise of
           `jax.random.PRNGKey(step)` (`core.prng.PRNGKey`).
Evaluation: accuracy of {MTMC, B4E, SRE} x {standard, HAT} controllers
(AVSS) and SVSS vs AVSS, on held-out classes; then the train -> write ->
serve check. `--full` uses the paper's 200-way 10-shot geometry.

It runs on the CUDA device unless `--device cpu` is given; on the card
every evaluation search runs the hand-written kernels. Two documented
differences from the reference: the controller's random init (numpy's
draws, `launch.train.init_params`), and the search configurations keep
`use_kernel="auto"`, where the reference pins "ref" (on this port every
backend gives the same results, and "auto" is the kernels' route).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.omniglot_conv4 import get_config, get_smoke_config
from repro_torch.core import prng
from repro_torch.core.avss import SearchConfig, class_mean_votes
from repro_torch.core.hat import HATConfig
from repro_torch.core.mcam import MCAMConfig
from repro_torch.core.quantization import (QuantSpec, fake_quant,
                                           quantize_asymmetric)
from repro_torch.data.fsl import EpisodeSampler, OmniglotLike, pretrain_batch
from repro_torch.engine import MemoryStore, RetrievalEngine, SearchRequest
from repro_torch.engine.store import resolve_device
from repro_torch.launch.steps import make_hat_train_steps
from repro_torch.launch.train import init_params
from repro_torch.models.controller import apply_conv4
from repro_torch.optim import adamw

#: the evaluation matrix's encodings: (name, cl), MTMC at the dataset's CL
MATRIX_ENCODINGS = (("mtmc", None), ("b4e", 3), ("sre", 4))


def embed_apply(params, images):
    return apply_conv4(params, images)


def _embed(params, images, dev) -> torch.Tensor:
    return embed_apply(params["backbone"],
                       torch.as_tensor(images, device=dev))


def evaluate(params, sampler, search_cfg, episodes=6, backend="auto",
             two_phase=False, k=64):
    """Episode accuracy through the retrieval API on the controller's
    device: each episode's quantized supports are programmed into a
    MemoryStore and searched with one typed request (`full`, or
    `two_phase` shortlist + exact noisy rescore). Returns (mean, std)."""
    dev = params["backbone"]["proj"]["w"].device
    engine = RetrievalEngine(search_cfg, backend=backend)
    request = SearchRequest(mode="two_phase" if two_phase else "full", k=k)
    levels = search_cfg.enc.levels
    accs = []
    with torch.no_grad():
        for e in range(episodes):
            ep = sampler.episode(1000 + e)
            s_emb = _embed(params, ep.support_images, dev)
            q_emb = _embed(params, ep.query_images, dev)
            if search_cfg.mode == "avss":
                qv, sv = quantize_asymmetric(q_emb, s_emb, levels)
            else:
                sv, _, rng = fake_quant(s_emb, QuantSpec(levels))
                qv, _, _ = fake_quant(q_emb, QuantSpec(levels), rng)
            qv, sv = qv.to(torch.int32), sv.to(torch.int32)
            store = MemoryStore.from_quantized(sv, ep.support_labels,
                                               search_cfg, device=dev)
            pred = engine.search(store, qv, request).predict()
            q_lab = torch.as_tensor(ep.query_labels, device=dev)
            accs.append(float((pred == q_lab).float().mean()))
    return float(np.mean(accs)), float(np.std(accs))


def train_controller(fsl, ds, train_ids, hat_cfg, args, use_hat=True,
                     seed=0):
    dev = resolve_device(args.device)
    pre_opt = adamw(1e-3, weight_decay=1e-4)
    meta_opt = adamw(1e-4, weight_decay=1e-4)  # gentle: adapt, don't destroy
    pre_step, meta_step, place = make_hat_train_steps(
        embed_apply, hat_cfg, pre_opt, meta_opt, n_way=args.n_way,
        device=dev)
    params = init_params(fsl, len(train_ids), seed, 32, dev)
    opt_state = pre_opt.init(params)

    t0 = time.time()
    for step in range(args.pretrain_steps):
        batch = place(pretrain_batch(ds, train_ids, batch=32, step=step))
        params, opt_state, loss = pre_step(params, opt_state, batch)
        if step % 50 == 0:
            print(f"  [pretrain] step {step} loss {float(loss):.3f} "
                  f"({time.time()-t0:.0f}s)")

    if not use_hat:
        return params

    # stage 2: episodic meta-training through the simulated MCAM
    sampler = EpisodeSampler(ds, train_ids, n_way=args.n_way,
                             k_shot=fsl.k_shot, n_query=4, seed=11)
    meta_params = {"backbone": params["backbone"]}
    opt_state2 = meta_opt.init(meta_params)
    for step in range(args.meta_steps):
        ep = sampler.episode(step)
        episode = place({"support_images": ep.support_images,
                         "support_labels": ep.support_labels,
                         "query_images": ep.query_images,
                         "query_labels": ep.query_labels})
        meta_params, opt_state2, loss = meta_step(
            meta_params, opt_state2, episode, prng.PRNGKey(step))
        if step % 40 == 0:
            print(f"  [meta/HAT] step {step} loss {float(loss):.3f} "
                  f"({time.time()-t0:.0f}s)")
    return {"backbone": meta_params["backbone"], "head": params["head"]}


def main(argv=None) -> dict:
    """Train both controllers, print the evaluation matrix and the serve
    check. Returns {"matrix": {(controller, encoding, mode): (mean, std)},
    "serve_parity": bool}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--pretrain-steps", type=int, default=150)
    ap.add_argument("--meta-steps", type=int, default=120)
    ap.add_argument("--n-way", type=int, default=8)
    ap.add_argument("--full", action="store_true",
                    help="paper geometry (200-way 10-shot, CL=32)")
    ap.add_argument("--engine-backend", default="auto",
                    choices=["auto", "ref", "pallas", "mxu", "fused"])
    ap.add_argument("--two-phase-eval", action="store_true",
                    help="evaluate via the two-phase engine path "
                         "(shortlist + exact rescore) instead of full search")
    ap.add_argument("--shortlist-k", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    fsl = get_config() if args.full else get_smoke_config()
    if not args.full:
        fsl = dataclasses.replace(fsl, k_shot=5)
    ds = OmniglotLike(n_classes=fsl.n_train_classes + fsl.n_test_classes,
                      image_size=fsl.image_size, seed=0)
    train_ids = np.arange(fsl.n_train_classes)
    test_ids = np.arange(fsl.n_train_classes,
                         fsl.n_train_classes + fsl.n_test_classes)

    mcam = MCAMConfig(sigma_device=0.15, sigma_read=0.05)
    cl = fsl.cl
    hat_cfg = HATConfig(search=SearchConfig("mtmc", cl=cl, mode="avss",
                                            mcam=mcam))

    print("== training controller WITHOUT HAT (standard 2-stage of [24]) ==")
    params_std = train_controller(fsl, ds, train_ids, hat_cfg, args,
                                  use_hat=False)
    print("== training controller WITH HAT (paper Sec. 3.3) ==")
    params_hat = train_controller(fsl, ds, train_ids, hat_cfg, args,
                                  use_hat=True)

    n_way = min(args.n_way, len(test_ids))
    sampler = EpisodeSampler(ds, test_ids, n_way=n_way, k_shot=fsl.k_shot,
                             n_query=4, seed=77)

    print(f"\n== evaluation on {len(test_ids)} held-out classes "
          f"({n_way}-way {fsl.k_shot}-shot, noisy MCAM) ==")
    results = {}
    for label, params in [("std", params_std), ("HAT", params_hat)]:
        for enc_name, ecl in MATRIX_ENCODINGS:
            cfg = SearchConfig(enc_name, cl=ecl or cl, mode="avss",
                               mcam=mcam)
            acc, sd = evaluate(params, sampler, cfg,
                               backend=args.engine_backend,
                               two_phase=args.two_phase_eval,
                               k=args.shortlist_k)
            results[(label, enc_name, "avss")] = (acc, sd)
            print(f"  {label:4s} {enc_name:5s} AVSS: {acc:.3f} +- {sd:.3f}")
    for mode in ("svss", "avss"):
        cfg = SearchConfig("mtmc", cl=cl, mode=mode, mcam=mcam)
        acc, sd = evaluate(params_hat, sampler, cfg,
                           backend=args.engine_backend)
        results[("HAT", "mtmc", f"{mode}_full")] = (acc, sd)
        print(f"  HAT  mtmc {mode.upper()}: {acc:.3f} +- {sd:.3f}")

    d_hat = results[("HAT", "mtmc", "avss")][0] \
        - results[("std", "mtmc", "avss")][0]
    d_enc = results[("HAT", "mtmc", "avss")][0] \
        - results[("HAT", "b4e", "avss")][0]
    print(f"\n  HAT gain (mtmc):          {d_hat:+.3f}   (paper: +1.25%..1.8%)")
    print(f"  MTMC vs B4E (HAT ctrl):   {d_enc:+.3f}   (paper: +0.34%..4.91%)")

    parity = serve_loop_check(params_hat, sampler, hat_cfg)
    return {"matrix": results, "serve_parity": parity}


def serve_loop_check(params, sampler, hat_cfg) -> bool:
    """Close the train->write->serve loop: the HAT controller's noiseless
    in-training scores (engine.episode_scores -- the exact forward stage 2
    trained through) must be BIT-IDENTICAL to serving the same supports
    through MemoryStore.calibrate/write + engine.search."""
    dev = params["backbone"]["proj"]["w"].device
    eng = RetrievalEngine(hat_cfg.search)
    ep = sampler.episode(4242)
    with torch.no_grad():
        s_emb = _embed(params, ep.support_images, dev)
        q_emb = _embed(params, ep.query_images, dev)
        s_lab = torch.as_tensor(ep.support_labels, device=dev)
        scores = eng.episode_scores(q_emb, s_emb, s_lab, ep.n_way,
                                    clip_std=hat_cfg.clip_std,
                                    sa_tau=hat_cfg.sa_tau, noisy=False)
        store = MemoryStore.from_episode(s_emb, q_emb, s_lab,
                                         hat_cfg.search,
                                         clip_std=hat_cfg.clip_std)
        res = eng.search(store, q_emb, SearchRequest(mode="full",
                                                     noisy=False))
        served = class_mean_votes(res.votes, store.labels, ep.n_way)
    parity = bool(torch.equal(scores, served))
    print(f"\n== train->write->serve loop ==\n"
          f"  in-training scores == served scores (bitwise): {parity}")
    return parity


if __name__ == "__main__":
    main()
