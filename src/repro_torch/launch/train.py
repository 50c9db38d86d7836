"""Hardware-aware training of the few-shot controller, closed by serving
(port of `repro.launch.train --hat`; the LM trainer waits for ROADMAP
Queue A10c):

    python -m repro_torch.launch.train --hat [--device cpu] \
        [--hat-pretrain-steps 40] [--hat-meta-steps 40] [--ckpt-dir DIR]

1. Pretrain a Conv4 controller with a linear head over the training
   classes (plain cross-entropy).
2. Meta-train it episodically through the simulated MCAM
   (`core.hat.meta_loss`): on the card the episode's physics runs the
   dense search kernel forward and the episodic backward kernel.
3. Close the loop on held-out classes: the trained controller's
   embeddings are programmed into a store (`MemoryStore.from_episode`)
   and searched (`mode="full"`, noiseless); the served class scores must
   equal the in-training head's bit for bit.
4. Checkpoint the controller and the last store (the JAX package's
   format).

It runs on the card unless `--device cpu` is given. Each meta step's
hardware noise is the reference's: `step_key(seed, step)` is the key data
of `jax.random.fold_in(PRNGKey(seed), step)` (`core.prng`), which
`engine.noise_stream` folds as the reference folds it. The one documented
difference from the reference is the controller's random init
(`init_conv4` draws numpy's normals, not jax.random's).

Training is reproducible bit for bit on the card: `train_hat` (and so
the `__main__` entry) first calls `make_deterministic()`, which turns on
torch's deterministic algorithms and cuDNN's deterministic convolutions
and sets `CUBLAS_WORKSPACE_CONFIG`. cuBLAS reads that variable when it
makes its first handle, so a program that does CUDA work before training
calls `make_deterministic()` before that work.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs.omniglot_conv4 import FSLConfig, get_smoke_config
from repro_torch.core.avss import SearchConfig, class_mean_votes
from repro_torch.core.hat import HATConfig
from repro_torch.core import prng
from repro_torch.core.mcam import MCAMConfig
from repro_torch.data.fsl import EpisodeSampler, OmniglotLike, pretrain_batch
from repro_torch.engine import MemoryStore, RetrievalEngine, SearchRequest
from repro_torch.engine.store import resolve_device
from repro_torch.launch.steps import make_hat_train_steps
from repro_torch.models.controller import apply_conv4, init_conv4
from repro_torch.optim import adamw

DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_hat_ckpt")
#: cuBLAS's reproducible workspace setting (make_deterministic)
CUBLAS_WORKSPACE = ":4096:8"


def hat_config(fsl: FSLConfig) -> HATConfig:
    """The trainer's HAT setting: the dataset's MTMC code length, AVSS,
    and the noisier MCAM the reference trains against."""
    return HATConfig(search=SearchConfig(
        "mtmc", cl=fsl.cl, mode="avss",
        mcam=MCAMConfig(sigma_device=0.15, sigma_read=0.05)))


def init_params(fsl: FSLConfig, n_train: int, seed: int, width: int,
                device) -> dict:
    """Conv4 backbone (width `width`) and a linear head over the training
    classes, from `seed` (numpy's draws)."""
    rng = np.random.default_rng(seed + 1)
    head = {"w": torch.as_tensor(
        rng.standard_normal((fsl.embed_dim, n_train)) * 0.05,
        dtype=torch.float32, device=device),
        "b": torch.zeros(n_train, dtype=torch.float32, device=device)}
    return {"backbone": init_conv4(seed, in_ch=fsl.channels, width=width,
                                   embed_dim=fsl.embed_dim, device=device),
            "head": head}


def step_key(seed: int, step: int) -> np.ndarray:
    """Meta step `step`'s key: the (2,) uint32 key data of
    `jax.random.fold_in(jax.random.PRNGKey(seed), step)`, which the
    reference trainer passes, folded into the step's noise stream."""
    return prng.fold_in(prng.PRNGKey(seed), step)


def make_deterministic() -> None:
    """Make training on the card give the same bits on every run: torch's
    deterministic algorithms (the gradient of a gather sums without
    atomics; an op with no deterministic form raises), cuDNN's
    deterministic convolution algorithms without benchmarking, and cuBLAS's
    fixed workspace (`CUBLAS_WORKSPACE_CONFIG`, kept where the caller set
    it). cuBLAS reads the variable when it makes its first handle: call
    this before the process's first CUDA work."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def train_hat(pretrain_steps: int = 40, meta_steps: int = 40,
              n_way: int = 6, k_shot: int = 3, n_query: int = 4,
              eval_episodes: int = 3, ckpt_dir: str = DEFAULT_CKPT_DIR,
              seed: int = 0, log_every: int = 10,
              device: torch.device | str | None = None,
              fsl: FSLConfig | None = None, width: int = 32) -> dict:
    """Two-stage hardware-aware training and the closed train -> write ->
    serve loop (module docstring). Returns the loss curves, the
    in-training and served eval accuracies, and whether every served class
    score equalled the in-training head's bit for bit."""
    make_deterministic()
    fsl = fsl or get_smoke_config()
    dev = resolve_device(device)
    ds = OmniglotLike(n_classes=fsl.n_train_classes + fsl.n_test_classes,
                      image_size=fsl.image_size, seed=0)
    train_ids = np.arange(fsl.n_train_classes)
    test_ids = np.arange(fsl.n_train_classes,
                         fsl.n_train_classes + fsl.n_test_classes)
    hat_cfg = hat_config(fsl)
    pre_opt = adamw(1e-3, weight_decay=1e-4)
    meta_opt = adamw(1e-4, weight_decay=1e-4)  # gentle: adapt, don't destroy
    pre_step, meta_step, place = make_hat_train_steps(
        apply_conv4, hat_cfg, pre_opt, meta_opt, n_way=n_way, device=dev)

    # stage 1: transferable features (plain CE, full training label set)
    params = init_params(fsl, len(train_ids), seed, width, dev)
    opt_state = pre_opt.init(params)
    pre_losses, meta_losses = [], []
    t0 = time.time()
    for step in range(pretrain_steps):
        batch = place(pretrain_batch(ds, train_ids, batch=32, step=step))
        params, opt_state, loss = pre_step(params, opt_state, batch)
        pre_losses.append(float(loss))
        if step % log_every == 0 or step == pretrain_steps - 1:
            print(f"[hat/pretrain] step {step:4d} loss {float(loss):.4f} "
                  f"({time.time() - t0:.0f}s)")

    # stage 2: episodic meta-training through the simulated MCAM
    sampler = EpisodeSampler(ds, train_ids, n_way=n_way, k_shot=k_shot,
                             n_query=n_query, seed=11 + seed)
    meta_params = {"backbone": params["backbone"]}
    opt_state2 = meta_opt.init(meta_params)
    for step in range(meta_steps):
        ep = sampler.episode(step)
        arrays = place({"support_images": ep.support_images,
                        "support_labels": ep.support_labels,
                        "query_images": ep.query_images,
                        "query_labels": ep.query_labels})
        meta_params, opt_state2, loss = meta_step(
            meta_params, opt_state2, arrays, step_key(seed, step))
        meta_losses.append(float(loss))
        if step % log_every == 0 or step == meta_steps - 1:
            print(f"[hat/meta]     step {step:4d} loss {float(loss):.4f} "
                  f"({time.time() - t0:.0f}s)")

    # close the loop: trained controller -> calibrate / write -> search
    eng = RetrievalEngine(hat_cfg.search)
    eval_way = min(n_way, len(test_ids))
    eval_sampler = EpisodeSampler(ds, test_ids, n_way=eval_way,
                                  k_shot=k_shot, n_query=n_query,
                                  seed=77 + seed)
    backbone = meta_params["backbone"]
    train_acc, served_acc, parity = [], [], True
    store = None
    with torch.no_grad():
        for e in range(eval_episodes):
            ep = place(vars(eval_sampler.episode(e)))
            s_emb = apply_conv4(backbone, ep["support_images"])
            q_emb = apply_conv4(backbone, ep["query_images"])
            s_lab = ep["support_labels"]
            # the in-training evaluation head (noiseless episodic forward)
            scores = eng.episode_scores(q_emb, s_emb, s_lab, eval_way,
                                        clip_std=hat_cfg.clip_std,
                                        sa_tau=hat_cfg.sa_tau, noisy=False)
            # the served head: the one train -> write -> serve recipe
            store = MemoryStore.from_episode(s_emb, q_emb, s_lab,
                                             hat_cfg.search,
                                             clip_std=hat_cfg.clip_std)
            res = eng.search(store, q_emb,
                             SearchRequest(mode="full", noisy=False))
            served = class_mean_votes(res.votes, store.labels, eval_way)
            parity &= bool(torch.equal(scores, served))
            q_lab = ep["query_labels"]
            train_acc.append(float((scores.argmax(-1) == q_lab)
                                   .float().mean()))
            served_acc.append(float((served.argmax(-1) == q_lab)
                                    .float().mean()))

    print(f"[hat/eval] in-training acc {np.mean(train_acc):.3f}  "
          f"served acc {np.mean(served_acc):.3f}  "
          f"score bit-parity: {parity}")

    # checkpoint the controller and the last programmed store
    mgr = CheckpointManager(ckpt_dir, every=1)
    mgr.maybe_save(meta_steps, {"params": meta_params}, force=True)
    mgr.wait()
    if store is not None:
        store.save(os.path.join(ckpt_dir, "store"), step=meta_steps)
    return {"pre_losses": pre_losses, "meta_losses": meta_losses,
            "train_acc": float(np.mean(train_acc)),
            "served_acc": float(np.mean(served_acc)),
            "parity": parity, "ckpt_dir": ckpt_dir}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hat", action="store_true",
                    help="two-stage hardware-aware training (paper Sec. "
                         "3.3) + the closed train->write->serve loop")
    ap.add_argument("--hat-pretrain-steps", type=int, default=40)
    ap.add_argument("--hat-meta-steps", type=int, default=40)
    ap.add_argument("--hat-n-way", type=int, default=6)
    ap.add_argument("--hat-k-shot", type=int, default=3)
    ap.add_argument("--hat-eval-episodes", type=int, default=3)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    if not args.hat:
        ap.error("only --hat is ported; the LM trainer waits for ROADMAP "
                 "Queue A10c")
    out = train_hat(args.hat_pretrain_steps, args.hat_meta_steps,
                    args.hat_n_way, args.hat_k_shot,
                    eval_episodes=args.hat_eval_episodes,
                    ckpt_dir=args.ckpt_dir, seed=args.seed,
                    device=args.device)
    print(f"HAT done: served acc {out['served_acc']:.3f} "
          f"(parity={out['parity']}); checkpoints in {out['ckpt_dir']}")


if __name__ == "__main__":
    main()
