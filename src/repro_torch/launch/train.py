"""Training launcher (port of `repro.launch.train` on one device): the
language-model trainer and hardware-aware training of the few-shot
controller, closed by serving.

    python -m repro_torch.launch.train --arch starcoder2-3b --smoke \
        --steps 50 --batch 8 --seq 128 [--device cpu]

trains an LM (`train`): random init from the seed (the port's seeded
`torch.Generator`: its draws are not jax.random's), deterministic
step-addressable batches (`data.lm.SyntheticLM`, or stub embeddings for
the embedding-input archs), `launch/steps.make_train_step` (gradient
accumulation, int8 error feedback when configured, clipping, the
optimizer the arch's size calls for, the in-step anomaly guard), and
fault tolerance: checkpoints of {"params", "opt", "step"} in the JAX
package's format (`--resume` restarts from the newest), a final
checkpoint on SIGTERM / SIGINT (`runtime.ft.PreemptionHandler`),
`AnomalyDetector` and `StepWatchdog`. `--model-parallel` above 1 is
ROADMAP A9b.

    python -m repro_torch.launch.train --hat [--device cpu] \
        [--hat-pretrain-steps 40] [--hat-meta-steps 40] [--ckpt-dir DIR]

runs the hardware-aware trainer (`train_hat`):

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

Both run on the card unless `--device cpu` (`device=`) is given; without
a card and without it they raise. Each meta step's hardware noise is the
reference's: `step_key(seed, step)` is the key data of
`jax.random.fold_in(PRNGKey(seed), step)` (`core.prng`), which
`engine.noise_stream` folds as the reference folds it. The documented
differences from the reference are the random inits (`init_conv4` draws
numpy's normals, the LM torch's).

Training is reproducible bit for bit on the card: `train` and
`train_hat` (and so the `__main__` entry) first call
`make_deterministic()`, which turns on torch's deterministic algorithms
and cuDNN's deterministic convolutions and sets
`CUBLAS_WORKSPACE_CONFIG`. cuBLAS reads that variable when it makes its
first handle, so a program that does CUDA work before training calls
`make_deterministic()` before that work.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs import load_config
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.configs.omniglot_conv4 import FSLConfig, get_smoke_config
from repro_torch.core.avss import SearchConfig, class_mean_votes
from repro_torch.core.hat import HATConfig
from repro_torch.core import prng
from repro_torch.core.mcam import MCAMConfig
from repro_torch.data.fsl import EpisodeSampler, OmniglotLike, pretrain_batch
from repro_torch.data.lm import (LMDataConfig, SyntheticLM,
                                 embedding_batch_for_step)
from repro_torch.engine import MemoryStore, RetrievalEngine, SearchRequest
from repro_torch.engine.store import _not_ported, resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.steps import make_hat_train_steps
from repro_torch.models import transformer as tfm
from repro_torch.models.controller import apply_conv4, init_conv4
from repro_torch.optim import adamw
from repro_torch.runtime.ft import (AnomalyDetector, PreemptionHandler,
                                    StepWatchdog)

DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_hat_ckpt")
DEFAULT_LM_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
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


def make_batch(cfg, shape: ShapeConfig, data: SyntheticLM, step: int,
               accum: int, mb: int, device) -> dict:
    """Step `step`'s global batch as tensors on `device`, every leaf
    reshaped to (accum, mb, ...): the data source's token ids and labels,
    or (embedding archs) `embedding_batch_for_step`'s embeddings, labels
    and, for M-RoPE, positions3."""
    if cfg.input_mode == "tokens":
        b = data.batch_for_step(step)
    else:
        b = embedding_batch_for_step(step, shape.global_batch, shape.seq_len,
                                     cfg.d_model, cfg.vocab_size,
                                     mrope=cfg.rope_type == "mrope")
    return {k: torch.from_numpy(np.ascontiguousarray(v).reshape(
        (accum, mb) + v.shape[1:])).to(device) for k, v in b.items()}


def train(arch: str, smoke: bool, steps: int, batch: int, seq: int,
          ckpt_dir: str = DEFAULT_LM_CKPT_DIR, resume: bool = False,
          model_parallel: int = 1, log_every: int = 10,
          device: torch.device | str | None = None) -> list[float]:
    """Train `arch` (its smoke config with `smoke`) for `steps` steps of
    `batch` sequences of `seq` tokens; returns the losses of the steps
    run (module docstring). Checkpoints every TrainConfig.checkpoint_every
    steps, and on preemption, under `ckpt_dir`."""
    make_deterministic()
    if model_parallel > 1:
        raise _not_ported(f"--model-parallel {model_parallel} (a mesh)",
                          "A9b")
    dev = resolve_device(device)
    cfg = load_config(arch, smoke=smoke)
    shape = ShapeConfig("custom", seq, batch, "train")
    tc = TrainConfig(total_steps=steps, checkpoint_dir=ckpt_dir,
                     learning_rate=1e-3 if smoke else 3e-4)
    cfg = steps_lib.adapt_config(cfg, shape, 1)
    mb = steps_lib.microbatch_for(cfg, shape)
    accum = shape.global_batch // mb

    data = SyntheticLM(LMDataConfig(seq, batch, cfg.vocab_size))
    step_fn, optimizer = steps_lib.make_train_step(cfg, tc)
    params = tfm.init(torch.Generator(device=dev).manual_seed(tc.seed), cfg)
    opt_state = optimizer.init(params)

    mgr = CheckpointManager(ckpt_dir, every=tc.checkpoint_every)
    start = 0
    if resume and mgr.latest_step() is not None:
        start = mgr.latest_step()
        state = mgr.restore({"params": params, "opt": opt_state,
                             "step": torch.zeros((), dtype=torch.int32)})
        params, opt_state = state["params"], state["opt"]
        print(f"resumed from step {start}")

    pre = PreemptionHandler()
    anom = AnomalyDetector()
    dog = StepWatchdog()
    losses = []
    for step in range(start, steps):
        dog.start()
        b = make_batch(cfg, shape, data, step, accum, mb, dev)
        params, opt_state, metrics = step_fn(params, opt_state, b)
        loss = float(metrics["loss"])
        gn = float(metrics["grad_norm"])
        dt = dog.stop()
        losses.append(loss)
        if not anom.check(loss, gn):
            print(f"step {step}: ANOMALY skipped (loss={loss}, gn={gn})")
        if step % log_every == 0 or step == steps - 1:
            print(f"step {step:5d} loss {loss:.4f} gnorm {gn:.3f} "
                  f"{dt * 1000:.0f}ms")
        state = {"params": params, "opt": opt_state,
                 "step": torch.tensor(step + 1, dtype=torch.int32)}
        mgr.maybe_save(step + 1, state)
        if pre.preempted:
            print("preemption requested -> checkpoint + exit")
            mgr.maybe_save(step + 1, state, force=True)
            break
    mgr.wait()
    return losses


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
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: under the "
                         "temporary directory, one for LM runs, one for "
                         "--hat)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--hat", action="store_true",
                    help="two-stage hardware-aware training (paper Sec. "
                         "3.3) + the closed train->write->serve loop")
    ap.add_argument("--hat-pretrain-steps", type=int, default=40)
    ap.add_argument("--hat-meta-steps", type=int, default=40)
    ap.add_argument("--hat-n-way", type=int, default=6)
    ap.add_argument("--hat-k-shot", type=int, default=3)
    ap.add_argument("--hat-eval-episodes", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0,
                    help="--hat's seed (an LM run draws from "
                         "TrainConfig.seed, as the reference's)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    if args.hat:
        out = train_hat(args.hat_pretrain_steps, args.hat_meta_steps,
                        args.hat_n_way, args.hat_k_shot,
                        eval_episodes=args.hat_eval_episodes,
                        ckpt_dir=args.ckpt_dir or DEFAULT_CKPT_DIR,
                        seed=args.seed, device=args.device)
        print(f"HAT done: served acc {out['served_acc']:.3f} "
              f"(parity={out['parity']}); checkpoints in {out['ckpt_dir']}")
        return
    losses = train(args.arch, args.smoke, args.steps, args.batch, args.seq,
                   args.ckpt_dir or DEFAULT_LM_CKPT_DIR, args.resume,
                   args.model_parallel, device=args.device)
    print(f"first-10 mean {np.mean(losses[:10]):.4f} -> "
          f"last-10 mean {np.mean(losses[-10:]):.4f}")


if __name__ == "__main__":
    main()
