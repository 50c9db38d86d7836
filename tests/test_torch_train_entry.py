"""The port's LM trainer end to end on the CPU (`repro_torch.launch.
train`: `train`, `main`, the `examples/train_llm` twin): the reference's
smoke contract for a train step in bf16 for every smoke arch (a finite
loss, applied 1, parameters changed), remat against none (the same bits),
a run stopped through the preemption path and resumed against the
straight run (the same bits), the restore of a checkpoint that the JAX
package's `train` wrote (every leaf bit for bit, names, dtypes, step),
the entry point's log lines against the reference's, the refusal of a
run with no card and no --device, and --model-parallel 2 on one
device."""

import functools
import os
import re
import runpy
import signal
import sys

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.launch import train as j_train
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import ckpt as t_ckpt
from repro_torch.configs import ARCHS, load_config
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.launch import steps as TS
from repro_torch.launch import train as t_train
from repro_torch.models import transformer as TT
from repro_torch.runtime import ft as t_ft

torch.set_num_threads(1)

LM_ARCHS = tuple(a for a in ARCHS
                 if hasattr(load_config(a, True), "n_layers"))


@pytest.fixture
def restore_process_state(monkeypatch):
    """Put back what a trainer sets for the process: torch's determinism
    settings (`make_deterministic`) and the SIGTERM / SIGINT handlers
    (`PreemptionHandler`)."""
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                                 signal.SIGINT)}
    yield
    torch.use_deterministic_algorithms(saved[0])
    torch.backends.cudnn.deterministic = saved[1]
    torch.backends.cudnn.benchmark = saved[2]
    for s, h in handlers.items():
        signal.signal(s, h)


def _batch(cfg, accum: int, mb: int, seq: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    lead = (accum, mb, seq)
    if cfg.input_mode == "tokens":
        b = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     lead))}
    else:
        b = {"embeddings": torch.from_numpy(rng.standard_normal(
            lead + (cfg.d_model,)).astype(np.float32))}
        if cfg.rope_type == "mrope":
            b["positions3"] = torch.from_numpy(rng.integers(
                0, 3 * seq, lead + (3,)))
    b["labels"] = torch.from_numpy(rng.integers(0, cfg.vocab_size, lead))
    return b


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_smoke_train_step_in_bf16(arch):
    """tests/test_models_smoke.py::test_smoke_train_step's contract, in the
    configs' own bf16: global batch 4 as 2 x 2 (accumulation), seq 16."""
    cfg = load_config(arch, smoke=True)
    shape = ShapeConfig("smoke", 16, 4, "train", microbatch=2)
    cfg = TS.adapt_config(cfg, shape)
    step, optimizer = TS.make_train_step(cfg, TrainConfig(learning_rate=1e-3))
    params = TT.init(torch.Generator().manual_seed(0), cfg)
    before = [p.clone() for p in tree_lib.leaves(params)]
    state = optimizer.init(params)
    params, state, metrics = step(params, state, _batch(cfg, 2, 2, 16, 1))
    assert np.isfinite(float(metrics["loss"]))
    assert float(metrics["applied"]) == 1.0
    moved = sum(float((a.float() - b.float()).abs().sum())
                for a, b in zip(before, tree_lib.leaves(params)))
    assert moved > 0.0


@pytest.mark.parametrize("arch", ["starcoder2-3b", "deepseek-moe-16b",
                                  "xlstm-350m", "hymba-1.5b"])
def test_remat_gives_the_same_loss_and_gradients(arch):
    """cfg.remat checkpoints each layer's body; recomputing it in
    backward gives the same bits (bf16)."""
    out = []
    for remat in (False, True):
        cfg = TS.adapt_config(dataclasses.replace(
            load_config(arch, smoke=True), remat=remat),
            ShapeConfig("s", 16, 2, "train"))
        assert cfg.remat == remat
        params = TT.init(torch.Generator().manual_seed(0), cfg)
        mb = {k: v[0] for k, v in _batch(cfg, 1, 2, 16, 2).items()}
        out.append(TS._grads(params, cfg, mb))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def _ckpt_leaves(directory: str, step: int) -> tuple[dict, list]:
    d = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    files = sorted(x for x in os.listdir(d) if x.endswith(".npy"))
    return manifest, [np.load(os.path.join(d, x)) for x in files]


class _PreemptAfter:
    """A PreemptionHandler whose first `n` checks report no request and
    every later one a request."""

    def __init__(self, n: int):
        self.left = n

    @property
    def preempted(self) -> bool:
        self.left -= 1
        return self.left < 0


def test_preempted_and_resumed_run_equals_the_straight_run(
        tmp_path, monkeypatch, capsys, restore_process_state):
    """4 steps straight against 2 steps stopped through the preemption
    path (a forced checkpoint at step 2) and resumed for 2 more: the same
    losses and the same checkpoint at step 4, every leaf bit for bit."""
    monkeypatch.setattr(t_train, "TrainConfig",
                        functools.partial(TrainConfig, checkpoint_every=4))
    kw = dict(arch="xlstm-350m", smoke=True, steps=4, batch=2, seq=16,
              device="cpu")
    straight = t_train.train(ckpt_dir=str(tmp_path / "a"), **kw)
    monkeypatch.setattr(t_train, "PreemptionHandler",
                        lambda: _PreemptAfter(1))
    first = t_train.train(ckpt_dir=str(tmp_path / "b"), **kw)
    assert "preemption requested -> checkpoint + exit" in \
        capsys.readouterr().out
    assert t_ckpt.all_steps(str(tmp_path / "b")) == [2]
    monkeypatch.setattr(t_train, "PreemptionHandler", t_ft.PreemptionHandler)
    rest = t_train.train(ckpt_dir=str(tmp_path / "b"), resume=True, **kw)
    assert "resumed from step 2" in capsys.readouterr().out
    assert first + rest == straight and len(straight) == 4
    ma, la = _ckpt_leaves(str(tmp_path / "a"), 4)
    mb, lb = _ckpt_leaves(str(tmp_path / "b"), 4)
    assert ma == mb
    for a, b in zip(la, lb):
        np.testing.assert_array_equal(np.atleast_1d(a).view(np.uint8),
                                      np.atleast_1d(b).view(np.uint8))


def test_restore_reads_the_reference_trainers_checkpoint(
        tmp_path, monkeypatch, capsys, restore_process_state):
    """The JAX package's `train` writes a checkpoint at step 1 (smoke
    starcoder2-3b, checkpoint_every 1); the port restores {"params",
    "opt", "step"} from it: every leaf of the files the reference wrote,
    by name, with its dtype, shape and bits, and the step; then the
    port's trainer resumes from it."""
    from repro.configs.base import TrainConfig as JTrain
    monkeypatch.setattr(j_train, "TrainConfig",
                        functools.partial(JTrain, checkpoint_every=1))
    d = str(tmp_path)
    j_train.train("starcoder2-3b", True, 1, 2, 16, d)
    assert t_ckpt.all_steps(d) == [1]
    cfg = load_config("starcoder2-3b", smoke=True)
    _, optimizer = TS.make_train_step(cfg, TrainConfig())
    params = TT.init(torch.Generator().manual_seed(0), cfg)
    target = {"params": params, "opt": optimizer.init(params),
              "step": torch.zeros((), dtype=torch.int32)}
    got = t_ckpt.CheckpointManager(d).restore(target)
    names, leaves = tree_lib.flatten_with_names(got)
    manifest, files = _ckpt_leaves(d, 1)
    by_name = {m["name"]: (m, a) for m, a in zip(manifest["leaves"], files)}
    assert manifest["step"] == 1 and int(got["step"]) == 1
    assert set(names) == set(by_name)
    for n, t in zip(names, leaves):
        m, a = by_name[n]
        assert str(t.dtype).removeprefix("torch.") == m["dtype"], n
        assert list(t.shape) == m["shape"], n
        tb = t.reshape(-1).view(torch.uint8).numpy() if t.dim() \
            else t.reshape(1).view(torch.uint8).numpy()
        np.testing.assert_array_equal(tb, np.atleast_1d(a).reshape(
            -1).view(np.uint8), err_msg=n)
    capsys.readouterr()
    losses = t_train.train("starcoder2-3b", True, 2, 2, 16, d, resume=True,
                           device="cpu")
    assert "resumed from step 1" in capsys.readouterr().out
    assert len(losses) == 1 and np.isfinite(losses[0])


def _shape_of(lines: list) -> list:
    """Log lines with their numbers replaced, and the step lines' times
    dropped."""
    out = []
    for line in lines:
        line = re.sub(r"\s+\d+ms$", "", line)
        out.append(re.sub(r"-?\d+(\.\d+)?", "N", line))
    return out


@pytest.mark.parametrize("entry", ["launch", "twin"])
def test_entry_point_prints_the_reference_lines(entry, tmp_path, capsys,
                                                monkeypatch,
                                                restore_process_state):
    args = ["--arch", "starcoder2-3b", "--smoke", "--steps", "4", "--batch",
            "4", "--seq", "32"]
    j_train.main(args + ["--ckpt-dir", str(tmp_path / "j")])
    want = capsys.readouterr().out.strip().splitlines()
    targs = args + ["--device", "cpu", "--ckpt-dir", str(tmp_path / "t")]
    if entry == "launch":
        t_train.main(targs)
    else:
        monkeypatch.setattr(sys, "argv", ["train_llm"] + targs)
        runpy.run_module("repro_torch.examples.train_llm",
                         run_name="__main__")
    got = capsys.readouterr().out.strip().splitlines()
    assert _shape_of(got) == _shape_of(want)
    assert len(got) == 3 and got[0].startswith("step     0 loss")
    assert got[-1].startswith("first-10 mean")


def test_no_card_and_no_device_raises(tmp_path, restore_process_state):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_train.train("starcoder2-3b", True, 1, 2, 16, str(tmp_path))


def test_model_parallel_is_not_ported(tmp_path, capsys,
                                      restore_process_state):
    """`--model-parallel 2` runs, as the reference's does: on one device
    the host mesh is (1, 1) and the log lines equal `--model-parallel 1`'s
    but for the step times (tests/test_torch_sharding.py holds the losses
    bit for bit in both packages)."""
    logs = []
    for mp in ("2", "1"):
        t_train.main(["--smoke", "--model-parallel", mp, "--device", "cpu",
                      "--steps", "2", "--batch", "2", "--seq", "16",
                      "--ckpt-dir", str(tmp_path / mp)])
        logs.append([re.sub(r"\d+ms$", "", ln) for ln in
                     capsys.readouterr().out.splitlines()])
    assert logs[0] == logs[1] and logs[0][-1].startswith("first-10 mean")
