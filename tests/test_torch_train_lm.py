"""Parity of the port's LM loss and the train step's execution knobs
(`repro_torch.models.transformer.loss_fn`, `repro_torch.launch.steps`:
`adapt_config`, `microbatch_for`, `optimizer_for`) with the JAX
package's, on the CPU; the train step itself is
tests/test_torch_train_step.py.

Weights and optimizer state cross over from the JAX package as numpy
arrays (`transformer.params_from_numpy`, `optim.state_from_numpy`), so
both packages start from the same bits; the JAX side runs under
`jax.jit`. Every family of smoke config runs in float32 (`dtype` and
`param_dtype` replaced). Tolerances:

- loss: LOSS_TOL absolute (measured <= 1.1e-5, deepseek-moe-16b's aux
  terms the largest).
- gradients: GRAD_RTOL of each leaf's largest entry, floored at
  GRAD_FLOOR of the tree's largest entry (a leaf whose true gradient is
  0, as the sLSTM's input-gate bias, holds rounding noise).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import load_config as j_load_config
from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import TrainConfig as JTrain
from repro.launch import steps as JS
from repro.models import transformer as JT
from repro.models.sharding import Rules
from repro_torch import tree as tree_lib
from repro_torch.configs import ARCHS, SHAPES, load_config
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.launch import steps as TS
from repro_torch.models import transformer as TT


torch.set_num_threads(1)

LOSS_TOL = 2e-5
GRAD_RTOL = 1e-4
GRAD_FLOOR = 1e-3
RULES = Rules(batch=(), fsdp=(), tensor=(), expert=())
LM_ARCHS = tuple(a for a in ARCHS
                 if hasattr(load_config(a, True), "n_layers"))
B, S = 2, 16


def _cfgs(arch: str, **kw):
    f32 = dict(dtype="float32", param_dtype="float32", **kw)
    return (dataclasses.replace(j_load_config(arch, True), **f32),
            dataclasses.replace(load_config(arch, True), **f32))


def _np_tree(jtree):
    return jax.tree_util.tree_map(np.asarray, jtree)


def _batch(cfg, accum: int, seed: int) -> dict:
    """(accum, B, S) inputs in the config's input mode and labels with
    some -1 (masked) entries, numpy."""
    rng = np.random.default_rng(seed)
    lead = (accum, B, S)
    if cfg.input_mode == "tokens":
        b = {"tokens": rng.integers(0, cfg.vocab_size, lead).astype(
            np.int32)}
    else:
        b = {"embeddings": rng.standard_normal(
            lead + (cfg.d_model,)).astype(np.float32)}
        if cfg.rope_type == "mrope":
            b["positions3"] = rng.integers(0, 3 * S, lead + (3,)).astype(
                np.int32)
    b["labels"] = rng.integers(-1, cfg.vocab_size, lead).astype(np.int32)
    b["labels"][..., :2] = -1
    return b


def _t(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _scaled_close(got: list, want: list, rtol: float, names: list,
                  atol: float = 0.0, floor: float = GRAD_FLOOR) -> None:
    top = max(float(np.abs(w).max()) for w in want if w.size)
    for n, g, w in zip(names, got, want):
        if not w.size:
            continue
        scale = max(float(np.abs(w).max()), floor * top)
        np.testing.assert_allclose(g, w, rtol=0, atol=rtol * scale + atol,
                                   err_msg=n)


def _leaves(tree) -> tuple[list, list]:
    names, leaves = tree_lib.flatten_with_names(tree)
    return names, [x.detach().float().numpy() if isinstance(x, torch.Tensor)
                   else np.asarray(x).astype(np.float32) for x in leaves]


# -- the execution knobs ---------------------------------------------------


def test_adapt_config_and_microbatch_match_the_reference():
    """Every arch of configs.ARCHS at the reference's shapes (and a few
    custom ones), at data-parallel widths 1 and 8: the same adapted
    config field for field, the same microbatch."""
    assert ARCHS == J_ARCHS
    shapes = [(SHAPES[k], J_SHAPES[k]) for k in SHAPES]
    shapes += [(ShapeConfig("c", s, b, kind, mb),
                JShape("c", s, b, kind, mb))
               for s, b, kind, mb in ((128, 8, "train", 0),
                                      (1024, 8, "train", 4),
                                      (32768, 2, "train", 0),
                                      (16, 3, "decode", 0))]
    for arch in LM_ARCHS:
        for smoke in (False, True):
            jc, tc = j_load_config(arch, smoke), load_config(arch, smoke)
            for ts, js in shapes:
                for dp in (1, 8):
                    got = TS.adapt_config(tc, ts, dp)
                    want = JS.adapt_config(jc, js, dp)
                    assert dataclasses.asdict(got) == dataclasses.asdict(
                        want), (arch, ts, dp)
                assert TS.microbatch_for(tc, ts) == JS.microbatch_for(jc, js)


@pytest.mark.parametrize("name", ["starcoder2-3b", "llama3-405b",
                                  "qwen1.5-110b", "command-r-plus-104b",
                                  "deepseek-v3-671b"])
@pytest.mark.parametrize("optimizer", ["adamw", "adamw8bit", "sgd"])
def test_optimizer_for_matches_the_reference(name, optimizer):
    """The optimizer the arch's name calls for (ARCH_OPTIMIZER: AdamW with
    bf16 moments, adafactor) or the TrainConfig's: the same state, leaf
    names, shapes and dtypes, on a small tree."""
    jc = dataclasses.replace(j_load_config("starcoder2-3b", True), name=name)
    tc = dataclasses.replace(load_config("starcoder2-3b", True), name=name)
    params = {"w": np.ones((4, 300), np.float32),
              "b": np.ones(5, np.float32)}
    js = JS.optimizer_for(jc, JTrain(optimizer=optimizer)).init(params)
    ts = TS.optimizer_for(tc, TrainConfig(optimizer=optimizer)).init(
        tree_lib.tree_map(torch.from_numpy, params))
    jn, jl = tree_lib.flatten_with_names(_np_tree(js))
    tn, tl = tree_lib.flatten_with_names(ts)
    assert jn == tn
    for a, t in zip(jl, tl):
        assert tuple(t.shape) == a.shape
        assert str(t.dtype).removeprefix("torch.") == a.dtype.name


# -- the loss and its gradients ----------------------------------------------


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_and_gradients_match(arch):
    jc, tc = _cfgs(arch)
    jp = JT.init(jax.random.PRNGKey(0), jc)
    tp = TT.params_from_numpy(_np_tree(jp), tc, "cpu")
    mb = {k: v[0] for k, v in _batch(jc, 1, 1).items()}
    (jloss, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, jc, b, RULES), has_aux=True))(jp, mb)
    tloss, tg = TS._grads(tp, tc, _t(mb))
    _, taux = TT.loss_fn(tp, tc, _t(mb))
    assert abs(float(tloss) - float(jloss)) <= LOSS_TOL
    assert set(taux) == set(jaux) == {"nll", "load_balance"}
    assert abs(float(taux["load_balance"]) - float(jaux["load_balance"])) \
        <= LOSS_TOL
    names, want = _leaves(jg)
    _scaled_close([g.numpy() for g in tg], want, GRAD_RTOL, names)


def test_loss_of_an_all_masked_batch_is_zero():
    """max(mask.sum(), 1): no position counts, the loss is 0 (MoE: its
    aux terms alone), as the reference's."""
    jc, tc = _cfgs("starcoder2-3b")
    jp = JT.init(jax.random.PRNGKey(0), jc)
    tp = TT.params_from_numpy(_np_tree(jp), tc, "cpu")
    mb = {k: v[0] for k, v in _batch(jc, 1, 2).items()}
    mb["labels"][:] = -1
    jl, _ = JT.loss_fn(jp, jc, mb, RULES)
    tl, _ = TT.loss_fn(tp, tc, _t(mb))
    assert float(tl) == float(jl) == 0.0
