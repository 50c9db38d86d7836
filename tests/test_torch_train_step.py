"""Parity of the port's LM train step (`repro_torch.launch.steps.
make_train_step`) with the JAX package's, on the CPU, and its in-place
update against the plain computation.

Weights and optimizer state cross over from the JAX package as numpy
arrays (`transformer.params_from_numpy`, `optim.state_from_numpy`), so
both packages start from the same bits; the JAX side runs under
`jax.jit`, in float32 (`dtype` and `param_dtype` replaced). Cases: accum
1 and 2 (dense, MoE, xLSTM), int8 error feedback, the adafactor route
and AdamW's bf16 moments (configs named deepseek-v3-671b and
llama3-405b: ARCH_OPTIMIZER keys on those names), adamw8bit. Tolerances,
after two steps:

- loss: LOSS_TOL absolute; grad_norm: rtol NORM_RTOL (measured <= 7e-6).
- parameters within PARAM_RTOL of the leaf's largest entry plus
  PARAM_LR_ATOL x lr x steps: AdamW's first steps move each weight by
  about lr x g / |g|, so a difference in the last bits of a small
  gradient moves its weight by a share of lr (measured: <= 2.9e-4 of
  the leaf's largest entry, xlstm-350m's mLSTM projections; <= 1e-4
  elsewhere).
- optimizer state leaves within STATE_RTOL of the leaf's largest entry,
  (measured <= 2.2e-4, xlstm-350m's moments: its recurrent gradients
  carry ~3e-5 of rounding; <= 1e-4 elsewhere); bf16 moments within
  STATE_BF16_RTOL (one bf16 ulp of the largest entry); adamw8bit's int8
  blocks within one count. Under the int8 codec a gradient entry on one
  of its rounding boundaries is decompressed one quantum (1/127 of the
  leaf's absmax) apart in the two packages (measured: 1 entry in
  16,384): its residual and moments are held as above but for one
  entry or EF_FLIP_SHARE of a leaf's entries (whichever is more), which
  are within one quantum (the residual) or 2% of the leaf's largest
  entry (the moments).
- the guard's skip, and the in-place update against the out-of-place
  computation, bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import load_config as j_load_config
from repro.configs.base import TrainConfig as JTrain
from repro.launch import steps as JS
from repro.models import transformer as JT
from repro.models.sharding import Rules
from repro_torch import tree as tree_lib
from repro_torch.configs import load_config
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import steps as TS
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.optim import clip_by_global_norm, state_from_numpy

torch.set_num_threads(1)

LOSS_TOL = 2e-5
NORM_RTOL = 2e-5
GRAD_FLOOR = 1e-3
PARAM_RTOL = 5e-4
PARAM_LR_ATOL = 0.05
STATE_RTOL = 5e-4
STATE_BF16_RTOL = 2**-7
EF_FLIP_SHARE = 1e-3
RULES = Rules(batch=(), fsdp=(), tensor=(), expert=())
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


# -- the train step ----------------------------------------------------------

STEP_CASES = {
    # name: (arch, accum, TrainConfig overrides, config overrides, steps)
    "dense_accum1": ("starcoder2-3b", 1, {}, {}, 2),
    "dense_accum2": ("starcoder2-3b", 2, {}, {}, 2),
    "moe_accum2": ("deepseek-moe-16b", 2, {}, {}, 2),
    "xlstm_accum1": ("xlstm-350m", 1, {}, {}, 2),
    "int8_feedback": ("starcoder2-3b", 2, {"grad_compression": "int8"}, {},
                      2),
    "adafactor": ("starcoder2-3b", 1, {}, {"name": "deepseek-v3-671b"}, 2),
    "bf16_moments": ("llama3-405b", 2, {}, {"name": "llama3-405b"}, 2),
    # one step: a second reads int8 moments, where a block entry one
    # count apart (a rounding boundary) moves its weight by up to a few lr
    "adamw8bit": ("qwen2-vl-7b", 1, {"optimizer": "adamw8bit"}, {}, 1),
}


def _flips_allowed(entries: np.ndarray) -> int:
    """One entry, or EF_FLIP_SHARE of the leaf's, whichever is more."""
    return max(1, int(EF_FLIP_SHARE * entries.size))


def _few_quanta_apart(n: str, got: np.ndarray, want: np.ndarray) -> None:
    """The int8 codec's residual: equal within STATE_RTOL of the leaf's
    largest entry but for at most `_flips_allowed` entries, each within
    one quantum (a residual lies within half a quantum of 0, so
    the leaf's largest entry is about half of one)."""
    scale = float(np.abs(want).max())
    off = np.abs(got - want) > STATE_RTOL * scale
    assert off.sum() <= _flips_allowed(off), n
    assert np.abs(got - want).max() <= 2 * scale * (1 + 1e-3), n


def _codec_flips(n: str, got: np.ndarray, want: np.ndarray, atol: float,
                 scale: float) -> None:
    """A moment under the int8 codec: within atol but for at most
    `_flips_allowed` entries (a gradient entry on a rounding boundary
    of the codec is one quantum, 1/127 of its leaf's absmax, apart), each
    within 2% of the leaf's largest entry."""
    off = np.abs(got - want) > atol
    assert off.sum() <= _flips_allowed(off), n
    assert np.abs(got - want).max() <= 0.02 * scale, n


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_the_reference(case):
    """Train steps from the JAX package's params and state: loss,
    grad_norm, applied, every parameter and every state leaf."""
    arch, accum, tkw, ckw, steps = STEP_CASES[case]
    jc, tc = _cfgs(arch, **ckw)
    lr = 1e-3
    jstep, jopt = JS.make_train_step(jc, JTrain(learning_rate=lr, **tkw),
                                     RULES)
    tstep, _ = TS.make_train_step(tc, TrainConfig(learning_rate=lr, **tkw))
    jp = JT.init(jax.random.PRNGKey(0), jc)
    js = jopt.init(jp)
    tp = TT.params_from_numpy(_np_tree(jp), tc, "cpu")
    ts = state_from_numpy(_np_tree(js), "cpu")
    jf = jax.jit(jstep)
    for step in range(steps):
        batch = _batch(jc, accum, 10 + step)
        jp, js, jm = jf(jp, js, batch)
        tp2, ts2, tm = tstep(tp, ts, _t(batch))
        assert tp2 is tp and ts2 is ts           # donated: written in place
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_TOL
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=NORM_RTOL)
        assert float(tm["applied"]) == float(jm["applied"]) == 1.0
    names, want = _leaves(jp)
    _, got = _leaves(tp)
    assert names == tree_lib.flatten_with_names(tp)[0]
    _scaled_close(got, want, PARAM_RTOL, names,
                  atol=PARAM_LR_ATOL * lr * steps, floor=0.0)
    snames, swant = _leaves(js)
    tnames, sgot = _leaves(ts)
    assert snames == tnames
    q8 = [n.endswith("//q") for n in snames]
    for n, g, w, is_q in zip(snames, sgot, swant, q8):
        if is_q:
            assert np.abs(g - w).max() <= 1, n
    bf16 = [x.dtype == torch.bfloat16 for x in tree_lib.leaves(ts)]
    rest = [(n, g, w, STATE_BF16_RTOL if b else STATE_RTOL)
            for n, g, w, is_q, b in zip(snames, sgot, swant, q8, bf16)
            if not is_q and not n.endswith("step")
            and not n.startswith("ef_residual")]
    tops = {}
    for n, _, w, _ in rest:
        part = n.split("//")[0]
        tops[part] = max(tops.get(part, 0.0), float(np.abs(w).max()))
    for n, g, w, tol in rest:
        top = tops[n.split("//")[0]]
        scale = max(float(np.abs(w).max()), GRAD_FLOOR * top)
        if "grad_compression" in tkw:
            _codec_flips(n, g, w, tol * scale, scale)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale,
                                       err_msg=n)
    for n, g, w in zip(snames, sgot, swant):
        if n.startswith("ef_residual"):
            _few_quanta_apart(n, g, w)
    assert int(ts["step"]) == int(js["step"]) == steps


def test_power_of_two_accum_divides_as_the_jitted_reference():
    """g / accum: at accum 2 (a power of two) the port's once-rounded
    division (`layers.div`) equals the jitted reference's product by the
    reciprocal bit for bit (ROADMAP C.R5), bf16 and float32."""
    rng = np.random.default_rng(0)
    for dt in (jnp.float32, jnp.bfloat16):
        g = jnp.asarray(rng.standard_normal(4096) * 1e3, dt)
        want = np.asarray(jax.jit(lambda x: x / 2)(g))
        got = TL.div(tree_lib.tensor_of(np.asarray(g), "cpu"), 2)
        if dt == jnp.bfloat16:
            got, want = got.view(torch.int16).numpy(), want.view(np.int16)
        np.testing.assert_array_equal(np.asarray(got), want)


def test_guard_skips_a_non_finite_step_bit_for_bit():
    """An inf in one weight: loss and grad_norm are not finite, applied
    is 0 and every parameter and state leaf keeps its bits, in both
    packages."""
    jc, tc = _cfgs("starcoder2-3b")
    jstep, jopt = JS.make_train_step(jc, JTrain(learning_rate=1e-3), RULES)
    tstep, _ = TS.make_train_step(tc, TrainConfig(learning_rate=1e-3))
    jp = JT.init(jax.random.PRNGKey(0), jc)
    jp["groups"][0]["mlp"]["w1"] = jp["groups"][0]["mlp"]["w1"].at[
        0, 0, 0].set(jnp.inf)
    js = jopt.init(jp)
    tp = TT.params_from_numpy(_np_tree(jp), tc, "cpu")
    ts = state_from_numpy(_np_tree(js), "cpu")
    before = [x.clone() for x in tree_lib.leaves((tp, ts))]
    batch = _batch(jc, 1, 3)
    jp2, js2, jm = jax.jit(jstep)(jp, js, batch)
    _, _, tm = tstep(tp, ts, _t(batch))
    assert float(tm["applied"]) == float(jm["applied"]) == 0.0
    assert not np.isfinite(float(tm["loss"]))
    for a, b in zip(tree_lib.leaves(_np_tree((jp, js))),
                    tree_lib.leaves(_np_tree((jp2, js2)))):
        np.testing.assert_array_equal(np.atleast_1d(a).view(np.uint8),
                                      np.atleast_1d(b).view(np.uint8))
    for a, b in zip(before, tree_lib.leaves((tp, ts))):
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))


def test_update_in_place_equals_the_out_of_place_computation():
    """The step's leaf-by-leaf update written into the given tensors
    equals the plain out-of-place computation (clip, optimizer.update over the whole
    tree, (p + u).to(p.dtype)) bit for bit, in bf16."""
    tc = load_config("starcoder2-3b", True)
    gen = torch.Generator().manual_seed(0)
    params0 = TT.init(gen, tc)
    batch = _t(_batch(tc, 2, 4))
    step, opt = TS.make_train_step(tc, TrainConfig(learning_rate=1e-3))
    params = tree_lib.tree_map(torch.clone, params0)
    state = opt.init(params)
    for _ in range(2):
        params, state, _ = step(params, state, batch)
    got = tree_lib.leaves((params, state))
    # the plain computation
    step, opt = TS.make_train_step(tc, TrainConfig(learning_rate=1e-3))
    params = tree_lib.tree_map(torch.clone, params0)
    state = opt.init(params)
    for _ in range(2):
        grads = []
        losses = []
        for i in range(2):
            loss, g = TS._grads(params, tc, {k: v[i]
                                             for k, v in batch.items()})
            grads.append(g)
            losses.append(loss)
        g = [TL.div(a + b, 2) for a, b in zip(*grads)]
        g, _ = clip_by_global_norm(tree_lib.unflatten(params, g), 1.0)
        upd, state = opt.update(g, state, params)
        params = tree_lib.tree_map(lambda p, u: (p + u).to(p.dtype), params,
                                   upd)
    plain = tree_lib.leaves((params, state))
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
