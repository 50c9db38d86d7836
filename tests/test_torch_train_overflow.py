"""xlstm-350m's gradients overflow at full width in both packages
(ROADMAP C.R7), on the CPU.

The sLSTM's recurrent weights are (H, dh, dh) = (4, 256, 256) drawn with
a fan-in of H (`dense_init`'s shape[0]), a standard deviation of 0.5, so
the sLSTM's loop is chaotic: its gradients grow with every position, and
so do the packages' float32 rounding differences. Both packages run
xlstm-350m's full-width config cut in depth to one sLSTM layer (d =
1,024, H = 4), float32, B = 1, from the same weights (JAX's, carried
across with `params_from_numpy`). Measured: global norms ~1.4e2 at S = 8,
3e7-4e7 at S = 64, 3e14-7e14 at S = 128; at S = 256 every gradient entry is
finite but the largest are ~1e26, whose squares overflow the float32
norm.

- S = 8: the losses agree within LOSS_TOL and every gradient leaf
  within GRAD_RTOL of its largest entry (floored at GRAD_FLOOR of the
  tree's largest; measured <= 3.5e-5). From S = 32 on the amplified
  rounding parts the packages (2e-2 at S = 32, O(1) at S = 64), so
- S = 64, 128: both norms finite and past GROWTH[S], and each package's
  norm and largest entry within ORDER of the other's (measured within
  2.8x);
- S = 256: both norms infinite, every leaf finite in both, the largest
  entries within ORDER of each other; the port's train step skips the
  step (applied 0) and leaves params and state bit for bit.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import load_config as j_load_config
from repro.models import transformer as JT
from repro.models.sharding import Rules
from repro.optim.optimizers import global_norm as j_global_norm
from repro_torch import tree as tree_lib
from repro_torch.configs import load_config
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import steps as TS
from repro_torch.models import transformer as TT
from repro_torch.optim import global_norm

torch.set_num_threads(1)

LOSS_TOL = 2e-5
GRAD_RTOL = 1e-4
GRAD_FLOOR = 1e-3
ORDER = 10.0
GROWTH = {64: 1e6, 128: 1e12}
RULES = Rules(batch=(), fsdp=(), tensor=(), expert=())
CUT = dict(n_layers=1, slstm_every=1, dtype="float32",
           param_dtype="float32")


@pytest.fixture(scope="module")
def weights():
    jc = dataclasses.replace(j_load_config("xlstm-350m", False), **CUT)
    tc = dataclasses.replace(load_config("xlstm-350m", False), **CUT)
    assert jc.layer_types() == tc.layer_types() == ("slstm",)
    assert (jc.d_model, jc.n_heads) == (1024, 4)
    jp = JT.init(jax.random.PRNGKey(0), jc)
    tp = TT.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tc,
                              "cpu")
    return jc, tc, jp, tp


def _batch(vocab: int, s: int) -> dict:
    rng = np.random.default_rng(s)
    return {k: rng.integers(0, vocab, (1, s)).astype(np.int32)
            for k in ("tokens", "labels")}


def _both(weights, s: int):
    jc, tc, jp, tp = weights
    mb = _batch(jc.vocab_size, s)
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, jc, b, RULES), has_aux=True))(jp, mb)
    tloss, tg = TS._grads(tp, tc, {k: torch.from_numpy(v)
                                   for k, v in mb.items()})
    names, jl = tree_lib.flatten_with_names(
        jax.tree_util.tree_map(np.asarray, jg))
    return (float(jloss), float(j_global_norm(jg)), names, jl,
            float(tloss), float(global_norm(tg)), [g.numpy() for g in tg],
            mb)


def _close(names, got, want):
    top = max(float(np.abs(w).max()) for w in want)
    for n, g, w in zip(names, got, want):
        scale = max(float(np.abs(w).max()), GRAD_FLOOR * top)
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_RTOL * scale,
                                   err_msg=n)


def _same_order(a: float, b: float) -> bool:
    return b / ORDER <= a <= b * ORDER


def test_gradients_agree_before_the_loop_amplifies(weights):
    jloss, jnorm, names, jl, tloss, tnorm, tl, _ = _both(weights, 8)
    assert abs(tloss - jloss) <= LOSS_TOL
    _close(names, tl, jl)


@pytest.mark.parametrize("s", sorted(GROWTH))
def test_gradients_grow_alike_in_both_packages(weights, s):
    jloss, jnorm, names, jl, tloss, tnorm, tl, _ = _both(weights, s)
    assert np.isfinite(jnorm) and np.isfinite(tnorm)
    assert jnorm > GROWTH[s] and tnorm > GROWTH[s]
    assert _same_order(tnorm, jnorm)
    assert _same_order(max(float(np.abs(g).max()) for g in tl),
                       max(float(np.abs(w).max()) for w in jl))


def test_gradients_overflow_in_both_packages_and_the_step_skips(weights):
    jloss, jnorm, names, jl, tloss, tnorm, tl, mb = _both(weights, 256)
    assert np.isfinite(jloss) and np.isfinite(tloss)
    assert not np.isfinite(jnorm) and not np.isfinite(tnorm)
    assert all(np.isfinite(x).all() for x in jl + tl)
    assert _same_order(max(float(np.abs(g).max()) for g in tl),
                       max(float(np.abs(w).max()) for w in jl))

    jc, tc, jp, tp = weights
    step, opt = TS.make_train_step(tc, TrainConfig())
    params = tree_lib.tree_map(torch.clone, tp)
    state = opt.init(params)
    before = [x.clone() for x in tree_lib.leaves((params, state))]
    batch = {k: torch.from_numpy(v)[None] for k, v in mb.items()}
    params, state, m = step(params, state, batch)
    assert float(m["applied"]) == 0.0
    assert not np.isfinite(float(m["grad_norm"]))
    for a, b in zip(before, tree_lib.leaves((params, state))):
        assert torch.equal(a, b)
