"""The LM's gradients at kinks and ties against jax.grad (ROADMAP C.P9),
on the CPU in float32: `core/kinks.cummax` (jax.lax.cummax, which JAX
differentiates as `associative_scan(max)`: a tie splits its gradient in
half at each level), `kinks.softplus` (jax.nn.softplus = logaddexp(x, 0),
gradient exp(x - out): 0.5 at 0) and `kinks.abs` (+1 at 0) at the sites
of `models/ssm.py` that use them, on inputs built so that the ties and
zeros occur; then the gradients of `mlstm_apply_seq`, `slstm_apply_seq`
and `mamba_apply_seq` and of the chunked attention on random inputs.

Tolerances: the running max's gradient and the softplus gradient at 0
are exact (sums of halves), compared bit for bit; elsewhere GRAD_RTOL of
each gradient leaf's largest entry, that scale floored at GRAD_FLOOR of
the whole tree's largest entry (measured on random inputs: mLSTM 1.8e-6,
sLSTM 8.6e-7, Mamba 5.8e-7 of the leaf's largest entry; the sLSTM's
input-gate bias alone, whose true gradient is 0 since the normaliser
cancels a shift shared by every step, holds rounding noise: 1.0e-8 of
the tree's). The JAX side runs under `jax.jit`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import load_config as j_load_config
from repro.models import layers as JL
from repro.models import ssm as JS
from repro_torch import tree as tree_lib
from repro_torch.configs import load_config
from repro_torch.core import kinks
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TS

torch.set_num_threads(1)

GRAD_RTOL = 2e-5
GRAD_FLOOR = 1e-3


def _cfgs(arch: str):
    f32 = dict(dtype="float32", param_dtype="float32")
    return (dataclasses.replace(j_load_config(arch, True), **f32),
            dataclasses.replace(load_config(arch, True), **f32))


def _leaves_np(jtree) -> list:
    return [np.asarray(a) for a in tree_lib.leaves(
        jax.tree_util.tree_map(np.asarray, jtree))]


def _torch_tree(jtree):
    return tree_lib.tree_map(lambda a: torch.tensor(np.asarray(a)),
                             jax.tree_util.tree_map(np.asarray, jtree))


def _port_grads(fn, args: tuple) -> list:
    """torch.autograd.grad of fn(*args) (a scalar) with respect to every
    tensor leaf of args, in visiting order."""
    leaves = [a.detach().clone().requires_grad_()
              for a in tree_lib.leaves(list(args))]
    out = fn(*tree_lib.unflatten(list(args), leaves))
    return [g.numpy() for g in torch.autograd.grad(out, leaves,
                                                   allow_unused=True,
                                                   materialize_grads=True)]


def _assert_grads_close(got: list, want: list, rtol: float = GRAD_RTOL):
    top = max(float(np.abs(w).max()) for w in want)
    for i, (g, w) in enumerate(zip(got, want)):
        scale = max(float(np.abs(w).max()), GRAD_FLOOR * top)
        np.testing.assert_allclose(g, w, rtol=0, atol=rtol * scale,
                                   err_msg=f"leaf {i}")


# -- the primitives --------------------------------------------------------


def test_cummax_splits_a_tie_as_jax():
    a = torch.tensor([1.0, 1.0, 0.5, 2.0, 2.0], requires_grad=True)
    (kinks.cummax(a, 0) * torch.arange(1.0, 6.0)).sum().backward()
    assert a.grad.tolist() == [3.5, 2.5, 0.0, 6.5, 2.5]
    j = jax.grad(lambda x: (jax.lax.cummax(x) * jnp.arange(1.0, 6.0)).sum())(
        jnp.array([1.0, 1.0, 0.5, 2.0, 2.0]))
    np.testing.assert_array_equal(np.asarray(j), a.grad.numpy())


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13, 64])
def test_cummax_matches_jax_bit_for_bit(n):
    """Values drawn from {0, 1, 2} (ties everywhere), along the middle
    axis of a 3-D tensor, weighted by a random cotangent."""
    rng = np.random.default_rng(n)
    a = rng.integers(0, 3, (2, n, 3)).astype(np.float32)
    w = rng.standard_normal((2, n, 3)).astype(np.float32)
    want_v = jax.lax.cummax(a, axis=1)
    want_g = jax.grad(lambda x: (jax.lax.cummax(x, axis=1) * w).sum())(a)
    t = torch.tensor(a, requires_grad=True)
    v = kinks.cummax(t, 1)
    (v * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(v.detach().numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want_g))
    assert torch.equal(v, torch.cummax(t.detach(), 1).values)


def test_softplus_value_and_gradient_match_jax():
    x = np.array([0.0, -0.0, 1e-3, -1.0, 2.0, 30.0, -30.0, 90.0, -90.0],
                 np.float32)
    t = torch.tensor(x, requires_grad=True)
    y = kinks.softplus(t)
    y.sum().backward()
    want = jax.jit(jax.nn.softplus)(x)
    want_g = jax.jit(jax.grad(lambda v: jax.nn.softplus(v).sum()))(x)
    # XLA:CPU flushes subnormal results to 0 (softplus(-90) ~ 8e-40):
    # atol is the smallest normal float32
    tiny = float(np.finfo(np.float32).tiny)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=tiny)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_g),
                               rtol=1e-6, atol=tiny)
    assert t.grad[0] == 0.5 and t.grad[1] == 0.5


def test_abs_gradient_at_zero_is_one():
    t = torch.tensor([0.0, -0.0, -2.0, 3.0], requires_grad=True)
    kinks.abs(t).sum().backward()
    want = jax.grad(lambda v: jnp.abs(v).sum())(jnp.array([0.0, -0.0, -2.0,
                                                           3.0]))
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))


# -- the sites of models/ssm.py, on inputs that reach the kinks ------------


def _mlstm_at_kinks(jc):
    """mLSTM weights with zero keys (so n.q = 0), constant gates (so the
    stabiliser's running max ties at every position: log f = 0 in
    float32) and an input gate of 200 (so exp(-m) = 0 and the
    normaliser's max(|n.q|, exp(-m)) ties at 0), and a state with C
    random, n = 0 and m = 200 (the running max ties m too)."""
    p = JS.mlstm_init(jax.random.PRNGKey(3), jc, jnp.float32)
    H = jc.n_heads
    p = {**p, "wk": jnp.zeros_like(p["wk"]),
         "w_gates": jnp.zeros_like(p["w_gates"]),
         "gate_bias": jnp.concatenate([jnp.full((H,), 200.0),
                                       jnp.full((H,), 100.0)])}
    B, dh = 2, 2 * jc.d_model // H
    rng = np.random.default_rng(0)
    state = {"C": rng.standard_normal((B, H, dh, dh)).astype(np.float32),
             "n": np.zeros((B, H, dh), np.float32),
             "m": np.full((B, H), 200.0, np.float32)}
    return p, state


@pytest.mark.parametrize("form", ["seq", "step"])
def test_mlstm_gradients_at_ties_and_zeros(form):
    jc, tc = _cfgs("xlstm-350m")
    p, state = _mlstm_at_kinks(jc)
    S = 8 if form == "seq" else 1
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, S, jc.d_model)).astype(np.float32)
    w = rng.standard_normal((2, S, jc.d_model)).astype(np.float32)
    jfn = JS.mlstm_apply_seq if form == "seq" else JS.mlstm_apply_step
    tfn = TS.mlstm_apply_seq if form == "seq" else TS.mlstm_apply_step

    def j_loss(p, x, st):
        y, new = jfn(p, x, jc, st)
        return (y * w).sum() + new["n"].sum() + new["C"].sum()

    def t_loss(p, x, st):
        y, new = tfn(p, x, tc, st)
        return ((y * torch.from_numpy(w)).sum() + new["n"].sum()
                + new["C"].sum())
    want = _leaves_np(jax.jit(jax.grad(j_loss, argnums=(0, 1, 2)))(
        p, x, state))
    got = _port_grads(t_loss, (_torch_tree(p), torch.from_numpy(x),
                               _torch_tree(state)))
    _assert_grads_close(got, want)
    # the kinks are reached: the state n's gradient comes only through
    # |n.q| at 0 (torch.abs would give 0 there)
    n_grad = got[-2]
    assert np.abs(n_grad).max() > 0


def test_slstm_gradients_at_zero_normaliser():
    """An input gate of -200 (exp underflows: the step adds nothing to n)
    over a state with n = 0: h = o c / (|n| + 1e-6) meets |x| at 0."""
    jc, tc = _cfgs("xlstm-350m")
    p = JS.slstm_init(jax.random.PRNGKey(4), jc, jnp.float32)
    p = {**p, "b_i": jnp.full_like(p["b_i"], -200.0)}
    H, dh = jc.n_heads, jc.d_model // jc.n_heads
    rng = np.random.default_rng(2)
    xw = {g: rng.standard_normal((2, H, dh)).astype(np.float32)
          for g in "zifo"}
    state = {"c": rng.standard_normal((2, H, dh)).astype(np.float32),
             "n": np.zeros((2, H, dh), np.float32),
             "h": rng.standard_normal((2, H, dh)).astype(np.float32),
             "m": np.zeros((2, H, dh), np.float32)}
    w = rng.standard_normal((2, H, dh)).astype(np.float32)

    def j_loss(p, xw, st):
        return (JS._slstm_cell(p, xw, st)["h"] * w).sum()

    def t_loss(p, xw, st):
        return (TS._slstm_cell(p, xw, st)["h"] * torch.from_numpy(w)).sum()
    want = _leaves_np(jax.jit(jax.grad(j_loss, argnums=(0, 1, 2)))(
        p, xw, state))
    got = _port_grads(t_loss, (_torch_tree(p), _torch_tree(xw),
                               _torch_tree(state)))
    _assert_grads_close(got, want)


def test_mamba_gradient_at_softplus_zero():
    """dt = softplus(0) at every position (dt_proj and dt_bias zero): the
    dt_bias gradient weighs each position's by 0.5, as JAX's."""
    jc, tc = _cfgs("hymba-1.5b")
    p = JS.mamba_init(jax.random.PRNGKey(5), jc, jnp.float32)
    p = {**p, "dt_proj": jnp.zeros_like(p["dt_proj"]),
         "dt_bias": jnp.zeros_like(p["dt_bias"])}
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, jc.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 6, jc.d_model)).astype(np.float32)
    want = _leaves_np(jax.jit(jax.grad(
        lambda p, x: (JS.mamba_apply_seq(p, x, jc)[0] * w).sum(),
        argnums=(0, 1)))(p, x))
    got = _port_grads(
        lambda p, x: (TS.mamba_apply_seq(p, x, tc)[0]
                      * torch.from_numpy(w)).sum(),
        (_torch_tree(p), torch.from_numpy(x)))
    _assert_grads_close(got, want)


# -- random inputs ---------------------------------------------------------


@pytest.mark.parametrize("block", ["mlstm", "slstm", "mamba"])
def test_recurrent_block_gradients_match(block):
    arch = "hymba-1.5b" if block == "mamba" else "xlstm-350m"
    jc, tc = _cfgs(arch)
    p = getattr(JS, f"{block}_init")(jax.random.PRNGKey(1), jc, jnp.float32)
    rng = np.random.default_rng(0)
    S = 128 if block == "mlstm" else 32
    x = rng.standard_normal((2, S, jc.d_model)).astype(np.float32)
    w = rng.standard_normal((2, S, jc.d_model)).astype(np.float32)
    jfn = getattr(JS, f"{block}_apply_seq")
    tfn = getattr(TS, f"{block}_apply_seq")
    want = _leaves_np(jax.jit(jax.grad(
        lambda p, x: (jfn(p, x, jc)[0] * w).sum(), argnums=(0, 1)))(p, x))
    got = _port_grads(
        lambda p, x: (tfn(p, x, tc)[0] * torch.from_numpy(w)).sum(),
        (_torch_tree(p), torch.from_numpy(x)))
    _assert_grads_close(got, want)


def test_chunked_attention_gradients_match():
    """The online softmax over kv chunks (its floor is jnp.maximum's)."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 16, 4, 8), (2, 16, 2, 8), (2, 16, 2, 8)))
    w = rng.standard_normal((2, 16, 4, 8)).astype(np.float32)
    pos = np.arange(16, dtype=np.int32)

    def j_loss(q, k, v):
        return (JL.dot_attention(q, k, v, qpos=pos, kpos=pos, window=6,
                                 chunk=4) * w).sum()

    def t_loss(q, k, v):
        p = torch.from_numpy(pos)
        return (TL.dot_attention(q, k, v, qpos=p, kpos=p, window=6,
                                 chunk=4) * torch.from_numpy(w)).sum()
    want = _leaves_np(jax.jit(jax.grad(j_loss, argnums=(0, 1, 2)))(q, k, v))
    got = _port_grads(t_loss, tuple(torch.from_numpy(a) for a in (q, k, v)))
    _assert_grads_close(got, want)
