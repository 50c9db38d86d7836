"""The other optimizers of the port (`adamw8bit`, `adafactor`, `sgd`,
`make_optimizer`; `repro_torch.optim`) against the JAX package, on the CPU,
on identical gradients.

The JAX side runs eagerly: each operation is then its own XLA kernel, as
each is its own kernel in PyTorch, so the elementwise arithmetic rounds at
the same places. Tolerances:
  * sgd, and adamw8bit's int8 moments and scales: bit for bit (the same
    roundings in the same order).
  * updates, and adafactor's factors: within 1e-5 of each leaf's largest
    entry (OPTIM_RTOL). The bias corrections' and adafactor's powers, and
    the warmup-cosine schedule's cosine, come from other libm's, and
    adafactor's row / column means sum in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as j_optim
from repro_torch import tree as tree_lib
from repro_torch.optim import optimizers as t_optim

torch.set_num_threads(1)

OPTIM_RTOL = 1e-5
STEPS = 4


def _params(rng):
    """A small tree of the shapes a controller has: 4-D convolutions, a
    matrix, vectors, and sizes that are and are not a multiple of the
    8-bit optimizer's 256-element block."""
    shapes = {"conv": (3, 3, 4, 8), "proj": (16, 24), "b": (24,),
              "blocks": [(512,), (5, 7)]}
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))


def _close(got, want, rtol=OPTIM_RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= rtol * scale, (
        np.abs(got - want).max(), scale)


def _run(name, lr_j, lr_t, kw, check_state):
    """STEPS updates of both packages on the same gradients, each package
    on its own parameters; the updates within OPTIM_RTOL, the state by
    `check_state(torch_state, jax_state)`."""
    rng = np.random.default_rng(len(name))
    params = _params(rng)
    oj = j_optim.make_optimizer(name, lr_j, **kw)
    ot = t_optim.make_optimizer(name, lr_t, **kw)
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    pt = tree_lib.tree_map(torch.as_tensor, params)
    sj, st = oj.init(pj), ot.init(pt)
    for step in range(STEPS):
        g = jax.tree_util.tree_map(
            lambda p: rng.standard_normal(p.shape).astype(np.float32)
            * 10.0 ** -step, params)
        uj, sj = oj.update(jax.tree_util.tree_map(jnp.asarray, g), sj, pj)
        ut, st = ot.update(tree_lib.tree_map(torch.as_tensor, g), st, pt)
        for a, b in zip(tree_lib.leaves(ut), jax.tree_util.tree_leaves(uj)):
            _close(a, b)
        check_state(st, sj)
        assert int(st["step"]) == int(sj["step"]) == step + 1
        assert st["step"].dtype == torch.int32
        pj = jax.tree_util.tree_map(lambda p, u: p + u, pj, uj)
        pt = tree_lib.tree_map(lambda p, u: p + u, pt, ut)


def _equal_leaves(st, sj):
    ts = tree_lib.leaves(st)
    js = jax.tree_util.tree_leaves(sj)
    assert len(ts) == len(js)
    for a, b in zip(ts, js):
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sgd_equals_the_reference_bit_for_bit():
    _run("sgd", 1e-2, 1e-2, {"momentum": 0.9}, _equal_leaves)


@pytest.mark.parametrize("schedule", [False, True], ids=["constant",
                                                         "warmup_cosine"])
def test_adamw8bit_tracks_the_reference(schedule):
    """Updates within OPTIM_RTOL; the int8 moments and their per-block
    scales bit for bit."""
    lr_j = j_optim.warmup_cosine(1e-2, 2, 10) if schedule else 1e-2
    lr_t = t_optim.warmup_cosine(1e-2, 2, 10) if schedule else 1e-2
    _run("adamw8bit", lr_j, lr_t, {"weight_decay": 0.05}, _equal_leaves)


def test_adafactor_with_warmup_cosine_tracks_the_reference():
    """Updates and the factored second moments (row / column statistics
    of >= 2-D leaves, a full one of vectors) within OPTIM_RTOL."""
    def check(st, sj):
        ts = tree_lib.leaves(st["f"])
        js = jax.tree_util.tree_leaves(sj["f"])
        assert len(ts) == len(js)
        for a, b in zip(ts, js):
            _close(a, b)
    _run("adafactor", j_optim.warmup_cosine(1e-2, 2, 10),
         t_optim.warmup_cosine(1e-2, 2, 10), {"weight_decay": 0.01}, check)


def test_q8_round_trips_as_the_reference():
    """_q8 / _dq8 on sizes below, at and above a block: the int8 words and
    scales equal JAX's, the round trip equals JAX's bit for bit and is
    within half a quantum of the input; zeros stay zeros."""
    rng = np.random.default_rng(3)
    for shape in ((7,), (256,), (3, 100), (2, 3, 257)):
        x = (rng.standard_normal(shape) * 3).astype(np.float32)
        qj, sj = j_optim._q8(jnp.asarray(x))
        qt, s_t = t_optim._q8(torch.as_tensor(x))
        assert qt.dtype == torch.int8 and s_t.dtype == torch.float32
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(sj))
        back = t_optim._dq8(qt, s_t, shape)
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(j_optim._dq8(qj, sj, shape)))
        half = np.repeat(s_t.numpy()[:, 0], 256)[:x.size].reshape(shape) / 2
        assert (np.abs(back.numpy() - x) <= half * (1 + 1e-6)).all()
    q0, s0 = t_optim._q8(torch.zeros(300))
    assert not q0.any() and t_optim._dq8(q0, s0, (300,)).abs().max() < 1e-10


def test_make_optimizer_takes_the_reference_names():
    for name in ("adamw", "adamw8bit", "adafactor", "sgd"):
        assert isinstance(t_optim.make_optimizer(name, 1e-3),
                          t_optim.Optimizer)
    for bad in ("adam", "lion", "AdamW"):
        with pytest.raises(KeyError):
            j_optim.make_optimizer(bad, 1e-3)
        with pytest.raises(KeyError):
            t_optim.make_optimizer(bad, 1e-3)
    from repro_torch import optim
    import repro.optim as j_pkg
    exported = {"Optimizer", "adafactor", "adamw", "adamw8bit",
                "make_optimizer", "sgd", "clip_by_global_norm",
                "warmup_cosine", "global_norm"}
    assert all(hasattr(optim, n) and hasattr(j_pkg, n) for n in exported)
