"""The CUB controller (ResNet12 in `repro_torch.models.controller`) and the
CUB configuration against the JAX package, on the CPU at narrow widths
((8, 16, 16, 32) on 24x24 and 12x12 images).

Both packages start from the same weights: the JAX package's
`init_resnet12` tree carried across by `resnet12_from_numpy` (HWIO ->
OIHW). The convolutions run in oneDNN here and in XLA there, so outputs
and gradients are held to a tolerance, CONV_RTOL / CONV_ATOL as for Conv4
(tests/test_torch_hat.py), and the losses to rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import avss as j_avss
from repro.core import hat as j_hat
from repro.launch import steps as j_steps
from repro.models import controller as j_ctrl
from repro.optim import optimizers as j_optim
from repro_torch import tree as tree_lib
from repro_torch.configs import cub_resnet12 as t_cub
from repro_torch.core import avss as t_avss
from repro_torch.core import hat as t_hat
from repro_torch.data import fsl as t_fsl
from repro_torch.launch import steps as t_steps
from repro_torch.models import controller as t_ctrl
from repro_torch.optim import optimizers as t_optim

torch.set_num_threads(1)

# anything through the convolutions (oneDNN here, XLA there): Conv4's
# tolerance (tests/test_torch_hat.py)
CONV_RTOL = 2e-4
CONV_ATOL = 2e-5
WIDTHS = (8, 16, 16, 32)


def _jparams(seed=0, widths=WIDTHS, embed=16):
    p = j_ctrl.init_resnet12(jax.random.PRNGKey(seed), in_ch=3,
                             widths=widths, embed_dim=embed)
    return jax.tree_util.tree_map(np.asarray, p)


def _images(seed, n, size):
    return np.random.default_rng(seed).random((n, size, size, 3),
                                              dtype=np.float32)


def _close(got, want, rtol=CONV_RTOL, atol=CONV_ATOL):
    """Within atol + rtol * max|want| everywhere."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= atol + rtol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("size", [24, 12], ids=["last_pool_floors",
                                                "last_block_unpooled"])
def test_resnet12_matches_the_reference_forward(size):
    """At 24x24 the maps go 24 -> 12 -> 6 -> 3 -> 1 (the last pool floors
    3 to 1); at 12x12 the last block sees 1x1 and does not pool. The
    embeddings equal the reference's within CONV_RTOL / CONV_ATOL, and
    the nn.Module holds the same function."""
    jp = _jparams()
    x = _images(size, 5, size)
    want = np.asarray(jax.jit(j_ctrl.apply_resnet12)(jp, jnp.asarray(x)))
    tp = t_ctrl.resnet12_from_numpy(jp)
    got = t_ctrl.apply_resnet12(tp, torch.as_tensor(x))
    _close(got, want, rtol=CONV_RTOL, atol=CONV_ATOL)
    assert (got >= 0).all() and got.shape == (5, 16)
    mod = t_ctrl.ResNet12(tp)
    assert torch.equal(mod(torch.as_tensor(x)), got)
    assert sum(p.numel() for p in mod.parameters()) == sum(
        a.size for a in jax.tree_util.tree_leaves(jp))


def test_resnet12_init_has_the_reference_tree():
    """`init_resnet12` (numpy's draws) gives the reference's tree: the
    same leaves in the same order with the carried-across shapes, He-normal
    convolutions (std sqrt(2 / fan_in)) and zero biases; at the paper's
    widths, 480-d embeddings. The registry names both controllers."""
    shapes = jax.eval_shape(lambda: j_ctrl.init_resnet12(
        jax.random.PRNGKey(0), in_ch=3, widths=(64, 160, 320, 640),
        embed_dim=480))
    fresh = t_ctrl.init_resnet12(0)
    carried = t_ctrl.resnet12_from_numpy(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32), shapes))
    names, leaves = tree_lib.flatten_with_names(fresh)
    assert names == tree_lib.flatten_with_names(carried)[0]
    assert [tuple(t.shape) for t in leaves] == [
        tuple(t.shape) for t in tree_lib.leaves(carried)]
    w = fresh["blocks"][3]["c2"]["w"]
    assert abs(float(w.std()) / np.sqrt(2.0 / (9 * 640)) - 1) < 0.01
    assert not fresh["blocks"][0]["sc"]["b"].any()
    assert t_ctrl.apply_resnet12(fresh, torch.zeros(1, 84, 84, 3)).shape \
        == (1, 480)
    assert set(t_ctrl.CONTROLLERS) == set(j_ctrl.CONTROLLERS)
    assert t_ctrl.CONTROLLERS["resnet12"] == (t_ctrl.init_resnet12,
                                              t_ctrl.apply_resnet12)


def test_resnet12_pretrain_loss_and_gradients_match():
    """Stage 1's loss and its gradient with respect to every ResNet12 and
    head leaf against jax.grad of the reference: within rtol 1e-4 of each
    leaf's largest entry, plus 1e-4 of the gradient's largest entry over
    all leaves (a convolution bias in front of a GroupNorm with one channel
    a group has a gradient of 0, of which both packages hold only rounding
    noise)."""
    jp = _jparams(1)
    rng = np.random.default_rng(5)
    head = {"w": rng.standard_normal((16, 10)).astype(np.float32) * 0.05,
            "b": np.zeros(10, np.float32)}
    batch = {"image": _images(1, 6, 24), "label": np.arange(6) % 10}
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: j_hat.pretrain_loss(p, b, j_ctrl.apply_resnet12)))(
        jax.tree_util.tree_map(jnp.asarray, {"backbone": jp, "head": head}),
        jax.tree_util.tree_map(jnp.asarray, batch))
    tparams = {"backbone": t_ctrl.resnet12_from_numpy(jp),
               "head": tree_lib.tree_map(torch.as_tensor, head)}
    tl, tg = t_hat.value_and_grad(
        t_hat.pretrain_loss, tparams,
        {"image": torch.as_tensor(batch["image"]),
         "label": torch.as_tensor(batch["label"])}, t_ctrl.apply_resnet12)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    want = {"backbone": t_ctrl.resnet12_from_numpy(
        jax.tree_util.tree_map(np.asarray, jg["backbone"])),
        "head": tree_lib.tree_map(torch.as_tensor, jax.tree_util.tree_map(
            np.array, jg["head"]))}
    scale = max(float(b.abs().max()) for b in tree_lib.leaves(want))
    for a, b in zip(tree_lib.leaves(tg), tree_lib.leaves(want)):
        _close(a, b, rtol=1e-4, atol=1e-4 * scale)


def test_one_resnet12_meta_step_at_the_cub_smoke_configuration():
    """One `make_hat_train_steps(apply_resnet12, ...)` meta step of each
    package at `cub_resnet12.get_smoke_config()` (d = 32, MTMC CL = 6,
    24x24 CUB-like images, a 6-way 2-shot episode with 2 queries a class)
    from the same carried-across weights and step key: the losses agree
    within rtol 1e-4, the port's update is its own AdamW of its own
    gradient, nothing is updated in place."""
    fsl = t_cub.get_smoke_config()
    jp = _jparams(3, embed=fsl.embed_dim)
    ds = t_fsl.CUBLike(fsl.n_train_classes, image_size=fsl.image_size, seed=0)
    ep = t_fsl.EpisodeSampler(ds, np.arange(fsl.n_train_classes),
                              n_way=fsl.n_way, k_shot=fsl.k_shot, n_query=2,
                              seed=1).episode(0)
    arrays = {"support_images": ep.support_images,
              "support_labels": ep.support_labels,
              "query_images": ep.query_images,
              "query_labels": ep.query_labels}
    key = jax.random.key_data(jax.random.PRNGKey(5))
    j_search = j_avss.SearchConfig("mtmc", cl=fsl.cl, use_kernel="ref")
    _, jmeta, jplace = j_steps.make_hat_train_steps(
        j_ctrl.apply_resnet12, j_hat.HATConfig(search=j_search),
        j_optim.adamw(1e-3), n_way=fsl.n_way)
    jparams = {"backbone": jax.tree_util.tree_map(jnp.asarray, jp)}
    _, _, jloss = jmeta(jparams, j_optim.adamw(1e-3).init(jparams),
                        jplace(jax.tree_util.tree_map(jnp.asarray, arrays)),
                        key)
    opt = t_optim.adamw(1e-3)
    hat_t = t_hat.HATConfig(search=t_avss.SearchConfig("mtmc", cl=fsl.cl))
    _, tmeta, place = t_steps.make_hat_train_steps(
        t_ctrl.apply_resnet12, hat_t, opt, n_way=fsl.n_way, device="cpu")
    tparams = {"backbone": t_ctrl.resnet12_from_numpy(jp)}
    state = opt.init(tparams)
    before = tree_lib.tree_map(torch.clone, tparams)
    new, state2, tloss = tmeta(tparams, state, place(arrays),
                               np.asarray(key))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    _, grads = t_hat.value_and_grad(
        t_hat.meta_loss, tparams, {**place(arrays), "n_way": fsl.n_way},
        t_ctrl.apply_resnet12, hat_t, np.asarray(key))
    upd, _ = opt.update(grads, state, tparams)
    for p, b, n, u in zip(*(tree_lib.leaves(t) for t in
                            (tparams, before, new, upd))):
        assert torch.equal(p, b)
        assert torch.equal(n, b + u)
    assert int(state2["step"]) == 1 and np.isfinite(float(tloss))

