"""Hardware-aware training in the port (`repro_torch.core.hat` and what it
runs: the straight-through estimators, the episodic forward and its
gradient, Conv4, AdamW, the trainer's steps, the procedural data) against
the JAX package, on the CPU at tiny sizes (d = 8, CL = 4, B <= 6,
N <= 12, 8x8 images, Conv4 width 8).

Forward values are bit-exact where the reference's are: the STEs' values,
the episodic votes and dist (eager JAX, as XLA:CPU contracts `1 + s * n`
into an FMA under jit, ROADMAP C.R3), the class head. Gradients are held to
a stated tolerance: the same terms are summed in other orders, and the
convolutions run in oneDNN here and in XLA there.
"""

import dataclasses
import functools
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import avss as j_avss
from repro.core import encodings as j_enc
from repro.core import hat as j_hat
from repro.core import mcam as j_mcam
from repro.core import quantization as j_quant
from repro.data import fsl as j_fsl
from repro.engine import RetrievalEngine as JEngine
from repro.engine.engine import _noise_stream as j_noise_stream
from repro.launch import steps as j_steps
from repro.models import controller as j_ctrl
from repro.optim import optimizers as j_optim
from repro_torch import tree as tree_lib
from repro_torch.configs import omniglot_conv4 as t_configs
from repro_torch.core import avss as t_avss
from repro_torch.core import encodings as t_enc
from repro_torch.core import hat as t_hat
from repro_torch.core import kinks
from repro_torch.core import mcam as t_mcam
from repro_torch.core import quantization as t_quant
from repro_torch.core.memory import MemoryConfig
from repro_torch.data import fsl as t_fsl
from repro_torch.engine import MemoryStore, RetrievalEngine, SearchRequest
from repro_torch.engine.engine import noise_stream
from repro_torch.launch import steps as t_steps
from repro_torch.launch import train as t_train
from repro_torch.models import controller as t_ctrl
from repro_torch.optim import optimizers as t_optim

torch.set_num_threads(1)

# gradients of the episodic loss (same terms, other summation order)
GRAD_ATOL = 1e-5
GRAD_RTOL = 1e-4
# anything through Conv4 (oneDNN here, XLA there)
CONV_RTOL = 2e-4
CONV_ATOL = 2e-5


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _close(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL):
    """Within atol + rtol * max|want| everywhere."""
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= atol + rtol * np.abs(want).max(), (err, np.abs(want).max())


def _relu_emb(rng, n, d=8):
    return np.maximum(rng.standard_normal((n, d)), 0).astype(np.float32)


# -- the straight-through estimators -------------------------------------------


def test_ste_round_and_fake_quant_match_the_reference():
    """Values bit-exact, gradients equal: the STE's identity slope inside
    the range, jnp.clip's 0 outside and 0.5 on a bound (the data minimum
    sits on lo; words clipped to 0 or levels - 1 sit on the outer clip's
    bounds)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 8)).astype(np.float32)
    x[0, 0] = x.min() - 3.0                         # far outside the range
    g = rng.standard_normal(x.shape).astype(np.float32)
    for levels in (4, 17):
        spec_j, spec_t = j_quant.QuantSpec(levels), t_quant.QuantSpec(levels)

        def jf(a):
            q, deq, _ = j_quant.fake_quant(a, spec_j)
            return (q * g).sum() + (deq * g).sum(), (q, deq)
        (_, (jq, jd)), jg = jax.value_and_grad(jf, has_aux=True)(
            jnp.asarray(x))
        tx = _t(x, True)
        tq, td, (lo, hi) = t_quant.fake_quant(tx, spec_t)
        ((tq * _t(g)).sum() + (td * _t(g)).sum()).backward()
        np.testing.assert_array_equal(_np(tq), np.asarray(jq))
        _close(td, jd, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(_np(tx.grad), np.asarray(jg), rtol=1e-6,
                                   atol=1e-6)
        assert set(np.unique(_np(tq))) >= {0.0, levels - 1.0}
    r = _t(np.array([0.5, 1.5, 2.5, -0.5], np.float32), True)
    out = t_quant.ste_round(r)
    out.sum().backward()
    assert _np(out).tolist() == [0.0, 2.0, 2.0, -0.0]
    assert _np(r.grad).tolist() == [1.0] * 4


def test_quantize_asymmetric_matches_the_reference():
    rng = np.random.default_rng(1)
    q, s = _relu_emb(rng, 5), _relu_emb(rng, 9)
    gq = rng.standard_normal(q.shape).astype(np.float32)
    gs = rng.standard_normal(s.shape).astype(np.float32)

    def jf(a, b):
        qq, qs = j_quant.quantize_asymmetric(a, b, 13)
        return (qq * gq).sum() + (qs * gs).sum(), (qq, qs)
    (_, (jqq, jqs)), (jga, jgb) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(jnp.asarray(q), jnp.asarray(s))
    ta, tb = _t(q, True), _t(s, True)
    tqq, tqs = t_quant.quantize_asymmetric(ta, tb, 13)
    ((tqq * _t(gq)).sum() + (tqs * _t(gs)).sum()).backward()
    np.testing.assert_array_equal(_np(tqq), np.asarray(jqq))
    np.testing.assert_array_equal(_np(tqs), np.asarray(jqs))
    np.testing.assert_allclose(_np(ta.grad), np.asarray(jga), atol=1e-6)
    np.testing.assert_allclose(_np(tb.grad), np.asarray(jgb), atol=1e-6)


@pytest.mark.parametrize("name,cl", [("mtmc", 4), ("mtmc", 7), ("b4e", 2),
                                     ("sre", 3), ("b4we", 2)])
def test_encode_words_ste_matches_the_reference(name, cl):
    """Forward equal to the hard encoder and to JAX's, bit for bit, on
    every level; gradient 1/CL per MTMC word, 1/length otherwise."""
    je, te = j_enc.make_encoding(name, cl), t_enc.make_encoding(name, cl)
    v = np.arange(je.levels, dtype=np.float32)
    g = np.random.default_rng(cl).standard_normal(
        (je.levels, je.length)).astype(np.float32)
    jw, jvjp = jax.vjp(lambda a: j_enc.encode_words_ste(a, je),
                       jnp.asarray(v))
    tv = _t(v, True)
    tw = t_enc.encode_words_ste(tv, te)
    (tw * _t(g)).sum().backward()
    np.testing.assert_array_equal(_np(tw), np.asarray(jw))
    np.testing.assert_array_equal(
        _np(tw), _np(te.encode(torch.arange(te.levels))).astype(np.float32))
    # the word gradients are summed in another order: 1e-6 of the largest
    _close(tv.grad, jvjp(jnp.asarray(g))[0], rtol=1e-6, atol=0.0)


def test_ste_step_and_sa_votes_match_the_reference():
    rng = np.random.default_rng(2)
    cur = rng.uniform(0.0, 1.1, size=(5, 7)).astype(np.float32)
    cfg_j, cfg_t = j_mcam.MCAMConfig(), t_mcam.MCAMConfig()
    th = cfg_j.thresholds()
    cur[0, :3] = th[:3]                     # exactly on a threshold: no vote
    g = rng.standard_normal((5, 7)).astype(np.float32)
    step_j = lambda x: j_mcam.ste_step(x, 0.05)   # noqa: E731
    jv, jvjp = jax.vjp(lambda c: j_mcam.sa_votes(c, cfg_j, step_fn=step_j),
                       jnp.asarray(cur))
    tc = _t(cur, True)
    tv = t_mcam.sa_votes(tc, cfg_t,
                         step_fn=lambda x: t_mcam.ste_step(x, 0.05))
    (tv * _t(g)).sum().backward()
    np.testing.assert_array_equal(_np(tv), np.asarray(jv))
    np.testing.assert_array_equal(_np(tv), _np(t_mcam.sa_votes(
        _t(cur), cfg_t)))
    _close(tc.grad, jvjp(jnp.asarray(g))[0], rtol=1e-5, atol=1e-5)


def test_votes_from_mismatch_with_a_stream_and_the_step():
    """core.avss.votes_from_mismatch with a noise stream and the STE step:
    dist exact; votes agree where no current lies within ulps of a
    threshold (>= 99% of pairs: its pow and libm are not XLA's); the
    gradient with respect to the mismatch within GRAD_RTOL."""
    rng = np.random.default_rng(3)
    mm = rng.integers(0, 4, size=(4, 6, 1, 4, 8)).astype(np.float32)
    cfg_j = j_avss.SearchConfig("mtmc", cl=4,
                                mcam=j_mcam.MCAMConfig(string_len=8))
    cfg_t = t_avss.SearchConfig("mtmc", cl=4,
                                mcam=t_mcam.MCAMConfig(string_len=8))
    th = cfg_j.mcam.thresholds()
    w = np.ones(4, np.float32)
    qi = np.arange(4, dtype=np.uint32)[:, None, None, None]
    R = rng.standard_normal((4, 6)).astype(np.float32)

    def jf(m):
        v, d = j_avss.votes_from_mismatch(
            m, jnp.asarray(qi), jnp.asarray(w), cfg_j, jnp.asarray(th),
            noise_stream=jnp.uint32(123),
            step_fn=lambda x: j_mcam.ste_step(x, 0.5))
        return (v * R).sum(), (v, d)
    (_, (jv, jd)), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(mm))
    tm = _t(mm, True)
    tv, td = t_avss.votes_from_mismatch(
        tm, torch.as_tensor(qi.astype(np.int64)), _t(w), cfg_t, _t(th),
        noise_stream=123, step_fn=lambda x: t_mcam.ste_step(x, 0.5))
    (tv * _t(R)).sum().backward()
    np.testing.assert_array_equal(_np(td), np.asarray(jd))
    assert (_np(tv) == np.asarray(jv)).mean() >= 0.99
    _close(tm.grad, jg, rtol=1e-3, atol=1e-4)


def test_kinks_follow_jax_grad():
    x = _t(np.array([-1.0, 0.0, 1.0, 3.0, 4.0], np.float32), True)
    (kinks.abs(x).sum() + kinks.clip(x, 0.0, 3.0).sum()).backward()
    ja = jax.grad(lambda a: jnp.abs(a).sum() + jnp.clip(a, 0.0, 3.0).sum())(
        jnp.asarray(_np(x)))
    np.testing.assert_array_equal(_np(x.grad), np.asarray(ja))
    assert _np(x.grad).tolist() == [-1.0, 1.5, 2.0, 1.5, 1.0]


# -- the episodic forward ------------------------------------------------------

EPISODE_CASES = [(mode, noisy, key) for mode in ("avss", "svss")
                 for noisy, key in ((False, None), (True, None), (True, 5),
                                    (True, "carried"))]


def _episode_inputs(seed, b=6, n=12, d=8):
    rng = np.random.default_rng(seed)
    return _relu_emb(rng, b, d), _relu_emb(rng, n, d)


@pytest.mark.parametrize("mode,noisy,key", EPISODE_CASES)
def test_episode_votes_equal_eager_jax_bit_for_bit(mode, noisy, key):
    """votes and dist of the port's episodic forward (the plain route:
    the dense physics' plain version with the STE step) equal eager
    JAX's, noiseless and noisy; a key, an int or a carried
    `jax.random.key_data`, folds to the same stream coordinate."""
    q, s = _episode_inputs(10 + len(mode) + 2 * noisy)
    jkey = jax.random.key_data(jax.random.PRNGKey(4)) \
        if key == "carried" else key
    tkey = np.asarray(jkey) if key == "carried" else key
    if key is not None:
        assert noise_stream(tkey) == int(j_noise_stream(jkey))
    jr = JEngine(j_avss.SearchConfig("mtmc", cl=4, mode=mode,
                                     use_kernel="ref")).episode_votes(
        jnp.asarray(q), jnp.asarray(s), noisy=noisy, key=jkey)
    tr = RetrievalEngine(t_avss.SearchConfig("mtmc", cl=4, mode=mode)) \
        .episode_votes(_t(q), _t(s), noisy=noisy, key=tkey)
    np.testing.assert_array_equal(_np(tr["votes"]), np.asarray(jr["votes"]))
    np.testing.assert_array_equal(_np(tr["dist"]), np.asarray(jr["dist"]))
    assert tr["iterations"] == jr["iterations"]


@pytest.mark.parametrize("mode", ["avss", "svss"])
@pytest.mark.parametrize("noisy", [False, True])
def test_episode_scores_equal_the_served_class_head(mode, noisy):
    """Train == serve in the port: `episode_scores` equals
    `class_mean_votes` of `search(mode="full")` on the store that
    `from_episode` programs (AVSS; SVSS calibrates on the supports, so its
    store is programmed from that range), bit for bit, noiseless and with
    the serving noise (key None)."""
    q, s = _episode_inputs(20)
    lab = np.arange(12) % 4
    cfg = t_avss.SearchConfig("mtmc", cl=4, mode=mode)
    eng = RetrievalEngine(cfg)
    if mode == "avss":
        store = MemoryStore.from_episode(_t(s), _t(q), lab, cfg)
        rng_range = None
    else:
        lo, hi = t_quant.clip_range(_t(s), 2.5)
        store = dataclasses.replace(
            MemoryStore.create(MemoryConfig(capacity=12, dim=8, search=cfg),
                               device="cpu"),
            lo=lo, hi=hi, calibrated=True).write(s, lab)
        rng_range = (lo, hi)
    assert store.device.type == "cpu"
    scores = eng.episode_scores(_t(q), _t(s), torch.as_tensor(lab), 4,
                                noisy=noisy, rng_range=rng_range)
    res = eng.search(store, q, SearchRequest(mode="full", noisy=noisy))
    served = t_avss.class_mean_votes(res.votes, store.labels, 4)
    assert torch.equal(scores.detach(), served)
    jv = j_avss.class_mean_votes(jnp.asarray(_np(res.votes)),
                                 jnp.asarray(lab), 4)
    np.testing.assert_array_equal(_np(served), np.asarray(jv))


def _j_grads(fn, *args):
    return jax.jit(jax.grad(fn, argnums=tuple(range(len(args)))))(
        *map(jnp.asarray, args))


@pytest.mark.parametrize("mode", ["avss", "svss"])
def test_meta_loss_gradient_wrt_embeddings_matches_jax_grad(mode):
    """d meta-CE / d (query, support) embeddings through the simulated MCAM
    (noisy, a carried key, tau 0.5 so that most strings sit on the
    sigmoid's slope), against jax.grad of the reference, within GRAD_RTOL
    of the largest entry."""
    q, s = _episode_inputs(30)
    lab, qlab = np.arange(12) % 4, np.arange(6) % 4
    key = jax.random.key_data(jax.random.PRNGKey(9))
    hat_j = j_hat.HATConfig(search=j_avss.SearchConfig(
        "mtmc", cl=4, mode=mode, use_kernel="ref"), sa_tau=0.5)
    hat_t = t_hat.HATConfig(search=t_avss.SearchConfig("mtmc", cl=4,
                                                       mode=mode), sa_tau=0.5)

    def jf(a, b):
        sc = j_hat.simulate_mcam(a, b, jnp.asarray(lab), 4, hat_j, key)
        return j_hat.cross_entropy(sc / hat_j.temperature, jnp.asarray(qlab))
    jga, jgb = _j_grads(jf, q, s)
    ta, tb = _t(q, True), _t(s, True)
    sc = t_hat.simulate_mcam(ta, tb, torch.as_tensor(lab), 4, hat_t,
                             np.asarray(key))
    t_hat.cross_entropy(torch.div(sc, torch.tensor(hat_t.temperature)),
                        torch.as_tensor(qlab)).backward()
    assert np.abs(np.asarray(jgb)).max() > 0
    _close(ta.grad, jga)
    _close(tb.grad, jgb)


def test_matching_cells_take_jax_kink_rules():
    """An episode whose supports repeat the queries, so most cells have
    |q - s| = 0 and many words sit on the clip's bounds: the gradient with
    respect to the supports matches jax.grad only with abs's +1 at 0 and
    clip's 0.5 on a bound (ROADMAP C.P4). Under torch.abs and torch.clamp
    the same episode's gradient does not."""
    rng = np.random.default_rng(40)
    q = _relu_emb(rng, 6)
    s = np.concatenate([q, q])
    R = rng.standard_normal((6, 12)).astype(np.float32)
    jcfg = j_avss.SearchConfig("mtmc", cl=4, use_kernel="ref")

    def jf(a, b):
        r = JEngine(jcfg).episode_votes(a, b, key=3, sa_tau=0.5)
        return (r["votes"] * R).sum() + 0.1 * (r["dist"] * R).sum()
    jga, jgb = _j_grads(jf, q, s)

    def port(abs_fn, clip_fn, monkeypatch):
        monkeypatch.setattr(kinks, "abs", abs_fn)
        monkeypatch.setattr(kinks, "clip", clip_fn)
        a, b = _t(q, True), _t(s, True)
        r = RetrievalEngine(t_avss.SearchConfig("mtmc", cl=4)).episode_votes(
            a, b, key=3, sa_tau=0.5)
        ((r["votes"] * _t(R)).sum()
         + 0.1 * (r["dist"] * _t(R)).sum()).backward()
        return a.grad, b.grad
    with pytest.MonkeyPatch.context() as mp:
        ga, gb = port(kinks.abs, kinks.clip, mp)
    _close(ga, jga)
    _close(gb, jgb)
    with pytest.MonkeyPatch.context() as mp:
        _, gb_torch = port(torch.abs, torch.clamp, mp)
    err = np.abs(_np(gb_torch) - np.asarray(jgb)).max()
    assert err > 0.1 * np.abs(np.asarray(jgb)).max()


# -- Conv4, the losses and the optimizer ----------------------------------------


@functools.cache
def _conv4_params(seed=0, width=8, embed=8):
    jp = j_ctrl.init_conv4(jax.random.PRNGKey(seed), in_ch=1, width=width,
                           embed_dim=embed)
    return jax.tree_util.tree_map(np.asarray, jp)


def _images(seed, n, size=8):
    return np.random.default_rng(seed).random((n, size, size, 1),
                                              dtype=np.float32)


def test_conv4_matches_the_reference_forward():
    """Carried-across parameters (HWIO -> OIHW) give the reference's
    embeddings within CONV_RTOL; the nn.Module holds the same function."""
    jp = _conv4_params()
    x = _images(0, 5)
    want = np.asarray(jax.jit(j_ctrl.apply_conv4)(jp, jnp.asarray(x)))
    tp = t_ctrl.conv4_from_numpy(jp)
    got = t_ctrl.apply_conv4(tp, _t(x))
    np.testing.assert_allclose(_np(got), want, rtol=CONV_RTOL, atol=CONV_ATOL)
    mod = t_ctrl.Conv4(tp)
    assert torch.equal(mod(_t(x)), got)
    assert sum(p.numel() for p in mod.parameters()) == sum(
        a.size for a in jax.tree_util.tree_leaves(jp))
    fresh = t_ctrl.init_conv4(0, width=8, embed_dim=8)
    assert [tuple(t.shape) for t in tree_lib.leaves(fresh)] == [
        tuple(t.shape) for t in tree_lib.leaves(tp)]


def test_pretrain_loss_and_gradients_match():
    jp = _conv4_params()
    rng = np.random.default_rng(5)
    head = {"w": rng.standard_normal((8, 10)).astype(np.float32) * 0.05,
            "b": np.zeros(10, np.float32)}
    batch = {"image": _images(1, 6), "label": np.arange(6) % 10}
    jparams = {"backbone": jp, "head": head}
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: j_hat.pretrain_loss(p, b, j_ctrl.apply_conv4)))(
        jax.tree_util.tree_map(jnp.asarray, jparams),
        jax.tree_util.tree_map(jnp.asarray, batch))
    tparams = {"backbone": t_ctrl.conv4_from_numpy(jp),
               "head": tree_lib.tree_map(torch.as_tensor, head)}
    tl, tg = t_hat.value_and_grad(
        t_hat.pretrain_loss, tparams,
        {"image": _t(batch["image"]), "label": torch.as_tensor(
            batch["label"])}, t_ctrl.apply_conv4)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    jg_t = {"backbone": t_ctrl.conv4_from_numpy(
        jax.tree_util.tree_map(np.asarray, jg["backbone"])),
        "head": tree_lib.tree_map(torch.as_tensor, jax.tree_util.tree_map(
            np.array, jg["head"]))}
    for a, b in zip(tree_lib.leaves(tg), tree_lib.leaves(jg_t)):
        _close(a, b, rtol=CONV_RTOL, atol=CONV_ATOL)


def test_meta_loss_gradient_wrt_conv4_matches_jax_grad():
    """The whole meta step's gradient: images -> Conv4 -> episodic MCAM ->
    CE, with respect to every Conv4 parameter, against jax.grad of the
    reference's meta_loss (noisy, a carried key)."""
    jp = _conv4_params(1)
    ep = {"support_images": _images(2, 12), "query_images": _images(3, 6),
          "support_labels": np.arange(12) % 4,
          "query_labels": np.arange(6) % 4}
    key = jax.random.key_data(jax.random.PRNGKey(2))
    hat_j = j_hat.HATConfig(search=j_avss.SearchConfig(
        "mtmc", cl=4, mode="avss", use_kernel="ref"), sa_tau=0.5)
    hat_t = t_hat.HATConfig(search=t_avss.SearchConfig("mtmc", cl=4),
                            sa_tau=0.5)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, e: j_hat.meta_loss(p, {**e, "n_way": 4},
                                     j_ctrl.apply_conv4, hat_j, key)))(
        {"backbone": jax.tree_util.tree_map(jnp.asarray, jp)},
        jax.tree_util.tree_map(jnp.asarray, ep))
    tl, tg = t_hat.value_and_grad(
        t_hat.meta_loss, {"backbone": t_ctrl.conv4_from_numpy(jp)},
        {**tree_lib.tree_map(torch.as_tensor, ep), "n_way": 4},
        t_ctrl.apply_conv4, hat_t, np.asarray(key))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    want = t_ctrl.conv4_from_numpy(jax.tree_util.tree_map(
        np.asarray, jg["backbone"]))
    for a, b in zip(tree_lib.leaves(tg["backbone"]), tree_lib.leaves(want)):
        _close(a, b, rtol=1e-3, atol=1e-5)


def test_adamw_on_identical_gradients_matches_the_reference():
    """Three AdamW steps on carried-across gradients and state (the
    reference's formula: b2 = 0.95, decay inside the update, bias
    correction as written), with a warmup-cosine schedule: updates and
    moments within 1e-6 relative. The first step's update is ~lr*sign(g),
    which is why the optimizer is held on identical gradients."""
    rng = np.random.default_rng(6)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": [rng.standard_normal(5).astype(np.float32)]}
    sched_j = j_optim.warmup_cosine(1e-2, 2, 10)
    sched_t = t_optim.warmup_cosine(1e-2, 2, 10)
    oj = j_optim.adamw(sched_j, weight_decay=0.05)
    ot = t_optim.adamw(sched_t, weight_decay=0.05)
    sj = oj.init(jax.tree_util.tree_map(jnp.asarray, params))
    st = ot.init(tree_lib.tree_map(torch.as_tensor, params))
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    pt = tree_lib.tree_map(torch.as_tensor, params)
    for step in range(3):
        g = jax.tree_util.tree_map(
            lambda p: rng.standard_normal(p.shape).astype(np.float32),
            params)
        uj, sj = oj.update(jax.tree_util.tree_map(jnp.asarray, g), sj, pj)
        ut, st = ot.update(tree_lib.tree_map(torch.as_tensor, g), st, pt)
        for a, b in zip(tree_lib.leaves(ut), jax.tree_util.tree_leaves(uj)):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6,
                                       atol=1e-9)
        for k in ("m", "v"):
            for a, b in zip(tree_lib.leaves(st[k]),
                            jax.tree_util.tree_leaves(sj[k])):
                np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6)
        assert int(st["step"]) == int(sj["step"]) == step + 1
        pj = jax.tree_util.tree_map(lambda p, u: p + u, pj, uj)
        pt = tree_lib.tree_map(lambda p, u: p + u, pt, ut)
    for s in range(12):
        np.testing.assert_allclose(float(sched_t(torch.tensor(s))),
                                   float(sched_j(jnp.int32(s))), rtol=1e-6)
    gt = tree_lib.tree_map(torch.as_tensor, params)
    np.testing.assert_allclose(
        float(t_optim.global_norm(gt)),
        float(j_optim.global_norm(jax.tree_util.tree_map(jnp.asarray,
                                                         params))),
        rtol=1e-6)
    clipped, _ = t_optim.clip_by_global_norm(gt, 0.5)
    np.testing.assert_allclose(float(t_optim.global_norm(clipped)), 0.5,
                               rtol=1e-5)


def test_adamw_state_carries_across():
    """AdamW state the JAX package built (m, v, step) carried across into
    the port continues the same run: the next update equals JAX's."""
    jp = _conv4_params(2, width=8)
    jparams = {"backbone": jax.tree_util.tree_map(jnp.asarray, jp)}
    oj = j_optim.adamw(1e-3)
    sj = oj.init(jparams)
    g = jax.tree_util.tree_map(lambda p: jnp.full(p.shape, 0.01), jparams)
    _, sj = oj.update(g, sj, jparams)
    st = t_optim.adamw_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, sj),
        lambda t: {"backbone": t_ctrl.conv4_from_numpy(t["backbone"])})
    tparams = {"backbone": t_ctrl.conv4_from_numpy(jp)}
    tg = tree_lib.tree_map(lambda p: torch.full(p.shape, 0.01), tparams)
    ut, st2 = t_optim.adamw(1e-3).update(tg, st, tparams)
    uj, _ = oj.update(g, sj, jparams)
    want = t_ctrl.conv4_from_numpy(jax.tree_util.tree_map(
        np.asarray, uj["backbone"]))
    for a, b in zip(tree_lib.leaves(ut["backbone"]), tree_lib.leaves(want)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-10)
    assert int(st2["step"]) == 2 and st2["step"].dtype == torch.int32


def test_one_meta_step_at_the_smoke_configuration():
    """One `make_hat_train_steps` meta step of each package at the smoke
    configuration's geometry (d = 24, CL = 8, 20x20 images, Conv4 width
    8, a 4-way 2-shot episode with 2 queries a class) from the same
    carried-across parameters: the losses agree, the port's update is its
    own AdamW of its own gradient (applied once, nothing in place), and
    every parameter moves by at most ~2 lr. Parameters are not compared
    with JAX's: a first AdamW step is ~lr*sign(g), which amplifies the
    sign of gradient entries near 0."""
    fsl = t_configs.get_smoke_config()
    jp = _conv4_params(3, width=8, embed=fsl.embed_dim)
    ds = t_fsl.OmniglotLike(20, image_size=fsl.image_size, seed=0)
    ep = t_fsl.EpisodeSampler(ds, np.arange(20), n_way=4, k_shot=2,
                              n_query=2, seed=1).episode(0)
    arrays = {"support_images": ep.support_images,
              "support_labels": ep.support_labels,
              "query_images": ep.query_images,
              "query_labels": ep.query_labels}
    key = jax.random.key_data(jax.random.PRNGKey(5))
    j_search = j_avss.SearchConfig("mtmc", cl=fsl.cl, use_kernel="ref")
    _, jmeta, jplace = j_steps.make_hat_train_steps(
        j_ctrl.apply_conv4, j_hat.HATConfig(search=j_search),
        j_optim.adamw(1e-3), n_way=4)
    jparams = {"backbone": jax.tree_util.tree_map(jnp.asarray, jp)}
    _, _, jloss = jmeta(jparams, j_optim.adamw(1e-3).init(jparams),
                        jplace(jax.tree_util.tree_map(jnp.asarray, arrays)),
                        key)
    opt = t_optim.adamw(1e-3)
    hat_t = t_hat.HATConfig(search=t_avss.SearchConfig("mtmc", cl=fsl.cl))
    _, tmeta, place = t_steps.make_hat_train_steps(
        t_ctrl.apply_conv4, hat_t, opt, n_way=4, device="cpu")
    tparams = {"backbone": t_ctrl.conv4_from_numpy(jp)}
    state = opt.init(tparams)
    before = tree_lib.tree_map(torch.clone, tparams)
    new, state2, tloss = tmeta(tparams, state, place(arrays),
                               np.asarray(key))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    _, grads = t_hat.value_and_grad(
        t_hat.meta_loss, tparams, {**place(arrays), "n_way": 4},
        t_ctrl.apply_conv4, hat_t, np.asarray(key))
    upd, _ = opt.update(grads, state, tparams)
    for p, b, n, u in zip(*(tree_lib.leaves(t) for t in
                            (tparams, before, new, upd))):
        assert torch.equal(p, b)                  # nothing in place
        assert torch.equal(n, b + u)
        assert float((n - b).abs().max()) <= 2.1e-3
    assert int(state2["step"]) == 1
    assert np.isfinite(float(tloss))


def test_fsl_copy_gives_identical_arrays():
    """The port's copy of repro.data.fsl: the same seeds give the same
    images, labels and batches."""
    for seed in (0, 3):
        jd = j_fsl.OmniglotLike(12, image_size=12, seed=seed)
        td = t_fsl.OmniglotLike(12, image_size=12, seed=seed)
        je = j_fsl.EpisodeSampler(jd, np.arange(12), 3, 2, 2, seed=seed)
        te = t_fsl.EpisodeSampler(td, np.arange(12), 3, 2, 2, seed=seed)
        for i in range(2):
            a, b = je.episode(i), te.episode(i)
            for f in ("support_images", "support_labels", "query_images",
                      "query_labels", "class_ids"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        for step in range(2):
            a = j_fsl.pretrain_batch(jd, np.arange(12), 4, step, seed)
            b = t_fsl.pretrain_batch(td, np.arange(12), 4, step, seed)
            for f in ("image", "label"):
                np.testing.assert_array_equal(a[f], b[f])
        jc = j_fsl.CUBLike(4, image_size=10, seed=seed)
        tc = t_fsl.CUBLike(4, image_size=10, seed=seed)
        np.testing.assert_array_equal(jc.class_images(1, 2, 5),
                                      tc.class_images(1, 2, 5))


def test_configs_match_the_reference():
    """Both datasets' configurations (Omniglot / Conv4 and CUB /
    ResNet12, full and smoke) equal the reference's field by field."""
    from repro.configs import cub_resnet12 as j_cub
    from repro.configs import omniglot_conv4 as j_configs
    from repro_torch.configs import cub_resnet12 as t_cub
    for j_mod, t_mod in ((j_configs, t_configs), (j_cub, t_cub)):
        for name in ("get_config", "get_smoke_config"):
            a, b = getattr(j_mod, name)(), getattr(t_mod, name)()
            for f in dataclasses.fields(a):
                if f.name != "search":
                    assert getattr(a, f.name) == getattr(b, f.name), f.name
            assert dataclasses.asdict(a.search) == \
                dataclasses.asdict(b.search)
    assert type(t_cub.get_config()) is t_configs.FSLConfig


@pytest.fixture
def restore_determinism(monkeypatch):
    """Put back torch's determinism settings after a test that runs the
    trainer (`launch.train.make_deterministic` sets them for the process)."""
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    yield
    torch.use_deterministic_algorithms(saved[0])
    torch.backends.cudnn.deterministic = saved[1]
    torch.backends.cudnn.benchmark = saved[2]


def test_train_hat_closes_the_loop_on_the_cpu(tmp_path, capsys,
                                              restore_determinism):
    """`python -m repro_torch.launch.train --hat --device cpu` at a few
    steps: finite losses, served class scores equal the in-training head
    bit for bit, and the controller and store checkpoints restore (the
    store searches as it did); the trainer turned on its deterministic
    settings."""
    t_train.main(["--hat", "--device", "cpu", "--hat-pretrain-steps", "2",
                  "--hat-meta-steps", "2", "--hat-n-way", "3",
                  "--hat-k-shot", "2", "--hat-eval-episodes", "1",
                  "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "score bit-parity: True" in out and "parity=True" in out
    assert torch.are_deterministic_algorithms_enabled()
    assert torch.backends.cudnn.deterministic
    assert not torch.backends.cudnn.benchmark
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == t_train.CUBLAS_WORKSPACE
    fsl = t_configs.get_smoke_config()
    target = {"params": {"backbone": t_ctrl.init_conv4(
        0, width=32, embed_dim=fsl.embed_dim)}}
    from repro_torch.checkpoint import ckpt
    params = ckpt.restore(str(tmp_path), target)
    assert ckpt.latest_step(str(tmp_path)) == 2
    assert all(torch.isfinite(t).all() for t in tree_lib.leaves(params))
    cfg = MemoryConfig(capacity=6, dim=fsl.embed_dim,
                       search=t_train.hat_config(fsl).search)
    store = MemoryStore.restore(str(tmp_path / "store"), cfg, device="cpu")
    assert store.calibrated and int(store.size) == 6
    # the LM path of the same entry point runs on a (1, 1) host mesh (its
    # preemption handler is put back after)
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                                 signal.SIGINT)}
    try:
        t_train.main(["--smoke", "--model-parallel", "2", "--device", "cpu",
                      "--steps", "1", "--batch", "2", "--seq", "8",
                      "--ckpt-dir", str(tmp_path / "lm")])
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)
    assert "first-10 mean" in capsys.readouterr().out
