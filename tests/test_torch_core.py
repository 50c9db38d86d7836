"""Parity of the port's core semantics (`repro_torch.core`) with the JAX
package (`repro.core`), on the CPU.

Inputs come from numpy seeds and go through both packages. Integer-valued
results (code words, LUTs, quantized values, layouts, hash bits, string
ids) must be equal; the float physics is held to the tolerance each test
states, with the reason beside it.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import avss as j_avss
from repro.core import encodings as j_enc
from repro.core import mcam as j_mcam
from repro.core import quantization as j_quant
from repro_torch.core import avss as t_avss
from repro_torch.core import encodings as t_enc
from repro_torch.core import mcam as t_mcam
from repro_torch.core import quantization as t_quant
from repro_torch.core.memory import MemoryConfig

torch.set_num_threads(1)

SCHEMES = [("mtmc", 1), ("mtmc", 4), ("mtmc", 8), ("mtmc", 32),
           ("b4e", 2), ("b4e", 4), ("b4e", 5), ("sre", 3), ("sre", 8),
           ("b4we", 2), ("b4we", 3)]


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- encodings -----------------------------------------------------------------


@pytest.mark.parametrize("name,cl", SCHEMES)
def test_encoders_and_luts_match(name, cl):
    """Every code word of every level, the weights and all three AVSS LUTs
    are equal (exact: integer tables)."""
    je, te = j_enc.make_encoding(name, cl), t_enc.make_encoding(name, cl)
    assert (te.name, te.cl, te.length, te.levels, te.weights) == \
        (je.name, je.cl, je.length, je.levels, je.weights)
    v = np.arange(je.levels, dtype=np.int32)
    np.testing.assert_array_equal(_np(te.encode(torch.as_tensor(v))),
                                  np.asarray(jax.jit(je.encode)(v)))
    np.testing.assert_array_equal(_np(te.weights_array()),
                                  np.asarray(je.weights_array()))
    for fn in ("avss_word_luts", "avss_sum_lut", "avss_max_lut"):
        a, b = getattr(j_enc, fn)(je), getattr(t_enc, fn)(te)
        assert a.dtype == b.dtype, fn
        np.testing.assert_array_equal(a, b, err_msg=fn)


def test_encoder_keeps_dtype_and_batch_shape():
    e = t_enc.make_encoding("mtmc", 4)
    v = torch.tensor([[0, 5], [12, 7]], dtype=torch.int32)
    w = e.encode(v)
    assert w.shape == (2, 2, 4) and w.dtype == torch.int32
    assert t_enc.CELL_STATES == j_enc.CELL_STATES
    assert t_enc.MAX_MISMATCH == j_enc.MAX_MISMATCH
    with pytest.raises(ValueError):
        t_enc.make_encoding("gray", 2)


# -- quantization --------------------------------------------------------------


@pytest.mark.parametrize("levels", [4, 97, 256])
def test_affine_quantize_given_range_is_exact(levels):
    rng = np.random.default_rng(levels)
    x = rng.normal(size=(64, 48)).astype(np.float32) * 2
    lo, hi = np.float32(-2.5), np.float32(3.25)
    a = j_quant.affine_quantize(jnp.asarray(x), levels, jnp.float32(lo),
                                jnp.float32(hi))
    b = t_quant.affine_quantize(torch.as_tensor(x), levels,
                                torch.tensor(lo), torch.tensor(hi))
    np.testing.assert_array_equal(np.asarray(a), _np(b))


def test_affine_quantize_rounds_half_to_even():
    """Trap: exact halves. jnp.round and torch.round both round half to
    even; floor(x + 0.5) would round 0.5 and 2.5 up."""
    x = np.array([0.5, 1.5, 2.5, 3.5, 2.0], np.float32)
    lo, hi = np.float32(0.0), np.float32(4.0)
    a = np.asarray(j_quant.affine_quantize(jnp.asarray(x), 5, lo, hi))
    b = _np(t_quant.affine_quantize(torch.as_tensor(x), 5,
                                    torch.tensor(lo), torch.tensor(hi)))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(b, [0, 2, 2, 4, 2])


def test_clip_range_matches_within_rtol():
    """Reductions (mean, std) run in another order in the two packages,
    so the low bits may differ: rtol 1e-6."""
    x = np.random.default_rng(1).normal(size=(300, 48)).astype(np.float32)
    jl, jh = j_quant.clip_range(jnp.asarray(x), 2.5)
    tl, th = t_quant.clip_range(torch.as_tensor(x), 2.5)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    np.testing.assert_allclose(float(th), float(jh), rtol=1e-6)


def test_clip_range_uses_population_std_exact_on_dyadic_sample():
    """Trap: jnp.std is the population std; torch.std's default
    correction=1 is not. On a dyadic sample of 256 values every reduction
    is exact, so both packages give the same bits -- and the sample
    std-corrected range would differ."""
    rng = np.random.default_rng(2)
    x = (rng.integers(-8, 9, size=256) / 4.0).astype(np.float32)
    jl, jh = j_quant.clip_range(jnp.asarray(x), 1.5)
    tl, th = t_quant.clip_range(torch.as_tensor(x), 1.5)
    assert float(tl) == float(jl) and float(th) == float(jh)
    xt = torch.as_tensor(x)
    sample_sd = xt.std() + 1e-8
    assert float(xt.mean() + 1.5 * sample_sd) != float(th)


# -- MCAM physics and the counter hash ----------------------------------------


def test_thresholds_and_config_defaults_match():
    for kw in ({}, {"string_len": 16, "n_thresholds": 12},
               {"rho": 4.0, "n_thresholds": 3}):
        jc, tc = j_mcam.MCAMConfig(**kw), t_mcam.MCAMConfig(**kw)
        np.testing.assert_array_equal(jc.thresholds(), tc.thresholds())
        assert jc.thresholds().dtype == tc.thresholds().dtype
    assert j_mcam.MCAMConfig() == j_mcam.MCAMConfig(
        **vars(t_mcam.MCAMConfig()))


def _coords(n, seed):
    """uint32 coordinates, half of them >= 2**31 (the trap: CPU torch has
    no full uint32 arithmetic, and an int32 view would go negative)."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 2**32, size=n, dtype=np.uint64)
    c[: n // 2] |= np.uint64(2**31)
    return c.astype(np.uint32)


def test_mix_is_bit_exact_on_full_uint32_range():
    c = _coords(4096, 0)
    a = np.asarray(j_mcam._mix(jnp.asarray(c))).astype(np.int64)
    b = _np(t_mcam._mix(torch.as_tensor(c.astype(np.int64))))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_hash_uniform_is_bit_exact(seed):
    """Also the trap of the uint32 -> f32 conversion, which must round to
    nearest (most hash values are above 2**24 and need rounding)."""
    a, b, c = _coords(4096, 1), _coords(4096, 2), np.arange(4096) % 24
    ju = np.asarray(j_mcam.hash_uniform(jnp.asarray(a), jnp.asarray(b),
                                        jnp.asarray(c, np.uint32),
                                        seed=seed))
    tu = _np(t_mcam.hash_uniform(torch.as_tensor(a.astype(np.int64)),
                                 torch.as_tensor(b.astype(np.int64)),
                                 torch.as_tensor(c), seed=seed))
    assert ju.dtype == tu.dtype == np.float32
    np.testing.assert_array_equal(ju, tu)
    assert (tu > 0).all() and (tu < 1).all()


def test_hash_normal_within_ulp_band():
    """Box-Muller: the uniforms are bit-exact, but log and cos come from
    two different libms (XLA's and the CPU's), so the normals may differ in
    the last bits: at most 4 ulp of the larger magnitude (measured: <= 3),
    and most are equal."""
    a, b = _coords(20000, 3), _coords(20000, 4)
    jn = np.asarray(j_mcam.hash_normal(jnp.asarray(a), jnp.asarray(b),
                                       seed=11))
    tn = _np(t_mcam.hash_normal(torch.as_tensor(a.astype(np.int64)),
                                torch.as_tensor(b.astype(np.int64)),
                                seed=11))
    band = 4 * np.spacing(np.maximum(np.abs(jn), np.abs(tn)))
    assert (np.abs(jn - tn) <= band).all()
    assert (jn == tn).mean() > 0.8


def _votes_explained(jc, tc, jv, tv, th, ulps=4):
    """Every vote that differs comes from a current within `ulps` ulp of
    a threshold in one of the two packages."""
    bad = jv != tv
    near = np.zeros_like(bad)
    for t in th:
        band = ulps * np.spacing(np.float32(t))
        near |= (np.abs(jc - t) <= band) | (np.abs(tc - t) <= band)
    return bool((~bad | near).all())


def test_string_current_votes_and_ideal_current():
    """XLA evaluates rho**m as exp(m log rho) and torch.pow does not, so
    even noiseless currents differ by ulps: rtol 5e-7, and a vote may
    differ only where a current lies within 4 ulp of a threshold (a
    string of s single-level mismatches reads exactly the s-th threshold).
    Noisy: currents agree to 1e-5 relative and votes on >= 99.9% of
    strings."""
    cfg_j, cfg_t = j_mcam.MCAMConfig(), t_mcam.MCAMConfig()
    rng = np.random.default_rng(5)
    mm = rng.integers(0, 4, size=(40, 16, 24)).astype(np.float32)
    jc = np.asarray(jax.jit(lambda m: j_mcam.string_current(m, cfg_j))(mm))
    tc = _np(t_mcam.string_current(torch.as_tensor(mm), cfg_t))
    np.testing.assert_allclose(tc, jc, rtol=5e-7)
    th = cfg_j.thresholds()
    jv = np.asarray(j_mcam.sa_votes(jnp.asarray(jc), cfg_j))
    tv = _np(t_mcam.sa_votes(torch.as_tensor(tc), cfg_t,
                             torch.as_tensor(th)))
    assert _votes_explained(jc, tc, jv, tv, th)
    qi = np.arange(40, dtype=np.uint32)[:, None]
    si = np.arange(16, dtype=np.uint32)[None, :]
    jn = np.asarray(jax.jit(lambda m, a, b: j_mcam.string_current(
        m, cfg_j, noise_idx=(a, b)))(mm, qi, si))
    tn = _np(t_mcam.string_current(
        torch.as_tensor(mm), cfg_t,
        noise_idx=(torch.as_tensor(qi.astype(np.int64)),
                   torch.as_tensor(si.astype(np.int64)))))
    np.testing.assert_allclose(tn, jn, rtol=1e-5)
    jv = np.asarray(j_mcam.sa_votes(jnp.asarray(jn), cfg_j))
    tv = _np(t_mcam.sa_votes(torch.as_tensor(tn), cfg_t))
    assert (jv == tv).mean() >= 0.999
    s = np.arange(0, 37, dtype=np.int32)
    np.testing.assert_allclose(
        _np(t_mcam.ideal_current(torch.as_tensor(s), cfg_t)),
        np.asarray(j_mcam.ideal_current(jnp.asarray(s), cfg_j)), rtol=1e-7)


# -- layouts and the reference search -----------------------------------------


@pytest.mark.parametrize("name,cl,d", [("mtmc", 8, 48), ("mtmc", 4, 30),
                                       ("b4e", 3, 7), ("sre", 3, 25)])
def test_layouts_and_string_ids_are_exact(name, cl, d):
    je, te = j_enc.make_encoding(name, cl), t_enc.make_encoding(name, cl)
    rng = np.random.default_rng(d)
    v = rng.integers(0, je.levels, size=(9, d)).astype(np.int32)
    q = rng.integers(0, 4, size=(3, d)).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(jax.jit(lambda x: j_avss.layout_support(x, je))(v)),
        _np(t_avss.layout_support(torch.as_tensor(v), te)))
    for mode in ("avss", "svss"):
        qq = q if mode == "avss" else v[:3]
        np.testing.assert_array_equal(
            np.asarray(jax.jit(lambda x: j_avss.layout_query(x, je, mode))(
                qq)),
            _np(t_avss.layout_query(torch.as_tensor(qq), te, mode)))
        assert t_avss.search_iterations(d, te, mode) == \
            j_avss.search_iterations(d, je, mode)
    assert t_avss.strings_per_support(d, te) == \
        j_avss.strings_per_support(d, je)
    seg = t_avss.n_segments(d)
    np.testing.assert_array_equal(
        np.asarray(j_avss._string_ids(9, seg, te.length)).astype(np.int64),
        _np(t_avss._string_ids(9, seg, te.length)))


def _search_inputs(seed, n=30, d=48, cl=8):
    je, te = j_enc.make_encoding("mtmc", cl), t_enc.make_encoding("mtmc", cl)
    rng = np.random.default_rng(seed)
    v = rng.integers(0, je.levels, size=(n, d)).astype(np.int32)
    q = rng.integers(0, 4, size=(4, d)).astype(np.int32)
    return je, te, v, q


@pytest.mark.parametrize("noisy", [False, True])
def test_votes_from_mismatch_matches_reference(noisy):
    """Noiseless: exact. Noisy: the device noise enters exp(), whose libm
    differs by ulps, so a current that lands within ulps of a threshold
    may flip one vote -- votes agree on >= 99% of (query, row) pairs and
    the summed mismatch `dist` stays exact."""
    je, te, v, q = _search_inputs(6)
    jcfg = j_avss.SearchConfig("mtmc", cl=8, noisy=noisy)
    tcfg = t_avss.SearchConfig("mtmc", cl=8, noisy=noisy)
    th = jcfg.mcam.thresholds()
    sg_j = j_avss.layout_support(jnp.asarray(v), je)
    sg_t = t_avss.layout_support(torch.as_tensor(v), te)
    one_query = jax.jit(lambda qg, b: j_avss._search_one_query(
        qg, sg_j, b, je.weights_array(), jcfg, jnp.asarray(th)))
    agree = []
    for b in range(q.shape[0]):
        qg_j = j_avss.layout_query(jnp.asarray(q[b:b + 1]), je, "avss")[0]
        qg_t = t_avss.layout_query(torch.as_tensor(q[b:b + 1]), te,
                                   "avss")[0]
        jv, jd = one_query(qg_j, jnp.uint32(b))
        tv, td = t_avss._search_one_query(qg_t, sg_t, b, te.weights_array(),
                                          tcfg, torch.as_tensor(th))
        np.testing.assert_array_equal(np.asarray(jd), _np(td))
        if noisy:
            agree.append((np.asarray(jv) == _np(tv)).mean())
        else:
            np.testing.assert_array_equal(np.asarray(jv), _np(tv))
    if noisy:
        assert np.mean(agree) >= 0.99


def test_prediction_heads_break_ties_like_the_reference():
    """Trap: ties. Votes tie, the smaller distance wins; distances tie
    too, the first index wins (argmin returns the first minimum)."""
    votes = np.array([[1., 3., 3., 3.], [2., 2., 2., 2.]], np.float32)
    dist = np.array([[0., 2., 1., 1.], [5., 5., 5., 5.]], np.float32)
    labels = np.array([10, 11, 12, 13], np.int32)
    jr = {"votes": jnp.asarray(votes), "dist": jnp.asarray(dist)}
    tr = {"votes": torch.as_tensor(votes), "dist": torch.as_tensor(dist)}
    np.testing.assert_array_equal(np.asarray(j_avss.best_support(jr)),
                                  _np(t_avss.best_support(tr)))
    np.testing.assert_array_equal(
        np.asarray(j_avss.predict_1nn(jr, jnp.asarray(labels))),
        _np(t_avss.predict_1nn(tr, torch.as_tensor(labels))))
    assert _np(t_avss.best_support(tr)).tolist() == [2, 0]


def test_config_dataclasses_match_field_for_field():
    from repro.core.memory import MemoryConfig as JMemoryConfig
    assert [f.name for f in __import__("dataclasses").fields(MemoryConfig)] \
        == [f.name for f in __import__("dataclasses").fields(JMemoryConfig)]
    tc, jc = MemoryConfig(), JMemoryConfig()
    assert (tc.capacity, tc.dim, tc.clip_std) == \
        (jc.capacity, jc.dim, jc.clip_std)
    ts, js = t_avss.SearchConfig(), j_avss.SearchConfig()
    for f in ("encoding", "cl", "mode", "noisy", "use_kernel",
              "query_chunk"):
        assert getattr(ts, f) == getattr(js, f), f
