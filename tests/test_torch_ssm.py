"""Parity of the port's recurrent blocks (`repro_torch.models.ssm`: mLSTM,
sLSTM, Mamba), multi-head latent attention and M-RoPE
(`repro_torch.models.layers`) with the JAX package's, on the CPU, in
float32 at smoke width.

Weights come from the reference's `*_init` and cross over bit for bit;
the JAX side runs under `jax.jit`. Tolerances:

F32_TOL (rtol = atol = 2e-5, as tests/test_torch_lm.py) for every output
and state leaf. Measured, as max |got - want| / (1 + |want|): chunkwise
mLSTM 5.8e-6 (two chunks of 4), its step form 2.6e-6, sLSTM 1.7e-6, MLA
4.6e-7, M-RoPE's sin / cos 4e-8, Mamba 3.8e-7: its scan is a loop over
time where the reference runs `associative_scan` (another order of
products; XLA also contracts `b * a + b'` under jit, ROADMAP C.R3). The
port's step forms against its own sequence forms (mLSTM's chunkwise
form, MLA's prefill) are other arithmetic for the same function, held
to F32_TOL as well.
"""

import functools

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
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT

torch.set_num_threads(1)

F32_TOL = 2e-5


def _cfgs(arch: str):
    jc, tc = j_load_config(arch, True), load_config(arch, True)
    f32 = dict(dtype="float32", param_dtype="float32")
    return dataclasses.replace(jc, **f32), dataclasses.replace(tc, **f32)


def _t(a) -> torch.Tensor:
    return TT._tensor_of(np.asarray(a), "cpu")


def _tree(jtree):
    return tree_lib.tree_map(_t, jax.tree_util.tree_map(np.asarray, jtree))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def assert_close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def assert_tree_close(got: dict, want: dict, tol=F32_TOL):
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == np.shape(want[k]), k
        assert_close(got[k], want[k], tol)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# block -> (arch, init, state_init, apply_seq, apply_step) of each package
BLOCKS = {
    "mlstm": ("xlstm-350m", "mlstm_init", "mlstm_state_init",
              "mlstm_apply_seq", "mlstm_apply_step"),
    "slstm": ("xlstm-350m", "slstm_init", "slstm_state_init",
              "slstm_apply_seq", "slstm_apply_step"),
    "mamba": ("hymba-1.5b", "mamba_init", "mamba_state_init",
              "mamba_apply_seq", "mamba_apply_step"),
}


@functools.cache
def _block(name: str):
    arch, init, _, seq, step = BLOCKS[name]
    jc, tc = _cfgs(arch)
    jp = getattr(JS, init)(jax.random.PRNGKey(3), jc, jnp.float32)
    jseq = jax.jit(lambda p, x, s: getattr(JS, seq)(p, x, jc, s))
    jstep = jax.jit(lambda p, x, s: getattr(JS, step)(p, x, jc, s))
    return jc, tc, jp, _tree(jp), jseq, jstep


def _states(name: str, jc, tc, batch: int):
    state_init = BLOCKS[name][2]
    return (getattr(JS, state_init)(jc, batch),
            getattr(TS, state_init)(tc, batch, "cpu"))


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_init_and_state_match_reference(name):
    """`*_init` makes the reference's leaves (names, shapes, dtypes; the
    constant ones equal: gate and forget biases and Mamba's skip, its
    a_log = log(1..ds) within F32_TOL: XLA's float32 log rounds log 7 up
    a bit, torch's to nearest) and `*_state_init` its state bit for bit
    (-1e30 stabilisers, n of 1e-6)."""
    arch, init = BLOCKS[name][:2]
    jc, tc = j_load_config(arch, True), load_config(arch, True)
    jp = getattr(JS, init)(jax.random.PRNGKey(0), jc, jnp.bfloat16)
    tp = getattr(TS, init)(torch.Generator().manual_seed(0), tc,
                           torch.bfloat16)
    assert sorted(tp) == sorted(jp)
    for k, a in jp.items():
        a = np.asarray(a)
        assert tuple(tp[k].shape) == a.shape, k
        assert str(tp[k].dtype).split(".")[-1] == a.dtype.name, k
        if k in ("gate_bias", "d_skip") or k.startswith("b_"):
            np.testing.assert_array_equal(tp[k].numpy(), a, err_msg=k)
        elif k == "a_log":
            assert_close(tp[k], a)
    lo, hi = np.log(np.expm1(1e-3)), np.log(np.expm1(1e-1))
    if name == "mamba":
        dt_bias = tp["dt_bias"].numpy()
        assert (dt_bias >= lo - 1e-4).all() and (dt_bias <= hi + 1e-4).all()
    js, ts = _states(name, jc, tc, 2)
    for k in js:
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]), k)


@pytest.mark.parametrize("name", list(BLOCKS))
def test_state_init_takes_the_reference_dtype(name):
    """`*_state_init(..., dtype=torch.bfloat16)` builds the reference's
    `dtype=jnp.bfloat16` state: the same leaves, shapes and dtypes, and
    the same bf16 words (the -1e30 stabilisers and sLSTM's 1e-6 fill
    rounded once to bf16)."""
    arch, _, state_init = BLOCKS[name][:3]
    jc, tc = j_load_config(arch, True), load_config(arch, True)
    js = getattr(JS, state_init)(jc, 2, dtype=jnp.bfloat16)
    ts = getattr(TS, state_init)(tc, 2, "cpu", dtype=torch.bfloat16)
    assert sorted(ts) == sorted(js)
    for k, a in js.items():
        a = np.asarray(a)
        assert a.dtype.name == "bfloat16", k
        assert ts[k].dtype == torch.bfloat16, k
        assert tuple(ts[k].shape) == a.shape, k
        np.testing.assert_array_equal(ts[k].view(torch.int16).numpy(),
                                      a.view(np.int16), err_msg=k)


@pytest.mark.parametrize("name,S,chunk", [("mlstm", 8, 64), ("mlstm", 12, 4),
                                          ("slstm", 8, None),
                                          ("mamba", 8, None)],
                         ids=["mlstm", "mlstm_chunks", "slstm", "mamba"])
def test_block_seq_matches_reference(name, S, chunk):
    """apply_seq from the initial state, then again from the state it
    left (the carried state seeds the chunk recurrence, the sLSTM loop,
    Mamba's scan and its convolution ring): outputs and every state leaf
    within F32_TOL."""
    jc, tc, jp, tp, jseq, _ = _block(name)
    kw = {} if chunk is None else {"chunk": chunk}
    if chunk is not None:
        jseq = jax.jit(lambda p, x, s: JS.mlstm_apply_seq(p, x, jc, s,
                                                          chunk=chunk))
    js, ts = _states(name, jc, tc, 2)
    for i in range(2):
        x = _x((2, S, jc.d_model), 20 + i)
        jy, js = jseq(jp, x, js)
        ty, ts = getattr(TS, BLOCKS[name][3])(tp, torch.from_numpy(x), tc,
                                              ts, **kw)
        assert_close(ty, jy)
        assert_tree_close(ts, js)


def test_mlstm_seq_refuses_a_ragged_chunk():
    """S must be a multiple of min(chunk, S), as the reference asserts."""
    jc, tc, jp, tp, _, _ = _block("mlstm")
    with pytest.raises(ValueError, match="multiple of the chunk"):
        TS.mlstm_apply_seq(tp, torch.zeros(1, 6, jc.d_model), tc, chunk=4)


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_step_matches_reference(name):
    """apply_step, 6 steps from the initial state: every output and state
    leaf within F32_TOL; the steps' outputs equal apply_seq's over the
    same inputs within F32_TOL too (the chunkwise mLSTM is another
    arithmetic of the same recurrence)."""
    jc, tc, jp, tp, _, jstep = _block(name)
    js, ts = _states(name, jc, tc, 2)
    x = _x((2, 6, jc.d_model), 30)
    ys = []
    for t in range(6):
        jy, js = jstep(jp, x[:, t:t + 1], js)
        ty, ts = getattr(TS, BLOCKS[name][4])(
            tp, torch.from_numpy(x[:, t:t + 1]), tc, ts)
        assert tuple(ty.shape) == (2, 1, jc.d_model)
        assert_close(ty, jy)
        assert_tree_close(ts, js)
        ys.append(ty)
    seq, _ = getattr(TS, BLOCKS[name][3])(tp, torch.from_numpy(x), tc)
    assert_close(torch.cat(ys, 1), seq)


# -- multi-head latent attention --------------------------------------------


@functools.cache
def _mla():
    jc, tc = _cfgs("deepseek-v3-671b")
    jp = JL.mla_init(jax.random.PRNGKey(4), jc, jnp.float32)
    # norm scales off 1, so a wrong scale shows
    jp = {**jp, "q_norm": jp["q_norm"] * 1.5, "kv_norm": jp["kv_norm"] - .25}
    return jc, tc, jp, _tree(jp)


def test_mla_init_matches_reference():
    jc, tc = j_load_config("deepseek-v3-671b", True), \
        load_config("deepseek-v3-671b", True)
    jp = JL.mla_init(jax.random.PRNGKey(0), jc, jnp.bfloat16)
    tp = TL.mla_init(torch.Generator().manual_seed(0), tc, torch.bfloat16)
    assert sorted(tp) == sorted(jp)
    for k, a in jp.items():
        assert tuple(tp[k].shape) == a.shape, k
        assert str(tp[k].dtype).split(".")[-1] == np.asarray(a).dtype.name
    jcache = JL.mla_cache_init(jc, 2, 5, jnp.bfloat16)
    tcache = TL.mla_cache_init(tc, 2, 5, torch.bfloat16, "cpu")
    for k in jcache:
        assert tuple(tcache[k].shape) == jcache[k].shape
        np.testing.assert_array_equal(_np(tcache[k]), _np(jcache[k]))


def test_mla_prefill_matches_reference():
    """Prefill: keys and values expanded per head, qk width nope + rope =
    24 against value width 16; the output and the latent cache (ckv,
    krope, kpos) within F32_TOL."""
    jc, tc, jp, tp = _mla()
    x = _x((2, 7, jc.d_model), 40)
    jy, jcache = jax.jit(lambda p, x: JL.mla_apply(p, x, jc))(jp, x)
    ty, tcache = TL.mla_apply(tp, torch.from_numpy(x), tc)
    assert tuple(ty.shape) == (2, 7, jc.d_model)
    assert_close(ty, jy)
    assert_tree_close(tcache, jcache)


def test_mla_absorbed_decode_matches_reference():
    """Decode past a cache of 5 positions (the write slot clamps to the
    last): the absorbed form against the cached latents, every output and
    cache leaf within F32_TOL; the first 5 steps' outputs equal prefill's
    over the same inputs within it too (absorbed against expanded)."""
    jc, tc, jp, tp = _mla()
    T = 5
    jcache = JL.mla_cache_init(jc, 2, T, jnp.float32)
    tcache = TL.mla_cache_init(tc, 2, T, torch.float32, "cpu")
    step = jax.jit(lambda p, x, c, pos: JL.mla_apply(p, x, jc, cache=c,
                                                     pos0=pos))
    xs = _x((2, 7, jc.d_model), 41)
    prefill, _ = TL.mla_apply(tp, torch.from_numpy(xs[:, :T]), tc)
    for pos in range(7):
        x = xs[:, pos:pos + 1]
        jy, jcache = step(jp, x, jcache, pos)
        ty, tcache = TL.mla_apply(tp, torch.from_numpy(x), tc, cache=tcache,
                                  pos0=pos)
        assert_close(ty, jy)
        assert_tree_close(tcache, jcache)
        if pos < T:
            assert_close(ty[:, 0], prefill[:, pos])


# -- M-RoPE -------------------------------------------------------------------


@pytest.mark.parametrize("dim,sections,theta", [(16, (4, 2, 2), 10000.0),
                                                (128, (16, 24, 24), 1e6)],
                         ids=["smoke", "qwen2-vl-7b"])
def test_mrope_sincos_matches_reference(dim, sections, theta):
    """Each frequency slot takes its section's position stream: sin / cos
    within F32_TOL of the reference's one-hot pick (temporal, height and
    width streams that differ); sections that do not cover dim / 2
    raise."""
    rng = np.random.default_rng(5)
    pos3 = rng.integers(0, 300, (2, 9, 3)).astype(np.int32)
    js, jcos = jax.jit(lambda p: JL.mrope_sincos(p, dim, theta,
                                                 sections))(pos3)
    ts, tcos = TL.mrope_sincos(torch.from_numpy(pos3), dim, theta, sections)
    assert tuple(ts.shape) == (2, 9, dim // 2)
    assert_close(ts, js)
    assert_close(tcos, jcos)
    with pytest.raises(ValueError, match="sections"):
        TL.mrope_sincos(torch.from_numpy(pos3), dim + 2, theta, sections)


def test_attn_apply_with_mrope_matches_reference():
    """qwen2-vl's attention (qkv biases, M-RoPE): prefill over 6 positions
    and 4 decode steps with their positions3, each within F32_TOL; a
    config that needs positions3 and gets none raises."""
    jc, tc = _cfgs("qwen2-vl-7b")
    jp = JL.attn_init(jax.random.PRNGKey(6), jc, jnp.float32)
    jp = {**jp, "bq": jp["bq"] + 0.1, "bk": jp["bk"] - 0.2}
    tp = _tree(jp)
    rng = np.random.default_rng(7)
    pos3 = rng.integers(0, 12, (2, 10, 3)).astype(np.int32)
    x = _x((2, 10, jc.d_model), 42)
    jy, _ = jax.jit(lambda p, x, p3: JL.attn_apply(p, x, jc, positions3=p3))(
        jp, x[:, :6], pos3[:, :6])
    ty, _ = TL.attn_apply(tp, torch.from_numpy(x[:, :6]), tc,
                          positions3=torch.from_numpy(pos3[:, :6]))
    assert_close(ty, jy)
    jcache = JL.attn_cache_init(jc, 2, 10, 0, jnp.float32)
    tcache = TL.attn_cache_init(tc, 2, 10, 0, torch.float32, "cpu")
    step = jax.jit(lambda p, x, c, pos, p3: JL.attn_apply(
        p, x, jc, cache=c, pos0=pos, positions3=p3))
    for pos in range(4):
        sl = slice(pos, pos + 1)
        jy, jcache = step(jp, x[:, sl], jcache, pos, pos3[:, sl])
        ty, tcache = TL.attn_apply(tp, torch.from_numpy(x[:, sl]), tc,
                                   cache=tcache, pos0=pos,
                                   positions3=torch.from_numpy(pos3[:, sl]))
        assert_close(ty, jy)
    with pytest.raises(ValueError, match="positions3"):
        TL.attn_apply(tp, torch.from_numpy(x[:, :2]), tc)
