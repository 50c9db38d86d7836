"""Parity of the port's language model (`repro_torch.models.{layers, moe,
ssm, transformer}`, `repro_torch.configs`) with the JAX package's, on the
CPU, for every family: dense GQA, MoE, MLA (deepseek-v3), attention with
Mamba (hymba), mLSTM / sLSTM (xlstm), embedding inputs (musicgen) and
M-RoPE (qwen2-vl), and the layer type "swa" and a soft-capped model on
variants of the smoke configs.

The JAX side runs under `jax.jit`; its `init` tree crosses over through
`transformer.params_from_numpy` (bf16 leaves as their 16-bit words), so
both packages run the same weights. Tolerances:

- float32 (`dataclasses.replace(cfg, dtype=param_dtype="float32")`):
  rtol = atol = 2e-5 on logits and layer outputs (measured: <= 9e-6;
  max |got - want| / (1 + |want|) of the models' logits <= 5e-6,
  deepseek-v3 and xlstm the largest), every family; the hidden state and
  the caches within 1e-4 (measured <= 3e-5).
- the configs' own bfloat16: the two packages round differently in the
  last bit (XLA rounds after each op of `gelu` / `silu` and keeps some dot
  outputs in float32 for the residual add they fuse with). Norms and
  attention on the same inputs are equal bit for bit; logits of the dense
  smoke models differ by at most 0.043 (qwen1.5-110b decode; xlstm
  0.042, llama3 0.035, qwen2-vl 0.035, musicgen 0.025, hymba 0.012,
  starcoder2 and command-r 0.006), held to BF16_LOGIT_ATOL. In a bf16
  MoE model such a last-bit difference can move a token's top-k experts,
  after which its logits are another function; so the bf16 MoE layer is
  held alone on the same inputs, and the MoE models in float32.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import load_config as j_load_config
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch import tree as tree_lib
from repro_torch.configs import ARCHS, load_config
from repro_torch.launch import steps as steps_lib
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT

torch.set_num_threads(1)

F32_TOL = 2e-5
BF16_LOGIT_ATOL = 0.0625
# a dense MLP / MoE layer in bf16 on the same inputs, of the output's
# largest entry (measured: one bf16 ulp of it, 0.0078 at |y| ~ 2 for the
# MLP, 0.25 at |y| ~ 58 for the MoE layer)
BF16_LAYER_RTOL = 2**-7
LM_ARCHS = tuple(a for a in ARCHS if hasattr(load_config(a, True), "n_layers"))
# smoke-config variants: the layer type "swa" (no shipped config uses it;
# window 4 < the 14 positions decoded, so its ring wraps) and a soft-capped
# model (ROADMAP C.P8: scores and logits divided by 30)
VARIANTS = {
    "swa": ("llama3-405b", dict(default_layer="swa", window=4,
                                global_attn_layers=(1,))),
    "softcap": ("starcoder2-3b", dict(logit_softcap=30.0)),
}
MOE_ARCHS = ("deepseek-moe-16b", "deepseek-v3-671b")
DENSE_ARCHS = tuple(a for a in LM_ARCHS if a not in MOE_ARCHS)
PROMPT, DECODE, BATCH = 6, 8, 2


def _cfgs(arch: str, dtype: str):
    if arch in VARIANTS:
        base, kw = VARIANTS[arch]
        jc, tc = _cfgs(base, dtype)
        return dataclasses.replace(jc, **kw), dataclasses.replace(tc, **kw)
    jc, tc = j_load_config(arch, True), load_config(arch, True)
    if dtype == "float32":
        jc = dataclasses.replace(jc, dtype=dtype, param_dtype=dtype)
        tc = dataclasses.replace(tc, dtype=dtype, param_dtype=dtype)
    return jc, tc


def _t(a) -> torch.Tensor:
    """A numpy / JAX array as a CPU tensor with the same bits."""
    return TT._tensor_of(np.asarray(a), "cpu")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def assert_close(got, want, tol=F32_TOL, atol=None):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol,
                               atol=tol if atol is None else atol)


def assert_bf16_layer_close(got, want):
    """Within BF16_LAYER_RTOL of the output's largest entry."""
    scale = float(np.abs(_np(want)).max())
    assert_close(got, want, tol=0, atol=BF16_LAYER_RTOL * scale)


@functools.cache
def _model(arch: str, dtype: str):
    """(jax cfg, port cfg, jax params, port params), one init per case."""
    jc, tc = _cfgs(arch, dtype)
    jp = JT.init(jax.random.PRNGKey(0), jc)
    tp = TT.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tc,
                              "cpu")
    return jc, tc, jp, tp


def _tokens(vocab: int, shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape)


def _inputs(cfg, S: int, seed: int) -> dict:
    """A batch of S positions in the config's input mode, numpy: token
    ids, or float32 embeddings with, for M-RoPE, position streams that
    differ (temporal, height, width)."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        return {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, S))}
    batch = {"embeddings": rng.standard_normal(
        (BATCH, S, cfg.d_model)).astype(np.float32)}
    if cfg.rope_type == "mrope":
        batch["positions3"] = rng.integers(0, 3 * S, (BATCH, S, 3)).astype(
            np.int32)
    return batch


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# -- configs and parameters ----------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_resolve_as_the_reference(arch):
    """Every --arch id resolves to the same shapes in both packages, full
    and smoke."""
    assert ARCHS == J_ARCHS
    for smoke in (False, True):
        got = load_config(arch, smoke)
        want = j_load_config(arch, smoke)
        as_dict = dataclasses.asdict
        assert type(got).__name__ == type(want).__name__
        if dataclasses.is_dataclass(got) and hasattr(got, "n_layers"):
            assert as_dict(got) == as_dict(want)
            assert got.layer_groups() == want.layer_groups()
            assert got.hd == want.hd
        else:
            assert repr(got).replace("repro_torch", "repro") == \
                repr(want).replace("repro_torch", "repro")


@pytest.mark.parametrize("arch", LM_ARCHS + ("swa",))
def test_init_tree_matches_reference(arch):
    """The port's `init` makes the reference's tree for every family: the
    same leaf names, shapes and dtypes (groups stacked on axis 0; no
    "embed" for embedding inputs), and its scales."""
    jc, tc = _cfgs(arch, "bfloat16")
    jp = JT.init(jax.random.PRNGKey(0), jc)
    tp = TT.init(torch.Generator().manual_seed(0), tc)
    jnames, jleaves = tree_lib.flatten_with_names(
        jax.tree_util.tree_map(np.asarray, jp))
    tnames, tleaves = tree_lib.flatten_with_names(tp)
    assert tnames == jnames
    for name, a, b in zip(jnames, jleaves, tleaves):
        assert tuple(b.shape) == a.shape, name
        assert str(b.dtype).split(".")[-1] == a.dtype.name, name
        sa, sb = float(np.std(a.astype(np.float32))), float(b.float().std())
        if sa == 0:
            assert sb == 0, name
        elif a.size >= 4096:
            assert abs(sb / sa - 1) < 0.1, (name, sa, sb)


def test_params_from_numpy_keeps_bits_and_module_holds_them():
    """bf16 leaves cross over bit for bit; `Transformer` holds the same
    tensors (no copy) and runs the pure functions."""
    jc, tc, jp, tp = _model("starcoder2-3b", "bfloat16")
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_lib.leaves(tp)):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            np.testing.assert_array_equal(b.view(torch.int16).numpy(),
                                          a.view(np.int16))
        else:
            np.testing.assert_array_equal(b.numpy(), a)
    model = TT.Transformer(tp, tc)
    for a, b in zip(tree_lib.leaves(model.tree()), tree_lib.leaves(tp)):
        assert a.data_ptr() == b.data_ptr()
    toks = torch.from_numpy(_tokens(tc.vocab_size, (BATCH, 3), 0))
    assert torch.equal(model({"tokens": toks})[0],
                       TT.forward(tp, tc, {"tokens": toks})[0])


@pytest.mark.parametrize("arch", ["xlstm-350m", "hymba-1.5b",
                                  "deepseek-v3-671b", "musicgen-medium",
                                  "qwen2-vl-7b"])
def test_params_from_numpy_carries_every_family(arch):
    """The new families' trees (mLSTM / sLSTM "cell", hymba's "mamba",
    MLA's wq_a .. wo_mla, no "embed" for embedding inputs) cross over
    with every leaf's bits; `Transformer` holds them and runs forward
    with the family's batch."""
    jc, tc, jp, tp = _model(arch, "bfloat16")
    jnames, jleaves = tree_lib.flatten_with_names(
        jax.tree_util.tree_map(np.asarray, jp))
    tnames, tleaves = tree_lib.flatten_with_names(tp)
    assert tnames == jnames
    assert ("embed" in tnames) == (tc.input_mode == "tokens")
    for a, b in zip(jleaves, tleaves):
        if a.dtype.name == "bfloat16":
            np.testing.assert_array_equal(b.view(torch.int16).numpy(),
                                          a.view(np.int16))
        else:
            np.testing.assert_array_equal(b.numpy(), a)
    model = TT.Transformer(tp, tc)
    batch = _torch_batch(_inputs(tc, 4, 1))
    assert torch.equal(model(batch)[0], TT.forward(tp, tc, batch)[0])


# -- layers --------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["starcoder2-3b", "llama3-405b"],
                         ids=["layernorm", "rmsnorm"])
def test_norm_matches_reference(arch, dtype):
    """Statistics in float32 (population variance, eps 1e-6): within
    F32_TOL in float32, equal bit for bit in bf16 (measured)."""
    jc, tc = _cfgs(arch, dtype)
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((2, 5, 64)) * 3 + 1, dtype)
    p = {k: v * (1 + 0.1 * jnp.arange(64.0)) + 0.05
         for k, v in JL.norm_init(jc).items()}
    want = jax.jit(lambda p, x: JL.apply_norm(p, x, jc))(p, x)
    got = TL.apply_norm({k: _t(v) for k, v in p.items()}, _t(x), tc)
    if dtype == "float32":
        assert_close(got, want)
    else:
        np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("theta", [10000.0, 5e5, 1e6, 75e6])
def test_rope_matches_reference(theta):
    """Frequencies equal the jitted reference's (its constant folded in
    float64) bit for bit; sin / cos and the rotation within F32_TOL."""
    want = np.asarray(jax.jit(lambda: JL.rope_freqs(128, theta))())
    np.testing.assert_array_equal(TL.rope_freqs(128, theta).numpy(), want)
    pos = np.arange(40, dtype=np.int32)
    js, jcos = jax.jit(lambda p: JL.rope_sincos(p, 16, theta))(pos)
    ts, tcos = TL.rope_sincos(torch.from_numpy(pos), 16, theta)
    assert_close(ts, js)
    assert_close(tcos, jcos)
    x = np.random.default_rng(2).standard_normal((2, 40, 3, 16)).astype(
        np.float32)
    assert_close(TL.apply_rope(torch.from_numpy(x), ts, tcos),
                 jax.jit(JL.apply_rope)(x, js, jcos))


ATTENTION_CASES = {
    # name: (S, T, window, chunk, kv_valid)
    "causal": (7, 7, 0, 0, False),
    "window": (7, 7, 3, 0, False),
    "kv_valid": (1, 9, 0, 0, True),
    "window_kv_valid": (2, 9, 4, 0, True),
    "chunked": (12, 12, 0, 4, False),
    "chunked_window": (12, 12, 5, 4, False),
}


@pytest.mark.parametrize("case", list(ATTENTION_CASES))
def test_dot_attention_matches_reference(case):
    """Both paths of `dot_attention`: one block (causal mask, window,
    kv_valid) and the online softmax over kv chunks (T > chunk), in
    float32, within F32_TOL; GQA with 2 query heads a kv head."""
    S, T, window, chunk, use_valid = ATTENTION_CASES[case]
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, S, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, T, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, T, 2, 8)).astype(np.float32)
    qpos = np.arange(T - S, T, dtype=np.int32)
    kpos = np.arange(T, dtype=np.int32)
    if use_valid:
        kpos[-2:] = np.iinfo(np.int32).max        # never-written slots
    valid = (rng.random((2, T)) > 0.2) if use_valid else None
    if valid is not None:
        valid[:, 0] = True
    kw = dict(window=window, chunk=chunk)
    want = jax.jit(lambda q, k, v, qp, kp, vl: JL.dot_attention(
        q, k, v, qpos=qp, kpos=kp, kv_valid=vl, **kw))(q, k, v, qpos, kpos,
                                                         valid)
    got = TL.dot_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        qpos=torch.from_numpy(qpos), kpos=torch.from_numpy(kpos),
        kv_valid=None if valid is None else torch.from_numpy(valid), **kw)
    assert_close(got, want)


@pytest.mark.parametrize("window", [0, 3], ids=["full", "ring"])
def test_attn_decode_cache_matches_reference(window):
    """attn_apply over a decode cache, step by step past its length: kpos
    starts at int32 max, the write slot is min(pos, T - 1) (full) or
    pos % T (a window's ring), valid is kpos <= pos; every output and
    cache leaf within F32_TOL."""
    jc, tc = _cfgs("starcoder2-3b", "float32")
    p = JL.attn_init(jax.random.PRNGKey(4), jc, jnp.float32)
    p = {**p, "bq": p["bq"] + 0.1, "bv": p["bv"] - 0.2}
    tp = {k: _t(v) for k, v in p.items()}
    T = 5
    jcache = JL.attn_cache_init(jc, 2, T, window, jnp.float32)
    tcache = TL.attn_cache_init(tc, 2, T, window, torch.float32, "cpu")
    np.testing.assert_array_equal(tcache["kpos"].numpy(),
                                  np.asarray(jcache["kpos"]))
    step = jax.jit(lambda p, x, c, pos: JL.attn_apply(
        p, x, jc, layer_window=window, cache=c, pos0=pos))
    xs = np.random.default_rng(5).standard_normal((8, 2, 1, 64)).astype(
        np.float32)
    for pos in range(8):
        jy, jcache = step(p, xs[pos], jcache, pos)
        ty, tcache = TL.attn_apply(tp, torch.from_numpy(xs[pos]), tc,
                                   layer_window=window, cache=tcache,
                                   pos0=pos)
        assert_close(ty, jy)
        for name in ("k", "v"):
            assert_close(tcache[name], jcache[name])
        np.testing.assert_array_equal(tcache["kpos"].numpy(),
                                      np.asarray(jcache["kpos"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["starcoder2-3b", "llama3-405b"],
                         ids=["gelu_bias", "swiglu"])
def test_mlp_matches_reference(arch, dtype):
    """The plain GELU MLP with biases (tanh approximation) and the gated
    SiLU MLP."""
    jc, tc = _cfgs(arch, dtype)
    p = JL.mlp_init(jax.random.PRNGKey(6), jc, jnp.dtype(dtype))
    if "mb1" in p:
        p = {**p, "mb1": p["mb1"] + 0.25, "mb2": p["mb2"] - 0.5}
    x = jnp.asarray(np.random.default_rng(7).standard_normal((2, 5, 64)),
                    dtype)
    want = jax.jit(lambda p, x: JL.mlp_apply(p, x, jc))(p, x)
    got = TL.mlp_apply({k: _t(v) for k, v in p.items()}, _t(x), tc)
    if dtype == "float32":
        assert_close(got, want)
    else:
        assert_bf16_layer_close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tokens,groups", [(6, 1), (12, 3), (40, 1)],
                         ids=["few", "grouped", "dropping"])
def test_moe_matches_reference(tokens, groups, dtype):
    """`moe_apply`: grouped capacity dispatch (40 tokens into 8 experts,
    top-2, capacity 16, drop tokens), shared experts, and both aux values
    (load balance, z-loss) within F32_TOL."""
    jc, tc = _cfgs("deepseek-moe-16b", dtype)
    moe = dataclasses.replace(jc.moe, groups=groups)
    jc = dataclasses.replace(jc, moe=moe)
    tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe,
                                                         groups=groups))
    p = JM.moe_init(jax.random.PRNGKey(8), jc, jnp.dtype(dtype))
    x = np.random.default_rng(9).standard_normal((2, tokens // 2, 64))
    if tokens == 40:
        # a shared direction, so most tokens pick the same experts and
        # their queues overflow
        x = x * 0.1 + 2.0 * np.asarray(p["router"])[:, 0] / np.linalg.norm(
            np.asarray(p["router"])[:, 0])
    x = jnp.asarray(x, dtype)
    (jy, jaux) = jax.jit(lambda p, x: JM.moe_apply(p, x, jc))(p, x)
    ty, taux = TM.moe_apply(tree_lib.tree_map(_t, jax.tree_util.tree_map(
        np.asarray, p)), _t(x), tc)
    if tokens == 40:
        sel = jax.nn.one_hot(jax.lax.top_k(jax.nn.softmax(
            jnp.asarray(x, jnp.float32).reshape(1, 40, 64) @ p["router"]),
            2)[1], 8).sum((1, 2))
        assert float(sel.max()) > JM._capacity(40, moe)  # tokens dropped
    if dtype == "float32":
        assert_close(ty, jy)
    else:
        assert_bf16_layer_close(ty, jy)
    for name in ("load_balance", "z_loss"):
        assert_close(taux[name], jaux[name])


# -- the model -------------------------------------------------------------------


def _run_both(arch: str, dtype: str):
    """forward over a prompt, then the prompt fed through decode_step
    (prefill) and DECODE more steps, in both packages -> dict of
    (port, jax) pairs: forward logits and aux, each decode step's logits
    and hidden state."""
    jc, tc, jp, tp = _model(arch, dtype)
    batch = _inputs(tc, PROMPT + DECODE, 10)
    prompt = {k: v[:, :PROMPT] for k, v in batch.items()}
    jl, jaux = jax.jit(lambda p, b: JT.forward(p, jc, b))(jp, prompt)
    tl, taux = TT.forward(tp, tc, _torch_batch(prompt))
    out = {"forward": (tl, jl), "load_balance": (taux["load_balance"],
                                                 jaux["load_balance"]),
           "z_loss": (taux["z_loss"], jaux["z_loss"]), "steps": []}
    jstep = jax.jit(lambda p, c, b, pos: JT.decode_step(
        p, jc, b, c, pos, return_hidden=True))
    jcache = JT.init_cache(jc, BATCH, PROMPT + DECODE)
    tcache = TT.init_cache(tc, BATCH, PROMPT + DECODE, "cpu")
    for pos in range(PROMPT + DECODE):
        b = {k: v[:, pos:pos + 1] for k, v in batch.items()}
        jlg, jcache, jh = jstep(jp, jcache, b, jnp.int32(pos))
        tlg, tcache, th = TT.decode_step(tp, tc, _torch_batch(b), tcache,
                                         pos, return_hidden=True)
        out["steps"].append({"logits": (tlg, jlg), "hidden": (th, jh)})
    out["caches"] = (tcache, jcache)
    return out


@pytest.mark.parametrize("arch", LM_ARCHS + tuple(VARIANTS))
def test_forward_and_decode_match_reference_f32(arch):
    """float32, every family: forward logits and aux values, and the
    logits and hidden state of every prefill and decode step, within
    F32_TOL; every cache leaf (KV rings, MLA's latents, the recurrent
    states) after the last step within it too; the port's decode of the
    prompt gives its forward's logits (the caches and states)."""
    out = _run_both(arch, "float32")
    assert_close(*out["forward"])
    assert_close(*out["load_balance"])
    assert_close(*out["z_loss"])
    for i, st in enumerate(out["steps"]):
        assert_close(*st["logits"])
        assert_close(*st["hidden"], tol=1e-4)
        if i < PROMPT:
            assert_close(st["logits"][0][:, 0], out["forward"][0][:, i])
    tcache, jcache = out["caches"]
    tnames, tleaves = tree_lib.flatten_with_names(tcache)
    jnames, jleaves = tree_lib.flatten_with_names(
        jax.tree_util.tree_map(np.asarray, jcache))
    assert tnames == jnames
    for name, a, b in zip(tnames, tleaves, jleaves):
        assert tuple(a.shape) == b.shape, name
        if name.endswith("kpos"):
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
        else:
            assert_close(a, b, tol=1e-4)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_forward_and_decode_match_reference_bf16(arch):
    """The configs' own bf16 (every family without MoE): forward and every
    decode step's logits within BF16_LOGIT_ATOL of the reference's, and
    of the port's own forward over the prompt."""
    out = _run_both(arch, "bfloat16")
    tl, jl = out["forward"]
    assert tl.dtype == torch.bfloat16
    assert_close(tl, jl, tol=0, atol=BF16_LOGIT_ATOL)
    for i, st in enumerate(out["steps"]):
        assert_close(*st["logits"], tol=0, atol=BF16_LOGIT_ATOL)
        if i < PROMPT:
            assert_close(st["logits"][0][:, 0], tl[:, i], tol=0,
                         atol=BF16_LOGIT_ATOL)


@pytest.mark.parametrize("divisor,dtype", [(30.0, "float32"),
                                           (6.0, "float32"),
                                           (math.sqrt(512), "bfloat16")],
                         ids=["softcap", "top_k", "mlstm_key_scale"])
def test_divisions_round_as_eager_jax(divisor, dtype):
    """ROADMAP C.P8: `layers.div` divides as JAX does, the Python divisor
    taking the dividend's dtype (weak typing) and the quotient rounded
    once: equal bit for bit to eager JAX on 10^5 normal inputs (a
    float32 divisor on a bf16 tensor differs on ~2% of them)."""
    x = np.random.default_rng(13).standard_normal(100_000).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    want = np.asarray(jx / divisor, np.float32)
    got = TL.div(_t(jx), divisor)
    assert str(got.dtype).endswith(dtype)
    np.testing.assert_array_equal(_np(got), want)


def test_prefill_step_matches_reference():
    """make_prefill_step: the last position's logits and the caches of
    `forward(return_cache=True)`, stacked per group."""
    jc, tc, jp, tp = _model("deepseek-moe-16b", "float32")
    prompt = _tokens(tc.vocab_size, (BATCH, PROMPT), 12)
    from repro.launch import steps as j_steps
    from repro.models.sharding import Rules
    rules = Rules(batch=(), fsdp=(), tensor=(), expert=())
    jl, jc_ = jax.jit(j_steps.make_prefill_step(jc, rules))(
        jp, {"tokens": prompt})
    tl, tc_ = steps_lib.make_prefill_step(tc)(
        tp, {"tokens": torch.from_numpy(prompt)})
    assert tl.shape == (BATCH, 1, tc.vocab_size)
    assert_close(tl, jl)
    for a, b in zip(tree_lib.leaves(tc_), jax.tree_util.tree_leaves(jc_)):
        assert tuple(a.shape) == np.shape(b)
        assert_close(a, b)


@pytest.mark.parametrize("arch", ["musicgen-medium", "qwen2-vl-7b"])
def test_step_functions_take_an_embeddings_batch(arch):
    """The embedding archs, which `serve` cannot feed (ROADMAP C.R4), run
    through `launch/steps`: make_prefill_step on an embeddings batch (with
    positions3 for M-RoPE) against the reference's, the last position's
    logits and every cache leaf within F32_TOL; make_serve_step is
    decode_step on the same embeddings and caches."""
    jc, tc, jp, tp = _model(arch, "float32")
    batch = _inputs(tc, PROMPT, 14)
    from repro.launch import steps as j_steps
    from repro.models.sharding import Rules
    rules = Rules(batch=(), fsdp=(), tensor=(), expert=())
    jl, jcaches = jax.jit(j_steps.make_prefill_step(jc, rules))(jp, batch)
    tl, tcaches = steps_lib.make_prefill_step(tc)(tp, _torch_batch(batch))
    assert tl.shape == (BATCH, 1, tc.vocab_size)
    assert_close(tl, jl)
    for a, b in zip(tree_lib.leaves(tcaches),
                    jax.tree_util.tree_leaves(jcaches)):
        assert tuple(a.shape) == np.shape(b)
        assert_close(a, b)
    step = _torch_batch({k: v[:, :1] for k, v in batch.items()})
    caches = TT.init_cache(tc, BATCH, PROMPT, "cpu")
    got, _ = steps_lib.make_serve_step(tc)(tp, caches, step, 0)
    want, _ = TT.decode_step(tp, tc, step, caches, 0)
    assert torch.equal(got, want)
