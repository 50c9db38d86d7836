"""Parity of the port's LM serving path (`repro_torch.launch.steps.
make_serve_step_with_mcam` / `knn_lm_head`, `launch.serve.serve`,
`examples.serve_retrieval`) with the JAX package's, on the CPU.

The JAX side decodes starcoder2-3b's smoke config (bf16) under `jax.jit`
with `return_hidden=True` (and hymba-1.5b's, xlstm-350m's and
deepseek-v3-671b's, the other token families); the same hidden rows
(carried across bit for bit) query a token store programmed by the JAX
package and carried across with `MemoryStore.from_numpy`, so both
engines search the same store with the same queries. The search results of the kNN-LM head (labels, votes,
indices, distances) must be equal bit for bit in `two_phase`, `ideal` and
routed search (the JAX side on backend "ref", as its `serve` pins it; the
port on "ref", on its default "auto" route and on "fused", each of whose
plain versions must give the same bits). The mixed log-probabilities are
held to MIXED_ATOL: the reference's serve step recomputes the decode in
its own jitted program, and its softmax over the bf16 logits rounds in
bf16 where the port's rounds once.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import load_config as j_load_config
from repro.core.avss import SearchConfig as JSearchConfig
from repro.core.memory import MemoryConfig as JMemoryConfig
from repro.engine import MemoryStore as JStore
from repro.engine import RetrievalEngine as JEngine
from repro.engine import SearchRequest as JRequest
from repro.launch import serve as j_serve
from repro.launch import steps as j_steps
from repro.models import transformer as JT
from repro.models.sharding import Rules
from repro_torch.configs import load_config
from repro_torch.core.avss import SearchConfig
from repro_torch.core.memory import MemoryConfig
from repro_torch.engine import MemoryStore, RetrievalEngine, SearchRequest
from repro_torch.examples import serve_retrieval
from repro_torch.launch import serve as serve_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.models import transformer as TT

torch.set_num_threads(1)

ARCH = "starcoder2-3b"
# the token families PR 20's starcoder2-3b does not cover: attention with
# Mamba, mLSTM / sLSTM, MLA with MoE
FAMILIES = ("hymba-1.5b", "xlstm-350m", "deepseek-v3-671b")
BATCH, PROMPT, STEPS = 4, 3, 4
DIM, K, SHARDS, NPROBE, LAM = 48, 32, 8, 2, 0.3
# |mixed log-prob| differences: measured max 0.0139 in every mode (the
# last bits of the bf16 softmax and of (1 - lam) p_lm, in the log)
MIXED_ATOL = 0.02
LEAVES = ("labels", "votes", "indices", "dist")
RULES = Rules(batch=(), fsdp=(), tensor=(), expert=())
FIELDS = ("values", "proj", "proj_packed", "s_grid", "labels", "size",
          "lo", "hi", "sketch_sums", "sketch_counts", "calibrated")


def _t(a) -> torch.Tensor:
    return TT._tensor_of(np.asarray(a), "cpu")


@functools.cache
def _setup(arch: str = ARCH):
    """The JAX model and decode, step by step (tokens, pos, caches before
    the step, logits, hidden), and the token store in both packages,
    unsharded and in SHARDS shards."""
    jc, tc = j_load_config(arch, True), load_config(arch, True)
    jp = JT.init(jax.random.PRNGKey(0), jc)
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((256, DIM)).astype(np.float32)
    toks = rng.integers(0, jc.vocab_size, 256)
    jmem = JMemoryConfig(capacity=1024, dim=DIM, search=JSearchConfig(
        "mtmc", cl=8, mode="avss", use_kernel="ref"))
    tmem = MemoryConfig(capacity=1024, dim=DIM,
                        search=SearchConfig("mtmc", cl=8, mode="avss"))
    js = JStore.create(jmem).calibrate(jnp.asarray(vecs)).write(
        jnp.asarray(vecs), jnp.asarray(toks))
    leaves = {f: np.asarray(getattr(js, f), np.float32 if f == "proj"
                            else None) for f in FIELDS}
    ts = MemoryStore.from_numpy(leaves, tmem, device="cpu")
    stores = {None: (js, ts), NPROBE: (js.shard(n_shards=SHARDS),
                                       ts.shard(n_shards=SHARDS))}
    step = jax.jit(lambda p, c, t, pos: JT.decode_step(
        p, jc, {"tokens": t}, c, pos, return_hidden=True))
    caches = JT.init_cache(jc, BATCH, PROMPT + STEPS)
    tok = rng.integers(0, jc.vocab_size, (BATCH, 1))
    trace = []
    for pos in range(PROMPT + STEPS):
        logits, new, hidden = step(jp, caches, tok, jnp.int32(pos))
        trace.append((tok, pos, caches, logits, hidden))
        caches = new
        tok = (rng.integers(0, jc.vocab_size, (BATCH, 1)) if pos < PROMPT
               else np.asarray(jnp.argmax(logits[:, 0], -1))[:, None])
    return jc, tc, jp, jmem, tmem, stores, trace


@pytest.mark.parametrize("backend", ["ref", "auto", "fused"])
@pytest.mark.parametrize("nprobe", [None, NPROBE], ids=["store", "routed"])
@pytest.mark.parametrize("mode", ["two_phase", "ideal"])
def test_head_search_equals_reference_bit_for_bit(mode, nprobe, backend):
    """Every step's hidden rows search both stores: labels, votes,
    indices and distances equal, and the hidden rows have the reference's
    dtype (the residual stream before the final norm, in bf16)."""
    jc, tc, jp, jmem, tmem, stores, trace = _setup()
    js, ts = stores[nprobe]
    jreq = JRequest(mode=mode, k=K, nprobe=nprobe)
    jsearch = jax.jit(lambda s, q: JEngine(jmem.search).search(s, q, jreq))
    eng = RetrievalEngine(tmem.search, backend=backend)
    for tok, pos, _, _, hidden in trace:
        assert hidden.dtype == jnp.bfloat16 and hidden.shape == (
            BATCH, 1, jc.d_model)
        q = hidden[:, 0][:, :DIM]
        want = jsearch(js, q)
        got = eng.search(ts, _t(q), SearchRequest(mode=mode, k=K,
                                                  nprobe=nprobe))
        for f in LEAVES:
            np.testing.assert_array_equal(
                getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                err_msg=f"{mode} nprobe={nprobe} {backend} pos={pos}: {f}")


@pytest.mark.parametrize("mode", ["two_phase", "ideal"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_head_search_equals_reference_for_every_token_family(arch, mode):
    """The same for the other token families' smoke models (bf16 hidden
    rows of hymba's attention + Mamba, xlstm's mLSTM / sLSTM and
    deepseek-v3's MLA + MoE layers): on the default route, every step's
    search equal to JAX's bit for bit."""
    jc, tc, jp, jmem, tmem, stores, trace = _setup(arch)
    js, ts = stores[None]
    jreq = JRequest(mode=mode, k=K)
    jsearch = jax.jit(lambda s, q: JEngine(jmem.search).search(s, q, jreq))
    eng = RetrievalEngine(tmem.search)
    for tok, pos, _, _, hidden in trace:
        assert hidden.dtype == jnp.bfloat16
        q = hidden[:, 0][:, :DIM]
        want = jsearch(js, q)
        got = eng.search(ts, _t(q), SearchRequest(mode=mode, k=K))
        for f in LEAVES:
            np.testing.assert_array_equal(
                getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                err_msg=f"{arch} {mode} pos={pos}: {f}")


@pytest.mark.parametrize("mode,nprobe", [("dense", None),
                                         ("two_phase", None),
                                         ("ideal", None),
                                         ("two_phase", NPROBE)],
                         ids=["dense", "two_phase", "ideal", "routed"])
def test_head_mixture_matches_reference(mode, nprobe):
    """The reference's serve step (its decode and head in one program)
    against the port's `knn_lm_head` on the same logits and hidden rows:
    float32 log-probabilities of shape (B, 1, V) within MIXED_ATOL."""
    jc, tc, jp, jmem, tmem, stores, trace = _setup()
    js, ts = stores[nprobe]
    dense = mode == "dense"
    jstep = jax.jit(j_steps.make_serve_step_with_mcam(
        jc, RULES, jmem, lam=LAM,
        engine=None if dense else JEngine(jmem.search), k=K,
        mode="two_phase" if dense else mode, nprobe=nprobe))
    eng = None if dense else RetrievalEngine(tmem.search)
    req = None if dense else SearchRequest(mode=mode, k=K, nprobe=nprobe)
    worst = 0.0
    for tok, pos, caches, logits, hidden in trace:
        want, _ = jstep(jp, caches, {"tokens": tok}, jnp.int32(pos), js)
        got = steps_lib.knn_lm_head(_t(logits), _t(hidden), ts, DIM,
                                    tc.vocab_size, LAM, eng, req)
        assert got.dtype == torch.float32
        assert got.shape == want.shape == (BATCH, 1, tc.vocab_size)
        worst = max(worst, float(np.abs(got.numpy() - np.asarray(want))
                                 .max()))
    assert worst <= MIXED_ATOL, worst


class _LargestOutput(TorchDispatchMode):
    """The most elements of any tensor an operator returns."""

    def __init__(self):
        super().__init__()
        self.most = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.most = max(self.most, t.numel())
        return out


@pytest.mark.parametrize("mode", ["dense", "two_phase"])
def test_head_makes_no_one_hot_at_the_full_vocabulary(mode):
    """At DeepSeek-V3's vocabulary of 129,280 the head adds each
    candidate's weight into its label's entry: no operator returns more
    than the (B, V) mixture's elements (a (B, k, V) one-hot would be K
    times that)."""
    _, tc, _, _, tmem, stores, trace = _setup()
    _, ts = stores[None]
    vocab = 129280
    _, _, _, _, hidden = trace[-1]
    logits = torch.randn(BATCH, 1, vocab)
    eng = None if mode == "dense" else RetrievalEngine(tmem.search)
    req = None if mode == "dense" else SearchRequest(mode=mode, k=K)
    with _LargestOutput() as seen:
        got = steps_lib.knn_lm_head(logits, _t(hidden), ts, DIM, vocab,
                                    LAM, eng, req)
    assert got.shape == (BATCH, 1, vocab)
    assert seen.most <= max(BATCH * vocab, BATCH * ts.labels.shape[0])
    assert BATCH * K * vocab > 4 * seen.most


def test_serve_step_with_mcam_runs_the_head_on_the_decode():
    """The port's serve step is its decode_step followed by knn_lm_head on
    that step's logits and hidden state; the caches advance as the plain
    serve step's do."""
    jc, tc, jp, jmem, tmem, stores, trace = _setup()
    tp = TT.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tc,
                              "cpu")
    _, ts = stores[None]
    eng = RetrievalEngine(tmem.search)
    step = steps_lib.make_serve_step_with_mcam(tc, tmem, lam=LAM,
                                               engine=eng, k=K)
    plain = steps_lib.make_serve_step(tc)
    caches = TT.init_cache(tc, BATCH, PROMPT + STEPS, "cpu")
    tok = torch.zeros((BATCH, 1), dtype=torch.int64)
    for pos in range(3):
        mixed, new = step(tp, caches, {"tokens": tok}, pos, ts)
        logits, new_plain = plain(tp, caches, {"tokens": tok}, pos)
        _, _, hidden = TT.decode_step(tp, tc, {"tokens": tok}, caches, pos,
                                      return_hidden=True)
        assert torch.equal(mixed, steps_lib.knn_lm_head(
            logits, hidden, ts, DIM, tc.vocab_size, LAM, eng,
            SearchRequest(mode="two_phase", k=K)))
        for a, b in zip(new, new_plain):
            assert all(torch.equal(a[f], b[f]) for f in a)
        caches, tok = new, torch.argmax(mixed[:, 0], -1)[:, None]


@pytest.mark.parametrize("kwargs", [
    dict(retrieval=True),
    dict(retrieval=True, retrieval_mode="ideal"),
    dict(retrieval=True, retrieval_mode="dense"),
    dict(retrieval=True, retrieval_shards=SHARDS,
         retrieval_nprobe=NPROBE, retrieval_fused_min_rows=256),
    dict(retrieval=False),
    dict(arch="deepseek-moe-16b", retrieval=True),
    dict(arch="hymba-1.5b", retrieval=True),
    dict(arch="hymba-1.5b", retrieval=False),
    dict(arch="xlstm-350m", retrieval=True),
    dict(arch="xlstm-350m", retrieval=False),
    dict(arch="deepseek-v3-671b", retrieval=True),
    dict(arch="deepseek-v3-671b", retrieval=False),
], ids=["two_phase", "ideal", "dense", "routed", "plain", "moe",
        "hymba", "hymba_plain", "xlstm", "xlstm_plain", "mla", "mla_plain"])
def test_serve_runs_on_the_cpu(kwargs, capsys):
    """`serve` decodes every retrieval mode, and every token family with
    and without the head, on `device="cpu"`, returns (batch, steps) token
    ids and prints its throughput line; the same seed gives the same
    tokens."""
    kwargs = {"arch": ARCH, **kwargs}
    arch = kwargs.pop("arch")
    run = functools.partial(serve_lib.serve, arch, True, 2, 3, 2,
                            device="cpu", **kwargs)
    toks = run()
    cfg = load_config(arch, True)
    assert toks.shape == (2, 3)
    assert ((toks >= 0) & (toks < cfg.vocab_size)).all()
    assert f"{arch}: 3 steps x 2 reqs in" in capsys.readouterr().out
    np.testing.assert_array_equal(run(), toks)


@pytest.mark.parametrize("arch", ["musicgen-medium", "qwen2-vl-7b"])
def test_serve_of_an_embedding_arch_raises_as_the_reference(arch):
    """ROADMAP C.R4: the reference's `serve` feeds token ids, and a model
    of embedding inputs reads `batch["embeddings"]`, so both packages
    raise KeyError('embeddings'); these archs run through `forward` /
    `decode_step` and the step functions with an embeddings batch."""
    with pytest.raises(KeyError, match="embeddings"):
        j_serve.serve(arch, True, 2, 2, 2)
    with pytest.raises(KeyError, match="embeddings"):
        serve_lib.serve(arch, True, 2, 2, 2, device="cpu")


def test_serve_cli_runs_on_cpu_and_raises_without_a_card(capsys):
    """`python -m repro_torch.launch.serve --retrieval --device cpu`
    prints its tok/s line; without --device it asks for the card, which
    raises where there is none (nothing falls back to the CPU)."""
    serve_lib.main(["--arch", ARCH, "--batch", "2", "--steps", "2",
                    "--prompt-len", "2", "--retrieval", "--device", "cpu"])
    assert "tok/s) on cpu" in capsys.readouterr().out
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lib.main(["--arch", ARCH, "--steps", "1", "--retrieval"])


def test_example_twin_runs_on_the_cpu(capsys):
    """The twin of examples/serve_retrieval.py: prefill through the decode
    path, then decode with the dense kNN-LM head; finite log-probs."""
    out = serve_retrieval.main(["--device", "cpu", "--steps", "2",
                                "--prompt-len", "3", "--batch", "2"])
    assert out["tokens"].shape == (2, 3)
    assert out["logits"].dtype == torch.float32
    assert torch.isfinite(out["logits"]).all()
    assert "OK: serve_step_with_mcam end-to-end" in capsys.readouterr().out
