"""The port's paper-evaluation twin (`repro_torch.examples.fsl_omniglot`)
against the JAX package's `examples/fsl_omniglot.py`, loaded by path, on
the CPU (the quickstart twin: tests/test_torch_quickstart.py).

The JAX side searches on `backend="ref"`: its `auto` full search reaches
the Pallas string-search kernel, which the installed JAX cannot run
(ROADMAP C.R2, R1). Its searches and controller run under `jax.jit`
(eager JAX is ~10x slower here). The example's episodes are deterministic
in (seed, index), so the tests cache them: each evaluation cell draws the
same episodes.

What is held (ROADMAP's parity standard): the quantized store words and
query words of every episode equal (the two controllers' embeddings may
differ in the last ulps, so a word could land in the next level at a bin
edge: the test names every such word, and expects none at its size);
predictions, distances and accuracies equal; a vote that differs is
explained by a string current within 4 ulp of a sense-amp threshold in
one of the packages (the Box-Muller log / cos and exp of two libms).
Measured: no vote differed (2 episodes x 32 x 40 votes a full cell).
"""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.engine as j_engine_pkg
from repro.core import avss as j_avss
from repro.core import mcam as j_mcam
from repro.core.avss import SearchConfig as JSearchConfig
from repro.core.mcam import MCAMConfig as JMCAMConfig
from repro.engine import RetrievalEngine as JEngine
from repro.models import controller as j_ctrl
from repro_torch.configs.omniglot_conv4 import get_smoke_config
from repro_torch.core import avss as t_avss
from repro_torch.core import mcam as t_mcam
from repro_torch.core import prng
from repro_torch.core.avss import SearchConfig
from repro_torch.core.mcam import MCAMConfig
from repro_torch.data import fsl as t_fsl
from repro_torch.engine import RetrievalEngine
from repro_torch.examples import fsl_omniglot
from repro_torch.models import controller as t_ctrl

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
VOTE_BAND_ULPS = 4
EPISODES = 2


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _JittedRefEngine:
    """The JAX engine on the ref backend, each search under jax.jit;
    every (store, queries, result) is appended to `calls`."""

    calls: list = []

    def __init__(self, cfg, backend="ref"):
        self.eng = JEngine(cfg, backend="ref")

    def search(self, store, queries, request):
        res = jax.jit(lambda s, q: self.eng.search(s, q, request))(
            store, jnp.asarray(queries))
        self.calls.append((store, np.asarray(queries), res))
        return res


class _CachedSampler(t_fsl.EpisodeSampler):
    """The example's sampler, each episode made once."""

    @functools.lru_cache(maxsize=None)
    def episode(self, index):
        return super().episode(index)


@pytest.fixture(scope="module")
def eval_setup():
    """A Conv4 controller of the JAX package (width 16, the smoke
    configuration's 24-d embeddings) carried across, and the example's
    held-out sampler (8-way 5-shot, 4 queries a class)."""
    fsl = get_smoke_config()
    jp = jax.tree_util.tree_map(np.asarray, j_ctrl.init_conv4(
        jax.random.PRNGKey(0), in_ch=1, width=16, embed_dim=fsl.embed_dim))
    ds = t_fsl.OmniglotLike(fsl.n_train_classes + fsl.n_test_classes,
                            image_size=fsl.image_size, seed=0)
    test_ids = np.arange(fsl.n_train_classes,
                         fsl.n_train_classes + fsl.n_test_classes)
    sampler = _CachedSampler(ds, test_ids, n_way=8, k_shot=5, n_query=4,
                             seed=77)
    return fsl, jp, sampler


@functools.partial(jax.jit, static_argnums=3)
def _j_currents(q_words, s_grid, b, cfg):
    """(N, seg, L) noisy string currents of the query words q_words (1, d)
    at query coordinate b against every row, as the reference's full
    search evaluates them."""
    q_grid = j_avss.layout_query(q_words, cfg.enc, cfg.mode)[0]
    mm = jnp.abs(q_grid[None].astype(jnp.int32)
                 - s_grid.astype(jnp.int32)).astype(jnp.float32)
    n, seg, L = mm.shape[:3]
    return j_mcam.string_current(
        mm, cfg.mcam, noise_idx=(b, j_avss._string_ids(n, seg, L)))


def _t_currents(q_words, s_grid, b, cfg):
    """The port's `_j_currents`."""
    q_grid = t_avss.layout_query(q_words, cfg.enc, cfg.mode)[0]
    mm = (q_grid[None].to(torch.int32)
          - s_grid.to(torch.int32)).abs().to(torch.float32)
    n, seg, L = mm.shape[:3]
    return t_mcam.string_current(
        mm, cfg.mcam, noise_idx=(torch.tensor(b),
                                 t_avss._string_ids(n, seg, L))).numpy()


def _explain(jcall, tcall, jcfg, tcfg):
    """Every (query, row) whose votes differ has a string whose current
    lies within VOTE_BAND_ULPS ulp of a threshold in one of the packages.
    The currents are recomputed per query; that they give the recorded
    votes is checked on query 0 and on every query with a differing vote.
    Returns the number of differing votes."""
    (js, jq, jr), (ts, tq, tr) = jcall, tcall
    jv, tv = np.asarray(jr.votes), tr.votes.numpy()
    diff = np.argwhere(jv != tv)
    th = jcfg.mcam.thresholds()
    w = np.asarray(jcfg.enc.weights, np.float32)
    for b in sorted(set(diff[:, 0].tolist()) | {0}):
        jc = np.asarray(_j_currents(jnp.asarray(jq[b:b + 1]), js.s_grid,
                                    jnp.uint32(b), jcfg))
        tc = _t_currents(torch.as_tensor(tq[b:b + 1]), ts.s_grid, b, tcfg)
        for cur, votes in ((jc, jv), (tc, tv)):
            count = (cur[..., None] > th).sum(-1).astype(np.float32)
            np.testing.assert_array_equal((count * w).sum((1, 2)), votes[b])
        near = np.zeros(jc.shape, bool)
        for t in th:
            band = VOTE_BAND_ULPS * np.spacing(np.float32(t))
            near |= (np.abs(jc - t) <= band) | (np.abs(tc - t) <= band)
        for n in diff[diff[:, 0] == b, 1]:
            assert near[n].any(), (b, n, jv[b, n], tv[b, n])
    return len(diff)


# (encoding, cl, mode, two_phase): the matrix's encodings under AVSS, by
# the full search and by two_phase (shortlist + rescore), and MTMC SVSS
CELLS = [("mtmc", 8, "avss", False), ("b4e", 3, "avss", False),
         ("sre", 4, "avss", False), ("mtmc", 8, "svss", False),
         ("mtmc", 8, "avss", True), ("b4e", 3, "avss", True),
         ("sre", 4, "avss", True)]


@pytest.mark.parametrize("enc,cl,mode,two_phase", CELLS)
def test_evaluate_equals_the_reference(eval_setup, monkeypatch, enc, cl,
                                       mode, two_phase):
    """One evaluation cell of both examples on the same weights and
    episodes: the same store and query words, predictions, distances and
    (mean, std) accuracy; differing votes explained (module docstring)."""
    fsl, jp, sampler = eval_setup
    jmod = _load("fsl_omniglot")
    monkeypatch.setattr(jmod, "embed_apply", jax.jit(j_ctrl.apply_conv4))
    monkeypatch.setattr(j_engine_pkg, "RetrievalEngine", _JittedRefEngine)
    monkeypatch.setattr(_JittedRefEngine, "calls", [])
    tcalls = []
    search = RetrievalEngine.search

    def spy(self, store, queries, request=None):
        res = search(self, store, queries, request)
        tcalls.append((store, queries.numpy(), res))
        return res
    monkeypatch.setattr(RetrievalEngine, "search", spy)

    mcam = dict(sigma_device=0.15, sigma_read=0.05)
    jcfg = JSearchConfig(enc, cl=cl, mode=mode, mcam=JMCAMConfig(**mcam),
                         use_kernel="ref")
    tcfg = SearchConfig(enc, cl=cl, mode=mode, mcam=MCAMConfig(**mcam))
    want = jmod.evaluate({"backbone": jp}, sampler, jcfg,
                         episodes=EPISODES, backend="ref",
                         two_phase=two_phase)
    got = fsl_omniglot.evaluate(
        {"backbone": t_ctrl.conv4_from_numpy(jp)}, sampler, tcfg,
        episodes=EPISODES, two_phase=two_phase)
    jcalls = _JittedRefEngine.calls
    assert len(jcalls) == len(tcalls) == EPISODES
    moved = []
    for e, (jc, tc) in enumerate(zip(jcalls, tcalls)):
        for what, a, b in (("store", np.asarray(jc[0].values),
                            tc[0].values.numpy()),
                           ("query", jc[1], tc[1])):
            moved += [(e, what, tuple(i)) for i in np.argwhere(a != b)]
        for f in ("dist", "indices", "labels"):
            np.testing.assert_array_equal(np.asarray(getattr(jc[2], f)),
                                          getattr(tc[2], f).numpy())
        np.testing.assert_array_equal(np.asarray(jc[2].predict()),
                                      tc[2].predict().numpy())
        if not two_phase:       # two_phase rows are full-search rows
            _explain(jc, tc, jcfg, tcfg)
    assert not moved, f"words in another level: {moved}"
    assert got == want


def test_two_phase_votes_are_the_full_search_votes_of_their_rows(eval_setup):
    """On the twin, the two_phase votes of every shortlisted row equal the
    full search's votes of that row (the engine's contract), so the
    two_phase cells' votes are explained by the full cells'."""
    _, jp, sampler = eval_setup
    params = {"backbone": t_ctrl.conv4_from_numpy(jp)}
    cfg = SearchConfig("b4e", cl=3, mcam=MCAMConfig(sigma_device=0.15,
                                                   sigma_read=0.05))
    eng = RetrievalEngine(cfg)
    ep = sampler.episode(1000)
    from repro_torch.core.quantization import quantize_asymmetric
    from repro_torch.engine import MemoryStore, SearchRequest
    with torch.no_grad():
        s = t_ctrl.apply_conv4(params["backbone"],
                               torch.as_tensor(ep.support_images))
        q = t_ctrl.apply_conv4(params["backbone"],
                               torch.as_tensor(ep.query_images))
    qv, sv = quantize_asymmetric(q, s, cfg.enc.levels)
    store = MemoryStore.from_quantized(sv.to(torch.int32), ep.support_labels,
                                       cfg, device="cpu")
    full = eng.search(store, qv.to(torch.int32), SearchRequest(mode="full"))
    tp = eng.search(store, qv.to(torch.int32),
                    SearchRequest(mode="two_phase", k=64))
    assert torch.equal(torch.take_along_dim(full.votes, tp.indices, dim=1),
                       tp.votes)


def test_serve_loop_check_reports_true(eval_setup, capsys):
    _, jp, sampler = eval_setup
    hat_cfg = fsl_omniglot.HATConfig(search=SearchConfig(
        "mtmc", cl=8, mcam=MCAMConfig(sigma_device=0.15, sigma_read=0.05)))
    assert fsl_omniglot.serve_loop_check(
        {"backbone": t_ctrl.conv4_from_numpy(jp)}, sampler, hat_cfg)
    assert "(bitwise): True" in capsys.readouterr().out


@pytest.mark.parametrize("extra", [[], ["--two-phase-eval",
                                        "--engine-backend", "fused"]],
                         ids=["full", "two_phase_fused"])
def test_main_runs_on_the_cpu(monkeypatch, capsys, extra):
    """`main` with 1 + 1 training steps on the CPU: every cell of the
    matrix has an accuracy in [0, 1], the serve check holds, and stage 2's
    step key is `jax.random.PRNGKey(step)`'s key data."""
    monkeypatch.setattr(fsl_omniglot, "EpisodeSampler", _CachedSampler)
    keys = []
    make = fsl_omniglot.make_hat_train_steps

    def recording(*a, **kw):
        pre, meta, place = make(*a, **kw)

        def meta_step(params, state, episode, key):
            keys.append(np.asarray(key))
            return meta(params, state, episode, key)
        return pre, meta_step, place
    monkeypatch.setattr(fsl_omniglot, "make_hat_train_steps", recording)
    out = fsl_omniglot.main(["--device", "cpu", "--pretrain-steps", "1",
                             "--meta-steps", "2", *extra])
    text = capsys.readouterr().out
    assert out["serve_parity"] and "(bitwise): True" in text
    assert len(out["matrix"]) == 8
    assert all(0.0 <= acc <= 1.0 for acc, _ in out["matrix"].values())
    assert [k.tolist() for k in keys] == [
        np.asarray(jax.random.key_data(jax.random.PRNGKey(s))).tolist()
        for s in range(2)] == [prng.PRNGKey(s).tolist() for s in range(2)]
