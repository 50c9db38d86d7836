"""Shared fixtures + the two-tier test split.

Tiers (documented in ROADMAP.md):

  fast tier   `pytest -m "not slow"` -- everything that finishes in seconds;
              runs on every CI push.
  full tier   plain `pytest` -- adds the @pytest.mark.slow system / dry-run /
              multi-device-subprocess tests; runs on the weekly CI job and
              before releases.

Session-scoped fixtures hold the expensive shared setup (procedural dataset,
controller init + embedding forward) so the system/engine tests don't each
pay for it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running test (system pipelines, subprocess "
        "multi-device runs); deselect with -m 'not slow'")
    config.addinivalue_line(
        "markers", "cuda: runs a hand-written CUDA kernel of repro_torch on "
        "an NVIDIA GPU; skips where there is none")
    # Internal deprecation shims (repro.core.memory.search /
    # distributed_search) are promoted to ERRORS suite-wide, so migrated
    # callers cannot silently regress onto the legacy API. Modules that
    # deliberately exercise the shims (tests/test_memory.py, the legacy-API
    # suite) scope this back with a filterwarnings mark.
    config.addinivalue_line(
        "filterwarnings",
        "error:repro\\.core\\.memory:DeprecationWarning")


@pytest.fixture(autouse=True)
def _isolate_legacy_shim_warnings():
    """The shims warn once per PROCESS (core/memory._WARNED): without
    isolation, the first legitimate legacy-API test would latch the warning
    for the rest of the run and the error promotion above would never fire
    for a later regressed caller. Restoring the latch around every test
    keeps the promotion live suite-wide."""
    from repro.core import memory as mem
    saved = set(mem._WARNED)
    yield
    mem._WARNED.clear()
    mem._WARNED.update(saved)


@pytest.fixture(scope="session")
def fsl_episode():
    """One deterministic 5-way 5-shot episode of the procedural Omniglot."""
    from repro.data.fsl import EpisodeSampler, OmniglotLike
    ds = OmniglotLike(n_classes=20, image_size=20, seed=0)
    samp = EpisodeSampler(ds, np.arange(20), n_way=5, k_shot=5, n_query=4,
                          seed=0)
    return samp.episode(0)


@pytest.fixture(scope="session")
def conv4_embeddings(fsl_episode):
    """(params, support_embeddings, query_embeddings) of an untrained Conv4."""
    from repro.models.controller import apply_conv4, init_conv4
    params = init_conv4(jax.random.PRNGKey(0), in_ch=1, width=32,
                        embed_dim=24)
    s_emb = apply_conv4(params, jnp.asarray(fsl_episode.support_images))
    q_emb = apply_conv4(params, jnp.asarray(fsl_episode.query_images))
    return params, s_emb, q_emb


@pytest.fixture(scope="session")
def quantized_store():
    """Deterministic quantized (queries, supports) for engine parity tests:
    B=6 queries in [0,4), N=256 supports in [0, levels) at d=48, mtmc cl=8."""
    from repro.core.avss import SearchConfig
    from repro.core.mcam import MCAMConfig
    cfg = SearchConfig("mtmc", cl=8, mode="avss", mcam=MCAMConfig(),
                       use_kernel="ref")
    sv = jax.random.randint(jax.random.PRNGKey(0), (256, 48), 0,
                            cfg.enc.levels)
    qv = jax.random.randint(jax.random.PRNGKey(1), (6, 48), 0, 4)
    return cfg, qv, sv
