"""The port's LM token pipeline (`repro_torch.data.lm`, numpy only)
against the JAX package's `repro.data.lm`: every array equal, with the
same dtype, for the synthetic corpus (steps, host shards), a
memory-mapped .bin corpus written here, and the stub-frontend embedding
batches (with and without M-RoPE positions); and the trainer's
`make_batch` of both packages."""

import numpy as np
import pytest
import torch

from repro.configs import load_config as j_load_config
from repro.configs.base import ShapeConfig as JShape
from repro.data import lm as J
from repro.launch import train as j_train
from repro_torch.configs import load_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import lm as T
from repro_torch.launch import train as t_train

torch.set_num_threads(1)


def _assert_same(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("seed,seq,batch,vocab", [(0, 32, 4, 256),
                                                  (3, 17, 6, 1000)])
def test_synthetic_batches_equal_the_reference(seed, seq, batch, vocab):
    cfg = dict(seq_len=seq, global_batch=batch, vocab_size=vocab, seed=seed)
    j, t = J.SyntheticLM(J.LMDataConfig(**cfg)), T.SyntheticLM(
        T.LMDataConfig(**cfg))
    for step in (0, 1, 7):
        _assert_same(t.batch_for_step(step), j.batch_for_step(step))
    # host sharding: each of 2 hosts takes its half of the global batch
    for host in (0, 1):
        _assert_same(t.batch_for_step(5, host, 2),
                     j.batch_for_step(5, host, 2))
    whole = t.batch_for_step(5)["tokens"]
    halves = [t.batch_for_step(5, h, 2)["tokens"] for h in (0, 1)]
    np.testing.assert_array_equal(np.concatenate(halves), whole)


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
def test_bin_token_source_equals_the_reference(tmp_path, dtype):
    path = tmp_path / "corpus.bin"
    rng = np.random.default_rng(1)
    rng.integers(0, 60000, 1001).astype(dtype).tofile(path)
    cfg = dict(seq_len=16, global_batch=4, vocab_size=60000)
    j = J.BinTokenSource(str(path), J.LMDataConfig(**cfg), dtype=dtype)
    t = T.BinTokenSource(str(path), T.LMDataConfig(**cfg), dtype=dtype)
    assert t.n_examples == j.n_examples == 62
    for step in (0, 3, 15, 16):            # 16 wraps around the corpus
        _assert_same(t.batch_for_step(step), j.batch_for_step(step))
    _assert_same(t.batch_for_step(2, 1, 2), j.batch_for_step(2, 1, 2))


@pytest.mark.parametrize("mrope", [False, True])
def test_embedding_batches_equal_the_reference(mrope):
    for step, seed in ((0, 0), (4, 2)):
        kw = dict(step=step, batch=3, seq=20, d_model=16, vocab=100,
                  seed=seed, mrope=mrope)
        _assert_same(T.embedding_batch_for_step(**kw),
                     J.embedding_batch_for_step(**kw))


@pytest.mark.parametrize("arch", ["starcoder2-3b", "qwen2-vl-7b",
                                  "musicgen-medium"])
def test_make_batch_equals_the_reference(arch):
    """(accum, microbatch, ...) leaves: token ids and labels, or
    embeddings, labels and positions3, as the reference's trainer makes
    them."""
    jc, tc = j_load_config(arch, True), load_config(arch, True)
    seq, batch, accum, mb = 12, 4, 2, 2
    data = T.SyntheticLM(T.LMDataConfig(seq, batch, tc.vocab_size))
    jdata = J.SyntheticLM(J.LMDataConfig(seq, batch, jc.vocab_size))
    got = t_train.make_batch(tc, ShapeConfig("s", seq, batch, "train"), data,
                             3, accum, mb, "cpu")
    want = j_train.make_batch(jc, JShape("s", seq, batch, "train"), jdata,
                              3, accum, mb)
    assert all(v.device.type == "cpu" for v in got.values())
    _assert_same({k: v.numpy() for k, v in got.items()}, want)
