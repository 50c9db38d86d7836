"""LM token pipeline (port of `repro.data.lm`, numpy only, so the arrays
equal the reference's): deterministic, host-sharded, step-addressable.

Resumability/fault-tolerance contract: `batch_for_step(step)` is a pure
function of (seed, step, host shard), so restarting from a checkpoint at step
k replays exactly the batches k, k+1, ... with no data-loader state to
persist, and elastic restarts onto a different host count re-shard cleanly
(shard by global example index, not by host-local counters).

Two sources:
  * SyntheticLM -- structured random tokens (Zipf unigrams + per-document
    repeated motifs) so small models show real loss decrease.
  * BinTokenSource -- memory-mapped .bin of uint16/uint32 tokens for real
    corpora (numpy memmap).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0
    motif_len: int = 8
    motifs_per_doc: int = 4


class SyntheticLM:
    """Zipf background + repeated motifs => predictable structure."""

    def __init__(self, cfg: LMDataConfig):
        self.cfg = cfg
        rng = np.random.RandomState(cfg.seed)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks ** 1.1
        self._p = p / p.sum()
        self._motif_bank = rng.randint(
            0, cfg.vocab_size, size=(256, cfg.motif_len)).astype(np.int32)

    def _example(self, idx: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.RandomState((cfg.seed * 1_000_003 + idx) % 2**31)
        toks = rng.choice(cfg.vocab_size, size=cfg.seq_len + 1,
                          p=self._p).astype(np.int32)
        for _ in range(cfg.motifs_per_doc):
            m = self._motif_bank[rng.randint(256)]
            for _ in range(3):  # motif repeats inside the doc -> learnable
                s = rng.randint(0, cfg.seq_len + 1 - cfg.motif_len)
                toks[s:s + cfg.motif_len] = m
        return toks

    def batch_for_step(self, step: int, host_index: int = 0,
                       host_count: int = 1) -> dict[str, np.ndarray]:
        cfg = self.cfg
        per_host = cfg.global_batch // host_count
        base = step * cfg.global_batch + host_index * per_host
        ex = np.stack([self._example(base + i) for i in range(per_host)])
        return {"tokens": ex[:, :-1], "labels": ex[:, 1:]}


class BinTokenSource:
    """Memory-mapped pre-tokenized corpus (uint16 or uint32 .bin)."""

    def __init__(self, path: str, cfg: LMDataConfig, dtype=np.uint16):
        self.cfg = cfg
        self.data = np.memmap(path, dtype=dtype, mode="r")
        self.n_examples = (len(self.data) - 1) // cfg.seq_len

    def batch_for_step(self, step, host_index=0, host_count=1):
        cfg = self.cfg
        per_host = cfg.global_batch // host_count
        base = step * cfg.global_batch + host_index * per_host
        idx = (base + np.arange(per_host)) % self.n_examples
        tok = np.stack([
            self.data[i * cfg.seq_len: i * cfg.seq_len + cfg.seq_len + 1]
            for i in idx]).astype(np.int32)
        return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def embedding_batch_for_step(step: int, batch: int, seq: int, d_model: int,
                             vocab: int, seed: int = 0, mrope: bool = False):
    """Stub-frontend batches (audio/vlm archs): deterministic embeddings in
    place of token ids + (optionally) 3D M-RoPE positions."""
    rng = np.random.RandomState((seed * 7_777_777 + step) % 2**31)
    out = {
        "embeddings": rng.randn(batch, seq, d_model).astype(np.float32) * 0.02,
        "labels": rng.randint(0, vocab, size=(batch, seq)).astype(np.int32),
    }
    if mrope:
        t = np.arange(seq)
        hw = int(np.sqrt(seq)) + 1
        pos3 = np.stack([t, t // hw, t % hw], -1)
        out["positions3"] = np.broadcast_to(
            pos3[None], (batch, seq, 3)).astype(np.int32)
    return out
