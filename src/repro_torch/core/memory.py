"""Legacy MANN external-memory API (port of `repro.core.memory`):
`MemoryConfig`, and thin deprecation shims over `MemoryStore`.

The store is `repro_torch.engine.store.MemoryStore` (its `write`
materialises the quantized values, the MTMC LUT projection and the
string-grid layout at write time), and every search goes through
`RetrievalEngine.search(store, queries, SearchRequest) -> SearchResult`.
This module keeps the pre-redesign dict-state functions working, with
the new API's results bit for bit:

  init_memory / calibrate / write ->  MemoryStore.create / .calibrate /
                                      .write
  search                          ->  engine.search(store, q,
                                      mode=full | two_phase)
  distributed_search              ->  engine.search(store.shard(mesh,
                                      axes), q)
  shard_state                     ->  MemoryStore.shard

A state dict holds `MemoryStore.to_state()`'s leaves (a mesh store's row
leaves as `ShardedRows`). The shims run on the device the state's leaves
are on; `init_memory` on `device` (default: the card). `search` and
`distributed_search` emit a DeprecationWarning once per process per
function.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from repro_torch.core import avss as avss_lib
from repro_torch.core.avss import SearchConfig


@dataclasses.dataclass(frozen=True)
class MemoryConfig:
    capacity: int = 2048
    dim: int = 48
    search: SearchConfig = dataclasses.field(default_factory=SearchConfig)
    clip_std: float = 2.5


_WARNED: set = set()


def _warn_once(name: str, replacement: str) -> None:
    if name in _WARNED:
        return
    _WARNED.add(name)
    warnings.warn(
        f"repro_torch.core.memory.{name} is deprecated; use {replacement}",
        DeprecationWarning, stacklevel=3)


def _store(state: dict, cfg: MemoryConfig):
    """The state's store, on the device of its leaves; a mesh state's row
    leaves assembled there (its pad rows included)."""
    from repro_torch.engine.sharded import ShardedRows
    from repro_torch.engine.store import MemoryStore
    values = state["values"]
    dev = (values.blocks[0] if isinstance(values, ShardedRows)
           else torch.as_tensor(values)).device
    state = {k: v.full(dev) if isinstance(v, ShardedRows) else v
             for k, v in state.items()}
    return MemoryStore.from_state(state, cfg, dev)


def init_memory(cfg: MemoryConfig,
                device: torch.device | str | None = None) -> dict:
    """The dict view of an empty MemoryStore (with the write-time `s_grid`
    layout beside `proj`)."""
    from repro_torch.engine.store import MemoryStore
    return MemoryStore.create(cfg, device).to_state()


def calibrate(state: dict, vectors, cfg: MemoryConfig) -> dict:
    """Set the quantization range from a sample of embeddings (std clipping
    clamped to the data extent, paper Sec. 3.3). Must run before the first
    write."""
    return _store(state, cfg).calibrate(vectors).to_state()


def write(state: dict, vectors, labels, cfg: MemoryConfig) -> dict:
    """Program a batch of support embeddings into the store (ring buffer)."""
    return _store(state, cfg).write(vectors, labels).to_state()


def quantize_queries(state: dict, queries) -> torch.Tensor:
    from repro_torch.engine.store import _quantize
    lo = torch.as_tensor(state["lo"])
    q = torch.as_tensor(queries).to(device=lo.device, dtype=torch.float32)
    return _quantize(q, 4, lo, torch.as_tensor(state["hi"]))


def search(state: dict, queries, cfg: MemoryConfig, two_phase: bool = False,
           k: int = 64, engine=None) -> dict:
    """DEPRECATED: AVSS over the whole store; use RetrievalEngine.search.

    Bit-identical to engine.search(MemoryStore.from_state(state, cfg),
    queries, SearchRequest(mode='two_phase' if two_phase else 'full', k)).
    """
    _warn_once("search", "RetrievalEngine.search(store, queries, "
                         "SearchRequest(...))")
    from repro_torch.engine import RetrievalEngine, SearchRequest
    eng = engine or RetrievalEngine(cfg.search)
    req = SearchRequest(mode="two_phase" if two_phase else "full", k=k)
    return eng.search(_store(state, cfg), queries, req).asdict()


def predict(result) -> torch.Tensor:
    """1-NN label prediction from a search result (SearchResult or legacy
    dict): max votes, vote ties broken by the ideal digital distance;
    masked slots carry -inf votes and lose."""
    if hasattr(result, "predict"):
        return result.predict()
    best = avss_lib.best_support(result)
    return torch.take_along_dim(result["labels"], best[:, None], dim=1)[:, 0]


# ---------------------------------------------------------------------------
# Distributed search: store rows sharded over mesh axes.
# ---------------------------------------------------------------------------


def shard_state(state: dict, mesh, axes, cfg: MemoryConfig | None = None
                ) -> dict:
    """The dict view of MemoryStore.shard: row-shard the store over
    `axes`. Pass `cfg` for ragged (non-divisible) splits: the pad rows'
    write-time layouts depend on the encoding, so a default config would
    pad with the wrong grid shape; divisible splits never pad and the
    3-argument form works."""
    n, d = state["values"].shape
    n_shards = int(np.prod([mesh.shape[a] for a in axes]))
    if cfg is None:
        if n % n_shards:
            raise ValueError(
                f"shard_state: {n} rows do not divide over {n_shards} "
                f"shards; ragged splits pad with encoding-dependent rows, "
                f"so pass cfg= (or use MemoryStore.shard directly)")
        cfg = MemoryConfig(capacity=n, dim=d)
    return _store(state, cfg).shard(mesh, axes).to_state()


def distributed_search(state: dict, queries, cfg: MemoryConfig, mesh,
                       axes=("data", "model"), k: int = 16,
                       exact: bool = True) -> dict:
    """DEPRECATED: block-parallel AVSS over the row-sharded store; use
    RetrievalEngine.search on a MemoryStore.shard(mesh, axes) store.

    exact=True: per-shard shortlist + exact noisy rescore with global rows
    feeding the noise counters, votes bit-identical to the single-device
    two-phase search; exact=False: the ideal digital distance only.
    """
    _warn_once("distributed_search",
               "RetrievalEngine.search(store.shard(mesh, axes), queries, "
               "SearchRequest(...))")
    from repro_torch.engine import RetrievalEngine, SearchRequest
    # shard() starts from the logical cfg.capacity rows, so a state that
    # shard_state already placed (ragged pad rows too) lands on the same
    # padded layout again
    store = _store(state, cfg).shard(mesh, tuple(axes))
    req = SearchRequest(mode="two_phase" if exact else "ideal", k=k)
    return RetrievalEngine(cfg.search).search(store, queries, req).asdict()
