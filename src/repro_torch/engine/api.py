"""The typed request / result contract of the retrieval API (port of
`repro.engine.api`): `RetrievalEngine.search(store, queries,
SearchRequest) -> SearchResult`."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import _build

MODES = ("full", "two_phase", "ideal")
#: the profiler range (`_build.profiler_range`) of `SearchResult.predict`
PREDICT_TAG = "engine.predict"


@dataclasses.dataclass(frozen=True)
class SearchRequest:
    """What to search (the same fields and meaning as the JAX package).

    mode: 'full' (exact noisy search of every row), 'two_phase' (ideal-
    distance shortlist + exact noisy rescore of the top-k) or 'ideal'
    (ideal-distance top-k only). k: candidate count of the shortlist
    modes. backend: 'auto' defers to the engine. nprobe: the shards a
    routed search visits on a partitioned store (None: every shard).
    axes: the mesh axes a mesh-sharded store is searched over (None: the
    store's own; ignored on an unsharded store). fused_min_rows, noisy:
    per-request overrides of the engine's."""

    mode: str = "two_phase"
    k: int = 64
    backend: str = "auto"
    axes: tuple[str, ...] | None = None
    fused_min_rows: int | None = None
    noisy: bool | None = None
    nprobe: int | None = None

    def __post_init__(self) -> None:
        if self.mode not in MODES:
            raise ValueError(
                f"unknown search mode {self.mode!r}; expected one of {MODES}")
        if self.nprobe is not None:
            if self.mode == "full":
                raise ValueError(
                    "SearchRequest: nprobe routes the shortlist modes "
                    "('two_phase' / 'ideal'); mode='full' scores every "
                    "row by definition")
            if self.nprobe < 1:
                raise ValueError(f"SearchRequest: nprobe must be >= 1, "
                                 f"got {self.nprobe}")


@dataclasses.dataclass(frozen=True)
class SearchResult:
    """One result type for every mode and backend.

    votes (B, K): MCAM vote scores (-inf on masked / empty candidates; for
    'ideal', -dist). dist (B, K): ideal digital distance (masked rows carry
    SHORTLIST_MASK_PENALTY). indices (B, K): store rows (int64). labels
    (B, K): candidate labels (-1 on empty slots). iterations: word-line
    cycles per query."""

    votes: torch.Tensor
    dist: torch.Tensor
    indices: torch.Tensor
    labels: torch.Tensor
    iterations: int = 0

    def best(self) -> torch.Tensor:
        """(B,) position of the best candidate: max votes, vote ties broken
        by ideal distance, then by index (`argmin` returns the first
        minimum)."""
        top = self.votes.max(dim=-1, keepdim=True).values
        masked = torch.where(self.votes == top, self.dist,
                             torch.full_like(self.dist, float("inf")))
        return torch.argmin(masked, dim=-1)

    def predict(self) -> torch.Tensor:
        """(B,) 1-NN label prediction; -1 when the store holds no valid
        candidate."""
        with _build.profiler_range(PREDICT_TAG):
            return torch.take_along_dim(self.labels, self.best()[:, None],
                                        dim=1)[:, 0]

    def asdict(self) -> dict[str, torch.Tensor | int]:
        return {"votes": self.votes, "dist": self.dist,
                "indices": self.indices, "labels": self.labels,
                "iterations": self.iterations}
