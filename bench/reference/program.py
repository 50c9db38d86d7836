"""The plain reference put in the program's place, with the interface the
harness drives (create, calibrate, write, search, predict): the control of
the check, run in a lower precision than the configuration's, which has to
come out not correct."""

from __future__ import annotations

import torch

from bench.reference import mcam


class Reference:
    def __init__(self, config: dict, device, dtype=torch.bfloat16):
        self.config, self.device, self.dtype = config, device, dtype

    def create(self) -> "_Store":
        return _Store(mcam.Store(self.config, self.device, self.dtype))

    def request(self, mode: str, k: int) -> tuple[str, int]:
        return mode, k

    def search(self, store: "_Store", queries: torch.Tensor, request):
        mode, k = request
        if mode == "two_phase":
            out = mcam.two_phase(queries, store.ref, k, self.dtype)
        else:
            out = mcam.full(queries, store.ref,
                            torch.arange(queries.shape[0],
                                         device=queries.device), self.dtype)
        return _Result(out)


class _Store:
    """A reference store read and written as the program's is."""

    def __init__(self, ref: mcam.Store):
        self.ref = ref

    def calibrate(self, sample: torch.Tensor) -> "_Store":
        self.ref.calibrate(sample)
        return self

    def write(self, x: torch.Tensor, labels: torch.Tensor) -> "_Store":
        self.ref.write(x, labels)
        return self

    def quantize_queries(self, q: torch.Tensor) -> torch.Tensor:
        return self.ref.query_words(q)

    @property
    def values(self) -> torch.Tensor:
        return self.ref.words

    @property
    def labels(self) -> torch.Tensor:
        return self.ref.labels

    @property
    def size(self) -> torch.Tensor:
        return torch.tensor(self.ref.size)

    @property
    def lo(self) -> torch.Tensor:
        return self.ref.lo

    @property
    def hi(self) -> torch.Tensor:
        return self.ref.hi


class _Result:
    def __init__(self, out: dict):
        self.votes, self.dist = out["votes"], out["dist"]
        self.indices, self.labels = out["rows"], out["labels"]
        self._pred = out["pred"]

    def predict(self) -> torch.Tensor:
        return self._pred
