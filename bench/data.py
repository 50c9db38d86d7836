"""The one generator of every cell's inputs, drawn on the device from the
seed: the store's supports, the query batches and the classes written
while serving. What it draws is set by the configuration (dimension,
classes, shots, the embedding's scale and spread) and the traffic mix
(batch, writes); the program only ever receives the tensors.

Every class c is one run of `shots` consecutive positions of the write
stream (positions [c shots, (c + 1) shots)); the initial supports are the
first `classes` classes and each write appends `write_classes` more, so
the ring of `capacity` rows holds positions [P - capacity, P) after P
positions. A query draws its class from the classes still whole in the
ring, uniformly where the mix's `class_skew` is 0, and else by Zipf's law
of that exponent over their ranks, newest class first; and its embedding
around that class's centre with fresh spread, so no batch of queries
repeats.
"""

from __future__ import annotations

import torch


class Inputs:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed % 2 ** 63)
        self.dim, self.shots = config["dim"], config["shots"]
        self.capacity = config["capacity"]
        self.scale = config["embedding"]["centre_scale"]
        self.spread = config["embedding"]["spread"]
        self.classes = config["classes"]
        self.skew = traffic["class_skew"]
        self._zipf: tuple[int, torch.Tensor | None] = (0, None)
        # centres of the classes a query can still draw live in a ring
        self.slots = self.classes + 2 * traffic["write_classes"] + 2
        self.centres = torch.empty(self.slots, self.dim, device=self.device)
        self.centres[:self.classes] = self._randn(self.classes) * self.scale
        self.next_class = self.classes

    def _randn(self, rows: int) -> torch.Tensor:
        return torch.randn(rows, self.dim, generator=self.gen,
                           device=self.device)

    def _members(self, c0: int, c1: int) -> tuple[torch.Tensor, torch.Tensor]:
        labels = torch.arange(c0, c1, device=self.device).repeat_interleave(
            self.shots)
        x = self.centres[labels % self.slots] + self.spread * self._randn(
            labels.shape[0])
        return x, labels.to(torch.int32)

    def supports(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The initial store: every class's shots, (classes x shots, dim)
        float32 and their int32 labels."""
        return self._members(0, self.classes)

    def new_classes(self, count: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The next `count` classes: fresh centres and their shots."""
        c0, c1 = self.next_class, self.next_class + count
        idx = torch.arange(c0, c1, device=self.device) % self.slots
        self.centres[idx] = self._randn(count) * self.scale
        self.next_class = c1
        return self._members(c0, c1)

    def live_classes(self) -> tuple[int, int]:
        """[first, last + 1) of the classes whose shots are all in the ring."""
        oldest = self.next_class * self.shots - self.capacity
        return max(0, -(-oldest // self.shots)), self.next_class

    def _ranks(self, n: int, batch: int) -> torch.Tensor:
        """`batch` ranks in [0, n), rank r drawn in proportion to
        (r + 1) ** -class_skew."""
        if self._zipf[0] != n:
            w = torch.arange(1, n + 1, dtype=torch.float64,
                             device=self.device) ** -self.skew
            self._zipf = (n, w)
        return torch.multinomial(self._zipf[1], batch, replacement=True,
                                 generator=self.gen)

    def queries(self, batch: int) -> torch.Tensor:
        lo, hi = self.live_classes()
        if self.skew:
            cls = hi - 1 - self._ranks(hi - lo, batch)
        else:
            cls = torch.randint(lo, hi, (batch,), generator=self.gen,
                                device=self.device)
        return self.centres[cls % self.slots] + self.spread * self._randn(batch)
