"""Fault-tolerance runtime (port of `repro.runtime.ft`).

What it provides, on one host:
  * preemption handling -- SIGTERM/SIGINT triggers a final checkpoint before
    exit (a scheduler's preemption grace window);
  * anomaly step-skipping -- non-finite loss or a gradient-norm spike
    (> spike_factor x running median) skips the update (the batch is
    consumed, so the bad batch is not replayed on restart);
  * step watchdog -- per-step wall-time EWMA + slow-step counter: a
    sustained slowdown (a stuck host, a degraded link) is its signal;
  * restart -- checkpoints are unsharded and in the reference's format
    (`repro_torch.checkpoint`), so a run restores from the last one.

Rescheduling, coordinated restart on host failure and straggler
exclusion are orchestration-level; `should_restart` is the signal that
layer consumes.
"""

from __future__ import annotations

import dataclasses
import signal
import time

import numpy as np
import torch

from repro_torch import tree as tree_lib


@dataclasses.dataclass
class AnomalyConfig:
    spike_factor: float = 10.0   # grad-norm spike threshold vs running median
    warmup_steps: int = 20       # collect stats before enforcing
    max_skips_in_row: int = 5    # give up (restart from ckpt) after this


class AnomalyDetector:
    """Decides, per step, whether to apply the update or skip it."""

    def __init__(self, cfg: AnomalyConfig = AnomalyConfig()):
        self.cfg = cfg
        self.norms: list[float] = []
        self.skips_in_row = 0

    def check(self, loss: float, grad_norm: float) -> bool:
        """True => apply update; False => skip step."""
        ok = bool(np.isfinite(loss)) and bool(np.isfinite(grad_norm))
        if ok and len(self.norms) >= self.cfg.warmup_steps:
            med = float(np.median(self.norms[-100:]))
            ok = grad_norm <= self.cfg.spike_factor * max(med, 1e-12)
        if ok:
            self.norms.append(float(grad_norm))
            self.skips_in_row = 0
        else:
            self.skips_in_row += 1
        return ok

    @property
    def should_restart(self) -> bool:
        return self.skips_in_row >= self.cfg.max_skips_in_row


def skip_or_apply(ok: torch.Tensor, new_tree, old_tree):
    """torch.where over a tree: the new leaves where `ok` (a 0-dim bool
    tensor), else the old ones, decided on the device with no host sync
    (so the decision can also live inside a train step)."""
    return tree_lib.tree_map(lambda n, o: torch.where(ok, n, o), new_tree,
                             old_tree)


class PreemptionHandler:
    """SIGTERM/SIGINT => request graceful stop; train loop checkpoints."""

    def __init__(self):
        self._requested = False
        self._prev = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev[sig] = signal.signal(sig, self._handle)
            except ValueError:  # not the main thread
                pass

    def _handle(self, signum, frame):
        self._requested = True

    @property
    def preempted(self) -> bool:
        return self._requested


class StepWatchdog:
    """EWMA step timing; flags sustained slowdown (straggler signal)."""

    def __init__(self, slow_factor: float = 2.0, patience: int = 5):
        self.ewma = None
        self.slow_factor = slow_factor
        self.patience = patience
        self.slow_count = 0
        self._t0 = None

    def start(self):
        self._t0 = time.monotonic()

    def stop(self) -> float:
        dt = time.monotonic() - self._t0
        if self.ewma is None:
            self.ewma = dt
        if dt > self.slow_factor * self.ewma:
            self.slow_count += 1
        else:
            self.slow_count = 0
            self.ewma = 0.9 * self.ewma + 0.1 * dt
        return dt

    @property
    def straggling(self) -> bool:
        return self.slow_count >= self.patience
