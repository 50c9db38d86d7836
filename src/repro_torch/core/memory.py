"""`MemoryConfig`, the store configuration (port of
`repro.core.memory.MemoryConfig`). The legacy dict-state shims of the JAX
module wait for the last slice (ROADMAP Queue A12)."""

from __future__ import annotations

import dataclasses

from repro_torch.core.avss import SearchConfig


@dataclasses.dataclass(frozen=True)
class MemoryConfig:
    capacity: int = 2048
    dim: int = 48
    search: SearchConfig = dataclasses.field(default_factory=SearchConfig)
    clip_std: float = 2.5
