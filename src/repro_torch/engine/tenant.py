"""TenantStore: per-tenant MemoryStores stacked into one batched store
(port of `repro.engine.tenant`).

A process that serves many few-shot users holds one store a user; stacked
along a leading tenant axis, one coalesced batch of queries from any mix
of tenants is one search (`RetrievalEngine.search_tenants`), whose
kernels and launch counts do not depend on the mix.

Stacking pads ragged capacities to the largest with the label -1, value-0
rows `MemoryStore.shard` pads with, which rank as never-written slots, so
each tenant's search equals its solo search bit for bit. Each tenant's
MemoryConfig and calibration flag ride along, so `tenant(i)` gives back
the stacked store exactly. `write_at` is the solo ring write on one
tenant and keeps every leaf's shape.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core.memory import MemoryConfig
from repro_torch.engine import router as router_lib
from repro_torch.engine.store import MemoryStore, _layout, _quantize
from repro_torch.kernels import ops as kernel_ops

#: the stacked leaves, each with a leading tenant axis
_LEAVES = ("values", "proj", "proj_packed", "s_grid", "labels", "size", "lo",
           "hi", "sketch_sums", "sketch_counts")


def tenant_query_rank(tenant_ids: torch.Tensor) -> torch.Tensor:
    """(B,) rank of each query within its tenant group, in batch order:
    its batch position in a solo search of its tenant's queries, the noise
    coordinate that makes the coalesced search equal the solo ones.

    >>> tenant_query_rank(torch.tensor([2, 0, 2, 2, 0])).tolist()
    [0, 0, 1, 2, 1]
    """
    t = torch.as_tensor(tenant_ids)
    same = t[:, None] == t[None, :]
    return torch.tril(same, diagonal=-1).sum(dim=1)


@dataclasses.dataclass(frozen=True)
class TenantStore:
    """Per-tenant stores as one batched store (module docstring).

    Leaves carry a leading tenant axis over the solo store's: values
    (T, Np, d), proj (T, Np, 4d), proj_packed (T, Np, w) or None, s_grid
    (T, Np, seg, L, sl), labels (T, Np), size / lo / hi (T,), sketch_sums
    (T, 1, R, d), sketch_counts (T, 1, R); Np is the padded capacity.
    `cfgs` / `calibrated` are each tenant's own."""

    values: torch.Tensor
    proj: torch.Tensor
    proj_packed: torch.Tensor | None
    s_grid: torch.Tensor
    labels: torch.Tensor
    size: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    sketch_sums: torch.Tensor
    sketch_counts: torch.Tensor
    cfgs: tuple[MemoryConfig, ...]
    calibrated: tuple[bool, ...]

    # -- construction --------------------------------------------------------

    @classmethod
    def stack(cls, stores: Sequence[MemoryStore]) -> "TenantStore":
        """Stack unpartitioned stores of one SearchConfig and dim, on one
        device, padding each to the largest capacity."""
        if not stores:
            raise ValueError("TenantStore.stack: need at least one store")
        first = stores[0]
        for i, s in enumerate(stores):
            if s.mesh is not None:
                raise ValueError(
                    f"TenantStore.stack: store {i} is sharded; stack "
                    f"unsharded stores (shard-of-stacks is not supported)")
            if s.n_shards != 1 or s.residency != "device":
                raise ValueError(
                    f"TenantStore.stack: store {i} is partitioned; stack "
                    f"unpartitioned stores")
            if s.cfg.search != first.cfg.search or s.dim != first.dim:
                raise ValueError(
                    f"TenantStore.stack: store {i} disagrees with store 0 "
                    f"on SearchConfig/dim; the stacked search is shared, so "
                    f"its configuration must be")
            if s.device != first.device:
                raise ValueError(f"TenantStore.stack: store {i} is on "
                                 f"{s.device}, store 0 on {first.device}")
        n_pad = max(s.cfg.capacity for s in stores)
        padded = [s._unpad()._pad_rows(n_pad - s.cfg.capacity)
                  for s in stores]
        packed = (None if any(s.proj_packed is None for s in padded)
                  else torch.stack([s.proj_packed for s in padded]))
        leaves = {f: torch.stack([getattr(s, f) for s in padded])
                  for f in _LEAVES if f != "proj_packed"}
        return cls(**leaves, proj_packed=packed,
                   cfgs=tuple(s.cfg for s in stores),
                   calibrated=tuple(s.calibrated for s in stores))

    # -- derived properties --------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def n_tenants(self) -> int:
        return self.values.shape[0]

    @property
    def n_pad(self) -> int:
        """Padded per-tenant capacity (the stack's largest)."""
        return self.values.shape[1]

    @property
    def capacities(self) -> tuple[int, ...]:
        """Each tenant's logical capacity."""
        return tuple(c.capacity for c in self.cfgs)

    @property
    def cfg(self) -> MemoryConfig:
        """Tenant 0's MemoryConfig at the padded capacity: the shared
        configuration of the per-query views."""
        return dataclasses.replace(self.cfgs[0], capacity=self.n_pad)

    @property
    def pack_bits(self) -> int:
        """Field width of `proj_packed` (every tenant's: one encoding)."""
        return kernel_ops.projection_pack_bits(self.cfgs[0].search.enc,
                                               self.proj.dtype)

    # -- solo views ----------------------------------------------------------

    def tenant(self, i: int) -> MemoryStore:
        """Tenant i's store as it was stacked: pads dropped, its own
        MemoryConfig and calibration flag."""
        cap = self.cfgs[i].capacity
        return MemoryStore(
            values=self.values[i, :cap], proj=self.proj[i, :cap],
            proj_packed=(None if self.proj_packed is None
                         else self.proj_packed[i, :cap]),
            s_grid=self.s_grid[i, :cap], labels=self.labels[i, :cap],
            size=self.size[i], lo=self.lo[i], hi=self.hi[i],
            sketch_sums=self.sketch_sums[i],
            sketch_counts=self.sketch_counts[i], cfg=self.cfgs[i],
            calibrated=self.calibrated[i])

    def query_view(self, tenant_ids: torch.Tensor) -> MemoryStore:
        """Per-query store view: every leaf gathered at `tenant_ids`, a
        MemoryStore whose leaves have one extra leading batch axis (what
        JAX's `search_tenants` vmaps over). A copy of B tenants' rows;
        `search_tenants` itself reads the stack through the visit lists."""
        t = torch.as_tensor(tenant_ids).to(device=self.device,
                                           dtype=torch.int64)
        leaves = {f: (None if getattr(self, f) is None
                      else getattr(self, f)[t]) for f in _LEAVES}
        return MemoryStore(**leaves, cfg=self.cfg, calibrated=True)

    # -- programming ---------------------------------------------------------

    def quantize_queries(self, queries, tenant_ids: torch.Tensor
                         ) -> torch.Tensor:
        """Float embeddings -> query words, each against its own tenant's
        calibrated (lo, hi), as `tenant(t).quantize_queries` would give
        it. Integer queries are words already and pass through. Float
        queries need every tenant calibrated."""
        q = torch.as_tensor(queries).to(self.device)
        if not torch.is_floating_point(q):
            return q
        if not all(self.calibrated):
            raise ValueError(
                "TenantStore.quantize_queries: float queries on a stack "
                "with never-calibrated tenants "
                f"{[i for i, c in enumerate(self.calibrated) if not c]} "
                "would quantize against the default (lo=0, hi=1) range "
                "and return garbage words; calibrate every store before "
                "stacking, or pass pre-quantized integer queries.")
        cfg = self.cfgs[0].search
        levels = 4 if cfg.mode == "avss" else cfg.enc.levels
        t = torch.as_tensor(tenant_ids).to(device=self.device,
                                           dtype=torch.int64)
        return _quantize(q.to(torch.float32), levels, self.lo[t][:, None],
                         self.hi[t][:, None])

    def write_at(self, tenant_id: int, vectors, labels) -> "TenantStore":
        """Program a batch into tenant `tenant_id`'s ring: the solo
        `MemoryStore.write` on that tenant (its range, its logical
        capacity, so pad rows are never written), returning a new stack
        with every leaf's shape kept; `tenant(t)` afterwards equals the
        solo store's write bit for bit."""
        x = torch.as_tensor(vectors).to(device=self.device,
                                        dtype=torch.float32)
        n = x.shape[0]
        if n == 0:
            return self
        t = int(tenant_id)
        if not self.calibrated[t]:
            raise ValueError(
                f"TenantStore.write_at: tenant {t} was stacked never-"
                f"calibrated; calibrate before stacking (already-quantized "
                f"supports go through MemoryStore.from_quantized).")
        ring = self.capacities[t]
        if n > ring:
            raise ValueError(f"write batch ({n}) exceeds tenant capacity "
                             f"({ring})")
        enc = self.cfgs[t].search.enc
        v = _quantize(x, enc.levels, self.lo[t], self.hi[t])
        lab = torch.as_tensor(labels).to(device=self.device,
                                         dtype=torch.int32)
        idx = (int(self.size[t]) % ring
               + torch.arange(n, device=self.device)) % ring
        proj = kernel_ops.support_projection(v, enc)
        # the solo store's incremental S=1 sketch: (new - old) bucket stats
        # over distinct ring slots
        r = self.sketch_sums.shape[2]
        ds_new, dc_new = router_lib.bucket_sums(v, lab, r)
        ds_old, dc_old = router_lib.bucket_sums(self.values[t, idx],
                                                self.labels[t, idx], r)

        def put(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
            return old.index_put((torch.full_like(idx, t), idx),
                                 new.to(old.dtype))

        def add(old: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
            out = old.clone()
            out[t, 0] += delta.to(old.dtype)
            return out

        size = self.size.clone()
        size[t] += n
        return dataclasses.replace(
            self, values=put(self.values, v), proj=put(self.proj, proj),
            proj_packed=(None if self.proj_packed is None else put(
                self.proj_packed, kernel_ops.pack_projection(proj, enc))),
            s_grid=put(self.s_grid, _layout(v, self.cfgs[t])),
            labels=put(self.labels, lab),
            sketch_sums=add(self.sketch_sums, ds_new - ds_old),
            sketch_counts=add(self.sketch_counts, dc_new - dc_old),
            size=size)
