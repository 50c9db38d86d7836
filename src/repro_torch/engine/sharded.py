"""Sharded retrieval: block-parallel search over a row-sharded store (port
of `repro.engine.sharded`), driven by one controller.

A mesh-sharded `MemoryStore` (`store.shard(mesh, axes)`) holds each
row-sharded field as a `ShardedRows`: one tensor a shard, on the shard's
mesh device (its first position; positions along the axes outside `axes`
hold replicas, which the single controller computes once). Shard i holds
global rows [i rows, (i + 1) rows), i the shard's row-major position over
`axes`. The reference's collectives become:

  axis_index (`_shard_index`)        the shard's row-major position
  all_gather of the (B, k_loc)       `torch.cat` on the first mesh device,
  (dist, global row, label) triplet  shard-major (`_gather_candidates`)
  ownership-masked psum of votes     the same masked sum over the shards'
                                     partial (B, k) votes (`_owned_votes`)

so only the triplets and the partial votes cross devices; a shard's rows
never leave its device.

  sharded_two_phase_search   per-shard shortlist + exact noisy rescore,
                             the triplets merged by a stable sort, the
                             votes recovered by the masked sum: bit-
                             identical to the unsharded two_phase.
  sharded_ideal_search       per-shard shortlist only (votes -dist).

Exactness (as the reference's): shortlist distances are integer-valued
f32, the same on every shard and route; each shard's local top-k_loc
keeps (distance, row) order, so no global candidate is lost; the gather
stacks shards in global row order, so a stable sort by distance is the
(distance, global row) order; the rescore feeds GLOBAL rows to the noise
counters; and adding f32 zeros to the one owning shard's vote is exact.

`sharded_ideal_search` takes the query words `q_values` where the
reference takes their one-hot rows `q_onehot` and the encoding `enc`: it
builds the one-hot rows itself, on each shard's device.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Sequence

import numpy as np
import torch

from repro_torch.core import avss as avss_lib
from repro_torch.core.avss import SearchConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import shortlist as shortlist_kernel
from repro_torch.models.sharding import count_collective


_NOT_ONE_TENSOR = ("a row-sharded field of a mesh store is not one tensor: "
                   "assemble it with .full(device), or read .block(i)")


class ShardedRows:
    """A row-sharded field of a mesh store: `blocks[i]` holds shard i's
    rows on its device, shard-major in global row order. It is not a
    tensor: indexing it, or handing it to torch or numpy, raises. A path
    that needs the global array assembles it with `full(device)` (a copy
    of every block onto one device); `block(i)` is one shard's rows."""

    __slots__ = ("blocks",)

    def __init__(self, blocks) -> None:
        self.blocks = tuple(blocks)

    @classmethod
    def split(cls, t: torch.Tensor,
              devices: Sequence[torch.device]) -> "ShardedRows":
        """`t`'s rows in len(devices) equal blocks, block i on devices[i]."""
        s = len(devices)
        if t.shape[0] % s:
            raise ValueError(
                f"store rows ({t.shape[0]}) must divide evenly over {s} "
                f"shards (MemoryStore.shard pads ragged splits)")
        rows = t.shape[0] // s
        return cls(t[i * rows:(i + 1) * rows].to(dev)
                   for i, dev in enumerate(devices))

    @property
    def shape(self) -> torch.Size:
        """The global shape."""
        return torch.Size((sum(b.shape[0] for b in self.blocks),)
                          + tuple(self.blocks[0].shape[1:]))

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    def block(self, i: int) -> torch.Tensor:
        return self.blocks[i]

    def full(self, device: torch.device | str) -> torch.Tensor:
        """The global array on `device`: every block copied there (the
        blocks past the first count as "all-gather" bytes)."""
        count_collective("all-gather", sum(
            b.numel() * b.element_size() for b in self.blocks[1:]))
        return torch.cat([b.to(device) for b in self.blocks])

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]
            ) -> "ShardedRows":
        """`fn` of each block, on its device."""
        return ShardedRows(fn(b) for b in self.blocks)

    def head(self, n: int) -> "ShardedRows":
        """The global rows below `n`, each block cut to them (blocks past
        `n` become empty): a ragged store's logical rows."""
        out, start = [], 0
        for b in self.blocks:
            out.append(b[:max(0, min(b.shape[0], n - start))])
            start += b.shape[0]
        return ShardedRows(out)

    def tiles(self) -> Iterator[tuple[tuple[int, ...], torch.Tensor]]:
        """(global start, block) of each non-empty block: what the tiled
        checkpoint writer (checkpoint/ckpt.py) writes, one file a shard."""
        start = 0
        for b in self.blocks:
            if b.shape[0]:
                yield (start,) + (0,) * (b.dim() - 1), b
            start += b.shape[0]

    def _refuse(self, *_: Any, **__: Any):
        raise TypeError(_NOT_ONE_TENSOR)

    __getitem__ = __array__ = _refuse
    __eq__ = __ne__ = __lt__ = __le__ = __gt__ = __ge__ = _refuse
    __hash__ = object.__hash__

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        raise TypeError(_NOT_ONE_TENSOR)

    def __getattr__(self, name: str):
        raise AttributeError(f"ShardedRows has no {name!r}: "
                             f"{_NOT_ONE_TENSOR}")


def n_shards(mesh, axes: Sequence[str]) -> int:
    """Shards of a store sharded over `axes` of `mesh`."""
    unknown = [a for a in axes if a not in mesh.shape]
    if unknown or not axes:
        raise ValueError(f"shard axes {tuple(axes)} are not axes of the "
                         f"mesh {tuple(mesh.axis_names)}")
    return int(np.prod([mesh.shape[a] for a in axes]))


def _shard_index(mesh, axes: Sequence[str], coords: dict[str, int]) -> int:
    """Row-major linear index over `axes` of the shard at mesh
    coordinates `coords`."""
    shard = 0
    for a in axes:
        shard = shard * mesh.shape[a] + coords[a]
    return shard


def shard_devices(mesh, axes: Sequence[str]) -> list[torch.device]:
    """Each shard's device, in shard order: its first mesh position (index
    0 along the axes outside `axes`, over which the shard is
    replicated)."""
    devices: list = [None] * n_shards(mesh, axes)
    for pos in np.ndindex(mesh.devices.shape):
        s = _shard_index(mesh, axes, dict(zip(mesh.axis_names, pos)))
        if devices[s] is None:
            devices[s] = mesh.devices[pos]
    return devices


def placed(x, devices: Sequence[torch.device]) -> ShardedRows | None:
    """`x` in len(devices) blocks on `devices`: a tensor is split; a
    ShardedRows of another shard count (a request whose axes differ from
    the store's) is assembled with `full()` on devices[0] and split."""
    if x is None:
        return None
    if isinstance(x, ShardedRows):
        if len(x.blocks) == len(devices):
            return x
        x = x.full(devices[0])
    return ShardedRows.split(x, devices)


def _gather_candidates(parts: Sequence[torch.Tensor],
                       device: torch.device) -> torch.Tensor:
    """Per-shard (B, kk) -> (B, S kk) on `device`, shard-major (ascending
    global rows)."""
    return torch.cat([p.to(device) for p in parts], dim=1)


def _owned_votes(i_k: torch.Tensor, gidx: torch.Tensor,
                 votes: torch.Tensor) -> torch.Tensor:
    """A shard's partial (B, k) votes of the merged rows i_k: its rescored
    vote where it owns the row (its candidates gidx), 0.0 elsewhere."""
    own = i_k.to(gidx.device)[:, :, None] == gidx[:, None, :]
    return torch.where(own, votes[:, None, :], 0.0).sum(dim=2)


def _use_fused(backend: str, rows: int, fused_min_rows: int | None) -> bool:
    """The fused-or-dense rule of every shortlist: the fused kernel on
    'fused', and on any kernel backend once the rows a query ranks (on a
    mesh store, a shard's own rows) reach `fused_min_rows`; 'ref' (and
    None, the raw-array default) keeps the dense plain route."""
    if backend == "fused":
        return True
    return (backend != "ref" and fused_min_rows is not None
            and rows >= fused_min_rows)


def _local_shortlist(q: torch.Tensor, proj_loc: torch.Tensor | None,
                     valid_loc: torch.Tensor | None, k_loc: int, *,
                     fused: bool, packed: torch.Tensor | None = None,
                     pack_bits: int | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """A block's top-k_loc rows by exact LUT distance (+ the mask
    penalty), q (B, d) words on the block's device -> (dist (B, k_loc),
    local rows (B, k_loc) int64), ascending by (distance, row). Fused: the
    one-table entry of csrc/shortlist.cu, streaming the packed projection
    when given; dense: the reference's `q1h @ proj.T` in f32 (exact) and
    the stable (distance, row) selection."""
    if fused:
        return shortlist_kernel.lut_shortlist(
            q, None if packed is not None else proj_loc, k_loc,
            valid=valid_loc, packed=packed, pack_bits=pack_bits)
    q1h = kernel_ops.query_onehot(q, torch.float32)
    dist = q1h @ proj_loc.to(torch.float32).T
    if valid_loc is not None:
        dist = dist + torch.where(valid_loc, 0.0,
                                  kernel_ops.SHORTLIST_MASK_PENALTY)[None]
    return shortlist_kernel.select_topk(dist, k_loc)


def _merge(d_all: torch.Tensor, k: int) -> Callable:
    """`take`: the first k of each row's gathered candidates by a stable
    sort on distance, i.e. by (distance, global row)."""
    order = torch.sort(d_all, dim=1, stable=True).indices[:, :k]
    return lambda x: x.gather(1, order)


def sharded_two_phase_search(q_values: torch.Tensor, s_values,
                             cfg: SearchConfig, mesh,
                             axes: Sequence[str] = ("data",), k: int = 64,
                             valid=None, labels=None, s_grid=None,
                             proj=None, packed=None,
                             pack_bits: int | None = None,
                             backend: str = "ref",
                             fused_min_rows: int | None = None
                             ) -> dict[str, Any]:
    """Two-phase AVSS over a store row-sharded on `axes` of `mesh`.

    q_values: (B, d) query words. s_values (N, d) and the optional valid
    (N,) bool, labels (N,) int32, s_grid (N, seg, L, sl), proj (N, 4d) and
    packed (bit-packed proj, `pack_bits` wide): each a ShardedRows of the
    store, or a tensor split here into equal blocks (N divisible by the
    shard count). Per shard: the shortlist with k_loc = min(k, N / S)
    (`_use_fused` on the shard's rows; packed streamed when given), then
    the rescore of its candidates with their global rows as noise rows
    (the plain version on 'ref'). Returns {votes (B, k), dist (B, k),
    indices (B, k) global rows [, labels (B, k)], iterations} on the first
    shard's device, bit-identical to the unsharded two_phase."""
    if cfg.mode != "avss":
        raise ValueError("two-phase search shortlists with the AVSS LUT "
                         "(mode='avss')")
    enc, sl = cfg.enc, cfg.mcam.string_len
    devices = shard_devices(mesh, axes)
    s_values, valid, labels, s_grid, proj, packed = (
        placed(x, devices) for x in (s_values, valid, labels, s_grid, proj,
                                     packed))
    n = s_values.shape[0]
    rows = n // len(devices)
    k = min(k, n)
    k_loc = min(k, rows)
    fused = _use_fused(backend, rows, fused_min_rows)
    if packed is not None and pack_bits is None:
        pack_bits = kernel_ops.projection_pack_bits(
            enc, proj.dtype if proj is not None else torch.bfloat16)
    rescore = (kernel_ops.rescore_shortlist_plain if backend == "ref"
               else kernel_ops.rescore_shortlist)
    dev0 = devices[0]
    q_values = q_values.to(dev0)
    q_grid = avss_lib.layout_query(q_values, enc, "avss", sl)
    d_parts, i_parts, l_parts, votes = [], [], [], []
    for i in range(len(devices)):
        s_loc = s_values.block(i)
        dev = s_loc.device
        proj_loc = (proj.block(i) if proj is not None
                    else kernel_ops.support_projection(s_loc, enc,
                                                       torch.float32))
        d_loc, idx_loc = _local_shortlist(
            q_values.to(dev), proj_loc,
            None if valid is None else valid.block(i), k_loc, fused=fused,
            packed=None if packed is None else packed.block(i),
            pack_bits=pack_bits)
        gidx = idx_loc + i * rows
        grid_loc = (s_grid.block(i) if s_grid is not None
                    else avss_lib.layout_support(s_loc, enc, sl))
        votes.append(rescore(
            q_grid.to(dev), grid_loc, idx_loc, enc.weights_array(device=dev),
            cfg, torch.as_tensor(cfg.mcam.thresholds(), device=dev),
            noise_idx=gidx))
        d_parts.append(d_loc)
        i_parts.append(gidx)
        if labels is not None:
            l_parts.append(labels.block(i)[idx_loc])
    d_all = _gather_candidates(d_parts, dev0)
    take = _merge(d_all, k)
    i_k = take(_gather_candidates(i_parts, dev0))
    # each merged row is owned by one shard: the sum of the partials adds
    # f32 zeros to its vote, which is exact
    v_k = sum(_owned_votes(i_k, g, v).to(dev0)
              for g, v in zip(i_parts, votes))
    res = {"votes": v_k, "dist": take(d_all), "indices": i_k,
           "iterations": avss_lib.search_iterations(q_values.shape[-1], enc,
                                                    "avss", sl)}
    if labels is not None:
        res["labels"] = take(_gather_candidates(l_parts, dev0))
    return res


def sharded_ideal_search(q_values: torch.Tensor, proj, labels, mesh,
                         axes: Sequence[str] = ("data",), k: int = 16,
                         backend: str = "ref",
                         fused_min_rows: int | None = None,
                         packed=None, pack_bits: int | None = None
                         ) -> dict[str, torch.Tensor]:
    """Ideal-digital-distance block search (no rescore): q_values (B, d)
    words; proj (N, 4d), labels (N,) (< 0 marks empty slots, which carry
    the mask penalty) and the optional packed projection (`pack_bits`
    wide), each a ShardedRows or a tensor split here. Returns {dist,
    votes = -dist, labels, indices} each (B, k') on the first shard's
    device, bit-identical to the unsharded ideal search."""
    devices = shard_devices(mesh, axes)
    if pack_bits is None:
        packed = None
    proj, labels, packed = (placed(x, devices)
                            for x in (proj, labels, packed))
    rows = proj.shape[0] // len(devices)
    fused = _use_fused(backend, rows, fused_min_rows)
    kk = min(k, rows)
    dev0 = devices[0]
    d_parts, l_parts, i_parts = [], [], []
    for i in range(len(devices)):
        lab = labels.block(i)
        dev = lab.device
        d_loc, idx = _local_shortlist(
            q_values.to(dev), proj.block(i), lab >= 0, kk, fused=fused,
            packed=None if packed is None else packed.block(i),
            pack_bits=pack_bits)
        d_parts.append(d_loc)
        l_parts.append(lab[idx])
        i_parts.append(idx + i * rows)
    d_all = _gather_candidates(d_parts, dev0)
    take = _merge(d_all, k)
    dist = take(d_all)
    return {"dist": dist, "votes": -dist,
            "labels": take(_gather_candidates(l_parts, dev0)),
            "indices": take(_gather_candidates(i_parts, dev0))}
