"""MemoryStore: the programmed MCAM memory (port of
`repro.engine.store`, on one device).

`write` materialises everything a search needs, once:

  values        (N, d)           int32  quantized support values (ring)
  proj          (N, 4d)          bf16   AVSS LUT projection
  proj_packed   (N, ceil(4d/wpi)) int32 the projection bit-packed
  s_grid        (N, seg, L, sl)  int8   string-grid layout
  labels        (N,)             int32  class labels; -1 marks an empty slot
  size          ()               int32  total writes so far (ring position)
  lo, hi        ()               f32    calibrated quantization range
  sketch_sums   (S, R, d)        int32  per (shard, class bucket) sums /
  sketch_counts (S, R)           int32  counts of valid rows: the router's
                                        leaves (engine/router.py); S = 1
                                        on an unpartitioned store

The store lives on one device, CUDA unless the caller passes
`device="cpu"`. Updates are functional: `calibrate` and `write` return a
new store and leave the old one as it was. `save` / `restore` use the JAX
package's checkpoint format (`repro_torch.checkpoint.ckpt`), so a store
crosses between the packages in both directions.

`shard(n_shards=S)` partitions the store logically: it keeps its arrays,
padded with label -1 rows to a multiple of S (rows that rank as
never-written slots), and the sketch records S contiguous row blocks,
which `SearchRequest.nprobe` routes over. With `residency="host"` the
leaves move to host memory (pinned where they came from the card), and
`engine/pager.ShardPager` pages the visited blocks onto the device.
Re-sharding starts from the logical `cfg.capacity` rows.

`shard(mesh, axes)` row-shards the store over a `launch/mesh.Mesh`: the
row fields (values, proj, proj_packed, s_grid, labels) and the sketch
become `engine/sharded.ShardedRows`, one block a shard on the shard's
device (the sketch one (1, R, d) block a shard); size, lo and hi stay one
tensor on the first shard's device, and (mesh, axes) are recorded, so
`RetrievalEngine.search` takes the sharded path. Reading such a field as
one tensor raises; the paths that need the global rows (`full` searches,
routed searches' sketch, `_unpad` and re-sharding) assemble them with
`.full()`. Writes to a store of more than
one shard are shard-local (`_program_streamed`): each shard selects, in
place, the batch rows the ring assigns to its own block, so no store row
crosses devices; the result equals the unsharded write bit for bit.
`save` writes one checkpoint tile a shard of each row leaf; `restore`
returns an unsharded store.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.core import avss as avss_lib
from repro_torch.core import quantization as quant_lib
from repro_torch.core.avss import SearchConfig
from repro_torch.core.memory import MemoryConfig
from repro_torch.engine import router as router_lib
from repro_torch.engine import sharded as sharded_lib
from repro_torch.engine.sharded import ShardedRows
from repro_torch.kernels import _build
from repro_torch.kernels import ops as kernel_ops
from repro_torch.launch.mesh import Mesh

#: array leaves of the store
DATA_FIELDS = ("values", "proj", "proj_packed", "s_grid", "labels", "size",
               "lo", "hi", "sketch_sums", "sketch_counts")
#: the leaves a mesh store row-shards (the sketch is sharded too)
ROW_FIELDS = ("values", "proj", "proj_packed", "s_grid", "labels")
#: what `to_numpy` returns and `from_numpy` takes: the leaves and whether
#: (lo, hi) came from `calibrate`
STATE_FIELDS = DATA_FIELDS + ("calibrated",)

_LEAF_DTYPES = {"values": torch.int32, "proj": torch.bfloat16,
                "proj_packed": torch.int32, "s_grid": torch.int8,
                "labels": torch.int32, "size": torch.int32,
                "lo": torch.float32, "hi": torch.float32,
                "sketch_sums": torch.int32, "sketch_counts": torch.int32}

#: profiler ranges (`_build.profiler_range`): the query words of a search,
#: the whole of a write, and each stage of a write in its order: the batch
#: quantised (labels onto the device), the ring cursor read back, the LUT
#: projection, its packing, the string-grid layout, the leaves committed
#: out of place, the router sketch updated
QUERY_TAG = "engine.quantize"
WRITE_TAG = "store.write"
QUANTIZE_TAG = "store.quantize"
CURSOR_TAG = "store.cursor"
PROJECTION_TAG = "store.projection"
PACK_TAG = "store.pack"
GRID_TAG = "store.layout"
COMMIT_TAG = "store.commit"
SKETCH_TAG = "store.sketch"


def resolve_device(device: torch.device | str | None) -> torch.device:
    """`device`, or the CUDA device when None. Raises when CUDA is asked
    for (explicitly or by default) and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available, and the store "
            "defaults to the card; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    return dev


def _quantize(x: torch.Tensor, levels: int, lo: torch.Tensor,
              hi: torch.Tensor) -> torch.Tensor:
    """Quantized int32 words. A range calibrated on constant data has
    hi == lo, and its words are NaN: XLA converts NaN to 0, torch to
    INT_MIN, so NaN is mapped to 0 before the cast, as the reference
    stores it."""
    q = quant_lib.affine_quantize(x, levels, lo, hi)
    return torch.nan_to_num(q, nan=0.0).to(torch.int32)


def _layout(values: torch.Tensor, cfg: MemoryConfig) -> torch.Tensor:
    """Write-time string grid: (n, d) -> (n, seg, L, sl) int8 codes."""
    grid = avss_lib.layout_support(values, cfg.search.enc,
                                   cfg.search.mcam.string_len)
    return grid.to(torch.int8).contiguous()


@dataclasses.dataclass(frozen=True)
class MemoryStore:
    """Programmed MCAM store (see module docstring). Lifecycle: create ->
    calibrate -> write, searched through `RetrievalEngine.search`."""

    values: torch.Tensor
    proj: torch.Tensor
    proj_packed: torch.Tensor
    s_grid: torch.Tensor
    labels: torch.Tensor
    size: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    sketch_sums: torch.Tensor
    sketch_counts: torch.Tensor
    cfg: MemoryConfig
    calibrated: bool = False
    residency: str = "device"
    mesh: Mesh | None = None
    axes: tuple[str, ...] = ()

    # -- construction --------------------------------------------------------

    @classmethod
    def _programmed(cls, values: torch.Tensor, labels: torch.Tensor,
                    cfg: MemoryConfig, size: int) -> "MemoryStore":
        enc = cfg.search.enc
        proj = kernel_ops.support_projection(values, enc)
        sk_sums, sk_counts = router_lib.build_sketch(values, labels, 1)
        dev = values.device
        return cls(
            values=values, proj=proj,
            proj_packed=kernel_ops.pack_projection(proj, enc),
            s_grid=_layout(values, cfg), labels=labels,
            size=torch.tensor(size, dtype=torch.int32, device=dev),
            lo=torch.zeros((), dtype=torch.float32, device=dev),
            hi=torch.ones((), dtype=torch.float32, device=dev),
            sketch_sums=sk_sums, sketch_counts=sk_counts, cfg=cfg)

    @classmethod
    def create(cls, cfg: MemoryConfig,
               device: torch.device | str | None = None) -> "MemoryStore":
        """Empty store on `device` (default: the CUDA device): every slot
        reads as value 0 with label -1, and proj / s_grid are what a write
        of value 0 would program."""
        dev = resolve_device(device)
        zeros = torch.zeros(cfg.capacity, cfg.dim, dtype=torch.int32,
                            device=dev)
        labels = torch.full((cfg.capacity,), -1, dtype=torch.int32,
                            device=dev)
        return cls._programmed(zeros, labels, cfg, 0)

    @classmethod
    def from_quantized(cls, values, labels, search_cfg: SearchConfig,
                       device: torch.device | str | None = None
                       ) -> "MemoryStore":
        """Program an already-quantized support set (ints in [0, levels))
        as a full store of capacity == len(values)."""
        dev = resolve_device(device)
        v = torch.as_tensor(values).to(device=dev, dtype=torch.int32)
        lab = torch.as_tensor(labels).to(device=dev, dtype=torch.int32)
        n, d = v.shape
        cfg = MemoryConfig(capacity=n, dim=d, search=search_cfg)
        return cls._programmed(v, lab, cfg, n)

    @classmethod
    def from_numpy(cls, arrays: dict[str, np.ndarray], cfg: MemoryConfig,
                   device: torch.device | str | None = None
                   ) -> "MemoryStore":
        """Adopt a store's state as numpy arrays (the keys of
        STATE_FIELDS), e.g. `{f: np.asarray(getattr(jax_store, f))}` of a
        store the JAX package programmed, or `to_numpy()` of one of this
        package. `proj` may arrive as float32; it is cast back to bf16,
        which is exact for values that were bf16. `calibrated` (a 0-d bool)
        says whether (lo, hi) were set by `calibrate`."""
        dev = resolve_device(device)
        missing = [f for f in STATE_FIELDS if f not in arrays]
        if missing:
            raise ValueError(f"MemoryStore.from_numpy: missing leaves "
                             f"{missing}")
        leaves = {f: torch.from_numpy(np.array(arrays[f])).to(
            device=dev, dtype=_LEAF_DTYPES[f]).contiguous()
            for f in DATA_FIELDS}
        store = cls(**leaves, cfg=cfg,
                    calibrated=bool(arrays["calibrated"]))
        if store.capacity != cfg.capacity or store.dim != cfg.dim:
            raise ValueError(f"MemoryStore.from_numpy: leaves hold "
                             f"({store.capacity}, {store.dim}) rows x dims; "
                             f"cfg says ({cfg.capacity}, {cfg.dim})")
        return store

    def to_numpy(self) -> dict[str, np.ndarray]:
        """Every leaf as a numpy array (`proj` as float32, since numpy has
        no bf16), and the `calibrated` flag as a 0-d bool."""
        out = {"calibrated": np.asarray(self.calibrated)}
        for f in DATA_FIELDS:
            t = getattr(self, f).detach().cpu()
            if t.dtype == torch.bfloat16:
                t = t.to(torch.float32)
            out[f] = t.numpy()
        return out

    @classmethod
    def from_episode(cls, s_emb, q_emb, labels, search_cfg: SearchConfig,
                     clip_std: float = 2.5, capacity: int | None = None,
                     device: torch.device | str | None = None
                     ) -> "MemoryStore":
        """Program an episode's float support embeddings the way the
        hardware-aware trainer quantized them: calibrated on the support
        and query sample together, as `quantize_asymmetric` saw it. Searches
        of the returned store equal the episodic training forward
        (`RetrievalEngine.episode_votes`) bit for bit. The store lands on
        `device`, by default the embeddings' device where they are
        tensors, else the card."""
        if device is None and isinstance(s_emb, torch.Tensor):
            device = s_emb.device
        s = torch.as_tensor(s_emb).detach()
        q = torch.as_tensor(q_emb).detach()
        cfg = MemoryConfig(capacity=capacity or s.shape[0], dim=s.shape[1],
                           search=search_cfg, clip_std=clip_std)
        sample = torch.cat([s.reshape(-1), q.reshape(-1).to(s.device)])
        return cls.create(cfg, device).calibrate(sample).write(s, labels)

    @classmethod
    def from_state(cls, state: dict, cfg: MemoryConfig,
                   device: torch.device | str | None = None
                   ) -> "MemoryStore":
        """Adopt a state dict (`to_state()`'s keys). A dict from an old
        checkpoint may lack the write-time `s_grid`: it is laid out from
        `values`, as `write` lays it out, so searches stay the same.
        proj_packed and the router sketch are integer functions of
        (values, proj, labels), rebuilt here exactly; a `proj_packed` the
        dict carries is recomputed to the same bits (the reference adopts
        it). The store is marked calibrated: the state's (lo, hi) is its
        calibration."""
        dev = resolve_device(device)
        leaf = {k: torch.as_tensor(v).to(device=dev, dtype=_LEAF_DTYPES[k])
                for k, v in state.items() if v is not None}
        values, labels = leaf["values"], leaf["labels"]
        s_grid = leaf.get("s_grid")
        s_grid = _layout(values, cfg) if s_grid is None else s_grid
        sk_sums, sk_counts = router_lib.build_sketch(values, labels, 1)
        return cls(values=values, proj=leaf["proj"],
                   proj_packed=kernel_ops.pack_projection(leaf["proj"],
                                                          cfg.search.enc),
                   s_grid=s_grid.contiguous(), labels=labels,
                   size=leaf["size"], lo=leaf["lo"], hi=leaf["hi"],
                   sketch_sums=sk_sums, sketch_counts=sk_counts, cfg=cfg,
                   calibrated=True)

    def to_state(self) -> dict[str, torch.Tensor]:
        """The persisted leaves: what a separate serving process needs to
        search bit-identically (the keys of the JAX package's state)."""
        return {"values": self.values, "proj": self.proj,
                "s_grid": self.s_grid, "labels": self.labels,
                "size": self.size, "lo": self.lo, "hi": self.hi}

    def save(self, directory: str, step: int = 0) -> None:
        """Persist the store (values, labels, the write-time proj / s_grid,
        the calibrated range and the ring size) in the JAX package's
        checkpoint format. A partitioned store saves its logical rows; a
        mesh store one tile a shard of each row leaf (its logical rows:
        a ragged store's pad rows are cut from the last blocks). Restore,
        then `shard` again."""
        if self.mesh is None:
            ckpt.save(directory, step, self._unpad().to_state())
            return
        n = self.cfg.capacity
        ckpt.save(directory, step, {
            k: v.head(n) if isinstance(v, ShardedRows) else v
            for k, v in self.to_state().items()})

    @classmethod
    def restore(cls, directory: str, cfg: MemoryConfig,
                step: int | None = None,
                device: torch.device | str | None = None) -> "MemoryStore":
        """Load a store that `save` wrote, in this package or the JAX one,
        onto `device` (default: the card), marked calibrated: searches on
        it equal the writer's bit for bit."""
        target = {k: 0 for k in ("values", "proj", "s_grid", "labels",
                                 "size", "lo", "hi")}
        state = ckpt.restore(directory, target, step=step, device="cpu")
        return cls.from_state(state, cfg, device)

    def shard(self, mesh=None, axes=("data",), *, n_shards: int | None = None,
              residency: str = "device") -> "MemoryStore":
        """Partition the store into `n_shards` contiguous row blocks (see
        the module docstring), or row-shard it over `axes` of `mesh` (S =
        the product of their sizes, each block on its shard's device):
        ragged splits pad with label -1, value-0 rows, indistinguishable
        from never-written slots, so top-k results equal the unpartitioned
        search's for k <= the logical rows. The sketch is rebuilt at S
        blocks. residency="host" moves every leaf to host memory (pinned
        when it came from the card); "device" moves a host store's leaves
        back (to the card when they were pinned). Idempotent: it starts
        from the logical `cfg.capacity` rows (a mesh store's assembled with
        `.full()`), so `shard(mesh_a).shard(mesh_b)` equals
        `shard(mesh_b)`."""
        if residency not in ("device", "host"):
            raise ValueError(f"unknown residency {residency!r}: expected "
                             f"'device' or 'host'")
        devices = None
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise TypeError(f"MemoryStore.shard: mesh must be a "
                                f"repro_torch.launch.mesh.Mesh, got "
                                f"{type(mesh).__name__}")
            if residency != "device":
                raise ValueError(
                    "MemoryStore.shard: mesh-sharded stores are device-"
                    "resident; residency='host' applies to logical "
                    "partitions (shard(n_shards=S, residency='host')) "
                    "paged by engine/pager.ShardPager")
            axes = tuple(axes)
            devices = sharded_lib.shard_devices(mesh, axes)
            n_shards = len(devices)
        elif n_shards is None or n_shards < 1:
            raise ValueError("MemoryStore.shard: pass a mesh or "
                             "n_shards >= 1")
        base = self._unpad()
        store = base._pad_rows((-base.capacity) % n_shards)
        if mesh is not None:
            return store._place(mesh, axes, devices)
        sk_sums, sk_counts = router_lib.build_sketch(
            store.values, store.labels, n_shards,
            self.sketch_sums.shape[1])
        store = dataclasses.replace(store, sketch_sums=sk_sums,
                                    sketch_counts=sk_counts)
        if residency == "host":
            return store._to_host(pin=self.device.type == "cuda"
                                  or base.values.is_pinned())
        if self.residency == "host":
            home = "cuda" if self.values.is_pinned() else "cpu"
            store = dataclasses.replace(store, **{
                f: getattr(store, f).to(home) for f in DATA_FIELDS})
        return store

    def _place(self, mesh: Mesh, axes: tuple[str, ...],
               devices: list[torch.device]) -> "MemoryStore":
        """This unsharded store (rows a multiple of the shard count) with
        its row fields split over `devices`, each shard's sketch built on
        its own block, and (mesh, axes) recorded."""
        r = self.sketch_sums.shape[1]
        rows = {f: ShardedRows.split(getattr(self, f), devices)
                for f in ROW_FIELDS}
        sketch = [router_lib.bucket_sums(v, lab, r) for v, lab in
                  zip(rows["values"].blocks, rows["labels"].blocks)]
        dev0 = devices[0]
        return dataclasses.replace(
            self, **rows, residency="device", mesh=mesh, axes=axes,
            sketch_sums=ShardedRows(s[None] for s, _ in sketch),
            sketch_counts=ShardedRows(c[None] for _, c in sketch),
            size=self.size.to(dev0), lo=self.lo.to(dev0),
            hi=self.hi.to(dev0))

    def assembled(self) -> "MemoryStore":
        """A mesh store's rows as an unsharded store on its first shard's
        device, pad rows included: every row field assembled with
        `.full()` (a copy of each block), the sketch the sum of the
        shards' (exact int32). `full` searches of a mesh store run over
        it."""
        dev = self.device
        rows = {f: getattr(self, f).full(dev) for f in ROW_FIELDS}
        return dataclasses.replace(
            self, **rows, mesh=None, axes=(),
            sketch_sums=self.sketch_sums.full(dev).sum(
                0, keepdim=True).to(torch.int32),
            sketch_counts=self.sketch_counts.full(dev).sum(
                0, keepdim=True).to(torch.int32))

    def _to_host(self, pin: bool) -> "MemoryStore":
        """Every leaf in host memory, pinned where `pin` (a store of the
        card: the pager's copies then run asynchronously), marked
        residency="host"."""
        def host(t: torch.Tensor) -> torch.Tensor:
            t = t.to("cpu")
            return t.pin_memory() if pin and not t.is_pinned() else t
        return dataclasses.replace(
            self, residency="host",
            **{f: host(getattr(self, f)) for f in DATA_FIELDS})

    def _unpad(self) -> "MemoryStore":
        """Back to the logical view: pad rows dropped, the sketch reset
        to one block and residency "device", so re-sharding always starts
        from the same store. Moves no array between memories (`shard`
        places them), but a mesh store's rows, assembled with `.full()` on
        its first shard's device."""
        if self.mesh is not None:
            return self.assembled()._unpad()
        n = self.cfg.capacity
        base = self
        if self.capacity != n:
            base = dataclasses.replace(
                self, values=self.values[:n], proj=self.proj[:n],
                proj_packed=self.proj_packed[:n], s_grid=self.s_grid[:n],
                labels=self.labels[:n])
        if base.n_shards != 1 or base.residency != "device":
            sk_sums, sk_counts = router_lib.build_sketch(
                base.values, base.labels, 1, base.sketch_sums.shape[1])
            base = dataclasses.replace(base, sketch_sums=sk_sums,
                                       sketch_counts=sk_counts,
                                       residency="device")
        return base

    def _pad_rows(self, pad: int) -> "MemoryStore":
        """`pad` label -1 rows holding what a write of value 0 programs."""
        if pad == 0:
            return self
        enc = self.cfg.search.enc
        zeros = torch.zeros(pad, self.dim, dtype=torch.int32,
                            device=self.device)
        proj_pad = kernel_ops.support_projection(zeros, enc)

        def cat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
            return torch.cat([a, b.to(a.dtype)])

        return dataclasses.replace(
            self, values=cat(self.values, zeros),
            proj=cat(self.proj, proj_pad),
            proj_packed=cat(self.proj_packed,
                            kernel_ops.pack_projection(proj_pad, enc)),
            s_grid=cat(self.s_grid, _layout(zeros, self.cfg)),
            labels=cat(self.labels, torch.full((pad,), -1, dtype=torch.int32,
                                               device=self.device)))

    # -- derived properties --------------------------------------------------

    @property
    def device(self) -> torch.device:
        """The store's device: a mesh store's first shard's."""
        return self.values.device if self.mesh is None else self.size.device

    @property
    def capacity(self) -> int:
        return self.values.shape[0]

    @property
    def dim(self) -> int:
        return self.values.shape[1]

    @property
    def n_shards(self) -> int:
        """Row blocks of the partition: derived from the mesh for a
        mesh store, else the sketch's leading axis (1 for an
        unpartitioned store)."""
        if self.mesh is not None:
            return sharded_lib.n_shards(self.mesh, self.axes)
        return int(self.sketch_sums.shape[0])

    @property
    def pack_bits(self) -> int:
        """Field width of `proj_packed`, fixed at pack time by the encoding
        and the stored `proj` dtype."""
        return kernel_ops.projection_pack_bits(self.cfg.search.enc,
                                               self.proj.dtype)

    @property
    def valid(self) -> torch.Tensor:
        """(N,) bool: slots holding a written support (a ShardedRows on a
        mesh store)."""
        if self.mesh is not None:
            return self.labels.map(lambda t: t >= 0)
        return self.labels >= 0

    # -- programming ---------------------------------------------------------

    def calibrate(self, vectors) -> "MemoryStore":
        """Set the quantization range from a sample of embeddings (std
        clipping clamped to the data extent). Must run before the first
        write: re-calibrating a store holding programmed rows raises."""
        written = int(self.size)
        if written > 0:
            raise ValueError(
                f"MemoryStore.calibrate: the store already holds {written} "
                f"programmed row(s); their quantized words were produced "
                f"under the previous range and would become inconsistent "
                f"with the new one. Calibrate before the first write (or "
                f"build a fresh store and re-program it).")
        x = torch.as_tensor(vectors).to(device=self.device,
                                        dtype=torch.float32)
        lo, hi = quant_lib.clip_range(x, self.cfg.clip_std)
        return dataclasses.replace(self, lo=lo, hi=hi, calibrated=True)

    def write(self, vectors, labels) -> "MemoryStore":
        """Program a batch of float support embeddings into the ring buffer:
        quantization, LUT projection, packing and string-grid layout happen
        here, once. A mesh store of more than one shard is written shard
        by shard (`_program_streamed`); one of a single shard takes the
        scatter of the unsharded store over its one block."""
        with _build.profiler_range(WRITE_TAG):
            x = torch.as_tensor(vectors).to(device=self.device,
                                            dtype=torch.float32)
            n = x.shape[0]
            ring = self.cfg.capacity
            if n > ring:
                raise ValueError(
                    f"write batch ({n}) exceeds capacity ({ring})")
            if n == 0:
                return self
            if not self.calibrated:
                raise ValueError(
                    "MemoryStore.write: writing to a never-calibrated store "
                    "would quantize against the default (lo=0, hi=1) range "
                    "and program garbage words; call store.calibrate("
                    "sample) before the first write (already-quantized "
                    "supports go through MemoryStore.from_quantized "
                    "instead).")
            with _build.profiler_range(QUANTIZE_TAG):
                v = _quantize(x, self.cfg.search.enc.levels, self.lo,
                              self.hi)
                lab = torch.as_tensor(labels).to(device=self.device,
                                                 dtype=torch.int32)
            if self.mesh is not None and self.n_shards > 1:
                return self._program_streamed(v, lab)
            with _build.profiler_range(CURSOR_TAG):
                start = int(self.size) % ring
                idx = (start + torch.arange(n, device=self.device)) % ring
            if self.mesh is not None:
                return self.assembled()._program(idx, v, lab)._place(
                    self.mesh, self.axes, [self.device])
            return self._program(idx, v, lab)

    def _program(self, idx: torch.Tensor, v: torch.Tensor,
                 lab: torch.Tensor) -> "MemoryStore":
        """Scatter a quantized batch onto ring slots `idx` (distinct, since
        the batch is no larger than the ring)."""
        enc = self.cfg.search.enc
        s, r = self.sketch_sums.shape[:2]
        with _build.profiler_range(PROJECTION_TAG):
            proj = kernel_ops.support_projection(v, enc)
        with _build.profiler_range(PACK_TAG):
            packed = kernel_ops.pack_projection(proj, enc)
        with _build.profiler_range(GRID_TAG):
            grid = _layout(v, self.cfg)

        def put(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
            return old.index_put((idx,), new.to(old.dtype))

        with _build.profiler_range(COMMIT_TAG):
            rows = {"values": put(self.values, v),
                    "proj": put(self.proj, proj),
                    "proj_packed": put(self.proj_packed, packed),
                    "s_grid": put(self.s_grid, grid),
                    "labels": put(self.labels, lab)}
        # after the commit: a partitioned store rebuilds its sketch from the
        # committed rows (the puts are out of place, so self still holds
        # the rows the batch replaces)
        with _build.profiler_range(SKETCH_TAG):
            if s == 1:
                # the batch lands on distinct slots, so adding (new - old)
                # bucket stats is exact integer arithmetic, equal to a
                # rebuild
                ds_new, dc_new = router_lib.bucket_sums(v, lab, r)
                ds_old, dc_old = router_lib.bucket_sums(self.values[idx],
                                                        self.labels[idx], r)
                sk_sums = self.sketch_sums + (ds_new - ds_old)[None]
                sk_counts = self.sketch_counts + (dc_new - dc_old)[None]
            else:
                # a partitioned store: the batch may cross blocks; rebuild
                sk_sums, sk_counts = router_lib.build_sketch(
                    rows["values"], rows["labels"], s, r)
        store = dataclasses.replace(
            self, **rows, sketch_sums=sk_sums, sketch_counts=sk_counts,
            size=self.size + idx.shape[0])
        if self.residency == "host" and self.values.is_pinned():
            store = dataclasses.replace(store, **{
                f: getattr(store, f).pin_memory() for f in DATA_FIELDS})
        return store

    def _program_streamed(self, v: torch.Tensor,
                          lab: torch.Tensor) -> "MemoryStore":
        """Shard-local write-through of a quantized batch into a mesh
        store (port of the reference's `_program_streamed`): the batch's
        projection, packed words and layout are computed once, on the
        first shard's device, and copied to each shard's (a replicated
        batch); each shard inverts the ring for every row of its block
        (j = (g - start) mod capacity for global row g; written iff j < n
        and g < capacity, so pad rows stay pads), selects in place and
        rebuilds its own sketch. No scatter, and no store row leaves its
        device; equal, bit for bit, to the unsharded write, wraparound
        across shard boundaries included."""
        enc, ring, n = self.cfg.search.enc, self.cfg.capacity, v.shape[0]
        with _build.profiler_range(CURSOR_TAG):
            start = int(self.size) % ring
        with _build.profiler_range(PROJECTION_TAG):
            proj = kernel_ops.support_projection(v, enc)
        with _build.profiler_range(PACK_TAG):
            packed = kernel_ops.pack_projection(proj, enc)
        with _build.profiler_range(GRID_TAG):
            grid = _layout(v, self.cfg)
        batch = {"values": v, "proj": proj, "proj_packed": packed,
                 "s_grid": grid, "labels": lab}
        r = self.sketch_sums.block(0).shape[1]
        out = {f: [] for f in ROW_FIELDS}
        with _build.profiler_range(COMMIT_TAG):
            g0 = 0
            for i in range(len(self.values.blocks)):
                old_values = self.values.block(i)
                dev, rows = old_values.device, old_values.shape[0]
                g = torch.arange(g0, g0 + rows, device=dev)
                j = torch.remainder(g - start, ring)
                written = (j < n) & (g < ring)
                jc = torch.clamp(j, max=n - 1)
                for f in ROW_FIELDS:
                    old = getattr(self, f).block(i)
                    w = written.reshape((-1,) + (1,) * (old.dim() - 1))
                    out[f].append(torch.where(w, batch[f].to(dev)[jc].to(
                        old.dtype), old))
                g0 += rows
        with _build.profiler_range(SKETCH_TAG):
            sums, counts = [], []
            for values, labels in zip(out["values"], out["labels"]):
                s, c = router_lib.bucket_sums(values, labels, r)
                sums.append(s[None])
                counts.append(c[None])
        return dataclasses.replace(
            self, **{f: ShardedRows(b) for f, b in out.items()},
            sketch_sums=ShardedRows(sums), sketch_counts=ShardedRows(counts),
            size=self.size + n)

    def quantize_queries(self, queries) -> torch.Tensor:
        """Float embeddings -> quantized query words ([0, 4) for AVSS,
        [0, levels) for SVSS) on the store's device. Integer queries are
        already words and pass through. Float queries on a never-calibrated
        store raise."""
        with _build.profiler_range(QUERY_TAG):
            q = torch.as_tensor(queries).to(self.device)
            if not torch.is_floating_point(q):
                return q
            if not self.calibrated:
                raise ValueError(
                    "MemoryStore.quantize_queries: float queries on a "
                    "never-calibrated store (e.g. fresh create() or "
                    "from_quantized()) would quantize against the default "
                    "(lo=0, hi=1) range and return garbage words; call "
                    "store.calibrate(sample) first, or pass pre-quantized "
                    "integer queries.")
            cfg = self.cfg.search
            levels = 4 if cfg.mode == "avss" else cfg.enc.levels
            return _quantize(q.to(torch.float32), levels, self.lo, self.hi)
