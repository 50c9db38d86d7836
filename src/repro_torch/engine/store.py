"""MemoryStore: the programmed MCAM memory (port of
`repro.engine.store`, unsharded).

`write` materialises everything a search needs, once:

  values        (N, d)           int32  quantized support values (ring)
  proj          (N, 4d)          bf16   AVSS LUT projection
  proj_packed   (N, ceil(4d/wpi)) int32 the projection bit-packed
  s_grid        (N, seg, L, sl)  int8   string-grid layout
  labels        (N,)             int32  class labels; -1 marks an empty slot
  size          ()               int32  total writes so far (ring position)
  lo, hi        ()               f32    calibrated quantization range
  sketch_sums   (1, R, d)        int32  per-class-bucket sums / counts of
  sketch_counts (1, R)           int32  valid rows (the router's leaves)

The store lives on one device, CUDA unless the caller passes
`device="cpu"`. Updates are functional: `calibrate` and `write` return a
new store and leave the old one as it was. Sharding, routing, host
residency and persistence are not ported yet; they raise
NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import avss as avss_lib
from repro_torch.core import quantization as quant_lib
from repro_torch.core.avss import SearchConfig
from repro_torch.core.memory import MemoryConfig
from repro_torch.engine import router as router_lib
from repro_torch.kernels import ops as kernel_ops

#: array leaves of the store
DATA_FIELDS = ("values", "proj", "proj_packed", "s_grid", "labels", "size",
               "lo", "hi", "sketch_sums", "sketch_counts")
#: what `to_numpy` returns and `from_numpy` takes: the leaves and whether
#: (lo, hi) came from `calibrate`
STATE_FIELDS = DATA_FIELDS + ("calibrated",)

_LEAF_DTYPES = {"values": torch.int32, "proj": torch.bfloat16,
                "proj_packed": torch.int32, "s_grid": torch.int8,
                "labels": torch.int32, "size": torch.int32,
                "lo": torch.float32, "hi": torch.float32,
                "sketch_sums": torch.int32, "sketch_counts": torch.int32}


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


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"repro_torch: {what} is not ported yet (ROADMAP Queue {item})")


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
    def from_episode(cls, *args, **kwargs) -> "MemoryStore":
        raise _not_ported("MemoryStore.from_episode (HAT training)", "A5")

    @classmethod
    def from_state(cls, *args, **kwargs) -> "MemoryStore":
        raise _not_ported("MemoryStore.from_state (legacy dict state)",
                          "A12")

    def save(self, *args, **kwargs) -> None:
        raise _not_ported("MemoryStore.save (checkpoint)", "A4")

    @classmethod
    def restore(cls, *args, **kwargs) -> "MemoryStore":
        raise _not_ported("MemoryStore.restore (checkpoint)", "A4")

    def shard(self, mesh=None, axes=("data",), *, n_shards=None,
              residency: str = "device") -> "MemoryStore":
        if residency == "host":
            raise _not_ported("shard(residency='host') (host paging)", "A8")
        if mesh is not None:
            raise _not_ported("shard(mesh) (multi-device sharding)", "A9")
        raise _not_ported("shard(n_shards=S) (router partitions)", "A6")

    # -- derived properties --------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def capacity(self) -> int:
        return self.values.shape[0]

    @property
    def dim(self) -> int:
        return self.values.shape[1]

    @property
    def n_shards(self) -> int:
        """Always 1: this port's store is unsharded."""
        return 1

    @property
    def pack_bits(self) -> int:
        """Field width of `proj_packed`, fixed at pack time by the encoding
        and the stored `proj` dtype."""
        return kernel_ops.projection_pack_bits(self.cfg.search.enc,
                                               self.proj.dtype)

    @property
    def valid(self) -> torch.Tensor:
        """(N,) bool: slots holding a written support."""
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
        here, once."""
        x = torch.as_tensor(vectors).to(device=self.device,
                                        dtype=torch.float32)
        n = x.shape[0]
        ring = self.cfg.capacity
        if n > ring:
            raise ValueError(f"write batch ({n}) exceeds capacity ({ring})")
        if n == 0:
            return self
        if not self.calibrated:
            raise ValueError(
                "MemoryStore.write: writing to a never-calibrated store "
                "would quantize against the default (lo=0, hi=1) range and "
                "program garbage words; call store.calibrate(sample) before "
                "the first write (already-quantized supports go through "
                "MemoryStore.from_quantized instead).")
        v = _quantize(x, self.cfg.search.enc.levels, self.lo, self.hi)
        lab = torch.as_tensor(labels).to(device=self.device,
                                         dtype=torch.int32)
        start = int(self.size) % ring
        idx = (start + torch.arange(n, device=self.device)) % ring
        return self._program(idx, v, lab)

    def _program(self, idx: torch.Tensor, v: torch.Tensor,
                 lab: torch.Tensor) -> "MemoryStore":
        """Scatter a quantized batch onto ring slots `idx` (distinct, since
        the batch is no larger than the ring)."""
        enc = self.cfg.search.enc
        proj = kernel_ops.support_projection(v, enc)
        r = self.sketch_sums.shape[1]
        # the batch lands on distinct slots, so adding (new - old) bucket
        # stats is exact integer arithmetic, equal to a full rebuild
        ds_new, dc_new = router_lib.bucket_sums(v, lab, r)
        ds_old, dc_old = router_lib.bucket_sums(self.values[idx],
                                                self.labels[idx], r)

        def put(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
            return old.index_put((idx,), new.to(old.dtype))

        return dataclasses.replace(
            self,
            values=put(self.values, v),
            proj=put(self.proj, proj),
            proj_packed=put(self.proj_packed,
                            kernel_ops.pack_projection(proj, enc)),
            s_grid=put(self.s_grid, _layout(v, self.cfg)),
            labels=put(self.labels, lab),
            sketch_sums=self.sketch_sums + (ds_new - ds_old)[None],
            sketch_counts=self.sketch_counts + (dc_new - dc_old)[None],
            size=self.size + idx.shape[0],
        )

    def quantize_queries(self, queries) -> torch.Tensor:
        """Float embeddings -> quantized query words ([0, 4) for AVSS,
        [0, levels) for SVSS) on the store's device. Integer queries are
        already words and pass through. Float queries on a never-calibrated
        store raise."""
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
