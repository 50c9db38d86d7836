"""Logical-axis sharding rules (port of `repro.models.sharding`) and the
placed tensors of a single-controller mesh.

Model code names every parameter's and activation's dims with LOGICAL
axis names; a `Rules` table maps them onto the mesh's physical axes per
deployment. The production meshes are (16, 16) ("data", "model") and
(2, 16, 16) ("pod", "data", "model"); the pod axis joins the
data-parallel / FSDP dimension.

  batch   -- data-parallel batch sharding of activations
  fsdp    -- ZeRO-3-style weight / optimizer row sharding
  tensor  -- Megatron-style head / ffn / vocab column sharding
  expert  -- MoE routed-expert sharding
  seq     -- sequence parallelism (long-context KV caches)

The JAX types have counterparts here: `PartitionSpec` (a tuple whose
entries are None, an axis name or a tuple of names), `NamedSharding`
over the port's `launch.mesh.Mesh`, whose `devices_indices_map(shape)`
gives the index slices each mesh POSITION holds (JAX keys it by device;
here positions may repeat a device), and `Placed`, a tensor laid out by
a NamedSharding: one block a position, on that position's device.

One Python program drives every position (the mesh is single-controller,
as JAX's is), so a placed tensor is a layout of storage, not of work: a
step assembles a leaf's blocks on the mesh's first device where it
computes with it (`Placed.full`) and writes results back block by block.
GSPMD's contract holds: every value equals the unplaced computation's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.launch.mesh import Mesh


def _entry(e):
    """A spec entry in JAX's normal form: a one-name tuple is the name, an
    empty one None, a list a tuple."""
    if e is None or isinstance(e, str):
        return e
    e = tuple(e)
    return None if not e else e[0] if len(e) == 1 else e


class PartitionSpec(tuple):
    """`jax.sharding.PartitionSpec`: entry i says how dim i splits over the
    mesh -- None (not split), an axis name, or a tuple of names (split
    over the product of their sizes, row-major in the tuple's order).
    Dims past the last entry are not split."""

    def __new__(cls, *parts):
        return super().__new__(cls, (_entry(e) for e in parts))

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class Rules:
    batch: tuple = ("data",)
    fsdp: tuple = ("data",)
    tensor: tuple = ("model",)
    expert: tuple = ("model",)
    seq: tuple = ()

    def resolve(self, *logical: str | None) -> PartitionSpec:
        """Logical axis names -> PartitionSpec."""
        out = []
        for name in logical:
            if name is None:
                out.append(None)
                continue
            axes = getattr(self, name)
            if not axes:
                out.append(None)
            elif len(axes) == 1:
                out.append(axes[0])
            else:
                out.append(tuple(axes))
        return P(*out)


def rules_for_mesh(mesh: Mesh, *, seq_sharding: bool = False) -> Rules:
    """Default rules for the production meshes."""
    names = mesh.axis_names
    dp = ("pod", "data") if "pod" in names else ("data",)
    return Rules(batch=dp, fsdp=dp, tensor=("model",), expert=("model",),
                 seq=("data",) if seq_sharding else ())


def _axes_of(entry) -> tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _split(mesh: Mesh, entry) -> int:
    """How many pieces a spec entry splits its dim into."""
    sizes = mesh.shape
    return int(np.prod([sizes[a] for a in _axes_of(entry)]))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """`jax.sharding.NamedSharding`: a PartitionSpec over a mesh."""
    mesh: Mesh
    spec: PartitionSpec

    def devices_indices_map(self, shape: Sequence[int]
                            ) -> dict[tuple[int, ...], tuple[slice, ...]]:
        """{mesh position: the index slices of a `shape` array it holds},
        positions in row-major order. A dim not split (or split into one
        piece) is `slice(None)`; a split dim must divide evenly."""
        shape = tuple(shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"{self.spec} has more entries than the "
                             f"{len(shape)} dims of {shape}")
        sizes = self.mesh.shape
        for entry in self.spec:
            if entry is not None:
                for a in _axes_of(entry):
                    if a not in sizes:
                        raise ValueError(f"{self.spec}: {a!r} is not an axis "
                                         f"of the mesh {tuple(sizes)}")
        out = {}
        for pos in np.ndindex(self.mesh.devices.shape):
            coords = dict(zip(self.mesh.axis_names, pos))
            idx = []
            for d, n in enumerate(shape):
                entry = self.spec[d] if d < len(self.spec) else None
                pieces = 1 if entry is None else _split(self.mesh, entry)
                if pieces == 1:
                    idx.append(slice(None))
                    continue
                if n % pieces:
                    raise ValueError(f"dim {d} of {shape} does not divide "
                                     f"into {pieces} pieces ({self.spec})")
                block = 0
                for a in _axes_of(entry):
                    block = block * sizes[a] + coords[a]
                step = n // pieces
                idx.append(slice(block * step, (block + 1) * step))
            out[pos] = tuple(idx)
        return out


def logical_sharding(mesh: Mesh, rules: Rules, *logical) -> NamedSharding:
    return NamedSharding(mesh, rules.resolve(*logical))


_ACTIVE_MESH: list = [None]
_ACTIVE_RULES: list = [None]


class active_mesh:
    """Context manager giving `constrain` / `aconstrain` a mesh (and
    optional Rules) to bind PartitionSpecs to, so layer code can annotate
    activation layouts without threading mesh / rules through every
    call."""

    def __init__(self, mesh, rules=None):
        self.mesh = mesh
        self.rules = rules

    def __enter__(self):
        _ACTIVE_MESH[0] = self.mesh
        _ACTIVE_RULES[0] = self.rules
        return self.mesh

    def __exit__(self, *exc):
        _ACTIVE_MESH[0] = None
        _ACTIVE_RULES[0] = None
        return False


def legalize_spec(spec: PartitionSpec, shape, mesh) -> PartitionSpec:
    """DROP mesh axes whose size does not divide the dim they shard (no
    shifting to a neighbouring dim: replicating the indivisible dim is
    cheaper than a partial-sum contraction). The result has one entry a
    dim."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = [None] * len(shape)
    for i, p in enumerate(parts):
        if p is None:
            continue
        if shape[i] % _split(mesh, p) == 0:
            out[i] = p
    return P(*out)


def aconstrain(x, *logical):
    """Activation layout by logical names on the ACTIVE mesh / rules. A
    tensor is returned unchanged: the single controller computes an
    activation on one device, and the constraint changes no value. A
    `Placed` tensor is re-placed by the legalized spec. No-op without an
    active mesh and rules, and for an all-None spec (a replicated pin
    would force the full tensor onto every position)."""
    mesh, rules = _ACTIVE_MESH[0], _ACTIVE_RULES[0]
    if not isinstance(x, Placed) or mesh is None or rules is None:
        return x
    spec = legalize_spec(rules.resolve(*logical), x.shape, mesh)
    if all(p is None for p in spec):
        return x
    return x.replaced(NamedSharding(mesh, spec))


def constrain(x, rules: Rules, *logical):
    """`aconstrain` with the given rules: a tensor unchanged; a `Placed`
    one re-placed on the active mesh (kept as it is without one, or for
    an all-None spec)."""
    mesh = _ACTIVE_MESH[0]
    if not isinstance(x, Placed) or mesh is None:
        return x
    spec = legalize_spec(rules.resolve(*logical), x.shape, mesh)
    if all(p is None for p in spec):
        return x
    return x.replaced(NamedSharding(mesh, spec))


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Logical axes for one parameter array (None entries are unsharded)."""
    logical: tuple

    def sharding(self, mesh: Mesh, rules: Rules) -> NamedSharding:
        return logical_sharding(mesh, rules, *self.logical)


def tree_shardings(spec_tree, mesh: Mesh, rules: Rules):
    """A tree of ParamSpec -> the tree of NamedSharding."""
    return tree_lib.tree_map(lambda s: s.sharding(mesh, rules), spec_tree)


# --------------------------------------------------------------------------
# Placed tensors.
# --------------------------------------------------------------------------

_NOT_ONE_TENSOR = ("a placed tensor is not one tensor: assemble it with "
                   ".full(device), or read .block(position)")


def _device_key(d: torch.device) -> tuple:
    """A device as (type, index), a CUDA device without an index being the
    current one (a tensor moved to "cuda" lies on "cuda:<current>")."""
    if d.type == "cuda" and d.index is None:
        return ("cuda", torch.cuda.current_device())
    return (d.type, d.index)


def _key(idx: tuple[slice, ...]) -> tuple:
    """A block's index slices as a hashable key: None for a whole dim,
    (start, stop) for a split one."""
    return tuple(None if s == slice(None) else (s.start, s.stop)
                 for s in idx)


def _slices(key: tuple) -> tuple[slice, ...]:
    return tuple(slice(None) if k is None else slice(*k) for k in key)


def _assemble(items: list, d: int, device: torch.device) -> torch.Tensor:
    """The tiles `items` ([(key, tensor)], all sharing key[:d]) joined
    along dims d.. on `device`: nested `torch.cat`, differentiable."""
    if d == len(items[0][0]):
        return items[0][1].to(device)
    if items[0][0][d] is None:
        return _assemble(items, d + 1, device)
    groups: dict = {}
    for k, t in items:
        groups.setdefault(k[d], []).append((k, t))
    parts = [_assemble(groups[s], d + 1, device) for s in sorted(groups)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, d)


class Placed:
    """A tensor laid out over a mesh by a NamedSharding: each mesh
    position holds the block `sharding.devices_indices_map(shape)` names,
    on the position's device. Positions on one device that hold the same
    indices share one tensor; a block held on several devices has a
    replica on each (`tiles[key]`: the first position's device's first).

    It is not a tensor: indexing it, or handing it to torch or numpy,
    raises. `full(device)` assembles the global array (differentiably,
    from each block's first replica); `block(position)` is one
    position's block; `write(full)` writes a global array back into
    every block in place."""

    __slots__ = ("sharding", "shape", "dtype", "tiles")

    def __init__(self, sharding: NamedSharding, shape, dtype: torch.dtype,
                 tiles: dict[tuple, list[torch.Tensor]]) -> None:
        self.sharding = sharding
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.tiles = tiles

    @classmethod
    def place(cls, x: torch.Tensor, sharding: NamedSharding) -> "Placed":
        """`x`'s blocks copied to their positions' devices."""
        tiles: dict[tuple, list[torch.Tensor]] = {}
        for pos, idx in sharding.devices_indices_map(x.shape).items():
            dev = sharding.mesh.devices[pos]
            reps = tiles.setdefault(_key(idx), [])
            if all(_device_key(r.device) != _device_key(dev) for r in reps):
                reps.append(x[idx].to(device=dev, copy=True,
                                      memory_format=torch.contiguous_format))
        return cls(sharding, x.shape, x.dtype, tiles)

    @property
    def device(self) -> torch.device:
        """The compute device: the mesh's first position's."""
        return self.sharding.mesh.devices.flat[0]

    def numel(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    def _indices(self) -> dict:
        return self.sharding.devices_indices_map(self.shape)

    def block(self, pos: tuple[int, ...]) -> torch.Tensor:
        """The block mesh position `pos` holds (on its device)."""
        dev = _device_key(self.sharding.mesh.devices[pos])
        reps = self.tiles[_key(self._indices()[pos])]
        return next(r for r in reps if _device_key(r.device) == dev)

    def canonical(self) -> dict[tuple, torch.Tensor]:
        """{block key: its first replica}."""
        return {k: reps[0] for k, reps in self.tiles.items()}

    def full(self, device: torch.device | str | None = None
             ) -> torch.Tensor:
        """The global array on `device` (default: the compute device).
        One block (a replicated leaf) is returned as it is, no copy."""
        dev = self.device if device is None else torch.device(device)
        items = sorted(self.canonical().items(), key=lambda kv: tuple(
            -1 if k is None else k[0] for k in kv[0]))
        return _assemble(items, 0, dev)

    def with_canonical(self, blocks: dict[tuple, torch.Tensor]
                       ) -> "Placed":
        """The same layout holding `blocks` (one a key, no replicas): a
        gradient, or an alias that autograd differentiates."""
        return Placed(self.sharding, self.shape, self.dtype,
                      {k: [t] for k, t in blocks.items()})

    def blocks_of(self, full: torch.Tensor) -> "Placed":
        """`full` cut into this layout's blocks (copies, one a key, on
        `full`'s device)."""
        return self.with_canonical({k: full[_slices(k)].clone()
                                    for k in self.tiles})

    def replaced(self, sharding: NamedSharding) -> "Placed":
        """The same values under another layout (a copy)."""
        return Placed.place(self.full(), sharding)

    def unbind(self, dim: int = 0) -> list["Placed"]:
        """The slices along an unsplit dim 0, each a Placed of views of
        this one's blocks (a stacked layer group's layers)."""
        if dim != 0 or any(k[0] is not None for k in self.tiles):
            raise ValueError("Placed.unbind: only an unsplit dim 0")
        spec = tuple(self.sharding.spec) + (None,) * (
            len(self.shape) - len(self.sharding.spec))
        sh = NamedSharding(self.sharding.mesh, P(*spec[1:]))
        parts = {k: [r.unbind(0) for r in reps]
                 for k, reps in self.tiles.items()}
        return [Placed(sh, self.shape[1:], self.dtype,
                       {k[1:]: [r[i] for r in reps]
                        for k, reps in parts.items()})
                for i in range(self.shape[0])]

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "Placed":
        """`fn` of every block and replica, on its device (a function
        that keeps each block's shape; the dtype is the results')."""
        tiles = {k: [fn(r) for r in reps] for k, reps in self.tiles.items()}
        dtype = next(iter(tiles.values()))[0].dtype
        return Placed(self.sharding, self.shape, dtype, tiles)

    @torch.no_grad()
    def write(self, full: torch.Tensor) -> None:
        """Copy `full`'s slices into every block and replica, in place."""
        for k, reps in self.tiles.items():
            part = full[_slices(k)]
            for r in reps:
                if r.data_ptr() != part.data_ptr() or r.shape != part.shape:
                    r.copy_(part)

    @torch.no_grad()
    def sync(self) -> None:
        """Copy each block's first replica into its other replicas."""
        for reps in self.tiles.values():
            for r in reps[1:]:
                r.copy_(reps[0])

    def same_layout(self, other) -> bool:
        """The same shape, blocks and devices (so the two can be updated
        block by block together)."""
        return (isinstance(other, Placed) and self.shape == other.shape
                and self.tiles.keys() == other.tiles.keys()
                and all([_device_key(r.device) for r in reps]
                        == [_device_key(r.device) for r in other.tiles[k]]
                        for k, reps in self.tiles.items()))

    def nbytes_at(self, pos: tuple[int, ...]) -> int:
        """Bytes of the block position `pos` holds."""
        b = self.block(pos)
        return b.numel() * b.element_size()

    @property
    def nbytes(self) -> int:
        """Bytes of every block and replica (shared blocks once)."""
        return sum(r.numel() * r.element_size()
                   for reps in self.tiles.values() for r in reps)

    def __repr__(self) -> str:
        return (f"Placed(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"spec={self.sharding.spec}, blocks={len(self.tiles)})")

    def _refuse(self, *_: Any, **__: Any):
        raise TypeError(_NOT_ONE_TENSOR)

    __getitem__ = __array__ = __len__ = _refuse
    __eq__ = __ne__ = __lt__ = __le__ = __gt__ = __ge__ = _refuse
    __hash__ = object.__hash__

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        raise TypeError(_NOT_ONE_TENSOR)

    def __getattr__(self, name: str):
        raise AttributeError(f"Placed has no {name!r}: {_NOT_ONE_TENSOR}")


def place(tree, shardings):
    """Every tensor leaf of `tree` placed by the NamedSharding at the same
    position of `shardings` (a tree of the same structure)."""
    return tree_lib.tree_map(Placed.place, tree, shardings)


def gathered(tree, device: torch.device | str | None = None):
    """`tree` with every Placed leaf assembled (`full(device)`, default its
    compute device); tensors and other leaves as they are."""
    return tree_lib.tree_map(
        lambda a: a.full(device) if isinstance(a, Placed) else a, tree)
