"""Atomic, manifest-last, tiled checkpoints (port of
`repro.checkpoint.ckpt`).

The on-disk format is the JAX package's, so a checkpoint written by one
package restores in the other:

    <directory>/step_%010d/leaf%05d.0.npy   an unsharded leaf, one tile
    <directory>/step_%010d/leaf%05d.<start0>_<start1>....npy
                                            a row-sharded leaf (a mesh
                                            store's `ShardedRows`): one
                                            tile a shard, keyed by its
                                            global start; replicas are
                                            one block, written once
    <directory>/step_%010d/manifest.json    {"step", "leaves": [{"name",
                                             "shape", "dtype"}, ...]}

Leaves are numbered and named in `jax.tree_util`'s order of a nested dict
(sorted keys, list indices, "//" between the parts; `repro_torch.tree`).
A step is written under `.tmp-<step>-0`, the manifest last, and renamed
into place, so a writer that dies leaves no directory that looks
complete. bfloat16 leaves are stored as numpy's 2-byte void records (what
`np.save` writes for JAX's bfloat16) with the manifest dtype "bfloat16",
and read back by their raw 16 bits: the card's machine has no `ml_dtypes`.
Restore assembles a leaf of several tiles, written by either package,
into the global array.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading

import numpy as np
import torch

from repro_torch import tree as tree_lib


def _leaf_id(i: int) -> str:
    return f"leaf{i:05d}"


def _dtype_name(leaf) -> str:
    dtype = getattr(leaf, "dtype", None)
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _tiles(leaf) -> list[tuple[str, object]]:
    """(file key, part) of each tile of a leaf: a row-sharded leaf's
    non-empty blocks (its `tiles()`) keyed by their global start, as the
    reference keys a sharded array's addressable shards; any other leaf
    whole, as tile "0"."""
    tiled = getattr(leaf, "tiles", None)
    if tiled is None:
        return [("0", leaf)]
    return [("_".join(map(str, start)), part) for start, part in tiled()]


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as the array np.save writes: bf16 as 2-byte void records."""
    if isinstance(leaf, torch.Tensor):
        # a copy: a train step updates its state in place while the
        # writer thread runs, and .cpu() of a CPU tensor is the tensor
        t = leaf.detach().to("cpu", copy=True).contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.asarray(leaf)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        raw = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(raw.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, dtype=np.dtype(dtype)))


def save(directory: str, step: int, tree, *, blocking: bool = True,
         keep: int = 3) -> threading.Thread | None:
    """Write the checkpoint of `step` (a snapshot of the leaves is taken
    before returning). With blocking=False the files are written on a
    thread, which is returned. Keeps the newest `keep` steps (0: all)."""
    names, leaves = tree_lib.flatten_with_names(tree)
    meta = [{"name": n, "shape": list(leaf.shape if hasattr(leaf, "tiles")
                                      else np.shape(leaf)),
             "dtype": _dtype_name(leaf)} for n, leaf in zip(names, leaves)]
    tiles = [(f"{_leaf_id(i)}.{key}.npy", _to_numpy(part))
             for i, leaf in enumerate(leaves) for key, part in _tiles(leaf)]

    def _write():
        tmp = os.path.join(directory, f".tmp-{step}-0")
        final = os.path.join(directory, f"step_{step:010d}")
        os.makedirs(tmp, exist_ok=True)
        for fname, data in tiles:
            np.save(os.path.join(tmp, fname), data)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "leaves": meta}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        _gc(directory, keep)

    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def _gc(directory: str, keep: int) -> None:
    steps = all_steps(directory)
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:010d}"),
                      ignore_errors=True)


def all_steps(directory: str) -> list[int]:
    """The complete steps (those with a manifest), ascending."""
    if not os.path.isdir(directory):
        return []
    out = []
    for d in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", d)
        if m and os.path.exists(os.path.join(directory, d, "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str) -> int | None:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _read_leaf(d: str, i: int, info: dict) -> torch.Tensor:
    prefix = _leaf_id(i) + "."
    tiles = [f for f in os.listdir(d) if f.startswith(prefix)]
    shape = tuple(info["shape"])
    if tiles == [prefix + "0.npy"]:
        return _from_numpy(np.load(os.path.join(d, tiles[0])),
                           info["dtype"]).reshape(shape)
    parts = [(tuple(int(x) for x in f[len(prefix):-4].split("_")),
              _from_numpy(np.load(os.path.join(d, f)), info["dtype"]))
             for f in tiles]
    full = torch.zeros(shape, dtype=parts[0][1].dtype)
    for start, part in parts:
        full[tuple(slice(s, s + n) for s, n in zip(start, part.shape))] = part
    return full


def restore(directory: str, target, *, step: int | None = None,
            device: torch.device | str | None = None):
    """A tree of `target`'s structure read from the checkpoint of `step`
    (default: the latest). Leaves are matched by name and take the dtype
    and shape the manifest records; they land on `device`, else on the
    device of the target's leaf where that is a tensor, else on the CPU."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    d = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_name = {m["name"]: i for i, m in enumerate(manifest["leaves"])}
    names, leaves = tree_lib.flatten_with_names(target)
    out = []
    for name, leaf in zip(names, leaves):
        if name not in by_name:
            raise KeyError(f"checkpoint missing leaf {name}")
        i = by_name[name]
        t = _read_leaf(d, i, manifest["leaves"][i])
        dev = device if device is not None else (
            leaf.device if isinstance(leaf, torch.Tensor) else "cpu")
        out.append(t.to(dev))
    return tree_lib.unflatten(target, out)


class CheckpointManager:
    """Train-loop front end: a save every `every` steps on a writer thread,
    one write in flight at a time; the newest `keep` steps stay."""

    def __init__(self, directory: str, every: int = 100, keep: int = 3):
        self.directory = directory
        self.every = every
        self.keep = keep
        self._pending: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    def maybe_save(self, step: int, tree, force: bool = False) -> None:
        if not force and (self.every <= 0 or step % self.every):
            return
        self.wait()
        self._pending = save(self.directory, step, tree, blocking=False,
                             keep=self.keep)

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def latest_step(self) -> int | None:
        return latest_step(self.directory)

    def restore(self, target, step: int | None = None,
                device: torch.device | str | None = None):
        return restore(self.directory, target, step=step, device=device)
