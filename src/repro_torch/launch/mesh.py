"""Device meshes (port of `repro.launch.mesh`).

`Mesh` is a single-controller mesh: named axes over an array of
`torch.device`s, as `jax.sharding.Mesh` names its devices. One Python
program drives every position and gets global results; a mesh-sharded
`MemoryStore` holds one row block per shard on its shard's device
(engine/sharded.py). A position may repeat a device: a mesh of 8
positions on one card (or on the CPU) runs every shard there, which is
how the tests and `chip_smoke.py` exercise the sharded path on one
device, as JAX's `--xla_force_host_platform_device_count` does on the
host.

Functions, never module-level constants, so importing this module
touches no device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


class Mesh:
    """Named axes over an array of devices: `devices` an object array of
    `torch.device`s whose shape gives the axes' sizes; `shape` a dict of
    axis name -> size (JAX's `mesh.shape`)."""

    def __init__(self, devices, axis_names: Sequence[str]) -> None:
        given = np.asarray(devices, dtype=object)
        arr = np.empty(given.shape, dtype=object)
        for pos in np.ndindex(arr.shape):
            arr[pos] = torch.device(given[pos])
        if arr.ndim != len(axis_names):
            raise ValueError(f"Mesh: {arr.ndim} device axes for axis names "
                             f"{tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)

    @classmethod
    def repeat(cls, device: torch.device | str, shape: Sequence[int],
               axis_names: Sequence[str]) -> "Mesh":
        """`shape` positions, every one on `device`."""
        devices = np.empty(tuple(shape), dtype=object)
        devices.fill(torch.device(device))
        return cls(devices, axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        names = sorted(set(map(str, self.devices.flat)))
        return f"Mesh({self.shape}, devices={names})"


def production_mesh_shape(multi_pod: bool = False
                          ) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """(shape, axis names) of the production mesh: (16, 16) data x model
    single pod; (2, 16, 16) pod x data x model for the 2-pod = 512-device
    deployment."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production mesh (`production_mesh_shape`) over this host's
    CUDA devices; raises below 256 / 512 of them."""
    shape, axes = production_mesh_shape(multi_pod)
    n = int(np.prod(shape))
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < n:
        raise RuntimeError(f"mesh {shape} needs {n} devices, found {found}")
    devices = [torch.device("cuda", i) for i in range(n)]
    return Mesh(np.array(devices, dtype=object).reshape(shape), axes)


def make_host_mesh(model_parallel: int = 1,
                   device: torch.device | str | None = None) -> Mesh:
    """Whatever this host has: (n / mp, mp) data x model over every CUDA
    device (one card: (1, 1)), or over the one `device` asked for (e.g.
    "cpu"). Raises when no CUDA device is found and none is asked for."""
    if device is not None:
        devices = [torch.device(device)]
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_host_mesh: no CUDA device is available; pass "
                "device='cpu' for a mesh on the host")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    n = len(devices)
    mp = max(1, min(model_parallel, n))
    kept = np.empty(((n // mp) * mp,), dtype=object)
    kept[:] = devices[: (n // mp) * mp]
    return Mesh(kept.reshape(n // mp, mp), ("data", "model"))
