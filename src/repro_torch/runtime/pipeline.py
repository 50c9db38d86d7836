"""GPipe-style pipeline parallelism over one mesh axis (port of
`repro.runtime.pipeline`).

Stages lie along a "pipe" axis of a `launch.mesh.Mesh`; microbatches
stream through them with the GPipe schedule (S + M - 1 ticks for M
microbatches over S stages), and each hop between stages is a copy of
the activation block to the next stage's device (the reference's
`ppermute`). Stage i's parameters live on the mesh position with pipe
coordinate i (index 0 along every other axis).

The reference runs this as one SPMD program (`shard_map`), in which
every stage computes every tick, on zeros while the pipe fills and
drains; here one controller runs the ticks as a loop and calls a stage
only on a tick where it holds a microbatch. The outputs are the same:
each microbatch passes through the stages in order with the same
parameters.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch import tree as tree_lib
from repro_torch.launch.mesh import Mesh
from repro_torch.models.sharding import NamedSharding, P, Placed


def _stage_positions(mesh: Mesh, axis: str) -> list[tuple[int, ...]]:
    names = mesh.axis_names
    if axis not in names:
        raise ValueError(f"pipeline axis {axis!r} is not an axis of the "
                         f"mesh {names}")
    return [tuple(i if a == axis else 0 for a in names)
            for i in range(mesh.shape[axis])]


def pipeline_apply(stage_fn: Callable, params_stacked, x_microbatches:
                   torch.Tensor, mesh: Mesh, axis: str = "pipe"
                   ) -> torch.Tensor:
    """Run M microbatches through S pipeline stages.

    stage_fn(stage_params, x) -> x (the per-stage computation, keeping
    x's shape). params_stacked: a tree with leading axis S (stage-major);
    its tensors are placed over `axis` (a `Placed` leaf already laid out
    that way is used as it is). x_microbatches: (M, mb, ...). Returns the
    (M, mb, ...) outputs of the LAST stage, in x's dtype, on the mesh's
    first position's device: as the reference's masked psum returns
    them, the last stage's outputs plus every other stage's zeros."""
    positions = _stage_positions(mesh, axis)
    n_stages = len(positions)
    M = x_microbatches.shape[0]
    if M < 1:
        raise ValueError("pipeline_apply: no microbatches")
    by_axis = NamedSharding(mesh, P(axis))

    def stage_params(a, pos):
        if not isinstance(a, Placed):
            a = Placed.place(a, by_axis)
        return a.block(pos)[0]

    params = [tree_lib.tree_map(lambda a: stage_params(a, pos),
                                params_stacked) for pos in positions]
    devs = [mesh.devices[pos] for pos in positions]
    outs = torch.zeros_like(x_microbatches, device=devs[-1])
    bufs: list = [None] * n_stages      # the microbatch each stage holds
    for t in range(n_stages + M - 1):
        # stage 0 ingests microbatch t while any remain
        bufs[0] = x_microbatches[t].to(devs[0]) if t < M else None
        ys = [None if b is None else stage_fn(p, b)
              for p, b in zip(params, bufs)]
        # the last stage emits microbatch t - (S - 1)
        if t >= n_stages - 1:
            outs[t - (n_stages - 1)] = ys[-1]
        # shift activations downstream: stage i -> i + 1
        bufs = [None] + [None if y is None else y.to(d)
                         for y, d in zip(ys[:-1], devs[1:])]
    first = mesh.devices.flat[0]
    if n_stages == 1:
        return outs.to(first)
    total = torch.zeros_like(outs, device=first)
    for i in range(n_stages):
        total = total + (outs.to(first) if i == n_stages - 1
                         else torch.zeros_like(total))
    return total
