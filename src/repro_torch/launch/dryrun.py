"""Multi-pod dry run (port of `repro.launch.dryrun`): trace the step of
one (arch x shape x mesh) cell on shapes alone and read the roofline terms
off the trace.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch llama3-405b --shape train_4k --mesh single [--retrieval] \\
        [--out results.json]

The reference lowers and compiles the step on 512 placeholder CPU
devices and reads XLA's cost and memory analyses and the partitioned
HLO. Here there is no compiler: the step is built exactly as a
deployment builds it (`launch/steps.py`: `make_train_step`,
`make_prefill_step`, `make_serve_step[_with_mcam]`), its parameters,
optimizer state, caches and batch come from `abstract_params` and the
step's own stand-ins on the meta device, placed by `param_shardings` /
`opt_shardings` / `cache_shardings` / `input_specs` as `Placed` tensors
on a mesh of meta POSITIONS of the production shape
(`Mesh.repeat("meta", (16, 16) | (2, 16, 16), axes)`), and the step runs
once eagerly under analysis/cost.py's trace. Succeeding proves the
shardings legalize for every leaf and the step runs on them; the record
gives FLOPs, bytes, live memory and the bytes moved between positions.
Unlike the reference, this module sets no environment variable and
touches no device when imported.

The record keeps the reference's keys; where the port differs:

  compile_s          the trace's seconds
  raw_uncorrected    the same figures as the corrected ones: an eager
                     trace counts every iteration of every loop, so there
                     is no while-loop trip-count correction
  flops_per_device   the traced total over `chips`; `flops_total` beside
                     it. The port's step runs on one controller and
                     computes all of it on the mesh's first position
                     (ROADMAP A9b.1-4: no transport between processes),
                     so the division is the work a position would do
                     under an even split, as the reference's partitioner
                     makes it
  bytes_per_device   the same, over `chips`
  collective_bytes_per_device, collectives_corrected
                     models/sharding.py's counter over the step: the
                     bytes the first position assembles from blocks
                     other positions hold ("all-gather") and writes back
                     into them ("reduce-scatter", and "all-to-all" for a
                     re-layout); the other kinds are 0. Not divided: under
                     SPMD every position gathers what the first does
  memory_analysis    argument bytes = the state a position holds; temp
                     and peak from the trace, which are the first
                     position's (it computes the whole step)
  roofline           against one H100 SXM (analysis/cost.py): 989
                     TFLOP/s bf16, 3.35 TB/s HBM, and for the collective
                     term NVLink 4 at 450 GB/s a direction on meshes of up
                     to 8 cards, 50 GB/s a card beyond (one NDR400 NIC a
                     card)

No counterpart, by design: `ICI_BW` (the TPU's interconnect rate; the
collective term here uses NVLink's, analysis/cost.py) and
`parse_collectives` (which reads partitioned HLO; the trace counts the
bytes that cross positions instead).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.analysis import cost as cost_lib
from repro_torch.configs import SHAPES, load_config, supports_shape
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import Mesh, production_mesh_shape
from repro_torch.models import transformer as tfm
from repro_torch.models.sharding import Placed, active_mesh, gathered, place

# one H100 SXM (analysis/cost.py)
PEAK_FLOPS = cost_lib.BF16_TENSOR_OPS_PER_S
HBM_BW = cost_lib.HBM_BYTES_PER_S

_COLLECTIVES = cost_lib.COLLECTIVE_KINDS

#: the retrieval head's store in a decode cell (the reference's)
RETRIEVAL_CAPACITY, RETRIEVAL_DIM = 131072, 48


def _tree_bytes_per_device(tree) -> int:
    """Bytes of the blocks one mesh position holds, over a tree whose
    leaves carry `shape`, `dtype` and `sharding` (a `Placed` leaf, an
    `InputSpec`); a leaf without a sharding counts whole."""
    total = 0
    for leaf in tree_lib.leaves(
            tree, is_leaf=lambda x: hasattr(x, "sharding")):
        shape = tuple(leaf.shape)
        shard = getattr(leaf, "sharding", None)
        if shard is not None:
            shape = shard.shard_shape(shape)
        n = int(np.prod(shape)) if shape else 1
        total += n * torch.empty((), dtype=leaf.dtype).element_size()
    return total


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense train) / 2*N*D (inference), N = active
    params (excluding embeddings), D = tokens processed."""
    aps = tfm.abstract_params(cfg)
    total = sum(int(np.prod(leaf.shape)) for leaf in tree_lib.leaves(aps))
    embed = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2) \
        if cfg.input_mode == "tokens" or not cfg.tie_embeddings else 0
    n_params = total - embed
    if cfg.moe is not None:
        m = cfg.moe
        layers_moe = sum(cfg.moe_layers())
        expert_p = m.n_routed * 3 * cfg.d_model * m.d_ff * layers_moe
        active_p = (m.top_k / m.n_routed) * expert_p
        n_params = n_params - expert_p + active_p
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6 if shape.kind == "train" else 2
    return mult * n_params * tokens


def meta_mesh(multi_pod: bool) -> Mesh:
    """The production mesh's shape and axes over meta positions."""
    shape, axes = production_mesh_shape(multi_pod)
    return Mesh.repeat("meta", shape, axes)


def _stand_ins(specs) -> dict:
    """input_specs' stand-ins as placed meta tensors."""
    return place({k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                  for k, v in specs.items()},
                 {k: v.sharding for k, v in specs.items()})


def _retrieval_store(cfg_search=None):
    """The retrieval head's store on meta rows, calibrated on the
    reference's sample (4 rows of zeros) on the host."""
    from repro_torch.core import quantization as quant_lib
    from repro_torch.core.memory import MemoryConfig
    from repro_torch.engine import MemoryStore
    mem_cfg = MemoryConfig(capacity=RETRIEVAL_CAPACITY, dim=RETRIEVAL_DIM)
    lo, hi = quant_lib.clip_range(torch.zeros(4, mem_cfg.dim),
                                  mem_cfg.clip_std)
    store = MemoryStore.create(mem_cfg, device="meta")
    return mem_cfg, dataclasses.replace(store, lo=lo.to("meta"),
                                        hi=hi.to("meta"), calibrated=True)


def _trace_step(cfg, shape, mesh, rules, tc, retrieval):
    """Build the step `shape` dictates on placed meta inputs and trace one
    call. Returns (the trace record, state bytes a position)."""
    p_shard = steps_lib.param_shardings(cfg, mesh, rules)
    params_abs = tfm.abstract_params(cfg)
    params_in = place(params_abs, p_shard)
    batch_in = _stand_ins(steps_lib.input_specs(cfg, shape, mesh, rules))

    with active_mesh(mesh, rules):
        if shape.kind == "train":
            step, optimizer = steps_lib.make_train_step(cfg, tc, rules)
            opt_abs = optimizer.init(params_abs)
            opt_in = place(opt_abs, steps_lib.opt_shardings(
                opt_abs, params_abs, p_shard, mesh, rules))
            state_bytes = (_tree_bytes_per_device(params_in)
                           + _tree_bytes_per_device(opt_in))
            _, rec = cost_lib.trace(step, params_in, opt_in, batch_in)
        elif shape.kind == "prefill":
            step = steps_lib.make_prefill_step(cfg, rules=rules)
            state_bytes = _tree_bytes_per_device(params_in)
            _, rec = cost_lib.trace(step, params_in, batch_in)
        else:  # decode
            c_shard, cache_abs = steps_lib.cache_shardings(
                cfg, shape.global_batch, shape.seq_len, mesh, rules)
            cache_in = place(cache_abs, c_shard)
            state_bytes = (_tree_bytes_per_device(params_in)
                           + _tree_bytes_per_device(cache_in))
            pos = shape.seq_len - 1
            if retrieval:
                mem_cfg, store = _retrieval_store()
                step = steps_lib.make_serve_step_with_mcam(cfg, mem_cfg,
                                                           rules=rules)

                def run(p, c, b):
                    return step(p, gathered(c), gathered(b), pos, store)
            else:
                step = steps_lib.make_serve_step(cfg, rules=rules)

                def run(p, c, b):
                    return step(p, gathered(c), gathered(b), pos)
            _, rec = cost_lib.trace(run, params_in, cache_in, batch_in)
    return rec, int(state_bytes)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             retrieval: bool = False, calibrate: bool = True) -> dict:
    """One cell's record (the reference's keys, see the module
    docstring). `calibrate` is kept for the reference's signature: the
    trace needs no correction."""
    del calibrate
    mesh = meta_mesh(multi_pod)
    n_chips = int(np.prod(mesh.devices.shape))
    shape = SHAPES[shape_name]
    rules = steps_lib.rules_for(mesh, shape)
    cfg = load_config(arch)
    ok, why = supports_shape(cfg, shape)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16"}
    if not ok:
        return {**rec, "status": "skipped", "reason": why}

    dp = int(np.prod([mesh.shape[a] for a in rules.batch]))
    cfg = steps_lib.adapt_config(cfg, shape, dp)
    tc = TrainConfig()

    t0 = time.time()
    traced, state_bytes = _trace_step(cfg, shape, mesh, rules, tc,
                                      retrieval)
    compile_s = time.time() - t0
    total = cost_lib.roofline_metrics(traced)
    per = {k: (v / n_chips if k in ("flops", "bytes") else v)
           for k, v in total.items()}
    mem = {"argument_size_in_bytes": int(state_bytes),
           "output_size_in_bytes": 0,
           "temp_size_in_bytes": int(traced["temp_bytes"]),
           "peak_size_in_bytes": int(state_bytes + traced["temp_bytes"])}

    flops = per["flops"]
    bytes_acc = per["bytes"]
    coll_bytes = per["coll_total"]
    mf = model_flops(cfg, shape)
    compute_s = flops / PEAK_FLOPS
    memory_s = bytes_acc / HBM_BW
    collective_s = coll_bytes / cost_lib.collective_bytes_per_s(n_chips)
    dominant = max((("compute", compute_s), ("memory", memory_s),
                    ("collective", collective_s)), key=lambda kv: kv[1])[0]
    return {
        **rec, "status": "ok", "chips": n_chips,
        "compile_s": round(compile_s, 1),
        "flops_per_device": flops,
        "flops_total": total["flops"],
        "bytes_per_device": bytes_acc,
        "collective_bytes_per_device": coll_bytes,
        "collectives_corrected": {k: per[f"coll_{k}"]
                                  for k in _COLLECTIVES},
        "raw_uncorrected": per,
        "memory_analysis": mem,
        "state_bytes_per_device": int(state_bytes),
        "model_flops_total": mf,
        "useful_flops_ratio": (mf / (flops * n_chips)) if flops else None,
        "host_syncs": traced["host_syncs"],
        "roofline": {
            "compute_s": compute_s, "memory_s": memory_s,
            "collective_s": collective_s, "dominant": dominant,
            "bound_s": max(compute_s, memory_s, collective_s),
        },
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--retrieval", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    rec = run_cell(args.arch, args.shape, args.mesh == "multi",
                   retrieval=args.retrieval)
    js = json.dumps(rec, indent=1)
    print(js)
    if args.out:
        with open(args.out, "w") as f:
            f.write(js)
    if rec["status"] == "ok":
        print(f"\nMEMORY: {rec['memory_analysis']}", file=sys.stderr)
        print(f"COST: flops/dev={rec['flops_per_device']:.3e} "
              f"bytes/dev={rec['bytes_per_device']:.3e}", file=sys.stderr)
    return 0 if rec["status"] in ("ok", "skipped") else 1


if __name__ == "__main__":
    sys.exit(main())
