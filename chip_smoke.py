#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--capacity 65536] [--seed 0]

Builds the four CUDA kernel sources of `src/repro_torch/csrc/` (one nvcc
per source, all started together; ptxas's registers / shared memory / spills,
the count of wgmma (HGMMA) instructions in the LUT product's SASS and of
mma.sync (IMMA) ones in each of the shortlist's two select kernels are
printed, and a one-table select without IMMA fails), checks on all 2**32
hash words that the physics kernel's cheaper arithmetic forms equal the
plain version's bit for bit, then
drives the port's main path through
the entry points a user calls, at the paper's Omniglot geometry (d = 48,
MTMC CL = 32, 24-cell strings: 64 strings per support) and a many-class
store of 65,536 supports (4,096 classes x 16 shots):

  1. program    MemoryStore.create -> calibrate -> write, one batch
  2. two_phase  default backend: shortlist kernel + gathered physics kernel
  3. ideal      shortlist kernel
  4. two_phase  backend="mxu", fused_min_rows > N: LUT product kernel over
                the whole (256 x N) matrix, then the exact key selection
  5. full       16 queries against every row: dense physics kernel

Then the searches over per-query lists of row blocks, each through the
block-table entry of csrc/shortlist.cu (rows `shortlist_blocks` at
nprobe 8, `shortlist_blocks_p1` at nprobe 1, `shortlist_blocks_tenants`
on the tenant stack, `shortlist_blocks_cub` at d = 480; each on the
inputs its path gives the entry, bit for bit against the plain version,
with the device time of each pass -- group, select, merge -- and the
descending / masked tables at k = 1, 64, 1,024, of 16-bit fields at both
widths and of 8-bit fields at d = 480):

  [routed]     the same store in 64 logical shards (1,024 rows, 64
               classes x 16 shots a shard), two_phase and ideal at nprobe
               1, 8 and 32: each equal, bit for bit, to the plain route
               (backend "ref") over the same visited shards; nprobe 64 and
               None byte for byte to the exhaustive search; two_phase
               votes equal to the full search's at the same global rows;
               top-1 and recall@64 against the exhaustive search printed
  [tenants]    64 Omniglot tenants of ragged capacities (1,024..4,096,
               some slots never written; 262,144 rows stacked) and 256
               queries of mixed tenants: two_phase, ideal, full and the
               dense two_phase on mxu, each equal to every tenant's solo
               search bit for bit; then TenantServer: 16 flushes of 256
               submits, a write_at after every 4th, every flush launching
               the same kernels
  [pager]      a store of 1,048,576 rows in 256 shards in pinned host
               memory (2.4 GB), paged through 16 device slots by 8 batches
               of 64 queries at nprobe 4 (classes written in groups of 4
               shards; a batch draws from two groups, the next batch
               shares one): each equal to the device twin's routed search

Then the LM serving entry point at full width (random weights drawn on
the card from the seed):

  [lm-serve]   `launch/serve.serve(arch, smoke=False, ...)`: starcoder2-3b
               (30 layers, d = 3,072, bf16) decodes 4 requests (8 prompt
               + 16 steps) with the kNN-LM head over the 1,024-row demo
               store in each mode (two_phase, ideal, dense, routed at
               nprobe 2 of 8 shards, two_phase on mxu) and without it,
               then with the head over a 65,536-row token store at d = 48;
               deepseek-moe-16b (28 layers, 64 routed + 2 shared experts,
               top-6), xlstm-350m (mLSTM / sLSTM), hymba-1.5b (attention
               with Mamba) and deepseek-v3-671b (MLA; cut to 4 layers:
               3 dense, 1 of 256 routed + 1 shared experts, top-8) with
               two_phase and without; musicgen-medium and qwen2-vl-7b
               (embedding inputs; M-RoPE), which `serve` cannot feed
               (ROADMAP C.R4), through the step functions with an
               embeddings batch. Every search of the head equals, in
               labels, votes and rows, the same store searched on the
               host by the plain route with the same hidden rows; decode
               over a prompt equals forward over it within
               LM_DECODE_ATOL (the archs without MoE); the decode step's
               time with and without the head, a profiled step of each
               (idle share, launches, device time by kind), the peak
               memory and the weight-bytes bound are printed; for the
               archs with mLSTM layers, a profiled prefill with the
               port's `kinks.cummax` and with `torch.cummax` in its
               place (launches, device ms; the same logits bit for bit)

Then the same path at the paper's CUB geometry:

  [cub-serve]  d = 480, MTMC CL = 25 (500 strings of 24 cells a support,
               480-word packed rows, a 1,920-deep LUT product) on a store
               of the same size: two_phase (fused), ideal, two_phase on
               mxu and full (B = 4), each path with its launch counts, top-1
               accuracy >= MIN_ACCURACY, and each kernel held against its
               plain version bit for bit (a row each, `<kernel>_cub`);
               then [routed cub]: the store in 64 shards at nprobe 8
               (row `shortlist_blocks_cub`)

Then hardware-aware training (paper Sec. 3.3):

  6. [episode]  a 20-way 10-shot episode with 4 queries a class (B = 80,
                N = 200: 24.6 M cells, where the plain versions fit): the
                dense physics kernel with a noise-stream coordinate equals
                its plain version bit for bit, noisy and noiseless; the
                episodic backward kernel's dq / ds agree with autograd
                through the plain forward (max relative error, cosine) and
                a second run gives the same bits
  7. [hat]      the trainer at the paper's full Omniglot width
                (`configs/omniglot_conv4.get_config`: 200-way 10-shot,
                d = 48, MTMC CL = 32, AVSS; MCAMConfig(sigma_device=0.15,
                sigma_read=0.05) and Conv4 width 32 as `launch/train.py`;
                4 queries a class: B = 800, N = 2,000, 2.46 G cells a
                step), under the trainer's deterministic settings
                (`launch/train.make_deterministic`, from [episode] on; its
                CUBLAS_WORKSPACE_CONFIG is set before any CUDA work):
                first a probe of which settings make the gradient
                of a first pretrain and meta step give the same bits in
                DETERMINISM_RUNS runs (none, cuDNN's deterministic
                convolutions, torch's deterministic algorithms, the
                trainer's; the trainer's must); then HAT_PRETRAIN_STEPS
                pretrain steps (batch 32 over the 964 training classes)
                and HAT_META_STEPS meta steps on one episode, made once on
                the host and reused; every loss finite, the dense and
                backward kernels launched once a meta step. The same steps
                run again from the same start without the settings
                (their cost) and with them, which must repeat every loss
                and every parameter and optimizer leaf bit for bit. Then
                the trained
                controller is served: `MemoryStore.from_episode` ->
                `search(mode="full", noisy=False)`, whose class-mean votes
                must equal `episode_scores(noisy=False)` bit for bit; and
                the store and the controller go through save -> restore,
                the restored store searching to the same bits. The
                backward kernel is held against its plain version at this
                width (the plain version runs in row blocks).
  8. [cub]      the same at the paper's CUB width (`configs/cub_resnet12`:
                50-way 5-shot, d = 480, MTMC CL = 25, 4 queries a class:
                B = 200, N = 250, 500 strings a support), ResNet12 (64,
                160, 320, 640) on 84x84x3 CUB-like images:
                CUB_PRETRAIN_STEPS + CUB_META_STEPS steps repeated bit for
                bit from the same start, their cost without the settings,
                the peak memory, train == serve bit for bit, the episodic
                kernels against their plain versions (row
                `mcam_episode_cub`), and one profiled meta step (ResNet12
                against the episodic kernels).

Then the paper's evaluation and the other optimizers:

  9. [paper]    the evaluation twin (`repro_torch.examples.fsl_omniglot`)
                with full searches and with two_phase on the fused route:
                every cell of the matrix launched its kernels, the serve
                check held; the quickstart twin answers 100%
 10. [optim]    adamw8bit, adafactor and sgd over a ResNet12 tree on the
                card against the CPU, within OPTIM_RTOL

Then LM training at full width (random weights drawn on the card from
the seed, under the trainer's deterministic settings):

 11. [lm-train] `launch/train.train(arch, smoke=False, ...)`: starcoder2-3b
                (30 layers, d = 3,072, bf16, remat, AdamW with float32
                moments) at global batch 8 x 1,024 tokens for 30 steps,
                deepseek-moe-16b cut in depth to 4 layers (1 dense + 3
                MoE of 64 routed + 2 shared experts, top-6) for 6 and
                xlstm-350m (24 layers, B = 8, S = 128: two mLSTM chunks;
                at S = 256 its gradients overflow the float32 norm in
                both packages, ROADMAP C.R7) for 4: every step's loss
                finite and applied; starcoder2-3b's loss falls; a second
                run from the seed repeats the losses and every parameter
                and state leaf's checksum; step ms, tokens/s and MFU
                against 6 N T at the bf16 peak, a profiled step (idle
                share, launches, device ms by kind) and peak memory
                against the state's bytes; starcoder2-3b also at
                microbatch 4 (accumulation over 2); a smoke model with an
                inf weight steps with applied 0 and every leaf unchanged.
                No MCAM kernel launches in the phase.
 12. [lm-mesh]  the LM's sharding layer on meshes of positions of the
                card: starcoder2-3b's train step (full width, B 8 x
                1,024) with parameters, AdamW state and batches placed on
                the reference test's (2, 2, 2) pod / data / model mesh
                (`param_shardings`, `opt_shardings`, `input_specs`, under
                `active_mesh`) equals the unplaced step bit for bit over
                3 steps (losses, grad norms, every leaf's checksum), with
                each side's step ms, a profiled step, peak memory and the
                bytes a position holds; `train(model_parallel=2)` equals
                `model_parallel=1` over 2 steps; [hat]'s full-width meta
                step on an episode placed over (4,) "data" positions
                equals the unplaced one (its dense and backward kernels
                launched); `runtime/pipeline.pipeline_apply` of 4
                tanh(h @ W) stages of d = 3,072 over 6 microbatches
                equals the sequential loop; the legacy
                `core.memory.distributed_search` on the main store over
                (8,) positions equals the unsharded two_phase (8
                shortlist and 8 rescore launches).

Then the analysis package (analysis/, launch/dryrun.py) on the card:

 13. [contracts] the contract registry's 45 cells (analysis/registry.py:
                the reference's matrix of searches, writes and the
                episodic forward) built on CUDA tensors, each call traced
                and its 169 invariants checked; `hbm_buffer_bound` strict
                (peak device bytes); the cells must launch every kernel,
                and the `shortlist_fused` range must agree with the fused
                launches and the dispatch rule; host syncs per route
 14. [dryrun]   starcoder2-3b's [lm-train] step (B 8 x 1,024) traced on
                meta tensors: its peak and FLOPs beside the card's peak
                and step time (printed, not gated); and the production
                cell llama3-405b `train_4k` on the 256-position meta mesh
                (`launch/dryrun.run_cell`, meta tensors only), run after
                every timed phase so that its host time is in none of
                them: status, trace seconds, state a position, dominant
                term
 15. [vmem]     analysis/vmem.py's shared-memory model of the shortlist's
                select blocks against ptxas: the static shared memory must
                equal the kernels'; the plans' occupancy against the
                registers a thread (printed); the one-table select at d =
                480 must run 2 or more blocks an SM

Each path runs once with the launch counters zeroed just before it and
read just after; a kernel of the path that was not launched fails the
run. Then every kernel is held against its plain PyTorch version on the
same inputs on the card, bit for bit (the shortlist also on three
adversarial stores of the same size, of 8-bit fields at d = 48 and d =
480 (the tensor-core select): rows in descending distance, where every
row beats the running k-th key, all rows tied, and all rows masked; the
first two also of 16-bit fields at d = 48, the block-table route), the
two_phase votes of every shortlisted row are held against the full
search's votes of that row, and a small store searched on the CPU (plain
versions) is held against the same store on the card.

Times are medians of CUDA-event (kernels) or synchronised host-clock
(paths) runs after a warm-up, except the plain versions of the CUB rows
and of the episodic backward, timed by CUDA events in the one call that
checks them; each kernel row adds `device_ms`, the
kernels' own device time from torch.profiler (recording after one call
it leaves out and a pause), which leaves out the wrapper's host time between
launches; the backward's row also adds `device_ms_in_step`, its device
time in one profiled meta step. The last lines of standard output
are the card's `name, power.limit`, one JSON object with a row per
kernel, and
`{"ok": true, "device": {...}}`. Exits non-zero, printing no result, when
there is no CUDA device or the package is missing, and when any phase
fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# The kernels' operations, bytes and bounds, and the H100's rates, come
# from the package's one cost model (analysis/cost.py: kernel_cost).

# backward kernel vs autograd through the plain forward: the same terms
# summed in another order, so relative to the largest entry
EPISODE_GRAD_RTOL = 1e-4
EPISODE_GRAD_MIN_COSINE = 0.99999
# [episode]: n_way, k_shot, queries a class (B = 80, N = 200)
EPISODE_SHAPE = (20, 10, 4)
# [hat]: queries a class and Conv4 width, as launch/train.py
HAT_QUERIES, HAT_WIDTH = 4, 32
HAT_PRETRAIN_STEPS = HAT_META_STEPS = 3
# [hat]'s determinism probe: the settings it compares (CUBLAS_WORKSPACE_
# CONFIG is set for the whole process, before CUDA starts), and the runs
# of a step's gradient under each
DETERMINISM_SETTINGS = ("none", "cudnn", "torch", "trainer")
DETERMINISM_RUNS = 3

# [cub] (ResNet12 at the paper's CUB width): queries a class, the
# controller's widths, and the depth it is cut to
CUB_QUERIES = 4
CUB_WIDTHS = (64, 160, 320, 640)
CUB_PRETRAIN_STEPS = CUB_META_STEPS = 2
# [cub-serve]: queries of two_phase and ideal, and of the full search (its
# plain version holds (B, rows, 500, 24) temporaries, in row blocks)
CUB_SERVE_QUERIES, CUB_FULL_QUERIES = 256, 4
# [paper]: training steps of each run of the evaluation twin
PAPER_STEPS = 2
# [optim]: steps of each optimizer, and the agreement of the card with the
# CPU (tests/test_torch_optim.py's tolerance: of each leaf's largest entry)
OPTIM_STEPS = 5
OPTIM_RTOL = 1e-5

# a profiled training step's device time by kind of kernel, by the parts
# of their names (the first kind that matches): the episodic physics, the
# controller's convolutions and matrix products (cuDNN's implicit GEMMs,
# FFT convolutions, layout transposes; cuBLAS), and torch's elementwise
# and reduction kernels (GroupNorm, ReLU, the STE stack, AdamW)
STEP_KERNEL_KINDS = {
    "episodic": ("episode_grad", "search_dense"),
    "convolution_and_gemm": ("cudnn", "xmma", "gemm", "fft", "conv",
                             "pointwise_mult_and_sum_complex",
                             "nhwcToNchw", "nchwToNhwc"),
    "elementwise_and_reduction": ("elementwise", "reduce", "Reduce"),
}

# [routed]: logical shards of the main store (1,024 rows, 64 classes x 16
# shots, a shard) and the nprobe values run
ROUTED_SHARDS = 64
ROUTED_NPROBES = (1, 8, 32)
ROUTED_KERNEL_NPROBE = 8
# [tenants]: tenants of the stack, its padded capacity (the largest
# tenant's), the least capacity, and the server's flushes
TENANTS, TENANT_NPAD, TENANT_MIN_CAPACITY = 64, 4096, 1024
TENANT_FLUSHES = 16
# [pager]: classes (x 16 shots: 1,048,576 rows), ring batches of rows,
# shards (4,096 rows each), shards a group of related classes, device
# slots, nprobe, batches and their queries
PAGER_CLASSES, PAGER_WRITE_ROWS = 65536, 65536
PAGER_SHARDS, PAGER_GROUP = 256, 4
PAGER_SLOTS, PAGER_NPROBE, PAGER_BATCHES, PAGER_QUERIES = 16, 4, 8, 64
LEAVES = ("votes", "dist", "indices", "labels")
# [sharded]: meshes of positions on the one card ((shape, axis names, the
# store's shard axes)), the routed nprobe, the streamed write's ragged
# capacity and batches (the last wraps past the ring's end)
SHARDED_MESHES = (((8,), ("data",), ("data",)),
                  ((4, 2), ("data", "model"), ("data", "model")),
                  ((4, 2), ("data", "model"), ("data",)))
SHARDED_NPROBE = 2
SHARDED_WRITE_CAPACITY = 65500
SHARDED_WRITE_BATCHES = (30000, 30000, 20000)
# [lm-serve]: the LM serving entry point at full width. The archs (run in
# turn, the first freed before the second), whether they are cut to their
# smoke configs (a CPU rehearsal), each serve run's batch, decoded steps
# and prompt, the kNN-LM head's k, the token store's rows, the routed
# run's shards and nprobe, and the timed decode steps
LM_ARCHS = ("starcoder2-3b", "deepseek-moe-16b", "xlstm-350m", "hymba-1.5b",
            "deepseek-v3-671b", "musicgen-medium", "qwen2-vl-7b")
# archs cut in depth (layers kept): deepseek-v3's 3 dense MLA layers and
# one MLA + MoE layer, 15.1 B parameters of its 671 B
LM_DEPTH = {"deepseek-v3-671b": 4}
LM_SMOKE = False
LM_BATCH, LM_STEPS, LM_PROMPT, LM_K = 4, 16, 8, 32
LM_STORE_ROWS = 65536
LM_SHARDS, LM_NPROBE = 8, 2
LM_REPS = 10
# decode_step over the prompt against forward over it, bf16 logits at full
# width (the archs without MoE): other GEMM shapes round other bits, which
# the layers carry (the measured gaps are in PERF.md §5); a wrong cache
# slot, mask or carried state moves a logit by O(1)
LM_DECODE_ATOL = 0.25
# archs whose bf16 decode over the prompt differs from forward by O(1) in
# the reference too (ROADMAP C.R6: xLSTM's chunkwise mLSTM rounds its
# numerator to bf16 over a float32 normaliser that can be small; the step
# form keeps float32): their bf16 gap is reported, and the same check is
# held at full width in float32, to this tolerance
LM_DECODE_F32 = {"xlstm-350m": 0.05}
# a profiled decode step's device time by kind of kernel, by the parts of
# their names (the first kind that matches)
LM_KERNEL_KINDS = {
    "mcam": ("shortlist", "search_gathered", "lut_dist"),
    "gemm": ("gemm", "gemv", "nvjet", "cutlass", "xmma", "splitK",
             "dot_kernel", "cublas"),
    "softmax": ("softmax", "Softmax"),
    "elementwise_and_reduction": ("elementwise", "reduce", "Reduce",
                                  "vectorized", "CatArray", "index",
                                  "scatter", "gather", "fill", "copy"),
}
# the profiler range around layers.dot_attention in a profiled step
LM_ATTENTION_RANGE = "lm.dot_attention"

# [lm-train]: LM training through `launch/train.train` at full width, each
# arch with (layers kept or None, global batch, sequence, steps of a
# train() run), the starcoder2-3b run at microbatch LM_TRAIN_MICRO (its
# steps), and the smoke arch whose step the guard check poisons. The
# trainer's constant learning rate with no warm-up (the reference's)
# throws starcoder2-3b's loss up over its first ~5 steps at full width
# (11.55 -> 30.74 at step 4) before it falls (7.27 at step 29): the
# phase holds the mean of the last LM_TRAIN_FALL losses below the first.
# xlstm-350m runs at S = 128 (two mLSTM chunks): its sLSTM's gradients grow
# with every position (norms ~1e17 here on the card, where the float32
# norm overflows past ~1.8e19), and at S = 256 they overflow it in both
# packages (ROADMAP C.R7, tests/test_torch_train_overflow.py)
LM_TRAIN = {"starcoder2-3b": (None, 8, 1024, 30),
            "deepseek-moe-16b": (4, 8, 1024, 6),
            "xlstm-350m": (None, 8, 128, 4)}
LM_TRAIN_FALL = 5
LM_TRAIN_MICRO, LM_TRAIN_MICRO_STEPS = 4, 3
LM_TRAIN_GUARD_ARCH = "starcoder2-3b"
# a profiled train step's device time by kind (LM_KERNEL_KINDS' names;
# the attention range is forward only: autograd runs backward outside it)
LM_TRAIN_KERNEL_KINDS = {k: v for k, v in LM_KERNEL_KINDS.items()
                         if k != "mcam"}

# [lm-mesh]: starcoder2-3b's step placed on the reference test's (2, 2, 2)
# mesh at full width (B 8 x 1,024), against the unplaced step; train()
# at model_parallel 2 against 1; the HAT meta step on a (4,) data mesh;
# the pipeline over (4,) stages of starcoder2-3b's width; the memory
# shims' distributed_search on the main store over (8,)
LM_MESH_ARCH = "starcoder2-3b"
LM_MESH = ((2, 2, 2), ("pod", "data", "model"))
LM_MESH_B, LM_MESH_S, LM_MESH_STEPS = 8, 1024, 3
LM_MESH_TRAIN_STEPS = 2
# the elastic restore: starcoder2-3b at full width cut to this depth, its
# train state saved placed on LM_MESH and restored onto LM_RESTORE_MESH
# (FSDP over every position: the rules shard no tensor axis)
LM_RESTORE_LAYERS = 2
LM_RESTORE_MESH = ((8,), ("data",))
HAT_MESH = (4,)
PIPE_STAGES, PIPE_MICRO, PIPE_ROWS, PIPE_D = 4, 6, 1024, 3072
SHIM_MESH = (8,)

MIN_ACCURACY = 0.95
REPS = 5                        # timed runs per measurement (median)
# pause between a profiler session's start of recording and the first
# call it keeps (see device_ms)
PROFILER_SETTLE_S = 0.05
# the block-table entry's passes, by a part of their kernels' names
BLOCK_PASSES = ("group", "select", "merge")
# the package's profiler ranges (kernels/shortlist.FUSED_TAG,
# core/avss.LAYOUT_TAG, engine/router.ROUTER_TAG; analysis/contracts.py
# reads them): a range has a device-side twin in a profile, which the
# kernels' device times leave out
RANGE_TAGS = ("shortlist_fused", "layout_support", "router_sketch")
# [dryrun]: [lm-train]'s first model and batch, traced on meta tensors,
# and the production cell run on the meta mesh of its 256 positions
DRYRUN_TRAIN = ("starcoder2-3b", 8, 1024)
DRYRUN_CELL = ("llama3-405b", "train_4k", False)


def fail(msg: str) -> None:
    raise AssertionError(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sass_count(lib: Path, opcode: str, function: str = "",
               without: str = "\0") -> int | None:
    """Instructions of `opcode` in a built library's SASS (cuobjdump), in
    the functions whose mangled name holds `function` and not `without`,
    or None where the toolkit has no cuobjdump."""
    tool = Path("/usr/local/cuda/bin/cuobjdump")
    if not tool.exists():
        return None
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    count, inside = 0, not function
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            inside = function in m.group(1) and without not in m.group(1)
        elif inside:
            count += opcode in line
    return count


def kernel_resources(nvcc_log: str) -> dict[str, str]:
    """Registers, shared memory and spills of each kernel entry in an nvcc
    -Xptxas -v log, by a short name (`search_dense<24>`)."""
    out, name = {}, None
    for line in nvcc_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            base = re.search(r"(search_dense|search_gathered|prove_forms|"
                             r"episode_grad_sum|episode_grad)"
                             r"((?:I(?:L[ib]\d+E)+E)?)",
                             mangled)
            args = re.findall(r"L[ib](\d+)E", base.group(2)) if base else []
            name = mangled if base is None else base.group(1) + (
                f"<{','.join(args)}>" if args else "")
            out[name] = ""
        elif name is not None and ("registers" in line or "spill" in line):
            part = line.split(":", 1)[-1].strip()
            out[name] = f"{out[name]}; {part}" if out[name] else part
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--capacity", type=int, default=65536,
                   help="store rows (classes x 16 shots)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        return run(args, torch)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1


def timers(torch) -> argparse.Namespace:
    """The card's clocks: CUDA-event, synchronised host-clock and
    torch.profiler device times of a call (medians of REPS runs after a
    warm-up), with the device and a log line."""
    dev = torch.device("cuda")

    def log(msg: str) -> None:
        print(msg, flush=True)

    def sync() -> None:
        torch.cuda.synchronize()

    def host_ms(fn, reps=REPS) -> float:
        fn()
        sync()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def event_ms(fn, reps=REPS) -> float:
        fn()
        sync()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def timed(fn):
        """One call of fn and its time by CUDA events -> (result, ms): for
        plain versions too slow to run more than the once the comparison
        needs."""
        sync()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        return out, a.elapsed_time(b)

    def device_ms(fn, part, reps=REPS, sessions=3, passes=None):
        """Device time per call of the kernels whose name holds `part`
        (torch.profiler's CUDA activity). Unlike event_ms it leaves out the
        host's time between launches. A profiler session can miss the
        first kernel launched after it starts recording, and would then
        read low, so each session records only after one warm-up call and
        a pause (PROFILER_SETTLE_S), and one that saw a kernel a number of
        times that is not a multiple of `reps` is dropped and taken again,
        up to `sessions` times; None where no session saw every call (or
        none saw such a kernel), rather than a low time. With `passes`
        (parts of kernel names): a dict of the time of each pass (a kernel
        counts under the first pass its name holds) and their "total"."""
        fn()
        sync()
        prof = torch.profiler
        for _ in range(sessions):
            with prof.profile(activities=[prof.ProfilerActivity.CUDA],
                              schedule=prof.schedule(wait=0, warmup=1,
                                                     active=reps,
                                                     repeat=1)) as p:
                for i in range(1 + reps):
                    if i == 1:
                        time.sleep(PROFILER_SETTLE_S)
                    fn()
                    sync()
                    p.step()
            seen = [e for e in p.key_averages()
                    if part in e.key and e.key not in RANGE_TAGS]
            if seen and not any(e.count % reps for e in seen):
                if passes is None:
                    return sum(e.device_time_total for e in seen) / reps / 1e3
                split = {ps: 0.0 for ps in passes}
                for e in seen:
                    ps = next((x for x in passes if x in e.key), None)
                    if ps is None:
                        fail(f"[device_ms] {e.key[:60]} is in no pass of "
                             f"{passes}")
                    split[ps] += e.device_time_total / reps / 1e3
                return {**split, "total": sum(split.values())}
            log(f"[device_ms] {part}: the profiler saw "
                f"{[(e.key[:60], e.count) for e in seen]} in {reps} calls")
        return None

    return argparse.Namespace(torch=torch, dev=dev, log=log, sync=sync,
                              host_ms=host_ms, event_ms=event_ms,
                              timed=timed, device_ms=device_ms)


def run(args, torch) -> int:
    import numpy as np

    from repro_torch.analysis.cost import kernel_cost
    from repro_torch.core import avss as avss_lib
    from repro_torch.core.avss import SearchConfig
    from repro_torch.core.memory import MemoryConfig
    from repro_torch.engine import MemoryStore, RetrievalEngine, SearchRequest
    from repro_torch.kernels import _build, mcam_dist, mcam_search, ops
    from repro_torch.kernels import shortlist
    from repro_torch.launch import train as train_lib

    # the trainer's cuBLAS setting (make_deterministic, which [episode] and
    # [hat] run under) is read at the first cuBLAS handle: set it before
    # any CUDA work; the serving phases run as a server runs them
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG",
                          train_lib.CUBLAS_WORKSPACE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()

    timing = timers(torch)
    dev, log, sync = timing.dev, timing.log, timing.sync
    host_ms, event_ms = timing.host_ms, timing.event_ms
    timed, device_ms = timing.timed, timing.device_ms

    # -- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"[build] {len(logs)} kernel libraries built in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        print(f"--- nvcc {name}.cu ---\n{text}", file=sys.stderr)
        for line in _build.ptxas_report(text):
            log(f"[ptxas {name}] {line}")
    hgmma = sass_count(_build.library_path("mcam_dist"), "HGMMA")
    log(f"[sass] mcam_dist: {hgmma} HGMMA instructions")
    imma = {name: sass_count(_build.library_path("shortlist"), "IMMA", fn,
                             without)
            for name, fn, without in (
                ("one-table select", "shortlist_select", "blocks"),
                ("block-table select", "shortlist_blocks_select", "\0"))}
    log(f"[sass] shortlist IMMA (mma.sync) instructions: {imma}")
    gmma = sass_count(_build.library_path("shortlist"), "GMMA",
                      "shortlist_wgmma")
    log(f"[sass] shortlist wgmma select: {gmma} GMMA instructions")
    if imma["one-table select"] == 0 or gmma == 0:
        fail("[sass] a one-table select runs no tensor-core instruction")
    resources = {}
    for src in ("mcam_search", "mcam_episode"):
        found = kernel_resources(logs.get(src, ""))
        resources.update(found)
        for entry, res in found.items():
            log(f"[resources {src}] {entry}: {res}")

    kernels = []
    launches = {k: 0 for k in _build.LAUNCHES}

    def row(name, source, replaces, err, ms, plain_ms, cost, library_ms,
            **extra):
        """A kernel row; `cost` is kernel_cost(...) at this run's inputs."""
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": cost["bound_ms"], "bound_by": cost["bound_by"],
            "library_ms": library_ms, "ops": cost["ops"],
            "bytes": cost["bytes"], **extra})
        log(f"[kernel] {name}: {ms:.4f} ms (plain {plain_ms:.3f} ms, "
            f"library {library_ms}, bound {cost['bound_ms']:.6f} ms by "
            f"{cost['bound_by']}), max_abs_err {err}")

    timing.row = row

    # -- the physics kernel's cheaper forms, on every hash word --------------
    t0 = time.perf_counter()
    forms = mcam_search.prove_forms(dev)
    sync()
    log(f"[prove] mcam_search forms over all 2**32 words in "
        f"{time.perf_counter() - t0:.2f} s: words that differ {forms}")
    if any(forms.values()):
        fail(f"mcam_search: a cheaper form differs from the plain "
             f"arithmetic: {forms}")

    # -- data ----------------------------------------------------------------
    shots, d, cl = 16, 48, 32
    n = args.capacity
    classes = n // shots
    rng, labels_np, support_np, qcls, queries_np = clustered(
        args.seed, n, d, 256)
    support = torch.from_numpy(support_np).to(dev)
    labels = torch.from_numpy(labels_np).to(dev)
    queries = torch.from_numpy(queries_np).to(dev)
    qcls_t = torch.from_numpy(qcls.astype(np.int64)).to(dev)
    cfg = MemoryConfig(capacity=n, dim=d,
                       search=SearchConfig("mtmc", cl=cl, mode="avss"))
    engine = RetrievalEngine(cfg.search)
    log(f"[config] d={d} mtmc cl={cl} levels={cfg.search.enc.levels} "
        f"capacity={n} ({classes} classes x {shots} shots) B=256 k=64")

    # -- 1. program ----------------------------------------------------------
    def program():
        return MemoryStore.create(cfg).calibrate(support).write(support,
                                                                labels)
    program_ms = host_ms(program, reps=3)
    store = program()
    sync()
    if store.device.type != dev.type:
        fail(f"store on {store.device}, expected the card")
    if store.pack_bits != 8 or store.proj_packed.shape != (n, 48):
        fail(f"pack_bits {store.pack_bits}, packed "
             f"{tuple(store.proj_packed.shape)}")
    mb = sum(getattr(store, f).numel() * getattr(store, f).element_size()
             for f in ("values", "proj", "proj_packed", "s_grid")) / 1e6
    log(f"[program] {program_ms:.2f} ms, store {mb:.1f} MB on the card")

    # -- 2-5. the main path, with launch counts ----------------------------
    q16 = queries[:16]
    paths = {
        "two_phase": (queries, SearchRequest(mode="two_phase", k=64),
                      ("shortlist", "mcam_rescore")),
        "ideal": (queries, SearchRequest(mode="ideal", k=64),
                  ("shortlist",)),
        "two_phase_mxu": (queries, SearchRequest(
            mode="two_phase", k=64, backend="mxu", fused_min_rows=n + 1),
            ("mcam_dist", "mcam_rescore")),
        "full": (q16, SearchRequest(mode="full"), ("mcam_search",)),
    }
    results, path_ms = {}, {}
    for name, (qs, req, needs) in paths.items():
        _build.reset_launches()
        res = engine.search(store, qs, req)
        sync()
        counts = dict(_build.LAUNCHES)
        for kname in needs:
            if counts[kname] < 1:
                fail(f"path {name} did not launch kernel {kname}: {counts}")
        for kname, c in counts.items():
            launches[kname] += c
        for f in ("votes", "dist"):
            t = getattr(res, f)
            if not torch.isfinite(t).all():
                fail(f"path {name}: non-finite {f}")
        results[name] = res
        path_ms[name] = host_ms(lambda: engine.search(store, qs, req))
        log(f"[{name}] {path_ms[name]:.3f} ms, launches "
            f"{ {k: v for k, v in counts.items() if v} }")

    tp, ideal, tpm, full = (results[k] for k in
                            ("two_phase", "ideal", "two_phase_mxu", "full"))
    if tp.votes.shape != (256, 64) or full.votes.shape != (16, n):
        fail(f"shapes {tuple(tp.votes.shape)}, {tuple(full.votes.shape)}")
    acc = float((tp.predict() == qcls_t).float().mean())
    acc_ideal = float((ideal.predict() == qcls_t).float().mean())
    acc_full = float((full.predict() == qcls_t[:16]).float().mean())
    log(f"[accuracy] top-1 two_phase {acc:.4f}  ideal {acc_ideal:.4f}  "
        f"full(16) {acc_full:.4f}")
    if acc < MIN_ACCURACY:
        fail(f"two_phase top-1 accuracy {acc} < {MIN_ACCURACY}")
    # every route ranks the same shortlist and votes the same rows
    for name, other in (("ideal", ideal), ("two_phase_mxu", tpm)):
        if not (torch.equal(other.indices, tp.indices)
                and torch.equal(other.dist, tp.dist)):
            fail(f"{name} shortlist differs from the fused two_phase one")
    if not torch.equal(tpm.votes, tp.votes):
        fail("two_phase votes differ between the fused and mxu routes")
    # contract: two_phase votes of every shortlisted row == full votes
    tp16 = engine.search(store, q16, SearchRequest(mode="two_phase", k=64))
    sync()
    full_at = torch.take_along_dim(full.votes, tp16.indices, dim=1)
    if not torch.equal(full_at, tp16.votes):
        bad = int((full_at != tp16.votes).sum())
        fail(f"two_phase votes differ from full votes on {bad} rows")
    log("[contract] two_phase votes == full votes on all 16 x 64 "
        "shortlisted rows")

    # -- shortlist kernel vs plain -------------------------------------------
    qw = store.quantize_queries(queries)
    valid = store.valid
    packed = store.proj_packed

    def sl_kernel():
        return shortlist.lut_shortlist(qw, None, 64, valid=valid,
                                       packed=packed, pack_bits=8)

    def sl_plain():
        return shortlist.lut_shortlist_plain(qw, None, 64, valid=valid,
                                             packed=packed, pack_bits=8)
    kd, ki = sl_kernel()
    sync()
    pd, pi = sl_plain()
    sync()
    err = max(float((kd - pd).abs().max()), float((ki - pi).abs().max()))
    # the other operand forms, a masked store, the largest and odd k
    mask = torch.from_numpy(rng.random(n) > 0.25).to(dev)
    for kk in (1, 7, 1024):
        for kw in ({"packed": packed, "pack_bits": 8},
                   {"s_proj": store.proj},
                   {"s_proj": store.proj.float()}):
            sp = kw.get("s_proj")
            extra = {k: v for k, v in kw.items() if k != "s_proj"}
            a = shortlist.lut_shortlist(qw, sp, kk, valid=mask, **extra)
            sync()
            b = shortlist.lut_shortlist_plain(qw, sp, kk, valid=mask,
                                              **extra)
            sync()
            if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
                fail(f"shortlist kernel != plain (k={kk}, "
                     f"{'packed' if sp is None else sp.dtype})")
    if err != 0:
        fail(f"shortlist kernel differs from plain by {err}")
    q1h_f = ops.query_onehot(qw, torch.float32)
    proj_f = store.proj.float()
    pen = torch.where(valid, 0.0, shortlist.SHORTLIST_MASK_PENALTY)[None]

    def sl_library():
        dist = torch.matmul(q1h_f, proj_f.T) + pen
        return torch.sort(dist, dim=1, stable=True)[0][:, :64]

    # adversarial stores at the same N and queries, bit for bit: 8-bit
    # fields (the tensor-core select) and 16-bit fields (the block-table
    # route), descending, all tied and all masked
    adv8 = adversarial_stores(timing, shortlist, qw, valid, packed, d,
                              "[shortlist]")
    per_row16 = torch.arange(n - 1, -1, -1, device=dev) * 3
    adv16 = adversarial_stores(timing, shortlist, qw, valid, None, d,
                               "[shortlist 16-bit]", bits=16, stores={
                                   "descending": per_row16,
                                   "ties": torch.full_like(per_row16,
                                                           5 * d)})
    plan = shortlist.shortlist_plan(256, n, packed.shape[1], 64)
    row("shortlist", "shortlist.cu", "src/repro/kernels/shortlist.py:210",
        err, event_ms(sl_kernel), event_ms(sl_plain),
        kernel_cost("shortlist", b=256, n=n, d=d, k=64,
                    row_words=packed.shape[1], bits=8),
        event_ms(sl_library), device_ms=device_ms(sl_kernel, "shortlist_"),
        plan=plan_fields(plan), **adv8,
        **{f"bits16_{k_}": v for k_, v in adv16.items()},
        shape=f"B=256 N={n} d={d} packed 8-bit k=64")

    # -- LUT product kernel vs plain -----------------------------------------
    q1h = ops.query_onehot(qw, torch.bfloat16)
    proj = store.proj
    md_k = mcam_dist.lut_dist_matmul(q1h, proj)
    sync()
    md_p = mcam_dist.lut_dist_matmul_plain(q1h, proj)
    sync()
    err = float((md_k - md_p).abs().max())
    if err != 0:
        fail(f"mcam_dist kernel differs from plain by {err}")
    odd = mcam_dist.lut_dist_matmul(q1h[:37, :190].contiguous(),
                                    proj[:1001, :190].contiguous())
    sync()
    if not torch.equal(odd, mcam_dist.lut_dist_matmul_plain(
            q1h[:37, :190], proj[:1001, :190])):
        fail("mcam_dist kernel != plain on ragged B/N/K")
    del md_k, md_p
    row("mcam_dist", "mcam_dist.cu", "src/repro/kernels/mcam_dist.py:32",
        err, event_ms(lambda: mcam_dist.lut_dist_matmul(q1h, proj)),
        event_ms(lambda: mcam_dist.lut_dist_matmul_plain(q1h, proj), reps=3),
        kernel_cost("mcam_dist", b=256, n=n, k=4 * d),
        event_ms(lambda: torch.matmul(q1h_f, proj_f.T)),
        device_ms=device_ms(lambda: mcam_dist.lut_dist_matmul(q1h, proj),
                            "lut_dist_"),
        shape=f"(256 x {4 * d}) x ({n} x {4 * d})^T bf16 -> f32")

    # -- physics kernels vs plain --------------------------------------------
    cs = cfg.search
    qs = ops.flatten_strings(ops.broadcast_query(avss_lib.layout_query(
        store.quantize_queries(q16), cs.enc, "avss"), cs.enc.length)).to(
            torch.int8).contiguous()
    ss = ops.flatten_strings(store.s_grid)
    S, sl = ss.shape[1], ss.shape[2]
    w = cs.enc.weights_array(device=dev).repeat(2)
    th = torch.as_tensor(cs.mcam.thresholds(), device=dev)

    def ms_kernel():
        return mcam_search.mcam_search(qs, ss, w, th, cs.mcam)

    def ms_plain():
        return mcam_search.mcam_search_plain(qs, ss, w, th, cs.mcam)
    kv, kdist = ms_kernel()
    sync()
    pv, pdist = ms_plain()
    sync()
    dist_err = float((kdist - pdist).abs().max())
    agree = float((kv == pv).float().mean())
    err = max(dist_err, float((kv - pv).abs().max()))
    log(f"[mcam_search] dist max err {dist_err}, vote agreement {agree:.7f}"
        f" over {kv.numel()} pairs (instance "
        f"{mcam_search.search_instance(sl, qs, ss)})")
    if not (torch.equal(kv, pv) and torch.equal(kdist, pdist)):
        fail(f"mcam_search kernel != plain: dist err {dist_err}, vote "
             f"agreement {agree}")
    if not torch.equal(kv, full.votes) or not torch.equal(kdist, full.dist):
        fail("mcam_search kernel != the full search's result")
    row("mcam_search", "mcam_search.cu",
        "src/repro/kernels/mcam_search.py:37", err, event_ms(ms_kernel),
        event_ms(ms_plain, reps=3),
        kernel_cost("mcam_search", b=16, n=n, s=S, sl=sl), None,
        vote_agreement=agree, device_ms=device_ms(ms_kernel, "search_dense"),
        resources=resources.get("search_dense<24,0>"),
        shape=f"B=16 N={n} S={S} sl={sl} noisy")

    qs256 = ops.flatten_strings(ops.broadcast_query(avss_lib.layout_query(
        qw, cs.enc, "avss"), cs.enc.length)).to(torch.int8).contiguous()
    rows = tp.indices

    def rs_kernel():
        return mcam_search.mcam_rescore(qs256, ss, rows, w, th, cs.mcam)

    def rs_plain():
        return mcam_search.mcam_rescore_plain(qs256, ss, rows, w, th,
                                              cs.mcam)
    rk = rs_kernel()
    sync()
    rp = rs_plain()
    sync()
    agree_r = float((rk == rp).float().mean())
    err = float((rk - rp).abs().max())
    log(f"[mcam_rescore] vote agreement {agree_r:.7f} over {rk.numel()} "
        f"pairs")
    if not torch.equal(rk, rp):
        fail(f"mcam_rescore kernel != plain: vote agreement {agree_r}")
    if not torch.equal(rk, tp.votes):
        fail("mcam_rescore kernel != the two_phase search's votes")
    uniq = int(torch.unique(rows).numel())
    row("mcam_rescore", "mcam_search.cu",
        "src/repro/kernels/mcam_search.py:37", err, event_ms(rs_kernel),
        event_ms(rs_plain, reps=3),
        kernel_cost("mcam_rescore", b=256, k=64, s=S, sl=sl, uniq=uniq),
        None,
        vote_agreement=agree_r, also_replaces="src/repro/kernels/ops.py:186",
        device_ms=device_ms(rs_kernel, "search_gathered"),
        resources=resources.get("search_gathered<24>"),
        shape=f"B=256 k=64 S={S} sl={sl} noisy, {uniq} distinct rows")

    # -- routed search over the main store's logical shards ----------------
    routed = run_routed(timing, store, queries, qcls_t,
                        {"two_phase": tp, "ideal": ideal}, launches,
                        full16=(q16, full))
    path_ms.update(routed.pop("phases_ms"))

    # -- the store row-sharded over meshes of positions on the card ----------
    sharded = run_sharded(timing, store, support, labels, queries,
                          {"two_phase": tp, "ideal": ideal}, (q16, full),
                          launches)
    path_ms.update(sharded.pop("phases_ms"))
    torch.cuda.empty_cache()

    # -- the card against the CPU (plain versions) on a small store ----------
    m = 1024
    small_cfg = MemoryConfig(capacity=m, dim=d, search=cfg.search)
    cpu = MemoryStore.create(small_cfg, device="cpu").calibrate(
        support_np[:m]).write(support_np[:m], labels_np[:m])
    gpu = MemoryStore.from_numpy(cpu.to_numpy(), small_cfg)
    for req in (SearchRequest(mode="two_phase", k=64),
                SearchRequest(mode="two_phase", k=64, fused_min_rows=1),
                SearchRequest(mode="ideal", k=64),
                SearchRequest(mode="full")):
        a = engine.search(gpu, queries_np[:16], req)
        b = engine.search(cpu, queries_np[:16], req)
        sync()
        same = all(torch.equal(getattr(a, f).cpu(), getattr(b, f))
                   for f in ("dist", "indices", "labels"))
        vag = float((a.votes.cpu() == b.votes).float().mean())
        log(f"[cpu-vs-card] {req.mode} fused_min_rows={req.fused_min_rows}:"
            f" ranks equal {same}, vote agreement {vag:.5f}")
        if not same or vag < 0.99:
            fail(f"card vs CPU on a {m}-row store: {req}")

    # -- the serving path at the paper's CUB geometry ------------------------
    cub_serve = run_cub_serve(timing, args, launches)
    path_ms.update(cub_serve.pop("phases_ms"))
    torch.cuda.empty_cache()

    # -- many tenants in one batch; a store in host memory -------------------
    tenants = run_tenants(timing, args, launches)
    path_ms.update(tenants.pop("phases_ms"))
    torch.cuda.empty_cache()
    pager = run_pager(timing, args, launches)
    path_ms.update(pager.pop("phases_ms"))
    torch.cuda.empty_cache()

    # -- the LM serving entry point at full width ----------------------------
    lm_serve = run_lm_serve(timing, args, launches, card)
    path_ms.update(lm_serve.pop("phases_ms"))
    torch.cuda.empty_cache()

    # -- hardware-aware training ---------------------------------------------
    train_lib.make_deterministic()
    episode = run_episode(timing, args.seed)
    hat = run_hat(timing, args, launches)
    path_ms.update(hat.pop("phases_ms"))
    hat_episode = hat.pop("episode_arrays")
    torch.cuda.empty_cache()
    cub = run_cub(timing, args, launches)
    path_ms.update(cub.pop("phases_ms"))
    torch.cuda.empty_cache()

    # -- the paper's evaluation, and the other optimizers --------------------
    paper = run_paper(timing, launches)
    path_ms.update(paper.pop("phases_ms"))
    optim = run_optim(timing, args)
    torch.cuda.empty_cache()

    # -- LM training at full width -------------------------------------------
    lm_train = run_lm_train(timing, args, card)
    path_ms.update(lm_train.pop("phases_ms"))
    torch.cuda.empty_cache()

    # -- the LM's sharding layer on meshes of positions ----------------------
    lm_mesh = run_lm_mesh(timing, args, card, store, queries, hat_episode,
                          launches)
    path_ms.update(lm_mesh.pop("phases_ms"))
    torch.cuda.empty_cache()

    # -- the analysis package on the card: contracts, dry run, vmem ----------
    # (the dry run's traces come after every timed phase: their minutes of
    # host work on meta tensors overlap none of the times above)
    contracts = run_contracts(timing, launches)
    path_ms.update(contracts.pop("phases_ms"))
    dryrun = run_dryrun(timing, lm_train, card)
    path_ms.update(dryrun.pop("phases_ms"))
    vmem = run_vmem(timing, logs.get("shortlist", ""), n)
    bwd = hat["backward"]
    row("mcam_episode", "mcam_episode.cu",
        "src/repro/engine/engine.py:457 (no Pallas kernel: jax.grad of jnp)",
        bwd["max_abs_err"], bwd["ms"], bwd["plain_ms"], bwd["cost"], None,
        device_ms=bwd["device_ms"],
        device_ms_in_step=bwd["device_ms_in_step"],
        max_rel_err=bwd["max_rel_err"],
        cosine=bwd["cosine"], episode=episode,
        resources=resources.get("episode_grad<24,1,1>"),
        resources_sum=resources.get("episode_grad_sum"),
        shape=bwd["shape"])

    for r in kernels:       # with the later paths' launches
        r["launches"] = launches[r["name"]]
    log(json.dumps({"phases_ms": {"program": program_ms, **path_ms},
                    "accuracy_two_phase": acc, "routed": routed,
                    "sharded": sharded,
                    "tenants": tenants, "pager": pager,
                    "lm_serve": lm_serve, "hat": hat,
                    "cub_serve": cub_serve, "cub": cub, "paper": paper,
                    "optim": optim, "lm_train": lm_train,
                    "lm_mesh": lm_mesh, "contracts": contracts,
                    "dryrun": dryrun, "vmem": vmem, "card": card}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run_contracts(t, launches: dict) -> dict:
    """[contracts]: the port's contract registry (analysis/registry.py)
    on CUDA tensors: every cell built on the card, its call traced and
    every invariant checked; `hbm_buffer_bound` is strict here (peak
    device bytes over the call, `torch.cuda.max_memory_allocated`). The
    cells must launch every hand-written kernel, and each cell's
    `shortlist_fused` range must agree with the fused kernels' launches
    (`_build.LAUNCHES`) as with the dispatch rule."""
    torch = t.torch
    from repro_torch.analysis import registry
    from repro_torch.kernels import _build
    _build.reset_launches()
    arts: dict = {}
    t0 = time.perf_counter()
    report = registry.run_cells(device=t.dev, artifacts=arts)
    t.sync()
    secs = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    for kname, c in counts.items():
        launches[kname] += c
    bad = [r for r in report["cells"] if r["status"] != "pass"]
    if bad:
        fail(f"[contracts] {len(bad)} invariant(s) broken on the card: "
             + "; ".join(f"{r['entry']} {json.dumps(r['config'])} "
                         f"[{r['invariant']}] {r['detail']}"
                         for r in bad[:6]))
    missing = [k for k, c in counts.items()
               if c < 1 and k not in _build.SELECT_PATHS]
    if missing:
        fail(f"[contracts] the cells launched no {missing}: {counts}")
    disagree = []
    for key, art in arts.items():
        if "expect_fused" in art:
            fused = sum(art["trace"]["launch_counter"].get(k, 0)
                        for k in ("shortlist", "shortlist_blocks"))
            if (fused > 0) != art["expect_fused"]:
                disagree.append(key)
    if disagree:
        fail(f"[contracts] fused launches disagree with the dispatch rule: "
             f"{disagree[:4]}")
    hbm = [r["hbm"] for r in report["cells"]
           if r["invariant"] == "hbm_buffer_bound"]
    syncs = {key: art["trace"]["host_syncs"] for key, art in arts.items()
             if "trace" in art and art["trace"]["host_syncs"]}
    s = report["summary"]
    t.log(f"[contracts] {s['pass']} invariants pass over {len(arts)} cells "
          f"on the card in {secs:.1f} s, launches {counts}; fused range == "
          f"fused launches == dispatch rule in "
          f"{sum('expect_fused' in a for a in arts.values())} cells; "
          f"hbm peak / bound {[(h['measured_bytes'], h['bound_bytes']) for h in hbm]}"
          f" (strict); host syncs by cell {syncs}")
    return {"summary": s, "cells": len(arts), "launches": counts,
            "hbm": hbm, "host_syncs": syncs,
            "phases_ms": {"contracts": secs * 1e3}}


def run_dryrun(t, lm_train: dict, card: str) -> dict:
    """[dryrun]: analysis/cost.py's trace of [lm-train]'s first model's
    step (DRYRUN_TRAIN, unplaced) on meta tensors, its peak and FLOPs
    printed beside the card's peak memory and step time from [lm-train]
    (not gated); then the record of DRYRUN_CELL on the meta mesh of the
    production shape (256 positions), `launch/dryrun.run_cell` as the dry
    run's command line calls it: status, seconds, the state a position
    holds, the dominant roofline term."""
    torch = t.torch
    from repro_torch.analysis import cost as cost_lib
    from repro_torch.configs import load_config
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import transformer as tfm
    arch, B, S = DRYRUN_TRAIN
    shape = ShapeConfig("custom", S, B, "train")
    cfg = steps_lib.adapt_config(load_config(arch), shape, 1)
    mb = steps_lib.microbatch_for(cfg, shape)
    step, optimizer = steps_lib.make_train_step(
        cfg, TrainConfig(learning_rate=3e-4))
    params = tfm.abstract_params(cfg)
    state = optimizer.init(params)
    batch = {k: torch.zeros((B // mb, mb, S), dtype=torch.int32,
                            device="meta") for k in ("tokens", "labels")}
    t0 = time.perf_counter()
    rec = cost_lib.traced_cost(step, params, state, batch)
    trace_s = time.perf_counter() - t0
    measured = lm_train.get(arch, {})
    peak, step_ms = measured.get("peak_memory_bytes"), measured.get(
        "step_ms")
    rate = rec["flops"] / step_ms / 1e9 if step_ms else None
    t.log(f"[dryrun] {arch} B {B} x {S} step traced on meta in "
          f"{trace_s:.1f} s: peak {rec['peak_bytes'] / 1e9:.2f} GB "
          f"(state {rec['argument_bytes'] / 1e9:.2f} + temp "
          f"{rec['temp_bytes'] / 1e9:.2f}) against the card's "
          f"{peak and round(peak / 1e9, 2)} GB in [lm-train]; "
          f"{rec['flops'] / 1e12:.2f} TFLOP counted, "
          f"{rate and round(rate, 1)} TFLOP/s at the card's {step_ms} ms a "
          f"step; {sum(rec['op_census'].values())} ops, host syncs "
          f"{rec['host_syncs']} ({card})")
    from repro_torch.launch import dryrun as dryrun_lib
    arch2, shape2, multi = DRYRUN_CELL
    t0 = time.perf_counter()
    cell = dryrun_lib.run_cell(arch2, shape2, multi)
    cell_s = time.perf_counter() - t0
    if cell["status"] != "ok":
        fail(f"[dryrun] {arch2} {shape2}: {cell}")
    t.log(f"[dryrun] {arch2} {shape2} on the {cell['mesh']} meta mesh "
          f"({cell['chips']} positions): {cell['status']}, traced in "
          f"{cell['compile_s']} s ({cell_s:.1f} s with the set-up);"
          f" state a position {cell['state_bytes_per_device'] / 1e9:.3f} GB;"
          f" FLOPs {cell['flops_total']:.4g} ({cell['flops_per_device']:.4g}"
          f" a position, useful ratio {cell['useful_flops_ratio']:.3f}); "
          f"collective bytes {cell['collective_bytes_per_device']:.4g}; "
          f"dominant {cell['roofline']['dominant']} "
          f"({cell['roofline']['bound_s']:.4g} s); host syncs "
          f"{cell['host_syncs']}")
    return {"train_trace": {
                "arch": arch, "batch": B, "seq": S, "seconds": trace_s,
                "flops": rec["flops"], "peak_bytes": rec["peak_bytes"],
                "temp_bytes": rec["temp_bytes"],
                "argument_bytes": rec["argument_bytes"],
                "hbm_bytes": rec["hbm_bytes_read"]
                + rec["hbm_bytes_written"], "host_syncs": rec["host_syncs"],
                "card_peak_bytes": peak, "card_step_ms": step_ms},
            "cell": cell, "cell_seconds": cell_s,
            "phases_ms": {"dryrun_trace": trace_s * 1e3,
                          "dryrun_cell": cell_s * 1e3}}


def ptxas_entries(nvcc_log: str) -> dict[str, tuple[int, int]]:
    """(registers, static shared bytes) of each kernel entry in an nvcc
    -Xptxas -v log, by its mangled name."""
    out, name = {}, None
    for line in nvcc_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            smem = re.search(r"(\d+) bytes smem", line)
            out[name] = (int(m.group(1)), int(smem.group(1)) if smem else 0)
            name = None
    return out


def run_vmem(t, nvcc_log: str, n: int) -> dict:
    """[vmem]: analysis/vmem.py's model of the shortlist's select blocks
    against ptxas: its static shared memory must equal the kernel's, and
    the plans' occupancy is checked against the registers ptxas gives a
    thread (printed, not gated), for the main path's and CUB's (the wgmma
    select), k = 1,024's (the mma.sync select) and the block-table rows'
    plans. The wgmma select's block must fit one SM by shared memory and
    by registers."""
    from repro_torch.analysis import vmem
    entries = ptxas_entries(nvcc_log)
    if not entries:
        t.log("[vmem] no nvcc log of csrc/shortlist.cu in this run (its "
              "library was built before): nothing to hold the model "
              "against")
        return {"rows": []}
    select = [(k, v) for k, v in entries.items()
              if "shortlist_select" in k and "blocks" not in k]
    wgmma = [(k, v) for k, v in entries.items() if "shortlist_wgmma" in k]
    blocks = [(k, v) for k, v in entries.items()
              if "shortlist_blocks_select" in k]
    if not select or not wgmma or not blocks:
        fail(f"[vmem] no select entries in the ptxas log: {list(entries)}")
    rows = []
    for name, est, found in (
            ("select", vmem.shortlist_smem(256, n, 48, 64), wgmma),
            ("select_cub", vmem.shortlist_smem(CUB_SERVE_QUERIES, n, 480,
                                               64), wgmma),
            ("select_k1024", vmem.shortlist_smem(256, n, 48, 1024), select),
            ("blocks", vmem.blocks_smem(256, ROUTED_KERNEL_NPROBE,
                                        ROUTED_SHARDS, n // ROUTED_SHARDS,
                                        48, 64, True), blocks),
            ("blocks_cub", vmem.blocks_smem(
                256, ROUTED_KERNEL_NPROBE, ROUTED_SHARDS,
                n // ROUTED_SHARDS, 480, 64, True), blocks)):
        for entry, (regs, smem) in found:
            check = vmem.validate_config(est, regs_per_thread=regs)
            row = {"plan": name, "entry": entry,
                   "model_static_bytes": est.static_bytes,
                   "ptxas_static_bytes": smem, "registers": regs,
                   "dynamic_bytes": est.dynamic_bytes,
                   "ctas_per_sm": est.ctas_per_sm, "threads": est.threads,
                   "fits": check.ok, "reason": check.reason}
            rows.append(row)
            t.log(f"[vmem] {name} {entry}: static smem model "
                  f"{est.static_bytes} B, "
                  f"ptxas {smem} B; dynamic {est.dynamic_bytes} B; "
                  f"{est.ctas_per_sm} blocks an SM x {est.threads} threads "
                  f"x {regs} registers = "
                  f"{est.ctas_per_sm * est.threads * regs} of "
                  f"{vmem.H100_SM_REGS}; fits {check.ok} {check.reason}")
            if est.static_bytes != smem:
                fail(f"[vmem] {name}: the model's static shared memory "
                     f"{est.static_bytes} B != ptxas's {smem} B")
            by_regs = vmem.H100_SM_REGS // (est.threads * regs)
            row["ctas_by_registers"] = by_regs
            if name in ("select", "select_cub") and \
                    min(est.ctas_per_sm, by_regs) < 1:
                fail(f"[vmem] the wgmma select ({name}) fits no SM "
                     f"(shared memory {est.ctas_per_sm}, registers "
                     f"{by_regs})")
    return {"rows": rows}


def clustered(seed: int, n: int, d: int, nq: int, shots: int = 16):
    """A serving store's data: n // shots classes of `shots` supports
    around random centres (scale 2, spread 0.3) and nq queries of random
    classes -> (the generator, labels, supports, query classes, queries)."""
    import numpy as np
    classes = n // shots
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((classes, d), dtype=np.float32) * 2.0
    labels = np.repeat(np.arange(classes, dtype=np.int32), shots)
    support = centres[labels] + 0.3 * rng.standard_normal(
        (n, d), dtype=np.float32)
    qcls = rng.choice(classes, size=nq, replace=classes < nq)
    queries = centres[qcls] + 0.3 * rng.standard_normal(
        (nq, d), dtype=np.float32)
    return rng, labels, support, qcls, queries


def _count(launches: dict, counts: dict, suffix: str = "") -> None:
    for kname, c in counts.items():
        launches[kname + suffix] = launches.get(kname + suffix, 0) + c


def run_cub_serve(t, args, launches: dict) -> dict:
    """[cub-serve]: the serving path at the paper's CUB geometry (d = 480,
    MTMC CL = 25: 20 segments x 25 words = 500 strings of 24 cells a
    support, 480-word packed rows of 8-bit fields, a 1,920-deep LUT
    product), on a store of `--capacity` supports (4,096 classes x 16
    shots), clustered data as the Omniglot serving store. Each path runs
    with the launch counts zeroed just before it and read just after
    (counted under `<kernel>_cub`); each kernel is then held against its
    plain version on the path's inputs, bit for bit, and adds a row to the
    kernels line."""
    import numpy as np
    torch, dev = t.torch, t.dev
    from repro_torch.analysis.cost import kernel_cost
    from repro_torch.configs.cub_resnet12 import get_config
    from repro_torch.core import avss as avss_lib
    from repro_torch.core.avss import SearchConfig
    from repro_torch.core.memory import MemoryConfig
    from repro_torch.engine import MemoryStore, RetrievalEngine, SearchRequest
    from repro_torch.kernels import _build, mcam_dist, mcam_search, ops
    from repro_torch.kernels import shortlist

    fsl = get_config()
    shots, d, cl = 16, fsl.embed_dim, fsl.cl
    n = args.capacity
    classes = n // shots
    _, labels_np, support_np, qcls, queries_np = clustered(
        args.seed + 17, n, d, CUB_SERVE_QUERIES)
    support = torch.from_numpy(support_np).to(dev)
    labels = torch.from_numpy(labels_np).to(dev)
    queries = torch.from_numpy(queries_np).to(dev)
    qcls_t = torch.from_numpy(qcls.astype(np.int64)).to(dev)
    del support_np
    cfg = MemoryConfig(capacity=n, dim=d,
                       search=SearchConfig("mtmc", cl=cl, mode="avss"))
    cs = cfg.search
    engine = RetrievalEngine(cs)

    def program():
        return MemoryStore.create(cfg).calibrate(support).write(support,
                                                                labels)
    program_ms = t.host_ms(program, reps=1)
    store = program()
    t.sync()
    seg, L = store.s_grid.shape[1:3]
    S, sl = seg * L, store.s_grid.shape[3]
    if store.pack_bits != 8 or store.proj_packed.shape != (n, d) \
            or S != 500:
        fail(f"[cub-serve] pack_bits {store.pack_bits}, packed "
             f"{tuple(store.proj_packed.shape)}, {S} strings a support")
    mb = sum(getattr(store, f).numel() * getattr(store, f).element_size()
             for f in ("values", "proj", "proj_packed", "s_grid")) / 1e6
    t.log(f"[cub-serve] d={d} mtmc cl={cl} levels={cs.enc.levels} "
          f"capacity={n} ({classes} classes x {shots} shots), {S} strings "
          f"of {sl} cells a support; program {program_ms:.2f} ms, store "
          f"{mb:.1f} MB on the card")

    qf = queries[:CUB_FULL_QUERIES]
    paths = {
        "two_phase": (queries, SearchRequest(mode="two_phase", k=64),
                      ("shortlist", "mcam_rescore")),
        "ideal": (queries, SearchRequest(mode="ideal", k=64),
                  ("shortlist",)),
        "two_phase_mxu": (queries, SearchRequest(
            mode="two_phase", k=64, backend="mxu", fused_min_rows=n + 1),
            ("mcam_dist", "mcam_rescore")),
        "full": (qf, SearchRequest(mode="full"), ("mcam_search",)),
    }
    results, path_ms = {}, {}
    for name, (qs, req, needs) in paths.items():
        _build.reset_launches()
        res = engine.search(store, qs, req)
        t.sync()
        counts = dict(_build.LAUNCHES)
        for kname in needs:
            if counts[kname] < 1:
                fail(f"[cub-serve] path {name} did not launch kernel "
                     f"{kname}: {counts}")
        _count(launches, counts, "_cub")
        for f in ("votes", "dist"):
            if not torch.isfinite(getattr(res, f)).all():
                fail(f"[cub-serve] path {name}: non-finite {f}")
        results[name] = res
        path_ms[f"cub_{name}"] = t.host_ms(
            lambda: engine.search(store, qs, req))
        t.log(f"[cub-serve {name}] {path_ms[f'cub_{name}']:.3f} ms, "
              f"launches { {k: v for k, v in counts.items() if v} }")
    tp, ideal, tpm, full = (results[k] for k in
                            ("two_phase", "ideal", "two_phase_mxu", "full"))
    acc = float((tp.predict() == qcls_t).float().mean())
    acc_full = float((full.predict() == qcls_t[:CUB_FULL_QUERIES])
                     .float().mean())
    t.log(f"[cub-serve accuracy] top-1 two_phase {acc:.4f}  full("
          f"{CUB_FULL_QUERIES}) {acc_full:.4f}")
    if acc < MIN_ACCURACY:
        fail(f"[cub-serve] two_phase top-1 accuracy {acc} < {MIN_ACCURACY}")
    for name, other in (("ideal", ideal), ("two_phase_mxu", tpm)):
        if not (torch.equal(other.indices, tp.indices)
                and torch.equal(other.dist, tp.dist)):
            fail(f"[cub-serve] {name} shortlist differs from the fused one")
    if not torch.equal(tpm.votes, tp.votes):
        fail("[cub-serve] two_phase votes differ between fused and mxu")
    tpf = engine.search(store, qf, SearchRequest(mode="two_phase", k=64))
    if not torch.equal(torch.take_along_dim(full.votes, tpf.indices, dim=1),
                       tpf.votes):
        fail("[cub-serve] two_phase votes differ from the full search's")

    def held(name, kernel, plain):
        """The kernel's result (tuple or tensor) equals the plain
        version's bit for bit -> (max abs error, plain ms, kernel out)."""
        got = kernel()
        t.sync()
        want, plain_ms = t.timed(plain)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, want))
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            fail(f"[cub-serve] {name} kernel differs from its plain version "
                 f"by {err}")
        return err, plain_ms, got

    # phase 1: the shortlist, 480-word rows streamed in K-chunks beside the
    # masks through the tensor-core select
    qw = store.quantize_queries(queries)
    valid, packed = store.valid, store.proj_packed
    nq = CUB_SERVE_QUERIES
    plan = shortlist.shortlist_plan(nq, n, packed.shape[1], 64)

    def sl_kernel():
        return shortlist.lut_shortlist(qw, None, 64, valid=valid,
                                       packed=packed, pack_bits=8)
    err, plain_ms, _ = held("shortlist", sl_kernel, lambda: (
        shortlist.lut_shortlist_plain(qw, None, 64, valid=valid,
                                      packed=packed, pack_bits=8)))
    adv8 = adversarial_stores(t, shortlist, qw, valid, packed, d,
                              "[cub-serve shortlist]")
    q1h_f = ops.query_onehot(qw, torch.float32)
    proj_f = store.proj.float()
    pen = torch.where(valid, 0.0, shortlist.SHORTLIST_MASK_PENALTY)[None]
    t.row("shortlist_cub", "shortlist.cu",
          "src/repro/kernels/shortlist.py:210", err, t.event_ms(sl_kernel),
          plain_ms, kernel_cost("shortlist", b=nq, n=n, d=d, k=64,
                                row_words=packed.shape[1], bits=8),
          t.event_ms(lambda: torch.sort(
              torch.matmul(q1h_f, proj_f.T) + pen, dim=1, stable=True)[0]
              [:, :64]),
          device_ms=t.device_ms(sl_kernel, "shortlist_"),
          plan=plan_fields(plan), row_words=packed.shape[1], **adv8,
          shape=f"B={nq} N={n} d={d} packed 8-bit ({packed.shape[1]} words "
                f"a row, K-chunks of {plan.chunk}) k=64")

    # the LUT product at K = 4d = 1,920
    q1h = ops.query_onehot(qw, torch.bfloat16)
    proj = store.proj
    err, plain_ms, _ = held(
        "mcam_dist", lambda: mcam_dist.lut_dist_matmul(q1h, proj),
        lambda: mcam_dist.lut_dist_matmul_plain(q1h, proj))
    t.row("mcam_dist_cub", "mcam_dist.cu", "src/repro/kernels/mcam_dist.py:32",
          err, t.event_ms(lambda: mcam_dist.lut_dist_matmul(q1h, proj)),
          plain_ms, kernel_cost("mcam_dist", b=nq, n=n, k=4 * d),
          t.event_ms(lambda: torch.matmul(q1h_f, proj_f.T)),
          device_ms=t.device_ms(lambda: mcam_dist.lut_dist_matmul(q1h, proj),
                                "lut_dist_"),
          shape=f"({nq} x {4 * d}) x ({n} x {4 * d})^T bf16 -> f32")
    del q1h_f, proj_f

    # the physics: dense (full) and gathered (two_phase's rescore)
    qs = ops.flatten_strings(ops.broadcast_query(avss_lib.layout_query(
        store.quantize_queries(qf), cs.enc, "avss"), L)).to(
            torch.int8).contiguous()
    ss = ops.flatten_strings(store.s_grid)
    w = cs.enc.weights_array(device=dev).repeat(seg)
    th = torch.as_tensor(cs.mcam.thresholds(), device=dev)

    def ms_kernel():
        return mcam_search.mcam_search(qs, ss, w, th, cs.mcam)
    err, plain_ms, (kv, kdist) = held(
        "mcam_search", ms_kernel,
        lambda: mcam_search.mcam_search_plain(qs, ss, w, th, cs.mcam))
    if not (torch.equal(kv, full.votes) and torch.equal(kdist, full.dist)):
        fail("[cub-serve] mcam_search kernel != the full search's result")
    t.row("mcam_search_cub", "mcam_search.cu",
          "src/repro/kernels/mcam_search.py:37", err, t.event_ms(ms_kernel),
          plain_ms, kernel_cost("mcam_search", b=CUB_FULL_QUERIES, n=n, s=S,
                                sl=sl), None,
          device_ms=t.device_ms(ms_kernel, "search_dense"),
          instance=mcam_search.search_instance(sl, qs, ss),
          shape=f"B={CUB_FULL_QUERIES} N={n} S={S} sl={sl} noisy")
    qsb = ops.flatten_strings(ops.broadcast_query(avss_lib.layout_query(
        qw, cs.enc, "avss"), L)).to(torch.int8).contiguous()
    rows = tp.indices

    def rs_kernel():
        return mcam_search.mcam_rescore(qsb, ss, rows, w, th, cs.mcam)
    err, plain_ms, (rk,) = held(
        "mcam_rescore", rs_kernel,
        lambda: mcam_search.mcam_rescore_plain(qsb, ss, rows, w, th,
                                               cs.mcam))
    if not torch.equal(rk, tp.votes):
        fail("[cub-serve] mcam_rescore kernel != the two_phase votes")
    uniq = int(torch.unique(rows).numel())
    t.row("mcam_rescore_cub", "mcam_search.cu",
          "src/repro/kernels/mcam_search.py:37", err, t.event_ms(rs_kernel),
          plain_ms, kernel_cost("mcam_rescore", b=nq, k=64, s=S, sl=sl,
                                uniq=uniq), None,
          also_replaces="src/repro/kernels/ops.py:186",
          device_ms=t.device_ms(rs_kernel, "search_gathered"),
          shape=f"B={nq} k=64 S={S} sl={sl} noisy, {uniq} distinct rows")
    # the routed search at this width: nprobe ROUTED_KERNEL_NPROBE
    routed = run_routed(t, store, queries, qcls_t,
                        {"two_phase": tp, "ideal": ideal}, launches,
                        suffix="_cub", nprobes=(ROUTED_KERNEL_NPROBE,))
    path_ms.update(routed.pop("phases_ms"))
    # [sharded]'s check at this width: two_phase on the (8,) mesh
    sharded = _sharded_search(t, engine, store, queries, "two_phase", tp,
                              SHARDED_MESHES[0], launches, "_cub")
    t.log(f"[sharded cub] two_phase on the (8,) mesh == unsharded: "
          f"{sharded}")
    return {"program_ms": program_ms, "accuracy_two_phase": acc,
            "accuracy_full": acc_full, "store_mb": mb, "routed": routed,
            "sharded": sharded,
            "phases_ms": {"cub_program": program_ms, **path_ms}}


def _sharded_search(t, engine, store, queries, mode, want, mesh_spec,
                    launches, suffix="") -> dict:
    """`mode` (k = 64) of `store` row-sharded over a mesh of positions on
    the card, with the launch counts zeroed just before and read just
    after (counted under `<kernel><suffix>`): every leaf and predict()
    must equal the unsharded result `want`, each shard launching its own
    shortlist (and rescore) -> {mesh, shards, launches}."""
    torch = t.torch
    from repro_torch.engine import SearchRequest
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import Mesh
    shape, names, axes = mesh_spec
    ms = store.shard(Mesh.repeat(t.dev, shape, names), axes)
    s = ms.n_shards
    req = SearchRequest(mode=mode, k=64)
    _build.reset_launches()
    res = engine.search(ms, queries, req)
    t.sync()
    counts = {k: v for k, v in _build.LAUNCHES.items() if v}
    _count(launches, counts, suffix)
    tag = f"[sharded{suffix.replace('_', ' ')}] {mode} {shape} {axes}"
    if not (_equal_results(torch, res, want)
            and torch.equal(res.predict(), want.predict())):
        fail(f"{tag}: differs from the unsharded search")
    need = {"shortlist": s, **({"mcam_rescore": s}
                               if mode == "two_phase" else {})}
    if any(counts.get(k, 0) != v for k, v in need.items()):
        fail(f"{tag}: launches {counts}, expected {need}")
    return {"mesh": list(shape), "axes": list(axes), "shards": s,
            "launches": counts}


def run_sharded(t, store, support, labels, queries, exhaustive, full16,
                launches) -> dict:
    """[sharded]: the main store row-sharded over meshes of positions on
    the one card (`SHARDED_MESHES`: 8 shards of 8,192 rows; 4 x 2 over
    both axes; 4 x 2 over "data", 4 shards each replicated twice).
    two_phase and ideal on each equal the unsharded search bit for bit,
    each shard launching its own kernels (`_sharded_search`); host-clock
    medians and a profiled call of each mode on the (8,) mesh beside the
    unsharded search's; `full` (B = 16) on the (8,) store equals the
    unsharded `full`; routed at SHARDED_NPROBE equals the logical
    partition's routed search, and the same routed search of the (8,)
    store without `proj_packed` (each shard streaming its wide bf16 rows)
    equals the packed store's, timed and profiled beside it; the
    shard-local write of a ragged store
    (SHARDED_WRITE_CAPACITY padded to a multiple of 8) in
    SHARDED_WRITE_BATCHES, the last wrapping past the ring's end across
    shard boundaries, equals the unsharded write in every leaf (its
    sketch `shard(mesh)`'s of that store), timed against it; the (8,)
    store saves 8 tiles a row leaf, restores and re-shards to the same
    leaves."""
    import tempfile
    from collections import Counter
    torch = t.torch
    from repro_torch.engine import MemoryStore, RetrievalEngine, SearchRequest
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import Mesh
    engine = RetrievalEngine(store.cfg.search)
    out, phases = {"searches": []}, {}
    for spec in SHARDED_MESHES:
        for mode in ("two_phase", "ideal"):
            got = _sharded_search(t, engine, store, queries, mode,
                                  exhaustive[mode], spec, launches)
            out["searches"].append(got)
            t.log(f"[sharded] {mode} {got['mesh']} over {got['axes']}: == "
                  f"unsharded, launches {got['launches']}")
    m8 = Mesh.repeat(t.dev, *SHARDED_MESHES[0][:2])
    ms = store.shard(m8)
    for mode in ("two_phase", "ideal"):
        req = SearchRequest(mode=mode, k=64)
        row = {}
        for name, st in (("unsharded", store), ("mesh8", ms)):
            ms_ = t.host_ms(lambda st=st: engine.search(st, queries, req))
            prof = _profile_search(t, lambda st=st: engine.search(
                st, queries, req))
            row[name] = {"ms": ms_, **{k: prof[k] for k in (
                "device_ms", "idle_share", "kernel_launches", "wall_ms",
                "top_kernels")}}
            phases[f"sharded_{mode}_{name}"] = ms_
        out[mode] = row
        t.log(f"[sharded time] {mode} B=256 k=64: unsharded "
              f"{row['unsharded']['ms']:.3f} ms (device "
              f"{row['unsharded']['device_ms']:.3f}, idle "
              f"{row['unsharded']['idle_share']:.3f}, "
              f"{row['unsharded']['kernel_launches']} launches); (8,) mesh "
              f"{row['mesh8']['ms']:.3f} ms (device "
              f"{row['mesh8']['device_ms']:.3f}, idle "
              f"{row['mesh8']['idle_share']:.3f}, "
              f"{row['mesh8']['kernel_launches']} launches)")
    q16, full = full16
    req = SearchRequest(mode="full")
    _build.reset_launches()
    res = engine.search(ms, q16, req)
    t.sync()
    counts = {k: v for k, v in _build.LAUNCHES.items() if v}
    _count(launches, counts)
    if counts.get("mcam_search") != 1 or not _equal_results(torch, res,
                                                           full):
        fail(f"[sharded] full (B=16) on the (8,) store differs from the "
             f"unsharded full search, launches {counts}")
    out["full"] = {name: t.host_ms(lambda st=st: engine.search(st, q16, req))
                   for name, st in (("unsharded", store), ("mesh8", ms))}
    t.log(f"[sharded] full B=16 on the (8,) store == unsharded: "
          f"{out['full']['mesh8']:.3f} ms, unsharded "
          f"{out['full']['unsharded']:.3f} ms, launches {counts}")
    logical = store.shard(n_shards=ms.n_shards)
    routed = {}
    for mode in ("two_phase", "ideal"):
        req = SearchRequest(mode=mode, k=64, nprobe=SHARDED_NPROBE)
        _build.reset_launches()
        res = routed[mode] = engine.search(ms, queries, req)
        t.sync()
        counts = {k: v for k, v in _build.LAUNCHES.items() if v}
        _count(launches, counts)
        if not _equal_results(torch, res, engine.search(logical, queries,
                                                        req)):
            fail(f"[sharded] routed {mode} nprobe={SHARDED_NPROBE} differs "
                 f"from the logical partition's")
        if not 0 < counts.get("shortlist_blocks", 0) <= ms.n_shards:
            fail(f"[sharded] routed {mode}: launches {counts}")
        ms_ = t.host_ms(lambda: engine.search(ms, queries, req))
        ms_logical = t.host_ms(lambda: engine.search(logical, queries, req))
        phases[f"sharded_routed_{mode}"] = ms_
        out[f"routed_{mode}"] = {"ms": ms_, "logical_ms": ms_logical,
                                 "launches": counts}
        t.log(f"[sharded] routed {mode} nprobe={SHARDED_NPROBE} on the "
              f"(8,) store == the logical partition's: {ms_:.3f} ms "
              f"(logical partition {ms_logical:.3f} ms), launches {counts}")

    # the routed search of the (8,) store without its packed projection:
    # each shard's block-table entry streams the wide bf16 rows
    unpacked = dataclasses.replace(ms, proj_packed=None)
    for mode in ("two_phase", "ideal"):
        req = SearchRequest(mode=mode, k=64, nprobe=SHARDED_NPROBE)
        _build.reset_launches()
        res = engine.search(unpacked, queries, req)
        t.sync()
        counts = {k: v for k, v in _build.LAUNCHES.items() if v}
        _count(launches, counts)
        if not _equal_results(torch, res, routed[mode]):
            fail(f"[sharded] routed {mode} nprobe={SHARDED_NPROBE} of the "
                 f"unpacked (8,) store differs from the packed store's")
        if not 0 < counts.get("shortlist_blocks", 0) <= ms.n_shards:
            fail(f"[sharded] routed unpacked {mode}: launches {counts}")
        row = {"launches": counts}
        for name, st in (("unpacked", unpacked), ("packed", ms)):
            prof = _profile_search(t, lambda st=st: engine.search(
                st, queries, req))
            row[name] = {"ms": t.host_ms(lambda st=st: engine.search(
                st, queries, req)), **{k: prof[k] for k in (
                    "device_ms", "idle_share", "kernel_launches",
                    "top_kernels")}}
        phases[f"sharded_routed_unpacked_{mode}"] = row["unpacked"]["ms"]
        out[f"routed_unpacked_{mode}"] = row
        up, pk = row["unpacked"], row["packed"]
        t.log(f"[sharded] routed {mode} nprobe={SHARDED_NPROBE} on the "
              f"(8,) store without proj_packed == the packed store's: "
              f"{up['ms']:.3f} ms (device {up['device_ms']:.3f}, "
              f"{up['kernel_launches']} launches), packed {pk['ms']:.3f} ms "
              f"(device {pk['device_ms']:.3f}, {pk['kernel_launches']} "
              f"launches); wrapper launches {counts}")
    del unpacked

    # the shard-local write-through of a ragged store
    cfg = dataclasses.replace(store.cfg, capacity=SHARDED_WRITE_CAPACITY)
    batches, a = [], 0
    for b in SHARDED_WRITE_BATCHES:
        idx = torch.arange(a, a + b, device=t.dev) % support.shape[0]
        batches.append((support[idx], labels[idx]))
        a += b

    def program(st):
        for x, lab in batches:
            st = st.write(x, lab)
        return st
    base = MemoryStore.create(cfg).calibrate(support)
    mbase = base.shard(m8)
    unsharded, streamed = program(base), program(mbase)
    t.sync()
    want = unsharded.shard(n_shards=8)
    sketch = unsharded.shard(m8)
    if streamed.capacity != want.capacity or int(streamed.size) != a:
        fail(f"[sharded write] capacity {streamed.capacity}, size "
             f"{int(streamed.size)}")
    for f in ("values", "proj", "proj_packed", "s_grid", "labels"):
        if not torch.equal(getattr(streamed, f).full(t.dev),
                           getattr(want, f)):
            fail(f"[sharded write] {f} differs from the unsharded write")
    for f in ("sketch_sums", "sketch_counts"):
        if not torch.equal(getattr(streamed, f).full(t.dev),
                           getattr(sketch, f).full(t.dev)):
            fail(f"[sharded write] {f} differs from shard(mesh)'s")
    w_ms = {"unsharded": t.host_ms(lambda: program(base), reps=3),
            "mesh8": t.host_ms(lambda: program(mbase), reps=3)}
    phases.update({f"sharded_write_{k}": v for k, v in w_ms.items()})
    out["write"] = {"capacity": streamed.capacity, "rows": a, **w_ms}
    t.log(f"[sharded write] capacity {SHARDED_WRITE_CAPACITY} (padded to "
          f"{streamed.capacity}) in batches {SHARDED_WRITE_BATCHES}: every "
          f"leaf == the unsharded write; {w_ms['mesh8']:.2f} ms on the (8,) "
          f"mesh, {w_ms['unsharded']:.2f} ms unsharded")
    del base, mbase, unsharded, streamed, want, sketch

    # the tiled checkpoint: 8 tiles a row leaf, restored and re-sharded
    with tempfile.TemporaryDirectory() as tmp:
        ms.save(tmp)
        per_leaf = dict(sorted(Counter(
            f.name.split(".")[0] for f in
            (Path(tmp) / "step_0000000000").glob("*.npy")).items()))
        back = MemoryStore.restore(tmp, store.cfg).shard(m8)
    t.sync()
    if sorted(per_leaf.values()) != [1, 1, 1, 8, 8, 8, 8]:
        fail(f"[sharded ckpt] tiles a leaf {per_leaf}")
    for f in ("values", "proj", "proj_packed", "s_grid", "labels",
              "sketch_sums", "sketch_counts"):
        if not torch.equal(getattr(back, f).full(t.dev),
                           getattr(ms, f).full(t.dev)):
            fail(f"[sharded ckpt] {f} differs after save -> restore -> "
                 f"shard")
    out["checkpoint_tiles"] = per_leaf
    t.log(f"[sharded ckpt] save of the (8,) store: tiles a leaf {per_leaf};"
          f" restore -> shard equal in every leaf")
    return {**out, "phases_ms": phases}


def _equal_results(torch, a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in LEAVES)


def run_routed(t, store, queries, qcls_t, exhaustive, launches,
               suffix="", nprobes=ROUTED_NPROBES, full16=None) -> dict:
    """[routed]: the store in ROUTED_SHARDS logical shards, searched with
    `nprobe` (the router picks each query's shards; the block-table
    entry of csrc/shortlist.cu ranks their rows). nprobe None and
    ROUTED_SHARDS must equal the exhaustive search byte for byte; each
    routed search equals, bit for bit, the plain route (backend "ref",
    no kernel) on the card over the same visited shards; with `full16`
    (queries, full result) routed two_phase votes equal the full search's
    at the same global rows. Top-1 accuracy and recall@k against the
    exhaustive search are printed, not gated. Adds the rows
    `shortlist_blocks<suffix>` at nprobe ROUTED_KERNEL_NPROBE and, where
    nprobe 1 runs, `shortlist_blocks_p1<suffix>`."""
    torch = t.torch
    from repro_torch.engine import RetrievalEngine, SearchRequest
    from repro_torch.kernels import _build
    tag = f"[routed{suffix.replace('_', ' ')}]"
    eng = RetrievalEngine(store.cfg.search)
    plain = eng.with_backend("ref")
    rstore = store.shard(n_shards=ROUTED_SHARDS)
    for mode in ("two_phase", "ideal"):
        for p in (None, ROUTED_SHARDS):
            res = eng.search(rstore, queries, SearchRequest(mode=mode, k=64,
                                                            nprobe=p))
            if not _equal_results(torch, res, exhaustive[mode]):
                fail(f"{tag} nprobe={p} {mode} differs from the exhaustive "
                     f"search")
    out, phases = {}, {}
    for p in nprobes:
        for mode in ("two_phase", "ideal"):
            req = SearchRequest(mode=mode, k=64, nprobe=p)
            _build.reset_launches()
            res = eng.search(rstore, queries, req)
            t.sync()
            counts = dict(_build.LAUNCHES)
            needs = ("shortlist_blocks",) + (
                ("mcam_rescore",) if mode == "two_phase" else ())
            for kname in needs:
                if counts[kname] < 1:
                    fail(f"{tag} {mode} nprobe={p} did not launch {kname}: "
                         f"{counts}")
            if counts["shortlist_blocks"] != 1:
                fail(f"{tag} {mode} nprobe={p}: {counts['shortlist_blocks']} "
                     f"block-table launches, expected 1")
            _count(launches, counts, suffix)
            if p == 1:
                _count(launches, {"shortlist_blocks_p1":
                                  counts["shortlist_blocks"]}, suffix)
            if not torch.isfinite(res.dist).all():
                fail(f"{tag} {mode} nprobe={p}: non-finite dist")
            ref = plain.search(rstore, queries, req)
            if not _equal_results(torch, res, ref):
                fail(f"{tag} {mode} nprobe={p} differs from the plain route")
            ms = t.host_ms(lambda: eng.search(rstore, queries, req))
            ex = exhaustive[mode].indices
            recall = float((res.indices[:, :, None] == ex[:, None, :])
                           .any(-1).float().mean())
            acc = float((res.predict() == qcls_t).float().mean())
            name = f"{mode}_nprobe{p}"
            out[name] = {"ms": ms, "top1": acc, "recall_at_k": recall,
                         "launches": {k: v for k, v in counts.items() if v}}
            phases[f"routed{suffix}_{name}"] = ms
            t.log(f"{tag} {mode} nprobe={p}: {ms:.3f} ms, top-1 {acc:.4f}, "
                  f"recall@64 {recall:.4f} vs exhaustive, launches "
                  f"{out[name]['launches']}; == plain route")
        if full16 is not None:
            q16, full = full16
            tp16 = eng.search(rstore, q16, SearchRequest(mode="two_phase",
                                                         k=64, nprobe=p))
            if not torch.equal(torch.take_along_dim(full.votes, tp16.indices,
                                                    dim=1), tp16.votes):
                fail(f"{tag} nprobe={p}: two_phase votes differ from the "
                     f"full search's at the same rows")
    if full16 is not None:
        t.log(f"{tag} routed two_phase votes == full votes at the same "
              f"global rows, 16 queries, nprobe {list(nprobes)}")
    # where a path's time goes: the routed two_phase against the
    # exhaustive one on the same store
    trace = {}
    for name, p in ((f"two_phase_nprobe{ROUTED_KERNEL_NPROBE}",
                     ROUTED_KERNEL_NPROBE), ("two_phase_exhaustive", None)):
        req = SearchRequest(mode="two_phase", k=64, nprobe=p)
        trace[name] = _profile_search(
            t, lambda: eng.search(rstore, queries, req))
        t.log(f"{tag} trace {name}: {trace[name]}")
    out["trace"] = trace
    for p in (ROUTED_KERNEL_NPROBE, 1):
        if p in nprobes:
            req = SearchRequest(mode="ideal", k=64, nprobe=p)
            blocks_row(t, f"shortlist_blocks{'_p1' if p == 1 else ''}"
                          f"{suffix}",
                       capture_blocks(lambda: eng.search(rstore, queries,
                                                         req)),
                       adversarial=(16, 8) if suffix else (16,),
                       note=f", the store in {ROUTED_SHARDS} shards")
    return {**out, "phases_ms": phases}


def _profile_search(t, fn, kinds: dict | None = None,
                    ranges: tuple = ()) -> dict:
    """One search under torch.profiler (`_profiled`): its wall time, the
    kernels' device time and the device's idle share, the kernel launches
    and the calls that wait for the device (stream / device
    synchronisations, blocking copies, scalar reads), the host operations
    that took the most time of their own, and the kernels that took the
    most device time. With `kinds` ({kind: parts of kernel names}), the
    device time by kind (the first that matches, else "other"); `ranges`
    names record_function ranges of fn, left out of the kernels' sums and
    reported with the device time under each."""
    torch = t.torch
    events, wall = _profiled(t, fn)
    cuda = torch.autograd.DeviceType.CUDA
    in_range = [e for e in events if e.key in ranges]
    events = [e for e in events if e.key not in ranges]
    busy = sum(e.device_time_total for e in events
               if e.device_type == cuda) / 1e3
    host = [e for e in events if e.device_type != cuda]
    waits = {e.key: e.count for e in host if e.key in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy",
        "aten::_local_scalar_dense")}
    launches = sum(e.count for e in host if "LaunchKernel" in e.key)
    top = sorted(((e.key[:60], e.self_cpu_time_total / 1e3, e.count)
                  for e in host), key=lambda r: -r[1])[:8]
    kernels = sorted(((e.key[:50], e.device_time_total / 1e3)
                      for e in events if e.device_type == cuda),
                     key=lambda r: -r[1])[:8]
    out = {"wall_ms": wall, "device_ms": busy,
           "idle_share": 1 - busy / wall if wall else None,
           "kernel_launches": launches, "waits": waits,
           "top_host_ops": [(k, round(ms, 4), n) for k, ms, n in top],
           "top_kernels": [(k, round(ms, 4)) for k, ms in kernels]}
    if kinds is not None:
        by_kind = {kind: 0.0 for kind in (*kinds, "other")}
        for e in events:
            if e.device_type == cuda:
                kind = next((kd for kd, parts in kinds.items()
                             if any(part in e.key for part in parts)),
                            "other")
                by_kind[kind] += e.device_time_total / 1e3
        out["device_ms_by_kind"] = by_kind
    if ranges:
        # the host-side range's device time sums the kernels launched
        # inside it (its device-side twin spans idle time too)
        out["ranges_device_ms"] = {e.key: e.device_time_total / 1e3
                                   for e in in_range
                                   if e.device_type != cuda}
    return out


def capture_blocks(fn) -> tuple:
    """The arguments of the one block-table call that `fn` (a search)
    makes: the entry's inputs as the path gives them."""
    from repro_torch.kernels import shortlist
    seen, real = [], shortlist.lut_shortlist_blocks

    def spy(*a, **kw):
        seen.append((a, kw))
        return real(*a, **kw)
    shortlist.lut_shortlist_blocks = spy
    try:
        fn()
    finally:
        shortlist.lut_shortlist_blocks = real
    if len(seen) != 1:
        fail(f"expected one block-table call, saw {len(seen)}")
    return seen[0]


def pack_fields(torch, proj, bits: int):
    """(N, C) integer LUT columns -> (N, ceil(C / wpi)) int32 words of
    `bits`-bit fields, column w * dp + m in field w of word m
    (`ops.pack_projection`'s layout)."""
    wpi = 32 // bits
    n, c = proj.shape
    dp = -(-c // wpi)
    p = torch.nn.functional.pad(proj.to(torch.int64), (0, dp * wpi - c))
    shifts = torch.arange(wpi, device=p.device, dtype=torch.int64) * bits
    words = (p.reshape(n, wpi, dp) << shifts[None, :, None]).sum(1)
    words &= 0xFFFFFFFF
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def uniform_table(torch, per_row, d: int, bits: int):
    """(N, words) int32 words of `bits`-bit packed fields whose every LUT
    column of a dimension holds one value, so that a row's distance is
    per_row (N,) whatever the query: per_row spread over the d
    dimensions, each share within a field."""
    share = (per_row // d)[:, None] + (torch.arange(d, device=per_row.device)
                                       [None] < (per_row % d)[:, None])
    if int(share.max()) >= 2**bits:
        fail(f"uniform table: shares reach {int(share.max())}")
    return pack_fields(torch, share.repeat_interleave(4, dim=1), bits)


def plan_fields(plan) -> dict:
    """The one-table select's plan as a kernel row prints it."""
    return {"path": plan.path, "query_tile": plan.queries,
            "row_tile": plan.tile_rows, "k_chunk_words": plan.chunk,
            "stages": plan.stages, "blocks_an_sm": plan.ctas_per_sm,
            "slices": plan.slices, "blocks": plan.blocks, "smem": plan.smem}


def adversarial_stores(t, shortlist, qw, valid, packed, d: int, tag: str,
                       bits: int = 8, stores: dict | None = None) -> dict:
    """The shortlist wrapper on adversarial stores of N rows of `bits`-bit
    fields, each held against the plain version bit for bit at k = 1, 64
    and 1,024 and timed at k = 64 (`<store>_ms`, `<store>_device_ms`):
    rows in descending distance (every row beats the running k-th key: the
    selection's worst case; at 8 bits, distances 255 d (N - 1 - n) / N,
    tied in runs where 255 d < N), all rows tied (no row after the first k
    beats it), and, where `packed` is given, its rows all masked. `stores`
    gives per-row distances in place of the first two."""
    torch = t.torch
    n = valid.shape[0]
    if stores is None:
        desc = torch.arange(n - 1, -1, -1, device=t.dev) * 255 * d // n
        stores = {"descending": desc,
                  "ties": torch.full_like(desc, 5 * d)}
    tables = {name: (uniform_table(torch, per_row, d, bits), valid)
              for name, per_row in stores.items()}
    if packed is not None:
        tables["masked"] = (packed, torch.zeros_like(valid))
    out = {}
    for name, (words, vmask) in tables.items():
        def call(kk, fn=shortlist.lut_shortlist):
            return fn(qw, None, kk, valid=vmask, packed=words,
                      pack_bits=bits)
        for kk in (1, 64, 1024):
            a = call(kk)
            t.sync()
            b = call(kk, shortlist.lut_shortlist_plain)
            t.sync()
            if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
                fail(f"{tag} shortlist kernel != plain on the {name} store "
                     f"(k={kk})")
        out[f"{name}_ms"] = t.event_ms(lambda: call(64))
        out[f"{name}_device_ms"] = t.device_ms(lambda: call(64),
                                               "shortlist_")
    t.log(f"{tag} adversarial stores of {bits}-bit fields ({words.shape[1]} "
          f"words a row) equal the plain version for k = 1, 64, 1024; k=64 "
          f"ms: { {k_: v and round(v, 4) for k_, v in out.items()} }")
    return out


def descending_table(torch, m, rows, d, bits, dev):
    """An adversarial table (m, rows, words): every row a fixed distance
    for every query (each LUT column of a dimension holds its share), in
    descending order over the m rows rows, so each row beats the running
    k-th key; fields of `bits` bits (the shares stay below 2**bits)."""
    n = m * rows
    per_row = torch.arange(n - 1, -1, -1, device=dev) * (3 if bits > 8
                                                          else 1)
    return uniform_table(torch, per_row, d, bits).reshape(m, rows, -1)


def blocks_units(shortlist, ids, m: int, rows: int, row_words: int, k: int,
                 mma: bool) -> dict:
    """The block-table plan at these visit lists: CTAs an SM, the units
    the grouping pass lays out, the grid's unit slots and the cut."""
    b, p = ids.shape
    plan = shortlist.shortlist_blocks_plan(b, p, m, rows, row_words, k, mma)
    ids = ids.reshape(-1).cpu()
    counts = ids.clamp(-1, m).masked_fill(ids < 0, m).bincount(
        minlength=m + 1).tolist()
    return {"ctas_per_sm": plan.ctas_per_sm,
            "units": plan.units_in_use(counts, rows),
            "unit_slots": plan.units, "smem": plan.smem, "chunk": plan.chunk,
            "stages": plan.stages, "work": plan.work, "split": plan.split}


def blocks_row(t, name, call, adversarial=(), note="") -> None:
    """The row `name`: the block-table entry on the inputs `call` (from
    capture_blocks) held against its plain version bit for bit, with its
    device time by pass (group, select, merge), its bound (the union of
    the blocks the visit lists name, read once) and the library's matmul
    + mask + sort over all table rows. `adversarial`: field widths of a
    descending table (descending_table) whose every row of query 0's
    visited blocks is masked, held bit for bit at k = 1, 64 and 1,024 and
    timed at the call's k."""
    torch = t.torch
    from repro_torch.analysis.cost import kernel_cost
    from repro_torch.kernels import ops, shortlist
    (qw, sp, k), kw = call
    ids, base, valid = kw["ids"], kw["base"], kw["valid"]
    table = kw.get("packed") if sp is None else sp
    m, rows = table.shape[:2]
    b, p = ids.shape
    d = qw.shape[1]

    def kernel():
        return shortlist.lut_shortlist_blocks(qw, sp, k, **kw)

    def plain():
        return shortlist.lut_shortlist_blocks_plain(qw, sp, k, **kw)
    got = kernel()
    t.sync()
    want, plain_ms = t.timed(plain)
    err = max(float((got[0] - want[0]).abs().max()),
              float((got[1] - want[1]).abs().max()))
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        fail(f"{name} kernel differs from plain by {err}")
    extra = {}
    for bits in adversarial:
        words = descending_table(torch, m, rows, d, bits, t.dev)
        vmask = valid.clone()
        vmask[ids[0]] = False
        adv = dict(base=base, ids=ids, valid=vmask, packed=words,
                   pack_bits=bits)
        for kk in (1, 64, 1024):
            a = shortlist.lut_shortlist_blocks(qw, None, kk, **adv)
            t.sync()
            c = shortlist.lut_shortlist_blocks_plain(qw, None, kk, **adv)
            t.sync()
            if not (torch.equal(a[0], c[0]) and torch.equal(a[1], c[1])):
                fail(f"{name} != plain on the descending, masked table of "
                     f"{bits}-bit fields (k={kk})")

        def adv_kernel():
            return shortlist.lut_shortlist_blocks(qw, None, k, **adv)
        extra[f"descending_masked_{bits}bit_ms"] = t.event_ms(adv_kernel)
        extra[f"descending_masked_{bits}bit_device"] = t.device_ms(
            adv_kernel, "shortlist_", passes=BLOCK_PASSES)
        del words
    visited = int(torch.unique(ids[(ids >= 0) & (ids < m)]).numel())
    q1h_f = ops.query_onehot(qw, torch.float32)
    proj_f = (shortlist.unpack_projection(table.reshape(m * rows, -1),
                                          kw["pack_bits"], 4 * d)
              if sp is None else sp.reshape(m * rows, -1).float())
    pen = torch.where(valid.reshape(-1), 0.0,
                      shortlist.SHORTLIST_MASK_PENALTY)[None]
    library_ms = t.event_ms(lambda: torch.sort(
        torch.matmul(q1h_f, proj_f.T) + pen, dim=1, stable=True)[0][:, :k])
    del q1h_f, proj_f, pen
    words = table.shape[2] if sp is None else (
        table.shape[2] // (2 if sp.dtype == torch.bfloat16 else 1))
    plan = blocks_units(shortlist, ids, m, rows, words, k,
                        sp is None and kw["pack_bits"] == 8)
    passes = t.device_ms(kernel, "shortlist_", passes=BLOCK_PASSES)
    t.row(name, "shortlist.cu", "src/repro/kernels/shortlist.py:210", err,
          t.event_ms(kernel), plain_ms,
          kernel_cost("shortlist_blocks", b=b, d=d, p=p, m=m, rows=rows,
                      row_words=words, k=k, visited=visited), library_ms,
          device_ms=passes and passes["total"], passes_ms=passes,
          plan=plan, visited_blocks=visited,
          also_replaces="jax.vmap of it, src/repro/engine/engine.py:318",
          shape=f"B={b} d={d} p={p} of {m} blocks x {rows} rows, "
                f"{'packed ' + str(kw['pack_bits']) + '-bit' if sp is None else sp.dtype} "
                f"({words} words a row) k={k}{note}; library: matmul + "
                f"mask + sort over all {m * rows} rows", **extra)


def tenant_stack(t, args) -> tuple:
    """[tenants]' stack: TENANTS Omniglot stores of ragged capacities,
    some slots never written, stacked, and 256 queries of uniformly mixed
    tenants -> (stack, queries, tenant ids, their numpy twin, query
    classes, the generator, the search config, MB on the card, classes
    written per tenant)."""
    import numpy as np
    torch, dev = t.torch, t.dev
    from repro_torch.core.avss import SearchConfig
    from repro_torch.core.memory import MemoryConfig
    from repro_torch.engine import MemoryStore, TenantStore
    shots, d, nq = 16, 48, 256
    rng = np.random.default_rng(args.seed + 29)
    caps = rng.integers(TENANT_MIN_CAPACITY // shots,
                        TENANT_NPAD // shots + 1, TENANTS) * shots
    caps[0] = TENANT_NPAD
    search = SearchConfig("mtmc", cl=32, mode="avss")
    stores, centres, written = [], [], []
    t0 = time.perf_counter()
    for cap in caps:
        cap = int(cap)
        n_cls = cap // shots
        cen = rng.standard_normal((n_cls, d), dtype=np.float32) * 2.0
        lab = np.repeat(np.arange(n_cls, dtype=np.int32), shots)
        x = cen[lab] + 0.3 * rng.standard_normal((cap, d), dtype=np.float32)
        n_w = cap - shots * int(rng.integers(0, n_cls // 8 + 1))
        st = MemoryStore.create(MemoryConfig(capacity=cap, dim=d,
                                             search=search)).calibrate(
            torch.from_numpy(x).to(dev))
        stores.append(st.write(torch.from_numpy(x[:n_w]).to(dev),
                               torch.from_numpy(lab[:n_w]).to(dev)))
        centres.append(cen)
        written.append(n_w // shots)
    tstore = TenantStore.stack(stores)
    t.sync()
    program_s = time.perf_counter() - t0
    if tstore.n_pad != TENANT_NPAD:
        fail(f"[tenants] n_pad {tstore.n_pad}")
    mb = sum(getattr(tstore, f).numel() * getattr(tstore, f).element_size()
             for f in ("values", "proj", "proj_packed", "s_grid",
                       "labels")) / 1e6
    tids_np = rng.integers(0, TENANTS, nq)
    qcls = np.array([rng.integers(0, written[i]) for i in tids_np])
    q_np = np.stack([centres[i][c] for i, c in zip(tids_np, qcls)]) + \
        0.3 * rng.standard_normal((nq, d), dtype=np.float32)
    queries = torch.from_numpy(q_np.astype(np.float32)).to(dev)
    tids = torch.from_numpy(tids_np).to(dev)
    t.log(f"[tenants] {TENANTS} tenants, capacities {int(caps.min())}.."
          f"{int(caps.max())} ({int(caps.sum())} rows, "
          f"{int(sum(written)) * shots} written), n_pad {tstore.n_pad}, "
          f"{mb:.1f} MB on the card, programmed in {program_s:.2f} s; "
          f"B={nq}, {len(np.unique(tids_np))} tenants in the batch")
    return (tstore, queries, tids, tids_np, qcls, rng, search, mb,
            written)


def run_tenants(t, args, launches) -> dict:
    """[tenants]: TENANTS Omniglot stores (d = 48, MTMC CL = 32) of ragged
    capacities in TENANT_MIN_CAPACITY..TENANT_NPAD, some slots never
    written, stacked (n_pad TENANT_NPAD), and 256 queries of uniformly
    mixed tenants. two_phase, ideal and full on the default backend and
    two_phase on mxu below the fused threshold (the dense route) must each
    equal every tenant's solo search on `tenant(t)` bit for bit, queries
    grouped in batch order; then TenantServer runs TENANT_FLUSHES flushes
    of 256 submits with a write_at after every 4th, and every flush must
    launch the same kernels the same number of times."""
    import numpy as np
    torch, dev = t.torch, t.dev
    from repro_torch.engine import RetrievalEngine, SearchRequest
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import TenantServer
    shots, d, nq = 16, 48, 256
    tstore, queries, tids, tids_np, qcls, rng, search, mb, _ = \
        tenant_stack(t, args)
    eng = RetrievalEngine(search)
    paths = {
        "two_phase": (SearchRequest(mode="two_phase", k=64),
                      ("shortlist_blocks", "mcam_rescore")),
        "ideal": (SearchRequest(mode="ideal", k=64), ("shortlist_blocks",)),
        "full": (SearchRequest(mode="full"), ("mcam_rescore",)),
        "two_phase_mxu": (SearchRequest(mode="two_phase", k=64,
                                        backend="mxu",
                                        fused_min_rows=TENANT_NPAD + 1),
                          ("mcam_dist", "mcam_rescore")),
    }
    out, phases = {}, {}
    for name, (req, needs) in paths.items():
        _build.reset_launches()
        res = eng.search_tenants(tstore, queries, tids, req)
        t.sync()
        counts = dict(_build.LAUNCHES)
        for kname in needs:
            if counts[kname] < 1:
                fail(f"[tenants] {name} did not launch {kname}: {counts}")
        _count(launches, counts, "_tenants")
        if not torch.isfinite(res.dist).all():
            fail(f"[tenants] {name}: non-finite dist")
        for tn in np.unique(tids_np):
            sel = torch.from_numpy(np.where(tids_np == tn)[0]).to(dev)
            solo = eng.search(tstore.tenant(int(tn)), queries[sel], req)
            w = solo.votes.shape[1]
            for f in LEAVES:
                if not torch.equal(getattr(res, f)[sel][:, :w],
                                   getattr(solo, f)):
                    fail(f"[tenants] {name}: tenant {tn} {f} differs from "
                         f"its solo search")
            if not (res.votes[sel][:, w:] == float("-inf")).all():
                fail(f"[tenants] {name}: tenant {tn} pad columns unmasked")
        ms = t.host_ms(lambda: eng.search_tenants(tstore, queries, tids,
                                                  req))
        acc = float((res.predict().cpu().numpy() == qcls).mean())
        out[name] = {"ms": ms, "top1": acc,
                     "launches": {k: v for k, v in counts.items() if v}}
        phases[f"tenants_{name}"] = ms
        t.log(f"[tenants {name}] {ms:.3f} ms, top-1 {acc:.4f}, launches "
              f"{out[name]['launches']}; == solo search of every tenant")
    blocks_row(t, "shortlist_blocks_tenants", capture_blocks(
        lambda: eng.search_tenants(tstore, queries, tids,
                                   SearchRequest(mode="ideal", k=64))),
        note=f", {TENANTS} tenants stacked")
    server = TenantServer(eng, tstore, SearchRequest(mode="two_phase", k=64))
    flush_ms, profiles = [], []
    for i in range(TENANT_FLUSHES):
        mix = rng.integers(0, TENANTS, nq)
        t.sync()
        t0 = time.perf_counter()
        _build.reset_launches()
        for b in range(nq):
            server.submit(int(mix[b]), queries[b])
        got = server.flush()
        t.sync()
        flush_ms.append((time.perf_counter() - t0) * 1e3)
        profiles.append(tuple(sorted((k, v) for k, v in
                                     _build.LAUNCHES.items() if v)))
        if len(got) != nq:
            fail(f"[tenants] flush {i} returned {len(got)} tickets")
        if i % 4 == 3:
            tn = int(mix[0])
            x = rng.standard_normal((shots, d), dtype=np.float32)
            server.write(tn, torch.from_numpy(x).to(dev),
                         torch.full((shots,), 7, device=dev))
    if len(set(profiles)) != 1 or server.cache_entries() != 1:
        fail(f"[tenants] flush launches depend on the mix: "
             f"{set(profiles)}")
    med = statistics.median(flush_ms)
    t.log(f"[tenants server] {TENANT_FLUSHES} flushes x {nq} submits, a "
          f"write_at after every 4th: median {med:.2f} ms a flush "
          f"({nq / med * 1e3:.0f} queries/s), each flush launched "
          f"{dict(profiles[0])}")
    out["server"] = {"flush_ms": flush_ms, "median_ms": med,
                     "queries_per_s": nq / med * 1e3,
                     "launches_per_flush": dict(profiles[0])}
    phases["tenants_flush"] = med
    return {**out, "store_mb": mb, "phases_ms": phases}


def run_pager(t, args, launches) -> dict:
    """[pager]: a store of PAGER_CLASSES x 16 rows (1,048,576; programmed
    on the card in ring batches of PAGER_WRITE_ROWS), partitioned into
    PAGER_SHARDS shards in pinned host memory, paged through PAGER_SLOTS
    device slots by PAGER_BATCHES batches of PAGER_QUERIES queries at
    nprobe PAGER_NPROBE. The classes come in groups written together
    (PAGER_GROUP shards a group of related classes), and batch i draws
    from groups i and i + 1, so consecutive batches share shards. Every
    paged result must equal the routed search of the device-resident twin
    bit for bit; a repeated batch (all shards resident) must copy no
    block."""
    import numpy as np
    torch, dev = t.torch, t.dev
    from repro_torch.core.avss import SearchConfig
    from repro_torch.core.memory import MemoryConfig
    from repro_torch.engine import (MemoryStore, RetrievalEngine,
                                    SearchRequest, ShardPager)
    from repro_torch.kernels import _build
    shots, d = 16, 48
    n = PAGER_CLASSES * shots
    per_shard = PAGER_CLASSES // PAGER_SHARDS
    rng = np.random.default_rng(args.seed + 41)
    group = rng.standard_normal((PAGER_SHARDS // PAGER_GROUP, d),
                                dtype=np.float32) * 3.0
    shard_c = group[np.arange(PAGER_SHARDS) // PAGER_GROUP] + \
        rng.standard_normal((PAGER_SHARDS, d), dtype=np.float32)
    centres = shard_c[np.arange(PAGER_CLASSES) // per_shard] + \
        rng.standard_normal((PAGER_CLASSES, d), dtype=np.float32)
    search = SearchConfig("mtmc", cl=32, mode="avss")
    cfg = MemoryConfig(capacity=n, dim=d, search=search)
    t0 = time.perf_counter()
    store = None
    for r0 in range(0, n, PAGER_WRITE_ROWS):
        lab = np.arange(r0, r0 + PAGER_WRITE_ROWS) // shots
        x = torch.from_numpy(centres[lab] + 0.3 * rng.standard_normal(
            (PAGER_WRITE_ROWS, d), dtype=np.float32)).to(dev)
        if store is None:
            store = MemoryStore.create(cfg).calibrate(x)
        store = store.write(x, torch.from_numpy(lab.astype(np.int32)).to(
            dev))
    t.sync()
    program_s = time.perf_counter() - t0
    twin = store.shard(n_shards=PAGER_SHARDS)
    t0 = time.perf_counter()
    host = store.shard(n_shards=PAGER_SHARDS, residency="host")
    host_s = time.perf_counter() - t0
    del store
    if not (host.residency == "host" and host.values.is_pinned()):
        fail("[pager] the host store's leaves are not pinned host memory")
    gb = sum(getattr(host, f).numel() * getattr(host, f).element_size()
             for f in ("values", "proj", "proj_packed", "s_grid",
                       "labels")) / 1e9
    rows = n // PAGER_SHARDS
    eng = RetrievalEngine(search)
    pager = ShardPager(host, eng, slots=PAGER_SLOTS)
    req = SearchRequest(mode="two_phase", k=64, nprobe=PAGER_NPROBE)
    block_bytes = sum(v[0].numel() * v.element_size()
                      for v in pager._host.values())
    t.log(f"[pager] {n} rows ({PAGER_CLASSES} classes x {shots} shots) "
          f"programmed in {program_s:.2f} s; {PAGER_SHARDS} shards of "
          f"{rows} rows ({block_bytes / 1e6:.2f} MB a shard) moved to "
          f"pinned host memory ({gb:.2f} GB) in {host_s:.2f} s; "
          f"{PAGER_SLOTS} slots, nprobe {PAGER_NPROBE}")
    batches = []
    for i in range(PAGER_BATCHES):
        shards = rng.integers(PAGER_GROUP * i, PAGER_GROUP * (i + 2),
                              PAGER_QUERIES)
        cls = shards * per_shard + rng.integers(0, per_shard, PAGER_QUERIES)
        batches.append((torch.from_numpy((centres[cls] + 0.3 *
                        rng.standard_normal((PAGER_QUERIES, d),
                                            dtype=np.float32)).astype(
                            np.float32)), cls))
    per_batch, counts_all = [], []
    for i, (q, cls) in enumerate(batches):
        before = (pager.hits, pager.misses, pager.staged_hits,
                  dict(pager.transfers))
        _build.reset_launches()
        t.sync()
        t0 = time.perf_counter()
        res = pager.search(q, req)
        t.sync()
        ms = (time.perf_counter() - t0) * 1e3
        counts = dict(_build.LAUNCHES)
        for kname in ("shortlist_blocks", "mcam_rescore"):
            if counts[kname] < 1:
                fail(f"[pager] batch {i} did not launch {kname}: {counts}")
        _count(launches, counts, "_pager")
        counts_all.append({k: v for k, v in counts.items() if v})
        want = eng.search(twin, q.to(dev), req)
        if not _equal_results(torch, res, want):
            fail(f"[pager] batch {i} differs from the device twin")
        rec = {"ms": ms, "hits": pager.hits - before[0],
               "misses": pager.misses - before[1],
               "staged_used": pager.staged_hits - before[2],
               **{f"{k}_bytes": pager.transfers[k] - before[3][k]
                  for k in pager.transfers},
               "top1": float((res.predict().cpu().numpy() == cls).mean())}
        per_batch.append(rec)
        t.log(f"[pager batch {i}] {ms:.2f} ms, {rec['hits']} hits, "
              f"{rec['misses']} misses, {rec['staged_used']} from the "
              f"prefetch, {rec['blocks_bytes'] / 1e6:.1f} MB paged at the "
              f"miss, {rec['staged_bytes'] / 1e6:.1f} MB staged, top-1 "
              f"{rec['top1']:.3f}; == device twin")
    blocks = pager.transfers["blocks"]
    q_last = batches[-1][0]
    steady_ms = t.host_ms(lambda: pager.search(q_last, req))
    if pager.transfers["blocks"] != blocks:
        fail("[pager] a batch of resident shards paged a block")
    twin_ms = t.host_ms(lambda: eng.search(twin, q_last.to(dev), req))
    used = sum(r["staged_used"] for r in per_batch) * block_bytes
    missed = sum(r["blocks_bytes"] for r in per_batch)
    hidden = used / max(1, used + missed)
    t.log(f"[pager] the prefetch supplied {used / 1e6:.1f} of "
          f"{(used + missed) / 1e6:.1f} MB paged in ({hidden:.3f}); a batch "
          f"of resident shards {steady_ms:.3f} ms (no block copied), the "
          f"device twin's routed search {twin_ms:.3f} ms")
    return {"batches": per_batch, "launches": counts_all,
            "prefetch_share": hidden, "steady_ms": steady_ms,
            "twin_ms": twin_ms, "host_gb": gb,
            "phases_ms": {"pager_batch_median": statistics.median(
                r["ms"] for r in per_batch), "pager_steady": steady_ms}}


def _cpu_twin(store):
    """The same store's leaves on the host."""
    import dataclasses

    from repro_torch.engine.store import DATA_FIELDS
    return dataclasses.replace(store, **{f: getattr(store, f).cpu()
                                         for f in DATA_FIELDS})


class _SearchSpy:
    """Records every `RetrievalEngine.search` while `on`: (store, queries,
    request, result). `check()` searches each recorded store's host twin
    with backend "ref" on the same queries, and fails where the labels,
    votes or rows differ in any bit."""

    def __init__(self, engine_cls):
        self.cls, self.search = engine_cls, engine_cls.search
        self.calls, self.on, self._twins = [], False, {}
        spy = self

        def search(eng, store, queries, request=None):
            res = spy.search(eng, store, queries, request)
            if spy.on:
                spy.calls.append((store, queries.detach().clone(), request,
                                  res))
            return res
        engine_cls.search = search

    def close(self) -> None:
        self.cls.search = self.search

    def check(self, torch, what: str) -> int:
        for i, (store, q, req, res) in enumerate(self.calls):
            twin = self._twins.get(id(store))
            if twin is None:
                twin = self._twins[id(store)] = (store, _cpu_twin(store))
            want = self.search(self.cls(store.cfg.search, backend="ref"),
                               twin[1], q.cpu(), req)
            for f in ("labels", "votes", "indices"):
                if not torch.equal(getattr(res, f).cpu(), getattr(want, f)):
                    fail(f"[lm-serve] {what}: search {i} ({req}): the head's "
                         f"{f} differ from the host's plain route")
        n = len(self.calls)
        self.calls = []
        return n


def _lm_config(arch: str):
    """An arch's config as `[lm-serve]` runs it: full width (smoke in a
    CPU rehearsal), the depth cut to LM_DEPTH where it names the arch."""
    import dataclasses

    from repro_torch.configs import load_config
    cfg = load_config(arch, smoke=LM_SMOKE)
    if arch in LM_DEPTH:
        cfg = dataclasses.replace(cfg, n_layers=min(cfg.n_layers,
                                                    LM_DEPTH[arch]))
    return cfg


def _lm_inputs(torch, cfg, rng, B: int, S: int, P: int, dev) -> dict:
    """S positions of inputs for `cfg`, drawn with numpy: token ids, or
    frame / patch embeddings (normal) with, for M-RoPE, the position
    streams of a prompt of P patches in a grid 4 wide (temporal 0,
    height, width) followed by text, whose three streams all continue
    from the largest prompt position plus one (Qwen2-VL's rule)."""
    import numpy as np
    if cfg.input_mode == "tokens":
        return {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (B, S))).to(dev)}
    out = {"embeddings": torch.from_numpy(rng.standard_normal(
        (B, S, cfg.d_model), dtype=np.float32)).to(dev)}
    if cfg.rope_type == "mrope":
        i = np.arange(S)
        grid = np.stack([np.zeros(S), i // 4, i % 4], -1)
        text = grid[:P].max() + 1 + (i - P)
        pos3 = np.where((i < P)[:, None], grid, text[:, None])
        out["positions3"] = torch.from_numpy(np.broadcast_to(
            pos3.astype(np.int32), (B, S, 3)).copy()).to(dev)
    return out


def _embedding_serve(torch, cfg, B: int, S: int, P: int, retrieval: bool,
                     k: int, seed: int, dev):
    """`serve`'s decode loop for an arch of embedding inputs, which the
    reference's `serve` cannot feed (ROADMAP C.R4): the same random
    weights, caches and demo store, driven through `launch/steps`'
    `make_serve_step` or `make_serve_step_with_mcam` (two_phase) with an
    embeddings batch (and positions3) of P prompt and S more positions.
    Returns the argmax ids of the S decoded steps, (B, S)."""
    import numpy as np

    from repro_torch.engine import RetrievalEngine
    from repro_torch.launch import serve as serve_lib
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import transformer as tfm
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = tfm.init(gen, cfg)
    caches = tfm.init_cache(cfg, B, P + S, dev)
    step_fn = steps_lib.make_serve_step(cfg)
    store = None
    if retrieval:
        mem_cfg, store = serve_lib.demo_store(cfg, seed, dev)
        step_fn = steps_lib.make_serve_step_with_mcam(
            cfg, mem_cfg, engine=RetrievalEngine(mem_cfg.search), k=k)
    inputs = _lm_inputs(torch, cfg, np.random.default_rng(seed + 1), B,
                        P + S, P, dev)
    toks = []
    for pos in range(P + S):
        batch = {n: v[:, pos:pos + 1] for n, v in inputs.items()}
        args = (params, caches, batch, pos)
        logits, caches = step_fn(*args, store) if retrieval \
            else step_fn(*args)
        if pos >= P:
            toks.append(torch.argmax(logits[:, 0], -1)[:, None].cpu())
    if not torch.isfinite(logits.float()).all():
        raise RuntimeError(f"{cfg.name}: non-finite logits")
    return torch.cat(toks, 1).numpy()


def _decode_vs_forward(torch, cfg, params, inputs: dict, P: int,
                       max_seq: int, dev) -> tuple:
    """The first P positions of `inputs` fed through the plain serve step
    from empty caches, against one forward over them -> (the last step's
    logits, the caches, max |decode - forward|, max |forward|, the share
    of positions within LM_DECODE_ATOL). Fails on a non-finite logit."""
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import transformer as tfm
    plain = steps_lib.make_serve_step(cfg)
    caches = tfm.init_cache(cfg, inputs[next(iter(inputs))].shape[0],
                            max_seq, dev)
    dec = []
    for pos in range(P):
        logits, caches = plain(params, caches, {n: v[:, pos:pos + 1]
                                                for n, v in inputs.items()},
                               pos)
        dec.append(logits[:, 0])
    fwd = tfm.forward(params, cfg, {n: v[:, :P]
                                    for n, v in inputs.items()})[0]
    if not (torch.isfinite(fwd).all() and all(
            torch.isfinite(x).all() for x in dec)):
        fail(f"[lm-serve] {cfg.name}: non-finite logits")
    diff = (torch.stack(dec, 1).float() - fwd.float()).abs()
    within = float((diff.amax(-1) <= LM_DECODE_ATOL).float().mean())
    return (logits, caches, float(diff.max()),
            float(fwd.float().abs().max()), within)


def _prefill_cummax(t, prefill, params, prompt) -> dict:
    """One profiled prefill with `core/kinks.cummax` (the port's, C.P9:
    JAX's odd/even scan, for its gradient at ties) and one with
    `torch.cummax` in its place (the parent's forward): launches, device
    and wall ms of each. Fails unless both give the same logits' bits."""
    from repro_torch.core import kinks

    torch = t.torch
    scan = kinks.cummax
    out, logits = {}, []
    try:
        for name, fn in (("kinks.cummax", scan), ("torch.cummax", lambda x, d:
                                                  torch.cummax(x, d).values)):
            kinks.cummax = fn
            logits.append(prefill(params, prompt)[0])
            prof = _profile_search(t, lambda: prefill(params, prompt))
            out[name] = {k: prof[k] for k in ("kernel_launches",
                                              "device_ms", "wall_ms")}
    finally:
        kinks.cummax = scan
    if not torch.equal(*logits):
        fail("[lm-serve] the prefill's logits differ between kinks.cummax "
             "and torch.cummax")
    return out


def run_lm_serve(t, args, launches: dict, card: str) -> dict:
    """[lm-serve]: the LM serving entry point (`launch/serve.serve`, the
    kNN-LM head of `launch/steps.make_serve_step_with_mcam`) at full width
    on the card, random weights drawn on the card from the seed, each
    arch of LM_ARCHS in turn (the previous one freed; deepseek-v3-671b cut
    to LM_DEPTH layers, its widths the published ones): for starcoder2-3b
    the head's modes through `serve` (two_phase: the fused shortlist and
    the gathered physics over the 1,024-row demo store; ideal; dense;
    routed, LM_SHARDS shards at nprobe LM_NPROBE with the fused threshold
    at the rows a query visits: the block-table entry; two_phase on mxu
    below the fused threshold: the LUT product) and the plain decode,
    then the head over a token store of LM_STORE_ROWS rows; for the other
    token archs two_phase and the plain decode through `serve`; for the
    embedding archs (musicgen-medium, qwen2-vl-7b), whose inputs `serve`
    cannot feed (ROADMAP C.R4), the same loop through the step functions
    (`_embedding_serve`). Each run with the launch counts zeroed just
    before it and read just after; every search of the head is held, bit
    for bit in labels, votes and rows, against the same store searched on
    the host by the plain route with the same hidden rows. Then, per arch:
    decode over a prompt against forward over it (LM_DECODE_ATOL for the
    archs without MoE; the MoE archs' is reported: a last-bit difference
    can move a token's experts; LM_DECODE_F32's archs are held in float32),
    the decode step's time with and without
    the head (host-clock medians of LM_REPS), one profiled step of each
    (idle share, launches, device time by kind, the attention range), the
    peak memory and the step's weight-bytes bound (parameter bytes over
    HBM_BYTES_PER_S)."""
    import dataclasses
    import gc

    import numpy as np
    torch, dev, log = t.torch, t.dev, t.log
    from repro_torch.analysis.cost import HBM_BYTES_PER_S
    from repro_torch.core.memory import MemoryConfig
    from repro_torch.engine import MemoryStore, RetrievalEngine
    from repro_torch.kernels import _build
    from repro_torch.launch import serve as serve_lib
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import layers as layers_lib
    from repro_torch.models import transformer as tfm
    from repro_torch import tree as tree_lib

    B, P, S = LM_BATCH, LM_PROMPT, LM_STEPS
    routed_rows = 1024 // LM_SHARDS * LM_NPROBE
    head_runs = {"two_phase": ({}, ("shortlist", "mcam_rescore")),
                 "plain": (None, ())}
    runs = {
        "starcoder2-3b": {
            "two_phase": ({}, ("shortlist", "mcam_rescore")),
            "ideal": ({"retrieval_mode": "ideal"}, ("shortlist",)),
            "dense": ({"retrieval_mode": "dense"}, ()),
            "routed": ({"retrieval_shards": LM_SHARDS,
                        "retrieval_nprobe": LM_NPROBE,
                        "retrieval_fused_min_rows": routed_rows},
                       ("shortlist_blocks", "mcam_rescore")),
            "mxu": ({"retrieval_backend": "mxu",
                     "retrieval_fused_min_rows": 2048},
                    ("mcam_dist", "mcam_rescore")),
            "plain": (None, ())},
    }
    spy = _SearchSpy(RetrievalEngine)
    real_load_config = serve_lib.load_config
    out, phases_ms = {}, {}
    try:
        for arch in LM_ARCHS:
            cfg = _lm_config(arch)
            # `serve` loads the arch's config by name: hand it the cut one
            serve_lib.load_config = lambda a, smoke, c=cfg: c
            res = out[arch] = {"layers": cfg.n_layers,
                               "d_model": cfg.d_model, "runs": {},
                               "input_mode": cfg.input_mode}
            # -- the entry point, every mode ------------------------------
            for name, (kw, needs) in runs.get(arch, head_runs).items():
                _build.reset_launches()
                spy.on = True
                t0 = time.perf_counter()
                torch.cuda.reset_peak_memory_stats()
                if cfg.input_mode == "tokens":
                    toks = serve_lib.serve(
                        arch, LM_SMOKE, B, S, P, retrieval=kw is not None,
                        retrieval_k=LM_K, seed=args.seed, device=dev,
                        **(kw or {}))
                else:
                    toks = _embedding_serve(torch, cfg, B, S, P,
                                            kw is not None, LM_K,
                                            args.seed, dev)
                t.sync()
                wall = (time.perf_counter() - t0) * 1e3
                spy.on = False
                peak = torch.cuda.max_memory_allocated()
                counts = dict(_build.LAUNCHES)
                if any(counts[k] < 1 for k in needs):
                    fail(f"[lm-serve] {arch} {name}: launched {counts}, "
                         f"needs {needs}")
                _count(launches, counts)
                if toks.shape != (B, S):
                    fail(f"[lm-serve] {arch} {name}: tokens {toks.shape}")
                checked = spy.check(torch, f"{arch} {name}")
                if kw is not None and kw.get("retrieval_mode") != "dense" \
                        and checked != P + S:
                    fail(f"[lm-serve] {arch} {name}: {checked} searches, "
                         f"expected one a step ({P + S})")
                res["runs"][name] = {
                    "wall_ms": wall, "searches_checked": checked,
                    "peak_memory_bytes": peak,
                    "launches_a_step": {k: v / (P + S)
                                        for k, v in counts.items() if v}}
                phases_ms[f"lm_{arch}_{name}"] = wall
                entry = ("serve" if cfg.input_mode == "tokens"
                         else "the step functions")
                log(f"[lm-serve] {arch} {name}: {entry} {wall:.0f} ms "
                    f"(init, {P} + {S} steps), peak memory "
                    f"{peak / 1e9:.2f} GB, {checked} head searches "
                    f"equal to the host's plain route bit for bit, "
                    f"kernel launches a step "
                    f"{res['runs'][name]['launches_a_step']} ({card})")
            gc.collect()
            torch.cuda.empty_cache()

            # -- one model: decode vs forward, step times, a profile ------
            rng = np.random.default_rng(args.seed + 3)
            inputs = _lm_inputs(torch, cfg, rng, B, P + 1, P, dev)
            prompt = {n: v[:, :P] for n, v in inputs.items()}
            f32 = None
            if arch in LM_DECODE_F32:
                cfg32 = dataclasses.replace(cfg, dtype="float32",
                                            param_dtype="float32")
                params32 = tfm.init(torch.Generator(device=dev).manual_seed(
                    args.seed), cfg32)
                f32 = _decode_vs_forward(torch, cfg32, params32, inputs, P,
                                         P, dev)[2:]
                del params32
                if f32[0] > LM_DECODE_F32[arch]:
                    fail(f"[lm-serve] {arch}: float32 decode over the "
                         f"prompt differs from forward by {f32[0]} > "
                         f"{LM_DECODE_F32[arch]}")
            torch.cuda.reset_peak_memory_stats()
            gen = torch.Generator(device=dev).manual_seed(args.seed)
            params = tfm.init(gen, cfg)
            res["init_peak_memory_bytes"] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            leaves = tree_lib.leaves(params)
            n_params = sum(a.numel() for a in leaves)
            p_bytes = sum(a.numel() * a.element_size() for a in leaves)
            mem_cfg, store = serve_lib.demo_store(cfg, args.seed, dev)
            eng = RetrievalEngine(mem_cfg.search)
            plain = steps_lib.make_serve_step(cfg)
            head = steps_lib.make_serve_step_with_mcam(cfg, mem_cfg,
                                                       engine=eng, k=LM_K)
            logits, caches, gap, scale, within = _decode_vs_forward(
                torch, cfg, params, inputs, P, P + S, dev)
            held = cfg.moe is None and arch not in LM_DECODE_F32
            if held and gap > LM_DECODE_ATOL:
                fail(f"[lm-serve] {arch}: decode over the prompt differs "
                     f"from forward by {gap} > {LM_DECODE_ATOL}")
            nxt = {n: v[:, P:P + 1] for n, v in inputs.items()}
            if cfg.input_mode == "tokens":
                nxt = {"tokens": torch.argmax(logits[:, 0], -1)[:, None]}

            def plain_step():
                return plain(params, caches, nxt, P)

            def head_step(st=store):
                return head(params, caches, nxt, P, st)
            step_ms = t.host_ms(plain_step, reps=LM_REPS)
            head_ms = t.host_ms(head_step, reps=LM_REPS)
            attention = layers_lib.dot_attention

            def annotated(*a, **k):
                with torch.profiler.record_function(LM_ATTENTION_RANGE):
                    return attention(*a, **k)
            layers_lib.dot_attention = annotated
            try:
                prof = {name: _profile_search(t, fn, LM_KERNEL_KINDS,
                                              (LM_ATTENTION_RANGE,))
                        for name, fn in (("plain", plain_step),
                                         ("head", head_step))}
            finally:
                layers_lib.dot_attention = attention
            _build.reset_launches()
            spy.on = True
            head_step()
            t.sync()
            spy.on = False
            spy.check(torch, f"{arch} timed step")
            mcam_a_step = {k: v for k, v in _build.LAUNCHES.items() if v}
            bound_ms = p_bytes / HBM_BYTES_PER_S * 1e3
            res.update({
                "params": n_params, "param_bytes": p_bytes,
                "decode_vs_forward_max_abs": gap, "logit_max_abs": scale,
                "decode_vs_forward_held": held,
                "decode_vs_forward_within_atol": within,
                "decode_vs_forward_f32": f32,
                "step_ms": step_ms, "head_step_ms": head_ms,
                "tokens_per_s": B / step_ms * 1e3,
                "head_tokens_per_s": B / head_ms * 1e3,
                "weight_bytes_bound_ms": bound_ms,
                "mcam_launches_a_step": mcam_a_step, "profile": prof})
            log(f"[lm-serve] {arch}: {cfg.n_layers} layers, d "
                f"{cfg.d_model}, {n_params} parameters ({p_bytes / 1e9:.2f}"
                f" GB); decode over the prompt vs forward: max |diff| "
                f"{gap:.4f} of logits up to {scale:.2f} ("
                f"{'held to' if held else 'reported; atol'} "
                f"{LM_DECODE_ATOL}: {within:.3f} of positions within"
                + ("" if f32 is None else
                   f"; float32 {f32[0]:.6f} of logits up to {f32[1]:.2f}, "
                   f"held to {LM_DECODE_F32[arch]}") + "); "
                f"decode step {step_ms:.3f} ms "
                f"({B / step_ms * 1e3:.1f} tok/s), with the head "
                f"{head_ms:.3f} ms ({B / head_ms * 1e3:.1f} tok/s); "
                f"weight-bytes bound {bound_ms:.3f} ms ({card})")
            for name, pr in prof.items():
                log(f"[lm-serve] {arch} profiled {name} step: wall "
                    f"{pr['wall_ms']:.3f} ms, device {pr['device_ms']:.3f} "
                    f"ms, idle share {pr['idle_share']:.3f}, "
                    f"{pr['kernel_launches']} kernel launches, by kind "
                    f"{ {k: round(v, 4) for k, v in pr['device_ms_by_kind'].items()} }"
                    f", attention {pr.get('ranges_device_ms')}, top "
                    f"{pr['top_kernels'][:4]} ({card})")

            # -- mLSTM prefill: C.P9's cummax against torch.cummax --------
            if "mlstm" in cfg.layer_types():
                res["prefill_cummax"] = _prefill_cummax(
                    t, steps_lib.make_prefill_step(cfg), params, prompt)
                log(f"[lm-serve] {arch} profiled prefill (B {B} x P {P}): "
                    + "; ".join(f"{k} {v['kernel_launches']} launches, "
                                f"device {v['device_ms']:.3f} ms, wall "
                                f"{v['wall_ms']:.3f} ms"
                                for k, v in res["prefill_cummax"].items())
                    + f"; the same logits bit for bit ({card})")

            # -- the head over a token store of LM_STORE_ROWS rows --------
            if arch == LM_ARCHS[0]:
                big_cfg = MemoryConfig(capacity=LM_STORE_ROWS,
                                       dim=mem_cfg.dim,
                                       search=mem_cfg.search)
                vecs = rng.standard_normal((LM_STORE_ROWS, mem_cfg.dim),
                                           dtype=np.float32)
                ids = rng.integers(0, cfg.vocab_size, LM_STORE_ROWS)
                big = MemoryStore.create(big_cfg, device=dev).calibrate(
                    vecs).write(vecs, ids)
                cache2 = tfm.init_cache(cfg, B, P + S, dev)
                _build.reset_launches()
                spy.on = True
                tok = prompt["tokens"][:, :1]
                for pos in range(P + S):
                    mixed, cache2 = head(params, cache2, {"tokens": tok},
                                         pos, big)
                    tok = (prompt["tokens"][:, pos + 1:pos + 2]
                           if pos + 1 < P
                           else torch.argmax(mixed[:, 0], -1)[:, None])
                t.sync()
                spy.on = False
                counts = dict(_build.LAUNCHES)
                if any(counts[k] < 1 for k in ("shortlist",
                                               "mcam_rescore")):
                    fail(f"[lm-serve] {arch} token store: launched "
                         f"{counts}")
                _count(launches, counts)
                if not torch.isfinite(mixed).all():
                    fail(f"[lm-serve] {arch} token store: non-finite")
                checked = spy.check(torch, f"{arch} token store")
                big_ms = t.host_ms(lambda: head_step(big), reps=LM_REPS)
                res["token_store"] = {
                    "rows": LM_STORE_ROWS, "dim": mem_cfg.dim,
                    "searches_checked": checked, "head_step_ms": big_ms,
                    "launches_a_step": {k: v / (P + S)
                                        for k, v in counts.items() if v}}
                log(f"[lm-serve] {arch} token store of {LM_STORE_ROWS} "
                    f"rows at d = {mem_cfg.dim}: {checked} head searches "
                    f"equal to the host's plain route bit for bit; decode "
                    f"step with the head {big_ms:.3f} ms "
                    f"({B / big_ms * 1e3:.1f} tok/s) ({card})")
                del big, cache2
            res["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
            log(f"[lm-serve] {arch}: peak memory "
                f"{res['peak_memory_bytes'] / 1e9:.2f} GB serving, "
                f"{res['init_peak_memory_bytes'] / 1e9:.2f} GB in init "
                f"({card})")
            del params, leaves, store, caches, logits, inputs, prompt, nxt
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        spy.close()
        serve_lib.load_config = real_load_config
    out["phases_ms"] = phases_ms
    return out


class _TrainSpy:
    """Wraps `launch/steps.make_train_step` until `close()`: each step of
    the step functions it makes is synchronised and timed on the host
    clock and its metrics read after it (`records`), the last step's
    (the wrapped step function, params, opt_state, batch) kept."""

    def __init__(self, t, steps_lib):
        self.t, self.lib, self.real = t, steps_lib, steps_lib.make_train_step
        self.records, self.last = [], None
        steps_lib.make_train_step = self._make

    def _make(self, cfg, tc, **kw):
        step_fn, optimizer = self.real(cfg, tc, **kw)

        def spied(params, opt_state, batch):
            self.t.sync()
            t0 = time.perf_counter()
            out = step_fn(params, opt_state, batch)
            self.t.sync()
            ms = (time.perf_counter() - t0) * 1e3
            self.records.append({"ms": ms, **{k: float(v) for k, v in
                                              out[2].items()}})
            self.last = (spied, out[0], out[1], batch)
            return out
        self.cfg = cfg
        return spied, optimizer

    def reset(self) -> None:
        self.records, self.last = [], None

    def close(self) -> None:
        self.lib.make_train_step = self.real


def _checksums(torch, tree) -> list:
    """Per leaf, two sums over its bits (as integers, one weighted by the
    position mod 65,521), in int64 and in chunks: equal lists mean equal
    leaves but for a collision. A placed leaf is assembled first, one at a
    time."""
    from repro_torch import tree as tree_lib
    from repro_torch.models.sharding import Placed
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = []
    for leaf in tree_lib.leaves(tree):
        leaf = leaf.full() if isinstance(leaf, Placed) else leaf
        flat = leaf.detach().reshape(-1)
        if flat.is_floating_point():
            flat = flat.view(ints[flat.element_size()])
        a = b = 0
        for c0 in range(0, flat.numel(), 1 << 26):
            part = flat[c0:c0 + (1 << 26)].to(torch.int64)
            w = (torch.arange(c0, c0 + part.numel(), device=part.device)
                 % 65521) + 1
            a += int(part.sum())
            b += int((part * w).sum())
        out.append((a, b))
    return out


def _train_bound(cfg, params, tokens: int) -> tuple[int, float]:
    """(parameters a token multiplies, the step's useful-work bound in
    ms): 6 N T FLOP at the bf16 tensor peak, N every parameter but the
    routed experts' unchosen share (top_k / n_routed of them count) and
    an untied input embedding (a lookup, no product; a tied one is the
    output layer's matrix and counts once)."""
    from repro_torch.analysis.cost import BF16_TENSOR_OPS_PER_S
    from repro_torch import tree as tree_lib
    names, leaves = tree_lib.flatten_with_names(params)
    n = sum(a.numel() for nm, a in zip(names, leaves)
            if cfg.tie_embeddings or nm != "embed")
    if cfg.moe is not None:
        routed = sum(a.numel() for nm, a in zip(names, leaves)
                     if "//moe//we" in nm)
        n -= round(routed * (1 - cfg.moe.top_k / cfg.moe.n_routed))
    return n, 6 * n * tokens / BF16_TENSOR_OPS_PER_S * 1e3


def run_lm_train(t, args, card: str) -> dict:
    """[lm-train]: LM training through the trainer's entry point
    (`launch/train.train(arch, smoke=False, ...)`, random weights drawn on
    the card from the seed, SyntheticLM batches or stub embeddings), each
    arch of LM_TRAIN at full width (deepseek-moe-16b cut in depth, handed
    to `train` by swapping its `load_config`) under the trainer's
    deterministic settings: LM_TRAIN's steps, each with a finite loss, a
    finite gradient norm and `applied` 1; starcoder2-3b's loss falls (the mean of the last
    LM_TRAIN_FALL below the first); a second run from the
    same seed gives the same per-leaf checksums of the parameters and the
    optimizer state and the same losses (the first run's state freed
    first). Then, on the second run's state: step ms (host-clock median
    but the first step), tokens/s and MFU against 6 N T at the bf16
    tensor peak, one profiled step (idle share, launches, device ms by
    kind), peak memory against the state's bytes (weights, gradients and
    optimizer state); starcoder2-3b also steps at microbatch
    LM_TRAIN_MICRO (accumulation over 2). The guard: a smoke model with
    an inf in one weight steps with `applied` 0 and leaves every
    parameter and state leaf's bits as they were. No MCAM kernel may
    launch in the phase."""
    import dataclasses
    import gc
    import tempfile

    torch, dev, log = t.torch, t.dev, t.log
    from repro_torch import tree as tree_lib
    from repro_torch.configs import load_config
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.data.lm import LMDataConfig, SyntheticLM
    from repro_torch.kernels import _build
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train as train_lib
    from repro_torch.models import layers as layers_lib

    out, phases_ms = {}, {}
    spy = _TrainSpy(t, steps_lib)
    real_load_config = train_lib.load_config
    _build.reset_launches()
    try:
        for arch, (depth, B, S, n_steps) in LM_TRAIN.items():
            cfg = load_config(arch, smoke=LM_SMOKE)
            if depth:
                cfg = dataclasses.replace(cfg, n_layers=min(cfg.n_layers,
                                                            depth))
            train_lib.load_config = lambda a, smoke, c=cfg: c
            runs = []
            for run in range(2):
                spy.reset()
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                with tempfile.TemporaryDirectory() as ckpt:
                    losses = train_lib.train(arch, LM_SMOKE, n_steps, B, S,
                                             ckpt, device=dev)
                wall = (time.perf_counter() - t0) * 1e3
                recs = spy.records
                if len(recs) != n_steps or any(
                        not math.isfinite(r["loss"]) or r["applied"] != 1.0
                        or not math.isfinite(r["grad_norm"])
                        for r in recs):
                    fail(f"[lm-train] {arch} run {run}: steps {recs}")
                _, params, opt_state, _ = spy.last
                sums = _checksums(torch, (params, opt_state))
                runs.append({"losses": losses, "wall_ms": wall,
                             "peak": torch.cuda.max_memory_allocated(),
                             "sums": sums,
                             "step_ms": [r["ms"] for r in recs],
                             "grad_norms": [r["grad_norm"] for r in recs]})
                if run == 0:
                    del params, opt_state
                    spy.reset()
            a, b = runs
            if a["sums"] != b["sums"] or a["losses"] != b["losses"]:
                bad = [i for i, (x, y) in enumerate(zip(a["sums"],
                                                        b["sums"])) if x != y]
                fail(f"[lm-train] {arch}: the rerun differs: losses "
                     f"{a['losses']} vs {b['losses']}, leaves {bad[:8]}")
            losses = b["losses"]
            if arch == "starcoder2-3b" and not (
                    statistics.mean(losses[-LM_TRAIN_FALL:]) < losses[0]):
                fail(f"[lm-train] {arch}: the loss did not fall: {losses}")
            step_fn, params, opt_state, batch = spy.last
            cfg = spy.cfg
            n_active, bound_ms = _train_bound(cfg, params, B * S)
            p_bytes = sum(x.numel() * x.element_size()
                          for x in tree_lib.leaves(params))
            s_bytes = 2 * p_bytes + sum(x.numel() * x.element_size()
                                        for x in tree_lib.leaves(opt_state))
            step_ms = statistics.median(b["step_ms"][1:])
            # one profiled step (two steps run: one left out)
            attention = layers_lib.dot_attention

            def annotated(*a_, **k_):
                with torch.profiler.record_function(LM_ATTENTION_RANGE):
                    return attention(*a_, **k_)
            layers_lib.dot_attention = annotated
            try:
                prof = _profile_search(
                    t, lambda: step_fn(params, opt_state, batch),
                    LM_TRAIN_KERNEL_KINDS, (LM_ATTENTION_RANGE,))
            finally:
                layers_lib.dot_attention = attention
            res = out[arch] = {
                "layers": cfg.n_layers, "d_model": cfg.d_model,
                "batch": B, "seq": S, "remat": cfg.remat,
                "params": sum(x.numel() for x in tree_lib.leaves(params)),
                "params_per_token": n_active, "param_bytes": p_bytes,
                "state_bytes": s_bytes, "losses": losses,
                "grad_norms": b["grad_norms"], "step_ms_all": b["step_ms"],
                "step_ms": step_ms, "tokens_per_s": B * S / step_ms * 1e3,
                "bound_ms": bound_ms, "mfu": bound_ms / step_ms,
                "peak_memory_bytes": b["peak"],
                "rerun_bit_for_bit": True, "profile": prof,
                "applied": [1.0] * len(losses)}
            phases_ms[f"lm_train_{arch}"] = b["wall_ms"]
            log(f"[lm-train] {arch}: {cfg.n_layers} layers, d "
                f"{cfg.d_model}, B {B} x S {S}, remat {cfg.remat}, "
                f"{res['params']} parameters ({n_active} a token); losses "
                f"{[round(x, 4) for x in losses]}, grad norms "
                f"{[round(x, 3) for x in b['grad_norms']]}; rerun bit for "
                f"bit "
                f"({len(b['sums'])} leaves of params and state); step "
                f"{step_ms:.1f} ms ({res['tokens_per_s']:.0f} tok/s), bound "
                f"6NT {bound_ms:.1f} ms, MFU {res['mfu']:.3f}; peak memory "
                f"{b['peak'] / 1e9:.2f} GB against {s_bytes / 1e9:.2f} GB "
                f"of weights, gradients and optimizer state ({card})")
            kinds = {k: round(v, 3)
                     for k, v in prof["device_ms_by_kind"].items()}
            log(f"[lm-train] {arch} profiled step: wall "
                f"{prof['wall_ms']:.1f} ms, device {prof['device_ms']:.1f} "
                f"ms, idle share {prof['idle_share']:.3f}, "
                f"{prof['kernel_launches']} kernel launches, by kind "
                f"{kinds}"
                f", attention forward {prof.get('ranges_device_ms')}, top "
                f"{prof['top_kernels'][:4]} ({card})")

            # -- gradient accumulation at width: microbatch LM_TRAIN_MICRO
            if arch == "starcoder2-3b":
                accum = B // LM_TRAIN_MICRO
                shape = ShapeConfig("custom", S, B, "train",
                                    microbatch=LM_TRAIN_MICRO)
                data = SyntheticLM(LMDataConfig(S, B, cfg.vocab_size))
                spy.reset()
                for step in range(LM_TRAIN_MICRO_STEPS):
                    mb = train_lib.make_batch(cfg, shape, data,
                                              n_steps + step, accum,
                                              LM_TRAIN_MICRO, dev)
                    params, opt_state, _ = step_fn(params, opt_state, mb)
                    t.sync()
                micro = spy.records
                if len(micro) != LM_TRAIN_MICRO_STEPS or any(
                        not math.isfinite(r["loss"]) or r["applied"] != 1.0
                        for r in micro):
                    fail(f"[lm-train] {arch} accum {accum}: {micro}")
                ms = statistics.median(r["ms"] for r in micro[1:])
                res["accum"] = {"microbatch": LM_TRAIN_MICRO,
                                "accum": accum, "step_ms": ms,
                                "losses": [r["loss"] for r in micro],
                                "tokens_per_s": B * S / ms * 1e3,
                                "mfu": bound_ms / ms}
                log(f"[lm-train] {arch} microbatch {LM_TRAIN_MICRO} "
                    f"(accum {accum}): step {ms:.1f} ms "
                    f"({B * S / ms * 1e3:.0f} tok/s), MFU "
                    f"{bound_ms / ms:.3f} ({card})")
            del step_fn, params, opt_state, batch
            spy.reset()
            gc.collect()
            torch.cuda.empty_cache()

        # -- the guard: a non-finite step changes nothing -----------------
        cfg = load_config(LM_TRAIN_GUARD_ARCH, smoke=True)
        step_fn, optimizer = steps_lib.make_train_step(
            cfg, TrainConfig(learning_rate=1e-3))
        from repro_torch.models import transformer as tfm
        params = tfm.init(torch.Generator(device=dev).manual_seed(
            args.seed), cfg)
        opt_state = optimizer.init(params)
        tree_lib.leaves(params)[-1].view(-1)[0] = float("inf")
        before = [x.clone() for x in tree_lib.leaves((params, opt_state))]
        data = SyntheticLM(LMDataConfig(16, 4, cfg.vocab_size))
        batch = train_lib.make_batch(
            cfg, ShapeConfig("custom", 16, 4, "train"), data, 0, 1, 4, dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        after = tree_lib.leaves((params, opt_state))
        same = all(torch.equal(x.view(-1).view(torch.uint8)
                               if x.is_floating_point() else x,
                               y.view(-1).view(torch.uint8)
                               if y.is_floating_point() else y)
                   for x, y in zip(before, after))
        applied = float(metrics["applied"])
        if applied != 0.0 or not same:
            fail(f"[lm-train] guard: applied {applied}, state unchanged "
                 f"{same}")
        out["guard"] = {"arch": cfg.name, "applied": applied,
                        "unchanged_bit_for_bit": same,
                        "loss": float(metrics["loss"])}
        log(f"[lm-train] guard: {cfg.name} with an inf weight: loss "
            f"{float(metrics['loss'])}, applied {applied}, every parameter "
            f"and state leaf unchanged bit for bit")
    finally:
        spy.close()
        train_lib.load_config = real_load_config
    counts = {k: v for k, v in _build.LAUNCHES.items() if v}
    if counts:
        fail(f"[lm-train] launched MCAM kernels: {counts}")
    out["mcam_launches"] = 0
    out["phases_ms"] = phases_ms
    return out


def _held_bytes(tree, positions) -> dict:
    """Bytes of a placed tree: per mesh position (the blocks it holds),
    of every block stored once (replicas and blocks shared by positions
    on one device once), and of the leaves themselves."""
    from repro_torch import tree as tree_lib
    from repro_torch.models.sharding import Placed
    leaves = [x for x in tree_lib.leaves(tree) if isinstance(x, Placed)]
    return {"per_position": [sum(x.nbytes_at(pos) for x in leaves)
                             for pos in positions],
            "stored": sum(x.nbytes for x in leaves),
            "leaves": sum(x.numel() * x.block(positions[0]).element_size()
                          for x in leaves)}


def run_lm_mesh(t, args, card: str, store, queries, hat_episode: dict,
                launches: dict) -> dict:
    """[lm-mesh]: the LM's sharding layer on meshes of positions of the
    card. (1) starcoder2-3b's train step at full width (B LM_MESH_B x
    LM_MESH_S, the trainer's settings) on the reference test's (2, 2, 2)
    pod / data / model mesh under `active_mesh`: parameters and state
    placed by `param_shardings` / `opt_shardings`, batches by
    `input_specs`; LM_MESH_STEPS steps equal the unplaced step's bit for
    bit (losses, grad norms, every parameter and state leaf's checksums);
    each side's step ms, one profiled step (idle share, launches), peak
    memory, and the placed side's bytes per position against its leaves'.
    (1b) The elastic restore (`_lm_elastic_restore`). (2)
    `train(model_parallel=2)` for LM_MESH_TRAIN_STEPS steps equals
    `model_parallel=1` bit for bit (one card: a (1, 1) host mesh). (3)
    The Omniglot meta step of [hat]'s episode placed over a (4,) "data"
    mesh equals the unplaced step bit for bit. (4) `pipeline_apply` of
    tanh(h @ W) stages at d = PIPE_D over a (4,) "pipe" mesh equals the
    sequential loop over each microbatch bit for bit. (5) The legacy
    shim `core.memory.distributed_search` on the main store over (8,)
    equals the unsharded two_phase search bit for bit."""
    import contextlib
    import gc
    import tempfile
    import warnings

    import numpy as np
    torch, dev, log = t.torch, t.dev, t.log
    from repro_torch.configs import load_config
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.configs.omniglot_conv4 import get_config
    from repro_torch.core import memory as mem_lib
    from repro_torch.data.lm import LMDataConfig, SyntheticLM
    from repro_torch.engine import RetrievalEngine, SearchRequest
    from repro_torch.kernels import _build
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train as train_lib
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.models.controller import apply_conv4
    from repro_torch.models.sharding import active_mesh, place, rules_for_mesh
    from repro_torch.optim import adamw
    from repro_torch.runtime.pipeline import pipeline_apply

    out, phases_ms = {}, {}
    t0_phase = time.perf_counter()

    # -- (1) the train step placed on (2, 2, 2) against the unplaced step ---
    B, S = LM_MESH_B, LM_MESH_S
    mesh = Mesh.repeat(dev, *LM_MESH)
    positions = list(np.ndindex(mesh.devices.shape))
    rules = rules_for_mesh(mesh)
    shape = ShapeConfig("custom", S, B, "train")
    dp = int(np.prod([mesh.shape[a] for a in rules.batch]))
    cfg = steps_lib.adapt_config(load_config(LM_MESH_ARCH, smoke=LM_SMOKE),
                                 shape, dp)
    tc = TrainConfig(learning_rate=1e-3 if LM_SMOKE else 3e-4)
    data = SyntheticLM(LMDataConfig(S, B, cfg.vocab_size))
    batches = [train_lib.make_batch(cfg, shape, data, step, 1, B, dev)
               for step in range(LM_MESH_STEPS)]
    runs = {}
    _build.reset_launches()
    for placed in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        ctx = active_mesh(mesh, rules) if placed else contextlib.nullcontext()
        with ctx:
            step_fn, optimizer = steps_lib.make_train_step(
                cfg, tc, rules=rules if placed else None)
            params = tfm.init(torch.Generator(device=dev).manual_seed(
                args.seed), cfg)
            inputs, held = batches, None
            if placed:
                aps = tfm.abstract_params(cfg)
                psh = steps_lib.param_shardings(cfg, mesh, rules)
                params = place(params, psh)
                opt_state = place(optimizer.init(params),
                                  steps_lib.opt_shardings(
                                      optimizer.init(aps), aps, psh, mesh,
                                      rules))
                specs = steps_lib.input_specs(cfg, shape, mesh, rules)
                inputs = [place(b, {k: v.sharding for k, v in specs.items()})
                          for b in batches]
                held = _held_bytes((params, opt_state), positions)
            else:
                opt_state = optimizer.init(params)
            gc.collect()
            torch.cuda.reset_peak_memory_stats()
            recs = []
            for b in inputs:
                t.sync()
                t0 = time.perf_counter()
                params, opt_state, m = step_fn(params, opt_state, b)
                t.sync()
                recs.append({"ms": (time.perf_counter() - t0) * 1e3,
                             **{k: float(v) for k, v in m.items()}})
            peak = torch.cuda.max_memory_allocated()
            sums = _checksums(torch, (params, opt_state))
            prof = _profile_search(
                t, lambda: step_fn(params, opt_state, inputs[-1]),
                LM_TRAIN_KERNEL_KINDS)
        runs[placed] = {"losses": [r["loss"] for r in recs],
                        "grad_norms": [r["grad_norm"] for r in recs],
                        "applied": [r["applied"] for r in recs],
                        "step_ms_all": [r["ms"] for r in recs],
                        "step_ms": statistics.median(r["ms"]
                                                     for r in recs[1:]),
                        "peak_memory_bytes": peak, "sums": sums,
                        "held_bytes": held,
                        "profile": {k: prof[k] for k in (
                            "wall_ms", "device_ms", "idle_share",
                            "kernel_launches", "device_ms_by_kind")}}
        del step_fn, params, opt_state, inputs, m, prof
    a, b = runs[False], runs[True]
    if (a["losses"] != b["losses"] or a["grad_norms"] != b["grad_norms"]
            or a["sums"] != b["sums"]
            or any(x != 1.0 or not math.isfinite(y) for x, y in zip(
                a["applied"] + b["applied"], a["losses"] + b["losses"]))):
        bad = [i for i, (x, y) in enumerate(zip(a["sums"], b["sums"]))
               if x != y]
        fail(f"[lm-mesh] the placed step differs from the unplaced: losses "
             f"{a['losses']} vs {b['losses']}, norms {a['grad_norms']} vs "
             f"{b['grad_norms']}, leaves {bad[:8]}")
    for r in runs.values():
        r.pop("sums")
    out["train_step"] = {"arch": cfg.name, "mesh": list(LM_MESH[0]),
                         "axes": list(LM_MESH[1]), "batch": B, "seq": S,
                         "unplaced": a, "placed": b, "bit_for_bit": True}
    held = b["held_bytes"]
    log(f"[lm-mesh] {cfg.name} B {B} x S {S} on {LM_MESH[0]} "
        f"{LM_MESH[1]} positions of the card: {LM_MESH_STEPS} steps equal "
        f"the unplaced step bit for bit (losses "
        f"{[round(x, 4) for x in b['losses']]}, grad norms "
        f"{[round(x, 3) for x in b['grad_norms']]}, every parameter and "
        f"state leaf); step {b['step_ms']:.1f} ms placed, "
        f"{a['step_ms']:.1f} ms unplaced; peak "
        f"{b['peak_memory_bytes'] / 1e9:.2f} / "
        f"{a['peak_memory_bytes'] / 1e9:.2f} GB; bytes a position "
        f"{min(held['per_position']) / 1e9:.3f}-"
        f"{max(held['per_position']) / 1e9:.3f} GB, stored "
        f"{held['stored'] / 1e9:.2f} GB against "
        f"{held['leaves'] / 1e9:.2f} GB of leaves ({card})")
    for name, r in (("placed", b), ("unplaced", a)):
        pr = r["profile"]
        log(f"[lm-mesh] {name} profiled step: wall {pr['wall_ms']:.1f} ms, "
            f"device {pr['device_ms']:.1f} ms, idle share "
            f"{pr['idle_share']:.3f}, {pr['kernel_launches']} kernel "
            f"launches, by kind "
            f"{ {k: round(v, 3) for k, v in pr['device_ms_by_kind'].items()} }"
            f" ({card})")
    phases_ms["lm_mesh_step_placed"] = b["step_ms"]
    phases_ms["lm_mesh_step_unplaced"] = a["step_ms"]
    gc.collect()
    torch.cuda.empty_cache()

    # -- (1b) elastic restore: saved on (2, 2, 2), restored onto (8,) ------
    out["elastic_restore"] = _lm_elastic_restore(t, args, card)
    phases_ms["lm_mesh_ckpt_save"] = out["elastic_restore"]["save_ms"]
    phases_ms["lm_mesh_ckpt_restore"] = out["elastic_restore"]["restore_ms"]
    gc.collect()
    torch.cuda.empty_cache()

    # -- (2) train(model_parallel=2) against model_parallel=1 -------------
    spy = _TrainSpy(t, steps_lib)
    mp_runs = {}
    try:
        for mp in (1, 2):
            spy.reset()
            gc.collect()
            torch.cuda.empty_cache()
            with tempfile.TemporaryDirectory() as ckpt:
                losses = train_lib.train(LM_MESH_ARCH, LM_SMOKE,
                                         LM_MESH_TRAIN_STEPS, B, S, ckpt,
                                         model_parallel=mp, device=dev)
            _, p_, o_, _ = spy.last
            mp_runs[mp] = {"losses": losses,
                           "grad_norms": [r["grad_norm"]
                                          for r in spy.records],
                           "step_ms": [r["ms"] for r in spy.records],
                           "sums": _checksums(torch, (p_, o_))}
            del p_, o_
            spy.reset()
    finally:
        spy.close()
    if (mp_runs[1]["losses"] != mp_runs[2]["losses"]
            or mp_runs[1]["sums"] != mp_runs[2]["sums"]):
        fail(f"[lm-mesh] train(model_parallel=2) differs from 1: "
             f"{mp_runs[1]['losses']} vs {mp_runs[2]['losses']}")
    for r in mp_runs.values():
        r.pop("sums")
    out["train_model_parallel"] = {"1": mp_runs[1], "2": mp_runs[2],
                                   "bit_for_bit": True}
    log(f"[lm-mesh] train({LM_MESH_ARCH}, model_parallel=2) on a (1, 1) "
        f"host mesh: {LM_MESH_TRAIN_STEPS} steps equal model_parallel=1 bit "
        f"for bit (losses {mp_runs[2]['losses']}, every parameter and "
        f"state leaf); steps {[round(x, 1) for x in mp_runs[2]['step_ms']]}"
        f" ms ({card})")
    gc.collect()
    torch.cuda.empty_cache()

    # -- (3) the HAT meta step on a (4,) "data" mesh -----------------------
    fsl = get_config()
    hat_cfg = train_lib.hat_config(fsl)
    hat = {}
    for m_ in (None, Mesh.repeat(dev, HAT_MESH, ("data",))):
        meta_opt = adamw(1e-4, weight_decay=1e-4)
        _, meta_step, place_fn = steps_lib.make_hat_train_steps(
            apply_conv4, hat_cfg, meta_opt, n_way=fsl.n_way, device=dev,
            mesh=m_)
        params = {"backbone": train_lib.init_params(
            fsl, fsl.n_train_classes, args.seed, HAT_WIDTH, dev)["backbone"]}
        state = meta_opt.init(params)
        arrays = place_fn(hat_episode)
        key = train_lib.step_key(args.seed, 0)
        meta_step(params, state, arrays, key)     # warm-up (out of place)
        _build.reset_launches()
        t.sync()
        t0 = time.perf_counter()
        params, state, loss = meta_step(params, state, arrays, key)
        t.sync()
        ms = (time.perf_counter() - t0) * 1e3
        counts = {k: v for k, v in _build.LAUNCHES.items() if v}
        _count(launches, counts)
        hat["placed" if m_ is not None else "unplaced"] = {
            "loss": float(loss), "ms": ms, "launches": counts,
            "sums": _checksums(torch, (params, state))}
    if (hat["placed"]["loss"] != hat["unplaced"]["loss"]
            or hat["placed"]["sums"] != hat["unplaced"]["sums"]):
        fail(f"[lm-mesh] the placed HAT meta step differs: {hat}")
    for r in hat.values():
        r.pop("sums")
    out["hat_meta_step"] = {**hat, "mesh": list(HAT_MESH),
                            "bit_for_bit": True}
    log(f"[lm-mesh] HAT meta step ({fsl.n_way}-way {fsl.k_shot}-shot) with "
        f"the episode placed on {HAT_MESH} data positions: loss "
        f"{hat['placed']['loss']:.6f}, equal to the unplaced step bit for "
        f"bit; {hat['placed']['ms']:.1f} / {hat['unplaced']['ms']:.1f} ms "
        f"(after a warm-up call), launches {hat['placed']['launches']} "
        f"({card})")

    # -- (4) the pipeline over (4,) stages -----------------------------------
    pmesh = Mesh.repeat(dev, (PIPE_STAGES,), ("pipe",))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    Ws = torch.randn((PIPE_STAGES, PIPE_D, PIPE_D), generator=gen,
                     device=dev) / math.sqrt(PIPE_D)
    x = torch.randn((PIPE_MICRO, PIPE_ROWS, PIPE_D), generator=gen,
                    device=dev)

    def stage(W, h):
        return torch.tanh(h @ W)

    def sequential():
        outs = []
        for mb in range(PIPE_MICRO):
            h = x[mb]
            for i in range(PIPE_STAGES):
                h = stage(Ws[i], h)
            outs.append(h)
        return torch.stack(outs)
    got = pipeline_apply(stage, Ws, x, pmesh)
    want = sequential()
    t.sync()
    if not torch.equal(got, want):
        fail(f"[lm-mesh] pipeline_apply differs from the sequential loop: "
             f"max abs {float((got - want).abs().max())}")
    pipe_ms = t.host_ms(lambda: pipeline_apply(stage, Ws, x, pmesh))
    seq_ms = t.host_ms(sequential)
    out["pipeline"] = {"stages": PIPE_STAGES, "microbatches": PIPE_MICRO,
                       "rows": PIPE_ROWS, "d": PIPE_D, "bit_for_bit": True,
                       "ms": pipe_ms, "sequential_ms": seq_ms}
    log(f"[lm-mesh] pipeline_apply: {PIPE_STAGES} tanh(h @ W) stages of d "
        f"{PIPE_D} over {PIPE_MICRO} microbatches of {PIPE_ROWS} rows on "
        f"(4,) pipe positions equals the sequential loop bit for bit; "
        f"{pipe_ms:.2f} ms against {seq_ms:.2f} ms ({card})")
    del Ws, x, got, want

    # -- (5) the legacy shim distributed_search over (8,) ------------------
    smesh = Mesh.repeat(dev, SHIM_MESH, ("data",))
    state = store.to_state()
    req = SearchRequest(mode="two_phase", k=64)
    want = RetrievalEngine(store.cfg.search).search(store, queries, req)

    def shim():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            return mem_lib.distributed_search(state, queries, store.cfg,
                                              smesh, axes=("data",), k=64)
    _build.reset_launches()
    got = shim()
    t.sync()
    counts = {k: v for k, v in _build.LAUNCHES.items() if v}
    _count(launches, counts)
    if not all(torch.equal(got[k], getattr(want, k)) for k in LEAVES):
        fail("[lm-mesh] distributed_search differs from the unsharded "
             "two_phase search")
    shim_ms = t.host_ms(shim, reps=3)
    out["shims"] = {"rows": store.capacity, "mesh": list(SHIM_MESH),
                    "bit_for_bit": True, "launches": counts,
                    "distributed_search_ms": shim_ms}
    log(f"[lm-mesh] core.memory.distributed_search on {store.capacity} rows "
        f"over {SHIM_MESH} data positions equals the unsharded two_phase "
        f"bit for bit; launches {counts}; {shim_ms:.2f} ms a call (host "
        f"clock, from the dict state: rebuilds the packed table and the "
        f"shards) ({card})")
    phases_ms["lm_mesh"] = (time.perf_counter() - t0_phase) * 1e3
    out["phases_ms"] = phases_ms
    return out


def _lm_elastic_restore(t, args, card: str) -> dict:
    """starcoder2-3b at full width cut to LM_RESTORE_LAYERS layers: one
    step placed on LM_MESH, then its train state (bf16 parameters and
    the optimizer's float32 state, 3.43 GB) saved as one checkpoint tile
    a block to a
    temporary directory, restored onto LM_RESTORE_MESH with `shardings=`
    (each leaf assembled on the host, then placed) and the directory
    removed. The restored leaves must equal the saved ones, and the next
    step on them (under the new mesh's rules) must equal the next step of
    the state that was never saved, loss and every leaf bit for bit ->
    {save_ms, restore_ms, bytes, tiles, loss, ...}."""
    import tempfile

    import numpy as np
    torch, dev = t.torch, t.dev
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import load_config
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.data.lm import LMDataConfig, SyntheticLM
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train as train_lib
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.models.sharding import (Rules, active_mesh, place,
                                             rules_for_mesh)

    B, S = LM_MESH_B, LM_MESH_S
    shape = ShapeConfig("custom", S, B, "train")
    cfg = steps_lib.adapt_config(dataclasses.replace(
        load_config(LM_MESH_ARCH, smoke=LM_SMOKE),
        n_layers=LM_RESTORE_LAYERS), shape, 1)
    tc = TrainConfig(learning_rate=1e-3 if LM_SMOKE else 3e-4)
    data = SyntheticLM(LMDataConfig(S, B, cfg.vocab_size))
    batches = [train_lib.make_batch(cfg, shape, data, step, 1, B, dev)
               for step in range(2)]
    aps = tfm.abstract_params(cfg)
    src, dst = Mesh.repeat(dev, *LM_MESH), Mesh.repeat(dev, *LM_RESTORE_MESH)
    layouts = {"saved": (src, rules_for_mesh(src)),
               "restored": (dst, Rules(tensor=(), expert=()))}

    def shardings(name, optimizer):
        mesh, rules = layouts[name]
        psh = steps_lib.param_shardings(cfg, mesh, rules)
        specs = steps_lib.input_specs(cfg, shape, mesh, rules)
        return ({"params": psh, "opt": steps_lib.opt_shardings(
                    optimizer.init(aps), aps, psh, mesh, rules)},
                {k: v.sharding for k, v in specs.items()})

    mesh, rules = layouts["saved"]
    with active_mesh(mesh, rules):
        step_fn, optimizer = steps_lib.make_train_step(cfg, tc, rules=rules)
        sh, bsh = shardings("saved", optimizer)
        params = place(tfm.init(torch.Generator(device=dev).manual_seed(
            args.seed), cfg), sh["params"])
        state = {"params": params,
                 "opt": place(optimizer.init(params), sh["opt"])}
        state["params"], state["opt"], _ = step_fn(
            state["params"], state["opt"], place(batches[0], bsh))
        saved = _checksums(torch, state)
        with tempfile.TemporaryDirectory() as tmp:
            t.sync()
            t0 = time.perf_counter()
            ckpt.save(tmp, 1, state)
            save_ms = (time.perf_counter() - t0) * 1e3
            files = list((Path(tmp) / "step_0000000001").glob("*.npy"))
            nbytes = sum(f.stat().st_size for f in files)
            dst_sh, dst_bsh = shardings("restored", optimizer)
            t0 = time.perf_counter()
            back = ckpt.restore(tmp, state, shardings=dst_sh)
            t.sync()
            restore_ms = (time.perf_counter() - t0) * 1e3
        p_, o_, m = step_fn(state["params"], state["opt"],
                            place(batches[1], bsh))
        want = {"loss": float(m["loss"]), "sums": _checksums(torch, (p_, o_))}
    del state, params, p_, o_, m
    restored = _checksums(torch, back)
    mesh, rules = layouts["restored"]
    with active_mesh(mesh, rules):
        step_fn, _ = steps_lib.make_train_step(cfg, tc, rules=rules)
        p_, o_, m = step_fn(back["params"], back["opt"],
                            place(batches[1], dst_bsh))
        got = {"loss": float(m["loss"]), "sums": _checksums(torch, (p_, o_))}
    del back, p_, o_, m
    if restored != saved:
        bad = [i for i, (a, b) in enumerate(zip(saved, restored)) if a != b]
        fail(f"[lm-mesh restore] restored leaves {bad[:8]} differ from the "
             f"saved ones")
    if got != want or not math.isfinite(got["loss"]):
        fail(f"[lm-mesh restore] the next step on the restored state differs"
             f" from the never-saved state's: loss {got['loss']} vs "
             f"{want['loss']}, leaves equal: {got['sums'] == want['sums']}")
    out = {"arch": cfg.name, "layers": cfg.n_layers, "batch": B, "seq": S,
           "saved_on": list(LM_MESH[0]), "restored_on":
           list(LM_RESTORE_MESH[0]), "tiles": len(files), "bytes": nbytes,
           "leaves": len(saved), "save_ms": save_ms,
           "restore_ms": restore_ms, "next_loss": got["loss"],
           "bit_for_bit": True}
    t.log(f"[lm-mesh restore] {cfg.name} cut to {cfg.n_layers} layers: the "
          f"train state ({len(saved)} leaves, {nbytes / 1e9:.3f} GB in "
          f"{len(files)} tiles) saved placed on {LM_MESH[0]} in "
          f"{save_ms:.1f} ms, restored onto {LM_RESTORE_MESH[0]} "
          f"{LM_RESTORE_MESH[1]} positions in {restore_ms:.1f} ms (warm "
          f"page cache); equal leaves, and the next step (loss "
          f"{got['loss']:.6f}) equals the never-saved state's bit for bit "
          f"({card})")
    return out


def _grad_agreement(torch, got, want) -> tuple[float, float, float]:
    """max |got - want|, that over max |want|, and the cosine."""
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    cos = float(torch.nn.functional.cosine_similarity(
        got.reshape(1, -1).double(), want.reshape(1, -1).double()))
    return err, err / scale if scale else err, cos


def _check_backward(t, name, q8, s8, gv, gd, w, th, mcfg, stream, tau):
    """The backward kernel twice (same bits) and its plain version on the
    same inputs; fails outside EPISODE_GRAD_RTOL / _MIN_COSINE. Returns
    the agreement and the three results' timing-free outputs."""
    torch = t.torch
    from repro_torch.kernels import mcam_episode
    kw = dict(noisy=True, stream=stream, tau=tau)
    dq, ds = mcam_episode.episode_backward(q8, s8, gv, gd, w, th, mcfg, **kw)
    dq2, ds2 = mcam_episode.episode_backward(q8, s8, gv, gd, w, th, mcfg,
                                             **kw)
    t.sync()
    if not (torch.equal(dq, dq2) and torch.equal(ds, ds2)):
        fail(f"{name}: the backward kernel gave other bits on a second run")
    pq, ps = mcam_episode.episode_backward_plain(q8, s8, gv, gd, w, th, mcfg,
                                                 **kw)
    t.sync()
    out = {}
    for label, a, b in (("dq", dq, pq), ("ds", ds, ps)):
        err, rel, cos = _grad_agreement(torch, a, b)
        out[label] = {"max_abs_err": err, "max_rel_err": rel, "cosine": cos}
        if not (rel <= EPISODE_GRAD_RTOL and cos >= EPISODE_GRAD_MIN_COSINE):
            fail(f"{name}: backward kernel {label} vs plain autograd: max "
                 f"relative error {rel}, cosine {cos}")
    return out


def run_episode(t, seed: int) -> dict:
    """[episode]: the stream forward and the backward kernel against their
    plain versions at a 20-way 10-shot episode, 4 queries a class."""
    import numpy as np
    torch, dev = t.torch, t.dev
    from repro_torch.configs.omniglot_conv4 import get_config
    from repro_torch.engine import RetrievalEngine
    from repro_torch.engine.engine import noise_stream
    from repro_torch.kernels import mcam_episode, mcam_search
    from repro_torch.launch import train as train_lib

    hat_cfg = train_lib.hat_config(get_config())
    mcfg = hat_cfg.search.mcam
    n_way, k_shot, n_query = EPISODE_SHAPE
    B, N, d = n_way * n_query, n_way * k_shot, 48
    rng = np.random.default_rng(seed + 15)
    q_emb = torch.as_tensor(np.maximum(rng.standard_normal((B, d)), 0),
                            dtype=torch.float32, device=dev)
    s_emb = torch.as_tensor(np.maximum(rng.standard_normal((N, d)), 0),
                            dtype=torch.float32, device=dev)
    q, s, w, th = RetrievalEngine(hat_cfg.search).episode_grids(q_emb, s_emb)
    q8, s8 = q.to(torch.int8).contiguous(), s.to(torch.int8).contiguous()
    S, sl = s8.shape[1:]
    stream = noise_stream(train_lib.step_key(seed, 0))
    for noisy, st in ((True, stream), (False, stream), (True, None)):
        a = mcam_search.mcam_search(q8, s8, w, th, mcfg, noisy=noisy,
                                    stream=st)
        t.sync()
        b = mcam_search.mcam_search_plain(q8, s8, w, th, mcfg, noisy=noisy,
                                          stream=st)
        t.sync()
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            fail(f"[episode] stream forward != plain (noisy={noisy}, "
                 f"stream={st})")
    gv = torch.as_tensor(rng.standard_normal((B, N)), dtype=torch.float32,
                         device=dev)
    gd = torch.as_tensor(rng.standard_normal((B, N)), dtype=torch.float32,
                         device=dev)
    agree = _check_backward(t, "[episode]", q8, s8, gv, gd, w, th, mcfg,
                            stream, hat_cfg.sa_tau)

    def kernel():
        return mcam_episode.episode_backward(q8, s8, gv, gd, w, th, mcfg,
                                             noisy=True, stream=stream,
                                             tau=hat_cfg.sa_tau)

    def plain():
        return mcam_episode.episode_backward_plain(
            q8, s8, gv, gd, w, th, mcfg, noisy=True, stream=stream,
            tau=hat_cfg.sa_tau)
    out = {"shape": f"B={B} N={N} S={S} sl={sl} noisy, stream",
           "cells": B * N * S * sl, **agree,
           "ms": t.event_ms(kernel), "device_ms": t.device_ms(
               kernel, "episode_grad"),
           "plain_ms": t.event_ms(plain, reps=3),
           "forward_ms": t.event_ms(lambda: mcam_search.mcam_search(
               q8, s8, w, th, mcfg, stream=stream))}
    t.log(f"[episode] {out['shape']} ({out['cells']} cells): stream forward "
          f"== plain bit for bit (noisy and noiseless); backward kernel vs "
          f"plain autograd dq {agree['dq']}, ds {agree['ds']}; same bits on "
          f"a second run; backward {out['ms']:.3f} ms (device "
          f"{out['device_ms']}), plain {out['plain_ms']:.1f} ms, forward "
          f"{out['forward_ms']:.3f} ms")
    return out


def _run_steps(t, step_fn, state, inputs):
    """step_fn over `inputs` (argument tuples) from state = (params,
    opt_state), each step synchronised and timed -> (params, opt_state),
    losses, ms."""
    params, opt = state
    losses, times = [], []
    for step_args in inputs:
        t.sync()
        t0 = time.perf_counter()
        params, opt, loss = step_fn(params, opt, *step_args)
        t.sync()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    return (params, opt), losses, times


def _clone(torch, tree):
    from repro_torch import tree as tree_lib
    return tree_lib.tree_map(torch.clone, tree)


def _differing(torch, a, b) -> list[str]:
    """Names of the leaves of two trees whose bits differ."""
    from repro_torch import tree as tree_lib

    def bits(x):
        return x.view(torch.int32) if x.dtype == torch.float32 else x
    names, xs = tree_lib.flatten_with_names(a)
    return [nm for nm, x, y in zip(names, xs, tree_lib.leaves(b))
            if not torch.equal(bits(x), bits(y))]


def _apply_settings(torch, name: str) -> None:
    """One of DETERMINISM_SETTINGS: "trainer" is make_deterministic();
    "torch" torch's deterministic algorithms alone, "cudnn" cuDNN's
    deterministic convolutions alone, "none" neither."""
    from repro_torch.launch import train as train_lib
    if name == "trainer":
        train_lib.make_deterministic()
        return
    torch.use_deterministic_algorithms(name == "torch")
    torch.backends.cudnn.deterministic = name == "cudnn"
    torch.backends.cudnn.benchmark = False


def _repeat_bit_for_bit(t, phase, pre_step, meta_step, pre_start,
                        meta_start, batches, meta_inputs, first):
    """The cost of the trainer's settings and whether they repeat a run:
    the pretrain and meta steps from clones of the same start without the
    settings, then with them again, which must give the first run's
    (losses, (params, opt_state)) of each stage bit for bit. Returns the
    step times without the settings and again with them."""
    torch = t.torch
    _apply_settings(torch, "none")
    _, _, pre_free = _run_steps(t, pre_step, _clone(torch, pre_start),
                                batches)
    _, _, meta_free = _run_steps(t, meta_step, _clone(torch, meta_start),
                                 meta_inputs)
    _apply_settings(torch, "trainer")
    pre_again, pre_again_losses, pre_again_times = _run_steps(
        t, pre_step, _clone(torch, pre_start), batches)
    meta_again, meta_again_losses, meta_again_times = _run_steps(
        t, meta_step, _clone(torch, meta_start), meta_inputs)
    for stage, (losses, state), again in (
            ("pretrain", first["pretrain"], (pre_again_losses, pre_again)),
            ("meta", first["meta"], (meta_again_losses, meta_again))):
        leaves = _differing(torch, state, again[1])
        if losses != again[0] or leaves:
            fail(f"{phase} a second run of the {stage} steps from the same "
                 f"state differs: losses {losses} vs {again[0]}, leaves "
                 f"{leaves}")
    return {"pretrain_free": pre_free, "meta_free": meta_free,
            "pretrain_again": pre_again_times, "meta_again": meta_again_times}


def _served_check(t, phase, apply_fn, backbone, arrays, n_way, hat_cfg):
    """Train == serve for a trained controller on one episode: the served
    class-mean votes (`MemoryStore.from_episode` -> `search(full,
    noisy=False)`) must equal `episode_scores(noisy=False)` bit for bit;
    the two launch the dense kernel once each and the backward never.
    Returns (engine, support and query embeddings, store, the full
    request, the launches, the served accuracy on the episode)."""
    torch = t.torch
    from repro_torch.core.avss import class_mean_votes
    from repro_torch.engine import MemoryStore, RetrievalEngine, SearchRequest
    from repro_torch.kernels import _build
    cs = hat_cfg.search
    _build.reset_launches()
    eng = RetrievalEngine(cs)
    s_lab = arrays["support_labels"]
    with torch.no_grad():
        s_emb = apply_fn(backbone, arrays["support_images"])
        q_emb = apply_fn(backbone, arrays["query_images"])
        scores = eng.episode_scores(q_emb, s_emb, s_lab, n_way,
                                    clip_std=hat_cfg.clip_std,
                                    sa_tau=hat_cfg.sa_tau, noisy=False)
        store = MemoryStore.from_episode(s_emb, q_emb, s_lab, cs,
                                         clip_std=hat_cfg.clip_std)
        full_req = SearchRequest(mode="full", noisy=False)
        res = eng.search(store, q_emb, full_req)
        served = class_mean_votes(res.votes, store.labels, n_way)
    t.sync()
    counts = dict(_build.LAUNCHES)
    if (counts["mcam_search"], counts["mcam_episode"]) != (2, 0):
        fail(f"{phase} episode_scores + search(full) launched {counts}; "
             f"expected mcam_search twice and mcam_episode never")
    if store.device.type != t.dev.type:
        fail(f"{phase} store on {store.device}, expected the card")
    if not torch.equal(scores, served):
        bad = int((scores != served).sum())
        fail(f"{phase} served class scores differ from episode_scores in "
             f"{bad} of {scores.numel()}")
    acc = float((served.argmax(-1) == arrays["query_labels"]).float().mean())
    return eng, s_emb, q_emb, store, full_req, counts, acc


def _episode_kernels(t, phase, eng, q_emb, s_emb, arrays, n_way, hat_cfg,
                     stream) -> dict:
    """The episodic kernels on a trained controller's episode: the dense
    forward with the noise stream `stream` against its plain version bit
    for bit, and the backward on the meta loss's gradient of the votes
    against its plain version (`_check_backward`), then their times.
    Returns the backward's row fields and the forward's times."""
    torch = t.torch
    from repro_torch.analysis.cost import kernel_cost
    from repro_torch.core.avss import class_mean_votes
    from repro_torch.core.hat import cross_entropy
    from repro_torch.kernels import mcam_episode, mcam_search
    mcfg = hat_cfg.search.mcam
    with torch.no_grad():
        q, s, w, th = eng.episode_grids(q_emb, s_emb,
                                        clip_std=hat_cfg.clip_std)
    q8, s8 = q.to(torch.int8).contiguous(), s.to(torch.int8).contiguous()
    (B, S, sl), N = q8.shape, s8.shape[0]
    votes = mcam_search.mcam_search(q8, s8, w, th, mcfg, stream=stream)[0]
    t.sync()
    pv = mcam_search.mcam_search_plain(q8, s8, w, th, mcfg, stream=stream)[0]
    t.sync()
    if not torch.equal(votes, pv):
        fail(f"{phase} stream forward != plain at this width")
    v_leaf = votes.clone().requires_grad_(True)
    with torch.enable_grad():
        loss = cross_entropy(torch.div(
            class_mean_votes(v_leaf, arrays["support_labels"], n_way),
            torch.tensor(hat_cfg.temperature, device=t.dev)),
            arrays["query_labels"])
        (gv,) = torch.autograd.grad(loss, v_leaf)
    gd = torch.zeros_like(gv)
    agree = _check_backward(t, phase, q8, s8, gv, gd, w, th, mcfg, stream,
                            hat_cfg.sa_tau)
    kw = dict(noisy=True, stream=stream, tau=hat_cfg.sa_tau)

    def bwd():
        return mcam_episode.episode_backward(q8, s8, gv, gd, w, th, mcfg,
                                             **kw)

    def fwd():
        return mcam_search.mcam_search(q8, s8, w, th, mcfg, stream=stream)
    _, plain_ms = t.timed(lambda: mcam_episode.episode_backward_plain(
        q8, s8, gv, gd, w, th, mcfg, **kw))
    cells = B * N * S * sl
    return {"shape": f"B={B} N={N} S={S} sl={sl} noisy, stream (one meta "
                     f"step)",
            "cells": cells, "ms": t.event_ms(bwd),
            "device_ms": t.device_ms(bwd, "episode_grad"),
            "plain_ms": plain_ms,
            "max_abs_err": max(a["max_abs_err"] for a in agree.values()),
            "max_rel_err": max(a["max_rel_err"] for a in agree.values()),
            "cosine": min(a["cosine"] for a in agree.values()),
            "cost": kernel_cost("mcam_episode", b=B, n=N, s=S, sl=sl),
            "tiling": mcam_episode.episode_tiling(B, N),
            "agreement": agree,
            "forward": {"ms": t.event_ms(fwd),
                        "device_ms": t.device_ms(fwd, "search_dense")}}


def _profiled(t, fn) -> tuple[list, float]:
    """One more call of fn under torch.profiler (CPU and CUDA), after one
    it leaves out and a pause (as device_ms does) -> (the profiler's
    averaged events but the step markers, the call's wall ms)."""
    prof = t.torch.profiler
    t.sync()
    with prof.profile(activities=[prof.ProfilerActivity.CPU,
                                  prof.ProfilerActivity.CUDA],
                      schedule=prof.schedule(wait=0, warmup=1, active=1,
                                             repeat=1)) as pr:
        for i in range(2):
            if i == 1:
                time.sleep(PROFILER_SETTLE_S)
            t0 = time.perf_counter()
            fn()
            t.sync()
            wall = (time.perf_counter() - t0) * 1e3
            pr.step()
    return ([e for e in pr.key_averages()
             if not e.key.startswith("ProfilerStep")
             and e.key not in RANGE_TAGS], wall)


def _profile_step(t, step_fn, *step_args) -> dict:
    """One more step under torch.profiler (`_profiled`): its wall time,
    the device time of each kernel, the device's busy share, and the
    episodic kernels' part."""
    torch = t.torch
    events, wall = _profiled(t, lambda: step_fn(*step_args))
    on_device = [(e.key, e.device_time_total / 1e3) for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(ms for _, ms in on_device)
    backward = sum(ms for k, ms in on_device if "episode_grad" in k)
    forward = sum(ms for k, ms in on_device if "search_dense" in k)
    by_kind = {kind: 0.0 for kind in (*STEP_KERNEL_KINDS, "other")}
    for k, ms in on_device:
        kind = next((kind for kind, parts in STEP_KERNEL_KINDS.items()
                     if any(part in k for part in parts)), "other")
        by_kind[kind] += ms
    return {"wall_ms": wall, "device_ms": busy,
            "busy_share": busy / wall if wall else None,
            "backward_device_ms": backward, "forward_device_ms": forward,
            "device_ms_by_kind": by_kind,
            "top": [(k[:80], ms) for k, ms in sorted(
                on_device, key=lambda kv: -kv[1])[:12]]}


def run_hat(t, args, launches: dict) -> dict:
    """[hat]: the trainer at the paper's full Omniglot width, then the
    trained controller served and checkpointed."""
    import tempfile

    import numpy as np
    torch, dev = t.torch, t.dev
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.configs.omniglot_conv4 import get_config
    from repro_torch.core import hat as hat_lib
    from repro_torch.data.fsl import (EpisodeSampler, OmniglotLike,
                                      pretrain_batch)
    from repro_torch.engine import MemoryStore, SearchRequest
    from repro_torch.engine.engine import noise_stream
    from repro_torch.kernels import _build
    from repro_torch.launch import train as train_lib
    from repro_torch.launch.steps import make_hat_train_steps
    from repro_torch.models.controller import apply_conv4
    from repro_torch.optim import adamw
    from repro_torch import tree as tree_lib

    fsl = get_config()
    hat_cfg = train_lib.hat_config(fsl)
    cs = hat_cfg.search
    n_query, width = HAT_QUERIES, HAT_WIDTH
    B, N = fsl.n_way * n_query, fsl.n_way * fsl.k_shot
    ds = OmniglotLike(n_classes=fsl.n_train_classes + fsl.n_test_classes,
                      image_size=fsl.image_size, seed=0)
    train_ids = np.arange(fsl.n_train_classes)
    pre_opt = adamw(1e-3, weight_decay=1e-4)
    meta_opt = adamw(1e-4, weight_decay=1e-4)
    pre_step, meta_step, place = make_hat_train_steps(
        apply_conv4, hat_cfg, pre_opt, meta_opt, n_way=fsl.n_way, device=dev)
    params = train_lib.init_params(fsl, len(train_ids), args.seed, width, dev)
    t.log(f"[hat] {fsl.name}: {fsl.n_way}-way {fsl.k_shot}-shot, "
          f"{n_query} queries a class (B={B}, N={N}), d={fsl.embed_dim}, "
          f"mtmc cl={fsl.cl} {cs.mode}, sigma_device="
          f"{cs.mcam.sigma_device} sigma_read={cs.mcam.sigma_read}, Conv4 "
          f"width {width}, {fsl.image_size}x{fsl.image_size} images")

    # one full-width episode, made once on the host and reused
    t0 = time.perf_counter()
    ep = EpisodeSampler(ds, train_ids, n_way=fsl.n_way, k_shot=fsl.k_shot,
                        n_query=n_query, seed=11 + args.seed).episode(0)
    episode_host_ms = (time.perf_counter() - t0) * 1e3
    arrays = place({"support_images": ep.support_images,
                    "support_labels": ep.support_labels,
                    "query_images": ep.query_images,
                    "query_labels": ep.query_labels})
    batches = [(place(pretrain_batch(ds, train_ids, batch=32, step=step)),)
               for step in range(HAT_PRETRAIN_STEPS)]
    meta_inputs = [(arrays, train_lib.step_key(args.seed, step))
                   for step in range(HAT_META_STEPS)]
    pre_start = (params, pre_opt.init(params))

    # which settings make a step's gradient reproducible: the gradient of
    # the first pretrain step and of a first meta step, DETERMINISM_RUNS
    # times under each setting; the leaves that differ from the first run
    meta_probe = {"backbone": params["backbone"]}
    episode = {**arrays, "n_way": fsl.n_way}
    probe = {}
    for name in DETERMINISM_SETTINGS:
        _apply_settings(torch, name)
        runs = {"pretrain": [hat_lib.value_and_grad(
                    hat_lib.pretrain_loss, params, batches[0][0],
                    apply_conv4) for _ in range(DETERMINISM_RUNS)],
                "meta": [hat_lib.value_and_grad(
                    hat_lib.meta_loss, meta_probe, episode, apply_conv4,
                    hat_cfg, meta_inputs[0][1])
                    for _ in range(DETERMINISM_RUNS)]}
        t.sync()
        probe[name] = {
            stage: sorted({nm for loss, g in r[1:]
                           for nm in _differing(torch,
                                                {"loss": r[0][0], **r[0][1]},
                                                {"loss": loss, **g})})
            for stage, r in runs.items()}
    train_lib.make_deterministic()
    t.log(f"[determinism] leaves (and the loss) of a first step's gradient "
          f"that differ between {DETERMINISM_RUNS} runs: {probe}")
    if probe["trainer"]["pretrain"] or probe["trainer"]["meta"]:
        fail(f"[hat] under the trainer's settings a step's gradient "
             f"differs between runs: {probe['trainer']}")

    # stage 1: pretrain steps (batch 32 over the training classes)
    pre_state, pre_losses, pre_times = _run_steps(
        t, pre_step, _clone(torch, pre_start), batches)
    params = pre_state[0]
    if not all(np.isfinite(pre_losses)):
        fail(f"[hat] non-finite pretrain loss: {pre_losses}")

    # stage 2: meta steps through the simulated MCAM: each launches the
    # dense forward and the backward kernel once
    meta_start = ({"backbone": params["backbone"]},
                  meta_opt.init({"backbone": params["backbone"]}))
    _build.reset_launches()
    meta_state, meta_losses, meta_times = _run_steps(
        t, meta_step, _clone(torch, meta_start), meta_inputs)
    meta_counts = dict(_build.LAUNCHES)
    want = {"mcam_search": HAT_META_STEPS, "mcam_episode": HAT_META_STEPS}
    if {k: meta_counts[k] for k in want} != want:
        fail(f"[hat] {HAT_META_STEPS} meta steps launched {meta_counts}; "
             f"expected {want}")
    if not all(np.isfinite(meta_losses)):
        fail(f"[hat] non-finite meta loss: {meta_losses}")

    # the cost of the settings: the same steps from the same start without
    # them, then with them again, which must repeat the first run's bits
    rerun = _repeat_bit_for_bit(
        t, "[hat]", pre_step, meta_step, pre_start, meta_start, batches,
        meta_inputs, {"pretrain": (pre_losses, pre_state),
                      "meta": (meta_losses, meta_state)})
    pre_free_times, meta_free_times = rerun["pretrain_free"], \
        rerun["meta_free"]
    pre_again_times, meta_again_times = rerun["pretrain_again"], \
        rerun["meta_again"]
    t.log(f"[hat] a second run of the pretrain and meta steps from a clone "
          f"of the same start gives the same losses and parameter and "
          f"optimizer leaves bit for bit; step ms with the trainer's "
          f"settings: pretrain {pre_times} then {pre_again_times}, meta "
          f"{meta_times} then {meta_again_times}; without them: pretrain "
          f"{pre_free_times}, meta {meta_free_times}")

    # the served evaluation, counted on its own
    meta_params, opt_state2 = meta_state
    eng, s_emb, q_emb, store, full_req, served_counts, acc = _served_check(
        t, "[hat]", apply_conv4, meta_params["backbone"], arrays, fsl.n_way,
        hat_cfg)
    for counts in (meta_counts, served_counts):
        for kname, c in counts.items():
            launches[kname] += c
    t.log(f"[hat] losses pretrain {pre_losses} meta {meta_losses}; launches "
          f"in the meta steps "
          f"{ {k: v for k, v in meta_counts.items() if v} }, in the served "
          f"check { {k: v for k, v in served_counts.items() if v} }; "
          f"train == serve: "
          f"class-mean votes of search(full) == episode_scores bit for bit "
          f"({B} x {fsl.n_way}); served accuracy on the episode {acc:.4f}")

    # save -> restore: the store and the controller
    with tempfile.TemporaryDirectory() as tmp:
        store.save(f"{tmp}/store", step=HAT_META_STEPS)
        back = MemoryStore.restore(f"{tmp}/store", store.cfg)
        noisy_req = SearchRequest(mode="full")
        for req in (full_req, noisy_req, SearchRequest(mode="two_phase",
                                                       k=64)):
            a, b = eng.search(store, q_emb, req), eng.search(back, q_emb, req)
            t.sync()
            for f in ("votes", "dist", "indices", "labels"):
                if not torch.equal(getattr(a, f), getattr(b, f)):
                    fail(f"[hat] restored store: {req.mode} {f} differ")
        mgr = CheckpointManager(f"{tmp}/controller", every=1)
        mgr.maybe_save(HAT_META_STEPS, {"params": meta_params}, force=True)
        mgr.wait()
        restored = mgr.restore({"params": meta_params})
        if not all(torch.equal(x, y) for x, y in zip(
                tree_lib.leaves(restored), tree_lib.leaves(
                    {"params": meta_params}))):
            fail("[hat] restored controller differs")
    t.log("[hat] save -> restore: the store searches to the same bits "
          "(full noiseless and noisy, two_phase k=64); the controller's "
          "leaves are equal")

    # the episodic kernels at this width, on this step's inputs: the
    # forward with the next step's stream, and the backward on the meta
    # loss's gradient of the votes, against their plain versions
    backward = _episode_kernels(
        t, "[hat]", eng, q_emb, s_emb, arrays, fsl.n_way, hat_cfg,
        noise_stream(train_lib.step_key(args.seed, HAT_META_STEPS)))
    forward = backward.pop("forward")
    agree = backward.pop("agreement")
    cells = backward["cells"]
    trace = _profile_step(t, meta_step, meta_params, opt_state2, arrays,
                          train_lib.step_key(args.seed, HAT_META_STEPS))
    backward["device_ms_in_step"] = trace["backward_device_ms"]
    wall, busy = trace["wall_ms"], trace["device_ms"]
    out = {"pretrain_losses": pre_losses, "meta_losses": meta_losses,
           "pretrain_step_ms": pre_times, "meta_step_ms": meta_times,
           "pretrain_step_ms_again": pre_again_times,
           "meta_step_ms_again": meta_again_times,
           "pretrain_step_ms_without_settings": pre_free_times,
           "meta_step_ms_without_settings": meta_free_times,
           "determinism_probe": probe,
           "episode_host_ms": episode_host_ms, "served_accuracy": acc,
           "forward": forward, "backward": backward,
           "agreement": agree, "meta_step_trace": trace,
           "episode_arrays": {k: getattr(ep, k) for k in (
               "support_images", "support_labels", "query_images",
               "query_labels")},
           "phases_ms": {"hat_meta_step": statistics.median(meta_times),
                         "hat_pretrain_step": statistics.median(pre_times)}}
    t.log(f"[hat] step times: pretrain {pre_times} ms, meta {meta_times} ms; "
          f"episode made on the host in {episode_host_ms:.0f} ms; at "
          f"{cells} cells the dense forward kernel {forward['ms']:.3f} ms "
          f"(device {forward['device_ms']}), the backward kernel "
          f"{backward['ms']:.3f} ms (device {backward['device_ms']}), its "
          f"plain version {backward['plain_ms']:.0f} ms; backward vs plain "
          f"{agree}")
    t.log(f"[hat] one meta step under torch.profiler: wall {wall:.1f} ms, "
          f"device busy {busy:.1f} ms; kernels by device time "
          f"{trace['top']}")
    return out


def run_cub(t, args, launches: dict) -> dict:
    """[cub]: hardware-aware training at the paper's CUB width: ResNet12
    (widths CUB_WIDTHS, 480-d embeddings) on 84x84x3 CUB-like images,
    `cub_resnet12.get_config()` (50-way 5-shot, MTMC CL = 25, AVSS; 4
    queries a class: B = 200, N = 250, S = 500), the trainer's HAT
    setting (`launch/train.hat_config`) and step keys, composed with
    `make_hat_train_steps(apply_resnet12, ...)` as the reference's
    bench_hat composes its own controller. Cut in depth only:
    CUB_PRETRAIN_STEPS pretrain and CUB_META_STEPS meta steps on one
    episode, under the trainer's deterministic settings, run again from
    clones of the same start without them (their cost) and with them
    (every loss and leaf bit for bit). Then the trained controller serves
    (train == serve bit for bit), and the episodic kernels are held against
    their plain versions at this width."""
    import numpy as np
    torch, dev = t.torch, t.dev
    from repro_torch.configs.cub_resnet12 import get_config
    from repro_torch.data.fsl import CUBLike, EpisodeSampler, pretrain_batch
    from repro_torch.engine.engine import noise_stream
    from repro_torch.kernels import _build
    from repro_torch.launch import train as train_lib
    from repro_torch.launch.steps import make_hat_train_steps
    from repro_torch.models.controller import apply_resnet12, init_resnet12
    from repro_torch.optim import adamw

    fsl = get_config()
    hat_cfg = train_lib.hat_config(fsl)
    cs = hat_cfg.search
    B, N = fsl.n_way * CUB_QUERIES, fsl.n_way * fsl.k_shot
    ds = CUBLike(n_classes=fsl.n_train_classes + fsl.n_test_classes,
                 image_size=fsl.image_size, seed=0)
    train_ids = np.arange(fsl.n_train_classes)
    pre_opt = adamw(1e-3, weight_decay=1e-4)
    meta_opt = adamw(1e-4, weight_decay=1e-4)
    pre_step, meta_step, place = make_hat_train_steps(
        apply_resnet12, hat_cfg, pre_opt, meta_opt, n_way=fsl.n_way,
        device=dev)
    # the trainer's head (launch/train.init_params) over a ResNet12
    rng = np.random.default_rng(args.seed + 1)
    params = {"backbone": init_resnet12(args.seed, in_ch=fsl.channels,
                                        widths=CUB_WIDTHS,
                                        embed_dim=fsl.embed_dim, device=dev),
              "head": {"w": torch.as_tensor(
                  rng.standard_normal((fsl.embed_dim, len(train_ids)))
                  * 0.05, dtype=torch.float32, device=dev),
                  "b": torch.zeros(len(train_ids), device=dev)}}
    t.log(f"[cub] {fsl.name}: {fsl.n_way}-way {fsl.k_shot}-shot, "
          f"{CUB_QUERIES} queries a class (B={B}, N={N}), d={fsl.embed_dim}, "
          f"mtmc cl={fsl.cl} {cs.mode}, sigma_device={cs.mcam.sigma_device} "
          f"sigma_read={cs.mcam.sigma_read}, ResNet12 {CUB_WIDTHS}, "
          f"{fsl.image_size}x{fsl.image_size}x{fsl.channels} images")

    t0 = time.perf_counter()
    ep = EpisodeSampler(ds, train_ids, n_way=fsl.n_way, k_shot=fsl.k_shot,
                        n_query=CUB_QUERIES, seed=11 + args.seed).episode(0)
    episode_host_ms = (time.perf_counter() - t0) * 1e3
    arrays = place({"support_images": ep.support_images,
                    "support_labels": ep.support_labels,
                    "query_images": ep.query_images,
                    "query_labels": ep.query_labels})
    batches = [(place(pretrain_batch(ds, train_ids, batch=32, step=step)),)
               for step in range(CUB_PRETRAIN_STEPS)]
    meta_inputs = [(arrays, train_lib.step_key(args.seed, step))
                   for step in range(CUB_META_STEPS)]
    pre_start = (params, pre_opt.init(params))

    _apply_settings(torch, "trainer")
    pre_state, pre_losses, pre_times = _run_steps(
        t, pre_step, _clone(torch, pre_start), batches)
    if not all(np.isfinite(pre_losses)):
        fail(f"[cub] non-finite pretrain loss: {pre_losses}")
    backbone = {"backbone": pre_state[0]["backbone"]}
    meta_start = (backbone, meta_opt.init(backbone))
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    meta_state, meta_losses, meta_times = _run_steps(
        t, meta_step, _clone(torch, meta_start), meta_inputs)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    meta_counts = dict(_build.LAUNCHES)
    want = {"mcam_search": CUB_META_STEPS, "mcam_episode": CUB_META_STEPS}
    if {k: meta_counts[k] for k in want} != want:
        fail(f"[cub] {CUB_META_STEPS} meta steps launched {meta_counts}; "
             f"expected {want}")
    if not all(np.isfinite(meta_losses)):
        fail(f"[cub] non-finite meta loss: {meta_losses}")
    rerun = _repeat_bit_for_bit(
        t, "[cub]", pre_step, meta_step, pre_start, meta_start, batches,
        meta_inputs, {"pretrain": (pre_losses, pre_state),
                      "meta": (meta_losses, meta_state)})
    t.log(f"[cub] losses pretrain {pre_losses} meta {meta_losses}; a second "
          f"run from a clone of the same start repeats every loss and "
          f"parameter and optimizer leaf bit for bit; step ms with the "
          f"trainer's settings: pretrain {pre_times} then "
          f"{rerun['pretrain_again']}, meta {meta_times} then "
          f"{rerun['meta_again']}; without them: pretrain "
          f"{rerun['pretrain_free']}, meta {rerun['meta_free']}; peak memory "
          f"of the meta steps {peak_gb:.2f} GB; episode made on the host in "
          f"{episode_host_ms:.0f} ms")

    # train == serve, then the episodic kernels at this width on the
    # trained controller's episode, then one profiled meta step
    meta_params, opt_state2 = meta_state
    eng, s_emb, q_emb, _, _, _, acc = _served_check(
        t, "[cub]", apply_resnet12, meta_params["backbone"], arrays,
        fsl.n_way, hat_cfg)
    _count(launches, meta_counts, "_cub")
    bwd = _episode_kernels(
        t, "[cub]", eng, q_emb, s_emb, arrays, fsl.n_way, hat_cfg,
        noise_stream(train_lib.step_key(args.seed, CUB_META_STEPS)))
    agree = bwd.pop("agreement")
    t.row("mcam_episode_cub", "mcam_episode.cu",
          "src/repro/engine/engine.py:457 (no Pallas kernel: jax.grad of jnp)",
          bwd["max_abs_err"], bwd["ms"], bwd["plain_ms"], bwd["cost"], None,
          device_ms=bwd["device_ms"], max_rel_err=bwd["max_rel_err"],
          cosine=bwd["cosine"], tiling=bwd["tiling"],
          forward_ms=bwd["forward"]["ms"],
          forward_device_ms=bwd["forward"]["device_ms"],
          shape=bwd["shape"].replace("one meta step", "one CUB meta step"))
    trace = _profile_step(t, meta_step, meta_params, opt_state2, arrays,
                          train_lib.step_key(args.seed, CUB_META_STEPS))
    t.log(f"[cub] train == serve: class-mean votes of search(full) == "
          f"episode_scores bit for bit ({B} x {fsl.n_way}), served accuracy "
          f"on the episode {acc:.4f}; backward vs plain {agree}; one meta "
          f"step under torch.profiler: wall {trace['wall_ms']:.1f} ms, "
          f"device busy {trace['device_ms']:.1f} ms, of which the dense "
          f"forward {trace['forward_device_ms']:.2f} ms and the backward "
          f"{trace['backward_device_ms']:.2f} ms; by kind "
          f"{trace['device_ms_by_kind']}; kernels by device time "
          f"{trace['top']}")
    return {"pretrain_losses": pre_losses, "meta_losses": meta_losses,
            "pretrain_step_ms": pre_times, "meta_step_ms": meta_times,
            "pretrain_step_ms_again": rerun["pretrain_again"],
            "meta_step_ms_again": rerun["meta_again"],
            "pretrain_step_ms_without_settings": rerun["pretrain_free"],
            "meta_step_ms_without_settings": rerun["meta_free"],
            "meta_peak_memory_gb": peak_gb, "served_accuracy": acc,
            "episode_host_ms": episode_host_ms, "agreement": agree,
            "meta_step_trace": trace,
            "phases_ms": {"cub_meta_step": statistics.median(meta_times),
                          "cub_pretrain_step": statistics.median(pre_times)}}


def run_paper(t, launches: dict) -> dict:
    """[paper]: the paper's evaluation on the card through the port's
    example twins. `examples.fsl_omniglot.main` at its smoke configuration
    with PAPER_STEPS + PAPER_STEPS training steps, once with `full`
    searches and once with `--two-phase-eval --engine-backend fused`; each
    evaluation cell (std / HAT x MTMC / B4E / SRE under AVSS, HAT MTMC
    under SVSS and AVSS) runs with the launch counts zeroed just before it
    and read just after, and must launch its kernels; the serve check must
    hold. The episodes are deterministic in (seed, index), so each is made
    once on the host and reused by the cells. Then
    `examples.quickstart.main`, whose accuracies must be 100%."""
    import functools

    from repro_torch.data.fsl import EpisodeSampler
    from repro_torch.examples import fsl_omniglot, quickstart
    from repro_torch.kernels import _build

    class CachedSampler(EpisodeSampler):
        @functools.lru_cache(maxsize=None)
        def episode(self, index):
            return super().episode(index)

    evaluate = fsl_omniglot.evaluate
    cells: list = []

    def counted(params, sampler, search_cfg, **kw):
        _build.reset_launches()
        out = evaluate(params, sampler, search_cfg, **kw)
        t.sync()
        cells.append((search_cfg, kw, dict(_build.LAUNCHES), out))
        return out

    steps = ["--pretrain-steps", str(PAPER_STEPS), "--meta-steps",
             str(PAPER_STEPS)]
    runs, phases_ms = {}, {}
    saved = fsl_omniglot.evaluate, fsl_omniglot.EpisodeSampler
    fsl_omniglot.evaluate, fsl_omniglot.EpisodeSampler = counted, \
        CachedSampler
    try:
        for name, extra in (("full", []), ("two_phase_fused", [
                "--two-phase-eval", "--engine-backend", "fused"])):
            cells.clear()
            t0 = time.perf_counter()
            out = fsl_omniglot.main(steps + extra)
            t.sync()
            phases_ms[f"paper_{name}"] = (time.perf_counter() - t0) * 1e3
            if not out["serve_parity"]:
                fail(f"[paper] {name}: the serve check printed False")
            if len(cells) != 8:
                fail(f"[paper] {name}: {len(cells)} evaluation cells, "
                     f"expected 8")
            matrix = {}
            # main's order: std x 3 codes, HAT x 3 codes, HAT SVSS / AVSS
            for i, (cfg, kw, counts, (acc, sd)) in enumerate(cells):
                two = kw.get("two_phase", False)
                needs = ("shortlist", "mcam_rescore") if two \
                    else ("mcam_search",)
                label = (f"{'std' if i < 3 else 'HAT'} {cfg.encoding} "
                         f"{cfg.mode.upper()} "
                         f"{'two_phase' if two else 'full'}"
                         f"{' (SVSS vs AVSS)' if i >= 6 else ''}")
                if any(counts[k] < 1 for k in needs):
                    fail(f"[paper] {name}: cell {label} launched {counts}")
                _count(launches, counts)
                matrix[label] = {"accuracy": acc, "std": sd, "launches": {
                    k: v for k, v in counts.items() if v}}
            runs[name] = {"matrix": matrix, "serve_parity": True}
            t.log(f"[paper] {name}: {phases_ms[f'paper_{name}']:.0f} ms; "
                  f"cells (accuracy, std, launches): {matrix}")
    finally:
        fsl_omniglot.evaluate, fsl_omniglot.EpisodeSampler = saved

    _build.reset_launches()
    t0 = time.perf_counter()
    accs = quickstart.main([])
    t.sync()
    phases_ms["paper_quickstart"] = (time.perf_counter() - t0) * 1e3
    counts = dict(_build.LAUNCHES)
    # full: the dense physics; two_phase at 512 rows (< fused_min_rows):
    # the LUT product, then the gathered physics
    if any(counts[k] < 1 for k in ("mcam_search", "mcam_dist",
                                   "mcam_rescore")):
        fail(f"[paper] quickstart launched {counts}")
    _count(launches, counts)
    if accs != {"full": 1.0, "two_phase": 1.0}:
        fail(f"[paper] quickstart accuracies {accs}, expected 100%")
    t.log(f"[paper] quickstart: accuracies {accs}, launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    return {"runs": runs, "quickstart": accs, "phases_ms": phases_ms}


def run_optim(t, args) -> dict:
    """[optim]: adamw8bit, adafactor and sgd from `make_optimizer` take
    OPTIM_STEPS steps over a ResNet12 parameter tree at the paper's widths
    with fixed gradients (numpy's, from the seed), on the card and on the
    CPU: every parameter and state leaf (the 8-bit moments dequantized)
    within OPTIM_RTOL of its largest entry, and every state on the card."""
    import numpy as np
    torch, dev = t.torch, t.dev
    from repro_torch import tree as tree_lib
    from repro_torch.models.controller import init_resnet12
    from repro_torch.optim import make_optimizer, warmup_cosine
    from repro_torch.optim.optimizers import _dq8, _is_q8

    params = init_resnet12(args.seed, widths=CUB_WIDTHS)
    rng = np.random.default_rng(args.seed + 29)
    grads = [tree_lib.tree_map(lambda p: torch.as_tensor(
        rng.standard_normal(tuple(p.shape), dtype=np.float32) * 1e-2
        * (1 + step)), params) for step in range(OPTIM_STEPS)]
    n_params = sum(p.numel() for p in tree_lib.leaves(params))

    def dense(tree):
        """State leaves as float tensors: 8-bit moments dequantized."""
        flat = []
        for leaf in tree_lib.leaves(tree, _is_q8):
            if isinstance(leaf, dict):
                flat.append(_dq8(leaf["q"], leaf["s"], leaf["q"].shape))
            else:
                flat.append(leaf)
        return flat

    out = {}
    for name in ("adamw8bit", "adafactor", "sgd"):
        results, times = {}, []
        for device in ("cpu", dev):
            opt = make_optimizer(name, warmup_cosine(1e-3, 2, 10))
            p = tree_lib.tree_map(lambda x: x.to(device), params)
            state = opt.init(p)
            for g in grads:
                g = tree_lib.tree_map(lambda x: x.to(device), g)
                t.sync()
                t0 = time.perf_counter()
                upd, state = opt.update(g, state, p)
                p = tree_lib.tree_map(lambda a, b: a + b, p, upd)
                t.sync()
                if device != "cpu":
                    times.append((time.perf_counter() - t0) * 1e3)
            results[str(device)] = (p, state)
        (pc, sc), (pg, sg) = results["cpu"], results[str(dev)]
        if any(x.device.type != dev.type for x in tree_lib.leaves(sg)):
            fail(f"[optim] {name}: a state leaf is not on the card")
        worst, differ = 0.0, 0
        for a, b in zip(tree_lib.leaves(pg) + dense(sg),
                        tree_lib.leaves(pc) + dense(sc)):
            a = a.cpu().float()
            b = b.float()
            scale = float(b.abs().max())
            err = float((a - b).abs().max())
            worst = max(worst, err / scale if scale else err)
            differ += int((a != b).sum())
        if worst > OPTIM_RTOL:
            fail(f"[optim] {name}: the card differs from the CPU by {worst} "
                 f"of a leaf's largest entry (> {OPTIM_RTOL})")
        out[name] = {"max_rel_err": worst, "elements_differing": differ,
                     "step_ms": times}
    t.log(f"[optim] {n_params} ResNet12 parameters, {OPTIM_STEPS} steps on "
          f"the card and on the CPU, states on the card: {out}")
    return out


if __name__ == "__main__":
    sys.exit(main())
