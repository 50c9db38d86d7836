#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--capacity 65536] [--seed 0]

Builds the four CUDA kernel sources of `src/repro_torch/csrc/` (one nvcc
per source, all started together; ptxas's registers / shared memory / spills
and the count of wgmma (HGMMA) instructions in the LUT product's SASS are
printed), checks on all 2**32 hash words that the physics kernel's
cheaper arithmetic forms equal the plain version's bit for bit, then
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

Each path runs once with the launch counters zeroed just before it and
read just after; a kernel of the path that was not launched fails the
run. Then every kernel is held against its plain PyTorch version on the
same inputs on the card, bit for bit (the shortlist also on three
adversarial stores of the same size: rows in
descending distance, where every row beats the running k-th key, all
rows tied, and all rows masked), the two_phase votes of every
shortlisted row are held against the full
search's votes of that row, and a small store searched on the CPU (plain
versions) is held against the same store on the card.

Times are medians of CUDA-event (kernels) or synchronised host-clock
(paths) runs after a warm-up; each kernel row adds `device_ms`, the
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
import json
import os
import re
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): device
# memory rate, float32 outside the tensor cores, bf16 tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12

# Scalar operations of one noisy cell evaluation of the physics kernel,
# counted by hand from the cell formula and kept fixed, so that the bound
# reads the same whatever the kernel's implementation: two hash streams per
# cell (one murmur finalizer of 8 ops each plus the coordinate xor / add:
# 2 x 10), the uniform conversions (2 x 3), Box-Muller (log, mul, sqrt, cos,
# 2 mul: 6), mismatch (2), noise fma + clip (4), exp argument + exp + sum
# (3) and the dist sum (1); the per-string terms (the 4-coordinate
# prefixes, read noise, division, thresholds) add ~3 per cell at 24 cells a
# string.
PHYSICS_OPS_PER_CELL = 2 * 10 + 2 * 3 + 6 + 2 + 4 + 3 + 1 + 3

# Scalar operations of one cell of the episodic backward, counted by hand
# from its formula (csrc/mcam_episode.cu) and kept fixed: the forward's 45
# to recompute the cell's current, then the clip mask (2), the cell's
# resistance term times the mask (1), its gradient a * e + g0 (2), the
# sign of q - s (2), the two sums into dq and ds (2), and the string's
# sigmoid terms over 8 thresholds and the current's derivative (~75 a
# string) spread over its 24 cells (3).
EPISODE_BACKWARD_OPS_PER_CELL = PHYSICS_OPS_PER_CELL + 2 + 1 + 2 + 2 + 2 + 3

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

MIN_ACCURACY = 0.95
REPS = 5                        # timed runs per measurement (median)
# pause between a profiler session's start of recording and the first
# call it keeps (see device_ms)
PROFILER_SETTLE_S = 0.05


def fail(msg: str) -> None:
    raise AssertionError(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sass_count(lib: Path, opcode: str) -> int | None:
    """Instructions of `opcode` in a built library's SASS (cuobjdump), or
    None where the toolkit has no cuobjdump."""
    tool = Path("/usr/local/cuda/bin/cuobjdump")
    if not tool.exists():
        return None
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    return sum(opcode in line for line in out.splitlines())


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


def run(args, torch) -> int:
    import numpy as np

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
    dev = torch.device("cuda")
    card = gpu_line()

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

    def device_ms(fn, part, reps=REPS, sessions=3):
        """Device time per call of the kernels whose name holds `part`
        (torch.profiler's CUDA activity). Unlike event_ms it leaves out the
        host's time between launches. A profiler session can miss the
        first kernel launched after it starts recording, and would then
        read low, so each session records only after one warm-up call and
        a pause (PROFILER_SETTLE_S), and one that saw a kernel a number of
        times that is not a multiple of `reps` is dropped and taken again,
        up to `sessions` times; None where no session saw every call (or
        none saw such a kernel), rather than a low time."""
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
            seen = [e for e in p.key_averages() if part in e.key]
            if seen and not any(e.count % reps for e in seen):
                return sum(e.device_time_total for e in seen) / reps / 1e3
            log(f"[device_ms] {part}: the profiler saw "
                f"{[(e.key[:60], e.count) for e in seen]} in {reps} calls")
        return None

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
    resources = {}
    for src in ("mcam_search", "mcam_episode"):
        found = kernel_resources(logs.get(src, ""))
        resources.update(found)
        for entry, res in found.items():
            log(f"[resources {src}] {entry}: {res}")

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
    rng = np.random.default_rng(args.seed)
    centres = rng.standard_normal((classes, d), dtype=np.float32) * 2.0
    labels_np = np.repeat(np.arange(classes, dtype=np.int32), shots)
    support_np = centres[labels_np] + 0.3 * rng.standard_normal(
        (n, d), dtype=np.float32)
    qcls = rng.choice(classes, size=256, replace=classes < 256)
    queries_np = centres[qcls] + 0.3 * rng.standard_normal(
        (256, d), dtype=np.float32)
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
    launches = {k: 0 for k in _build.LAUNCHES}
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

    kernels = []

    def row(name, source, replaces, err, ms, plain_ms, bytes_, ops_,
            ops_rate, library_ms, **extra):
        t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
        t_ops = ops_ / ops_rate * 1e3
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, **extra})
        log(f"[kernel] {name}: {ms:.4f} ms (plain {plain_ms:.3f} ms, "
            f"library {library_ms}, bound {max(t_bytes, t_ops):.4f} ms), "
            f"max_abs_err {err}")

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

    # adversarial stores at the same N and queries, bit for bit: every
    # LUT column of a row holds one value per dimension, so a row's
    # distance is the same for every query. Descending distance makes
    # every row beat the running k-th key (the selection's worst case,
    # timed); all rows tied or all masked admit no row after the first k.
    def uniform_store(per_row):
        per_dim = (per_row // d)[:, None].repeat(1, 4 * d)
        per_dim[:, :4] += (per_row % d)[:, None]
        dp = 2 * d                               # 16-bit fields, 2 a word
        words = per_dim[:, :dp] | (per_dim[:, dp:] << 16)
        return torch.where(words >= 2**31, words - 2**32, words).to(
            torch.int32)
    rows_desc = torch.arange(n - 1, -1, -1, device=dev) * 3
    adversarial = {
        "descending": (uniform_store(rows_desc), 16, valid),
        "ties": (uniform_store(torch.full_like(rows_desc, 5 * d)), 16,
                 valid),
        "masked": (packed, 8, torch.zeros_like(valid))}
    adv_ms = {}
    for name, (words, bits, vmask) in adversarial.items():
        for kk in (1, 64, 1024):
            a = shortlist.lut_shortlist(qw, None, kk, valid=vmask,
                                        packed=words, pack_bits=bits)
            sync()
            b = shortlist.lut_shortlist_plain(qw, None, kk, valid=vmask,
                                              packed=words, pack_bits=bits)
            sync()
            if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
                fail(f"shortlist kernel != plain on the {name} store "
                     f"(k={kk})")
        adv_ms[name] = event_ms(lambda: shortlist.lut_shortlist(
            qw, None, 64, valid=vmask, packed=words, pack_bits=bits))
        adv_ms[f"{name}_device"] = device_ms(lambda: shortlist.lut_shortlist(
            qw, None, 64, valid=vmask, packed=words, pack_bits=bits),
            "shortlist_")
    log(f"[shortlist] adversarial stores equal the plain version for k = "
        f"1, 64, 1024; k=64 kernel ms: "
        f"{ {k_: v and round(v, 4) for k_, v in adv_ms.items()} } (descending "
        f"and ties on 16-bit fields, 96 words a row)")
    row("shortlist", "shortlist.cu", "src/repro/kernels/shortlist.py:210",
        err, event_ms(sl_kernel), event_ms(sl_plain),
        packed.numel() * 4 + qw.numel() * 4 + n + 256 * 64 * 12,
        256 * n * d, F32_OPS_PER_S, event_ms(sl_library),
        device_ms=device_ms(sl_kernel, "shortlist_"),
        descending_ms=adv_ms["descending"],
        descending_device_ms=adv_ms["descending_device"],
        ties_ms=adv_ms["ties"], masked_ms=adv_ms["masked"],
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
        (q1h.numel() + proj.numel()) * 2 + 256 * n * 4,
        2 * 256 * n * 4 * d, BF16_TENSOR_OPS_PER_S,
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
    cells = 16 * n * S * sl
    row("mcam_search", "mcam_search.cu",
        "src/repro/kernels/mcam_search.py:37", err, event_ms(ms_kernel),
        event_ms(ms_plain, reps=3), ss.numel() + qs.numel() + 16 * n * 8
        + w.numel() * 4, cells * PHYSICS_OPS_PER_CELL, F32_OPS_PER_S, None,
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
        event_ms(rs_plain, reps=3), uniq * S * sl + qs256.numel()
        + rows.numel() * 16 + rk.numel() * 4 + w.numel() * 4,
        256 * 64 * S * sl * PHYSICS_OPS_PER_CELL, F32_OPS_PER_S, None,
        vote_agreement=agree_r, also_replaces="src/repro/kernels/ops.py:186",
        device_ms=device_ms(rs_kernel, "search_gathered"),
        resources=resources.get("search_gathered<24>"),
        shape=f"B=256 k=64 S={S} sl={sl} noisy, {uniq} distinct rows")

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

    # -- hardware-aware training ---------------------------------------------
    timing = argparse.Namespace(torch=torch, dev=dev, log=log, sync=sync,
                                host_ms=host_ms, event_ms=event_ms,
                                device_ms=device_ms)
    train_lib.make_deterministic()
    episode = run_episode(timing, args.seed)
    hat = run_hat(timing, args, launches)
    path_ms.update(hat.pop("phases_ms"))
    bwd = hat["backward"]
    row("mcam_episode", "mcam_episode.cu",
        "src/repro/engine/engine.py:457 (no Pallas kernel: jax.grad of jnp)",
        bwd["max_abs_err"], bwd["ms"], bwd["plain_ms"], bwd["bytes"],
        bwd["cells"] * EPISODE_BACKWARD_OPS_PER_CELL, F32_OPS_PER_S, None,
        device_ms=bwd["device_ms"],
        device_ms_in_step=bwd["device_ms_in_step"],
        max_rel_err=bwd["max_rel_err"],
        cosine=bwd["cosine"], episode=episode,
        resources=resources.get("episode_grad<24,1,1>"),
        resources_sum=resources.get("episode_grad_sum"),
        shape=bwd["shape"])

    for r in kernels:       # with the [hat] path's launches
        r["launches"] = launches[r["name"]]
    log(json.dumps({"phases_ms": {"program": program_ms, **path_ms},
                    "accuracy_two_phase": acc, "hat": hat, "card": card}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


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


def run_hat(t, args, launches: dict) -> dict:
    """[hat]: the trainer at the paper's full Omniglot width, then the
    trained controller served and checkpointed."""
    import tempfile

    import numpy as np
    torch, dev = t.torch, t.dev
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.configs.omniglot_conv4 import get_config
    from repro_torch.core import hat as hat_lib
    from repro_torch.core.avss import class_mean_votes
    from repro_torch.core.hat import cross_entropy
    from repro_torch.data.fsl import (EpisodeSampler, OmniglotLike,
                                      pretrain_batch)
    from repro_torch.engine import MemoryStore, RetrievalEngine, SearchRequest
    from repro_torch.engine.engine import noise_stream
    from repro_torch.kernels import _build, mcam_episode, mcam_search
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

    def run_steps(step_fn, state, inputs):
        """step_fn over `inputs` (argument tuples) from state = (params,
        opt_state), each step synchronised and timed -> (params,
        opt_state), losses, ms."""
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

    def clone(tree):
        return tree_lib.tree_map(torch.clone, tree)

    def differing(a, b) -> list[str]:
        """Names of the leaves of two trees whose bits differ."""
        def bits(x):
            return x.view(torch.int32) if x.dtype == torch.float32 else x
        names, xs = tree_lib.flatten_with_names(a)
        return [nm for nm, x, y in zip(names, xs, tree_lib.leaves(b))
                if not torch.equal(bits(x), bits(y))]

    def apply_settings(name: str) -> None:
        """One of DETERMINISM_SETTINGS: "trainer" is make_deterministic();
        "torch" torch's deterministic algorithms alone, "cudnn" cuDNN's
        deterministic convolutions alone, "none" neither."""
        if name == "trainer":
            train_lib.make_deterministic()
            return
        torch.use_deterministic_algorithms(name == "torch")
        torch.backends.cudnn.deterministic = name == "cudnn"
        torch.backends.cudnn.benchmark = False

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
        apply_settings(name)
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
                           for nm in differing({"loss": r[0][0], **r[0][1]},
                                               {"loss": loss, **g})})
            for stage, r in runs.items()}
    train_lib.make_deterministic()
    t.log(f"[determinism] leaves (and the loss) of a first step's gradient "
          f"that differ between {DETERMINISM_RUNS} runs: {probe}")
    if probe["trainer"]["pretrain"] or probe["trainer"]["meta"]:
        fail(f"[hat] under the trainer's settings a step's gradient "
             f"differs between runs: {probe['trainer']}")

    # stage 1: pretrain steps (batch 32 over the training classes)
    pre_state, pre_losses, pre_times = run_steps(pre_step, clone(pre_start),
                                                 batches)
    params = pre_state[0]
    if not all(np.isfinite(pre_losses)):
        fail(f"[hat] non-finite pretrain loss: {pre_losses}")

    # stage 2: meta steps through the simulated MCAM: each launches the
    # dense forward and the backward kernel once
    meta_start = ({"backbone": params["backbone"]},
                  meta_opt.init({"backbone": params["backbone"]}))
    _build.reset_launches()
    meta_state, meta_losses, meta_times = run_steps(
        meta_step, clone(meta_start), meta_inputs)
    meta_params, opt_state2 = meta_state
    t.sync()
    meta_counts = dict(_build.LAUNCHES)
    want = {"mcam_search": HAT_META_STEPS, "mcam_episode": HAT_META_STEPS}
    if {k: meta_counts[k] for k in want} != want:
        fail(f"[hat] {HAT_META_STEPS} meta steps launched {meta_counts}; "
             f"expected {want}")
    if not all(np.isfinite(meta_losses)):
        fail(f"[hat] non-finite meta loss: {meta_losses}")

    # the cost of the settings: the same steps from the same start without
    # them, then with them again, which must repeat the first run's bits
    apply_settings("none")
    _, _, pre_free_times = run_steps(pre_step, clone(pre_start), batches)
    _, _, meta_free_times = run_steps(meta_step, clone(meta_start),
                                      meta_inputs)
    train_lib.make_deterministic()
    pre_again, pre_again_losses, pre_again_times = run_steps(
        pre_step, clone(pre_start), batches)
    meta_again, meta_again_losses, meta_again_times = run_steps(
        meta_step, clone(meta_start), meta_inputs)
    for stage, first, again in (
            ("pretrain", (pre_losses, pre_state),
             (pre_again_losses, pre_again)),
            ("meta", (meta_losses, meta_state),
             (meta_again_losses, meta_again))):
        leaves = differing(first[1], again[1])
        if first[0] != again[0] or leaves:
            fail(f"[hat] a second run of the {stage} steps from the same "
                 f"state differs: losses {first[0]} vs {again[0]}, leaves "
                 f"{leaves}")
    t.log(f"[hat] a second run of the pretrain and meta steps from a clone "
          f"of the same start gives the same losses and parameter and "
          f"optimizer leaves bit for bit; step ms with the trainer's "
          f"settings: pretrain {pre_times} then {pre_again_times}, meta "
          f"{meta_times} then {meta_again_times}; without them: pretrain "
          f"{pre_free_times}, meta {meta_free_times}")

    # the served evaluation, counted on its own: episode_scores and
    # search(full) launch the dense kernel once each
    _build.reset_launches()
    eng = RetrievalEngine(cs)
    backbone = meta_params["backbone"]
    s_lab, q_lab = arrays["support_labels"], arrays["query_labels"]
    with torch.no_grad():
        s_emb = apply_conv4(backbone, arrays["support_images"])
        q_emb = apply_conv4(backbone, arrays["query_images"])
        scores = eng.episode_scores(q_emb, s_emb, s_lab, fsl.n_way,
                                    clip_std=hat_cfg.clip_std,
                                    sa_tau=hat_cfg.sa_tau, noisy=False)
        store = MemoryStore.from_episode(s_emb, q_emb, s_lab, cs,
                                         clip_std=hat_cfg.clip_std)
        full_req = SearchRequest(mode="full", noisy=False)
        res = eng.search(store, q_emb, full_req)
        served = class_mean_votes(res.votes, store.labels, fsl.n_way)
    t.sync()
    served_counts = dict(_build.LAUNCHES)
    if (served_counts["mcam_search"], served_counts["mcam_episode"]) != (2, 0):
        fail(f"[hat] episode_scores + search(full) launched {served_counts}; "
             f"expected mcam_search twice and mcam_episode never")
    for counts in (meta_counts, served_counts):
        for kname, c in counts.items():
            launches[kname] += c
    if store.device.type != dev.type:
        fail(f"[hat] store on {store.device}, expected the card")
    if not torch.equal(scores, served):
        bad = int((scores != served).sum())
        fail(f"[hat] served class scores differ from episode_scores in "
             f"{bad} of {scores.numel()}")
    acc = float((served.argmax(-1) == q_lab).float().mean())
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
    # forward with the step's stream bit for bit, and the backward on the
    # meta loss's gradient of the votes, against their plain versions
    stream = noise_stream(train_lib.step_key(args.seed, HAT_META_STEPS))
    with torch.no_grad():
        q, s, w, th = eng.episode_grids(q_emb, s_emb,
                                        clip_std=hat_cfg.clip_std)
    q8, s8 = q.to(torch.int8).contiguous(), s.to(torch.int8).contiguous()
    S, sl = s8.shape[1:]
    mcfg = cs.mcam
    votes = mcam_search.mcam_search(q8, s8, w, th, mcfg, stream=stream)[0]
    t.sync()
    pv = mcam_search.mcam_search_plain(q8, s8, w, th, mcfg, stream=stream)[0]
    t.sync()
    if not torch.equal(votes, pv):
        fail("[hat] stream forward != plain at full width")
    v_leaf = votes.clone().requires_grad_(True)
    with torch.enable_grad():
        loss = cross_entropy(torch.div(
            class_mean_votes(v_leaf, s_lab, fsl.n_way),
            torch.tensor(hat_cfg.temperature)), q_lab)
        (gv,) = torch.autograd.grad(loss, v_leaf)
    gd = torch.zeros_like(gv)
    agree = _check_backward(t, "[hat]", q8, s8, gv, gd, w, th, mcfg, stream,
                            hat_cfg.sa_tau)

    def bwd():
        return mcam_episode.episode_backward(q8, s8, gv, gd, w, th, mcfg,
                                             noisy=True, stream=stream,
                                             tau=hat_cfg.sa_tau)

    def fwd():
        return mcam_search.mcam_search(q8, s8, w, th, mcfg, stream=stream)

    def plain():
        return mcam_episode.episode_backward_plain(
            q8, s8, gv, gd, w, th, mcfg, noisy=True, stream=stream,
            tau=hat_cfg.sa_tau)
    cells = B * N * S * sl
    backward = {
        "shape": f"B={B} N={N} S={S} sl={sl} noisy, stream (one meta step)",
        "cells": cells, "ms": t.event_ms(bwd),
        "device_ms": t.device_ms(bwd, "episode_grad"),
        "plain_ms": t.event_ms(plain, reps=1),
        "max_abs_err": max(a["max_abs_err"] for a in agree.values()),
        "max_rel_err": max(a["max_rel_err"] for a in agree.values()),
        "cosine": min(a["cosine"] for a in agree.values()),
        "bytes": q8.numel() + s8.numel() + 2 * gv.numel() * 4
        + (q8.numel() + s8.numel()) * 4 + w.numel() * 4}
    forward = {"ms": t.event_ms(fwd),
               "device_ms": t.device_ms(fwd, "search_dense")}

    # one more meta step under torch.profiler, after one it leaves out and
    # a pause (as device_ms does): the device time of each kernel of a
    # step, and the device's busy share of the step's wall time
    prof = torch.profiler
    t.sync()
    with prof.profile(activities=[prof.ProfilerActivity.CPU,
                                  prof.ProfilerActivity.CUDA],
                      schedule=prof.schedule(wait=0, warmup=1, active=1,
                                             repeat=1)) as pr:
        for i in range(2):
            if i == 1:
                time.sleep(PROFILER_SETTLE_S)
            t0 = time.perf_counter()
            meta_step(meta_params, opt_state2, arrays,
                      train_lib.step_key(args.seed, HAT_META_STEPS))
            t.sync()
            wall = (time.perf_counter() - t0) * 1e3
            pr.step()
    on_device = [(e.key, e.device_time_total / 1e3) for e in pr.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.key.startswith("ProfilerStep")]
    busy = sum(ms for _, ms in on_device)
    backward["device_ms_in_step"] = sum(ms for k, ms in on_device
                                        if "episode_grad" in k)
    trace = {"wall_ms": wall, "device_ms": busy,
             "busy_share": busy / wall if wall else None,
             "top": [(k[:80], ms) for k, ms in sorted(
                 on_device, key=lambda kv: -kv[1])[:8]]}
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


if __name__ == "__main__":
    sys.exit(main())
