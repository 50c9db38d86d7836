#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--capacity 65536] [--seed 0]

Builds the three CUDA kernels of `src/repro_torch/csrc/` (one nvcc per
source, all started together), then drives the port's main path through
the entry points a user calls, at the paper's Omniglot geometry (d = 48,
MTMC CL = 32, 24-cell strings: 64 strings per support) and a many-class
store of 65,536 supports (4,096 classes x 16 shots):

  1. program    MemoryStore.create -> calibrate -> write, one batch
  2. two_phase  default backend: shortlist kernel + gathered physics kernel
  3. ideal      shortlist kernel
  4. two_phase  backend="mxu", fused_min_rows > N: LUT product kernel over
                the whole (256 x N) matrix, then the exact key selection
  5. full       16 queries against every row: dense physics kernel

Each path runs once with the launch counters zeroed just before it and
read just after; a kernel of the path that was not launched fails the
run. Then every kernel is held against its plain PyTorch version on the
same inputs on the card (shortlist and LUT product bit for bit; the
physics kernel's dist exactly and its votes at a stated agreement), the
two_phase votes of every shortlisted row are held against the full
search's votes of that row, and a small store searched on the CPU (plain
versions) is held against the same store on the card.

Times are medians of CUDA-event (kernels) or synchronised host-clock
(paths) runs after a warm-up. The last lines of standard output are the
card's `name, power.limit`, one JSON object with a row per kernel, and
`{"ok": true, "device": {...}}`. Exits non-zero, printing no result, when
there is no CUDA device or the package is missing, and when any phase
fails.
"""

from __future__ import annotations

import argparse
import json
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
# counted from csrc/mcam_search.cu: two hash streams per cell (one murmur
# finalizer of 8 ops each plus the coordinate xor / add: 2 x 10), the
# uniform conversions (2 x 3), Box-Muller (log, mul, sqrt, cos, 2 mul: 6),
# mismatch (2), noise fma + clip (4), exp argument + exp + sum (3) and the
# dist sum (1); the per-string terms (the 4-coordinate prefixes, read noise,
# division, thresholds) add ~3 per cell at 24 cells a string.
PHYSICS_OPS_PER_CELL = 2 * 10 + 2 * 3 + 6 + 2 + 4 + 3 + 1 + 3

PHYSICS_MIN_AGREEMENT = 0.999   # kernel vs plain vote agreement, per pair
MIN_ACCURACY = 0.95
REPS = 5                        # timed runs per measurement (median)


def fail(msg: str) -> None:
    raise AssertionError(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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

    # -- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    for name, text in logs.items():
        print(f"--- nvcc {name}.cu ---\n{text}", file=sys.stderr)
    log(f"[build] {len(logs)} kernel libraries built in "
        f"{time.perf_counter() - t0:.1f} s")

    # -- data ----------------------------------------------------------------
    shots, d, cl = 16, 48, 32
    n = args.capacity
    classes = n // shots
    rng = np.random.default_rng(args.seed)
    centres = rng.standard_normal((classes, d), dtype=np.float32) * 2.0
    labels_np = np.repeat(np.arange(classes, dtype=np.int32), shots)
    support_np = centres[labels_np] + 0.3 * rng.standard_normal(
        (n, d), dtype=np.float32)
    qcls = rng.choice(classes, size=256, replace=False)
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
        # `ms` is the kernel's time under the key readers of this line
        # parse; `kernel_ms` repeats it under PERF.md's column name
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "kernel_ms": ms,
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
    row("shortlist", "shortlist.cu", "src/repro/kernels/shortlist.py:210",
        err, event_ms(sl_kernel), event_ms(sl_plain),
        packed.numel() * 4 + qw.numel() * 4 + n + 256 * 64 * 12,
        256 * n * d, F32_OPS_PER_S, event_ms(sl_library),
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
        f" over {kv.numel()} pairs")
    if dist_err != 0 or agree < PHYSICS_MIN_AGREEMENT:
        fail(f"mcam_search: dist err {dist_err}, agreement {agree}")
    if not torch.equal(kv, full.votes) or not torch.equal(kdist, full.dist):
        fail("mcam_search kernel != the full search's result")
    cells = 16 * n * S * sl
    row("mcam_search", "mcam_search.cu",
        "src/repro/kernels/mcam_search.py:37", err, event_ms(ms_kernel),
        event_ms(ms_plain, reps=3), ss.numel() + qs.numel() + 16 * n * 8
        + w.numel() * 4, cells * PHYSICS_OPS_PER_CELL, F32_OPS_PER_S, None,
        vote_agreement=agree, shape=f"B=16 N={n} S={S} sl={sl} noisy")

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
    if agree_r < PHYSICS_MIN_AGREEMENT:
        fail(f"mcam_rescore agreement {agree_r}")
    if not torch.equal(rk, tp.votes):
        fail("mcam_rescore kernel != the two_phase search's votes")
    uniq = int(torch.unique(rows).numel())
    row("mcam_rescore", "mcam_search.cu",
        "src/repro/kernels/mcam_search.py:37", err, event_ms(rs_kernel),
        event_ms(rs_plain, reps=3), uniq * S * sl + qs256.numel()
        + rows.numel() * 16 + rk.numel() * 4 + w.numel() * 4,
        256 * 64 * S * sl * PHYSICS_OPS_PER_CELL, F32_OPS_PER_S, None,
        vote_agreement=agree_r, also_replaces="src/repro/kernels/ops.py:186",
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

    log(json.dumps({"phases_ms": {"program": program_ms, **path_ms},
                    "accuracy_two_phase": acc, "card": card}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
