"""Time the block-table entry of csrc/shortlist.cu on one NVIDIA GPU.

    python3 src/repro_torch/launch/time_blocks.py [--src DIR] [--variants]
        [--capacity 65536] [--seed 0]

Run it from the root of a checkout: it takes its stores, its capture of a
search's block-table call and its timers from chip_smoke.py there. It
builds the CUDA kernels of the repro_torch package under DIR (default:
this checkout's src; another checkout's src, such as a parent commit's,
times that tree's entry on the same stores and card), then times the
entry on the inputs that chip_smoke.py's searches give it:

  nprobe8      the routed store (65,536 rows, d = 48, 64 shards), nprobe 8
  nprobe1      the same store at nprobe 1
  tenants      the tenant stack and its 256 queries of mixed tenants
  cub_nprobe8  the routed store at the CUB width (d = 480), nprobe 8

and the one-table entry (`lut_shortlist`) on the two unsharded stores,
on their 8-bit packed fields (`shortlist`, `cub_shortlist`) and on their
bf16 projections (`shortlist_bf16`, `cub_shortlist_bf16`; this tree routes
those through the block-table entry): its CUDA-event ms, the wrapper's
host work included, and its torch.profiler device ms.
Each block row holds the entry's result against its plain version bit for
bit, and gives its CUDA-event ms and its torch.profiler device ms by pass
(group, select, merge). With --variants (this checkout's package only)
every block row the constant acts on is timed again under each value in
VARIANTS of the host plan's tuning constants, and the one-table entry on
both stores under each value in ONE_TABLE_VARIANTS, at the k its select
takes (the wgmma select's ring depth and widest row staged whole at k =
64; the mma.sync select's K-chunk words and ring depth at k = 1,024); a
value whose select block the shared-memory model (analysis/vmem.py) puts
over the H100's budget is rejected before it is timed. One JSON object a line; the last line
gives the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]

# the host plan's tuning constants (kernels/shortlist.py) and the values
# --variants times; the first two spread a mix over waves of units, the
# last two cut K-chunked rows (d = 480) within what the kernel takes
# (chunks of 8 to CHUNK_MAX = 64 words, 2 to 4 stages)
VARIANTS = {
    "_BLOCKS_WAVES": (0.25, 0.5, 1.0, 2.0, 4.0),
    "_BLOCKS_WAVES_CHUNKED": (0.5, 1.0, 1.5, 2.0, 4.0),
    "_CHUNK_MAX": (32, 48, 64),
    "_BLOCKS_STAGES_CHUNKED": (2, 3, 4),
}
CHUNKED = ("_BLOCKS_WAVES_CHUNKED", "_CHUNK_MAX", "_BLOCKS_STAGES_CHUNKED")
# the one-table selects' constants, each with its values and the k whose
# select it cuts: the wgmma select's ring slots (3 to 8) and the widest
# row it stages whole, in 64-byte columns (0: every row in K-columns; at
# most csrc's 3); the mma.sync select's K-chunk words (a multiple of 8)
# and ring slots for K-chunked rows
ONE_TABLE_VARIANTS = {"_WG_STAGES": ((3, 4), 64),
                      "_WG_WHOLE_BOXES": ((0, 3), 64),
                      "_ONE_CHUNK": ((24, 32, 40, 48), 1024),
                      "_ONE_STAGES": ((2, 3), 1024)}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--src", type=Path, default=ROOT / "src",
                   help="the directory that holds the repro_torch to time")
    p.add_argument("--variants", action="store_true",
                   help="also time each value of the plan's constants")
    p.add_argument("--capacity", type=int, default=65536)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("time_blocks: no CUDA device", file=sys.stderr)
        return 2
    own = args.src.resolve() == (ROOT / "src").resolve()
    if args.variants and not own:
        print("time_blocks: --variants times this checkout's plan only",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(args.src.resolve()), str(ROOT)]
    import chip_smoke as smoke
    from repro_torch.configs.cub_resnet12 import get_config
    from repro_torch.core.avss import SearchConfig
    from repro_torch.core.memory import MemoryConfig
    from repro_torch.engine import MemoryStore, RetrievalEngine, SearchRequest
    from repro_torch.kernels import _build, shortlist

    t = smoke.timers(torch)
    _build.build()
    calls, one_calls = {}, {}
    out = {"src": str(args.src), "one_table_ms": {},
           "one_table_device_ms": {}}
    cub = get_config()
    for prefix, seed, d, cl in (("", args.seed, 48, 32),
                                ("cub_", args.seed + 17, cub.embed_dim,
                                 cub.cl)):
        _, labels, support, _, queries = smoke.clustered(
            seed, args.capacity, d, 256)
        cfg = MemoryConfig(capacity=args.capacity, dim=d,
                           search=SearchConfig("mtmc", cl=cl, mode="avss"))
        x = torch.from_numpy(support).to(t.dev)
        store = MemoryStore.create(cfg).calibrate(x).write(
            x, torch.from_numpy(labels).to(t.dev))
        q = torch.from_numpy(queries).to(t.dev)
        qw = store.quantize_queries(q)

        for name, sp, kw in (
                (f"{prefix}shortlist", None,
                 {"packed": store.proj_packed, "pack_bits": 8}),
                (f"{prefix}shortlist_bf16", store.proj, {})):
            def fn(qw=qw, sp=sp, kw=kw, valid=store.valid, k=64):
                return shortlist.lut_shortlist(qw, sp, k, valid=valid, **kw)
            got = fn()
            want = shortlist.lut_shortlist_plain(qw, sp, 64,
                                                 valid=store.valid, **kw)
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                smoke.fail(f"{name}: the one-table entry differs from plain")
            one_calls[name] = fn
            out["one_table_ms"][name] = t.event_ms(fn)
            out["one_table_device_ms"][name] = t.device_ms(fn, "shortlist_")
        rstore = store.shard(n_shards=smoke.ROUTED_SHARDS)
        eng = RetrievalEngine(cfg.search)
        for nprobe in (8,) if prefix else (8, 1):
            req = SearchRequest(mode="ideal", k=64, nprobe=nprobe)
            calls[f"{prefix}nprobe{nprobe}"] = smoke.capture_blocks(
                lambda: eng.search(rstore, q, req))
        del x
    tstore, queries, tids, *_, search, _, _ = smoke.tenant_stack(t, args)
    eng = RetrievalEngine(search)
    calls["tenants"] = smoke.capture_blocks(
        lambda: eng.search_tenants(tstore, queries, tids,
                                   SearchRequest(mode="ideal", k=64)))

    def measure(name):
        (qw, sp, k), kw = calls[name]

        def kernel():
            return shortlist.lut_shortlist_blocks(qw, sp, k, **kw)
        got = kernel()
        want = shortlist.lut_shortlist_blocks_plain(qw, sp, k, **kw)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                             want[1])):
            smoke.fail(f"{name}: the block-table entry differs from plain")
        row = {"ms": t.event_ms(kernel),
               "device_ms": t.device_ms(kernel, "shortlist_",
                                        passes=smoke.BLOCK_PASSES)}
        if own:
            table = kw.get("packed") if sp is None else sp
            m, rows, words = table.shape
            row["plan"] = smoke.blocks_units(
                shortlist, kw["ids"], m, rows, words, k,
                sp is None and kw["pack_bits"] == 8)
        return row

    out["rows"] = {name: measure(name) for name in calls}
    for name, row in out["rows"].items():
        t.log(json.dumps({"row": name, **row}))
    def over_budget(names) -> str:
        """The vmem gate's reasons for the rows' plans under the current
        constants ('' when every plan fits)."""
        from repro_torch.analysis import vmem
        reasons = []
        for name in names:
            (qw, sp, k), kw = calls[name]
            table = kw.get("packed") if sp is None else sp
            m, rows = table.shape[:2]
            words = table.shape[2] if sp is None else (
                table.shape[2] // (2 if sp.dtype == torch.bfloat16 else 1))
            b, p = kw["ids"].shape
            check = vmem.validate_config(vmem.blocks_smem(
                b, p, m, rows, words, k,
                sp is None and kw["pack_bits"] == 8))
            if not check.ok:
                reasons.append(f"{name}: {check.reason}")
        return "; ".join(reasons)

    if args.variants:
        out["variants"] = {}
        for const, values in VARIANTS.items():
            kept = getattr(shortlist, const)
            names = [n for n in calls if n.startswith("cub_") == (
                const in CHUNKED)]
            for v in values:
                setattr(shortlist, const, v)
                try:
                    rejected = over_budget(names)
                    res = ({"rejected": rejected} if rejected
                           else {n: measure(n) for n in names})
                except ValueError as e:     # the plan refuses the value
                    res = {"refused": str(e)}
                finally:
                    setattr(shortlist, const, kept)
                out["variants"][f"{const}={v}"] = res
                t.log(json.dumps({"variant": f"{const}={v}", **res}))
        from repro_torch.analysis import vmem
        for const, (values, k) in ONE_TABLE_VARIANTS.items():
            kept = getattr(shortlist, const)
            for v in values:
                setattr(shortlist, const, v)
                shortlist.shortlist_plan.cache_clear()  # plans of this value
                res = {}
                try:
                    for name, d in (("shortlist", 48),
                                    ("cub_shortlist", cub.embed_dim)):
                        check = vmem.validate_config(vmem.shortlist_smem(
                            256, args.capacity, d, k))
                        fn = one_calls[name]
                        res[name] = ({"rejected": check.reason}
                                     if not check.ok else {
                            "k": k,
                            "ms": t.event_ms(lambda: fn(k=k)),
                            "device_ms": t.device_ms(lambda: fn(k=k),
                                                     "shortlist_"),
                            "plan": smoke.plan_fields(
                                shortlist.shortlist_plan(
                                    256, args.capacity, d, k))})
                finally:
                    setattr(shortlist, const, kept)
                    shortlist.shortlist_plan.cache_clear()
                out["variants"][f"{const}={v}"] = res
                t.log(json.dumps({"variant": f"{const}={v}", **res}))
    card = smoke.gpu_line()
    t.log(json.dumps({**out, "card": card}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
