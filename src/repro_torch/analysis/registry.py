"""Declarative contract registry of the port: (invariant x entry-point x
config) cells (counterpart of `repro.analysis.registry`, with the same
cells under the same `entry|config` keys).

  engine.search      mode (full/two_phase/ideal) x backend (ref/mxu/fused)
                     x sharded/unsharded x packed/unpacked operand
                     x fused_min_rows (forcing both sides of the dispatch)
                     x routed (nprobe < n_shards on a partitioned store
                     engages the sketch router: the `router_sketch` range
                     iff routing is engaged)
  engine.search_tenants
                     the multi-tenant dispatch over a ragged 5-tenant
                     stack, plus one program across tenant counts for T
                     in {1, 5, 64}
  MemoryStore.write  scatter path (unsharded / 1-shard) vs shard-local
                     write-through (multi-shard)
  episode_votes      the differentiable training twin of search

`python -m repro_torch.analysis run` builds each cell on small inputs,
runs its call once under analysis/cost.py's trace and checks the record
through analysis/contracts.py (the ONE spelling of each invariant),
writing results/contract_report.json with pass / fail per cell and the
offending lines on failure. The fused-range expectation of every cell is
computed from the SAME dispatch rule the engine uses
(engine/sharded._use_fused).

Where the port differs from the reference, because nothing compiles:

  * a cell's artifact is its call's trace record, not HLO text;
  * the jit-cache invariants become "one program": equal-but-distinct
    requests over same-shape stores (and repeated tenant searches at one
    tenant count) must run the same op census and the same kernel
    launches, and no kernel library may be built or loaded a second time;
  * `hbm_buffer_bound` reads the call's peak live bytes: on the card
    `torch.cuda.max_memory_allocated` over the call, strictly; on the CPU
    the trace's temp bytes, recorded without binding (the plain versions
    materialise the (B, N) distances the kernel never holds), as the
    reference's `strict` flag does off the TPU;
  * the episode cell also takes the gradient of the votes, so that on
    the card it launches the episodic backward kernel;
  * sharded cells run on a mesh of 8 positions of the cell's device, so
    no cell skips for want of devices.

`build_cells(device)` builds the cells on `device`: the card unless the
caller asks for the CPU (`device="cpu"`, as the tests do); chip_smoke.py
runs them on the card.
"""

from __future__ import annotations

import dataclasses
import functools
import json
from typing import Callable

import numpy as np
import torch

from repro_torch.analysis import contracts as hc
from repro_torch.analysis import cost as cost_lib

#: k used by every search cell (small, so cells run in milliseconds)
CELL_K = 16
#: fused_min_rows values forcing each side of the dispatch rule
FMR_FORCE_FUSED = 1
FMR_FORCE_DENSE = 1 << 30
#: positions of the sharded cells' mesh (the reference's CLI forces 8
#: host devices)
N_SHARDS = 8
#: tenant counts of the one-program-across-tenants cell
TENANT_COUNTS = (1, 5, 64)


def cell_device(device=None) -> torch.device:
    """`device`, or the card when None (the port's entry points run on
    the card unless the caller asks for the CPU)."""
    from repro_torch.engine.store import resolve_device
    return resolve_device(device)


@dataclasses.dataclass(frozen=True)
class Cell:
    """One entry-point configuration and the invariants checked on it.

    build() returns the cell's artifacts: {"trace": the call's record};
    fused cells add "expect_fused", routed ones "expect_router", the
    buffer cells "hbm", the one-program cells "programs" / "expected" or
    "program_counts"."""

    entry: str
    config: dict
    invariants: tuple[str, ...]
    build: Callable[[], dict]
    skip: str = ""

    @property
    def key(self) -> str:
        return f"{self.entry}|{json.dumps(self.config, sort_keys=True)}"


# -- invariant name -> checker over cell artifacts --------------------------


def _inv_hbm_buffer_bound(art: dict) -> list[str]:
    h = art["hbm"]
    if h["measured_bytes"] <= h["bound_bytes"] or not h["strict"]:
        return []
    return [f"peak buffers {h['measured_bytes']}B exceed the "
            f"O(B*k + N*4d) bound {h['bound_bytes']}B"]


def _inv_one_program(art: dict) -> list[str]:
    if art["programs"] == art["expected"]:
        return []
    return [f"{art['programs']} distinct programs for one request family "
            f"(expected {art['expected']}): equal-but-distinct "
            f"SearchRequests or same-shape stores ran other ops or "
            f"launches"]


INVARIANTS: dict[str, Callable[[dict], list[str]]] = {
    "no_collectives": lambda a: hc.check_no_collectives(a["trace"]),
    "no_scatter_any_spelling":
        lambda a: hc.check_no_scatter_any_spelling(a["trace"]),
    "scatter_write_engaged": lambda a: hc.check_scatter_write(a["trace"]),
    "no_layout_ops": lambda a: hc.check_no_layout_ops(a["trace"]),
    "layout_ops_present":
        lambda a: hc.check_layout_ops_present(a["trace"]),
    "fused_tag_iff_dispatch_rule":
        lambda a: hc.check_fused_tag(a["trace"], a["expect_fused"]),
    "router_tag_iff_engaged":
        lambda a: hc.check_router_tag(a["trace"], a["expect_router"]),
    "no_f64_promotion": lambda a: hc.check_no_f64(a["trace"]),
    "hbm_buffer_bound": _inv_hbm_buffer_bound,
    "single_jit_cache_entry_per_request_family": _inv_one_program,
    "single_jit_entry_across_tenants":
        lambda a: hc.check_single_jit_entry_across_tenants(
            a["program_counts"]),
}


# -- shared fixtures (built lazily; tiny shapes, tie-heavy + masked rows) ---


@functools.lru_cache(maxsize=None)
def _fix(device: str):
    from repro_torch.core.avss import SearchConfig
    from repro_torch.core.memory import MemoryConfig
    from repro_torch.engine import MemoryStore

    cfg = SearchConfig("mtmc", cl=8, mode="avss", use_kernel="ref")
    rng = np.random.default_rng(0)
    base = rng.integers(0, cfg.enc.levels, size=(8, 20))
    sv = np.concatenate([base] * 9, axis=0)                # 72 rows, ties
    labels = np.where(np.arange(72) % 4 == 0, -1,
                      np.arange(72)).astype(np.int32)      # masked rows
    store = MemoryStore.from_quantized(sv, labels, cfg, device=device)
    qv = torch.from_numpy(rng.integers(0, 4, size=(5, 20))).to(device)

    mcfg = MemoryConfig(capacity=32, dim=16,
                        search=SearchConfig("mtmc", cl=4, mode="avss",
                                            use_kernel="ref"))
    wvecs = torch.from_numpy(rng.standard_normal((12, 16)).astype(
        np.float32)).to(device)
    wlabs = torch.arange(12, dtype=torch.int32, device=device)
    wstore = MemoryStore.create(mcfg, device=device).calibrate(wvecs)
    return {"cfg": cfg, "store": store, "qv": qv,
            "mcfg": mcfg, "wstore": wstore, "wvecs": wvecs, "wlabs": wlabs}


@functools.lru_cache(maxsize=None)
def _tenant_fix(device: str):
    """Ragged 5-tenant stack of the reference's geometry: one empty tenant
    (calibrated, never written), one tie-heavy tenant, masked label -1
    rows, and an interleaved query batch with repeated tenants."""
    from repro_torch.core.avss import SearchConfig
    from repro_torch.core.memory import MemoryConfig
    from repro_torch.engine import MemoryStore, TenantStore

    cfg = SearchConfig("mtmc", cl=8, mode="avss", use_kernel="ref")
    rng = np.random.default_rng(0)
    stores = []
    for i, cap in enumerate((12, 7, 16, 5, 9)):
        if i == 3:                                      # empty tenant
            mc = MemoryConfig(capacity=cap, dim=20, search=cfg)
            sample = rng.normal(size=(8, 20)).astype(np.float32)
            stores.append(MemoryStore.create(mc, device=device).calibrate(
                sample))
            continue
        v = rng.integers(0, cfg.enc.levels, size=(cap, 20))
        if i == 2:                                      # tie-heavy
            v = np.concatenate([v[:4]] * 4)[:cap]
        lab = rng.integers(0, 5, size=(cap,))
        lab[::4] = -1                                   # masked rows
        stores.append(MemoryStore.from_quantized(v, lab, cfg, device=device))
    tstore = TenantStore.stack(stores)
    tids = torch.tensor([0, 2, 1, 0, 2, 4, 2, 3, 0], dtype=torch.int32,
                        device=device)
    qv = torch.from_numpy(rng.integers(0, 4, size=(9, 20))).to(device)
    return {"cfg": cfg, "tstore": tstore, "qv": qv, "tids": tids}


def _mesh(device: str):
    from repro_torch.launch.mesh import Mesh
    return Mesh.repeat(device, (N_SHARDS,), ("data",))


def _unpacked(store):
    """The same store streaming the WIDE projection: proj_packed dropped,
    so every fused route takes the unpacked-operand path."""
    return dataclasses.replace(store, proj_packed=None)


def _expect_fused(backend: str, rows_loc: int, mode: str, fmr: int) -> bool:
    """The registry's expectation IS the engine's dispatch rule."""
    from repro_torch.engine.sharded import _use_fused
    if mode == "full":
        return False
    return _use_fused(backend, rows_loc, fmr)


def _traced(device: torch.device, fn, *args) -> tuple[dict, int | None]:
    """(the trace record of fn(*args), the peak device bytes it added on
    the card, None elsewhere). The record also holds "launch_counter":
    what the call added to `kernels/_build.LAUNCHES` (launches on the
    card; nothing elsewhere)."""
    from repro_torch.kernels import _build
    cuda = device.type == "cuda"
    before = dict(_build.LAUNCHES)
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    _, rec = cost_lib.trace(fn, *args)
    rec["launch_counter"] = {k: v - before[k]
                             for k, v in _build.LAUNCHES.items()
                             if v != before[k]}
    if not cuda:
        return rec, None
    torch.cuda.synchronize(device)
    return rec, torch.cuda.max_memory_allocated(device) - base


def _hbm_stats(rec: dict, device_peak: int | None, B: int, k: int, N: int,
               d: int) -> dict:
    """Peak bytes of the call vs the O(B*k + N*4d) bound the fused
    shortlist advertises (kernels/shortlist.py): the per-query top-k
    buffers plus one pass over the streamed projection, times 4 for dtype
    width and slack; kp as the reference pads k. Strict on the card."""
    kp = 128 if k <= 128 else k
    bound = 4 * 4 * (B * kp * 2 + N * 4 * d)
    measured = rec["temp_bytes"] if device_peak is None else device_peak
    return {"measured_bytes": int(measured), "bound_bytes": bound,
            "strict": device_peak is not None}


# -- cell builders ----------------------------------------------------------


def _search_cell(device, mode: str, backend: str, fmr: int, packed: bool,
                 sharded: bool, n_shards: int) -> Cell:
    from repro_torch.engine import RetrievalEngine, SearchRequest
    dev = cell_device(device)

    def build() -> dict:
        fx = _fix(str(dev))
        store, qv = fx["store"], fx["qv"]
        if sharded:
            store = store.shard(_mesh(str(dev)), ("data",))
        if not packed:
            store = _unpacked(store)
        eng = RetrievalEngine(fx["cfg"], backend=backend)
        req = SearchRequest(mode=mode, k=CELL_K, fused_min_rows=fmr)
        rec, peak = _traced(dev, lambda st, q: eng.search(st, q, req).votes,
                            store, qv)
        rows_loc = store.capacity // (n_shards if sharded else 1)
        art = {"trace": rec,
               "expect_fused": _expect_fused(backend, rows_loc, mode, fmr)}
        if mode == "ideal" and art["expect_fused"] and not sharded:
            art["hbm"] = _hbm_stats(rec, peak, qv.shape[0], CELL_K,
                                    store.capacity, store.dim)
        return art

    invariants = ["fused_tag_iff_dispatch_rule", "no_layout_ops",
                  "no_f64_promotion"]
    if not sharded:
        # unsharded searches move nothing between positions; sharded
        # two-phase / ideal gather the per-shard top-k by design
        invariants.append("no_collectives")
        if mode == "ideal" and _expect_fused(backend, 72, mode, fmr):
            invariants.append("hbm_buffer_bound")
    return Cell(entry="engine.search",
                config={"mode": mode, "backend": backend,
                        "sharded": sharded, "packed": packed,
                        "fused_min_rows": fmr},
                invariants=tuple(invariants), build=build)


def _routed_cell(device, mode: str, backend: str, fmr: int, packed: bool,
                 nprobe: int, n_shards: int = 8) -> Cell:
    """engine.search with nprobe on a LOGICALLY partitioned store
    (`shard(n_shards=...)`, mesh-less: nothing crosses positions).
    nprobe < n_shards must route (range entered); nprobe == n_shards is
    the control: the exhaustive search, range absent."""
    from repro_torch.engine import RetrievalEngine, SearchRequest
    dev = cell_device(device)
    engaged = nprobe < n_shards

    def build() -> dict:
        fx = _fix(str(dev))
        store = fx["store"].shard(n_shards=n_shards)
        if not packed:
            store = _unpacked(store)
        eng = RetrievalEngine(fx["cfg"], backend=backend)
        req = SearchRequest(mode=mode, k=CELL_K, fused_min_rows=fmr,
                            nprobe=nprobe)
        rec, _ = _traced(dev, lambda st, q: eng.search(st, q, req).votes,
                         store, fx["qv"])
        # the routed shortlist ranks the visited blocks: rows_loc =
        # nprobe * rows a shard; the control is exhaustive
        rows_loc = (nprobe * (store.capacity // n_shards) if engaged
                    else store.capacity)
        return {"trace": rec, "expect_router": engaged,
                "expect_fused": _expect_fused(backend, rows_loc, mode,
                                              fmr)}

    return Cell(entry="engine.search",
                config={"mode": mode, "backend": backend, "packed": packed,
                        "fused_min_rows": fmr, "nprobe": nprobe,
                        "n_shards": n_shards},
                invariants=("router_tag_iff_engaged",
                            "fused_tag_iff_dispatch_rule", "no_layout_ops",
                            "no_f64_promotion", "no_collectives"),
                build=build)


def _tenant_search_cell(device, mode: str, backend: str, fmr: int,
                        packed: bool) -> Cell:
    from repro_torch.engine import RetrievalEngine, SearchRequest
    dev = cell_device(device)

    def build() -> dict:
        fx = _tenant_fix(str(dev))
        tstore, qv, tids = fx["tstore"], fx["qv"], fx["tids"]
        if not packed:
            tstore = _unpacked(tstore)
        eng = RetrievalEngine(fx["cfg"], backend=backend)
        req = SearchRequest(mode=mode, k=CELL_K, fused_min_rows=fmr)
        rec, _ = _traced(
            dev, lambda ts, q, i: eng.search_tenants(ts, q, i, req).votes,
            tstore, qv, tids)
        # every query ranks its tenant's block at the PADDED row count
        return {"trace": rec,
                "expect_fused": _expect_fused(backend, tstore.n_pad,
                                              mode, fmr)}

    return Cell(entry="engine.search_tenants",
                config={"mode": mode, "backend": backend, "packed": packed,
                        "fused_min_rows": fmr},
                invariants=("fused_tag_iff_dispatch_rule", "no_layout_ops",
                            "no_f64_promotion", "no_collectives"),
                build=build)


def _loaded_libraries() -> int:
    from repro_torch.kernels import _build
    return len(_build._LIBS)


def _programs(recs_and_libs) -> int:
    """Distinct programs over calls [(record, libraries loaded after)]: by
    op census and launches, a library loaded after the first call
    counting as another program."""
    programs = {hc.program_of(rec) for rec, _ in recs_and_libs}
    libs = {n for _, n in recs_and_libs}
    return len(programs) + len(libs) - 1


def _tenant_jit_cache_cell(device) -> Cell:
    dev = cell_device(device)

    def build() -> dict:
        from repro_torch.engine import (MemoryStore, RetrievalEngine,
                                        SearchRequest, TenantStore)
        fx = _tenant_fix(str(dev))
        eng = RetrievalEngine(fx["cfg"])
        levels = fx["cfg"].enc.levels

        def mk_stack(T: int, seed: int):
            r = np.random.default_rng(seed)
            return TenantStore.stack([
                MemoryStore.from_quantized(
                    r.integers(0, levels, size=(6, 8)),
                    r.integers(0, 3, size=(6,)), fx["cfg"], device=dev)
                for _ in range(T)])

        # per tenant count T: fresh stores / queries / tenant_ids of the
        # same shapes must all run ONE program
        counts, launches = {}, {}
        for T in TENANT_COUNTS:
            calls = []
            for trial in range(2):
                r = np.random.default_rng(100 * T + trial)
                ts = mk_stack(T, seed=T + trial)
                q = torch.from_numpy(r.integers(0, 4, size=(4, 8))).to(dev)
                tids = torch.from_numpy(r.integers(0, T, size=(4,))).to(
                    dev, torch.int32)
                req = SearchRequest(mode="two_phase", k=4)
                rec, _ = _traced(
                    dev, lambda a, b, c: eng.search_tenants(
                        a, b, c, req).votes, ts, q, tids)
                calls.append((rec, _loaded_libraries()))
            counts[T] = _programs(calls)
            launches[f"T={T}"] = calls[0][0]["launches"]
        return {"program_counts": counts, "launch_counts": launches}

    return Cell(entry="engine.search_tenants",
                config={"check": "jit cache across tenant counts"},
                invariants=("single_jit_entry_across_tenants",),
                build=build)


def _write_cell(device, kind: str, n_shards: int) -> Cell:
    dev = cell_device(device)

    def build() -> dict:
        fx = _fix(str(dev))
        wstore, vecs, labs = fx["wstore"], fx["wvecs"], fx["wlabs"]
        if kind != "unsharded":
            from repro_torch.launch.mesh import Mesh
            wstore = wstore.shard(Mesh.repeat(str(dev), (n_shards,),
                                              ("data",)), ("data",))
        rec, _ = _traced(dev, lambda st, v, lab: st.write(v, lab),
                         wstore, vecs, labs)
        return {"trace": rec}

    if kind == "multi_shard":
        # the shard-local write-through: rows programmed in place with
        # nothing crossing positions and no scatter under any spelling
        invariants = ("no_collectives", "no_scatter_any_spelling",
                      "no_f64_promotion")
    else:
        # unsharded / 1-shard: the scatter path must actually engage
        invariants = ("scatter_write_engaged", "no_collectives",
                      "no_f64_promotion")
    return Cell(entry="MemoryStore.write",
                config={"path": kind, "n_shards": n_shards},
                invariants=invariants, build=build)


def _episode_votes_cell(device) -> Cell:
    dev = cell_device(device)

    def build() -> dict:
        from repro_torch.engine import RetrievalEngine
        fx = _fix(str(dev))
        eng = RetrievalEngine(fx["cfg"])
        r = np.random.default_rng(3)
        q = torch.from_numpy(r.standard_normal((4, 20)).astype(
            np.float32)).to(dev).requires_grad_()
        s = torch.from_numpy(r.standard_normal((10, 20)).astype(
            np.float32)).to(dev).requires_grad_()

        def votes_and_grads(qq, ss):
            v = eng.episode_votes(qq, ss)["votes"]
            return torch.autograd.grad(v.sum(), (qq, ss))
        rec, _ = _traced(dev, votes_and_grads, q, s)
        return {"trace": rec}

    return Cell(entry="episode_votes", config={},
                invariants=("no_f64_promotion", "no_collectives"),
                build=build)


def _layout_control_cell(device) -> Cell:
    dev = cell_device(device)

    def build() -> dict:
        from repro_torch.engine import RetrievalEngine
        fx = _fix(str(dev))
        eng = RetrievalEngine(fx["cfg"], backend="ref")
        rec, _ = _traced(
            dev, lambda s, q: eng.two_phase(q, s, k=CELL_K)["votes"],
            fx["store"].values, fx["qv"])
        return {"trace": rec}

    return Cell(entry="engine.two_phase(raw-arrays)",
                config={"control": "read-time layout"},
                invariants=("layout_ops_present",), build=build)


def _jit_cache_cell(device) -> Cell:
    dev = cell_device(device)

    def build() -> dict:
        from repro_torch.engine import (MemoryStore, RetrievalEngine,
                                        SearchRequest)
        fx = _fix(str(dev))
        eng = RetrievalEngine(fx["cfg"])
        store_a = fx["store"]
        store_b = MemoryStore.from_quantized(
            torch.flip(store_a.values, dims=(0,)), store_a.labels,
            fx["cfg"], device=dev)
        # equal-but-distinct request objects + distinct same-shape stores:
        # one request family, and it must run ONE program
        calls = []
        for st in (store_a, store_b):
            req = SearchRequest(mode="two_phase", k=CELL_K)
            rec, _ = _traced(dev, lambda s, q: eng.search(s, q, req).votes,
                             st, fx["qv"])
            calls.append((rec, _loaded_libraries()))
        return {"trace": calls[0][0], "programs": _programs(calls),
                "expected": 1}

    return Cell(entry="engine.search", config={"check": "jit cache"},
                invariants=("single_jit_cache_entry_per_request_family",),
                build=build)


def build_cells(device=None) -> list[Cell]:
    """The full registered matrix (see the module docstring), built on
    `device` (default the card)."""
    n_shards = N_SHARDS
    cells: list[Cell] = []

    # engine.search, unsharded
    for mode in ("full", "two_phase", "ideal"):
        for backend in ("ref", "mxu", "fused"):
            fmrs = ((FMR_FORCE_FUSED,) if mode == "full"
                    or backend == "ref" else (FMR_FORCE_FUSED,
                                              FMR_FORCE_DENSE))
            for fmr in fmrs:
                cells.append(_search_cell(device, mode, backend, fmr, True,
                                          False, 1))
                if _expect_fused(backend, 72, mode, fmr):
                    # fused cells also cover the unpacked-operand route
                    cells.append(_search_cell(device, mode, backend, fmr,
                                              False, False, 1))

    # engine.search, sharded over a mesh of positions
    for mode in ("two_phase", "ideal"):
        for backend, fmr in (("mxu", FMR_FORCE_FUSED),
                             ("mxu", FMR_FORCE_DENSE),
                             ("fused", FMR_FORCE_DENSE)):
            cells.append(_search_cell(device, mode, backend, fmr, True,
                                      True, n_shards))
        cells.append(_search_cell(device, mode, "fused", FMR_FORCE_DENSE,
                                  False, True, n_shards))

    # engine.search, routed: both phase-1 dispositions plus the
    # nprobe == n_shards control (no router range)
    cells.append(_routed_cell(device, "two_phase", "mxu", FMR_FORCE_DENSE,
                              True, 2))
    cells.append(_routed_cell(device, "two_phase", "fused", FMR_FORCE_FUSED,
                              True, 2))
    cells.append(_routed_cell(device, "ideal", "fused", FMR_FORCE_FUSED,
                              True, 2))
    cells.append(_routed_cell(device, "ideal", "fused", FMR_FORCE_FUSED,
                              False, 2))
    cells.append(_routed_cell(device, "two_phase", "mxu", FMR_FORCE_DENSE,
                              True, 8))

    # engine.search_tenants: one cell per representative route plus the
    # one-program-across-tenant-counts cell
    cells.append(_tenant_search_cell(device, "full", "ref", FMR_FORCE_FUSED,
                                     True))
    cells.append(_tenant_search_cell(device, "full", "mxu", FMR_FORCE_FUSED,
                                     True))
    cells.append(_tenant_search_cell(device, "two_phase", "mxu",
                                     FMR_FORCE_DENSE, True))
    cells.append(_tenant_search_cell(device, "two_phase", "fused",
                                     FMR_FORCE_FUSED, True))
    cells.append(_tenant_search_cell(device, "ideal", "fused",
                                     FMR_FORCE_FUSED, True))
    cells.append(_tenant_search_cell(device, "ideal", "fused",
                                     FMR_FORCE_FUSED, False))
    cells.append(_tenant_jit_cache_cell(device))

    # MemoryStore.write: scatter vs write-through per n_shards
    cells.append(_write_cell(device, "unsharded", 1))
    cells.append(_write_cell(device, "one_shard", 1))
    cells.append(_write_cell(device, "multi_shard", n_shards))

    cells.append(_episode_votes_cell(device))
    cells.append(_layout_control_cell(device))
    cells.append(_jit_cache_cell(device))
    return cells


# -- runner -----------------------------------------------------------------


def run_cells(cells: list[Cell] | None = None, device=None,
              artifacts: dict | None = None) -> dict:
    """Build + check every cell; returns the contract report dict (the
    reference's shape). `artifacts`, when given, receives each built
    cell's artifacts by its key. The report's device is the one the cells
    were built on: `device` (default the card) when they are built here,
    None for cells passed in without one."""
    if cells is None or device is not None:
        device = cell_device(device)
    if cells is None:
        cells = build_cells(device)
    rows: list[dict] = []
    for cell in cells:
        if cell.skip:
            for inv in cell.invariants:
                rows.append({"entry": cell.entry, "config": cell.config,
                             "invariant": inv, "status": "skip",
                             "detail": cell.skip, "matched": []})
            continue
        try:
            art = cell.build()
        except Exception as e:                  # build error fails the cell
            for inv in cell.invariants:
                rows.append({"entry": cell.entry, "config": cell.config,
                             "invariant": inv, "status": "error",
                             "detail": f"{type(e).__name__}: {e}",
                             "matched": []})
            continue
        if artifacts is not None:
            artifacts[cell.key] = art
        for inv in cell.invariants:
            violations = INVARIANTS[inv](art)
            row = {"entry": cell.entry, "config": cell.config,
                   "invariant": inv,
                   "status": "fail" if violations else "pass",
                   "detail": violations[0] if violations else "",
                   "matched": violations[:8]}
            if inv == "hbm_buffer_bound":
                row["hbm"] = art["hbm"]
            rows.append(row)
    summary = {s: sum(1 for r in rows if r["status"] == s)
               for s in ("pass", "fail", "error", "skip")}
    return {"meta": {"torch": torch.__version__,
                     "device": device and str(device)},
            "summary": summary, "cells": rows}
