"""One cost model for the port (counterpart of `repro.analysis.cost`).

There is no XLA here, so no compiled program to read `cost_analysis()`
or `memory_analysis()` from, and no HLO. What takes their place is one
eager TRACE of a call: the call runs once under a `TorchDispatchMode`
(`Trace`) that sees every aten op. On the meta device it runs on shapes
alone, so a full-width step costs no memory. Everything that reads op
costs (`TorchDispatchMode`, `FlopCounterMode`'s FLOP formulas) lives
HERE; the `cost-call` lint rule keeps it so.

Three parts:

* Trace extraction over one call: `traced_cost(fn, *args)` (or
  `trace`, which also returns fn's result) gives {flops,
  hbm_bytes_read, hbm_bytes_written, temp_bytes, peak_bytes, op_census,
  host_syncs} and more (`Trace.record`). FLOPs are the formulas of
  `torch.utils.flop_counter` (matmul, bmm, conv; einsum reaches them as
  bmm); bytes are each op's input and output tensors (view ops move
  none); the live bytes of what the call allocates are tracked until
  freed (`weakref.finalize` on each new storage's tensor) for the temp
  and peak bytes; the op census counts aten ops by name (the
  reference's `hlo_op_census`); host syncs count `_local_scalar_dense`
  of a value the device made (a host constant read back is none) and
  copies from a device to the host. An eager trace counts every
  iteration of every loop, so the reference's trip-count correction
  (`scan_trip_count_totals`, its count-1 / count-2 variant compiles)
  has no counterpart. `roofline_metrics`, `metric_add` and
  `metric_clamp` work over trace records.

* `kernel_cost(name, **shapes)`: operations, bytes and the H100 bound of
  each hand-written kernel of `csrc/`, the one spelling of the formulas
  (chip_smoke.py's kernel rows read them). Under a trace a kernel
  wrapper reports each call (`kernels/_build.TRACE`): off the card its
  plain version runs uncounted and the call counts as the kernel the
  card launches, at this cost; on the card the launch adds the same.

* The resource report over the port's contract registry
  (analysis/registry.py): `resource_row` / `resource_report`, one row a
  route with the reference's fields, where `jit_entries` (there is no
  jit cache) becomes `launches`, per kernel; `host_syncs` is reported
  and gates nothing. `diff_resource_reports` is the reference's
  (launches held exactly).

The rates are an NVIDIA H100 SXM's, the card of `CARD`, from NVIDIA's
data sheet (dense).

No counterpart, by design (the names that read compiled HLO or XLA's
analyses): `DTYPE_BYTES`, `CENSUS_OPS`, `MEMORY_STATS`, `shape_bytes`,
`parse_collectives`, `hlo_op_census`, `compiled_cost`, `hbm_rw_bytes`,
`compiled_memory`, `temp_bytes`, `peak_bytes_of`,
`scan_trip_count_totals`, and `roofline_metrics`' `compiled` argument
(it takes a trace record).
"""

from __future__ import annotations

import dataclasses
import json
import time
import weakref
from typing import Any, Mapping

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.models import sharding

#: the card the rates are for, as `nvidia-smi --query-gpu=name,power.limit
#: --format=csv,noheader` names it
CARD = "NVIDIA H100 80GB HBM3, 700 W"
#: HBM3 rate, bytes/s
HBM_BYTES_PER_S = 3.35e12
#: float32 outside the tensor cores, ops/s
F32_OPS_PER_S = 67e12
#: bf16 tensor cores, dense, FLOP/s
BF16_TENSOR_OPS_PER_S = 989e12
#: int8 tensor cores, dense, ops/s
INT8_TENSOR_OPS_PER_S = 1979e12
#: NVLink 4 a direction, bytes/s, on a mesh of up to NVLINK_GPUS cards
NVLINK_BYTES_PER_S = 450e9
NVLINK_GPUS = 8
#: beyond one NVLink domain: one NDR400 NIC a card (DGX H100), bytes/s
NIC_BYTES_PER_S = 50e9

#: the collective kinds of the reference, which models/sharding.py counts
COLLECTIVE_KINDS: tuple[str, ...] = sharding.COLLECTIVE_KINDS

#: fields diffed between two resource reports (route-wise)
RESOURCE_FIELDS: tuple[str, ...] = (
    "flops", "hbm_bytes_read", "hbm_bytes_written", "temp_bytes",
    "peak_bytes", "launches")

# Scalar operations of one noisy cell of the physics kernel, counted by
# hand from the cell formula and kept fixed, so that a bound reads the
# same whatever the kernel's implementation: two hash streams a cell (one
# murmur finalizer of 8 ops each plus the coordinate xor / add: 2 x 10),
# the uniform conversions (2 x 3), Box-Muller (log, mul, sqrt, cos, 2 mul:
# 6), mismatch (2), noise fma + clip (4), exp argument + exp + sum (3) and
# the dist sum (1); the per-string terms (the 4-coordinate prefixes, read
# noise, division, thresholds) add ~3 a cell at 24 cells a string.
PHYSICS_OPS_PER_CELL = 2 * 10 + 2 * 3 + 6 + 2 + 4 + 3 + 1 + 3

# Scalar operations of one cell of the episodic backward
# (csrc/mcam_episode.cu), counted the same way: the forward's 45 to
# recompute the cell's current, then the clip mask (2), the cell's
# resistance term times the mask (1), its gradient a * e + g0 (2), the
# sign of q - s (2), the two sums into dq and ds (2), and the string's
# sigmoid terms over 8 thresholds and the current's derivative (~75 a
# string) spread over its 24 cells (3).
EPISODE_BACKWARD_OPS_PER_CELL = PHYSICS_OPS_PER_CELL + 2 + 1 + 2 + 2 + 2 + 3


def collective_bytes_per_s(chips: int) -> float:
    """The link rate a card's collective bytes move at on a mesh of
    `chips` cards: NVLink within one 8-card domain, the NIC beyond."""
    return NVLINK_BYTES_PER_S if chips <= NVLINK_GPUS else NIC_BYTES_PER_S


# -- the hand-written kernels ----------------------------------------------


def _lut_rate(bits: int) -> float:
    """The tensor-core rate of a one-hot LUT product whose entries are
    `bits` wide: int8 for packed fields of 8 bits or fewer, else bf16."""
    return INT8_TENSOR_OPS_PER_S if bits <= 8 else BF16_TENSOR_OPS_PER_S


def kernel_cost(name: str, **s) -> dict[str, Any]:
    """Operations, bytes (each input read once, each output written once)
    and the H100 bound of one launch of kernel `name` (a key of
    `kernels/_build.LAUNCHES`) at the shapes `s`:

      shortlist         b queries, n rows, d dims, k, row_words (32-bit
                        words a row of the streamed operand), masked (a
                        row mask is read; default True), bits (of a LUT
                        entry; default 8): the one-hot product, 2 b n 4d
                        multiply-adds, at the int8 tensor-core rate for
                        fields of 8 bits or fewer, else the bf16 one
      shortlist_blocks  b, d, p visits a query, m blocks of `rows` rows,
                        row_words, k, bits, visited (blocks some query
                        visits, read once; default min(m, b p)): 2 b p
                        rows 4d, at the same rates
      mcam_dist         b x k by n x k, elem bytes an operand element
                        (default 2, bf16 on the tensor cores): 2 b n k
      mcam_search       b queries, n supports, s strings of sl cells:
                        PHYSICS_OPS_PER_CELL a cell
      mcam_rescore      b queries, k candidates, s, sl, uniq (distinct
                        rows read; default b k): the same a cell
      mcam_episode      b, n, s, sl: EPISODE_BACKWARD_OPS_PER_CELL a cell

    Returns {ops, bytes, written, rate, bound_ms, bound_by}; the bound is
    the larger of bytes over HBM_BYTES_PER_S and ops over `rate`."""
    rate = F32_OPS_PER_S
    if name == "shortlist":
        b, n, d, k = s["b"], s["n"], s["d"], s["k"]
        written = b * k * 12
        nbytes = (n * s["row_words"] * 4 + b * d * 4
                  + (n if s.get("masked", True) else 0) + written)
        ops = 2 * b * n * 4 * d
        rate = _lut_rate(s.get("bits", 8))
    elif name == "shortlist_blocks":
        b, p, m, rows, k = s["b"], s["p"], s["m"], s["rows"], s["k"]
        visited = s.get("visited")
        visited = min(m, b * p) if visited is None else visited
        written = b * k * 12
        nbytes = (visited * rows * (s["row_words"] * 4 + 1)
                  + b * s["d"] * 4 + b * p * 8 + m * 8 + written)
        ops = 2 * b * p * rows * 4 * s["d"]
        rate = _lut_rate(s.get("bits", 8))
    elif name == "mcam_dist":
        b, n, k, elem = s["b"], s["n"], s["k"], s.get("elem", 2)
        written = b * n * 4
        nbytes = (b * k + n * k) * elem + written
        ops = 2 * b * n * k
        if elem == 2:
            rate = BF16_TENSOR_OPS_PER_S
    elif name == "mcam_search":
        b, n, st, sl = s["b"], s["n"], s["s"], s["sl"]
        written = b * n * 8
        nbytes = n * st * sl + b * st * sl + written + st * 4
        ops = b * n * st * sl * PHYSICS_OPS_PER_CELL
    elif name == "mcam_rescore":
        b, k, st, sl = s["b"], s["k"], s["s"], s["sl"]
        uniq = s.get("uniq")
        uniq = b * k if uniq is None else uniq
        written = b * k * 4
        nbytes = (uniq * st * sl + b * st * sl + b * k * 16 + written
                  + st * 4)
        ops = b * k * st * sl * PHYSICS_OPS_PER_CELL
    elif name == "mcam_episode":
        b, n, st, sl = s["b"], s["n"], s["s"], s["sl"]
        grids = b * st * sl + n * st * sl
        written = grids * 4
        nbytes = grids + 2 * b * n * 4 + written + st * 4
        ops = b * n * st * sl * EPISODE_BACKWARD_OPS_PER_CELL
    else:
        raise ValueError(f"kernel_cost: no kernel {name!r}")
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return {"ops": ops, "bytes": nbytes, "written": written, "rate": rate,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# -- the trace --------------------------------------------------------------

#: ops that move no bytes of their own
_NO_BYTES = frozenset((
    "aten._local_scalar_dense", "aten.lift_fresh", "aten.lift_fresh_copy",
    "aten.detach", "aten.alias", "aten.empty", "aten.empty_like",
    "aten.empty_strided", "aten.new_empty", "aten.new_empty_strided",
    "aten.set_", "aten.resize_", "profiler._record_function_enter",
    "profiler._record_function_enter_new", "profiler._record_function_exit"))
#: ops whose output is a host constant
_CONSTANT = frozenset(("aten.lift_fresh", "aten.lift_fresh_copy",
                       "aten.scalar_tensor"))
_TAG_OPS = frozenset(("profiler._record_function_enter",
                      "profiler._record_function_enter_new"))


def _tensors(obj, seen: set | None = None) -> list:
    """The tensors an argument holds: in dicts, lists, tuples, dataclasses
    and the port's placed containers (a `Placed` leaf's tiles, a
    `ShardedRows`' blocks)."""
    from repro_torch.engine.sharded import ShardedRows
    from repro_torch.models.sharding import Placed
    if seen is None:
        seen = set()
    if id(obj) in seen:
        return []
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        items = list(obj.values())
    elif isinstance(obj, (list, tuple)):
        items = list(obj)
    elif isinstance(obj, Placed):
        items = [r for reps in obj.tiles.values() for r in reps]
    elif isinstance(obj, ShardedRows):
        items = list(obj.blocks)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        items = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    else:
        return []
    return [t for x in items for t in _tensors(x, seen)]


def _storage_key(t) -> int:
    return t.untyped_storage()._cdata


def _storage_bytes(tensors) -> int:
    """Bytes of the distinct storages of `tensors`."""
    seen = {}
    for t in tensors:
        seen.setdefault(_storage_key(t), t.untyped_storage().nbytes())
    return sum(seen.values())


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class Trace(TorchDispatchMode):
    """Counts what one call does (see the module docstring): flops,
    bytes, live and peak bytes, ops by name, host syncs, profiler
    ranges entered (`tags`), float64 outputs, and the kernels the
    wrappers reported."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.read = 0.0
        self.written = 0.0
        self.census: dict[str, int] = {}
        self.host_syncs = 0
        self.tags: list[str] = []
        self.f64_ops: list[str] = []
        self.kernels: dict[str, dict[str, float]] = {}
        self.live = 0
        self.peak = 0
        self._live: dict[int, int] = {}
        self._consts: set[int] = set()      # ids of host constants
        self._suspended = 0

    # memory ------------------------------------------------------------
    def _free(self, key: int) -> None:
        self.live -= self._live.pop(key, 0)

    def _track(self, t) -> None:
        if t.layout != torch.strided:
            return
        key = _storage_key(t)
        if key in self._live:
            return
        nb = t.untyped_storage().nbytes()
        self._live[key] = nb
        self.live += nb
        self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._free, key)

    # kernels -----------------------------------------------------------
    def _kernel(self, name: str, shapes) -> None:
        self._suspended += 1
        try:
            cost = kernel_cost(name, **shapes())
        finally:
            self._suspended -= 1
        k = self.kernels.setdefault(
            name, {"launches": 0, "ops": 0, "bytes": 0})
        k["launches"] += 1
        k["ops"] += cost["ops"]
        k["bytes"] += cost["bytes"]
        self.flops += cost["ops"]
        self.read += cost["bytes"] - cost["written"]
        self.written += cost["written"]

    def off_card(self, name: str, shapes, plain):
        """A wrapper off the card: plain() uncounted, the call counted
        as kernel `name`, its outputs tracked as new storage."""
        self._kernel(name, shapes)
        self._suspended += 1
        try:
            out = plain()
        finally:
            self._suspended -= 1
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._track(t)
                if t.dtype == torch.float64:  # lint: allow=f64-astype
                    self.f64_ops.append(f"kernel {name}")
        return out

    def launched(self, name: str, shapes) -> None:
        """A wrapper launched kernel `name` on the card."""
        self._kernel(name, shapes)

    # ops ---------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        op = str(func.overloadpacket)
        if op in _TAG_OPS and not self._suspended:
            self.tags.append(str(args[0]))
        out = func(*args, **kwargs)
        if self._suspended:
            return out
        ins = [a for a in pytree.tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        outs = [o for o in pytree.tree_leaves(out)
                if isinstance(o, torch.Tensor)]
        if op in _CONSTANT or ins and all(id(a) in self._consts
                                          for a in ins):
            # a host constant (or made from host constants only, its
            # copy to a device included): no device work
            for o in outs:
                if id(o) not in self._consts:
                    self._consts.add(id(o))
                    weakref.finalize(o, self._consts.discard, id(o))
            return out
        self.census[op] = self.census.get(op, 0) + 1
        if op == "aten._local_scalar_dense":
            self.host_syncs += 1
            return out
        if (op in ("aten._to_copy", "aten.copy_") and ins and outs
                and outs[0].device.type == "cpu"
                and any(a.device.type == "cuda" for a in ins)):
            self.host_syncs += 1
        fc = flop_registry.get(func.overloadpacket)
        if fc is not None:
            self.flops += fc(*args, **kwargs, out_val=out)
        aliased = [r.alias_info is not None
                   for r in func._schema.returns]
        if op not in _NO_BYTES and not func.is_view:
            self.read += sum(_nbytes(a) for a in ins)
            self.written += sum(_nbytes(o) for o in outs)
        for i, o in enumerate(outs):
            if o.dtype == torch.float64:  # lint: allow=f64-astype
                self.f64_ops.append(f"{op} -> float64 "
                                    f"{tuple(o.shape)}")
            if not func.is_view and not (i < len(aliased)
                                         and aliased[i]):
                self._track(o)
        return out


def trace(fn, *args, **kwargs) -> tuple[Any, dict[str, Any]]:
    """Run fn(*args, **kwargs) once under the trace -> (its result, the
    record): flops, hbm_bytes_read / hbm_bytes_written, temp_bytes (the
    peak of the bytes the call allocated and still held), peak_bytes
    (the arguments' storage plus temp_bytes), argument_bytes, op_census
    {aten op: count}, host_syncs, launches {kernel: count} and kernels
    {kernel: {launches, ops, bytes}} (the wrappers' reports), tags (the
    profiler ranges entered, in order), f64_ops (ops that output
    float64), collectives {kind: bytes} (models/sharding's counter over
    the call) and seconds."""
    from repro_torch.kernels import _build

    arg_bytes = _storage_bytes(_tensors((args, kwargs)))
    before = dict(sharding.COLLECTIVE_BYTES)
    tr = Trace()
    t0 = time.perf_counter()
    prev, _build.TRACE[0] = _build.TRACE[0], tr
    try:
        with tr:
            out = fn(*args, **kwargs)
    finally:
        _build.TRACE[0] = prev
    seconds = time.perf_counter() - t0
    record = {
        "flops": float(tr.flops), "hbm_bytes_read": float(tr.read),
        "hbm_bytes_written": float(tr.written), "temp_bytes": int(tr.peak),
        "peak_bytes": int(arg_bytes + tr.peak),
        "argument_bytes": int(arg_bytes),
        "op_census": dict(sorted(tr.census.items())),
        "host_syncs": tr.host_syncs,
        "launches": {k: int(v["launches"])
                     for k, v in sorted(tr.kernels.items())},
        "kernels": {k: dict(v) for k, v in sorted(tr.kernels.items())},
        "tags": list(tr.tags), "f64_ops": list(tr.f64_ops),
        "collectives": {k: sharding.COLLECTIVE_BYTES.get(k, 0)
                        - before.get(k, 0) for k in COLLECTIVE_KINDS},
        "seconds": seconds}
    return out, record


def traced_cost(fn, *args, **kwargs) -> dict[str, Any]:
    """The trace record of one call of fn (see `trace`)."""
    return trace(fn, *args, **kwargs)[1]


def roofline_metrics(record: Mapping[str, Any]) -> dict[str, float]:
    """{flops, bytes, coll_<kind>..., coll_total} of a trace record (the
    reference's metric; nothing to correct: see the module docstring)."""
    out = {"flops": float(record["flops"]),
           "bytes": float(record["hbm_bytes_read"]
                          + record["hbm_bytes_written"])}
    coll = record.get("collectives", {})
    for k in COLLECTIVE_KINDS:
        out[f"coll_{k}"] = float(coll.get(k, 0))
    out["coll_total"] = float(sum(coll.get(k, 0) for k in COLLECTIVE_KINDS))
    return out


def metric_add(a: Mapping[str, float], b: Mapping[str, float],
               sa: float = 1.0, sb: float = 1.0) -> dict[str, float]:
    """Keywise linear combination ``sa*a + sb*b`` over a's keys."""
    return {k: sa * a[k] + sb * b.get(k, 0.0) for k in a}


def metric_clamp(a: Mapping[str, float]) -> dict[str, float]:
    """Keywise clamp to >= 0."""
    return {k: max(v, 0.0) for k, v in a.items()}


# -- the per-route resource report ------------------------------------------


def route_key(row: Mapping[str, Any]) -> str:
    """``entry|sorted-config`` -- the same key shape registry.Cell.key
    uses, so resource rows and contract cells align."""
    return f"{row['entry']}|{json.dumps(row['config'], sort_keys=True)}"


def _null_row(entry: str, config: Mapping[str, Any], status: str,
              detail: str) -> dict[str, Any]:
    return {"entry": entry, "config": dict(config), "status": status,
            "detail": detail, "flops": None, "hbm_bytes_read": None,
            "hbm_bytes_written": None, "temp_bytes": None,
            "peak_bytes": None, "launches": None, "op_census": {},
            "host_syncs": None}


def resource_row(entry: str, config: Mapping[str, Any],
                 art: Mapping[str, Any]) -> dict[str, Any]:
    """One resource-report row from a built registry cell's artifacts:
    a cell that traced a call ("trace") gets its {flops, hbm read /
    written, temp, peak, launches, op_census, host_syncs}; a cell that
    checks repeated calls ("launch_counts") reports their launches."""
    row = _null_row(entry, config, "ok", "")
    rec = art.get("trace")
    if rec is not None:
        row.update(flops=rec["flops"], hbm_bytes_read=rec["hbm_bytes_read"],
                   hbm_bytes_written=rec["hbm_bytes_written"],
                   temp_bytes=rec["temp_bytes"],
                   peak_bytes=rec["peak_bytes"], launches=rec["launches"],
                   op_census=rec["op_census"], host_syncs=rec["host_syncs"])
    if "launch_counts" in art:
        row["launches"] = art["launch_counts"]
    return row


def resource_report(cells=None, device=None) -> dict[str, Any]:
    """Per-route resource rows over the contract registry matrix
    (`registry.build_cells(device)`, default the card; the report's
    device None for cells passed in without one); build errors become
    rows with status "error", so the report has one row per registered
    route."""
    from repro_torch.analysis import registry

    if cells is None or device is not None:
        device = registry.cell_device(device)
    if cells is None:
        cells = registry.build_cells(device)
    rows: list[dict[str, Any]] = []
    for cell in cells:
        if cell.skip:
            rows.append(_null_row(cell.entry, cell.config, "skip",
                                  cell.skip))
            continue
        try:
            art = cell.build()
        except Exception as e:          # build error surfaces in the row
            rows.append(_null_row(cell.entry, cell.config, "error",
                                  f"{type(e).__name__}: {e}"))
            continue
        rows.append(resource_row(cell.entry, cell.config, art))
    summary: dict[str, Any] = {"routes": len(rows)}
    for s in ("ok", "skip", "error"):
        summary[s] = sum(1 for r in rows if r["status"] == s)
    summary["total_flops"] = float(sum(r["flops"] or 0.0 for r in rows))
    return {"meta": {"torch": torch.__version__,
                     "device": device and str(device)},
            "summary": summary, "routes": rows}


def diff_resource_reports(old: Mapping[str, Any], new: Mapping[str, Any],
                          rtol: float = 0.05) -> dict[str, Any]:
    """Route-wise drift between two resource reports (the reference's).

    Only rows with status "ok" on both sides are compared. A route that
    was ok in `old` but is gone (or no longer ok) in `new` is `missing`
    (red); `launches` must match exactly, every other RESOURCE_FIELD
    within ``rtol`` relative tolerance (absolute floor 1.0, so zero
    baselines do not trip on rounding); new routes are `added`
    (reported, never fatal)."""
    old_rows = {route_key(r): r for r in old.get("routes", [])
                if r.get("status") == "ok"}
    new_rows = {route_key(r): r for r in new.get("routes", [])
                if r.get("status") == "ok"}
    missing = sorted(set(old_rows) - set(new_rows))
    added = sorted(set(new_rows) - set(old_rows))
    drifted: list[dict[str, Any]] = []
    for key in sorted(set(old_rows) & set(new_rows)):
        o, n = old_rows[key], new_rows[key]
        for field in RESOURCE_FIELDS:
            ov, nv = o.get(field), n.get(field)
            if ov is None and nv is None:
                continue
            if ov is None or nv is None:
                drifted.append({"route": key, "field": field, "old": ov,
                                "new": nv, "rel": None})
                continue
            if isinstance(ov, dict) or isinstance(nv, dict):
                if ov != nv:            # per-kernel launches: exact
                    drifted.append({"route": key, "field": field,
                                    "old": ov, "new": nv, "rel": None})
                continue
            ov_f, nv_f = float(ov), float(nv)
            tol = 0.0 if field == "launches" \
                else rtol * max(abs(ov_f), 1.0)
            if abs(nv_f - ov_f) > tol:
                drifted.append({"route": key, "field": field, "old": ov,
                                "new": nv,
                                "rel": (nv_f - ov_f) / max(abs(ov_f), 1.0)})
    return {"drifted": drifted, "missing": missing, "added": added}
