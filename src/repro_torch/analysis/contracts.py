"""ONE spelling of every invariant the port's programs keep (counterpart
of `repro.analysis.hlo_contracts`; there is no HLO, so the name says what
is checked).

The reference reads its invariants off compiled HLO text: a store-based
search must not re-run `layout_support`, a shard-local write must not
emit collectives or a scatter, the fused shortlist must engage exactly
when the dispatch rule says so. Here a cell's call is traced once
(analysis/cost.py's `trace`) and the same statements are read off its
record:

  tags          the profiler ranges entered (`torch.profiler.
                record_function`, where the reference has
                `jax.named_scope`): `layout_support` (core/avss.py),
                `shortlist_fused` (both entries of kernels/shortlist.py),
                `router_sketch` (engine/router.route_scores)
  op_census     the aten ops by name: the scatter spellings
  collectives   the bytes copied between mesh positions
                (models/sharding.COLLECTIVE_BYTES)
  f64_ops       the ops that output float64
  launches      the kernels the wrappers launched (or, off the card,
                would launch: the dispatch rule)

Checkers return the offending lines -- empty means the invariant holds.
The registry runner (analysis/registry.py) walks every cell through the
`check_*` functions; tests call the `assert_*` wrappers over the same
functions.
"""

from __future__ import annotations

from typing import Any, Mapping

from repro_torch.core.avss import LAYOUT_TAG
from repro_torch.engine.router import ROUTER_TAG
from repro_torch.kernels.shortlist import FUSED_TAG
from repro_torch.models.sharding import COLLECTIVE_KINDS

#: the collective kinds whose bytes must stay 0 where nothing crosses
#: positions
COLLECTIVE_OPS = COLLECTIVE_KINDS

#: every aten spelling of a scatter: a write of rows at given indices
SCATTER_SPELLINGS = (
    "aten.index_put", "aten.index_put_", "aten._index_put_impl_",
    "aten.scatter", "aten.scatter_", "aten.scatter_add",
    "aten.scatter_add_", "aten.scatter_reduce", "aten.scatter_reduce_",
    "aten.index_copy", "aten.index_copy_", "aten.index_add",
    "aten.index_add_", "aten.masked_scatter", "aten.masked_scatter_")

LAYOUT_SCOPE_TAG = LAYOUT_TAG
FUSED_SCOPE_TAG = FUSED_TAG
ROUTER_SCOPE_TAG = ROUTER_TAG


def _tagged(rec: Mapping[str, Any], tag: str) -> list[str]:
    n = sum(1 for t in rec["tags"] if t == tag)
    return [f"profiler range {tag!r} entered {n} time(s)"] if n else []


# -- checkers: [] == invariant holds ----------------------------------------


def check_no_collectives(rec: Mapping[str, Any]) -> list[str]:
    """No bytes crossed mesh positions during the call."""
    return [f"{k}: {v} bytes" for k, v in rec["collectives"].items()
            if k in COLLECTIVE_OPS and v]


def check_no_scatter_any_spelling(rec: Mapping[str, Any]) -> list[str]:
    """No scatter under ANY spelling."""
    return [f"{op} x{n}" for op, n in rec["op_census"].items()
            if op in SCATTER_SPELLINGS]


def check_scatter_write(rec: Mapping[str, Any]) -> list[str]:
    """The single-shard / unsharded write DID take the scatter path."""
    if check_no_scatter_any_spelling(rec):
        return []
    return ["expected a scatter (the scatter write path) but the call ran "
            "none"]


def check_no_layout_ops(rec: Mapping[str, Any]) -> list[str]:
    """Store-based searches use the write-time grids: the read-time
    `layout_support` range must not be entered."""
    return _tagged(rec, LAYOUT_SCOPE_TAG)


def check_layout_ops_present(rec: Mapping[str, Any]) -> list[str]:
    """Control direction: the raw-array path DOES lay the supports out,
    proving the range is visible to the trace."""
    if _tagged(rec, LAYOUT_SCOPE_TAG):
        return []
    return [f"expected the {LAYOUT_SCOPE_TAG!r} range (read-time layout) "
            f"but the call entered none"]


def check_fused_tag(rec: Mapping[str, Any], expected: bool) -> list[str]:
    """The `shortlist_fused` range is entered iff the dispatch rule
    (engine/sharded._use_fused) says the fused kernel engages."""
    lines = _tagged(rec, FUSED_SCOPE_TAG)
    if expected and not lines:
        return [f"dispatch rule says the fused shortlist engages but the "
                f"{FUSED_SCOPE_TAG!r} range was not entered"]
    if not expected and lines:
        return lines
    return []


def check_router_tag(rec: Mapping[str, Any], expected: bool) -> list[str]:
    """The `router_sketch` range is entered iff routing is engaged
    (`SearchRequest.nprobe < store.n_shards`)."""
    lines = _tagged(rec, ROUTER_SCOPE_TAG)
    if expected and not lines:
        return [f"nprobe < n_shards engages the router but the "
                f"{ROUTER_SCOPE_TAG!r} range was not entered"]
    if not expected and lines:
        return lines
    return []


def check_no_f64(rec: Mapping[str, Any]) -> list[str]:
    """No op outputs a float64 tensor."""
    return list(rec["f64_ops"])


def check_single_jit_entry_across_tenants(entries) -> list[str]:
    """ONE program serves any tenant count: `entries` maps tenant count T
    -> the programs repeated `search_tenants` calls at that T ran (1 when
    every call ran the same op census and launches)."""
    return [f"tenant count {t}: {n} distinct programs "
            f"(expected exactly 1)"
            for t, n in sorted(entries.items()) if n != 1]


def program_of(rec: Mapping[str, Any]) -> tuple:
    """What makes two calls the same program here: the op census and the
    kernels launched (the jit cache entry's counterpart)."""
    return (tuple(sorted(rec["op_census"].items())),
            tuple(sorted(rec["launches"].items())))


# -- assert wrappers (the test-suite surface) -------------------------------


def _raise(violations: list[str], what: str) -> None:
    if violations:
        shown = "\n  ".join(violations[:8])
        raise AssertionError(f"{what}:\n  {shown}")


def assert_no_collectives(rec) -> None:
    _raise(check_no_collectives(rec), "bytes crossed mesh positions")


def assert_no_scatter_any_spelling(rec) -> None:
    _raise(check_no_scatter_any_spelling(rec), "scatter (any spelling)")


def assert_scatter_write(rec) -> None:
    _raise(check_scatter_write(rec), "scatter write path did not engage")


def assert_no_layout_ops(rec) -> None:
    _raise(check_no_layout_ops(rec),
           "read-time layout_support in a store-based search")


def assert_layout_ops_present(rec) -> None:
    _raise(check_layout_ops_present(rec), "layout range not visible")


def assert_fused_tag(rec, expected: bool) -> None:
    _raise(check_fused_tag(rec, expected),
           f"fused-shortlist range mismatch (expected engaged={expected})")


def assert_router_tag(rec, expected: bool) -> None:
    _raise(check_router_tag(rec, expected),
           f"router-sketch range mismatch (expected engaged={expected})")


def assert_no_f64(rec) -> None:
    _raise(check_no_f64(rec), "float64 outputs")


def assert_single_jit_entry_across_tenants(entries) -> None:
    _raise(check_single_jit_entry_across_tenants(entries),
           "multi-tenant search ran another program per tenant count")
