"""The port's cost model (`repro_torch.analysis.cost`), on the CPU.

`kernel_cost` is the one spelling of each hand-written kernel's
operations, bytes and H100 bound: at the shapes of PERF.md's kernel
table it must give every bound printed there, to the digit. The trace
counts a matmul's FLOPs, the bytes of each op, the live and peak bytes,
host syncs (a host constant read back is none), the profiler ranges, and
a kernel wrapper's call as the kernel the card launches. `route_key` and
`diff_resource_reports` equal the reference's on the same inputs
(`launches` in the place of `jit_entries`), and the resource report over
the registry has one row a route.
"""

import copy
import json

import pytest
import torch

from repro.analysis import cost as j_cost
from repro_torch.analysis import cost as C
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.kernels import shortlist

torch.set_num_threads(1)

# (kernel, shapes, PERF.md's bound, its unit): the kernel table's rows
BOUNDS = {
    "shortlist": ("shortlist", dict(b=256, n=65536, d=48, k=64,
                                    row_words=48), "3.85", "us"),
    "shortlist_cub": ("shortlist", dict(b=256, n=65536, d=480, k=64,
                                        row_words=480), "37.8", "us"),
    "shortlist_blocks": ("shortlist_blocks", dict(
        b=256, d=48, p=8, m=64, rows=1024, row_words=48, k=64,
        visited=64), "3.9", "us"),
    "shortlist_blocks_p1": ("shortlist_blocks", dict(
        b=256, d=48, p=1, m=64, rows=1024, row_words=48, k=64,
        visited=61), "3.7", "us"),
    "shortlist_blocks_tenants": ("shortlist_blocks", dict(
        b=256, d=48, p=1, m=64, rows=4096, row_words=48, k=64,
        visited=64), "15.2", "us"),
    "shortlist_blocks_cub": ("shortlist_blocks", dict(
        b=256, d=480, p=8, m=64, rows=1024, row_words=480, k=64,
        visited=64), "37.8", "us"),
    "mcam_dist": ("mcam_dist", dict(b=256, n=65536, k=192), "27.6", "us"),
    "mcam_dist_cub": ("mcam_dist", dict(b=256, n=65536, k=1920), "95.4",
                      "us"),
    "mcam_search": ("mcam_search", dict(b=16, n=65536, s=64, sl=24),
                    "1.082", "ms"),
    "mcam_search_cub": ("mcam_search", dict(b=4, n=65536, s=500, sl=24),
                        "2.113", "ms"),
    "mcam_rescore": ("mcam_rescore", dict(b=256, k=64, s=64, sl=24,
                                          uniq=9000), "16.9", "us"),
    "mcam_rescore_cub": ("mcam_rescore", dict(b=256, k=64, s=500, sl=24,
                                              uniq=9000), "132", "us"),
    "mcam_episode": ("mcam_episode", dict(b=800, n=2000, s=64, sl=24),
                     "2.091", "ms"),
    "mcam_episode_cub": ("mcam_episode", dict(b=200, n=250, s=500, sl=24),
                         "0.510", "ms"),
}


@pytest.mark.parametrize("row", list(BOUNDS))
def test_kernel_bounds_equal_the_kernel_table(row):
    name, shapes, shown, unit = BOUNDS[row]
    c = C.kernel_cost(name, **shapes)
    value = c["bound_ms"] * (1e3 if unit == "us" else 1)
    decimals = len(shown.split(".")[1]) if "." in shown else 0
    assert f"{value:.{decimals}f}" == shown, (row, value)
    assert c["bound_by"] in ("bytes", "operations")
    assert c["written"] <= c["bytes"]


def test_kernel_cost_formulas():
    c = C.kernel_cost("shortlist", b=2, n=10, d=3, k=4, row_words=3,
                      masked=False)
    # the one-hot product: 2 b n 4d multiply-adds, int8 tensor cores for
    # packed fields of 8 bits or fewer, else the bf16 rate
    assert c["ops"] == 2 * 2 * 10 * 4 * 3
    assert c["rate"] == C.INT8_TENSOR_OPS_PER_S == 1979e12
    assert C.kernel_cost("shortlist", b=2, n=10, d=3, k=4, row_words=6,
                         bits=16)["rate"] == C.BF16_TENSOR_OPS_PER_S
    assert c["bytes"] == 10 * 3 * 4 + 2 * 3 * 4 + 2 * 4 * 12
    blocks = C.kernel_cost("shortlist_blocks", b=2, d=3, p=2, m=4, rows=10,
                           row_words=3, k=4, bits=4)
    assert blocks["ops"] == 2 * 2 * 2 * 10 * 4 * 3
    assert blocks["rate"] == C.INT8_TENSOR_OPS_PER_S
    assert C.kernel_cost("mcam_dist", b=2, n=3, k=8)["rate"] == \
        C.BF16_TENSOR_OPS_PER_S
    assert C.kernel_cost("mcam_dist", b=2, n=3, k=8, elem=4)["rate"] == \
        C.F32_OPS_PER_S
    assert C.PHYSICS_OPS_PER_CELL == 45
    assert C.EPISODE_BACKWARD_OPS_PER_CELL == 57
    with pytest.raises(ValueError, match="no kernel"):
        C.kernel_cost("nope")


def test_trace_counts_flops_bytes_memory_and_syncs():
    a = torch.ones(8, 16)
    b = torch.ones(16, 4)

    def fn(x, w):
        y = (x @ w).relu()
        c = torch.tensor(3.0).item()            # a host constant: no sync
        return y.view(-1).sum() * c, y.sum().item()

    out, rec = C.trace(fn, a, b)
    assert rec["flops"] == 2 * 8 * 16 * 4
    assert rec["host_syncs"] == 1
    assert rec["argument_bytes"] == (8 * 16 + 16 * 4) * 4
    assert rec["temp_bytes"] >= 2 * 8 * 4 * 4       # the mm and relu outputs
    assert rec["peak_bytes"] == rec["argument_bytes"] + rec["temp_bytes"]
    assert rec["op_census"]["aten.mm"] == 1
    # mm reads both operands and writes its output; a view moves nothing
    assert rec["hbm_bytes_read"] >= (8 * 16 + 16 * 4) * 4
    assert "aten.view" in rec["op_census"]
    assert rec["f64_ops"] == [] and rec["tags"] == []
    assert out[1] == 512.0 and float(out[0]) == 1536.0


def test_trace_sees_ranges_and_float64():
    def fn(x):
        with torch.profiler.record_function("layout_support"):
            return x.to(torch.float64).sum()  # lint: allow=f64-astype
    rec = C.traced_cost(fn, torch.ones(3))
    assert rec["tags"] == ["layout_support"]
    assert any("float64" in line for line in rec["f64_ops"])


def test_a_wrapper_call_counts_as_its_kernel():
    """Off the card a wrapper runs its plain version uncounted and the
    trace counts the kernel the card launches, at kernel_cost."""
    g = torch.Generator().manual_seed(0)
    q = torch.randint(0, 4, (5, 12), generator=g)
    proj = torch.randint(0, 100, (300, 48), generator=g).to(torch.bfloat16)
    out, rec = C.trace(lambda a, b: shortlist.lut_shortlist(a, b, 7), q,
                       proj)
    assert rec["launches"] == {"shortlist": 1}
    want = C.kernel_cost("shortlist", b=5, n=300, d=12, k=7, row_words=24,
                         masked=False)
    assert rec["kernels"]["shortlist"]["ops"] == want["ops"]
    assert rec["flops"] == want["ops"]
    assert rec["tags"] == [shortlist.FUSED_TAG]
    # the plain version's ops are not in the census
    assert "aten.topk" not in rec["op_census"]
    assert torch.equal(out[1], shortlist.lut_shortlist_plain(q, proj, 7)[1])


def _rows(field):
    base = [
        {"entry": "engine.search", "config": {"mode": "ideal", "k": 16},
         "status": "ok", "flops": 100.0, "hbm_bytes_read": 10.0,
         "hbm_bytes_written": 0.0, "temp_bytes": 5, "peak_bytes": 9,
         field: 1},
        {"entry": "engine.search", "config": {"mode": "full"},
         "status": "ok", "flops": 0.0, "hbm_bytes_read": 0.5,
         "hbm_bytes_written": 2.0, "temp_bytes": 0, "peak_bytes": 0,
         field: 1},
        {"entry": "MemoryStore.write", "config": {"path": "x"},
         "status": "ok", "flops": 1e6, "hbm_bytes_read": 1e6,
         "hbm_bytes_written": 1e3, "temp_bytes": 10, "peak_bytes": 20,
         field: None},
        {"entry": "episode_votes", "config": {}, "status": "error",
         "flops": None},
    ]
    return {"routes": base}


def _mutate(report, field):
    new = copy.deepcopy(report)
    r = new["routes"]
    r[0]["flops"] = 104.0          # within 5%
    r[0]["temp_bytes"] = 7         # +40%
    r[1]["hbm_bytes_read"] = 1.4   # under the absolute floor of 1
    r[1][field] = 2                # launches / entries must be exact
    r[2][field] = 3                # None -> value
    del r[2]["peak_bytes"]
    r.append({"entry": "new", "config": {"a": 1}, "status": "ok"})
    return new


@pytest.mark.parametrize("rtol", [0.05, 0.5, 0.0])
def test_diff_and_route_key_equal_the_reference(rtol):
    old_t, old_j = _rows("launches"), _rows("jit_entries")
    new_t, new_j = _mutate(old_t, "launches"), _mutate(old_j, "jit_entries")
    got = C.diff_resource_reports(old_t, new_t, rtol=rtol)
    want = j_cost.diff_resource_reports(old_j, new_j, rtol=rtol)
    rename = [{**d, "field": d["field"].replace("jit_entries", "launches")}
              for d in want["drifted"]]
    assert got["drifted"] == rename
    assert got["missing"] == want["missing"]
    assert got["added"] == want["added"]
    for row in old_t["routes"]:
        assert C.route_key(row) == j_cost.route_key(row)
    # a lost route is missing on both
    lost = copy.deepcopy(old_t)
    lost["routes"].pop(0)
    assert C.diff_resource_reports(old_t, lost)["missing"] == [
        C.route_key(old_t["routes"][0])]


def test_per_kernel_launches_are_held_exactly():
    a = {"routes": [{"entry": "e", "config": {}, "status": "ok",
                     "launches": {"shortlist": 1}}]}
    b = copy.deepcopy(a)
    assert C.diff_resource_reports(a, b)["drifted"] == []
    b["routes"][0]["launches"] = {"shortlist": 1, "mcam_rescore": 1}
    assert C.diff_resource_reports(a, b)["drifted"][0]["field"] == \
        "launches"


def test_roofline_metrics_and_collective_rates():
    rec = {"flops": 10.0, "hbm_bytes_read": 3.0, "hbm_bytes_written": 1.0,
           "collectives": {"all-gather": 5, "reduce-scatter": 2}}
    m = C.roofline_metrics(rec)
    assert m["bytes"] == 4.0 and m["coll_total"] == 7.0
    assert m["coll_all-reduce"] == 0.0
    assert C.metric_clamp(C.metric_add(m, m, 1.0, -2.0))["flops"] == 0.0
    assert C.collective_bytes_per_s(8) == C.NVLINK_BYTES_PER_S
    assert C.collective_bytes_per_s(256) == C.NIC_BYTES_PER_S


def test_resource_report_and_cost_cli(tmp_path, capsys):
    """`cost` writes one row a registry route (launches from the dispatch
    rule here); `cost-diff` of a report against itself is green, against
    a drifted one red."""
    out = tmp_path / "res.json"
    assert analysis_main(["cost", "--device", "cpu", "--out",
                          str(out)]) == 0
    report = json.loads(out.read_text())
    from repro_torch.analysis import registry
    assert [C.route_key(r) for r in report["routes"]] == [
        c.key for c in registry.build_cells("cpu")]
    assert report["summary"]["error"] == 0
    fused = [r for r in report["routes"]
             if r["entry"] == "engine.search"
             and r["config"].get("backend") == "fused"
             and r["config"].get("mode") == "ideal"
             and not r["config"].get("sharded")
             and "nprobe" not in r["config"]]
    assert fused and all(r["launches"].get("shortlist") == 1 for r in fused)
    assert analysis_main(["cost-diff", str(out), str(out)]) == 0
    bad = json.loads(out.read_text())
    bad["routes"][0]["flops"] = (bad["routes"][0]["flops"] or 0) * 2 + 10
    drifted = tmp_path / "bad.json"
    drifted.write_text(json.dumps(bad))
    assert analysis_main(["cost-diff", str(out), str(drifted)]) == 1
    assert "DRIFT" in capsys.readouterr().out
