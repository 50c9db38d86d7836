"""CLI for the port's contract guard: run / lint / diff / cost /
cost-diff (see the package docstring), with the reference's exit codes.

`run` and `cost` build their cells on the card unless `--device` names
another (`--device cpu` runs the kernels' plain versions on the CPU); the
sharded cells use 8 positions of that device, so nothing needs a forced
device count.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

DEFAULT_REPORT = os.path.join("results", "contract_report.json")
DEFAULT_RESOURCES = os.path.join("results", "resource_report.json")
DEFAULT_LINT_PATH = os.path.join("src", "repro_torch")


def _cmd_run(args: argparse.Namespace) -> int:
    from repro_torch.analysis import registry

    report = registry.run_cells(device=args.device)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w", encoding="utf-8") as fh:
        json.dump(report, fh, indent=2, sort_keys=True)
    s = report["summary"]
    print(f"contract report: {s['pass']} pass, {s['fail']} fail, "
          f"{s['error']} error, {s['skip']} skip -> {args.out}")
    bad = [r for r in report["cells"] if r["status"] in ("fail", "error")]
    for r in bad:
        print(f"  {r['status'].upper()} {r['entry']} "
              f"{json.dumps(r['config'], sort_keys=True)} "
              f"[{r['invariant']}] {r['detail']}")
        for line in r["matched"]:
            print(f"    | {line}")
    return 1 if bad else 0


def _cmd_lint(args: argparse.Namespace) -> int:
    from repro_torch.analysis import lint

    paths = args.paths or [DEFAULT_LINT_PATH]
    findings = lint.lint_paths(paths)
    for f in findings:
        print(f.format())
    print(f"lint: {len(findings)} finding(s) over {len(paths)} path(s)")
    return 1 if findings else 0


def _failures(report: dict) -> set[str]:
    return {f"{r['entry']}|{json.dumps(r['config'], sort_keys=True)}"
            f"|{r['invariant']}"
            for r in report["cells"] if r["status"] in ("fail", "error")}


def _cmd_diff(args: argparse.Namespace) -> int:
    with open(args.old, encoding="utf-8") as fh:
        old = json.load(fh)
    with open(args.new, encoding="utf-8") as fh:
        new = json.load(fh)
    fresh = sorted(_failures(new) - _failures(old))
    fixed = sorted(_failures(old) - _failures(new))
    for key in fixed:
        print(f"fixed: {key}")
    for key in fresh:
        print(f"NEW FAILURE: {key}")
    print(f"diff: {len(fresh)} new failure(s), {len(fixed)} fixed")
    return 1 if fresh else 0


def _cmd_cost(args: argparse.Namespace) -> int:
    from repro_torch.analysis import cost

    report = cost.resource_report(device=args.device)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w", encoding="utf-8") as fh:
        json.dump(report, fh, indent=2, sort_keys=True)
    s = report["summary"]
    print(f"resource report: {s['ok']} route(s) ok, {s['skip']} skip, "
          f"{s['error']} error -> {args.out}")
    bad = [r for r in report["routes"] if r["status"] == "error"]
    for r in bad:
        print(f"  ERROR {r['entry']} "
              f"{json.dumps(r['config'], sort_keys=True)} {r['detail']}")
    return 1 if bad else 0


def _cmd_cost_diff(args: argparse.Namespace) -> int:
    from repro_torch.analysis import cost

    with open(args.old, encoding="utf-8") as fh:
        old = json.load(fh)
    with open(args.new, encoding="utf-8") as fh:
        new = json.load(fh)
    d = cost.diff_resource_reports(old, new, rtol=args.rtol)
    for key in d["missing"]:
        print(f"MISSING ROUTE: {key}")
    for row in d["drifted"]:
        rel = f" ({row['rel']:+.1%})" if row["rel"] is not None else ""
        print(f"DRIFT: {row['route']} {row['field']} "
              f"{row['old']} -> {row['new']}{rel}")
    for key in d["added"]:
        print(f"added: {key}")
    print(f"cost-diff: {len(d['drifted'])} drift(s), "
          f"{len(d['missing'])} missing, {len(d['added'])} added "
          f"(rtol={args.rtol})")
    return 1 if d["drifted"] or d["missing"] else 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_run = sub.add_parser("run", help="build, trace and check every "
                                       "contract cell")
    p_run.add_argument("--out", default=DEFAULT_REPORT)
    p_run.add_argument("--device", default=None,
                       help="device of the cells (default: cuda)")
    p_run.set_defaults(fn=_cmd_run)
    p_lint = sub.add_parser("lint", help="repo-specific AST lint over "
                                         "src/repro_torch")
    p_lint.add_argument("paths", nargs="*")
    p_lint.set_defaults(fn=_cmd_lint)
    p_diff = sub.add_parser("diff",
                            help="compare two reports; new failures = red")
    p_diff.add_argument("old")
    p_diff.add_argument("new")
    p_diff.set_defaults(fn=_cmd_diff)
    p_cost = sub.add_parser(
        "cost", help="traced FLOPs/HBM resource row per registry route")
    p_cost.add_argument("--out", default=DEFAULT_RESOURCES)
    p_cost.add_argument("--device", default=None,
                        help="device of the cells (default: cuda)")
    p_cost.set_defaults(fn=_cmd_cost)
    p_cdiff = sub.add_parser(
        "cost-diff",
        help="compare two resource reports; drift or lost routes = red")
    p_cdiff.add_argument("old")
    p_cdiff.add_argument("new")
    p_cdiff.add_argument("--rtol", type=float, default=0.05,
                         help="relative drift tolerance per field "
                              "(default 0.05; launches are exact)")
    p_cdiff.set_defaults(fn=_cmd_cost_diff)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
