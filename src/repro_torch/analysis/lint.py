"""Repo-specific AST lint of the port (counterpart of
`repro.analysis.lint`): rules generic linters cannot know.

Run as `python -m repro_torch.analysis lint [paths...]` (default:
src/repro_torch). Each finding carries a rule id; suppress a specific
line with an annotation comment naming the rule, trailing or on the line
above:

    dist = torch.topk(keys, k)   # lint: allow=kernel-sort

Rules (ids in brackets); the reference's carry over to the port's idiom:

  [deprecated-shim]       nothing in the package calls the deprecated
                          `repro_torch.core.memory.search /
                          distributed_search` dict shims -- everything
                          goes through `RetrievalEngine.search`.
  [kernel-sort]           no `torch.sort` / `torch.topk` (or the tensor
                          methods) in a function of repro_torch/kernels
                          that launches a kernel (calls `_build.load`,
                          `_load` or `_build.check`): the hand-written
                          kernel selects the top-k itself; the reference
                          bans `lax.sort` / `lax.top_k` inside a Pallas
                          kernel.
  [float-epsilon-tiebreak] no small float epsilons (0 < |x| < 1e-4) in
                          ranking code (repro_torch/engine,
                          repro_torch/kernels): ties break by (distance,
                          index) order, never by epsilon nudges.
  [serving-raw-random]    no raw random draws in serving paths
                          (repro_torch/engine, repro_torch/kernels):
                          `torch.rand*` / `randn*` / `randint*` /
                          `randperm`, `.normal_` / `.uniform_` /
                          `.bernoulli` / `.multinomial`. Serving noise is
                          the counter-hash family keyed on absolute
                          coordinates (core/mcam.hash_normal).
  [ste-raw-primitive]     the straight-through `autograd.Function`s
                          (`_SteRound`, `_MtmcWordSte`, `_SteStep`) are
                          only touched inside their defining modules --
                          everyone else uses the wrappers (`ste_round`,
                          `encode_words_ste`, `ste_step`).
  [f64-astype]            no float64 tensors: `torch.float64` /
                          `torch.double` (`.to(...)`, `dtype=...`) or
                          `.double()`. Host-side `np.float64` is fine.
  [cost-call]             no `TorchDispatchMode` / `FlopCounterMode` /
                          `flop_registry` cost reads outside
                          repro_torch/analysis -- analysis/cost.py is the
                          one cost model.
  [tensor-number-div]     no `tensor / number` or `number / tensor` in
                          code that runs on the card (every package but
                          data/, examples/ and analysis/): on the
                          card PyTorch divides by a Python number as a
                          product with its reciprocal, and `number /
                          tensor` rounds twice (ROADMAP C.P3, C.P7, C.P8).
                          Divide by a 0-dim tensor on the dividend's
                          device (`models/layers.div`). A division whose
                          other side is a literal or a call of `math.*`,
                          `np.*`, `int`, `float`, `len` is host
                          arithmetic and is not flagged.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re

#: modules allowed to touch the raw STE Functions (they define them)
STE_DEFINING_MODULES = ("core/quantization.py", "core/encodings.py",
                        "core/mcam.py")
#: ranking / serving path prefixes for the epsilon + raw-random rules
SERVING_PREFIXES = ("repro_torch/engine/", "repro_torch/kernels/")
#: packages whose code runs on the host only (the division rule skips)
HOST_PREFIXES = ("repro_torch/data/", "repro_torch/examples/",
                 "repro_torch/analysis/")
_STE_PRIMITIVE = re.compile(r"^_\w*Ste\w*$")
_ALLOW = re.compile(r"#\s*lint:\s*allow=([\w,-]+)")
EPSILON_BOUND = 1e-4
_RAW_RANDOM_METHODS = ("normal_", "uniform_", "bernoulli", "bernoulli_",
                       "multinomial")
_LAUNCH_CALLS = ("_build.load", "_load", "_build.check")
_SORTS = ("sort", "topk")
_COST_NAMES = ("TorchDispatchMode", "FlopCounterMode", "flop_registry")
_HOST_CALLS = ("int", "float", "len")
_HOST_MODULES = ("math", "np", "numpy")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _suppressed(source_lines: list[str], line: int, rule: str) -> bool:
    for ln in (line, line - 1):                # trailing or line-above
        if 1 <= ln <= len(source_lines):
            m = _ALLOW.search(source_lines[ln - 1])
            if m and rule in m.group(1).split(","):
                return True
    return False


def _dotted(node: ast.AST) -> str:
    """'a.b.c' for nested Attribute/Name nodes ('' when not a plain path)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _norm(path: str) -> str:
    return path.replace(os.sep, "/")


# -- rules (each: (tree, path, source_lines) -> list[Finding]) --------------


def _rule_deprecated_shim(tree, path, lines):
    if _norm(path).endswith("core/memory.py"):      # the shims' own home
        return []
    out = []
    shims = {"search", "distributed_search"}
    memory_aliases = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            if node.module == "repro_torch.core.memory":
                for a in node.names:
                    if a.name in shims:
                        out.append(Finding(
                            "deprecated-shim", path, node.lineno,
                            f"import of deprecated shim "
                            f"repro_torch.core.memory.{a.name}; use "
                            f"RetrievalEngine.search"))
            elif node.module == "repro_torch.core":
                for a in node.names:
                    if a.name == "memory":
                        memory_aliases.add(a.asname or a.name)
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "repro_torch.core.memory" and a.asname:
                    memory_aliases.add(a.asname)
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in shims
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id in memory_aliases):
            out.append(Finding(
                "deprecated-shim", path, node.lineno,
                f"call to deprecated shim "
                f"{node.func.value.id}.{node.func.attr}(); use "
                f"RetrievalEngine.search"))
    return out


def _rule_kernel_sort(tree, path, lines):
    if "repro_torch/kernels/" not in _norm(path):
        return []
    out = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)]
        if not any(_dotted(c.func) in _LAUNCH_CALLS for c in calls):
            continue
        for c in calls:
            if (isinstance(c.func, ast.Attribute)
                    and c.func.attr in _SORTS):
                out.append(Finding(
                    "kernel-sort", path, c.lineno,
                    f"{_dotted(c.func) or c.func.attr} in {fn.name}(), "
                    f"which launches a kernel: the kernel selects the "
                    f"top-k itself"))
    return out


def _rule_float_epsilon(tree, path, lines):
    if not any(p in _norm(path) for p in SERVING_PREFIXES):
        return []
    out = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant)
                and isinstance(node.value, float)
                and 0.0 < abs(node.value) < EPSILON_BOUND):
            out.append(Finding(
                "float-epsilon-tiebreak", path, node.lineno,
                f"float epsilon {node.value!r} in ranking code: ties "
                f"break by (distance, index) order, not epsilon nudges"))
    return out


def _rule_serving_raw_random(tree, path, lines):
    if not any(p in _norm(path) for p in SERVING_PREFIXES):
        return []
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Attribute):
            continue
        d = _dotted(node)
        if d.startswith("torch.rand") or node.attr in _RAW_RANDOM_METHODS:
            out.append(Finding(
                "serving-raw-random", path, node.lineno,
                f"{d or node.attr} in a serving path: serving noise is "
                f"the counter-hash family (core/mcam.hash_normal), not "
                f"random sampling"))
    return out


def _rule_ste_raw_primitive(tree, path, lines):
    if any(_norm(path).endswith(m) for m in STE_DEFINING_MODULES):
        return []
    out = []
    for node in ast.walk(tree):
        name = None
        if isinstance(node, ast.Name):
            name = node.id
        elif isinstance(node, ast.Attribute):
            name = node.attr
        elif isinstance(node, ast.ImportFrom):
            for a in node.names:
                if _STE_PRIMITIVE.match(a.name):
                    out.append(Finding(
                        "ste-raw-primitive", path, node.lineno,
                        f"import of raw STE Function {a.name}; use its "
                        f"wrapper"))
            continue
        if name and _STE_PRIMITIVE.match(name):
            out.append(Finding(
                "ste-raw-primitive", path, node.lineno,
                f"use of raw STE Function {name}; use its wrapper "
                f"(ste_round / encode_words_ste / ste_step)"))
    return out


def _rule_f64_astype(tree, path, lines):
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and _dotted(node) in (
                "torch.float64", "torch.double"):
            out.append(Finding(
                "f64-astype", path, node.lineno,
                f"{_dotted(node)} in device code: the stack is "
                f"f32/bf16/int (host-side np.float64 is fine)"))
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr == "double" and not node.args):
            out.append(Finding(
                "f64-astype", path, node.lineno,
                ".double() in device code"))
    return out


def _rule_cost_call(tree, path, lines):
    if "repro_torch/analysis" in _norm(path):
        return []                       # the cost model's own home
    out = []
    for node in ast.walk(tree):
        name = None
        if isinstance(node, ast.Name):
            name = node.id
        elif isinstance(node, ast.Attribute):
            name = node.attr
        elif isinstance(node, ast.ImportFrom):
            if node.module == "torch.utils.flop_counter" or any(
                    a.name in _COST_NAMES for a in node.names):
                out.append(Finding(
                    "cost-call", path, node.lineno,
                    "import of an op-cost reader outside "
                    "repro_torch.analysis; go through "
                    "repro_torch.analysis.cost (the one cost model)"))
            continue
        if name in _COST_NAMES:
            out.append(Finding(
                "cost-call", path, node.lineno,
                f"{name} outside repro_torch.analysis; go through "
                f"repro_torch.analysis.cost (the one cost model)"))
    return out


def _number(node) -> bool:
    """A numeric literal (or its negation)."""
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        node = node.operand
    return (isinstance(node, ast.Constant)
            and isinstance(node.value, (int, float))
            and not isinstance(node.value, bool))


def _host_number(node) -> bool:
    """An expression of literals and calls of math / numpy / int / float
    / len: host arithmetic."""
    if _number(node):
        return True
    if isinstance(node, ast.Call):
        d = _dotted(node.func)
        return d in _HOST_CALLS or d.split(".")[0] in _HOST_MODULES
    if isinstance(node, ast.BinOp):
        return _host_number(node.left) and _host_number(node.right)
    if isinstance(node, ast.UnaryOp):
        return _host_number(node.operand)
    return False


def _rule_tensor_number_div(tree, path, lines):
    if any(p in _norm(path) for p in HOST_PREFIXES):
        return []
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
            pair = (node.left, node.right)
        elif isinstance(node, ast.AugAssign) and isinstance(node.op,
                                                            ast.Div):
            pair = (node.target, node.value)
        else:
            continue
        a, b = pair
        if (_number(a) or _number(b)) and not (_host_number(a)
                                               and _host_number(b)):
            out.append(Finding(
                "tensor-number-div", path, node.lineno,
                f"`{ast.unparse(node)[:60]}`: a division by (or of) a "
                f"Python number rounds differently on the card; divide "
                f"by a 0-dim tensor on the dividend's device "
                f"(models/layers.div)"))
    return out


RULES = {
    "deprecated-shim": _rule_deprecated_shim,
    "kernel-sort": _rule_kernel_sort,
    "float-epsilon-tiebreak": _rule_float_epsilon,
    "serving-raw-random": _rule_serving_raw_random,
    "ste-raw-primitive": _rule_ste_raw_primitive,
    "f64-astype": _rule_f64_astype,
    "cost-call": _rule_cost_call,
    "tensor-number-div": _rule_tensor_number_div,
}


def lint_source(source: str, path: str) -> list[Finding]:
    """All findings for one file's source text (suppressions applied)."""
    tree = ast.parse(source, filename=path)
    lines = source.splitlines()
    out = []
    for rule_id, rule in RULES.items():
        for f in rule(tree, path, lines):
            if not _suppressed(lines, f.line, f.rule):
                out.append(f)
    return sorted(out, key=lambda f: (f.path, f.line, f.rule))


def lint_paths(paths: list[str]) -> list[Finding]:
    """Lint every .py file under the given files/directories."""
    files: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, names in os.walk(p):
                files.extend(os.path.join(root, n) for n in names
                             if n.endswith(".py"))
        else:
            files.append(p)
    out = []
    for fp in sorted(files):
        with open(fp, encoding="utf-8") as fh:
            out.extend(lint_source(fh.read(), fp))
    return out
