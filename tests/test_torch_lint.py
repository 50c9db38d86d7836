"""The port's AST lint (`repro_torch.analysis.lint`), on the CPU: each
rule catches an injected violation, an `# lint: allow=<rule>` annotation
(trailing or on the line above) silences it, the package itself is
lint-clean, and the CLI's exit codes are the reference's
(tests/test_analysis.py)."""

import os

import pytest

from repro_torch.analysis import lint
from repro_torch.analysis.__main__ import main as analysis_main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# rule -> (a path the rule covers, violating source, the violating line)
CASES = {
    "deprecated-shim": (
        "src/repro_torch/launch/x.py",
        "from repro_torch.core import memory as m\n"
        "r = m.distributed_search(s, q, cfg, mesh)\n", 2),
    "kernel-sort": (
        "src/repro_torch/kernels/x.py",
        "def launch(x):\n"
        "    lib = _build.load('x', {})\n"
        "    return torch.topk(x, 4)\n", 3),
    "float-epsilon-tiebreak": (
        "src/repro_torch/engine/x.py", "d = dist + 1e-6\n", 1),
    "serving-raw-random": (
        "src/repro_torch/kernels/x.py", "n = torch.randn(3, 4)\n", 1),
    "ste-raw-primitive": (
        "src/repro_torch/models/x.py",
        "from repro_torch.core.quantization import _SteRound\n", 1),
    "f64-astype": (
        "src/repro_torch/engine/x.py", "y = x.to(torch.float64)\n", 1),
    "cost-call": (
        "src/repro_torch/launch/x.py",
        "from torch.utils.flop_counter import FlopCounterMode\n", 1),
    "tensor-number-div": (
        "src/repro_torch/models/x.py", "y = x / 2.0\n", 1),
}


def _rules(source: str, path: str) -> list[str]:
    return [f.rule for f in lint.lint_source(source, path)]


@pytest.mark.parametrize("rule", list(CASES))
def test_rule_catches_an_injected_violation(rule):
    path, src, line = CASES[rule]
    found = [f for f in lint.lint_source(src, path) if f.rule == rule]
    assert [f.line for f in found] == [line], found
    assert rule in found[0].format()


@pytest.mark.parametrize("where", ["trailing", "above"])
@pytest.mark.parametrize("rule", list(CASES))
def test_annotation_silences_a_rule(rule, where):
    path, src, line = CASES[rule]
    lines = src.splitlines()
    if where == "trailing":
        lines[line - 1] += f"  # lint: allow={rule}"
    else:
        indent = lines[line - 1][:len(lines[line - 1])
                                 - len(lines[line - 1].lstrip())]
        lines.insert(line - 1, f"{indent}# lint: allow={rule}")
    assert rule not in _rules("\n".join(lines) + "\n", path)


def test_rules_keep_to_their_scope():
    # the serving rules skip code outside engine / kernels
    assert _rules("n = torch.randn(3)\nd = x + 1e-6\n",
                  "src/repro_torch/models/x.py") == []
    # host arithmetic and host-only packages are not divisions on the card
    host = ("import math\nimport numpy as np\n"
            "a = 1.0 / math.sqrt(64)\nb = 2 / 3\n"
            "c = 1.0 / np.power(np.float64(2.0), 3)\n")
    assert _rules(host, "src/repro_torch/models/x.py") == []
    assert _rules("y = x / 2.0\n", "src/repro_torch/data/x.py") == []
    # both directions and the augmented form
    assert _rules("a = 1.0 / x\nx /= 3\n", "src/repro_torch/core/x.py") == \
        ["tensor-number-div"] * 2
    # a sort off a launching function is the plain version's business
    assert _rules("def plain(x):\n    return torch.topk(x, 4)\n",
                  "src/repro_torch/kernels/x.py") == []
    # the STE Functions' own modules and the cost model's home
    assert _rules("y = _SteRound.apply(x)\n",
                  "src/repro_torch/core/quantization.py") == []
    assert _rules("from torch.utils.flop_counter import flop_registry\n",
                  "src/repro_torch/analysis/cost.py") == []
    # host-side numpy float64 is fine, .double() is not
    assert _rules("a = np.float64(1.0)\n", "src/repro_torch/x.py") == []
    assert _rules("y = x.double()\n", "src/repro_torch/x.py") == \
        ["f64-astype"]


def test_the_package_is_lint_clean():
    findings = lint.lint_paths([os.path.join(ROOT, "src", "repro_torch")])
    assert findings == [], "\n".join(f.format() for f in findings)


def test_cli_lint_exit_codes(tmp_path, capsys):
    bad = tmp_path / "repro_torch" / "engine" / "bad.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("import torch\nn = torch.randn(4)\n")
    assert analysis_main(["lint", str(bad)]) == 1
    assert "serving-raw-random" in capsys.readouterr().out
    good = tmp_path / "good.py"
    good.write_text("x = 1\n")
    assert analysis_main(["lint", str(good)]) == 0
    assert analysis_main(["lint", str(tmp_path)]) == 1
