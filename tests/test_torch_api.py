"""The port's package surfaces against the JAX package's: every name a
`src/repro/**/__init__.py` exports is importable from the port's
counterpart package. The reference's names are read by AST, so this
file imports no `repro` (and no JAX).

A name the reference exports that the port spells otherwise, by design,
stands in STATED_DIFFERENCES with its port name; any other missing name
fails, so the two surfaces cannot drift apart unnoticed.
"""

import ast
import importlib
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
REFERENCE = ROOT / "src" / "repro"

#: (reference package, exported name) -> the port's name for it
STATED_DIFFERENCES = {
    # there is no HLO in the port: its contracts are read off a trace
    ("analysis", "hlo_contracts"): "contracts",
}


def _exports(init: pathlib.Path) -> list[str]:
    """The public names an `__init__.py` binds at module level: its
    `from ... import` names, definitions and assignments (`__all__`
    included, when it lists names the module binds)."""
    names = []
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.module != "__future__":
            names += [a.asname or a.name for a in node.names]
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
            if any(isinstance(t, ast.Name) and t.id == "__all__"
                   for t in node.targets):
                names += [e.value for e in node.value.elts]
    return sorted({n for n in names if not n.startswith("_")})


PACKAGES = sorted(
    ".".join(p.parent.relative_to(REFERENCE).parts)
    for p in REFERENCE.rglob("__init__.py") if p.parent != REFERENCE)


def test_every_reference_package_is_read():
    """The packages whose exports are held below (a package of the
    reference without a counterpart would fail its import)."""
    assert {"analysis", "checkpoint", "configs", "core", "engine",
            "kernels", "optim"} <= set(PACKAGES)
    assert "CheckpointManager" in _exports(
        REFERENCE / "checkpoint" / "__init__.py")


@pytest.mark.parametrize("package", PACKAGES)
def test_port_package_exports_the_reference_names(package):
    """Each name is an attribute of the port's package, or a submodule
    it holds (`from repro_torch.<package> import <name>` works)."""
    port = importlib.import_module(f"repro_torch.{package}")
    missing = []
    for name in _exports(REFERENCE.joinpath(*package.split("."),
                                            "__init__.py")):
        name = STATED_DIFFERENCES.get((package, name), name)
        if hasattr(port, name):
            continue
        try:
            importlib.import_module(f"repro_torch.{package}.{name}")
        except ModuleNotFoundError:
            missing.append(name)
    assert not missing, f"repro_torch.{package} lacks {missing}"


def test_stated_differences_name_real_reference_exports():
    """Every stated difference is a name the reference still exports, so
    the list cannot outlive what it excuses."""
    for package, name in STATED_DIFFERENCES:
        assert name in _exports(REFERENCE.joinpath(*package.split("."),
                                                   "__init__.py"))
