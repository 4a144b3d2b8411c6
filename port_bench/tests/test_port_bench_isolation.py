"""What the benchmark imports and reads: no module whose top-level name
is ``jax``, ``jaxlib``, ``flax`` or ``wave_fenics_tpu`` (compared whole:
``wave_fenics_tpu_torch`` is the port), references that import nothing of
the port, and no path into the JAX package's folder."""

import ast
import json
import re
import subprocess
import sys

import pytest

from port_bench import harness

SOURCES = sorted(p for p in harness.ROOT.rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(harness.ROOT)))
def test_no_jax_import(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & harness.FORBIDDEN


@pytest.mark.parametrize("path", sorted((harness.ROOT / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert tops <= {"__future__", "math", "numpy", "torch"}, tops


def test_no_path_into_the_jax_package():
    jax_pkg = re.compile(r"wave_fenics_tpu[/.]|\bbench\.py\b")
    for path in SOURCES + sorted(harness.ROOT.rglob("*.json")):
        if path.parent.name == "tests":
            continue
        assert not jax_pkg.search(path.read_text()), path


def test_forbidden_names_compare_whole():
    names = {"wave_fenics_tpu_torch.ops", "wave_fenics_tpu_torch", "jaxtyping", "flaxen"}
    assert not {n.split(".")[0] for n in names} & harness.FORBIDDEN
    assert {n.split(".")[0] for n in ("wave_fenics_tpu.ops", "jax.numpy")} <= harness.FORBIDDEN


def test_a_run_loads_no_jax_module():
    """A whole run at a small size in a fresh process leaves no forbidden
    module in ``sys.modules``."""
    code = (
        "import sys, json\n"
        "from port_bench import harness\n"
        "r = harness.run_cell('planar3d-p4.leapfrog', 5, 0.1, False, 'cpu',\n"
        "                     overrides={'cells': [4, 2, 2]})\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules} & harness.FORBIDDEN)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.REPO, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert json.loads(out.strip().splitlines()[-1]) == []
