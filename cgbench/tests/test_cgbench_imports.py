"""Neither JAX nor the JAX package is loaded, compared by whole
top-level names: ``acg_tpu_torch`` begins with ``acg_tpu`` and is not
it."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from cgbench import harness

ROOT = Path(harness.__file__).resolve().parent


@pytest.mark.parametrize("loaded, found", [
    (["acg_tpu_torch", "acg_tpu_torch.solvers.cg", "jaxtyping"], []),
    (["acg_tpu.cli"], ["acg_tpu"]),
    (["jax", "jax.numpy"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
])
def test_whole_name_compare(monkeypatch, loaded, found):
    for name in ("acg_tpu", "jax", "jaxlib", "flax"):
        for m in [m for m in sys.modules
                  if m == name or m.startswith(name + ".")]:
            monkeypatch.delitem(sys.modules, m)
    for m in loaded:
        monkeypatch.setitem(sys.modules, m, type(sys)(m))
    assert harness.forbidden_modules() == found


def test_a_run_loads_neither():
    code = ("import dataclasses, sys\n"
            "from cgbench import spec, harness, control\n"
            "c = spec.load_cell('p2d2048-cg-f64-1000it')\n"
            "c = dataclasses.replace(c, config=dict(c.config, n=16),\n"
            "    traffic=dict(c.traffic, iterations=9))\n"
            "out = harness.run(c, 1, 0.1, False, device='cpu')\n"
            "assert out.correct\n"
            "print(harness.forbidden_modules())\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT.parent, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_the_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "checks.py", "counts.py", "trace.py"):
        assert not _imports(ROOT / name) & {"acg_tpu_torch", "acg_tpu",
                                            "jax"}, name


def test_only_program_py_imports_the_program():
    for path in ROOT.rglob("*.py"):
        if path.name == "program.py" or "tests" in path.parts:
            continue
        assert "acg_tpu_torch" not in _imports(path), path
        assert not _imports(path) & {"acg_tpu", "jax", "jaxlib", "flax"}
