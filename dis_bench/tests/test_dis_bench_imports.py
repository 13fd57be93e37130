"""No module of the benchmark loads `jax`, `jaxlib`, `flax` or the JAX
package `of_dis_tpu`, and the reference loads nothing of the port. Module
names are compared whole by their top-level part: the port's name,
`of_dis_tpu_torch`, begins with the JAX package's."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "of_dis_tpu"}
SOURCES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)

# load a file by path (metric readers have dots in their names) and list
# the top-level names of every module loaded
PROBE = """
import importlib.util, json, sys
spec = importlib.util.spec_from_file_location("probe", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
sys.modules["probe"] = mod
spec.loader.exec_module(mod)
print(json.dumps(sorted({k.split(".")[0] for k in sys.modules})))
"""


def loaded(path: Path) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE, str(path)], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin",
                              "JAX_PLATFORMS": "cpu"})
    return set(json.loads(out.stdout.splitlines()[-1]))


def imported_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not imported_names(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in SOURCES if "tests" not in p.parts],
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_loads_jax_or_the_jax_package(path):
    assert not loaded(path) & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    for path in sorted((HERE / "reference").glob("*.py")):
        assert "of_dis_tpu_torch" not in imported_names(path)
        assert not loaded(path) & (FORBIDDEN | {"of_dis_tpu_torch"})


def test_the_names_are_compared_whole():
    """The port's name begins with the JAX package's and is allowed."""
    assert "of_dis_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "of_dis_tpu.models".split(".")[0] in FORBIDDEN
