"""Nothing of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program.  Top-level module names are
compared whole: ``bath_tpu_torch`` is not ``bath_tpu``."""

import ast
import subprocess
import sys

import pytest

from perfbench.tests.conftest import REPO

BENCH = REPO / "perfbench"
NEVER = {"jax", "jaxlib", "flax", "bath_tpu"}


def imported(path):
    """Top-level names of every module <path> imports (relative
    imports resolved inside perfbench)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("perfbench" if node.level else
                      node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax(path):
    assert not imported(path) & NEVER


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_no_program(path):
    assert not imported(path) & (NEVER | {"bath_tpu_torch"})


def test_whole_names():
    assert "bath_tpu_torch" not in NEVER
    assert imported(BENCH / "entries" / "bathsearch.py") >= {"perfbench"}


def test_reference_loads_alone():
    code = ("import sys, perfbench.reference.dp, perfbench.check; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'bath_tpu', 'bath_tpu_torch'}))")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "[]", r.stderr
