"""No file of the benchmark imports JAX, jaxlib, flax or the JAX package
``repro``, and the reference imports nothing of the program either
(top-level names compared whole: ``repro_torch`` is not ``repro``)."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(BENCH.rglob("*.py"))
BANNED = {"jax", "jaxlib", "flax", "repro"}


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_imports(path):
    names = list(_imported(ast.parse(path.read_text(), str(path))))
    bad = [n for n in names if n.split(".")[0] in BANNED]
    if "reference" in path.relative_to(BENCH).parts:
        bad += [n for n in names if n.split(".")[0] == "repro_torch"]
    assert not bad, f"{path}: imports {bad}"


def test_the_walk_sees_the_reference():
    assert any("reference" in p.parts for p in FILES)
    assert len(FILES) > 20
