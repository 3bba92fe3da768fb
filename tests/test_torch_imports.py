"""The port stands alone: no module under ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package ``repro`` (checked on the
AST, so a lazy import inside a function counts too)."""
import ast
from pathlib import Path

import jax  # noqa: F401  (both frameworks load in one test process)
import pytest
import torch  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "repro")


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


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    names = list(_imported(ast.parse(path.read_text(), str(path))))
    bad = [n for n in names if n.split(".")[0] in BANNED]
    assert not bad, f"{path}: imports {bad}"


def test_every_port_module_is_checked():
    assert len(FILES) > 20
    assert any(p.name == "ops.py" for p in FILES)
