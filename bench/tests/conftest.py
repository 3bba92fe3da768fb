"""The benchmark's tests run on the CPU at the files' reduced sizes; no
test needs a card, and nothing here decides anything at import."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


import pytest  # noqa: E402
import torch  # noqa: E402


@pytest.fixture(autouse=True)
def _few_threads():
    """The suite runs several workers at once: two threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _this_checkout():
    """Each test finds the pieces of this checkout, whatever root the one
    before pointed the search at."""
    from bench.core import plugins
    plugins.use_root(ROOT)
    yield
    plugins.use_root(ROOT)
