"""Modules found by name in the checkout's ``bench/`` folder.

A file names the piece it needs and this finds its module, so that a new
piece is a new file:

* a configuration's ``family`` names ``bench/reference/<family>.py``: its
  leaves, the port's parameter tree, the plain reference forward and the
  model FLOPs of a token;
* its ``moe.router`` names ``bench/reference/routers/<router>.py``: the
  MoE layer's leaves, its reference forward and its routing kernels'
  bounds;
* a traffic mix's ``driver`` names ``bench/core/<driver>_driver.py`` (the
  loop that runs the cell and what it reports), and an open loop's
  ``arrivals`` names ``bench/traffic/<arrivals>.py`` (the gaps between due
  times);
* a per-layer metric's name names ``bench/metrics/<name>.py``.

:func:`use_root` points the search at the checkout whose ``BENCHMARK.json``
names the cell (``spec.load_cell`` calls it); a module is loaded once per
file.
"""
from __future__ import annotations

import hashlib
import importlib.util
from pathlib import Path
from types import ModuleType
from typing import Dict

BENCH = Path(__file__).resolve().parents[1]
_root = {"bench": BENCH}
_loaded: Dict[Path, ModuleType] = {}


def use_root(root: Path) -> None:
    """Search ``root/bench`` from now on."""
    _root["bench"] = Path(root).resolve() / "bench"


def load(folder: str, name: str) -> ModuleType:
    """The module ``bench/<folder>/<name>.py`` of the current root."""
    path = _root["bench"] / folder / f"{name}.py"
    if path not in _loaded:
        if not path.is_file():
            raise FileNotFoundError(f"no {folder}/{name}.py under "
                                    f"{_root['bench']}")
        dotted = ["bench", *folder.split("/"), name]
        if path == BENCH.joinpath(*dotted[1:]).with_suffix(".py") and all(
                p.isidentifier() for p in dotted):
            # this package's own file: the module every import shares
            _loaded[path] = importlib.import_module(".".join(dotted))
            return _loaded[path]
        tag = hashlib.sha256(str(path).encode()).hexdigest()[:12]
        spec = importlib.util.spec_from_file_location(
            f"bench_plugin_{tag}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[path] = mod
    return _loaded[path]


def family(doc: Dict) -> ModuleType:
    return load("reference", doc["family"])


def router(doc: Dict) -> ModuleType:
    return load("reference/routers", doc["moe"]["router"])


def driver(mix: Dict) -> ModuleType:
    return load("core", f"{mix['driver']}_driver")


def arrivals(mix: Dict) -> ModuleType:
    return load("traffic", mix["arrivals"])
