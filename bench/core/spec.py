"""Find a cell's pieces by name and merge them into one plan.

``BENCHMARK.json`` names each cell (``workloads``), its configuration and
its traffic mix.  Each piece lives in a file of its own, found by name:

* ``bench/configs/<config>.json``: the model as it is run (``model`` and
  ``moe`` hold the port's config fields), its source and its cuts, and
  its ``family`` (``bench/reference/<family>.py``);
* ``bench/traffic/<traffic>.json``: the mix (lengths, arrivals, batch) and
  its ``driver`` (``bench/core/<driver>_driver.py``);
* ``bench/workloads/<cell>.json``: what belongs to the cell alone (the
  engine's settings, a rate or a client count, the limits of its
  correctness checks); its keys override the traffic's;
* ``bench/metrics/<metric>.py``: the reader of one per-layer metric.

Adding a cell, a mix, a configuration or a metric adds files and edits
none; so does a new family, router, driver or arrival process
(``bench/core/plugins.py`` finds each by the name a file gives).  ``reduced=True`` (the CPU rehearsal) folds each file's
``cpu_rehearsal`` group over its other keys.
"""
from __future__ import annotations

import copy
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

from bench.core import plugins

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _load(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _fold(base: Dict[str, Any], over: Dict[str, Any]) -> Dict[str, Any]:
    """``base`` with ``over`` laid on it, nested groups merged key by key."""
    out = copy.deepcopy(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _fold(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _rehearse(doc: Dict[str, Any], reduced: bool) -> Dict[str, Any]:
    over = doc.get("cpu_rehearsal", {})
    doc = {k: v for k, v in doc.items() if k != "cpu_rehearsal"}
    return _fold(doc, over) if reduced else doc


@dataclass
class Cell:
    """Everything one run of one cell needs, read from the files."""
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: Dict[str, Any]          # the configuration file, folded
    load: Dict[str, Any]            # the traffic file with the cell's keys
    limits: Dict[str, float]        # check name -> limit
    end_to_end: List[Dict[str, Any]] = field(default_factory=list)
    per_layer: List[Dict[str, Any]] = field(default_factory=list)
    reduced: bool = False


def benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return _load(root / "BENCHMARK.json")


def _applies(metric: Dict[str, Any], cell: str,
             e2e_names: Optional[set] = None) -> bool:
    """Whether ``metric`` is reported in ``cell``: its ``workloads`` list
    names the cell, or it has none (a per-layer metric without one goes
    wherever the end-to-end metric it moves is reported)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if e2e_names is not None and "moves" in metric:
        return metric["moves"] in e2e_names
    return True


def load_cell(name: str, *, reduced: bool = False, root: Path = ROOT,
              bench_doc: Optional[Dict[str, Any]] = None) -> Cell:
    plugins.use_root(root)
    doc = bench_doc if bench_doc is not None else benchmark(root)
    entries = {w["name"]: w for w in doc["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(entries)}")
    w = entries[name]
    bench = root / "bench"
    config = _rehearse(_load(bench / "configs" / f"{w['config']}.json"),
                       reduced)
    load = _rehearse(_load(bench / "traffic" / f"{w['traffic']}.json"),
                     reduced)
    cell_path = bench / "workloads" / f"{name}.json"
    cell_doc = _rehearse(_load(cell_path), reduced) if cell_path.exists() \
        else {}
    limits = dict(cell_doc.pop("limits", {}))
    load = _fold(load, cell_doc)
    e2e = [m for m in doc["end_to_end"] if _applies(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in doc["per_layer"] if _applies(m, name, names)]
    return Cell(name, w["config"], w["traffic"], int(w["chips"]), config,
                load, limits, e2e, per_layer, reduced)
