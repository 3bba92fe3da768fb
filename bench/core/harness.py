"""One run of one cell: set-up, the measured window, the reference and the
result line.

``python3 bench/run.py --workload CELL --seed N --seconds S --trace 0|1``
runs the cell on the card it is started on and prints, as the last line
of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
a ``breakdown``, and last ``checks``: each number the correctness check
compared, beside its limit.  The same numbers end standard error.

Without a card, or with fewer than the cell asks for, it prints no result
and exits 2.  If JAX, flax or the JAX package got loaded it names them on
standard error, prints no result and exits 3.  ``--reduced`` is the CPU
rehearsal: the files' ``cpu_rehearsal`` sizes, on the CPU, no card asked
for; its numbers are no device's.
"""
from __future__ import annotations

import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]
BANNED = ("jax", "jaxlib", "flax", "repro")
CACHE = ROOT / ".bench_cache"


def fix_environment() -> None:
    """Caches at fixed paths inside the checkout; no library pulls in JAX."""
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def banned_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in BANNED})


class Ctx:
    """What a metric's reader sees: the cell, its configuration, the run's
    numbers and the traced window."""

    def __init__(self, cell, run):
        self.cell, self.doc, self.run = cell, cell.config, run
        self.trace = run.get("trace")


def checks(cell, vals: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """Each number the cell's limits name, beside its limit."""
    missing = set(cell.limits) - set(vals)
    if missing:
        raise KeyError(f"cell {cell.name} limits {sorted(missing)}, which "
                       f"no check reads")
    return {k: {"value": vals[k], "limit": lim}
            for k, lim in cell.limits.items()}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             reduced: bool = False, clock=None, root: Path = ROOT):
    """Returns ``(exit code, result dict or None)``.  ``root`` is the
    checkout whose ``BENCHMARK.json`` and ``bench/`` files name the cell."""
    import torch
    from bench.core import plugins, spec
    t_start = time.monotonic()
    clock = clock or (lambda: time.monotonic() - t_start)
    cell = spec.load_cell(workload, reduced=reduced, root=root)
    if reduced:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            print(f"bench: {workload} needs {cell.chips} CUDA device(s); "
                  f"this machine has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2, None
        device = torch.device("cuda", 0)
    drv = plugins.driver(cell.load)
    run = drv.run(cell, seed, seconds, trace, device, clock)
    bad = banned_modules()
    if bad:
        print(f"bench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 3, None
    chk = checks(cell, drv.checks(run))
    correct = all(c["value"] <= c["limit"] for c in chk.values())
    if trace:
        ctx = Ctx(cell, run)
        metrics = {}
        for m in cell.per_layer:
            v = plugins.load("metrics", m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = drv.end_to_end(run)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in e2e}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": run["peak"]}
    result = {"correct": correct, "attempted": run.get("attempted",
                                                       run.get("steps", 0)),
              "failed": run["failed"], "metrics": metrics, "device": dev}
    tr = run.get("trace")
    if trace and tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(10),
                               "idle_gaps": tr.idle_gaps(10)}
    if run.get("late_s"):
        late = sorted(run["late_s"])
        result["generator_late_ms"] = {
            "p95": 1e3 * late[max(0, math.ceil(0.95 * len(late)) - 1)],
            "max": 1e3 * late[-1]}
    result["checks"] = chk
    return 0, result


def main(argv: Optional[List[str]] = None, t0: Optional[float] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--reduced", action="store_true",
                    help="the CPU rehearsal at the files' reduced sizes")
    a = ap.parse_args(argv)
    t0 = time.monotonic() if t0 is None else t0
    code, result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                            a.reduced, clock=lambda: time.monotonic() - t0)
    if result is None:
        return code
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return code
