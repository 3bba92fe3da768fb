"""The readings that the limits of a cell's correctness checks are set from.

For each seed of ``--seeds`` it makes one run of the cell as
``bench/run.py`` makes it (the cell's driver's ``run``; a serving cell
under its own load for ``run_seconds``, a training cell up to the end of
its first steps) and prints the numbers the checks compare, the
program's against the fp32 reference.  For each seed of
``--control-seeds`` it also prints the control's: the reference put in
the program's place at the next precision below the configured one (fp8
matmul operands, and in serving an fp8 KV cache too) over the same
inputs, against the fp32 reference; a training cell adds the fault of
half of each batch left out, planted in the reference.  One JSON line
per reading (the driver's ``readings``).

  python3 bench/calibrate.py --workload smile3.7b-train-b16s128 \\
      --seeds 11,12,13 --control-seeds 11,12,13
"""
import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench.core import harness  # noqa: E402


def _seeds(s: str):
    return [int(x) for x in s.split(",") if x]


def main(argv=None) -> int:
    import torch
    from bench.core import plugins, spec
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--reduced", action="store_true",
                    help="the CPU rehearsal at the files' reduced sizes")
    a = ap.parse_args(argv)
    cell = spec.load_cell(a.workload, reduced=a.reduced)
    seconds = spec.benchmark()["run_seconds"]
    device = torch.device("cpu" if a.reduced else "cuda")
    drv = plugins.driver(cell.load)
    controls = set(_seeds(a.control_seeds))
    seeds = _seeds(a.seeds)
    for seed in seeds + sorted(controls - set(seeds)):
        for line in drv.readings(cell, seed, seconds, device,
                                 control=seed in controls):
            if line["who"] == "program" and seed not in seeds:
                continue
            print(json.dumps({"seed": seed, **line,
                              "t_s": time.monotonic() - T0}), flush=True)
    return 0


if __name__ == "__main__":
    harness.fix_environment()
    sys.exit(main())
