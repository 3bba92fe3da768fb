"""Run one cell of the benchmark once: ``python3 bench/run.py --workload
CELL --seed N --seconds S --trace 0|1`` from the root of a checkout (see
``bench/core/harness.py``)."""
import time

T0 = time.monotonic()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench.core import harness  # noqa: E402

if __name__ == "__main__":
    harness.fix_environment()
    sys.exit(harness.main(t0=T0))
