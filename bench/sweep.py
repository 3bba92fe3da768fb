"""Find the knee of an open-loop serving cell: the highest rate the engine
sustains.  Builds the cell's engine once, then for each rate runs the
cell's traffic (a ramp, then a window) and prints one JSON line: the
TTFT median and p95, the TPOT p95, the requests due in the window and
those that finished within the cap, and the backlog (submitted, no first
token yet) at the window's start and end.  A backlog that grows over the
window marks a rate above the knee.  Between rates the engine drains.

  python3 bench/sweep.py --workload qwen3moe-chat --rates 4,5,6,7,8 \\
      --seconds 30 --seed 1
"""
import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench.core import harness  # noqa: E402


def backlog(eng, t: float) -> int:
    return sum(1 for r in eng.requests.values()
               if r.t_submit <= t and (not r.t_tokens or r.t_first > t))


def main() -> int:
    import torch
    from bench.core import serve_driver as SD
    from bench.core import spec
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--ramp", type=float, default=15.0)
    ap.add_argument("--cap", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--stop-growth", type=int, default=10,
                    help="stop after a rate whose backlog grew by more")
    a = ap.parse_args()
    cell = spec.load_cell(a.workload, reduced=a.reduced)
    device = torch.device("cpu" if a.reduced else "cuda")
    tree, drawn, eng = SD.prepare(cell, a.seed, device)
    vocab = cell.config["model"]["vocab_size"]
    print(json.dumps({"setup_s": time.monotonic() - T0}), flush=True)
    for i, rate in enumerate(float(x) for x in a.rates.split(",")):
        mix = dict(cell.load, rate_per_s=rate, ramp_s=a.ramp,
                   drain_cap_s=a.cap)
        queue = SD.make_queue(mix, a.seed + i, a.seconds, vocab)
        d = SD.Drive(eng, mix, queue, a.seconds)
        st = d.open_stats(eng)
        ticks = [b - s for s, b in d.ticks.t if d.w0 <= s < d.w1]
        print(json.dumps({
            "rate_per_s": rate, "due": st["attempted"],
            "finished": st["attempted"] - st["failed"],
            "ttft_p50_ms": 1e3 * st["ttft_p50_s"],
            "ttft_p95_ms": 1e3 * st["ttft_p95_s"],
            "tpot_p95_ms": 1e3 * st["tpot_p95_s"],
            "backlog_start": backlog(eng, d.w0),
            "backlog_end": backlog(eng, d.w1),
            "tick_ms_mean": 1e3 * sum(ticks) / max(1, len(ticks)),
            "late_p95_ms": 1e3 * sorted(d.late)[int(0.95 * len(d.late))]}),
            flush=True)
        if backlog(eng, d.w1) - backlog(eng, d.w0) > a.stop_growth:
            break
        eng.run()
    return 0


if __name__ == "__main__":
    harness.fix_environment()
    sys.exit(main())
