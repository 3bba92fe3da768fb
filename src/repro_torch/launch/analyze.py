"""Static analyzer CLI: ``python -m repro_torch.launch.analyze``.

The port of ``repro.launch.analyze``.  Runs the three passes of
:mod:`repro_torch.analysis` (repo lint over the AST, kernel lint over
the CUDA sources and what ``ptxas`` reports, trace lint over the
entrypoint grid on 8 gloo ranks of the CPU), prints one line per finding
with its ``file:line``, and exits nonzero if anything was flagged.

Without ``nvcc`` (the CPU) the kernel pass says that its ptxas rules were
not run and runs its source rule alone; the launch rules (shared memory
and registers at each launch) need the card's launch records, which
``chip_smoke.py`` phase 23 gathers.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.analyze",
        description="repo lint, kernel lint and collective (trace) lint "
                    "of the port")
    ap.add_argument("--pass", dest="passes", default="all",
                    choices=("all", "repo", "kernel", "trace"),
                    help="which analysis pass to run (default: all)")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="suppress progress lines; print findings only")
    args = ap.parse_args(argv)

    log = ((lambda _msg: None) if args.quiet
           else (lambda msg: print(msg, flush=True)))
    from repro_torch.analysis import format_findings

    findings = []
    if args.passes in ("all", "repo"):
        log("[analyze] repo lint (AST)...")
        from repro_torch.analysis import repo_lint
        findings += repo_lint.run(log=log)
    if args.passes in ("all", "kernel"):
        log("[analyze] kernel lint (sources, ptxas)...")
        from repro_torch.analysis import kernel_lint
        # the passes it did not run are said even under -q
        findings += kernel_lint.run(log=lambda m: (
            print(m, flush=True) if "not run" in m else log(m)))
    if args.passes in ("all", "trace"):
        log("[analyze] trace lint (entrypoint grid on 8 gloo ranks)...")
        from repro_torch.analysis import trace_lint
        findings += trace_lint.run(log=log)

    print(format_findings(findings), flush=True)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
