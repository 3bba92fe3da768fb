"""Count the kernels that profiler windows see, before and after
``chip_smoke.py`` phase 22 (b)'s profiled zamba2 forward.

Each window runs 5 calls of one function under ``torch.profiler`` and
prints the CUDA kernels it saw with their launch counts: ``ssd_chunk`` at
zamba2-2.7b's path shape (2, 16, 128, 80, 64, 64) through its ctypes
wrapper, and a 4096 x 4096 fp32 ``torch.mm``, each under CUDA activity
alone, then host and CUDA activity, then CUDA activity alone again.  The
probe runs before phase 22 (b), just after it, and 2 s later.  A window
that lost its kernels prints ``{}``.

    PYTHONPATH=src python3 tools/profiler_probe.py

Needs one CUDA card; builds the kernels at first use.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def window(torch, fn, activities, iters=5):
    """``{kernel name: launches}`` of one profiler window of ``iters``
    calls of ``fn``, padded with 5 ms of idle host time at both ends."""
    from torch.autograd import DeviceType
    from torch.profiler import profile
    with profile(activities=activities) as prof:
        time.sleep(0.005)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.005)
    return {e.key[:40]: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profiler_probe: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity as PA
    from repro_torch.kernels import _build, ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    _build.load_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn((4096, 4096), generator=gen, device="cuda")
    B, nc, Q, nh, hd, ds = 2, 16, 128, 80, 64, 64
    xh = torch.randn((B, nc, Q, nh, hd), generator=gen, device="cuda")
    dt = torch.rand((B, nc, Q, nh), generator=gen, device="cuda")
    Bc = torch.randn((B, nc, Q, ds), generator=gen, device="cuda")
    Cc = torch.randn((B, nc, Q, ds), generator=gen, device="cuda")
    fns = {"ssd_chunk": lambda: ops.ssd_chunk(xh, dt, -dt, Bc, Cc),
           "mm": lambda: a @ a}
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    cuda, both = [PA.CUDA], [PA.CPU, PA.CUDA]

    def probe(when):
        for name, fn in fns.items():
            for acts, what in ((cuda, "CUDA"), (both, "host and CUDA"),
                               (cuda, "CUDA")):
                print(f"{when}: {name}, {what}: {window(torch, fn, acts)}",
                      flush=True)

    probe("before (b)")
    with cs.first_intra_chunk_inputs():
        cs.phase_scoring_forward(torch, ops, cs.ZAMBA_FORWARD,
                                 cs.ZERO_LAUNCHES, shares=())
    probe("after (b)")
    time.sleep(2.0)
    probe("after (b) and 2 s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
