"""Time the SSD kernel's grouped route at every head group G, and fit the
cost model that ``repro_torch.kernels.ops.ssd_route`` picks G with.

At zamba2-2.7b's shape (B 4, nc 32, Q 128, nh 80, hd 64, ds 64, fp32) it
launches ``ssd_chunk_grouped`` with each G from 1 to ``SSD_MAX_GROUP``
(every G holds the same outputs as G = 1, bit for bit), in rounds that
take the G in turns, and keeps each G's fastest round (CUDA events, the
mean of ``--iters`` calls after a warm-up).  A block of G heads costs
about G + c heads' time, c being its start (the loads, the scores C B^T
and the cumsums), and a launch about waves x (G + c), where waves =
ceil(blocks / SMs): a least-squares fit of ms = a waves G + b waves gives
a (ms a head a wave) and c = b / a.  Prints the card's name and power
limit, one line a G, the fit, and a JSON line last.

    PYTHONPATH=src python3 tools/ssd_group_sweep.py [--rounds 3] [--iters 20]

Needs one CUDA card; builds ``ssd_chunk.cu`` at first use.
"""
import argparse
import json
import subprocess

import numpy as np
import torch

from repro_torch.kernels import _build, ops

SHAPE = (4, 32, 128, 80, 64, 64)          # (B, nc, Q, nh, hd, ds)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ssd_group_sweep: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.splitlines()[0]
    print(card)
    B, nc, Q, nh, hd, ds = SHAPE
    BC, dev = B * nc, torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    xh = torch.randn((B, nc, Q, nh, hd), generator=gen, device=dev)
    dt = 0.001 + 0.099 * torch.rand((B, nc, Q, nh), generator=gen, device=dev)
    loga = -torch.rand((B, nc, Q, nh), generator=gen, device=dev)
    Bc, Cc = (torch.randn((B, nc, Q, ds), generator=gen, device=dev)
              for _ in range(2))
    outs = (torch.empty_like(xh),
            torch.empty((B, nc, nh, hd, ds), device=dev),
            torch.empty((B, nc, nh), device=dev))
    lib = _build.load("ssd_chunk")
    stream = torch.cuda.current_stream().cuda_stream

    def launch(G):
        err = lib.ssd_chunk_grouped(
            *(t.data_ptr() for t in (xh, dt, loga, Bc, Cc, *outs)),
            BC, Q, nh, hd, ds, G, stream)
        if err:
            raise RuntimeError(f"ssd_chunk_grouped G={G}: cudaError_t {err}")

    groups = list(range(1, ops.SSD_MAX_GROUP + 1))
    launch(1)
    first = [t.clone() for t in outs]
    for G in groups:
        launch(G)
        if not all(torch.equal(a, b) for a, b in zip(first, outs)):
            raise AssertionError(f"G={G} differs from G=1")
    best = {G: float("inf") for G in groups}
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for _ in range(args.rounds):
        for G in groups:
            launch(G)
            start.record()
            for _ in range(args.iters):
                launch(G)
            end.record()
            end.synchronize()
            best[G] = min(best[G], start.elapsed_time(end) / args.iters)

    waves = {G: -(-BC * -(-nh // G) // sms) for G in groups}
    A = np.array([[waves[G] * G, waves[G]] for G in groups], dtype=float)
    y = np.array([best[G] for G in groups])
    (a, b), *_ = np.linalg.lstsq(A, y, rcond=None)
    c = b / a
    for G in groups:
        print(f"G {G:2d}: {BC * -(-nh // G):5d} blocks, {waves[G]:2d} waves, "
              f"{best[G]:.4f} ms; model {a * waves[G] * (G + c):.4f}")
    fastest = min(groups, key=best.get)
    print(f"fit: {a:.5f} ms a head a wave, a block's start c = {c:.2f} "
          f"heads; fastest G {fastest} ({best[fastest]:.4f} ms); ssd_route "
          f"picks G {ops.ssd_route(BC, Q, nh, hd, ds, sms).group} "
          f"({best[ops.ssd_route(BC, Q, nh, hd, ds, sms).group]:.4f} ms)")
    print(json.dumps({"card": card, "shape": SHAPE, "sms": sms,
                      "ms": {G: best[G] for G in groups},
                      "head_ms": a, "start_heads": c, "fastest": fastest}))


if __name__ == "__main__":
    main()
