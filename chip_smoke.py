#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code:

1. Card and build: print the card's name and power limit (nvidia-smi) and
   build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc, one
   process per source, in parallel).
2. Kernels against their plain PyTorch versions on the card, at the shapes
   of the serving path (qwen3-moe-30b-a3b at full width, logical expert grid
   (16, 8), batch 8, prompt 128; decode t=8): errors, and times from CUDA
   events beside the least time the card could take.
3. The path: ``repro_torch.launch.serve.serve`` on qwen3-moe-30b-a3b at full
   width with the depth cut to 4 of 48 layers, random weights from seed 0,
   batch 8, prompt 128, 32 new tokens.  Every kernel must have launched in
   both prefill and decode, and the logits must be finite.  Then the same
   weights and prompts through ``generate`` again, warm, and once more
   under the profiler.
4. Card against CPU: the reduced qwen3-moe config, prefill plus 3 decode
   steps on the CPU (plain versions) and on the card (kernels), logits held
   within the tolerance of the CPU slice test.
5. A ``{"kernels": [...]}`` line, then the card line, then the last line
   ``{"ok": true, "device": {...}}``.

It needs one CUDA card; without one, or without the repository's ``src``
beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
BF16_TC_FLOPS = 989e12             # H100 SXM dense bf16 tensor cores
FP32_FLOPS = 67e12                 # H100 SXM fp32, outside the tensor cores

# serving shapes: qwen3-moe-30b-a3b, d=2048, f=768, 128 experts, top-8 over
# top_g=4 of 16 nodes, capacity factor 2, batch 8 x prompt 128 (t=1024) and
# decode (t=8)
D_MODEL, D_FF = 2048, 768
# name -> (tokens t, rows R, k) per dispatch/combine hop
GATHER_SHAPES = {
    "prefill hop-1": (1024, 8192, 4),
    "prefill hop-2": (8192, 32768, 2),
    "decode hop-1": (8, 64, 4),
    "decode hop-2": (64, 256, 2),
}
FFN_SHAPES = {"prefill": (128, 256), "decode": (128, 2)}   # (G, T)
# the tolerance of tests/test_torch_serve.py for bf16 logits
LOGITS_ATOL = 3e-2
FFN_RTOL = FFN_ATOL = 2e-2

SOURCES = {
    "dispatch_gather": ("src/repro_torch/kernels/csrc/dispatch_gather.cu",
                        "src/repro/kernels/moe_dispatch.py:49"),
    "grouped_ffn": ("src/repro_torch/kernels/csrc/grouped_ffn.cu",
                    "src/repro/kernels/grouped_ffn.py:103"),
    "combine_gather": ("src/repro_torch/kernels/csrc/combine_gather.cu",
                       "src/repro/kernels/moe_dispatch.py:94"),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float, peak_ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak_ops
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops
            else "operations")


def phase_kernels(torch, ops, ref):
    """Each kernel against its plain version at the path's shapes."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    bf = torch.bfloat16
    rows = {}

    def record(name, shape, got, want, ms, plain_ms, b, library_ms=None):
        err = (got.float() - want.float()).abs().max().item()
        rel = err / max(want.float().abs().max().item(), 1e-30)
        rows.setdefault(name, []).append(dict(
            shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b[0], bound_by=b[1], library_ms=library_ms))
        lib = "n/a" if library_ms is None else f"{library_ms:.4f}"
        print(f"  {name:15s} {shape:13s} max abs err {err:.3e} (over max "
              f"|ref|: {rel:.2e})  kernel {ms:.4f} ms  plain "
              f"{plain_ms:.4f} ms  bound {b[0]:.4f} ms ({b[1]})  library "
              f"{lib} ms")

    for shape, (t, R, k) in GATHER_SHAPES.items():
        # dispatch: x (t, d) -> (R, d); a quarter of the slots empty
        x = torch.randn((t, D_MODEL), generator=gen, device=dev).to(bf)
        src = torch.randint(0, t, (R,), generator=gen, device=dev,
                            dtype=torch.int32)
        empty = torch.rand((R,), generator=gen, device=dev) < 0.25
        src = torch.where(empty, torch.full_like(src, -1), src)
        got = ops.dispatch_gather(x, src)
        want = ref.dispatch_gather_ref(x, src)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"dispatch_gather {shape}: not bit-exact")
        used = torch.unique(src[src >= 0]).numel()
        nbytes = used * D_MODEL * 2 + R * 4 + R * D_MODEL * 2
        record("dispatch_gather", shape, got, want,
               time_ms(lambda: ops.dispatch_gather(x, src)),
               time_ms(lambda: ref.dispatch_gather_ref(x, src)),
               bound(nbytes, 0, FP32_FLOPS))

        # combine: the hop's R buffer rows back to its t tokens, k each
        buf = torch.randn((R, D_MODEL), generator=gen, device=dev).to(bf)
        csrc = torch.randint(0, R, (t, k), generator=gen, device=dev,
                             dtype=torch.int32)
        drop = torch.rand((t, k), generator=gen, device=dev) < 0.1
        csrc = torch.where(drop, torch.full_like(csrc, -1), csrc)
        scale = torch.rand((t, k), generator=gen, device=dev)
        got = ops.combine_gather(buf, csrc, scale)
        want = ref.combine_gather_ref(buf, csrc, scale)
        torch.cuda.synchronize()
        wf = want.float()
        ulp = torch.where(wf == 0, torch.full_like(wf, 1e-30),
                          wf.abs() * 2.0 ** -7)
        if not bool(((got.float() - wf).abs() <= ulp).all()):
            raise AssertionError(f"combine_gather {shape}: more than 1 bf16 "
                                 f"ulp from the plain version")
        valid = int((csrc >= 0).sum())
        used = torch.unique(csrc[csrc >= 0]).numel()
        nbytes = used * D_MODEL * 2 + t * k * 8 + t * D_MODEL * 2
        record("combine_gather", shape, got, want,
               time_ms(lambda: ops.combine_gather(buf, csrc, scale)),
               time_ms(lambda: ref.combine_gather_ref(buf, csrc, scale)),
               bound(nbytes, 2.0 * valid * D_MODEL, FP32_FLOPS))

    for shape, (G, T) in FFN_SHAPES.items():
        x = torch.randn((G, T, D_MODEL), generator=gen, device=dev).to(bf)
        w1 = (torch.randn((G, D_MODEL, D_FF), generator=gen, device=dev)
              / D_MODEL ** 0.5).to(bf)
        w3 = (torch.randn((G, D_MODEL, D_FF), generator=gen, device=dev)
              / D_MODEL ** 0.5).to(bf)
        w2 = (torch.randn((G, D_FF, D_MODEL), generator=gen, device=dev)
              / D_FF ** 0.5).to(bf)
        got = ops.grouped_ffn(x, w1, w3, w2, act="silu")
        want = ref.grouped_ffn_ref(x, w1, w3, w2, act="silu")
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        if not bool((diff <= FFN_ATOL + FFN_RTOL * want.float().abs()).all()):
            raise AssertionError(f"grouped_ffn {shape}: outside rtol "
                                 f"{FFN_RTOL} / atol {FFN_ATOL}")

        def library():
            return torch.bmm(F.silu(torch.bmm(x, w1)) * torch.bmm(x, w3), w2)

        nbytes = (2 * G * T * D_MODEL + 3 * G * D_MODEL * D_FF) * 2
        flops = 2.0 * G * T * D_MODEL * D_FF * 3
        record("grouped_ffn", shape, got, want,
               time_ms(lambda: ops.grouped_ffn(x, w1, w3, w2, act="silu")),
               time_ms(lambda: ref.grouped_ffn_ref(x, w1, w3, w2,
                                                   act="silu")),
               bound(nbytes, flops, BF16_TC_FLOPS), time_ms(library))
    return rows


SERVE = dict(arch="qwen3-moe-30b-a3b", reduced=False, num_layers=4,
             moe_grid=(16, 8))


def phase_serve(torch, ops):
    """The main path: serve() once, every launch count set to 0 just
    before and read just after."""
    from repro_torch.launch.serve import serve
    from repro_torch.common.config import ServeConfig
    sc = ServeConfig()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = serve(SERVE["arch"], reduced=False, batch=sc.batch_size,
                prompt_len=sc.prompt_len, new_tokens=sc.max_new_tokens,
                seed=0, device="cuda", num_layers=SERVE["num_layers"],
                moe_grid=SERVE["moe_grid"])
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = res.decode_steps
    print(f"  first call: prefill {res.prefill_s * 1e3:.2f} ms "
          f"({sc.batch_size} x {sc.prompt_len} tokens); decode "
          f"{res.decode_s / steps * 1e3:.2f} ms per step over {steps} steps "
          f"({steps * res.batch / res.decode_s:.1f} tokens/s)")
    print(f"  first generated row: {res.tokens[0].tolist()}")
    print(f"  launches: prefill {res.launches['prefill']}, "
          f"decode {res.launches['decode']}")
    print(f"  max_memory_allocated {peak / 2**30:.2f} GiB")
    if not res.logits_finite:
        raise AssertionError("serve: non-finite logits")
    per_forward = {"dispatch_gather": 8, "grouped_ffn": 4,
                   "combine_gather": 8}
    for phase, n in (("prefill", 1), ("decode", steps)):
        want = {k: v * n for k, v in per_forward.items()}
        if res.launches[phase] != want:
            raise AssertionError(f"serve {phase}: launches "
                                 f"{res.launches[phase]}, expected {want}")
    if res.tokens.shape != (sc.batch_size, sc.max_new_tokens):
        raise AssertionError(f"serve: tokens {res.tokens.shape}")
    return launches, res


def phase_warm(torch, first):
    """serve()'s weights and prompts through generate() again: warm times,
    then the same run under the profiler for the device time by kernel,
    the idle share, and the host's op, launch and synchronization counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import generate
    inp = first.inputs
    new_tokens = first.tokens.shape[1]

    def run():
        return generate(inp.params, inp.prompts, inp.cfg, inp.plan,
                        new_tokens=new_tokens)

    res = run()
    steps = res.decode_steps
    print(f"  warm: prefill {res.prefill_s * 1e3:.2f} ms; decode "
          f"{res.decode_s / steps * 1e3:.2f} ms per step "
          f"({steps * res.batch / res.decode_s:.1f} tokens/s); tokens equal "
          f"to the first call: {bool((res.tokens == first.tokens).all())}")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev, runtime = {}, {}
    for e in prof.key_averages():
        # device-side entries only: a CPU op's entry repeats the time of
        # the kernels it launched
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            dev[e.key] = dev.get(e.key, 0.0) + us
        elif e.key.startswith("cuda"):
            runtime[e.key] = runtime.get(e.key, 0) + e.count
    busy = sum(dev.values())
    top_ops = sum(1 for e in prof.events()
                  if e.cpu_parent is None and e.name.startswith("aten::"))
    launches = sum(n for k, n in runtime.items() if "Launch" in k)
    syncs = sum(n for k, n in runtime.items() if "Synchronize" in k)
    fwd = new_tokens                     # one prefill + the decode steps
    print(f"  profiled (the whole run, {fwd} forwards, profiler on): wall "
          f"{wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms, idle "
          f"share {1 - busy / wall_us:.3f}; per forward "
          f"{top_ops / fwd:.0f} top-level aten ops, {launches / fwd:.0f} "
          f"kernel launches, {syncs / fwd:.2f} host synchronizations")
    for name, us in sorted(dev.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    {us / 1e3:8.3f} ms  {100 * us / max(busy, 1e-9):5.1f}%  "
              f"{name[:90]}")


def phase_card_vs_cpu(torch):
    """Reduced qwen3-moe: prefill + 3 decode steps, CPU plain versions
    against the card's kernels, the CPU's tokens fed to both."""
    import numpy as np
    from repro_torch.configs import get_reduced
    from repro_torch.models import transformer as T
    from repro_torch.sharding.plan import single_device_plan
    cfg = get_reduced("qwen3-moe-30b-a3b")
    plan = single_device_plan()
    params = T.init_model(cfg, plan, seed=0, device="cpu")

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(to(v, dev) for v in tree)
        return tree.to(dev)

    B, S, steps = 2, 16, 3
    toks = np.random.default_rng(0).integers(8, cfg.vocab_size, (B, S))
    runs = {}
    for dev in ("cpu", "cuda"):
        p = to(params, dev)
        caches = T.init_caches(cfg, B, S + steps, plan, device=dev)
        outs = []
        tok = torch.as_tensor(toks, dtype=torch.int32, device=dev)
        with torch.inference_mode():
            for i in range(steps + 1):
                pos = (torch.arange(S, dtype=torch.int32, device=dev) if i == 0
                       else torch.tensor([S + i - 1], dtype=torch.int32,
                                         device=dev))
                _, logits, _, caches = T.forward(p, tok, cfg, plan,
                                                 positions=pos, caches=caches,
                                                 use_kernel=True)
                outs.append(logits.float().cpu())
                nxt = (runs["cpu"][i] if dev == "cuda" else logits.cpu())
                tok = nxt[:, -1].argmax(-1).to(torch.int32)[:, None].to(dev)
        runs[dev] = outs
    for i, (a, b) in enumerate(zip(runs["cpu"], runs["cuda"])):
        err = (a - b).abs().max().item()
        what = "prefill" if i == 0 else f"decode {i}"
        print(f"  {what}: max |logits_cpu - logits_card| {err:.3e} "
              f"(tolerance {LOGITS_ATOL}, |logits| max "
              f"{a.abs().max().item():.3f})")
        if not err <= LOGITS_ATOL:
            raise AssertionError(f"card against CPU, {what}: {err}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build, ops, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    print("== phase 1: card and build")
    card = card_line()
    print(f"  card: {card}")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.load_all()
    print(f"  kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  [{name}] {line.strip()}")

    print(f"== phase 2: kernels against their plain versions ({card}); "
          f"tolerances: dispatch_gather bit-exact, combine_gather 1 bf16 "
          f"ulp, grouped_ffn rtol {FFN_RTOL} + atol {FFN_ATOL}")
    rows = phase_kernels(torch, ops, ref)

    print(f"== phase 3: serve qwen3-moe-30b-a3b, full width, 4 of 48 layers "
          f"({card})")
    launches, first = phase_serve(torch, ops)
    phase_warm(torch, first)
    del first

    print("== phase 4: card against CPU, reduced qwen3-moe-30b-a3b")
    phase_card_vs_cpu(torch)

    main_shape = {"dispatch_gather": "prefill hop-2",
                  "combine_gather": "prefill hop-2",
                  "grouped_ffn": "prefill"}
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        r = next(x for x in rows[name] if x["shape"] == main_shape[name])
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(x["max_abs_err"] for x in rows[name]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    print(f"  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
