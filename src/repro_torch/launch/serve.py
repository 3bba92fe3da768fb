"""Serving entry point, the port of ``repro.launch.serve``.

Fixed-batch path (prefill, then greedy decode, all sequences in lock-step):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b \
      --reduced --batch 4 --prompt-len 32 --new-tokens 16

Continuous-batching engine (``--engine``: paged KV cache, ragged requests,
one prefill chunk and one fused decode step a tick, each step a CUDA graph
on the card; the ``SERVE_OPTIONS`` registry derives the flags
``--page-size``, ``--pool-pages``, ``--n-slots``, ``--prefill-buckets`` and
``--admit-policy``):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
      --reduced --engine --requests 8 --n-slots 4

Runs on the card unless ``--device cpu`` is given.  The path always runs
the CUDA kernels (``use_kernel=True``): on the card every dispatch gather,
grouped expert FFN and combine is a kernel launch.  rwkv6-1.6b serves too;
as in the JAX package, its cached steps run the plain WKV recurrence, so it
launches no kernel (the WKV6 kernel belongs to the cache-less forward).  ``serve(...,
moe_options={"dispatch_backend": "dropless"})`` serves without capacity
(the options of :func:`repro_torch.configs.with_options`, as in the JAX
package there is no flag for them): the expert FFN then runs the ragged
grouped-FFN kernel.  ``--num-layers`` cuts
the depth and ``--moe-grid N,M`` sets the logical expert grid, which a
SMILE config needs on one device (its ``grid=(0, 0)`` folds to ``(1, 1)``
there, and top-``top_g`` of one node cannot route).  The engine takes the
same ``num_layers``, ``moe_grid`` and ``moe_options`` (``serve_engine``).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.config import SERVE_OPTIONS, ModelConfig, ServeConfig
from repro_torch.common.device import resolve_device
from repro_torch.configs import get_config, get_reduced, with_options
from repro_torch.data.pipeline import synthetic_tokens
from repro_torch.kernels import ops as kops
from repro_torch.launch.train import add_option_flags, parse_option_flags
from repro_torch.models.transformer import init_caches, init_model
from repro_torch.serve.decode import decode_step_fn, prefill_fn
from repro_torch.serve.engine import Engine
from repro_torch.sharding.plan import MeshPlan, single_device_plan


@dataclasses.dataclass
class ServeInputs:
    """What :func:`serve` builds before it generates; hand it back to
    :func:`generate` to run the same weights and prompts again."""
    cfg: ModelConfig
    plan: MeshPlan
    params: Dict
    prompts: torch.Tensor               # (B, S) int32 on the device


@dataclasses.dataclass
class ServeResult:
    tokens: np.ndarray                  # (B, new_tokens) generated ids
    prefill_s: float                    # wall time of the prefill
    decode_s: float                     # wall time of all decode steps
    decode_steps: int
    batch: int
    launches: Dict[str, Dict[str, int]]  # phase -> kernel -> launches
    logits_finite: bool                 # every step's logits were finite
    inputs: Optional[ServeInputs] = None  # set by serve()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before[k] for k in after}


def serve_config(arch: str, *, reduced: bool = True,
                 num_layers: Optional[int] = None,
                 moe_grid: Optional[Tuple[int, int]] = None,
                 moe_options: Optional[dict] = None) -> ModelConfig:
    """The config :func:`serve` runs: the arch's config (or its reduced
    variant) with the depth, the logical expert grid and the MoE runtime
    options (``configs.with_options``) optionally set."""
    cfg = get_reduced(arch) if reduced else get_config(arch)
    if moe_options:
        cfg = with_options(cfg, **moe_options)
    if num_layers is not None:
        cfg = cfg.replace(num_layers=num_layers)
    if moe_grid is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  grid=tuple(moe_grid)))
    if not cfg.causal:
        raise SystemExit(f"{arch} is an encoder (MLM) model; no decode step")
    return cfg


def generate(params, prompts: torch.Tensor, cfg: ModelConfig,
             plan: MeshPlan, *, new_tokens: int) -> ServeResult:
    """Prefill ``prompts`` (B, S) and greedily decode ``new_tokens`` tokens
    per sequence through the kernel path, all sequences in lock-step.
    Times are host wall clock around work that ends in a device sync."""
    device = prompts.device
    batch, prompt_len = prompts.shape
    caches = init_caches(cfg, batch, prompt_len + new_tokens, plan,
                         device=device)
    run = dict(cfg=cfg, plan=plan, use_kernel=True)
    with torch.inference_mode():
        c0 = kops.launch_counts()
        _sync(device)
        t0 = time.perf_counter()
        tok, caches, logits = prefill_fn(params, prompts, caches, **run)
        finite = torch.isfinite(logits).all()
        _sync(device)
        t_prefill = time.perf_counter() - t0
        c1 = kops.launch_counts()
        out = [tok]
        t0 = time.perf_counter()
        for i in range(new_tokens - 1):
            tok, caches, logits = decode_step_fn(params, tok, caches,
                                                 prompt_len + i, **run)
            finite = finite & torch.isfinite(logits).all()
            out.append(tok)
        _sync(device)
        t_decode = time.perf_counter() - t0
        c2 = kops.launch_counts()
    gen = torch.stack(out, dim=-1).cpu().numpy()
    return ServeResult(gen, t_prefill, t_decode, new_tokens - 1, batch,
                       {"prefill": _delta(c1, c0), "decode": _delta(c2, c1)},
                       bool(finite))


def serve(arch: str, *, reduced: bool = True, batch: int = 4,
          prompt_len: int = 32, new_tokens: int = 16, seed: int = 0,
          device="cuda", num_layers: Optional[int] = None,
          moe_grid: Optional[Tuple[int, int]] = None,
          moe_options: Optional[dict] = None) -> ServeResult:
    """Random weights from ``seed``, synthetic prompts, then
    :func:`generate`; prints the times and the first generated row.  The
    result's ``inputs`` hold the config, weights and prompts."""
    cfg = serve_config(arch, reduced=reduced, num_layers=num_layers,
                       moe_grid=moe_grid, moe_options=moe_options)
    device = resolve_device(device)
    plan = single_device_plan()
    params = init_model(cfg, plan, seed=seed, device=device)
    prompts = torch.as_tensor(
        synthetic_tokens(np.random.default_rng(seed), batch, prompt_len,
                         cfg.vocab_size), device=device)
    res = generate(params, prompts, cfg, plan, new_tokens=new_tokens)
    res.inputs = ServeInputs(cfg, plan, params, prompts)
    steps = res.decode_steps
    print(f"prefill {prompt_len} toks x{batch}: {res.prefill_s * 1e3:.1f} ms;"
          f" decode {steps} steps: {res.decode_s * 1e3:.1f} ms "
          f"({steps * batch / max(res.decode_s, 1e-9):,.0f} tok/s)")
    print("generated (first row):", res.tokens[0].tolist())
    return res


@dataclasses.dataclass
class EngineResult:
    tokens: Dict[int, List[int]]        # request uid -> generated ids
    ttft_s: Dict[int, float]            # uid -> submit to first token
    tpot_s: Dict[int, float]            # uid -> mean time per later token
    wall_s: float                       # first submit to the last token
    ticks: int
    metrics: Dict                       # Engine.metrics()
    capture_launches: Dict[str, int]    # kernel -> launches at warm-up and
                                        # capture (none on the CPU)
    replays: int                        # graph replays (0 on the CPU)
    engine: Engine


def draw_requests(rng: np.random.Generator, n: int, prompt_len: int,
                  new_tokens: int, vocab_size: int) -> List[Tuple]:
    """``n`` ragged requests ``(prompt, max_new_tokens)`` drawn as the
    reference draws them: prompts of ``[prompt_len // 4, prompt_len]``
    tokens, ``[new_tokens // 2, new_tokens]`` new tokens."""
    out = []
    for _ in range(n):
        plen = int(rng.integers(max(1, prompt_len // 4), prompt_len + 1))
        nt = int(rng.integers(max(1, new_tokens // 2), new_tokens + 1))
        out.append((synthetic_tokens(rng, 1, plen, vocab_size)[0], nt))
    return out


def run_engine(params, cfg: ModelConfig, plan: MeshPlan,
               requests: List[Tuple], serve: ServeConfig,
               **engine_kw) -> EngineResult:
    """Submit every request at once to a new :class:`Engine` on the
    parameters' device and run it until it drains.  Times are host wall
    clock; each token's time is taken after its step's device-to-host
    copy."""
    eng = Engine(params, cfg, plan, serve=serve, **engine_kw)
    t0 = time.perf_counter()
    for prompt, nt in requests:
        eng.submit(prompt, nt)
    out = eng.run()
    wall = time.perf_counter() - t0
    ttft, tpot = {}, {}
    for uid, r in eng.requests.items():
        ttft[uid] = r.t_first - r.t_submit
        gaps = np.diff(r.t_tokens)
        tpot[uid] = float(gaps.mean()) if len(gaps) else float("nan")
    counts = eng.compile_counts()
    replays = (counts["replays"]["decode"]
               + sum(counts["replays"]["prefill"].values())
               if "replays" in counts else 0)
    return EngineResult(out, ttft, tpot, wall, eng.ticks, eng.metrics(),
                        eng.capture_launches(), replays, eng)


def serve_engine(arch: str, *, reduced: bool = True, requests: int = 8,
                 prompt_len: int = 32, new_tokens: int = 16, seed: int = 0,
                 device="cuda", num_layers: Optional[int] = None,
                 moe_grid: Optional[Tuple[int, int]] = None,
                 moe_options: Optional[dict] = None,
                 serve_opts: Optional[dict] = None) -> EngineResult:
    """Continuous-batching engine: random weights from ``seed``, ragged
    synthetic requests (:func:`draw_requests`) through the paged-KV engine,
    metrics printed at the end.  ``serve_opts`` sets ``ServeConfig``
    fields (the ``SERVE_OPTIONS`` flags)."""
    cfg = serve_config(arch, reduced=reduced, num_layers=num_layers,
                       moe_grid=moe_grid, moe_options=moe_options)
    device = resolve_device(device)
    plan = single_device_plan()
    scfg = dataclasses.replace(
        ServeConfig(prompt_len=prompt_len, max_new_tokens=new_tokens),
        **(serve_opts or {}))
    params = init_model(cfg, plan, seed=seed, device=device)
    reqs = draw_requests(np.random.default_rng(seed), requests, prompt_len,
                         new_tokens, cfg.vocab_size)
    res = run_engine(params, cfg, plan, reqs, scfg)
    m = res.metrics
    n_tok = sum(len(v) for v in res.tokens.values())
    print(f"engine: {requests} requests, {n_tok} tokens in {res.ticks} ticks"
          f" ({res.wall_s * 1e3:.0f} ms, {n_tok / max(res.wall_s, 1e-9):,.0f}"
          f" tok/s)")
    ttft = np.mean(list(res.ttft_s.values())) * 1e3
    tpot = np.nanmean(list(res.tpot_s.values())) * 1e3
    print(f"  time to first token mean {ttft:.1f} ms; time per output token "
          f"mean {tpot:.2f} ms")
    print(f"  pool occupancy mean/max: {m['page_occupancy_mean']:.2f}/"
          f"{m['page_occupancy_max']:.2f}  compiles: {m['compiles']}")
    print(f"  moe: drop={m['moe_drop_frac_mean']:.3f} "
          f"max_load={m['moe_hop_max_load_max']:.2f} "
          f"entropy_min={m['moe_hop_load_entropy_min']:.2f}")
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--num-layers", type=int, default=None)
    ap.add_argument("--moe-grid", default=None,
                    help="logical expert grid 'N,M' (e.g. 16,8)")
    ap.add_argument("--engine", action="store_true",
                    help="continuous-batching engine (paged KV cache) "
                         "instead of the fixed-batch lock-step path")
    ap.add_argument("--requests", type=int, default=8,
                    help="engine mode: synthetic ragged requests to submit")
    add_option_flags(ap, SERVE_OPTIONS)
    args = ap.parse_args()
    grid = (None if args.moe_grid is None
            else tuple(int(v) for v in args.moe_grid.split(",")))
    if args.engine:
        serve_engine(args.arch, reduced=args.reduced, requests=args.requests,
                     prompt_len=args.prompt_len, new_tokens=args.new_tokens,
                     seed=args.seed, device=args.device,
                     num_layers=args.num_layers, moe_grid=grid,
                     serve_opts=parse_option_flags(args, SERVE_OPTIONS))
        return
    serve(args.arch, reduced=args.reduced, batch=args.batch,
          prompt_len=args.prompt_len, new_tokens=args.new_tokens,
          seed=args.seed, device=args.device, num_layers=args.num_layers,
          moe_grid=grid)


if __name__ == "__main__":
    main()
