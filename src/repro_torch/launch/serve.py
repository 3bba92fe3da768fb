"""Serving entry point: batched prefill + greedy decode, all sequences in
lock-step (the fixed-batch path of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b \
      --reduced --batch 4 --prompt-len 32 --new-tokens 16

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
there, and top-``top_g`` of one node cannot route).  The continuous-batching
engine (``--engine`` in the JAX package) is not ported yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.config import ModelConfig
from repro_torch.common.device import resolve_device
from repro_torch.configs import get_config, get_reduced, with_options
from repro_torch.data.pipeline import synthetic_tokens
from repro_torch.kernels import ops as kops
from repro_torch.models.transformer import init_caches, init_model
from repro_torch.serve.decode import decode_step_fn, prefill_fn
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
    args = ap.parse_args()
    grid = (None if args.moe_grid is None
            else tuple(int(v) for v in args.moe_grid.split(",")))
    serve(args.arch, reduced=args.reduced, batch=args.batch,
          prompt_len=args.prompt_len, new_tokens=args.new_tokens,
          seed=args.seed, device=args.device, num_layers=args.num_layers,
          moe_grid=grid)


if __name__ == "__main__":
    main()
