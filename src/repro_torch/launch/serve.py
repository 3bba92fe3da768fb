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

Over a mesh of ranks (expert, tensor and data parallel, as the JAX
package's ``serve(..., mesh=...)``): ``--mesh 2,2`` (axes ``data, model``;
three numbers add ``pod`` in front) spawns one process a rank, with the
backend and the ranks' devices given explicitly, e.g. four ranks sharing
one card over gloo, or on the CPU:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch \
      qwen3-moe-30b-a3b --num-layers 4 --moe-grid 16,8 --batch 8 \
      --mesh 2,2 --backend gloo --devices cuda:0
  PYTHONPATH=src python -m repro_torch.launch.serve --arch \
      qwen3-moe-30b-a3b --reduced --mesh 2,2 --backend gloo --devices cpu

(``--backend nccl`` needs a card a rank: ``--devices cuda:0,cuda:1,...``).
Under ``torchrun`` add ``--launcher env``: each process is then one rank,
initialized from ``env://``.

Runs on the card unless ``--device cpu`` is given.  The path always runs
the CUDA kernels (``use_kernel=True``): on the card every dispatch gather,
grouped expert FFN and combine is a kernel launch.  rwkv6-1.6b serves too;
as in the JAX package, its cached steps run the plain WKV recurrence, so it
launches no kernel (the WKV6 kernel belongs to the cache-less forward).  ``serve(...,
moe_options={"dispatch_backend": "dropless"})`` serves without capacity
(the options of :func:`repro_torch.configs.with_options`, as in the JAX
package there is no flag for them): the expert FFN then runs the ragged
grouped-FFN kernel.  zamba2-2.7b serves as the JAX package's does: no
kernel launches (its Mamba2 blocks take none, and its shared attention
block runs with ``use_kernel=False``), a prompt at most one SSD chunk or
a multiple of one.  ``--num-layers`` cuts
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
import torch.distributed as dist

from repro_torch.common.config import SERVE_OPTIONS, ModelConfig, ServeConfig
from repro_torch.common.device import resolve_device
from repro_torch.configs import get_config, get_reduced, with_options
from repro_torch.data.pipeline import synthetic_tokens
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import (MESH_AXES, add_mesh_flags, make_mesh,
                                     mesh_cli, spawn)
from repro_torch.launch.train import (add_option_flags, cut_depth,
                                      parse_option_flags)
from repro_torch.models.transformer import init_caches, init_model
from repro_torch.serve.decode import decode_step_fn, prefill_fn
from repro_torch.serve.engine import Engine
from repro_torch.sharding import comm
from repro_torch.sharding import specs as S
from repro_torch.sharding.plan import (MeshPlan, plan_from_mesh,
                                       single_device_plan)


@dataclasses.dataclass
class ServeInputs:
    """What :func:`serve` builds before it generates; hand it back to
    :func:`generate` to run the same weights and prompts again (over a
    mesh: the rank's slices)."""
    cfg: ModelConfig
    plan: MeshPlan
    params: Dict
    prompts: torch.Tensor               # (B, S) or (B, K, S) int32, device


@dataclasses.dataclass
class ServeResult:
    tokens: np.ndarray                  # (B, [K,] new_tokens) generated ids
    prefill_s: float                    # wall time of the prefill
    decode_s: float                     # wall time of all decode steps
    decode_steps: int
    batch: int
    launches: Dict[str, Dict[str, int]]  # phase -> kernel -> launches
    logits_finite: bool                 # every step's logits were finite
    inputs: Optional[ServeInputs] = None  # set by serve()
    # over a mesh: phase -> the rank's comm.WireLog summary
    wire: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    logits: Optional[np.ndarray] = None  # (steps, B, [K,] V_loc), kept


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
        cfg = cut_depth(cfg, num_layers)
    if moe_grid is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  grid=tuple(moe_grid)))
    if not cfg.causal:
        raise SystemExit(f"{arch} is an encoder (MLM) model; no decode step")
    return cfg


def generate(params, prompts: torch.Tensor, cfg: ModelConfig,
             plan: MeshPlan, *, new_tokens: int, keep_logits: bool = False,
             use_kernel: bool = True) -> ServeResult:
    """Prefill ``prompts`` (B, S), or (B, K, S) under K > 1 codebooks (the
    tokens then (B, K, new_tokens)), and greedily decode ``new_tokens``
    tokens per sequence through the kernel path (``use_kernel=False``: the plain
    path, which also takes fp32 compute), all sequences in lock-step.
    Times are host wall clock around work that ends in a device sync.

    Over a mesh (a plan with named axes) every rank calls this on its
    slice: its prompts, parameters and caches; the result holds the
    rank's rows and its wire log by phase (``comm.WireLog``, reset before
    each phase).  ``keep_logits`` keeps every step's last-position logits
    (the rank's part of the vocabulary) on the host."""
    device = prompts.device
    batch, prompt_len = prompts.shape[0], prompts.shape[-1]
    caches = init_caches(cfg, batch, prompt_len + new_tokens, plan,
                         device=device)
    run = dict(cfg=cfg, plan=plan, use_kernel=use_kernel)
    wire = comm.bound_mesh().wire if plan.all_axes else None
    wires, kept = {}, []

    def mark(phase=None):
        if wire is not None:
            if phase is not None:
                wires[phase] = wire.summary()
            wire.reset()

    with torch.inference_mode():
        c0 = kops.launch_counts()
        _sync(device)
        mark()
        t0 = time.perf_counter()
        tok, caches, logits = prefill_fn(params, prompts, caches, **run)
        finite = torch.isfinite(logits).all()
        _sync(device)
        t_prefill = time.perf_counter() - t0
        mark("prefill")
        if keep_logits:
            kept.append(logits.float().cpu())
        c1 = kops.launch_counts()
        out = [tok]
        t0 = time.perf_counter()
        for i in range(new_tokens - 1):
            tok, caches, logits = decode_step_fn(params, tok, caches,
                                                 prompt_len + i, **run)
            finite = finite & torch.isfinite(logits).all()
            out.append(tok)
            if keep_logits:
                kept.append(logits.float().cpu())
        _sync(device)
        t_decode = time.perf_counter() - t0
        mark("decode")
        c2 = kops.launch_counts()
    gen = torch.stack(out, dim=-1).cpu().numpy()
    return ServeResult(gen, t_prefill, t_decode, new_tokens - 1, batch,
                       {"prefill": _delta(c1, c0), "decode": _delta(c2, c1)},
                       bool(finite), wire=wires,
                       logits=(torch.stack(kept).numpy() if keep_logits
                               else None))


def serve_prompts(cfg: ModelConfig, batch: int, prompt_len: int, seed: int,
                  device, mesh=None, plan: Optional[MeshPlan] = None
                  ) -> torch.Tensor:
    """The synthetic prompts :func:`serve` runs, (batch, prompt_len) from
    ``seed`` (under K > 1 codebooks (batch, K, prompt_len), a stream a
    codebook, as the reference draws them); over a mesh the rank's rows
    (the batch split over dp)."""
    rng = np.random.default_rng(seed)
    if cfg.num_codebooks > 1:
        toks = np.stack([synthetic_tokens(rng, batch, prompt_len,
                                          cfg.vocab_size)
                         for _ in range(cfg.num_codebooks)], 1)
    else:
        toks = synthetic_tokens(rng, batch, prompt_len, cfg.vocab_size)
    prompts = torch.as_tensor(toks)
    if mesh is not None:
        prompts = S.shard_params(prompts, S.batch_specs(prompts, plan), mesh)
    return prompts.to(device)


def serve(arch: str, *, reduced: bool = True, batch: int = 4,
          prompt_len: int = 32, new_tokens: int = 16, seed: int = 0,
          device=None, num_layers: Optional[int] = None,
          moe_grid: Optional[Tuple[int, int]] = None,
          moe_options: Optional[dict] = None, mesh=None,
          keep_logits: bool = False) -> ServeResult:
    """Random weights from ``seed``, synthetic prompts, then
    :func:`generate`.  The result's ``inputs`` hold the config, weights
    and prompts.

    On one device (``device``, the card unless the caller asks for the
    CPU) it prints the times and the first generated row.  With ``mesh``
    (:func:`repro_torch.launch.mesh.make_mesh`; the rank's device is the
    mesh's) the plan is ``plan_from_mesh(mesh)``, the prompts are split
    over dp, and the parameters (the same numbers as one device draws) and
    caches are the rank's slices; nothing is printed, and the result holds
    the rank's rows (:func:`serve_mesh` gathers them)."""
    cfg = serve_config(arch, reduced=reduced, num_layers=num_layers,
                       moe_grid=moe_grid, moe_options=moe_options)
    if mesh is None:
        device = resolve_device("cuda" if device is None else device)
        plan = single_device_plan()
    else:
        if device is not None and resolve_device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device}")
        device, plan = mesh.device, plan_from_mesh(mesh)
    params = init_model(cfg, plan, seed=seed, device=device, mesh=mesh)
    prompts = serve_prompts(cfg, batch, prompt_len, seed, device, mesh, plan)
    res = generate(params, prompts, cfg, plan, new_tokens=new_tokens,
                   keep_logits=keep_logits)
    res.inputs = ServeInputs(cfg, plan, params, prompts)
    if mesh is None:
        steps = res.decode_steps
        print(f"prefill {prompt_len} toks x{batch}: "
              f"{res.prefill_s * 1e3:.1f} ms; decode {steps} steps: "
              f"{res.decode_s * 1e3:.1f} ms "
              f"({steps * batch / max(res.decode_s, 1e-9):,.0f} tok/s)")
        print("generated (first row):", res.tokens[0].tolist())
    return res


def _serve_rank(rank, shape, kw) -> dict:
    """One rank of :func:`serve_mesh` (a :class:`RankPool` task)."""
    mesh = make_mesh(shape, MESH_AXES[len(shape)], device=rank.device)
    res = serve(mesh=mesh, **kw)
    return {"tokens": res.tokens, "prefill_s": res.prefill_s,
            "decode_s": res.decode_s, "dp_index": mesh.index(
                res.inputs.plan.dp_axes), "tp_index": mesh.index("model"),
            "finite": res.logits_finite, "wire": res.wire,
            "logits": res.logits, "launches": res.launches}


def gather_rows(results: List[dict]) -> np.ndarray:
    """The global (B, n) tokens from the ranks' results: each dp slice
    from its tp rank 0, in dp order."""
    firsts = sorted((r["dp_index"], r["tokens"]) for r in results
                    if r["tp_index"] == 0)
    return np.concatenate([t for _, t in firsts])


def gather_logits(results: List[dict]) -> np.ndarray:
    """The global (steps, B, [K,] V) logits from the ranks' kept ones: each
    rank's vocabulary slice in tp order, its rows in dp order."""
    rows = {}
    for r in results:
        rows.setdefault(r["dp_index"], {})[r["tp_index"]] = r["logits"]
    return np.concatenate([np.concatenate([v[t] for t in sorted(v)], -1)
                           for _, v in sorted(rows.items())], 1)


def serve_mesh(arch: str, shape: Tuple[int, ...], *, backend: str,
               devices, threads: Optional[int] = None,
               timeout_s: float = 600.0, **kw) -> List[dict]:
    """:func:`serve` (``kw``) over a mesh of ``shape`` (axes
    ``MESH_AXES``): one process a rank (:func:`repro_torch.launch.mesh.
    spawn`) under ``backend`` on ``devices[rank]``; prints the slowest
    rank's times and the first generated row; returns each rank's
    result."""
    world = int(np.prod(shape))
    out = spawn(_serve_rank, world, backend=backend, devices=devices,
                args=(tuple(shape), dict(arch=arch, **kw)), threads=threads,
                timeout_s=timeout_s)
    if not all(r["finite"] for r in out):
        raise RuntimeError("serve over the mesh: non-finite logits")
    tokens = gather_rows(out)
    pf = max(r["prefill_s"] for r in out)
    dc = max(r["decode_s"] for r in out)
    steps = tokens.shape[-1] - 1
    print(f"mesh {dict(zip(MESH_AXES[len(shape)], shape))}, {backend}: "
          f"prefill {kw.get('prompt_len')} toks x{tokens.shape[0]}: "
          f"{pf * 1e3:.1f} ms; decode {steps} steps: {dc * 1e3:.1f} ms "
          f"({steps * tokens.shape[0] / max(dc, 1e-9):,.0f} tok/s; slowest "
          f"rank)")
    print("generated (first row):", tokens[0].tolist())
    return out


@dataclasses.dataclass
class EngineResult:
    tokens: Dict[int, List[int]]        # request uid -> generated ids
    ttft_s: Dict[int, float]            # uid -> submit to first token
    queue_wait_s: Dict[int, float]      # uid -> submit to admission
    prefill_wait_s: Dict[int, float]    # uid -> admission to first chunk
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
    copy.  ``engine_kw`` goes to the engine (``mesh=``: every rank of the
    mesh calls this on its slice, with the same requests)."""
    eng = Engine(params, cfg, plan, serve=serve, **engine_kw)
    t0 = time.perf_counter()
    for prompt, nt in requests:
        eng.submit(prompt, nt)
    out = eng.run()
    wall = time.perf_counter() - t0
    ttft, tpot, queue_wait, prefill_wait = {}, {}, {}, {}
    for uid, r in eng.requests.items():
        ttft[uid] = r.t_first - r.t_submit
        queue_wait[uid] = r.t_admit - r.t_submit
        prefill_wait[uid] = r.t_prefill - r.t_admit
        gaps = np.diff(r.t_tokens)
        tpot[uid] = float(gaps.mean()) if len(gaps) else float("nan")
    counts = eng.compile_counts()
    replays = (counts["replays"]["decode"]
               + sum(counts["replays"]["prefill"].values())
               if "replays" in counts else 0)
    return EngineResult(out, ttft, queue_wait, prefill_wait, tpot, wall,
                        eng.ticks, eng.metrics(),
                        eng.capture_launches(), replays, eng)


def print_engine_summary(res: dict, what: str = "engine") -> None:
    """The engine's summary (``res``: :func:`engine_summary`): requests,
    tokens, ticks, wall time and tokens/s, mean TTFT and TPOT, the mean
    admission and prefill waits inside the TTFT, page occupancy, compile
    counts and the MoE telemetry."""
    m, wall = res["metrics"], res["wall_s"]
    n_tok = sum(len(v) for v in res["tokens"].values())
    print(f"{what}: {len(res['tokens'])} requests, {n_tok} tokens in "
          f"{res['ticks']} ticks ({wall * 1e3:.0f} ms, "
          f"{n_tok / max(wall, 1e-9):,.0f} tok/s)")
    ttft = np.mean(list(res["ttft_s"].values())) * 1e3
    tpot = np.nanmean(list(res["tpot_s"].values())) * 1e3
    print(f"  time to first token mean {ttft:.1f} ms; time per output token "
          f"mean {tpot:.2f} ms")
    qw, pw = (np.mean(list(res[k].values())) * 1e3
              for k in ("queue_wait_s", "prefill_wait_s"))
    print(f"  of the first token: admission wait mean {qw:.1f} ms, prefill "
          f"wait mean {pw:.1f} ms")
    print(f"  pool occupancy mean/max: {m['page_occupancy_mean']:.2f}/"
          f"{m['page_occupancy_max']:.2f}  compiles: {m['compiles']}")
    print(f"  moe: drop={m['moe_drop_frac_mean']:.3f} "
          f"max_load={m['moe_hop_max_load_max']:.2f} "
          f"entropy_min={m['moe_hop_load_entropy_min']:.2f}")


def engine_summary(res: EngineResult) -> dict:
    """The picklable part of an :class:`EngineResult` (a rank's result)."""
    return {"tokens": res.tokens, "ttft_s": res.ttft_s,
            "queue_wait_s": res.queue_wait_s,
            "prefill_wait_s": res.prefill_wait_s, "tpot_s": res.tpot_s,
            "wall_s": res.wall_s, "ticks": res.ticks, "metrics": res.metrics}


def serve_engine(arch: str, *, reduced: bool = True, requests: int = 8,
                 prompt_len: int = 32, new_tokens: int = 16, seed: int = 0,
                 device="cuda", num_layers: Optional[int] = None,
                 moe_grid: Optional[Tuple[int, int]] = None,
                 moe_options: Optional[dict] = None,
                 serve_opts: Optional[dict] = None,
                 mesh=None) -> EngineResult:
    """Continuous-batching engine: random weights from ``seed``, ragged
    synthetic requests (:func:`draw_requests`) through the paged-KV engine,
    metrics printed at the end.  ``serve_opts`` sets ``ServeConfig``
    fields (the ``SERVE_OPTIONS`` flags).

    With ``mesh`` the plan is ``plan_from_mesh(mesh)``, the parameters
    are the rank's slices (the same numbers as one device draws) on the
    mesh's device, every rank submits the same requests, and nothing is
    printed (:func:`serve_engine_mesh` prints the slowest rank's)."""
    cfg = serve_config(arch, reduced=reduced, num_layers=num_layers,
                       moe_grid=moe_grid, moe_options=moe_options)
    if mesh is None:
        device, plan = resolve_device(device), single_device_plan()
    else:
        device, plan = mesh.device, plan_from_mesh(mesh)
    scfg = dataclasses.replace(
        ServeConfig(prompt_len=prompt_len, max_new_tokens=new_tokens),
        **(serve_opts or {}))
    params = init_model(cfg, plan, seed=seed, device=device, mesh=mesh)
    reqs = draw_requests(np.random.default_rng(seed), requests, prompt_len,
                         new_tokens, cfg.vocab_size)
    res = run_engine(params, cfg, plan, reqs, scfg, mesh=mesh)
    if mesh is None:
        print_engine_summary(engine_summary(res))
    return res


def _engine_rank(rank, shape, kw) -> dict:
    """One rank of :func:`serve_engine_mesh` (a :class:`RankPool` task)."""
    mesh = make_mesh(shape, MESH_AXES[len(shape)], device=rank.device)
    res = engine_summary(serve_engine(mesh=mesh, **kw))
    return {**res, "agree": ranks_agree(res["tokens"], mesh)}


def ranks_agree(tokens: Dict[int, List[int]], mesh) -> bool:
    """On every rank of ``mesh``: whether every rank finished the same
    requests with the same tokens (an all-gather of each rank's tokens in
    uid order; the counts are equal on every rank by construction)."""
    flat = torch.as_tensor([t for u in sorted(tokens) for t in tokens[u]],
                           dtype=torch.int32, device=mesh.device)
    every = comm.all_gather(flat, mesh.axes, axis=0, tiled=False)
    return bool((every == flat[None]).all())


def serve_engine_mesh(arch: str, shape: Tuple[int, ...], *, backend: str,
                      devices, threads: Optional[int] = None,
                      timeout_s: float = 600.0, **kw) -> List[dict]:
    """:func:`serve_engine` (``kw``) over a mesh of ``shape`` (axes
    ``MESH_AXES``): one process a rank under ``backend`` on
    ``devices[rank]``, as :func:`serve_mesh`; checks that every rank gave
    the same tokens (:func:`ranks_agree`), prints the slowest rank's
    summary, and returns each rank's :func:`engine_summary`."""
    world = int(np.prod(shape))
    out = spawn(_engine_rank, world, backend=backend, devices=devices,
                args=(tuple(shape), dict(arch=arch, **kw)), threads=threads,
                timeout_s=timeout_s)
    if not all(r["agree"] for r in out):
        raise RuntimeError("engine over the mesh: the ranks' tokens differ")
    axes = dict(zip(MESH_AXES[len(shape)], shape))
    print_engine_summary(max(out, key=lambda r: r["wall_s"]),
                         f"engine over mesh {axes}, {backend}, slowest rank")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    add_mesh_flags(ap, "serve")
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
    if args.mesh is not None:
        _main_mesh(args, grid)
        return
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


def _main_mesh(args, grid) -> None:
    shape, devices, mesh = mesh_cli(args)
    if args.engine:
        kw = dict(reduced=args.reduced, requests=args.requests,
                  prompt_len=args.prompt_len, new_tokens=args.new_tokens,
                  seed=args.seed, num_layers=args.num_layers, moe_grid=grid,
                  serve_opts=parse_option_flags(args, SERVE_OPTIONS))
        if mesh is None:
            serve_engine_mesh(args.arch, shape, backend=args.backend,
                              devices=devices, **kw)
            return
        res = engine_summary(serve_engine(args.arch, mesh=mesh, **kw))
        if not ranks_agree(res["tokens"], mesh):
            raise SystemExit("engine over the mesh: the ranks' tokens differ")
        if mesh.rank == 0:
            print_engine_summary(res, f"engine, rank 0 of {len(devices)} "
                                      f"(env://, {args.backend})")
        dist.destroy_process_group()
        return
    kw = dict(reduced=args.reduced, batch=args.batch,
              prompt_len=args.prompt_len, new_tokens=args.new_tokens,
              seed=args.seed, num_layers=args.num_layers, moe_grid=grid)
    if mesh is None:
        serve_mesh(args.arch, shape, backend=args.backend, devices=devices,
                   **kw)
        return
    res = serve(args.arch, mesh=mesh, **kw)
    rows = comm.all_gather(torch.as_tensor(res.tokens, device=mesh.device),
                           res.inputs.plan.dp_axes, axis=0, tiled=True)
    if mesh.rank == 0:
        print(f"rank 0 of {len(devices)} (env://, {args.backend}): prefill "
              f"{res.prefill_s * 1e3:.1f} ms; decode {res.decode_steps} "
              f"steps: {res.decode_s * 1e3:.1f} ms")
        print("generated (first row):", rows[0].tolist())
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
