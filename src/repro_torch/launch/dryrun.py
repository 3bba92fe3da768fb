"""Dry run on the meta device: run the real step once without memory.

The port of ``repro.launch.dryrun``.  For an (arch × input shape ×
production mesh) this:

1. joins a world of 256 ranks (``data 16 × model 16``) or 512 (``pod 2
   × data 16 × model 16``) as rank 0, through PyTorch's fake process
   group (``init_process_group("fake")``: collectives return at once and
   move nothing), and builds the port's mesh on it (``make_mesh``);
2. makes the rank's parameters, optimizer state, batch and caches on the
   meta device (:mod:`repro_torch.launch.inputs`: shapes and dtypes, no
   storage) and runs the REAL step once on them: ``train_step`` (LAMB,
   the JAX dry run's micro-batches of one row), prefill or a decode step,
   by the shape's kind (prefill and decode in the serving form: the
   blocks' weights in the compute dtype, the plain path);
3. counts it as it dispatches (:mod:`repro_torch.launch.cost_analysis`):
   ``dot_flops``, ``traffic_bytes``, the step's live bytes, and every
   collective by class and group, intra-node and inter-node;
4. writes ``experiments/dryrun_torch/<arch>__<shape>__<mesh>[__tag].json``
   with the JAX dry run's keys where they mean the same thing, and
   ``fits``: the step's peak (``argument_bytes``, what the rank holds
   before it, plus ``temp_bytes``, its peak above them) against
   ``--hbm-gib``, by default the H100 80GB HBM3's memory as
   ``torch.cuda.get_device_properties`` reports it on the card.

Meta tensors have no values, so the host reads of the routed path take
the static stand-ins of :mod:`repro_torch.common.meta` (the ragged
exchange's split sizes, the sentinel's verdict).

Usage:
  python -m repro_torch.launch.dryrun --arch deepseek-v3-671b --shape train_4k
  python -m repro_torch.launch.dryrun --arch ... --shape ... --multi-pod
  python -m repro_torch.launch.dryrun --all --jobs 6     # the 10 x 4 x 2 sweep
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.common.config import (INPUT_SHAPES, MOE_DRYRUN_OPTS,
                                       TRAIN_DRYRUN_OPTS, InputShape,
                                       ModelConfig, TrainConfig)
from repro_torch.configs import config_for_shape, supports_shape
from repro_torch.launch import cost_analysis as CA
from repro_torch.launch import inputs as I

# the production meshes: (shape, axes)
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}
# torch.cuda.get_device_properties(0).total_memory of an NVIDIA H100 80GB
# HBM3 (chip_smoke.py phase 23 prints it on the card)
H100_HBM_BYTES = 85017493504
DRYRUN_LOCAL_OPTS = ("rsc", "kvseq", "zero1", "bf16p", "epxpod")
OUT_DIR = "experiments/dryrun_torch"


def fake_world(world: int, rank: int = 0) -> None:
    """This process as ``rank`` of a fake world of ``world`` ranks (a
    world of another size is left first)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_rank() == rank:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


def leave_world() -> None:
    import torch.distributed as dist
    from repro_torch.sharding import comm
    if dist.is_initialized():
        dist.destroy_process_group()
    comm.bind(None)


def dryrun_config(arch: str, shape_name: str, router: Optional[str] = None,
                  opts: str = "", cfg: Optional[ModelConfig] = None
                  ) -> Tuple[ModelConfig, set]:
    """The config a dry run lowers and its ``--opt`` tokens: the shape's
    config (or ``cfg``), the router swapped, then the tokens applied (the
    MoE ones derived from the options registry, each with its
    prerequisites; contradictory tokens raise)."""
    if cfg is None:
        cfg = config_for_shape(arch, INPUT_SHAPES[shape_name])
    if router is not None and cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, router=router))
    opt_set = set(o for o in opts.split(",") if o)
    unknown = opt_set - set(DRYRUN_LOCAL_OPTS) - set(MOE_DRYRUN_OPTS) - set(
        TRAIN_DRYRUN_OPTS)
    if unknown:
        raise ValueError(f"unknown --opt tokens {sorted(unknown)}")
    if "rsc" in opt_set:
        cfg = cfg.replace(remat_save_collectives=True)
    if "kvseq" in opt_set:
        cfg = cfg.replace(kv_seq_shard=True)
    moe_kw, moe_src = {}, {}
    for tok in sorted(opt_set & MOE_DRYRUN_OPTS.keys()):
        for fld, val in MOE_DRYRUN_OPTS[tok].items():
            if fld in moe_kw and moe_kw[fld] != val:
                raise ValueError(
                    f"--opt tokens {moe_src[fld]!r} and {tok!r} disagree "
                    f"on {fld} ({moe_kw[fld]!r} vs {val!r})")
            moe_kw[fld] = val
            moe_src.setdefault(fld, tok)
    if moe_kw and cfg.moe is not None:
        from repro_torch.configs import with_options
        cfg = with_options(cfg, **moe_kw)
    return cfg, opt_set


def run_step(arch: str, shape_name: str, *, multi_pod: bool = False,
             router: Optional[str] = None, opts: str = "",
             mesh_shape: Optional[Sequence[int]] = None,
             mesh_axes: Optional[Sequence[str]] = None,
             cfg: Optional[ModelConfig] = None,
             shape: Optional[InputShape] = None, micro_batch: int = 1,
             micro_steps: Optional[int] = None,
             cache_len: Optional[int] = None,
             collect_every: int = CA.GC_EVERY) -> Dict:
    """Build the rank's inputs on meta and run the step once under the
    cost counts; returns the counts (no file).

    ``mesh_shape`` / ``mesh_axes`` replace the production mesh (``()``:
    one device, no world), ``cfg`` the arch's config (the ``--opt``
    tokens still applied), ``shape`` the named input shape and
    ``cache_len`` its cache length.  A train step splits a rank's rows
    into micro-batches of ``micro_batch`` rows (0: one pass).  With
    ``micro_steps`` (fewer than the step's micro-batches) the step runs
    that many, which give the same ops each, and the counts of its
    forward and backward are scaled to the step's micro-batches (the
    memory peak is a micro-batch's whatever their number); the result
    says so (``micro_batches``, ``micro_batches_run``).
    ``collect_every`` is :class:`~repro_torch.launch.cost_analysis.
    CostMode`'s."""
    from repro_torch.sharding import comm
    from repro_torch.sharding.plan import plan_from_mesh, single_device_plan
    shape = shape or INPUT_SHAPES[shape_name]
    cfg, opt_set = dryrun_config(arch, shape_name, router, opts, cfg)
    if mesh_shape is None:
        mesh_shape, mesh_axes = PRODUCTION[multi_pod]
    mesh_shape, mesh_axes = tuple(mesh_shape), tuple(mesh_axes or ())
    mesh = None
    if mesh_shape:
        from repro_torch.launch.mesh import make_mesh
        fake_world(math.prod(mesh_shape))
        mesh = make_mesh(mesh_shape, mesh_axes, device="meta")
        inter = ("pod", "data") if "epxpod" in opt_set else None
        plan = plan_from_mesh(mesh, smile_inter_axes=inter)
    else:
        plan = single_device_plan()
    pdtype = torch.bfloat16 if "bf16p" in opt_set else None
    train = shape.kind == "train"
    t0 = time.perf_counter()
    params, _ = I.params_struct(cfg, plan, mesh, dtype=pdtype,
                                compute_cast=not train)
    args: Dict[str, object] = {"params": params}
    n_micro = run_micro = 1
    if train:
        from repro_torch.optim import make_optimizer, make_schedule
        from repro_torch.train.step import build_train_step
        train_kw = {}
        for tok in sorted(opt_set & TRAIN_DRYRUN_OPTS.keys()):
            train_kw.update(TRAIN_DRYRUN_OPTS[tok])
        sentinel = bool(train_kw.get("sentinel", False))
        zero1 = "zero1" in opt_set
        batch, bspec = I.train_batch_struct(cfg, shape, plan)
        rows = I.rank_batch(shape.global_batch, plan)
        n_micro = max(1, rows // micro_batch) if micro_batch else 1
        run_micro = min(micro_steps or n_micro, n_micro)
        tcfg = TrainConfig(global_batch_size=shape.global_batch,
                           seq_len=shape.seq_len,
                           micro_batch_size=micro_batch,
                           optimizer="lamb", sentinel=sentinel)
        batch_bytes = I.tree_bytes(I.local(batch, bspec, plan))
        if run_micro < n_micro:
            # the rows of run_micro micro-batches a rank
            keep = shape.global_batch * run_micro // n_micro
            batch = {k: torch.empty((keep,) + tuple(v.shape[1:]),
                                    dtype=v.dtype, device=I.META)
                     for k, v in batch.items()}
        opt_state = I.opt_state_struct(params, cfg, plan, zero1=zero1)
        step = build_train_step(cfg, tcfg, plan, make_optimizer("lamb"),
                                make_schedule("cosine", 3e-4, 100, 10000),
                                params, batch, mesh=mesh, zero1=zero1,
                                sentinel=sentinel)
        call = [params, opt_state, batch, 1]
        if sentinel:
            from repro_torch.train.sentinel import init_sentinel_state
            call.append(init_sentinel_state(I.META))
        args.update(opt_state=opt_state, extra=call[4:])

        def run():
            return step(*call)
    else:
        from repro_torch.models.transformer import init_caches
        from repro_torch.serve.decode import decode_step_fn, prefill_fn
        B = shape.global_batch
        L = cache_len or I.cache_length(cfg, shape)
        caches = init_caches(cfg, I.rank_batch(B, plan), L, plan,
                             device=I.META)
        if shape.kind == "prefill":
            toks, tspec = I.prefill_batch_struct(cfg, shape, plan)

            def run():
                with torch.no_grad():
                    return prefill_fn(params, toks, caches, cfg=cfg,
                                      plan=plan, use_kernel=False)
        else:
            (toks, _, _), (tspec, _) = I.decode_state_struct(cfg, shape,
                                                             plan)

            def run():
                with torch.no_grad():
                    return decode_step_fn(params, toks, caches, L - 1,
                                          cfg=cfg, plan=plan,
                                          use_kernel=False)
        toks = I.local(toks, tspec, plan)
        args.update(caches=caches)
        batch_bytes = I.tree_bytes(toks)
    t_build = time.perf_counter() - t0
    arg_bytes = I.tree_bytes(args) + batch_bytes
    log = comm.TraceLog()
    inner = {}
    t0 = time.perf_counter()
    with CA.CostMode(exclude=list(_tensors(args)),
                     collect_every=collect_every) as cm, \
            comm.tracing(log), _count_inner(cm, log, inner):
        out = run()
    t_step = time.perf_counter() - t0
    out_bytes = cm.live_bytes
    del out
    # the forward and backward of the micro-batches not run
    f = n_micro / run_micro - 1.0
    dot = cm.dot_flops + f * inner.get("dot_flops", 0.0)
    traffic = cm.traffic_bytes + f * inner.get("traffic_bytes", 0.0)
    ops = cm.ops + f * inner.get("ops", 0)
    costs = []
    if mesh is not None:
        costs = CA.collective_costs(log.calls, mesh_shape, mesh_axes,
                                    mesh.rank)
        lo, hi = inner.get("calls", (0, 0))
        scale = [1.0 + f if lo <= i < hi else 1.0
                 for i, c in enumerate(log.calls)
                 if CA.op_class(c.op) is not None
                 and all(a in mesh_axes for a in c.axes)]
        for c, k in zip(costs, scale):
            c.count = k
    return {"cfg": cfg, "mesh": mesh, "opts": sorted(opt_set),
            "dot_flops": dot, "traffic_bytes": traffic, "ops": ops,
            "argument_bytes": arg_bytes, "temp_bytes": cm.peak_bytes,
            "output_bytes": out_bytes, "collectives": costs,
            "trace": log.calls, "micro_batches": n_micro,
            "micro_batches_run": run_micro, "build_s": t_build,
            "step_s": t_step}


@contextlib.contextmanager
def _count_inner(cm, log, inner: dict):
    """Keep in ``inner`` the counts of the train step's forward and
    backward over its micro-batches (``train.step._loss_backward``)."""
    from repro_torch.train import step as ST
    orig = ST._loss_backward

    def counted(*a, **k):
        before = (cm.dot_flops, cm.traffic_bytes, cm.ops, len(log.calls))
        out = orig(*a, **k)
        inner.update(dot_flops=cm.dot_flops - before[0],
                     traffic_bytes=cm.traffic_bytes - before[1],
                     ops=cm.ops - before[2],
                     calls=(before[3], len(log.calls)))
        return out
    ST._loss_backward = counted
    try:
        yield inner
    finally:
        ST._loss_backward = orig


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def mesh_name(shape: Sequence[int]) -> str:
    return "x".join(str(n) for n in shape)


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            out_dir: str = OUT_DIR, router: Optional[str] = None,
            tag: str = "", opts: str = "",
            hbm_bytes: float = H100_HBM_BYTES,
            micro_steps: Optional[int] = None) -> Dict:
    """:func:`run_step`, then its JSON under ``out_dir``."""
    shape = INPUT_SHAPES[shape_name]
    if not supports_shape(arch, shape):
        return {"skipped": True}
    r = run_step(arch, shape_name, multi_pod=multi_pod, router=router,
                 opts=opts, micro_steps=micro_steps)
    cfg, mesh = r["cfg"], r["mesh"]
    summary = CA.collective_summary(r["collectives"])
    peak = r["argument_bytes"] + r["temp_bytes"]
    res = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name(mesh.shape),
        "router": cfg.moe.router if cfg.moe else None, "opts": r["opts"],
        "rank": mesh.rank, "world": math.prod(mesh.shape),
        "flops": r["dot_flops"], "dot_flops": r["dot_flops"],
        "bytes_accessed": r["traffic_bytes"],
        "traffic_bytes": r["traffic_bytes"], "ops": r["ops"],
        "memory": {"argument_bytes": r["argument_bytes"],
                   "output_bytes": r["output_bytes"],
                   "temp_bytes": r["temp_bytes"], "peak_bytes": peak},
        "hbm_bytes": hbm_bytes, "fits": peak <= hbm_bytes,
        "collectives": summary,
        "collectives_by_group": CA.by_group(r["collectives"]),
        "micro_batches": r["micro_batches"],
        "micro_batches_run": r["micro_batches_run"],
        "build_s": r["build_s"], "step_s": r["step_s"],
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    }
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    fn = os.path.join(out_dir, f"{arch}__{shape_name}__"
                      f"{'multi' if multi_pod else 'single'}{suffix}.json")
    with open(fn, "w") as f:
        json.dump(res, f, indent=1)
    a2a = summary["bytes_per_op"]["all-to-all"]
    print(f"[dryrun] {arch} {shape_name} {res['mesh']}{suffix}: "
          f"dot_flops={res['dot_flops']:.3e} a2a_bytes={a2a:.3e} "
          f"(to peers on the node {summary['intra_node_peer_bytes']['all-to-all']:.3e}, "
          f"off it {summary['inter_node_peer_bytes']['all-to-all']:.3e}) "
          f"peak={peak / 2**30:.2f} GiB fits={res['fits']} "
          f"step={r['step_s']:.1f}s -> {fn}", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun",
        description="run the real step once on the meta device over a "
                    "fake production mesh; memory, costs, collectives")
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--router", choices=["smile", "switch"], default=None,
                    help="override the MoE router (baseline comparisons)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--opt", default="",
                    help="comma list: rsc,kvseq,zero1,bf16p,epxpod + the "
                         "registry-derived MoE tokens "
                         f"({','.join(sorted(MOE_DRYRUN_OPTS))}) + train "
                         f"tokens ({','.join(sorted(TRAIN_DRYRUN_OPTS))})")
    ap.add_argument("--hbm-gib", type=float, default=H100_HBM_BYTES / 2**30,
                    help="device memory the peak must fit (default: the "
                         "H100 80GB HBM3's)")
    ap.add_argument("--micro-steps", type=int, default=None,
                    help="run this many of a train step's micro-batches "
                         "and scale their counts to all of them (default: "
                         "run all)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    if not args.all:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape (or --all)")
        run_one(args.arch, args.shape, multi_pod=args.multi_pod,
                out_dir=args.out, router=args.router, tag=args.tag,
                opts=args.opt, hbm_bytes=args.hbm_gib * 2**30,
                micro_steps=args.micro_steps)
        leave_world()
        return 0

    # the full sweep, a subprocess each (a fresh fake world)
    from repro_torch.configs import ASSIGNED
    jobs = []
    for arch in ASSIGNED:
        for shape in INPUT_SHAPES:
            for mp in (False, True):
                fn = os.path.join(args.out, f"{arch}__{shape}__"
                                  f"{'multi' if mp else 'single'}.json")
                if args.skip_existing and os.path.exists(fn):
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--out", args.out,
                       "--hbm-gib", str(args.hbm_gib)]
                if mp:
                    cmd.append("--multi-pod")
                jobs.append((arch, shape, mp, cmd))
    running: List = []
    fails = []
    while jobs or running:
        while jobs and len(running) < args.jobs:
            arch, shape, mp, cmd = jobs.pop(0)
            p = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
            running.append((arch, shape, mp, p))
        time.sleep(1)
        still = []
        for arch, shape, mp, p in running:
            if p.poll() is None:
                still.append((arch, shape, mp, p))
                continue
            out = p.stdout.read()
            if p.returncode != 0:
                fails.append((arch, shape, mp))
                print(f"FAIL {arch} {shape} mp={mp}:\n{out[-2000:]}")
            elif out.strip():
                print(out.strip().splitlines()[-1])
        running = still
    print(f"\n{len(fails)} failures: {fails}")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
