"""Training entry point: the port of ``repro.launch.train``.

Runs real optimization steps on the card (``--device cpu`` for the CPU)::

  PYTHONPATH=src python -m repro_torch.launch.train --arch smile-3.7b \
      --steps 3 --router-impl fused --sort-impl radix --moe-grid 16,8

The MoE option flags (``--router-impl``, ``--sort-impl``, ...) are derived
from the port's copy of ``MOE_OPTIONS``, as in the JAX package.
``--moe-grid N,M`` sets the logical expert grid: on one device a SMILE
config's ``grid=(0, 0)`` folds to ``(1, 1)``, where the node router has a
single column.  ``--num-layers`` cuts the depth.

The robust runtime, as the JAX package's: ``--zero1`` shards LAMB's
moments over each leaf's replicated axes; ``--sentinel`` skips a step
whose loss or gradients are not finite, or whose loss spikes;
``--ckpt-dir DIR --ckpt-every N --ckpt-keep K`` keeps a checksummed
keep-last-K rotation of snapshots, ``--resume`` restores the newest valid
one (falling back past corrupt ones) and replays the data stream from
there, bit-identical to an uninterrupted run; ``--ckpt PATH`` writes a
final snapshot.  On the CPU::

  PYTHONPATH=src python -m repro_torch.launch.train --arch smile-3.7b \
      --reduced --steps 4 --batch 4 --seq 32 --device cpu --sentinel \
      --ckpt-dir run --ckpt-every 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch smile-3.7b \
      --reduced --steps 6 --batch 4 --seq 32 --device cpu --sentinel \
      --ckpt-dir run --ckpt-every 2 --resume

Over a mesh of ranks (data, expert and tensor parallel, as the JAX
package's ``train(..., mesh=...)``): ``--mesh 2,2`` (axes ``data, model``;
three numbers add ``pod`` in front) spawns one process a rank, with the
backend and the ranks' devices given explicitly, e.g. on the CPU or four
ranks sharing one card over gloo::

  PYTHONPATH=src python -m repro_torch.launch.train --arch smile-3.7b \
      --reduced --steps 2 --batch 8 --seq 32 --mesh 2,2 --backend gloo \
      --devices cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch smile-3.7b \
      --num-layers 6 --moe-grid 16,8 --router-impl fused --sort-impl radix \
      --mesh 2,2 --backend gloo --devices cuda:0

(``--backend nccl`` needs a card a rank).  Under ``torchrun`` add
``--launcher env``: each process is then one rank, initialized from
``env://``.  ``--batch`` is the global batch, split over the dp axes.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.common.config import (MOE_OPTIONS, TRAIN_OPTIONS,
                                       ModelConfig, TrainConfig)
from repro_torch.common.device import resolve_device
from repro_torch.configs import get_config, get_reduced, with_options
from repro_torch.data.pipeline import DataPipeline
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import (MESH_AXES, add_mesh_flags, make_mesh,
                                     mesh_cli, spawn)
from repro_torch.models.transformer import init_model
from repro_torch.optim import make_optimizer, make_schedule
from repro_torch.sharding.plan import plan_from_mesh, single_device_plan
from repro_torch.train.checkpoint import CheckpointManager, save_checkpoint
from repro_torch.train.sentinel import FIELDS as SENTINEL_FIELDS
from repro_torch.train.sentinel import init_sentinel_state
from repro_torch.train.step import build_train_step, zero1_state

_UNSET = object()       # float-flag default (argparse type-converts string
                        # defaults, so "" cannot be the sentinel there)


def _float_or_off(v: str):
    """argparse type for float options: a number, or off/none -> None."""
    if v in ("off", "none"):
        return None
    return float(v)


def add_option_flags(ap, options) -> None:
    """Add one CLI flag per registry entry (generic over option kinds):
    empty / unset keeps the config's setting; bools take ``on``/``off``;
    floats a number or ``off``; ints and strings pass through."""
    for opt in options:
        if opt.kind == "choice":
            ap.add_argument(opt.flag, default="",
                            choices=("",) + opt.choices, help=opt.help)
        elif opt.kind == "bool":
            ap.add_argument(opt.flag, default="", nargs="?", const="on",
                            choices=("", "on", "off"), help=opt.help)
        elif opt.kind == "float":
            ap.add_argument(opt.flag, default=_UNSET, type=_float_or_off,
                            help=opt.help + " (number, or 'off' for None)")
        elif opt.kind == "int":
            ap.add_argument(opt.flag, default=_UNSET, type=int,
                            help=opt.help)
        else:  # "str"
            ap.add_argument(opt.flag, default="", help=opt.help)


def parse_option_flags(args, options) -> dict:
    """The registry-derived flags the user set, as ``{field: value}``."""
    opts = {}
    for opt in options:
        v = getattr(args, opt.field)
        if v is _UNSET or v == "":
            continue
        opts[opt.field] = (v == "on") if opt.kind == "bool" else v
    return opts


def cut_depth(cfg: ModelConfig, num_layers: int) -> ModelConfig:
    """``cfg`` with ``num_layers`` layers; a MoE config keeps at most that
    many leading dense layers (deepseek-v3's three, cut to one, is a
    dense layer alone and an empty MoE stage)."""
    cfg = cfg.replace(num_layers=num_layers)
    if cfg.moe is not None and cfg.moe.first_dense_layers > num_layers:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, first_dense_layers=num_layers))
    return cfg


def train_config(arch: str, *, reduced: bool = True,
                 moe_options: Optional[dict] = None,
                 moe_grid: Optional[Tuple[int, int]] = None,
                 num_layers: Optional[int] = None) -> ModelConfig:
    """The config :func:`train` runs: the arch's config (or its reduced
    variant) with the MoE options, the logical expert grid and the depth
    (:func:`cut_depth`) optionally set."""
    cfg = get_reduced(arch) if reduced else get_config(arch)
    if moe_options:
        cfg = with_options(cfg, **moe_options)
    if moe_grid is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  grid=tuple(moe_grid)))
    if num_layers is not None:
        cfg = cut_depth(cfg, num_layers)
    return cfg


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(arch: str, *, reduced: bool = True, steps: int = 50,
          batch: int = 16, seq: int = 128, lr: float = 3e-4,
          optimizer: str = "lamb", seed: int = 0, log_every: int = 10,
          ckpt: str = "", mesh=None, micro_batch: int = 0,
          log_file: str = "", zero1: bool = False, eval_every: int = 0,
          moe_options: Optional[dict] = None, sentinel: bool = False,
          resume: bool = False, ckpt_every: int = 0, ckpt_keep: int = 3,
          ckpt_dir: str = "", halt_after: int = 0,
          moe_grid: Optional[Tuple[int, int]] = None,
          num_layers: Optional[int] = None, device="cuda",
          on_step: Optional[Callable[[int], None]] = None):
    """Run (or resume) a training run from random weights (seed ``seed``)
    on the synthetic stream.  Returns ``(params, history)``.

    Each logged step's history entry holds the step's metrics, the
    cumulative ``tokens_per_s`` (as the JAX package), and, over the steps
    since the previous entry, ``step_ms`` (wall time per step, measured to
    a device sync, checkpoint writes left out) and ``launches`` (kernel
    launches per step).  ``on_step(step)``, where given, is called after
    each step and its log entry (to start or stop a profiler between
    steps, for instance).

    The robust runtime, as the reference's: ``zero1`` shards LAMB's
    moments over each leaf's replicated axes; ``sentinel`` skips a bad
    step's update (the sentinel's counters end the history); ``ckpt_dir``
    with ``ckpt_every`` keeps a ``ckpt_keep``-deep checksummed rotation,
    and a skipped step saves a snapshot too; ``resume`` restores the
    newest valid snapshot of ``ckpt_dir`` (corrupt ones fall back) and
    skips the data stream's draws the restored steps consumed, so the run
    is bit-identical to an uninterrupted one; ``halt_after`` stops after
    that many steps, keeping the ``steps`` schedule's horizon (a crash,
    for the resume tests); ``ckpt`` writes a final snapshot.  Where
    snapshots were written or read, an entry ``{"checkpoints": {"saves",
    "restored"}}`` (bytes and seconds) comes before the sentinel's.

    With ``mesh`` (:func:`repro_torch.launch.mesh.make_mesh`; the rank's
    device is the mesh's) every rank of the mesh calls this: the plan is
    ``plan_from_mesh(mesh)``, the parameters are the rank's slices of the
    ones a single device draws, ``batch`` is the global batch (each rank
    trains on its dp rows), and only rank 0 prints.  Each logged entry
    also holds ``wire``, the last step's collectives (``comm.WireLog``,
    emptied as each step starts; its ``timed`` flag, which ``on_step`` may
    set, times them).
    """
    if resume and not ckpt_dir:
        raise ValueError("--resume needs --ckpt-dir (the rotation to resume "
                         "from)")
    cfg = train_config(arch, reduced=reduced, moe_options=moe_options,
                       moe_grid=moe_grid, num_layers=num_layers)
    if mesh is None:
        device = resolve_device(device)
        plan = single_device_plan()
    else:
        device, plan = mesh.device, plan_from_mesh(mesh)
    # a fault plan or a checked wire: the log line carries the MoE layers'
    # fault events and wire verdicts
    faulted = cfg.moe is not None and (cfg.moe.fault_plan is not None
                                       or cfg.moe.wire_integrity != "off")
    loud = mesh is None or mesh.rank == 0
    say = print if loud else (lambda *a: None)
    tcfg = TrainConfig(global_batch_size=batch, seq_len=seq, steps=steps,
                       optimizer=optimizer, lr=lr,
                       warmup_steps=max(steps // 10, 1),
                       micro_batch_size=micro_batch, seed=seed,
                       sentinel=sentinel, ckpt_every=ckpt_every,
                       ckpt_keep=ckpt_keep, ckpt_dir=ckpt_dir)
    params = init_model(cfg, plan, seed=seed, device=device,
                        compute_cast=False, mesh=mesh)
    opt = make_optimizer(optimizer)
    sched = make_schedule("cosine", lr, tcfg.warmup_steps, steps)
    opt_state = (zero1_state(params, cfg, plan) if zero1
                 else opt.init(params))
    sent = init_sentinel_state(device) if sentinel else None

    mgr = (CheckpointManager(ckpt_dir, keep=ckpt_keep, cfg=cfg, mesh=mesh)
           if ckpt_dir else None)
    start = 0
    if resume:
        got = mgr.restore_latest(params, opt_state, extra_like=sent, log=say)
        if got is not None:
            opt_state, start = got[1], got[2]
            say(f"resumed from step {start} ({mgr.dir})")
        else:
            say(f"no valid checkpoint in {mgr.dir} — starting fresh")

    pipe = DataPipeline(cfg, batch, seq, seed=seed)
    batch0 = next(pipe)                          # draw 0 (step 1's batch)
    # the stream is deterministic in (seed, draw): skip the draws the
    # restored steps consumed, so step S + 1 sees its own batch
    for _ in range(max(start - 1, 0)):
        next(pipe)
    step_fn = build_train_step(cfg, tcfg, plan, opt, sched, params, batch0,
                               mesh=mesh, zero1=zero1, sentinel=sentinel)

    def save(step):
        nonlocal t0, t_last
        t = time.perf_counter()
        mgr.save(step, params, opt_state, extra=sent)
        t0 += time.perf_counter() - t       # a write is not a step's time
        t_last += time.perf_counter() - t

    history = []
    until = min(steps, halt_after + start) if halt_after else steps
    _sync(device)
    t0 = t_last = time.perf_counter()
    c_last, i_last = kops.launch_counts(), start
    for i in range(start, until):
        b = batch0 if i == 0 else next(pipe)
        if mesh is not None:
            mesh.wire.reset()
        if sentinel:
            params, opt_state, m, sent = step_fn(params, opt_state, b, i + 1,
                                                 sent)
            anomaly = float(m["skip"]) > 0
        else:
            params, opt_state, m = step_fn(params, opt_state, b, i + 1)
            anomaly = False
        if (i + 1) % log_every == 0 or i == start:
            m = {k: float(v) for k, v in m.items()}     # syncs the device
            _sync(device)
            now, counts = time.perf_counter(), kops.launch_counts()
            n = i + 1 - i_last
            toks = batch * seq * (i + 1 - start)
            m.update(tokens_per_s=toks / (now - t0),
                     step_ms=(now - t_last) * 1e3 / n,
                     launches={k: (counts[k] - c_last[k]) / n
                               for k in counts})
            if mesh is not None:
                m["wire"] = mesh.wire.summary()
            say(f"step {i+1:5d} loss {m['loss']:.4f} ce {m['ce']:.4f} "
                f"lb {m['lb']:.4f} drop {m['drop_frac']:.3f} "
                f"gnorm {m['grad_norm']:.2f} {m['step_ms']:.1f} ms/step "
                f"tok/s {m['tokens_per_s']:,.0f}"
                + (f" skip {m['skip']:.0f}" if sentinel else "")
                + (f" faults {m['fault_events']:g} wire {m['wire_faults']:g}"
                   if faulted else ""))
            history.append({"step": i + 1, **m})
            t_last, c_last, i_last = now, counts, i + 1
        if anomaly and mgr is not None:
            # the skipped step left the state bit-unchanged: this snapshot
            # is the last good state, taken while it is still current
            save(i + 1)
            say(f"step {i+1}: anomaly (update skipped) — snapshot saved")
        elif mgr is not None and ckpt_every and (i + 1) % ckpt_every == 0:
            save(i + 1)
        if eval_every and (i + 1) % eval_every == 0:
            from repro_torch.train.evaluate import evaluate
            ev = evaluate(params, cfg, plan, batch=batch, seq=seq, seed=seed,
                          n_batches=2)
            say(f"  eval ce {ev['eval_ce']:.4f} ppl {ev['eval_ppl']:.1f}")
            history.append({"step": i + 1, **ev})
        if on_step is not None:
            on_step(i + 1)
    pipe.close()
    if ckpt:
        save_checkpoint(ckpt, params, opt_state, until, extra=sent, cfg=cfg,
                        mesh=mesh)
        say(f"saved checkpoint -> {ckpt}")
    if mgr is not None and (mgr.saves or mgr.restored):
        history.append({"checkpoints": {"saves": mgr.saves,
                                        "restored": mgr.restored}})
    if sentinel:
        history.append({"sentinel": {
            k: float(getattr(sent, k)) for k in SENTINEL_FIELDS
            if k not in ("loss_ema", "ema_steps")}})
    if log_file and loud:
        with open(log_file, "w") as f:
            json.dump(history, f, indent=1)
    return params, history


def _train_rank(rank, shape, kw) -> dict:
    """One rank of :func:`train_mesh` (a :class:`RankPool` task)."""
    mesh = make_mesh(shape, MESH_AXES[len(shape)], device=rank.device)
    if mesh.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(mesh.device)
    _, history = train(mesh=mesh, **kw)
    peak = (torch.cuda.max_memory_allocated(mesh.device)
            if mesh.device.type == "cuda" else None)
    return {"history": history, "rank": mesh.rank, "peak_bytes": peak}


def train_mesh(arch: str, shape: Tuple[int, ...], *, backend: str,
               devices, threads: Optional[int] = None,
               timeout_s: float = 600.0, **kw) -> Tuple[List[dict],
                                                        List[dict]]:
    """:func:`train` (``kw``) over a mesh of ``shape`` (axes
    ``MESH_AXES``): one process a rank (:func:`repro_torch.launch.mesh.
    spawn`) under ``backend`` on ``devices[rank]``.  Returns ``(history,
    results)``: rank 0's history, each entry with ``step_ms_max``, the
    slowest rank's ``step_ms``, and each rank's result (its ``history``
    and ``peak_bytes``, the card's peak allocation where it runs on
    one)."""
    world = int(np.prod(shape))
    out = spawn(_train_rank, world, backend=backend, devices=devices,
                args=(tuple(shape), dict(arch=arch, **kw)), threads=threads,
                timeout_s=timeout_s)
    history = [dict(h) for h in out[0]["history"]]
    for j, h in enumerate(history):
        if "step_ms" in h:
            h["step_ms_max"] = max(r["history"][j]["step_ms"] for r in out)
    last = [h for h in history if "step_ms_max" in h][-1]
    print(f"mesh {dict(zip(MESH_AXES[len(shape)], shape))}, {backend}: "
          f"step {last['step']} loss {last['loss']:.4f} "
          f"{last['step_ms_max']:.1f} ms/step on the slowest rank")
    return history, out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="lamb")
    ap.add_argument("--micro-batch", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--log-file", default="")
    ap.add_argument("--zero1", action="store_true",
                    help="shard optimizer state over replicated axes")
    ap.add_argument("--eval-every", type=int, default=0)
    ap.add_argument("--moe-grid", default=None,
                    help="logical expert grid 'N,M' (e.g. 16,8)")
    ap.add_argument("--num-layers", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    add_mesh_flags(ap, "train")
    add_option_flags(ap, MOE_OPTIONS)
    add_option_flags(ap, TRAIN_OPTIONS)
    args = ap.parse_args()
    grid = (None if args.moe_grid is None
            else tuple(int(v) for v in args.moe_grid.split(",")))
    kw = dict(reduced=args.reduced, steps=args.steps, batch=args.batch,
              seq=args.seq, lr=args.lr, optimizer=args.optimizer,
              seed=args.seed, log_every=args.log_every, ckpt=args.ckpt,
              micro_batch=args.micro_batch, log_file=args.log_file,
              zero1=args.zero1, eval_every=args.eval_every,
              moe_options=parse_option_flags(args, MOE_OPTIONS),
              moe_grid=grid, num_layers=args.num_layers,
              **parse_option_flags(args, TRAIN_OPTIONS))
    if args.mesh is None:
        train(args.arch, device=args.device, **kw)
        return
    shape, devices, mesh = mesh_cli(args)
    if mesh is None:
        train_mesh(args.arch, shape, backend=args.backend, devices=devices,
                   **kw)
        return
    train(args.arch, mesh=mesh, **kw)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
