"""A training cell: the port's ``build_train_step`` over the MLM stream.

Set-up builds the one step object with its model and LAMB state from the
seed and drives it through its first steps, on the window's own call and
feed.  Those steps are what the reference follows: each step's loss, each
leaf's first clipped gradient as LAMB holds it after one step (its first
moment over ``1 - b1``), and each leaf's change after the last of them,
before the window's first step moves the weights again.  The window then
runs steps until ``seconds`` have passed; its rate is all the tokens of all
its steps over the time from its start to the device's end of the last.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List

import torch
from torch.profiler import record_function

from bench.core import traffic as TR
from bench.core import weights as W
from bench.core.spec import Cell

FIRST_STEPS = 3


def port_config(doc: Dict):
    from repro_torch.common.config import ModelConfig, MoEConfig
    moe = dict(doc["moe"])
    moe["grid"] = tuple(moe["grid"])
    return ModelConfig(**doc["model"], moe=MoEConfig(**moe))


def _program_first_grads(tree, drawn, opt_state, b1) -> Dict[str, float]:
    """Each group's norm of the first clipped gradient, from LAMB's first
    moment after one step (``m = (1 - b1) g``)."""
    from repro_torch.optim.optimizers import leaf_groups
    where = {}
    for gi, g in enumerate(leaf_groups(tree)):
        for pi, p in enumerate(g.pieces):
            where[id(p)] = (gi, pi)
    sq: Dict[str, float] = {}
    for leaf, t in drawn:
        gi, pi = where[id(t)]
        m = opt_state["m"][gi][pi]
        sq[leaf.group] = sq.get(leaf.group, 0.0) + float(
            m.float().square().sum())
    return {k: math.sqrt(v) / (1 - b1) for k, v in sq.items()}


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        clock) -> Dict:
    from repro_torch.common.config import TrainConfig
    from repro_torch.optim import make_optimizer, make_schedule
    from repro_torch.sharding.plan import single_device_plan
    from repro_torch.train import step as ST
    from bench.core import trace as TRC
    from bench.reference import train as REF

    doc, mix = cell.config, cell.load
    t = doc["train"]
    vocab = doc["model"]["vocab_size"]
    cfg = port_config(doc)
    batch, seq = mix["batch"], mix["seq"]
    micro = int(mix.get("micro_batch_size", 0))
    n_micro = batch // micro if micro else 1
    tcfg = TrainConfig(global_batch_size=batch, micro_batch_size=micro,
                       seq_len=seq, optimizer=t["optimizer"], lr=t["lr"],
                       warmup_steps=0, weight_decay=t["weight_decay"],
                       grad_clip=t["grad_clip"], eps=t["eps"], b1=t["b1"],
                       b2=t["b2"], schedule=t["schedule"],
                       mlm_mask_prob=t["mlm_mask_prob"], seed=seed)
    plan = single_device_plan()

    def feed(i):
        return TR.mlm_batch(mix, vocab, t["mlm_mask_prob"], seed, i)

    tree, drawn = W.make(doc, seed, device, torch.float32)
    opt = make_optimizer(t["optimizer"], weight_decay=t["weight_decay"],
                         b1=t["b1"], b2=t["b2"], eps=t["eps"])
    schedule = make_schedule(t["schedule"], t["lr"], 0, 1 << 30)
    step_fn = ST.build_train_step(cfg, tcfg, plan, opt, schedule, tree,
                                  feed(0))
    opt_state = opt.init(tree)

    # ---- the first steps, through the window's own call and feed
    losses, first_grads, first_batches = [], {}, []
    step = 0
    for step in range(FIRST_STEPS):
        b = feed(step)
        first_batches.append(b)
        tree, opt_state, met = step_fn(tree, opt_state, b, step)
        losses.append(float(met["loss"]))
        if step == 0:
            first_grads = _program_first_grads(tree, drawn, opt_state,
                                               t["b1"])
    change = W.change_norms(drawn, seed, device)
    program = {"loss": losses, "grad": first_grads, "change": change}
    if device.type == "cuda":
        torch.cuda.synchronize()

    # ---- the window
    setup_s = clock()
    t0 = time.monotonic()
    done, step_losses = 0, []
    traced = None
    trace_at = t0 + seconds / 3
    n_trace = int(mix.get("trace_steps", 2))
    step = FIRST_STEPS
    while time.monotonic() - t0 < seconds:
        if trace and traced is None and time.monotonic() >= trace_at:
            with TRC.Window(torch) as w:
                for _ in range(n_trace):
                    with record_function("bench.train_step"):
                        tree, opt_state, met = step_fn(tree, opt_state,
                                                       feed(step), step)
                    step_losses.append(met["loss"])
                    step += 1
                    done += 1
            traced = w
            continue
        tree, opt_state, met = step_fn(tree, opt_state, feed(step), step)
        step_losses.append(met["loss"])
        step += 1
        done += 1
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    bad = int((~torch.isfinite(torch.stack(step_losses))).sum()) \
        if step_losses else 0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    if traced is not None:
        traced = traced.collect()

    # ---- free the program's state, then the reference
    del step_fn, opt_state, tree, drawn, met, step_losses
    _free(device)
    batches = [{k: torch.as_tensor(v, device=device) for k, v in b.items()}
               for b in first_batches]
    ref = REF.follow(doc, seed, batches, n_micro, device)
    return {
        "setup_s": setup_s, "wall_s": wall,
        "tokens": done * batch * seq, "steps": done, "failed": bad,
        "peak": peak, "program": program, "reference": ref,
        "trace": traced, "traced_steps": n_trace if traced else 0,
        "batch": batch, "seq": seq, "n_micro": n_micro,
        "first_batches": batches,
    }


def end_to_end(run: Dict) -> Dict[str, float]:
    """All the tokens of all the window's steps over the window."""
    return {"setup_s": run["setup_s"],
            "train_tokens_per_s": run["tokens"] / run["wall_s"]}


def checks(run: Dict) -> Dict[str, float]:
    from bench.core import compare as CMP
    return CMP.train_gaps(run["program"], run["reference"])


def readings(cell: Cell, seed: int, seconds: float, device,
             control: bool) -> List[Dict]:
    """What the limits are set from: the first steps of one run as
    ``run`` makes them (no window: those steps are what is compared),
    against the reference; with ``control``, the
    reference put in the program's place at fp8 and with the fault of
    half of each batch left out, each against the fp32 reference."""
    from bench.core import compare as CMP
    from bench.reference import train as REF
    r = run(cell, seed, 0.0, False, device, lambda: 0.0)
    out = [{"who": "program", **CMP.train_gaps(r["program"], r["reference"]),
            **CMP.details(r["program"], r["reference"])}]
    if not control:
        return out
    ref = r["reference"]
    for who, kw in (("control:fp8", {"quant": "fp8"}),
                    ("fault:half_batch", {"half_batch": True})):
        other = REF.follow(cell.config, seed, r["first_batches"],
                           r["n_micro"], device, **kw)
        _free(device)
        out.append({"who": who, **CMP.train_gaps(other, ref),
                    **CMP.details(other, ref)})
    return out


def _free(device) -> None:
    import gc
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
