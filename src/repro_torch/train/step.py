"""The training step on one device: the port of ``repro.train.step``.

Loss and backward, gradient accumulation over micro-batches, the global-norm
clip and the optimizer update.  The parameters are the fp32 masters
(``init_model(..., compute_cast=False)``); the forward casts each block's
weights to the activation dtype inside its remat region
(``forward(..., cast_weights=True)``).

As the JAX package's step does at every call site, the forward runs with
``use_kernel=False``: the expert FFN and the dispatch/combine gathers are
plain tensor code, so the slice-1 kernels (which have no backward) stay off
this path.  The routing kernels run all the
same, through ``MoEConfig.router_impl="fused"`` and ``sort_impl="radix"``.

One device only: the mesh, the gradient sync trees, ZeRO-1 and the step
sentinel come with later slices and raise here.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.profiler import record_function

from repro_torch.common.config import ModelConfig, TrainConfig
from repro_torch.models import transformer as T
from repro_torch.models.layers import vocab_parallel_xent
from repro_torch.optim.optimizers import (Optimizer, clip_by_global_norm,
                                          leaf_groups)
from repro_torch.sharding import comm
from repro_torch.sharding.plan import MeshPlan

IGNORE = -1


def _ce_loss(params, batch, cfg: ModelConfig, plan: MeshPlan):
    """Masked cross-entropy plus the MoE aux losses.  Returns ``(loss,
    metrics)``; on one device the gradient-path loss is the loss itself."""
    tokens, labels = batch["tokens"], batch["labels"]
    if "image_embeds" in batch:
        raise NotImplementedError("vision inputs are not ported yet")
    S = tokens.shape[-1]
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    _, logits, stats, _ = T.forward(params, tokens, cfg, plan,
                                    positions=positions, remat=cfg.remat,
                                    use_kernel=False, cast_weights=True)
    ce = vocab_parallel_xent(logits, labels, plan)
    mask = labels != IGNORE
    loss_sum = (ce * mask).sum()
    cnt = comm.psum(mask.sum().float(), plan.dp_axes)
    ce_mean = comm.psum(loss_sum, plan.dp_axes) / torch.clamp(cnt, min=1.0)
    total = ce_mean + stats.lb_loss + stats.z_loss
    metrics = {"ce": ce_mean, "lb": stats.lb_loss, "z": stats.z_loss,
               "mtp": torch.zeros_like(ce_mean), "drop_frac": stats.drop_frac,
               "loss": total,
               "fault_events": stats.fault_events.sum(),
               "wire_faults": stats.wire_faults.sum(),
               "max_load": stats.hop_max_load.max(),
               "load_entropy": stats.hop_load_entropy.min()}
    return total, {k: v.detach() for k, v in metrics.items()}


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def train_step_fn(params, opt_state, batch, step, *, cfg: ModelConfig,
                  tcfg: TrainConfig, plan: MeshPlan, opt: Optimizer,
                  schedule, n_micro: int = 1):
    """One optimizer step.  ``params`` are updated in place (and returned);
    returns ``(params, opt_state, metrics)``, the metrics as tensors (no
    host sync) except ``lr``.  Its three phases are profiler ranges
    (``train_step.loss_backward``, ``.clip``, ``.optimizer``)."""
    for g in leaf_groups(params):
        for p in g.pieces:
            p.grad = None
    with record_function("train_step.loss_backward"):
        loss, metrics = _loss_backward(params, batch, cfg, plan, n_micro)
    lr = schedule(step)
    with record_function("train_step.clip"):
        gnorm = clip_by_global_norm(params, tcfg.grad_clip)
    with record_function("train_step.optimizer"):
        opt_state = opt.update(params, opt_state, lr)
    metrics = dict(metrics, grad_norm=gnorm, lr=lr)
    return params, opt_state, metrics


def _loss_backward(params, batch, cfg, plan, n_micro):
    """Forward and backward, over ``n_micro`` micro-batches; the gradients
    land in each parameter's ``.grad``.  Returns ``(loss, metrics)`` of the
    last micro-batch."""
    if n_micro <= 1:
        loss, metrics = _ce_loss(params, batch, cfg, plan)
        loss.backward()
    else:
        B = batch["tokens"].shape[0]
        if B % n_micro:
            raise ValueError(f"batch {B} does not split into {n_micro} "
                             f"micro-batches")
        mb = B // n_micro
        # the reference's lax.scan over micro-batches: gradients add up,
        # the metrics are the last micro-batch's
        for i in range(n_micro):
            sub = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, metrics = _ce_loss(params, sub, cfg, plan)
            loss.backward()
        with torch.no_grad():
            for g in leaf_groups(params):
                for p in g.pieces:
                    if p.grad is not None:
                        p.grad.div_(n_micro)
    return loss, metrics


def build_train_step(cfg: ModelConfig, tcfg: TrainConfig, plan: MeshPlan,
                     opt: Optimizer, schedule, params_like, batch_like,
                     mesh=None, zero1: bool = False, sentinel: bool = False):
    """Return ``step(params, opt_state, batch, step) -> (params, opt_state,
    metrics)`` for one device.  ``batch`` may hold numpy arrays; they are
    moved to the parameters' device.  Marks every parameter of
    ``params_like`` as requiring grad."""
    if mesh is not None:
        raise NotImplementedError("training over a mesh of ranks is not "
                                  "ported yet (ROADMAP queue 1, item 7)")
    if zero1 or sentinel:
        raise NotImplementedError(
            "ZeRO-1 and the step sentinel are not ported yet (ROADMAP, "
            "queue item 8)")
    for g in leaf_groups(params_like):
        for p in g.pieces:
            p.requires_grad_(True)
    n_micro = 1
    if tcfg.micro_batch_size:
        local_b = batch_like["tokens"].shape[0] // max(plan.dp, 1)
        n_micro = max(1, local_b // tcfg.micro_batch_size)
    device = params_like["embed"]["table"].device

    def step_fn(params, opt_state, batch, step):
        return train_step_fn(params, opt_state, to_device(batch, device),
                             step, cfg=cfg, tcfg=tcfg, plan=plan, opt=opt,
                             schedule=schedule, n_micro=n_micro)

    return step_fn
