"""The training step: the port of ``repro.train.step``.

Loss and backward, gradient accumulation over micro-batches, the gradient
sync over a mesh, the global-norm clip and the optimizer update.  The
parameters are the fp32 masters (``init_model(..., compute_cast=False)``);
the forward casts each block's weights to the activation dtype inside its
remat region (``forward(..., cast_weights=True)``).

As the JAX package's step does at every call site, the forward runs with
``use_kernel=False``: the expert FFN and the dispatch/combine gathers are
plain tensor code, so the slice-1 kernels (which have no backward) stay off
this path.  The routing kernels run all the
same, through ``MoEConfig.router_impl="fused"`` and ``sort_impl="radix"``.

Over a mesh of ranks (``build_train_step(..., mesh=)``) every rank runs
the step the reference runs under ``shard_map``: each rank's loss is its
share of the global loss (the cross-entropy's ``loss_sum / tp /
global_count``, the aux losses ``/ n_dev``), its backward runs through the
collectives' transposes (``sharding.comm``), each leaf's gradient is then
psum'd over the axes the leaf is replicated on (``specs.shard_axes``), and
the clip and LAMB sum their norms over the axes it is cut over
(``specs.sharded_axes_only``).

``zero1=True`` shards LAMB's moments over each leaf's replicated axes
(:mod:`repro_torch.optim.zero1`): the raw gradients skip the psums and
are reduce-scattered into owned chunks, clipped there, and the updated
chunks all-gathered.  ``sentinel=True`` judges each step after the
reduction and the clip, before the moments see anything
(:mod:`repro_torch.train.sentinel`): a non-finite or spiking step skips
the optimizer and leaves the parameters and its state bit-unchanged.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch.profiler import record_function

from repro_torch.common.config import ModelConfig, TrainConfig
from repro_torch.models import transformer as T
from repro_torch.models.layers import vocab_parallel_xent
from repro_torch.optim.optimizers import (CHUNK, Optimizer,
                                          clip_by_global_norm, group_axes,
                                          leaf_groups)
from repro_torch.optim.zero1 import (Zero1State, init_state_shapes,
                                     zero1_apply, zero1_reduce_and_clip)
from repro_torch.sharding import comm
from repro_torch.sharding import specs as S
from repro_torch.sharding.plan import MeshPlan
from repro_torch.train import sentinel as SEN

IGNORE = -1
MTP_LAMBDA = 0.1


def _ce_loss(params, batch, cfg: ModelConfig, plan: MeshPlan):
    """Masked cross-entropy plus the MoE aux losses (and, with an MTP head,
    ``MTP_LAMBDA`` times its loss).  Returns ``(loss, metrics)``: ``loss``
    is this rank's share of the gradient-path loss (the shares of all
    ranks sum to the global loss, which is the loss itself on one device),
    the metrics the global values.  Musicgen's labels are (B, K, S); image
    inputs (``image_embeds``, ``image_pos``) ride in the batch."""
    tokens, labels = batch["tokens"], batch["labels"]
    positions = torch.arange(tokens.shape[-1], dtype=torch.int32,
                             device=tokens.device)
    extra = {k: batch[k] for k in ("image_embeds", "image_pos")
             if k in batch}
    h, logits, stats, _ = T.forward(params, tokens, cfg, plan,
                                    positions=positions, extra=extra or None,
                                    remat=cfg.remat, use_kernel=False,
                                    cast_weights=True)
    if cfg.num_codebooks > 1:
        labels_t = labels.transpose(1, 2)                # (B, S, K)
        ce = vocab_parallel_xent(logits, labels_t, plan)
        mask = labels_t != IGNORE
    else:
        ce = vocab_parallel_xent(logits, labels, plan)
        mask = labels != IGNORE
    loss_sum = (ce * mask).sum()
    # tokens are distinct across the dp axes only (replicated over tp)
    cnt = torch.clamp(comm.psum(mask.sum().float(), plan.dp_axes), min=1.0)
    ce_mean = comm.psum(loss_sum.detach(), plan.dp_axes) / cnt
    n_dev = 1
    for _, n in plan.axis_sizes:
        n_dev *= n
    tp = max(plan.tp, 1)
    # the aux losses are replicated (psum'd inside): each rank's share is
    # 1 / n_dev of them
    share = loss_sum / tp / cnt + (stats.lb_loss + stats.z_loss) / n_dev
    total = ce_mean + stats.lb_loss + stats.z_loss
    mtp_loss = torch.zeros_like(ce_mean)
    if cfg.mtp_depth and cfg.causal and "mtp" in params:
        nxt = torch.where(labels == IGNORE, 0, labels)   # token t+1
        tgt = torch.full_like(labels, IGNORE)
        tgt[:, :-1] = labels[:, 1:]                      # token t+2
        ml = T.mtp_logits(params, h, nxt, cfg, plan, positions)
        mmask = (tgt != IGNORE) & (labels != IGNORE)
        ms = (vocab_parallel_xent(ml, tgt, plan) * mmask).sum()
        mc = torch.clamp(comm.psum(mmask.sum().float(), plan.dp_axes),
                         min=1.0)
        mtp_loss = comm.psum(ms.detach(), plan.dp_axes) / mc
        share = share + MTP_LAMBDA * (ms / tp / mc)
        total = total + MTP_LAMBDA * mtp_loss
    metrics = {"ce": ce_mean, "lb": stats.lb_loss, "z": stats.z_loss,
               "mtp": mtp_loss, "drop_frac": stats.drop_frac,
               "loss": total,
               "fault_events": stats.fault_events.sum(),
               "wire_faults": stats.wire_faults.sum(),
               "max_load": stats.hop_max_load.max(),
               "load_entropy": stats.hop_load_entropy.min()}
    return share, {k: v.detach() for k, v in metrics.items()}


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


@torch.no_grad()
def sync_grads(groups, axes: List[Tuple[str, ...]]) -> None:
    """Each group's ``.grad`` psum'd over its ``axes`` (the axes the leaf
    is replicated on), in place.  The gradients that share an axes tuple
    are flattened into buckets of at most ``CHUNK`` elements, one psum a
    bucket (the same sums, element by element)."""
    by: Dict[Tuple[str, ...], List[torch.Tensor]] = {}
    for g, a in zip(groups, axes):
        if a:
            by.setdefault(a, []).extend(p.grad for p in g.pieces)
    for a, grads in by.items():
        bucket: List[torch.Tensor] = []
        size = 0
        for gr in grads + [None]:
            if bucket and (gr is None or size + gr.numel() > CHUNK):
                flat = comm.psum(torch.cat([b.reshape(-1) for b in bucket]),
                                 a, label="psum.sync")
                off = 0
                for b in bucket:
                    b.copy_(flat[off:off + b.numel()].view_as(b))
                    off += b.numel()
                bucket, size = [], 0
            if gr is not None:
                bucket.append(gr)
                size += gr.numel()


def train_step_fn(params, opt_state, batch, step, sent=None, *,
                  cfg: ModelConfig, tcfg: TrainConfig, plan: MeshPlan,
                  opt: Optimizer, schedule, n_micro: int = 1,
                  sync_axes=None, norm_axes=None, zero1: bool = False,
                  sentinel: bool = False):
    """One optimizer step.  ``params`` are updated in place (and returned);
    returns ``(params, opt_state, metrics)``, the metrics as tensors (no
    host sync) except ``lr``.  ``sync_axes`` and ``norm_axes`` (trees
    shaped as the parameters; None on one device) name the axes each
    leaf's gradient is psum'd over and its norms are summed over.  Its
    phases are profiler ranges (``train_step.loss_backward``, ``.sync``,
    ``.clip``, ``.optimizer``).

    With ``zero1`` the optimizer is ZeRO-1 LAMB (``opt_state`` a
    :class:`~repro_torch.optim.zero1.Zero1State`, whatever ``opt`` is, as
    in the reference).  With ``sentinel`` the step takes and returns a
    fifth value, the :class:`~repro_torch.train.sentinel.SentinelState`,
    the update runs only on a good step, and the metrics gain ``skip``."""
    groups = leaf_groups(params)
    for g in groups:
        for p in g.pieces:
            p.grad = None
    with record_function("train_step.loss_backward"):
        loss, metrics = _loss_backward(params, batch, cfg, plan, n_micro)
    if sync_axes is not None:
        # a leaf no rank's loss reached still takes part in the psums,
        # so that every rank issues the same collectives
        for g in groups:
            for p in g.pieces:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
    lr = schedule(step)
    if zero1:
        with record_function("train_step.sync"):
            g_upd, gnorm, scale = zero1_reduce_and_clip(
                params, sync_axes_tree=sync_axes, norm_axes_tree=norm_axes,
                plan=plan, grad_clip=tcfg.grad_clip)
        grads = [t for x in g_upd for t in ([x] if torch.is_tensor(x)
                                            else x)]

        def apply(g_own, state, params):
            return params, zero1_apply(
                g_own, scale, state, params, lr, sync_axes_tree=sync_axes,
                norm_axes_tree=norm_axes, plan=plan, b1=tcfg.b1, b2=tcfg.b2,
                eps=tcfg.eps, weight_decay=tcfg.weight_decay)
    else:
        if sync_axes is not None:
            with record_function("train_step.sync"):
                sync_grads(groups, group_axes(groups, sync_axes))
        with record_function("train_step.clip"):
            gnorm = clip_by_global_norm(params, tcfg.grad_clip, norm_axes)
        g_upd = None
        grads = [p.grad for g in groups for p in g.pieces
                 if p.grad is not None]

        def apply(_, state, params):
            return params, opt.update(params, state, lr,
                                      shard_axes=norm_axes)
    with record_function("train_step.optimizer"):
        if sentinel:
            # the verdict after the reduction and the clip, before the
            # moments see anything
            ok, nonfin, spike = SEN.step_verdict(metrics["loss"], grads,
                                                 sent, plan.all_axes)
            params, opt_state = SEN.gated_update(ok, apply, g_upd,
                                                 opt_state, params)
            alarm = SEN.router_alarm(metrics["max_load"],
                                     metrics["load_entropy"])
            sent = SEN.update_sentinel(sent, metrics["loss"], ok, nonfin,
                                       spike, alarm)
            metrics = dict(metrics, skip=(~ok).to(torch.float32))
        else:
            params, opt_state = apply(g_upd, opt_state, params)
    metrics = dict(metrics, grad_norm=gnorm, lr=lr)
    if sentinel:
        return params, opt_state, metrics, sent
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


def _axes_trees(params, cfg: ModelConfig, plan: MeshPlan):
    """Each leaf's sync and shard axes (``specs.shard_axes``,
    ``specs.sharded_axes_only``)."""
    pspec = S.param_specs(params, cfg, plan)
    return S.shard_axes(pspec, plan), S.sharded_axes_only(pspec, plan)


def build_train_step(cfg: ModelConfig, tcfg: TrainConfig, plan: MeshPlan,
                     opt: Optimizer, schedule, params_like, batch_like,
                     mesh=None, zero1: bool = False, sentinel: bool = False):
    """Return ``step(params, opt_state, batch, step) -> (params, opt_state,
    metrics)``.  ``batch`` may hold numpy arrays; they are moved to the
    parameters' device.  Marks every parameter of ``params_like`` as
    requiring grad.

    With ``mesh`` (:func:`repro_torch.launch.mesh.make_mesh`, and ``plan``
    its ``plan_from_mesh``) the parameters are this rank's slices
    (``init_model(..., mesh=)``) and the step takes the global batch, as
    the reference's ``shard_map`` does, and cuts this rank's rows
    (``specs.batch_specs``); the micro-batches split the rank's rows.

    With ``zero1`` the optimizer state is :func:`zero1_state`'s.  With
    ``sentinel`` the step is ``step(params, opt_state, batch, step, sent)
    -> (params, opt_state, metrics, sent)``, ``sent`` from
    ``train.sentinel.init_sentinel_state``, and a bad step is skipped."""
    for g in leaf_groups(params_like):
        for p in g.pieces:
            p.requires_grad_(True)
    n_micro = 1
    if tcfg.micro_batch_size:
        local_b = batch_like["tokens"].shape[0] // max(plan.dp, 1)
        n_micro = max(1, local_b // tcfg.micro_batch_size)
    device = params_like["embed"]["table"].device
    sync_axes = norm_axes = None
    if mesh is not None:
        sync_axes, norm_axes = _axes_trees(params_like, cfg, plan)

    def step_fn(params, opt_state, batch, step, sent=None):
        batch = to_device(batch, device)
        if mesh is not None:
            batch = S.shard_params(batch, S.batch_specs(batch, plan), mesh)
        return train_step_fn(params, opt_state, batch, step, sent, cfg=cfg,
                             tcfg=tcfg, plan=plan, opt=opt,
                             schedule=schedule, n_micro=n_micro,
                             sync_axes=sync_axes, norm_axes=norm_axes,
                             zero1=zero1, sentinel=sentinel)

    return step_fn


def zero1_state(params, cfg: ModelConfig, plan: MeshPlan) -> Zero1State:
    """The zero ZeRO-1 optimizer state of ``params`` (the rank's slices
    over a mesh, ``plan`` its ``plan_from_mesh``)."""
    sync_axes, norm_axes = _axes_trees(params, cfg, plan)
    return init_state_shapes(params, sync_axes, norm_axes, plan)
