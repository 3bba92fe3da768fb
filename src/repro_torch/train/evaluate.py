"""Evaluation: held-out cross-entropy / perplexity on the synthetic stream
(the port of ``repro.train.evaluate``).  The eval stream uses a disjoint
seed space from training (seed + 10_000).  Over a mesh (a plan with named
axes, on a rank of the bound mesh) each rank scores its dp slice of every
batch, and the sums are psum'd over the dp axes."""
from __future__ import annotations

import math
from functools import partial
from typing import Dict

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.data.pipeline import make_batch
from repro_torch.models import transformer as T
from repro_torch.models.layers import vocab_parallel_xent
from repro_torch.sharding import comm
from repro_torch.sharding import specs as S
from repro_torch.sharding.plan import MeshPlan
from repro_torch.train.step import IGNORE, to_device

EVAL_SEED_OFFSET = 10_000


@torch.no_grad()
def eval_step_fn(params, batch, *, cfg: ModelConfig, plan: MeshPlan):
    """Returns (sum CE, token count) over one batch, as tensors (no MTP
    loss, as the reference's)."""
    tokens, labels = batch["tokens"], batch["labels"]
    S = tokens.shape[-1]
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    extra = {k: batch[k] for k in ("image_embeds", "image_pos")
             if k in batch}
    _, logits, _, _ = T.forward(params, tokens, cfg, plan,
                                positions=positions, extra=extra or None,
                                cast_weights=True)
    if cfg.num_codebooks > 1:
        labels = labels.transpose(1, 2)                  # (B, S, K)
    ce = vocab_parallel_xent(logits, labels, plan)
    mask = labels != IGNORE
    s = comm.psum((ce * mask).sum(), plan.dp_axes)
    n = comm.psum(mask.sum().float(), plan.dp_axes)
    return s, n


def evaluate(params, cfg: ModelConfig, plan: MeshPlan, *, batch: int,
             seq: int, seed: int = 0, n_batches: int = 4,
             step_fn=None) -> Dict[str, float]:
    """Average CE + perplexity over ``n_batches`` held-out batches."""
    if step_fn is None:
        step_fn = partial(eval_step_fn, cfg=cfg, plan=plan)
    device = params["embed"]["table"].device
    mesh = comm.bound_mesh() if plan.all_axes else None
    tot, cnt = 0.0, 0.0
    for i in range(n_batches):
        b = to_device(make_batch(cfg, batch, seq, seed + EVAL_SEED_OFFSET, i),
                      device)
        if mesh is not None:
            b = S.shard_params(b, S.batch_specs(b, plan), mesh)
        s, n = step_fn(params, b)
        tot += float(s)
        cnt += float(n)
    ce = tot / max(cnt, 1.0)
    return {"eval_ce": ce, "eval_ppl": math.exp(min(ce, 30.0)),
            "eval_tokens": cnt}
