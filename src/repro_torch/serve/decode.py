"""Serving: batched prefill + single-token decode steps (fixed batch).

The port of ``repro.serve.decode``.  PyTorch runs eagerly, so there is no
``build_prefill`` / ``build_decode_step`` compile step: :func:`prefill_fn`
and :func:`decode_step_fn` are called directly.  Both update the caches in
place (the ring-buffer KV caches written, a Mamba2 cache's states
replaced) and return them.  Over a mesh every rank calls them on its slice
of the batch, the parameters and the caches (``launch.serve.generate``);
the logits they return are the rank's part of the vocabulary, and the
sampled tokens are the whole vocabulary's.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.sharding import comm
from repro_torch.sharding.plan import MeshPlan


def greedy_sample(logits: torch.Tensor, plan: MeshPlan) -> torch.Tensor:
    """Greedy argmax over vocab-sharded (..., V_loc) logits; the lowest
    index wins ties, across ranks too (``torch.argmax`` returns the first
    maximal index of a rank's part; then the largest maximum over tp, and
    of the ranks that hold it, the smallest index)."""
    arg = logits.argmax(-1).to(torch.int32)
    if plan.tp <= 1:
        return arg
    local_max = logits.amax(-1)
    arg = arg + comm.axis_index(plan.tp_axis) * logits.shape[-1]
    gmax = comm.pmax(local_max, plan.tp_axis)
    # int32 on the wire, as the reference's argmax gives
    cand = torch.where(local_max >= gmax, arg,
                       torch.full_like(arg, torch.iinfo(torch.int32).max))
    return -comm.pmax(-cand, plan.tp_axis)


def prefill_fn(params, tokens: torch.Tensor, caches, *, cfg: ModelConfig,
               plan: MeshPlan, use_kernel: bool = True
               ) -> Tuple[torch.Tensor, tuple, torch.Tensor]:
    """Run the prompt (B, S), or (B, K, S) under K > 1 codebooks, through
    the model, filling the caches.

    Returns ``(next_token (B,) or (B, K) int32, caches, last_logits (B, V)
    or (B, K, V) fp32)``; the JAX version returns the first two, the logits
    let a caller check them without another forward.
    """
    S = tokens.shape[-1]
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    _, logits, _, caches = T.forward(params, tokens, cfg, plan,
                                     positions=positions, caches=caches,
                                     use_kernel=use_kernel)
    last = logits[:, -1]
    return greedy_sample(last, plan), caches, last


def decode_step_fn(params, token: torch.Tensor, caches, step: int, *,
                   cfg: ModelConfig, plan: MeshPlan, use_kernel: bool = True
                   ) -> Tuple[torch.Tensor, tuple, torch.Tensor]:
    """One decode step.  token: (B,), or (B, K) under K > 1 codebooks;
    step: the position of this token.  Returns ``(next_token, caches,
    logits)`` shaped as :func:`prefill_fn`'s."""
    positions = torch.full((1,), step, dtype=torch.int32, device=token.device)
    _, logits, _, caches = T.forward(params, token[..., None], cfg, plan,
                                     positions=positions, caches=caches,
                                     use_kernel=use_kernel)
    last = logits[:, -1]
    return greedy_sample(last, plan), caches, last
