"""Serving: batched prefill + single-token decode steps (fixed batch).

The port of ``repro.serve.decode``.  PyTorch runs eagerly, so there is no
``build_prefill`` / ``build_decode_step`` compile step: :func:`prefill_fn`
and :func:`decode_step_fn` are called directly.  Both update the ring-buffer
KV caches in place.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.sharding.plan import MeshPlan


def greedy_sample(logits: torch.Tensor, plan: MeshPlan) -> torch.Tensor:
    """Greedy argmax over (..., V) logits; the lowest index wins ties
    (``torch.argmax`` returns the first maximal index)."""
    return logits.argmax(-1).to(torch.int32)


def prefill_fn(params, tokens: torch.Tensor, caches, *, cfg: ModelConfig,
               plan: MeshPlan, use_kernel: bool = True
               ) -> Tuple[torch.Tensor, tuple, torch.Tensor]:
    """Run the prompt (B, S) through the model, filling the caches.

    Returns ``(next_token (B,) int32, caches, last_logits (B, V) fp32)``;
    the JAX version returns the first two, the logits let a caller check
    them without another forward.
    """
    S = tokens.shape[-1]
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    _, logits, _, caches = T.forward(params, tokens, cfg, plan,
                                     positions=positions, caches=caches,
                                     use_kernel=use_kernel)
    last = logits[:, -1, :]
    return greedy_sample(last, plan), caches, last


def decode_step_fn(params, token: torch.Tensor, caches, step: int, *,
                   cfg: ModelConfig, plan: MeshPlan, use_kernel: bool = True
                   ) -> Tuple[torch.Tensor, tuple, torch.Tensor]:
    """One decode step.  token: (B,); step: the position of this token.
    Returns ``(next_token (B,), caches, logits (B, V))``."""
    positions = torch.full((1,), step, dtype=torch.int32, device=token.device)
    _, logits, _, caches = T.forward(params, token[:, None], cfg, plan,
                                     positions=positions, caches=caches,
                                     use_kernel=use_kernel)
    last = logits[:, -1, :]
    return greedy_sample(last, plan), caches, last
