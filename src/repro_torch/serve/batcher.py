"""DEPRECATED shim: :class:`Batcher` wraps :class:`repro_torch.serve.engine.
Engine`.  The port of ``repro.serve.batcher``.

The original Batcher was a fixed-shape toy (a fixed ``prompt_len``, one
batch-of-1 ring cache per slot, a decode call per slot per tick).  The
engine replaces all three: a paged KV cache over a shared pool,
variable-length bucketed prefill, and one fused batched decode step a
tick.  This class keeps the old constructor / submit / run surface; new
code should use the Engine directly.
"""
from __future__ import annotations

import warnings
from typing import Dict, List

import numpy as np

from repro_torch.common.config import ModelConfig, ServeConfig
from repro_torch.serve.engine import Engine, Request  # noqa: F401  (re-export)
from repro_torch.sharding.plan import MeshPlan


class Batcher:
    def __init__(self, params, cfg: ModelConfig, plan: MeshPlan, *,
                 n_slots: int = 4, cache_len: int = 128,
                 prompt_len: int = 16):
        warnings.warn(
            "repro_torch.serve.batcher.Batcher is deprecated; use "
            "repro_torch.serve.engine.Engine (paged KV cache + fused batched "
            "decode). prompt_len is no longer a fixed shape — prompts of "
            "any length up to cache_len are accepted.",
            DeprecationWarning, stacklevel=2)
        serve = ServeConfig(n_slots=n_slots, cache_len=cache_len,
                            prompt_len=prompt_len,
                            page_size=min(16, cache_len))
        self.engine = Engine(params, cfg, plan, serve=serve)

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16) -> int:
        return self.engine.submit(prompt, max_new_tokens)

    def run(self) -> Dict[int, List[int]]:
        return self.engine.run()

    @property
    def ticks(self) -> int:
        return self.engine.ticks
