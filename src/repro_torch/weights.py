"""Carry the JAX package's parameters into the port.

``repro.models.transformer.init_model`` returns a tree whose stages stack
their blocks' parameters on a leading ``(repeats, ...)`` axis (for
``lax.scan``).  :func:`params_from_jax` takes that tree with its leaves
already turned into numpy arrays (``jax.tree.map(np.asarray, params)``),
splits every stage into its per-block dicts, and returns the port's
parameters — the same structure :func:`repro_torch.models.transformer.
init_model` returns, compute weights cast once to the compute dtype — so
both packages compute the same thing on the same weights.  This module
imports neither JAX nor the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.common.config import ModelConfig
from repro_torch.common.device import resolve_device
from repro_torch.models.transformer import (build_stages, cast_for_compute,
                                            _check_supported)


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C")).to(device)   # a copy


def _tree(t, device, index=None):
    """Nested dicts of arrays -> nested dicts of tensors, optionally taking
    ``[index]`` along each leaf's leading (stacked-block) axis."""
    if isinstance(t, dict):
        return {k: _tree(v, device, index) for k, v in t.items()}
    if t is None:
        return None
    return _tensor(t if index is None else np.asarray(t)[index], device)


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig, *,
                    device="cuda") -> Dict[str, Any]:
    """The JAX parameter tree (numpy leaves) as the port's parameters on
    ``device``."""
    device = resolve_device(device)
    _check_supported(cfg)
    stages = []
    for st, sp in zip(build_stages(cfg), tree["stages"]):
        if st.kind == "pair":
            stages.append({k: [_tree(sp[k], device, r)
                               for r in range(st.repeats)]
                           for k in ("dense", "moe")})
        else:
            stages.append({"blocks": [_tree(sp["blocks"], device, r)
                                      for r in range(st.repeats)]})
    params = {k: _tree(v, device) for k, v in tree.items() if k != "stages"}
    params["stages"] = tuple(stages)
    return cast_for_compute(params, cfg)
