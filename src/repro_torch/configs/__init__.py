"""Architecture registry: the 10 assigned architectures + the paper's own
SMILE/Switch MLM configs. Every module exports ``CONFIG`` (the exact assigned
configuration, source cited) and ``REDUCED`` (2-layer smoke-test variant).

Pure data, copied whole from ``repro.configs`` so the port never imports the
JAX package; the tests hold every copy equal to its reference.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.common.config import INPUT_SHAPES, InputShape, ModelConfig

_MODULES = {
    "deepseek-v3-671b": "deepseek_v3_671b",
    "phi-3-vision-4.2b": "phi3_vision_4_2b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "zamba2-2.7b": "zamba2_2_7b",
    "musicgen-large": "musicgen_large",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "llama3-405b": "llama3_405b",
    "stablelm-12b": "stablelm_12b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    # the paper's own models (reproduction targets)
    "smile-3.7b": "smile_paper",
    "switch-3.7b": "smile_paper",
    "smile-13b": "smile_paper",
    "smile-48b": "smile_paper",
    "bert-110m": "smile_paper",
    "bert-3.7b": "smile_paper",
}

ASSIGNED = list(_MODULES)[:10]
PAPER = list(_MODULES)[10:]


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    m = _mod(name)
    if hasattr(m, "CONFIGS"):
        return m.CONFIGS[name]
    return m.CONFIG


def get_reduced(name: str) -> ModelConfig:
    m = _mod(name)
    if hasattr(m, "REDUCEDS"):
        return m.REDUCEDS[name]
    return m.REDUCED


def with_options(cfg: ModelConfig, **options) -> ModelConfig:
    """Rebuild ``cfg`` with MoE dispatch options swapped; no-op for dense
    architectures.

    The single entry point for runtime MoE knobs: every option is validated
    against :data:`repro_torch.common.config.MOE_OPTIONS` (the same registry both
    launchers derive their flags from), e.g. ``with_options(cfg,
    dispatch_backend="dropless", recv_bound_factor=2.0)``.
    """
    if cfg.moe is None:
        return cfg
    return cfg.replace(moe=cfg.moe.with_options(**options))


def with_dispatch_backend(cfg: ModelConfig, backend: str,
                          ragged_a2a: bool | None = None,
                          sort_impl: str | None = None) -> ModelConfig:
    """Deprecated shim: use :func:`with_options` instead.

    Kept so pre-pipeline callers keep working (with a DeprecationWarning);
    forwards to ``with_options``, which validates against the options
    registry.
    """
    import warnings
    warnings.warn(
        "with_dispatch_backend is deprecated; use "
        "configs.with_options(cfg, dispatch_backend=..., ...) — options are "
        "validated against repro_torch.common.config.MOE_OPTIONS",
        DeprecationWarning, stacklevel=2)
    kw = {"dispatch_backend": backend}
    if ragged_a2a is not None:
        kw["ragged_a2a"] = ragged_a2a
    if sort_impl is not None:
        kw["sort_impl"] = sort_impl
    if cfg.moe is None:
        # preserve the old contract: validate even for dense archs
        from repro_torch.common.config import MoEConfig
        MoEConfig().with_options(**kw)
        return cfg
    return with_options(cfg, **kw)


def config_for_shape(name: str, shape: InputShape) -> ModelConfig:
    """Adapt a config to an input shape.

    ``long_500k`` requires sub-quadratic attention: SSM/hybrid archs run
    natively; attention archs switch to the documented sliding-window
    variant (ring-buffer KV cache, window 8192 — see DESIGN.md).
    """
    cfg = get_config(name)
    if shape.name == "long_500k":
        if cfg.attention in ("full", "mla"):
            cfg = cfg.replace(attention="sliding" if cfg.attention == "full"
                              else cfg.attention, window=8192)
        if cfg.arch_type == "hybrid":
            cfg = cfg.replace(attention="sliding", window=4096)
    return cfg


def supports_shape(name: str, shape: InputShape) -> bool:
    cfg = get_config(name)
    if shape.kind == "decode" and not cfg.causal:
        return False          # encoder-only MLM archs have no decode step
    return True
