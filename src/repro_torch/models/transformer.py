"""Model assembly: the port of ``repro.models.transformer``.

A model is a list of *stages*; each stage is a homogeneous stack of blocks.
The JAX package stacks a stage's block parameters on a leading axis and
runs them with ``lax.scan``; here a stage holds a list of per-block
parameter dicts (``{"blocks": [...]}``) and a Python loop runs them.  Caches
follow the same shape: one list of per-block cache dicts per stage.

This slice ports the attention families the serving path needs: ``dense``,
``moe`` and the paper's ``pair`` stage.  RWKV, Mamba2, MLA and the
multimodal inputs raise.

Parameters are drawn from a seeded ``torch.Generator`` on the target
device.  Its numbers differ from ``jax.random``'s, which is expected: the
tests carry the JAX package's weights across with
:func:`repro_torch.weights.params_from_jax`.  The matmul weights of the
blocks (attention projections, dense, shared and expert FFNs) are cast to
the activation dtype (bf16, the dtype :func:`embed_inputs` computes in) once
at load by :func:`cast_for_compute`; the reference casts them at every use,
which gives the same bits.  The blocks use them as they are, with no cast
of their own.  Router weights, norm scales, the embedding table and the LM
head stay fp32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.common.device import resolve_device
from repro_torch.core.moe import init_moe_params, moe_layer
from repro_torch.core.pipeline import MoEStats, zero_stats
from repro_torch.kernels.ref import activation
from repro_torch.models import layers as L
from repro_torch.sharding import comm
from repro_torch.sharding.plan import MeshPlan

# the activation dtype of forward: the reference embeds in bf16 whatever
# the config's dtype, and casts the blocks' weights to it at use
COMPUTE_DTYPE = torch.bfloat16


# =============================================================================
# Stage plan
# =============================================================================

@dataclasses.dataclass(frozen=True)
class Stage:
    kind: str        # dense | moe | pair | mamba_group | rwkv
    repeats: int


def build_stages(cfg: ModelConfig) -> List[Stage]:
    if cfg.arch_type in ("ssm",) and cfg.rwkv is not None:
        return [Stage("rwkv", cfg.num_layers)]
    if cfg.arch_type == "hybrid":
        g = cfg.ssm_layers_per_attn
        if cfg.num_layers % g:
            raise ValueError(f"num_layers {cfg.num_layers} must be a "
                             f"multiple of ssm_layers_per_attn {g}")
        return [Stage("mamba_group", cfg.num_layers // g)]
    if cfg.moe is not None and cfg.moe.num_experts:
        stages = []
        fd = cfg.moe.first_dense_layers
        if fd:
            stages.append(Stage("dense", fd))
        rest = cfg.num_layers - fd
        if cfg.moe.every_n_layers == 2:
            if rest % 2:
                raise ValueError(f"{rest} MoE-stage layers cannot pair up")
            stages.append(Stage("pair", rest // 2))
        else:
            stages.append(Stage("moe", rest))
        return stages
    return [Stage("dense", cfg.num_layers)]


def _phys_heads(cfg: ModelConfig, plan: MeshPlan) -> int:
    """Pad query heads up to a tp multiple (e.g. deepseek-coder 56 -> 64)."""
    tp = max(plan.tp, 1)
    return ((cfg.num_heads + tp - 1) // tp) * tp


def _model_cfg(cfg: ModelConfig, plan: MeshPlan) -> ModelConfig:
    h = _phys_heads(cfg, plan)
    if h != cfg.num_heads:
        cfg = cfg.replace(num_heads=h, head_dim=cfg.resolved_head_dim)
    return cfg


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.attention not in ("full", "sliding"):
        raise NotImplementedError(f"attention={cfg.attention!r} is not "
                                  f"ported yet")
    if cfg.num_codebooks > 1 or cfg.vision_tokens or cfg.mtp_depth:
        raise NotImplementedError("multimodal inputs and MTP heads are not "
                                  "ported yet")
    for st in build_stages(cfg):
        if st.kind not in BLOCK_KINDS:
            raise NotImplementedError(f"{st.kind!r} stages are not ported "
                                      f"yet")


# =============================================================================
# Block init / forward
# =============================================================================

def init_block(cfg: ModelConfig, kind: str, plan: MeshPlan, *,
               generator: torch.Generator, device=None) -> Dict:
    d = cfg.d_model
    kw = dict(generator=generator, device=device)
    if kind not in ("dense", "moe"):
        raise NotImplementedError(f"{kind!r} blocks are not ported yet")
    p = {
        "ln1": L._norm_init(d, cfg.norm, device),
        "attn": L.init_attention(cfg, **kw),
        "ln2": L._norm_init(d, cfg.norm, device),
    }
    if kind == "dense":
        p["ffn"] = L.init_ffn(cfg, **kw)
    else:
        p["moe"] = init_moe_params(cfg.moe, d, plan, glu=cfg.glu, **kw)
        if cfg.moe.num_shared_experts:
            p["shared"] = L.init_ffn(
                cfg, cfg.moe.num_shared_experts * cfg.moe.d_ff_expert, **kw)
    return p


def _add_stats(a: MoEStats, b: MoEStats) -> MoEStats:
    # losses/drops sum across layers; the watchdog fields keep the worst
    # layer (max load fraction, min load entropy)
    return MoEStats(a.lb_loss + b.lb_loss, a.z_loss + b.z_loss,
                    a.drop_frac + b.drop_frac,
                    a.hop_drop_frac + b.hop_drop_frac,
                    a.fault_events + b.fault_events,
                    torch.maximum(a.hop_max_load, b.hop_max_load),
                    torch.minimum(a.hop_load_entropy, b.hop_load_entropy),
                    a.wire_faults + b.wire_faults)


def dense_block(p, x, cfg, plan, positions, cache, *, use_kernel=False,
                token_valid=None):
    window = cfg.window if cfg.attention == "sliding" else 0
    h, cache = L.attention_forward(p["attn"], L.apply_norm(p["ln1"], x,
                                                           cfg.norm),
                                   cfg, plan, positions=positions,
                                   cache=cache, window=window,
                                   use_kernel=use_kernel)
    x = x + h
    x = x + L.ffn_forward(p["ffn"], L.apply_norm(p["ln2"], x, cfg.norm),
                          cfg, plan)
    return x, zero_stats(x.device), cache


def moe_block(p, x, cfg, plan, positions, cache, *, use_kernel=False,
              token_valid=None):
    window = cfg.window if cfg.attention == "sliding" else 0
    h, cache = L.attention_forward(p["attn"], L.apply_norm(p["ln1"], x,
                                                           cfg.norm),
                                   cfg, plan, positions=positions,
                                   cache=cache, window=window,
                                   use_kernel=use_kernel)
    x = x + h
    hn = L.apply_norm(p["ln2"], x, cfg.norm)
    B, T, d = hn.shape
    loc, _ = comm.split_tokens(hn.reshape(B * T, d), plan.tp_axis,
                               max(plan.tp, 1))
    valid_loc = None
    if token_valid is not None:
        valid_loc, _ = comm.split_tokens(token_valid.reshape(B * T),
                                         plan.tp_axis, max(plan.tp, 1))
    y_loc, stats = moe_layer(p["moe"], loc, cfg.moe, plan, act=cfg.act,
                             use_kernel=use_kernel, token_valid=valid_loc)
    if "shared" in p:
        ps = p["shared"]
        hh = activation(loc @ ps["w1"], cfg.act)
        if "w3" in ps:
            hh = hh * (loc @ ps["w3"])
        y_loc = y_loc + hh @ ps["w2"]
    y = comm.unsplit_tokens(y_loc, plan.tp_axis, B * T).reshape(B, T, d)
    return x + y, stats, cache


BLOCK_FNS = {"dense": dense_block, "moe": moe_block}
BLOCK_KINDS = ("dense", "moe", "pair")


def init_stage(cfg: ModelConfig, stage: Stage, plan: MeshPlan, *,
               generator: torch.Generator, device=None) -> Dict:
    kw = dict(generator=generator, device=device)
    R = stage.repeats
    if stage.kind == "pair":
        return {"dense": [init_block(cfg, "dense", plan, **kw)
                          for _ in range(R)],
                "moe": [init_block(cfg, "moe", plan, **kw)
                        for _ in range(R)]}
    return {"blocks": [init_block(cfg, stage.kind, plan, **kw)
                       for _ in range(R)]}


def stage_forward(params: Dict, x, cfg: ModelConfig, stage: Stage,
                  plan: MeshPlan, positions, caches, *,
                  use_kernel: bool = False, token_valid=None):
    """Run the stage's blocks in order (a loop in place of ``lax.scan``).
    ``caches``: None or a list of per-block caches.  Returns
    ``(x, stats, caches)``."""

    def run(kind, blocks, x, caches):
        fn = BLOCK_FNS[kind]
        acc = zero_stats(x.device)
        new = []
        for i, p in enumerate(blocks):
            c = None if caches is None else caches[i]
            x, stats, c = fn(p, x, cfg, plan, positions, c,
                             use_kernel=use_kernel, token_valid=token_valid)
            acc = _add_stats(acc, stats)
            new.append(c)
        return x, acc, (None if caches is None else new)

    if stage.kind == "pair":
        # the reference runs the stage's dense blocks, then its MoE blocks
        x, s1, c1 = run("dense", params["dense"], x,
                        None if caches is None else caches["dense"])
        x, s2, c2 = run("moe", params["moe"], x,
                        None if caches is None else caches["moe"])
        cc = None if caches is None else {"dense": c1, "moe": c2}
        return x, _add_stats(s1, s2), cc
    return run(stage.kind, params["blocks"], x, caches)


# =============================================================================
# Whole model
# =============================================================================

def cast_for_compute(params: Dict, cfg: ModelConfig) -> Dict:
    """Cast the blocks' matmul weights to :data:`COMPUTE_DTYPE` once, in
    place of the reference's cast at every use (same bits).  Router weights,
    norm scales, the embedding table and the LM head are left as they are."""
    dt = COMPUTE_DTYPE

    def block(p: Dict) -> Dict:
        p = dict(p)
        p["attn"] = {k: v.to(dt) for k, v in p["attn"].items()}
        if "ffn" in p:
            p["ffn"] = {k: v.to(dt) for k, v in p["ffn"].items()}
        if "shared" in p:
            p["shared"] = {k: v.to(dt) for k, v in p["shared"].items()}
        if "moe" in p:
            p["moe"] = dict(p["moe"])
            p["moe"]["experts"] = {k: v.to(dt) for k, v in
                                   p["moe"]["experts"].items()}
        return p

    out = dict(params)
    out["stages"] = tuple({k: [block(b) for b in blocks]
                           for k, blocks in st.items()}
                          for st in params["stages"])
    return out


def init_model(cfg0: ModelConfig, plan: MeshPlan, *, seed: int = 0,
               device="cuda") -> Dict:
    """Random parameters from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (the card unless the caller asks for the CPU; raises when
    the card is asked for and there is none)."""
    device = resolve_device(device)
    cfg = _model_cfg(cfg0, plan)
    _check_supported(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(generator=gen, device=device)
    params: Dict[str, Any] = {"embed": L.init_embedding(cfg, plan, **kw)}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": L.dense_init(
            (cfg.vocab_size, cfg.d_model), scale=0.02, **kw)}
    stages = tuple(init_stage(cfg, st, plan, **kw)
                   for st in build_stages(cfg))
    params["stages"] = stages
    params["final_norm"] = L._norm_init(cfg.d_model, cfg.norm, device)
    return cast_for_compute(params, cfg)


def embed_inputs(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
                 plan: MeshPlan, dtype=COMPUTE_DTYPE) -> torch.Tensor:
    """Token embedding; like the reference, always computed in bf16."""
    return L.embed_tokens(params["embed"], tokens, plan, dtype)


def model_logits(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                 plan: MeshPlan) -> torch.Tensor:
    """fp32 logits (B, T, V)."""
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return L.output_logits(head, x, plan)


def forward(params: Dict, tokens: torch.Tensor, cfg0: ModelConfig,
            plan: MeshPlan, *, positions: torch.Tensor,
            caches: Optional[Tuple] = None, use_kernel: bool = False,
            token_valid: Optional[torch.Tensor] = None):
    """Full forward.  Returns (hidden (B,T,d), logits (B,T,V), MoEStats,
    new_caches).  ``caches`` (from :func:`init_caches`) are updated in
    place and returned."""
    cfg = _model_cfg(cfg0, plan)
    stages = build_stages(cfg)
    x = embed_inputs(params, tokens, cfg, plan)
    acc = zero_stats(x.device)
    new_caches = []
    for i, st in enumerate(stages):
        c = None if caches is None else caches[i]
        x, stats, c = stage_forward(params["stages"][i], x, cfg, st, plan,
                                    positions, c, use_kernel=use_kernel,
                                    token_valid=token_valid)
        acc = _add_stats(acc, stats)
        new_caches.append(c)
    logits = model_logits(params, x, cfg, plan)
    return x, logits, acc, (None if caches is None else tuple(new_caches))


def init_caches(cfg0: ModelConfig, batch: int, length: int, plan: MeshPlan,
                *, device="cuda"):
    """Per-stage lists of ring-buffer KV caches sized ``length`` (the window
    for sliding attention)."""
    device = resolve_device(device)
    cfg = _model_cfg(cfg0, plan)
    _check_supported(cfg)
    if cfg.attention == "sliding":
        length = min(length, cfg.window)

    def attn_caches(n):
        return [L.init_attention_cache(cfg, batch, length, plan,
                                       device=device) for _ in range(n)]

    out = []
    for st in build_stages(cfg):
        if st.kind == "pair":
            out.append({"dense": attn_caches(st.repeats),
                        "moe": attn_caches(st.repeats)})
        else:
            out.append(attn_caches(st.repeats))
    return tuple(out)
