"""Model assembly: the port of ``repro.models.transformer``.

A model is a list of *stages*; each stage is a homogeneous stack of blocks.
The JAX package stacks a stage's block parameters on a leading axis and
runs them with ``lax.scan``; here a stage holds a list of per-block
parameter dicts (``{"blocks": [...]}``) and a Python loop runs them.  Caches
follow the same shape: one list of per-block cache dicts per stage.

Stages: ``dense``, ``moe``, the paper's ``pair``, ``rwkv`` (rwkv6-1.6b)
and zamba2's ``mamba_group`` (``{"mamba": R lists of g Mamba2 blocks,
"shared_attn": one dense block}``: each group runs its g Mamba2 blocks,
then the shared block, whose parameters every group uses); attention GQA
or deepseek-v3's latent attention (MLA), with its multi-token-prediction
head (:func:`mtp_logits`); musicgen's codebooks (summed embeddings, a head
per codebook) and phi-3-vision's projected image embeddings.

Parameters are drawn from a seeded ``torch.Generator`` on the target
device (on the CPU for the meta device, the dry run's, which has no
generator and makes no numbers).  Its numbers differ from ``jax.random``'s, which is expected: the
tests carry the JAX package's weights across with
:func:`repro_torch.weights.params_from_jax`.  Parameters are fp32; the
activations are in :func:`compute_dtype` (``ModelConfig.dtype``, bf16 by
default).  The matmul weights of the blocks (attention projections, dense,
shared and expert FFNs, and an rwkv block's time-mix output projection
``tmix.wo``, and a Mamba2 block's projections and convolutions) are used
in the compute dtype, cast in one of two ways:

* serving casts them once at load (:func:`cast_for_compute`, the default of
  :func:`init_model`); the blocks then use them as they are;
* training keeps the fp32 masters (``compute_cast=False``) and runs
  :func:`forward` with ``cast_weights=True``, which casts each block's
  weights at the top of the block, inside its remat region, so only the
  block being run (or recomputed) holds a cast copy.

The reference casts them at every use, which gives the same bits (the
serving form draws each of those weights in the compute dtype, which also
gives the same bits, so a model whose fp32 masters would not fit beside
their cast never holds both).  Router weights, norm scales, the embedding
tables, the LM and codebook heads, the vision projection (cast at its use)
and every other rwkv weight (both mixes compute in fp32) stay fp32.

``remat=True`` (``ModelConfig.remat``, on for training) runs each block
(each group of a ``mamba_group`` stage) under ``torch.utils.checkpoint``
(non-reentrant), as the JAX package wraps its layer-scan body in
``jax.checkpoint``: its activations are recomputed in the backward pass
instead of kept.

Over a mesh (a ``plan_from_mesh`` plan) every rank runs this same code on
its slice of the parameters (``sharding.specs``) and of the batch: tensor
parallelism in attention, the dense FFNs, the embedding and the LM head,
the tokens split over tp before each MoE layer and gathered after it, and
the experts over the SMILE grid; an rwkv or Mamba2 block's heads over
tp; under ``kv_seq_shard`` the ring caches' sequence over tp.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.config import ModelConfig
from repro_torch.common.device import resolve_device
from repro_torch.core.moe import init_moe_params, moe_layer
from repro_torch.core.pipeline import MoEStats, zero_stats
from repro_torch.kernels.ref import activation
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import rwkv6 as RW
from repro_torch.sharding import comm
from repro_torch.sharding import specs as S
from repro_torch.sharding.plan import MeshPlan


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    """The activation dtype of :func:`forward`: ``ModelConfig.dtype``.  The
    reference embeds in bf16 (the default here too); ``dtype="float32"``
    runs the whole model in fp32, which the tests use to hold gradients to
    the reference tightly."""
    return getattr(torch, cfg.dtype)


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


def _check_plan(cfg: ModelConfig, plan: MeshPlan) -> None:
    """rwkv over tp cuts the time mix by head (``sharding.specs``).  Where
    the heads do not divide over tp the reference keeps the time mix
    replicated and still psums its output over tp, which counts it tp
    times; no config of either package has such heads, so the port
    refuses the plan instead."""
    if (plan.tp > 1 and not S.rwkv_heads_divide(cfg, plan)
            and any(st.kind == "rwkv" for st in build_stages(cfg))):
        nh = cfg.d_model // cfg.rwkv.head_dim
        raise ValueError(f"rwkv over tp needs its {nh} heads to divide "
                         f"over {plan.tp} ranks")


def _check_supported(cfg: ModelConfig) -> None:
    stages = build_stages(cfg)
    attention_free = all(st.kind == "rwkv" for st in stages)
    if not (cfg.attention in ("full", "sliding", "mla")
            or (cfg.attention == "none" and attention_free)):
        raise NotImplementedError(f"attention={cfg.attention!r} is not "
                                  f"ported yet")


# =============================================================================
# Block init / forward
# =============================================================================

def init_block(cfg: ModelConfig, kind: str, plan: MeshPlan, *,
               generator: torch.Generator, device=None,
               dtype=torch.float32) -> Dict:
    """One block's parameters; the matmul weights that :func:`cast_block`
    casts are stored in ``dtype`` (the same bits as casting them after an
    fp32 draw), an rwkv block's in fp32."""
    d = cfg.d_model
    kw = dict(generator=generator, device=device)
    if kind == "rwkv":
        # both norms are LayerNorms whatever cfg.norm says, as the reference
        return {
            "ln1": L._norm_init(d, "layernorm", device),
            "tmix": RW.init_rwkv_tmix(cfg, **kw),
            "ln2": L._norm_init(d, "layernorm", device),
            "cmix": RW.init_rwkv_cmix(cfg, **kw),
        }
    if kind == "mamba":
        return {"ln1": L._norm_init(d, cfg.norm, device),
                "mamba": M2.init_mamba2(cfg, dtype=dtype, **kw)}
    if kind not in ("dense", "moe"):
        raise NotImplementedError(f"{kind!r} blocks are not ported yet")
    init_attn = L.init_mla if cfg.attention == "mla" else L.init_attention
    p = {
        "ln1": L._norm_init(d, cfg.norm, device),
        "attn": init_attn(cfg, dtype=dtype, **kw),
        "ln2": L._norm_init(d, cfg.norm, device),
    }
    if kind == "dense":
        p["ffn"] = L.init_ffn(cfg, dtype=dtype, **kw)
    else:
        p["moe"] = init_moe_params(cfg.moe, d, plan, glu=cfg.glu, **kw,
                                   expert_dtype=dtype)
        if cfg.moe.num_shared_experts:
            p["shared"] = L.init_ffn(
                cfg, cfg.moe.num_shared_experts * cfg.moe.d_ff_expert,
                dtype=dtype, **kw)
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


def _attn_fwd(p, x, cfg, plan, positions, cache, use_kernel):
    """The block's attention on its normed input: latent attention under
    ``attention="mla"`` (which, as the reference's, never takes the flash
    kernel), else GQA."""
    window = cfg.window if cfg.attention == "sliding" else 0
    if cfg.attention == "mla":
        return L.mla_forward(p, x, cfg, plan, positions=positions,
                             cache=cache, window=window)
    return L.attention_forward(p, x, cfg, plan, positions=positions,
                               cache=cache, window=window,
                               use_kernel=use_kernel)


def dense_block(p, x, cfg, plan, positions, cache, *, use_kernel=False,
                token_valid=None):
    h, cache = _attn_fwd(p["attn"], L.apply_norm(p["ln1"], x, cfg.norm),
                         cfg, plan, positions, cache, use_kernel)
    x = x + h
    x = x + L.ffn_forward(p["ffn"], L.apply_norm(p["ln2"], x, cfg.norm),
                          cfg, plan)
    return x, zero_stats(x.device), cache


def moe_block(p, x, cfg, plan, positions, cache, *, use_kernel=False,
              token_valid=None):
    h, cache = _attn_fwd(p["attn"], L.apply_norm(p["ln1"], x, cfg.norm),
                         cfg, plan, positions, cache, use_kernel)
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


def rwkv_block(p, x, cfg, plan, positions, cache, *, use_kernel=False,
               token_valid=None):
    h, cache = RW.rwkv_tmix_forward(p["tmix"],
                                    L.apply_norm(p["ln1"], x, "layernorm"),
                                    cfg, plan, cache=cache,
                                    use_kernel=use_kernel)
    x = x + h
    h, cache = RW.rwkv_cmix_forward(p["cmix"],
                                    L.apply_norm(p["ln2"], x, "layernorm"),
                                    cfg, plan, cache=cache)
    return x + h, zero_stats(x.device), cache


def mamba_block(p, x, cfg, plan, cache):
    """``x + mamba2_forward(ln1(x))`` and the cache: no kernel, whatever
    the caller's ``use_kernel``, as the reference's (its Mamba2 ignores
    it), and no routing statistics."""
    h, cache = M2.mamba2_forward(p["mamba"],
                                 L.apply_norm(p["ln1"], x, cfg.norm),
                                 cfg, plan, cache=cache)
    return x + h, cache


BLOCK_FNS = {"dense": dense_block, "moe": moe_block, "rwkv": rwkv_block}


def init_stage(cfg: ModelConfig, stage: Stage, plan: MeshPlan, *,
               generator: torch.Generator, device=None,
               dtype=torch.float32, cut=lambda block: block) -> Dict:
    """The stage's blocks (their matmul weights in ``dtype``,
    :func:`init_block`), each passed through ``cut`` as soon as it is
    drawn (:func:`init_model` cuts a rank's slice there).  A
    ``mamba_group`` stage: ``R`` lists of ``g`` Mamba2 blocks and the one
    shared dense block."""
    kw = dict(generator=generator, device=device, dtype=dtype)
    R = stage.repeats
    if stage.kind == "mamba_group":
        g = cfg.ssm_layers_per_attn
        return {"mamba": [[cut(init_block(cfg, "mamba", plan, **kw))
                           for _ in range(g)] for _ in range(R)],
                "shared_attn": cut(init_block(cfg, "dense", plan, **kw))}
    if stage.kind == "pair":
        return {"dense": [cut(init_block(cfg, "dense", plan, **kw))
                          for _ in range(R)],
                "moe": [cut(init_block(cfg, "moe", plan, **kw))
                        for _ in range(R)]}
    return {"blocks": [cut(init_block(cfg, stage.kind, plan, **kw))
                       for _ in range(R)]}


def cast_block(p: Dict, dt: torch.dtype) -> Dict:
    """One block's matmul weights (attention, dense, shared and expert FFNs)
    cast to ``dt``; router weights and norm scales are left as they are.
    An rwkv block casts only ``tmix.wo``: the reference computes both mixes
    in fp32 from fp32 weights and casts that one at its use.  A Mamba2
    block casts its projections and convolutions (``mamba2.CAST``), not
    ``A_log``, ``D``, ``dt_bias`` or its norms.  A no-op on weights
    already in ``dt``."""
    p = dict(p)
    if "tmix" in p:
        p["tmix"] = {**p["tmix"], "wo": p["tmix"]["wo"].to(dt)}
        return p
    if "mamba" in p:
        p["mamba"] = {k: v.to(dt) if k in M2.CAST else v
                      for k, v in p["mamba"].items()}
        return p
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


def stage_forward(params: Dict, x, cfg: ModelConfig, stage: Stage,
                  plan: MeshPlan, positions, caches, *, remat: bool = False,
                  use_kernel: bool = False, token_valid=None,
                  cast_weights: bool = False):
    """Run the stage's blocks in order (a loop in place of ``lax.scan``).
    ``caches``: None or a list of per-block caches (a ``mamba_group``
    stage's: per group, :func:`init_caches`).  With ``remat`` (and
    autograd recording) each block runs under ``torch.utils.checkpoint``;
    with ``cast_weights`` each block casts its fp32 weights to the
    activation dtype first, inside that region.  Returns
    ``(x, stats, caches)``."""
    remat = remat and torch.is_grad_enabled()

    def run(kind, blocks, x, caches):
        fn = BLOCK_FNS[kind]

        def body(p, x, c):
            if cast_weights:
                p = cast_block(p, x.dtype)
            return fn(p, x, cfg, plan, positions, c, use_kernel=use_kernel,
                      token_valid=token_valid)

        acc = zero_stats(x.device)
        new = []
        for i, p in enumerate(blocks):
            c = None if caches is None else caches[i]
            if remat:
                x, stats, c = checkpoint(body, p, x, c, use_reentrant=False)
            else:
                x, stats, c = body(p, x, c)
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
    if stage.kind == "mamba_group":
        return _mamba_groups(params, x, cfg, plan, positions, caches,
                             remat=remat, cast_weights=cast_weights)
    return run(stage.kind, params["blocks"], x, caches)


def _mamba_groups(params, x, cfg, plan, positions, caches, *, remat,
                  cast_weights):
    """A ``mamba_group`` stage: each group's ``g`` Mamba2 blocks, then the
    shared dense block with ``use_kernel=False``, as the reference runs it
    whatever the caller asks.  With ``remat`` the checkpoint wraps a whole
    group, as the reference's ``jax.checkpoint`` wraps its group body; with
    ``cast_weights`` the group's blocks and the shared block are cast
    inside it.  Neither block routes, so the stats stay zero."""

    def group(blocks, shared, x, c):
        if cast_weights:
            blocks = [cast_block(p, x.dtype) for p in blocks]
            shared = cast_block(shared, x.dtype)
        mc = []
        for i, p in enumerate(blocks):
            x, ci = mamba_block(p, x, cfg, plan,
                                None if c is None else c["mamba"][i])
            mc.append(ci)
        x, _, ac = dense_block(shared, x, cfg, plan, positions,
                               None if c is None else c["attn"])
        return x, (None if c is None else {"mamba": mc, "attn": ac})

    new = []
    for r, blocks in enumerate(params["mamba"]):
        c = None if caches is None else caches[r]
        if remat:
            x, c = checkpoint(group, blocks, params["shared_attn"], x, c,
                              use_reentrant=False)
        else:
            x, c = group(blocks, params["shared_attn"], x, c)
        new.append(c)
    return x, zero_stats(x.device), (None if caches is None else new)


# =============================================================================
# Whole model
# =============================================================================

def map_blocks(fn, blocks):
    """``fn`` over the block dicts of a stage's entry: a list of blocks,
    ``mamba_group``'s lists of lists, or one block (its ``shared_attn``),
    keeping the structure."""
    if isinstance(blocks, list):
        return [map_blocks(fn, b) for b in blocks]
    return fn(blocks)


def cast_for_compute(params: Dict, cfg: ModelConfig) -> Dict:
    """Every block's matmul weights (the MTP head's block and projection
    too) cast to :func:`compute_dtype` once (the serving form), in place of
    the reference's cast at every use (same bits).  Router weights, norm
    scales, the embedding tables, the LM and codebook heads and the vision
    projection are left as they are."""
    dt = compute_dtype(cfg)
    out = dict(params)
    out["stages"] = tuple({k: map_blocks(lambda b: cast_block(b, dt), v)
                           for k, v in st.items()}
                          for st in params["stages"])
    if "mtp" in params:
        out["mtp"] = {**params["mtp"], "proj": params["mtp"]["proj"].to(dt),
                      "block": cast_block(params["mtp"]["block"], dt)}
    return out


def draw_generator(device: torch.device, seed: int) -> torch.Generator:
    """The seeded generator parameters are drawn from: on ``device``, or
    on the CPU for the meta device, which has none (a draw onto meta takes
    a CPU generator and makes no numbers)."""
    dev = torch.device("cpu") if device.type == "meta" else device
    return torch.Generator(device=dev).manual_seed(seed)


def init_model(cfg0: ModelConfig, plan: MeshPlan, *, seed: int = 0,
               device="cuda", compute_cast: bool = True,
               mesh=None) -> Dict:
    """Random parameters from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (the card unless the caller asks for the CPU; raises when
    the card is asked for and there is none).  ``compute_cast=True`` (the
    serving form) gives the blocks' matmul weights in the compute dtype,
    drawn fp32 and cast leaf by leaf as they are drawn (the bits of
    :func:`cast_for_compute` on the fp32 draw, without holding both);
    ``False`` keeps every parameter fp32 (the training form).

    The leaves are the reference's: ``embed`` (a table (V, d), or (K, V,
    d) under K > 1 codebooks, with ``heads`` (K, V, d) in place of
    ``lm_head``), ``vision_proj`` for image inputs, the stages, the final
    norm, and deepseek-v3's ``mtp`` head (``proj`` (2d, d), one dense
    ``block``, ``norm_h`` and ``norm_e``; a block of its own, not stacked
    with a stage's).

    With ``mesh`` (and its plan) each rank draws every leaf whole, the same
    numbers as one device draws under the same plan, and keeps only its
    slice (``sharding.specs``): the embedding and the heads are cut as
    drawn, each block as soon as it is made, so a rank never holds more
    than one full block."""
    device = resolve_device(device)
    cfg = _model_cfg(cfg0, plan)
    _check_supported(cfg)
    _check_plan(cfg, plan)
    rule = S.param_spec_rules(cfg, plan)

    def cut(tree, prefix=()):
        if mesh is None:
            return tree
        return S.shard_params(tree, S.map_tree(
            lambda p, x: rule(prefix + p, x.ndim), tree), mesh)
    gen = draw_generator(device, seed)
    kw = dict(generator=gen, device=device)
    block_dtype = compute_dtype(cfg) if compute_cast else torch.float32
    d, V, K = cfg.d_model, cfg.vocab_size, cfg.num_codebooks
    params: Dict[str, Any] = {}
    if K > 1:
        params["embed"] = cut({"table": L.dense_init(
            (K, V, d), scale=0.02, **kw)}, ("embed",))
        params["heads"] = cut({"w": L.dense_init(
            (K, V, d), scale=0.02, **kw)}, ("heads",))
    else:
        params["embed"] = cut(L.init_embedding(cfg, plan, **kw), ("embed",))
        if not cfg.tie_embeddings:
            params["lm_head"] = cut({"w": L.dense_init(
                (V, d), scale=0.02, **kw)}, ("lm_head",))
    if cfg.vision_tokens:
        params["vision_proj"] = {"w": L.dense_init(
            (cfg.vision_embed_dim, d), **kw)}
    params["stages"] = tuple(
        init_stage(cfg, st, plan, cut=cut, dtype=block_dtype, **kw)
        for st in build_stages(cfg))
    params["final_norm"] = L._norm_init(d, cfg.norm, device)
    if cfg.mtp_depth:
        params["mtp"] = {
            "proj": L.dense_init((2 * d, d), dtype=block_dtype, **kw),
            "block": cut(init_block(cfg, "dense", plan, dtype=block_dtype,
                                    **kw), ("mtp", "block")),
            "norm_h": L._norm_init(d, cfg.norm, device),
            "norm_e": L._norm_init(d, cfg.norm, device),
        }
    return cast_for_compute(params, cfg) if compute_cast else params


def embed_inputs(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
                 plan: MeshPlan, extra: Optional[Dict] = None
                 ) -> torch.Tensor:
    """Token (and modality) embedding in :func:`compute_dtype`.

    Under K > 1 codebooks (musicgen) ``tokens`` is (B, K, S): each
    codebook's ids read its own table (the rank's vocabulary slice, an id
    outside it reading zeros), summed over K in fp32, psum'd over tp, then
    cast.  With image inputs (phi-3-vision) ``extra`` holds
    ``image_embeds`` (B, P, E), projected in the compute dtype, and
    ``image_pos`` (B, P), the positions of each row they are written at
    (over the token embeddings there)."""
    dt = compute_dtype(cfg)
    if cfg.num_codebooks > 1:
        table = params["embed"]["table"]                 # (K, V_loc, d)
        K, v_loc = table.shape[0], table.shape[1]
        local = tokens.long() - comm.axis_index(plan.tp_axis) * v_loc
        hit = (local >= 0) & (local < v_loc)             # (B, K, S)
        book = torch.arange(K, device=tokens.device)[None, :, None]
        emb = table[book, local.clamp(0, v_loc - 1)]     # (B, K, S, d)
        emb = emb * hit[..., None].to(table.dtype)
        return comm.psum(emb.sum(1), plan.tp_axis).to(dt)
    x = L.embed_tokens(params["embed"], tokens, plan, dt)
    if cfg.vision_tokens and extra is not None and "image_embeds" in extra:
        proj = extra["image_embeds"].to(dt) @ params["vision_proj"]["w"].to(dt)
        pos = extra["image_pos"].long()[..., None].expand(-1, -1, x.shape[-1])
        x = x.scatter(1, pos, proj)
    return x


def model_logits(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                 plan: MeshPlan) -> torch.Tensor:
    """fp32 logits of the rank's vocabulary: (B, T, V_loc), or (B, T, K,
    V_loc) under K > 1 codebooks (a head per codebook)."""
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    if cfg.num_codebooks > 1:
        return torch.einsum("btd,kvd->btkv", x.float(),
                            params["heads"]["w"].float())
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return L.output_logits(head, x, plan)


def forward(params: Dict, tokens: torch.Tensor, cfg0: ModelConfig,
            plan: MeshPlan, *, positions: torch.Tensor,
            caches: Optional[Tuple] = None, extra: Optional[Dict] = None,
            remat: bool = False, use_kernel: bool = False,
            token_valid: Optional[torch.Tensor] = None,
            cast_weights: bool = False):
    """Full forward.  Returns (hidden (B,T,d), logits (B,T,V) or (B,T,K,V),
    MoEStats, new_caches).  ``tokens`` (B, T), or (B, K, T) under K > 1
    codebooks; ``extra`` the image inputs (:func:`embed_inputs`).
    ``caches`` (from :func:`init_caches`, or the paged pools
    of ``serve.kvcache`` with their page tables) are updated in place and
    returned.  ``positions``: (T,) shared, or (B, T) per row (the paged
    cache; -1 marks a dead row).  ``token_valid`` (B, T) bool, optional:
    the live-token mask of a decode tick or a padded prefill chunk; only the
    MoE blocks read it (invalid tokens route nowhere and leave the router
    losses).  ``remat`` and ``cast_weights`` as in
    :func:`stage_forward` (training passes both)."""
    cfg = _model_cfg(cfg0, plan)
    _check_plan(cfg, plan)
    stages = build_stages(cfg)
    x = embed_inputs(params, tokens, cfg, plan, extra)
    acc = zero_stats(x.device)
    new_caches = []
    for i, st in enumerate(stages):
        c = None if caches is None else caches[i]
        x, stats, c = stage_forward(params["stages"][i], x, cfg, st, plan,
                                    positions, c, remat=remat,
                                    use_kernel=use_kernel,
                                    token_valid=token_valid,
                                    cast_weights=cast_weights)
        acc = _add_stats(acc, stats)
        new_caches.append(c)
    logits = model_logits(params, x, cfg, plan)
    return x, logits, acc, (None if caches is None else tuple(new_caches))


def mtp_logits(params: Dict, hidden: torch.Tensor, next_tokens: torch.Tensor,
               cfg0: ModelConfig, plan: MeshPlan,
               positions: torch.Tensor) -> torch.Tensor:
    """deepseek-v3's multi-token-prediction head (depth 1): predicts token
    t+2 from the final hidden state at t (before the final norm) and the
    embedding of token t+1.  Returns the rank's fp32 logits (B, T, V_loc).
    The head's weights are cast to the hidden state's dtype at their use
    (a no-op in the serving form); it runs no kernel and no cache."""
    cfg = _model_cfg(cfg0, plan)
    p = params["mtp"]
    e = L.embed_tokens(params["embed"], next_tokens, plan, hidden.dtype)
    h = torch.cat([L.apply_norm(p["norm_h"], hidden, cfg.norm),
                   L.apply_norm(p["norm_e"], e, cfg.norm)], dim=-1)
    h = h @ p["proj"].to(h.dtype)
    h, _, _ = dense_block(cast_block(p["block"], h.dtype), h, cfg, plan,
                          positions, None)
    return model_logits(params, h, cfg, plan)


def paged_cache_supported(cfg: ModelConfig) -> bool:
    """The serving engine's arch gate (the reference's, in
    ``repro.serve.engine.Engine``): a causal model of one token stream with
    GQA attention, full or sliding, and no recurrent state.  MLA, SSM and
    RWKV stages keep state the page pool does not hold."""
    return (cfg.causal and cfg.num_codebooks == 1
            and cfg.attention in ("full", "sliding")
            and cfg.arch_type not in ("ssm", "hybrid"))


def init_caches(cfg0: ModelConfig, batch: int, length: int, plan: MeshPlan,
                *, device="cuda"):
    """Per-stage lists of per-block caches: ring-buffer KV caches sized
    ``length`` (the window for sliding attention; MLA's latent cache,
    :func:`repro_torch.models.layers.init_mla_cache`), or an rwkv block's
    state and last tokens (no length); a ``mamba_group`` stage a dict a
    group, ``{"mamba": g Mamba2 caches, "attn": the shared block's ring
    cache}`` (:func:`repro_torch.models.mamba2.init_mamba2_cache`).  Over
    a mesh ``batch`` is the rank's own, and each cache is allocated at
    the rank's slice of the global cache
    (``sharding.specs.cache_specs``): its KV heads, or under
    ``kv_seq_shard`` its ``length / tp`` ring slots, or its rwkv or Mamba2
    heads."""
    device = resolve_device(device)
    cfg = _model_cfg(cfg0, plan)
    _check_supported(cfg)
    _check_plan(cfg, plan)
    if cfg.attention == "sliding":
        length = min(length, cfg.window)

    def attn_caches(n):
        if cfg.attention == "mla":
            return [L.init_mla_cache(cfg, batch, length, plan, device=device)
                    for _ in range(n)]
        return [L.init_attention_cache(cfg, batch, length, plan,
                                       device=device) for _ in range(n)]

    out = []
    for st in build_stages(cfg):
        if st.kind == "rwkv":
            out.append([RW.init_rwkv_cache(cfg, batch, plan, device=device)
                        for _ in range(st.repeats)])
        elif st.kind == "mamba_group":
            g = cfg.ssm_layers_per_attn
            out.append([{"mamba": [M2.init_mamba2_cache(cfg, batch, plan,
                                                        device=device)
                                   for _ in range(g)],
                         "attn": attn_caches(1)[0]}
                        for _ in range(st.repeats)])
        elif st.kind == "pair":
            out.append({"dense": attn_caches(st.repeats),
                        "moe": attn_caches(st.repeats)})
        else:
            out.append(attn_caches(st.repeats))
    return tuple(out)
