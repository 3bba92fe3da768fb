"""Meta-device stand-ins for every model input: the dry run's fuel.

The port of ``repro.launch.inputs``.  A tensor on the meta device
(``torch.device("meta")``) has a shape and a dtype and no storage, as a
``jax.ShapeDtypeStruct`` has, so nothing here allocates memory: the
parameters, LAMB's state (and ZeRO-1's chunks), the train and prefill
batches and the decode caches are built by the same functions that build
them for a run, asked for the meta device by name.

Each function gives the tensors and their specs (``sharding.specs``).
Without a mesh a leaf is whole, as one device holds it (the caches'
heads already cut by the plan's tp, as :func:`repro_torch.models.
transformer.init_caches` allocates them); with a mesh (a rank of a
``torch.distributed`` world, the dry run's fake one) a leaf is the rank's
slice.  :func:`local` gives a rank's slice of a whole tree from its specs
(``specs.local_shape``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.common.config import InputShape, ModelConfig
from repro_torch.models import transformer as T
from repro_torch.sharding import specs as S
from repro_torch.sharding.plan import MeshPlan

META = torch.device("meta")


def local(tree, spec_tree, sizes):
    """A rank's slice of each leaf of ``tree`` (whole meta tensors) under
    ``spec_tree``: meta tensors of :func:`repro_torch.sharding.specs.
    local_shape` (``sizes``: a plan or a mesh)."""
    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(v, s[k]) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, sv) for v, sv in zip(t, s))
        if t is None:
            return None
        return torch.empty(S.local_shape(tuple(t.shape), s, sizes),
                           dtype=t.dtype, device=META)
    return walk(tree, spec_tree)


def params_struct(cfg: ModelConfig, plan: MeshPlan, mesh=None,
                  dtype: Optional[torch.dtype] = None,
                  compute_cast: bool = False):
    """Meta parameters and their specs: whole, or the rank's slices over
    ``mesh``.  ``compute_cast=False`` (default) is the training form,
    every leaf fp32 as the reference's ``init_model``; ``dtype``
    overrides the floating leaves (``bf16p``: bf16 weights)."""
    params = T.init_model(cfg, plan, device=META, compute_cast=compute_cast,
                          mesh=mesh)
    if dtype is not None:
        params = S.map_tree(lambda _, x: x.to(dtype) if x.is_floating_point()
                            else x, params)
    return params, S.param_specs(params, cfg, plan)


def opt_state_struct(params, cfg: ModelConfig, plan: MeshPlan,
                     zero1: bool = False):
    """LAMB's meta state of ``params`` (its moments, a tensor a piece), or
    under ``zero1`` the ZeRO-1 state (each leaf's flat moment chunk of
    this rank)."""
    if zero1:
        from repro_torch.train.step import zero1_state
        return zero1_state(params, cfg, plan)
    from repro_torch.optim import make_optimizer
    return make_optimizer("lamb").init(params)


def train_batch_struct(cfg: ModelConfig, shape: InputShape, plan: MeshPlan):
    """The global train batch (``tokens``, ``labels``, under K > 1
    codebooks (B, K, S); ``image_embeds`` and ``image_pos`` for image
    inputs) and its specs (the batch dim over dp)."""
    B, S_ = shape.global_batch, shape.seq_len
    i32 = dict(dtype=torch.int32, device=META)
    tok = ((B, cfg.num_codebooks, S_) if cfg.num_codebooks > 1 else (B, S_))
    batch: Dict[str, Any] = {"tokens": torch.empty(tok, **i32),
                             "labels": torch.empty(tok, **i32)}
    if cfg.vision_tokens:
        batch["image_embeds"] = torch.empty(
            (B, cfg.vision_tokens, cfg.vision_embed_dim),
            dtype=torch.float32, device=META)
        batch["image_pos"] = torch.empty((B, cfg.vision_tokens), **i32)
    return batch, S.batch_specs(batch, plan)


def prefill_batch_struct(cfg: ModelConfig, shape: InputShape,
                         plan: MeshPlan):
    """The global prompt tokens (B, S), or (B, K, S), and their spec."""
    B, S_ = shape.global_batch, shape.seq_len
    tok = ((B, cfg.num_codebooks, S_) if cfg.num_codebooks > 1 else (B, S_))
    toks = torch.empty(tok, dtype=torch.int32, device=META)
    return toks, S.batch_specs({"t": toks}, plan)["t"]


def cache_length(cfg: ModelConfig, shape: InputShape) -> int:
    L = shape.seq_len
    if cfg.attention == "sliding":
        L = min(L, cfg.window)
    return L


def rank_batch(batch: int, plan: MeshPlan) -> int:
    """A rank's rows of a global batch: split over dp where it divides
    (``specs.batch_dim_spec``), else every row."""
    return batch // plan.dp if S.batch_dim_spec(batch, plan) else batch


def decode_state_struct(cfg: ModelConfig, shape: InputShape,
                        plan: MeshPlan, rank: bool = False):
    """``(token, caches, step)`` for the decode step, and the specs of the
    token and the caches.  The caches hold ``cache_length`` positions;
    the batch is the global one, or with ``rank`` a rank's rows (the
    caches are the rank's slices then, as ``init_caches`` over a mesh
    allocates them; their specs are the global ones)."""
    B = shape.global_batch
    caches = T.init_caches(cfg, rank_batch(B, plan) if rank else B,
                           cache_length(cfg, shape), plan, device=META)
    cspecs = S.cache_specs(caches, cfg, plan, B)
    tok_shape = (B, cfg.num_codebooks) if cfg.num_codebooks > 1 else (B,)
    tok = torch.empty(tok_shape, dtype=torch.int32, device=META)
    tspec = (S.batch_dim_spec(B, plan),) + (None,) * (len(tok_shape) - 1)
    return (tok, caches, cache_length(cfg, shape) - 1), (tspec, cspecs)


def tree_bytes(tree) -> int:
    """The bytes of every tensor of a tree (nested dicts, lists, tuples,
    NamedTuples; a tensor counted once however often it appears)."""
    seen, total = set(), 0

    def walk(t):
        nonlocal total
        if torch.is_tensor(t):
            if id(t) not in seen:
                seen.add(id(t))
                total += t.numel() * t.element_size()
        elif isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
    walk(tree)
    return total
