"""Partition specs: how every parameter, cache and batch leaf is cut over
the mesh.

The port of ``repro.sharding.specs``.  A spec is a tuple with one entry a
dim of the leaf: ``None`` (replicated) or the axis name, or tuple of axis
names, the dim is split over (JAX's ``PartitionSpec``).  Rules are keyed
on a leaf's parent key and name and give the spec of its trailing dims;
leading dims are padded with ``None``.  The port's trees keep one dict a
block (no stacked leading axis), so a rule's spec is usually the whole
spec.

:func:`shard_params` cuts this rank's slice out of a full tree: a dim
split over axes ``A`` is cut into ``size(A)`` equal parts and the rank
keeps part ``index(A)``, its linear index over ``A`` in the order named,
as JAX places shards; :func:`gather_leaf` is its inverse.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.sharding.plan import MeshPlan

Spec = Tuple[Any, ...]


def _one(axes: Tuple[str, ...]):
    """A spec entry: None, one axis name, or a tuple of them."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def _expert_spec(cfg: ModelConfig, plan: MeshPlan) -> Tuple:
    from repro_torch.core.layout import make_layout
    from repro_torch.core.moe import _grid
    n_g, m_g = _grid(cfg.moe, plan)
    layout = make_layout(cfg.moe.num_experts, n_g, m_g)
    intra = tuple(plan.ep_intra) if layout.shard_intra else ()
    return (_one(tuple(plan.ep_inter)), _one(intra), None, None)


def rwkv_heads_divide(cfg: ModelConfig, plan: MeshPlan) -> bool:
    """Whether an rwkv time mix's heads (``d_model / head_dim``) divide
    over ``tp``: then they are cut by head, else replicated."""
    return (cfg.rwkv is None
            or (cfg.d_model // cfg.rwkv.head_dim) % max(plan.tp, 1) == 0)


def param_spec_rules(cfg: ModelConfig, plan: MeshPlan
                     ) -> Callable[[Tuple[str, ...], int], Spec]:
    """``rule(path, ndim) -> spec`` for the port's parameter leaves: the
    experts over ``(inter, intra if the layout shards it)``; the
    embedding (each codebook's, under K > 1), the LM head (the codebook
    heads), attention heads (MLA's ``wq_b``, ``wk_b``, ``wv_b`` and
    ``wo``) and dense FFNs over ``tp``; routers, norms, the shared expert,
    MLA's low-rank ``wq_a`` and ``wkv_a``, the vision projection and the
    MTP head's projection replicated.  KV projections stay
    replicated where the KV heads do not divide over ``tp``, and under
    ``kv_seq_shard`` (the cache's sequence dim is the cut one there).  An
    rwkv block's time mix is cut by head (its projections, decay, bonus,
    group norm and output projection) where the heads divide over ``tp``,
    its channel mix Megatron-style over ``d_ff``.  A Mamba2 block is cut
    by head (``wx``, ``wz``, ``wdt`` on the output, ``conv_x``, ``A_log``,
    ``D``, ``dt_bias`` and the gated norm's scale, ``wo`` on the input),
    its B/C projections and convolutions replicated."""
    tp = plan.tp_axis
    kv_ok = (cfg.num_kv_heads % max(plan.tp, 1) == 0
             and not cfg.kv_seq_shard)
    rwkv_tp = tp if rwkv_heads_divide(cfg, plan) else None
    espec = (_expert_spec(cfg, plan)
             if (cfg.moe and cfg.moe.num_experts) else None)

    def base(parent: str, name: str) -> Optional[Tuple]:
        if parent == "embed" and name == "table":
            return (None, tp, None) if cfg.num_codebooks > 1 else (tp, None)
        if parent == "heads" and name == "w":
            return (None, tp, None)
        if parent == "lm_head" and name == "w":
            return (tp, None)
        if parent == "vision_proj":
            return (None, None)
        if parent == "experts":
            return espec
        if parent in ("router", "router_inter", "router_intra"):
            return (None, None)
        if parent == "tmix":
            if name in ("wr", "wk", "wv", "wg"):
                return (None, rwkv_tp, None)
            if name in ("w0", "u"):
                return (rwkv_tp, None)
            if name == "decay_b":
                return (None, rwkv_tp, None)
            if name == "wo":
                return (rwkv_tp, None, None)
            return None          # mu, mix_a, mix_b, decay_a replicated
        if parent == "ln_x":
            return (rwkv_tp, None)
        if parent == "cmix":
            if name == "wk":
                return (None, tp)
            if name == "wv":
                return (tp, None)
            return None          # wr, mu_k, mu_r replicated
        if name == "wq":
            return (None, tp, None)
        if name in ("wk", "wv"):
            return (None, tp if kv_ok else None, None)
        if name == "wo" and parent == "attn":
            return (tp, None, None)
        if name == "bq":
            return (tp, None)
        if name in ("bk", "bv"):
            return (tp if kv_ok else None, None)
        if name in ("wq_a", "wkv_a"):          # MLA's low-rank projections
            return (None, None)
        if name in ("wq_b", "wk_b", "wv_b"):   # MLA's heads
            return (None, tp, None)
        if parent == "shared":
            return None          # runs on token-split shards, replicated
        if name in ("w1", "w3"):
            return (None, tp)
        if name == "w2":
            return (tp, None)
        if parent == "mamba":                  # a Mamba2 block's heads
            if name in ("wx", "wz", "wdt"):
                return (None, tp)
            if name in ("conv_x", "wo"):
                return (tp, None)
            if name in ("A_log", "D", "dt_bias"):
                return (tp,)
            return None          # wB, wC, conv_B, conv_C replicated
        if parent == "norm" and name == "scale":
            return (tp,)         # the Mamba2 gated norm over d_inner
        return None

    def rule(path: Tuple[str, ...], ndim: int) -> Spec:
        parent = path[-2] if len(path) >= 2 else ""
        b = base(parent, path[-1])
        if b is None:
            return (None,) * ndim
        if ndim < len(b):
            raise ValueError(f"{'/'.join(path)}: {ndim} dims, spec {b}")
        return (None,) * (ndim - len(b)) + tuple(b)

    return rule


def map_tree(fn, tree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over the tensor leaves of nested dicts, lists and
    tuples (None stays None), keeping the structure; ``path`` holds the
    keys and indices as strings, as JAX's key paths do."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def param_specs(params, cfg: ModelConfig, plan: MeshPlan):
    """The spec tree of ``params`` (tensors, or anything with ``ndim``)."""
    rule = param_spec_rules(cfg, plan)
    return map_tree(lambda p, x: rule(p, x.ndim), params)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


def _spec_map(fn, specs):
    if isinstance(specs, dict):
        return {k: _spec_map(fn, v) for k, v in specs.items()}
    if isinstance(specs, list) or (isinstance(specs, tuple)
                                   and not _is_spec(specs)):
        return type(specs)(_spec_map(fn, v) for v in specs)
    if specs is None:
        return None
    return fn(specs)


def _used(spec: Spec) -> Tuple[str, ...]:
    out = []
    for e in spec:
        if e is None:
            continue
        out.extend(e if isinstance(e, tuple) else (e,))
    return tuple(out)


def shard_axes(spec_tree, plan: MeshPlan):
    """For each leaf, the mesh axes it is replicated over (the axes its
    gradient is summed over), in mesh order."""
    return _spec_map(lambda s: tuple(a for a in plan.all_axes
                                     if a not in _used(s)), spec_tree)


def sharded_axes_only(spec_tree, plan: MeshPlan):
    """For each leaf, the mesh axes it is cut over (the axes its norms are
    summed over), in mesh order."""
    return _spec_map(lambda s: tuple(a for a in plan.all_axes
                                     if a in _used(s)), spec_tree)


def zero1_spec(sync: Tuple[str, ...], norm: Tuple[str, ...]) -> Spec:
    """The spec of a ZeRO-1 flat moment (``repro.optim.zero1.state_specs``):
    dim 0 over the leaf's shard axes, then its replicated ones (``norm +
    sync``), so each rank's chunk sits at its linear index over them in
    that order."""
    return (_one(tuple(norm) + tuple(sync)),)


# =============================================================================
# Batch / cache specs
# =============================================================================

def batch_dim_spec(batch: int, plan: MeshPlan):
    """The batch dim over the dp axes where it divides, else replicated."""
    if plan.dp_axes and batch % plan.dp == 0:
        return _one(tuple(plan.dp_axes))
    return None


def batch_specs(batch_tree, plan: MeshPlan):
    """Leading (batch) dim over dp, the rest replicated."""
    def one(path, leaf):
        b = leaf.shape[0] if leaf.ndim else 1
        return (batch_dim_spec(b, plan),) + (None,) * max(leaf.ndim - 1, 0)
    return map_tree(one, batch_tree)


def cache_specs(cache_tree, cfg: ModelConfig, plan: MeshPlan, batch: int):
    """Decode caches: the batch dim over dp, the KV heads over tp where
    they divide.  Leaves: ring KV ``k``/``v`` (B, W, KV, hd) and ``pos``
    (W,); paged pools ``pool_k``/``pool_v`` (pages, page, KV, hd), no
    batch dim, and their page ``table``, replicated; MLA's latent
    ``ckv`` (B, W, kvr) and ``kpe`` (B, W, rope), the batch dim only;
    rwkv ``wkv`` (B, nh, hd, hd), its heads over tp where they divide, and
    ``x_prev_*`` (B, 1, d); Mamba2's ``ssm`` (B, nh, hd, ds) and
    ``conv_x`` (B, W, d_inner) over tp by head, ``conv_B``/``conv_C`` (B,
    W, ds) the batch dim only.  Under ``kv_seq_shard`` with tp > 1 the ring's sequence dim is the
    cut one: ``k``/``v`` (B, W / tp, KV, hd) with every KV head, ``pos``
    (W / tp,)."""
    tp = plan.tp_axis
    bspec = batch_dim_spec(batch, plan)
    kv_ok = cfg.num_kv_heads % max(plan.tp, 1) == 0
    seq_shard = cfg.kv_seq_shard and plan.tp > 1
    rwkv_tp = tp if rwkv_heads_divide(cfg, plan) else None

    def one(path, leaf):
        name, nd = path[-1], leaf.ndim
        if name == "pos" and seq_shard:
            return (None,) * (nd - 1) + (tp,)
        if name in ("pos", "table"):
            return (None,) * nd
        if name in ("pool_k", "pool_v"):
            b = (None, None, tp if kv_ok else None, None)
        elif name in ("k", "v"):
            b = ((bspec, tp, None, None) if seq_shard
                 else (bspec, None, tp if kv_ok else None, None))
        elif name == "wkv":
            b = (bspec, rwkv_tp, None, None)
        elif name == "ssm":
            b = (bspec, tp, None, None)
        elif name == "conv_x":
            b = (bspec, None, tp)
        else:
            b = (bspec,) + (None,) * (nd - 1)
        return (None,) * (nd - len(b)) + b

    return map_tree(one, cache_tree)


def engine_step_specs(params, caches, cfg: ModelConfig, plan: MeshPlan
                      ) -> Dict[str, Any]:
    """The specs of the serving engine's steps over a mesh, as the
    reference's ``build_paged_decode_step`` / ``build_paged_prefill`` set
    them: the parameters by :func:`param_specs`; the page pools by
    :func:`cache_specs` at batch 1 (no batch dim: replicated over dp, the
    KV heads over tp where they divide); the per-tick scheduler arrays
    (``tok``, ``pos``, ``live`` (B,) and the page ``table`` (B,
    max_pages)) replicated on every rank; a decode step's logits (B, V)
    vocabulary-cut over tp, its tokens replicated."""
    return {"params": param_specs(params, cfg, plan),
            "caches": cache_specs(caches, cfg, plan, 1),
            "tok": (None,), "pos": (None,), "live": (None,),
            "table": (None, None),
            "next_tok": (None,), "logits": (None, plan.tp_axis)}


def local_shape(shape: Tuple[int, ...], spec: Spec, sizes) -> Tuple[int, ...]:
    """The shape of a rank's slice of a leaf of ``shape`` under ``spec``:
    each cut dim divided by the size of its axes (``sizes``: anything with
    ``size(axes)``, a mesh or a plan)."""
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} for a leaf of {len(shape)} dims")
    out = []
    for n, e in zip(shape, spec):
        k = 1 if e is None else sizes.size(e)
        if n % k:
            raise ValueError(f"dim {n} of {tuple(shape)} does not split over "
                             f"{e} ({k} ranks)")
        out.append(n // k)
    return tuple(out)


# =============================================================================
# Cutting a rank's slice
# =============================================================================

def shard_leaf(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's slice of the full leaf ``x`` under ``spec``: a fresh
    tensor where a dim is cut (the full leaf can be freed), ``x`` itself
    where none is."""
    if len(spec) != x.dim():
        raise ValueError(f"spec {spec} for a leaf of {x.dim()} dims")
    out = x
    for dim, e in enumerate(spec):
        if e is None:
            continue
        n = mesh.size(e)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {e} ({n} ranks)")
        per = x.shape[dim] // n
        out = out.narrow(dim, mesh.index(e) * per, per)
    return out if out is x else out.clone()


def shard_params(full_tree, spec_tree, mesh):
    """This rank's slice of every leaf of ``full_tree`` (params, caches or
    a batch) under the matching ``spec_tree``."""
    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(v, s[k]) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, sv) for v, sv in zip(t, s))
        if t is None:
            return None
        return shard_leaf(t, s, mesh)
    return walk(full_tree, spec_tree)


@torch.no_grad()
def gather_leaf(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The full leaf whose slice under ``spec`` this rank holds in ``x``:
    the inverse of :func:`shard_leaf`.  Each cut dim is all-gathered over
    its axes' group, which orders its ranks in mesh order, and its blocks
    are then put in the spec's own axis order (a dim over ``("model",
    "data")`` is model-major).  Every rank of the mesh must call it."""
    from repro_torch.sharding import comm
    if len(spec) != x.dim():
        raise ValueError(f"spec {spec} for a leaf of {x.dim()} dims")
    out = x
    for dim, e in enumerate(spec):
        if e is None:
            continue
        axes = comm._norm(e)
        order = tuple(a for a in mesh.axes if a in axes)
        parts = comm.all_gather(out.contiguous(), order, axis=dim,
                                tiled=False, label="all_gather.leaf")
        sizes = dict(mesh.axis_sizes)
        perm = [0] * mesh.size(order)
        for j in range(len(perm)):
            c, r = {}, j                 # member j's coordinates over order
            for a in reversed(order):
                c[a] = r % sizes[a]
                r //= sizes[a]
            i = 0                        # its linear index in spec order
            for a in axes:
                i = i * sizes[a] + c[a]
            perm[i] = j
        parts = parts.index_select(dim, torch.tensor(perm,
                                                     device=parts.device))
        out = parts.flatten(dim, dim + 1)
    return out
