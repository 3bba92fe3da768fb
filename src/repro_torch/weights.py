"""Carry the JAX package's parameters into the port.

``repro.models.transformer.init_model`` returns a tree whose stages stack
their blocks' parameters on a leading ``(repeats, ...)`` axis (for
``lax.scan``).  :func:`params_from_jax` takes that tree with its leaves
already turned into numpy arrays (``jax.tree.map(np.asarray, params)``),
splits every stage into its per-block dicts, and returns the port's
parameters — the same structure :func:`repro_torch.models.transformer.
init_model` returns — so both packages compute the same thing on the same
weights.  ``compute_cast=True`` gives the serving form (the blocks' matmul
weights cast once to the compute dtype); ``False`` the training form (every
parameter fp32, the masters the optimizer updates).

The other way, :func:`params_to_jax` stacks each stage's blocks again, and
:func:`opt_state_to_jax` / :func:`opt_state_from_jax` carry the optimizer
state (LAMB's and AdamW's ``{"m", "v", "step"}``, ZeRO-1's
:class:`~repro_torch.optim.zero1.Zero1State`, whose flat moments are the
reference's global flat arrays) and the sentinel's carry across.  All of
them stand on :func:`state_leaves`, which lists every leaf of the JAX
layout under the key the reference's checkpoints give it (``p/…``,
``o/m/…``, ``o/v/…``, ``x/…``; ``jax.tree_util``'s names: stages by
index, dict keys, NamedTuple and dataclass fields by name), with the
tensors that hold the rank's part of it; over a mesh each is gathered
(``specs.gather_leaf``) or cut (``specs.shard_leaf``) a leaf at a time.
This module imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.config import ModelConfig
from repro_torch.common.device import resolve_device
from repro_torch.models.transformer import (build_stages, cast_for_compute,
                                            _check_supported)
from repro_torch.optim.optimizers import leaf_groups
from repro_torch.optim.zero1 import Zero1State
from repro_torch.sharding import specs as S
from repro_torch.train.sentinel import FIELDS as SENTINEL_FIELDS
from repro_torch.train.sentinel import SentinelState


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C")).to(device)   # a copy


def _tree(t, device, index=None):
    """Nested dicts of arrays -> nested dicts of tensors, optionally taking
    ``[index]`` along each leaf's leading (stacked-block) axes."""
    if isinstance(t, dict):
        return {k: _tree(v, device, index) for k, v in t.items()}
    if t is None:
        return None
    return _tensor(t if index is None else np.asarray(t)[index], device)


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig, *,
                    device="cuda", compute_cast: bool = True
                    ) -> Dict[str, Any]:
    """The JAX parameter tree (numpy leaves) as the port's parameters on
    ``device``: cast for serving, or fp32 for training (``compute_cast=
    False``)."""
    device = resolve_device(device)
    _check_supported(cfg)
    stages = []
    for st, sp in zip(build_stages(cfg), tree["stages"]):
        if st.kind == "pair":
            stages.append({k: [_tree(sp[k], device, r)
                               for r in range(st.repeats)]
                           for k in ("dense", "moe")})
        elif st.kind == "mamba_group":
            # the Mamba2 blocks stacked (R, g, ...); the shared block whole
            g = cfg.ssm_layers_per_attn
            stages.append({
                "mamba": [[_tree(sp["mamba"], device, (r, j))
                           for j in range(g)] for r in range(st.repeats)],
                "shared_attn": _tree(sp["shared_attn"], device)})
        else:
            stages.append({"blocks": [_tree(sp["blocks"], device, r)
                                      for r in range(st.repeats)]})
    params = {k: _tree(v, device) for k, v in tree.items() if k != "stages"}
    params["stages"] = tuple(stages)
    return cast_for_compute(params, cfg) if compute_cast else params


# =============================================================================
# The port's state in the JAX layout
# =============================================================================

class Leaf(NamedTuple):
    """One leaf of the JAX layout: its checkpoint ``key``, the rank's
    ``tensors`` that hold it (a stage's blocks, stacked on the leading
    dims ``stack``, R-major: ``(R,)``, zamba2's ``(R, g)``, or ``()`` for
    a whole leaf), and each tensor's spec over the mesh."""
    key: str
    tensors: List[torch.Tensor]
    specs: List[Tuple]
    stack: Tuple[int, ...]


def _whole(t: torch.Tensor) -> Tuple:
    return (None,) * t.dim()


def state_leaves(params=None, opt_state=None, extra=None, *,
                 cfg: Optional[ModelConfig] = None, mesh=None) -> List[Leaf]:
    """Every leaf of ``params`` (``p/``), of ``opt_state`` (``o/m/``,
    ``o/v/``: LAMB's, AdamW's or ZeRO-1's moments; the step clock is
    :func:`opt_step`'s) and of ``extra`` (``x/``, a
    :class:`~repro_torch.train.sentinel.SentinelState`).  Over a ``mesh``
    (with ``cfg``) each tensor's spec cuts as the parameters do, a ZeRO-1
    flat moment over its shard and then its sync axes; without one every
    tensor is whole.  ``opt_state`` needs its ``params``."""
    out: List[Leaf] = []
    groups = leaf_groups(params) if params is not None else []
    if mesh is not None and groups:
        from repro_torch.sharding.plan import plan_from_mesh
        plan = plan_from_mesh(mesh)
        pspec = S.param_specs(params, cfg, plan)
        sync = S.shard_axes(pspec, plan)
        norm = S.sharded_axes_only(pspec, plan)
        gspec = [g.of(pspec) for g in groups]
        flat_spec = [S.zero1_spec(tuple(g.of(sync)), tuple(g.of(norm)))
                     for g in groups]
    else:
        gspec = [_whole(g.pieces[0]) for g in groups]
        flat_spec = [(None,)] * len(groups)

    def add(prefix, i, ts):
        key = prefix + groups[i].name.replace(".", "/")
        if torch.is_tensor(ts):                 # a ZeRO-1 flat chunk
            out.append(Leaf(key, [ts], [flat_spec[i]], ()))
        else:
            out.append(Leaf(key, list(ts), [gspec[i]] * len(ts),
                            groups[i].stack))

    for i, g in enumerate(groups):
        add("p/", i, g.pieces)
    if opt_state is not None:
        m, v = ((opt_state.m, opt_state.v) if isinstance(opt_state, Zero1State)
                else (opt_state["m"], opt_state["v"]))
        for name, ms in (("m", m), ("v", v)):
            for i in range(len(groups)):
                add(f"o/{name}/", i, ms[i])
    if extra is not None:
        out += [Leaf(f"x/{f}", [getattr(extra, f)], [()], ())
                for f in SENTINEL_FIELDS]
    return out


def opt_step(opt_state) -> int:
    """The optimizer's step clock (``o/step``)."""
    return (opt_state.step if isinstance(opt_state, Zero1State)
            else opt_state["step"])


def with_opt_step(opt_state, step: int):
    """``opt_state`` with its step clock set to ``step`` (a dict in place;
    a new :class:`Zero1State`)."""
    if isinstance(opt_state, Zero1State):
        return opt_state._replace(step=int(step))
    opt_state["step"] = int(step)
    return opt_state


def global_shape(leaf: Leaf, mesh=None) -> Tuple[int, ...]:
    """The leaf's shape in the JAX layout (all of it, over a mesh)."""
    shape = tuple(leaf.tensors[0].shape)
    if mesh is not None:
        shape = tuple(n * (mesh.size(e) if e is not None else 1)
                      for n, e in zip(shape, leaf.specs[0]))
    return tuple(leaf.stack) + shape


def leaf_to_numpy(leaf: Leaf, mesh=None) -> np.ndarray:
    """The whole leaf on the host, its tensors moved there one at a time;
    over a mesh each is gathered first (every rank must call)."""
    parts = []
    for t, spec in zip(leaf.tensors, leaf.specs):
        if mesh is not None:
            t = S.gather_leaf(t, spec, mesh)
        parts.append(t.detach().cpu().numpy())
    if not leaf.stack:
        return parts[0]
    return np.stack(parts).reshape(tuple(leaf.stack) + parts[0].shape)


@torch.no_grad()
def leaf_from_numpy(leaf: Leaf, arr: np.ndarray, mesh=None) -> None:
    """Copy the whole leaf ``arr`` into the rank's tensors (their slices
    of it, over a mesh), cast to their dtypes."""
    parts = (list(arr.reshape((-1,) + arr.shape[len(leaf.stack):]))
             if leaf.stack else [arr])
    for t, spec, a in zip(leaf.tensors, leaf.specs, parts):
        a = torch.from_numpy(np.array(a, order="C"))   # a copy, 0-d kept
        if mesh is not None:
            a = S.shard_leaf(a, spec, mesh)
        t.copy_(a.reshape(t.shape))


def unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """``{"a/0/b": array}`` as nested dicts, a dict whose keys are all
    indices becoming a tuple (JAX's stages)."""
    tree: Dict[str, Any] = {}
    for key, a in flat.items():
        node = tree
        *path, last = key.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = a

    def fix(t):
        if not isinstance(t, dict):
            return t
        if t and all(k.isdigit() for k in t):
            return tuple(fix(t[str(i)]) for i in range(len(t)))
        return {k: fix(v) for k, v in t.items()}
    return fix(tree)


def flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """A JAX-layout tree (nested dicts, tuples and lists, NamedTuples and
    dataclasses; array leaves) as ``{prefix + key: array}`` under
    ``jax.tree_util``'s names."""
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = ((f, getattr(tree, f)) for f in tree._fields)
    elif dataclasses.is_dataclass(tree):
        items = ((f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree))
    elif isinstance(tree, (tuple, list)):
        items = ((str(i), v) for i, v in enumerate(tree))
    elif tree is None:
        return {}
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out: Dict[str, np.ndarray] = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}{k}/"))
    return out


def params_to_jax(params, *, cfg: Optional[ModelConfig] = None,
                  mesh=None) -> Dict[str, Any]:
    """The port's parameters as the JAX package's tree (numpy leaves, each
    stage's blocks stacked, zamba2's Mamba2 blocks twice): the inverse of
    :func:`params_from_jax`.
    Over a mesh (with ``cfg``) each leaf is gathered whole."""
    return unflatten({l.key[2:]: leaf_to_numpy(l, mesh) for l in
                      state_leaves(params, cfg=cfg, mesh=mesh)})


def opt_state_to_jax(state, params=None, *,
                     cfg: Optional[ModelConfig] = None, mesh=None):
    """The optimizer state (a dict ``{"m", "v", "step"}`` or a
    :class:`Zero1State`) as the JAX package's ``{"m": tree, "v": tree,
    "step": int32}`` (a ``Zero1State``'s fields have the same names), or a
    :class:`SentinelState` as ``{field: float32}``.  Over a mesh every
    leaf is gathered whole, ZeRO-1's flat moments to the reference's
    global flat arrays."""
    if isinstance(state, SentinelState):
        return {f: getattr(state, f).detach().cpu().numpy()
                for f in SENTINEL_FIELDS}
    tree = unflatten({l.key[2:]: leaf_to_numpy(l, mesh) for l in
                      state_leaves(params, state, cfg=cfg, mesh=mesh)
                      if l.key.startswith("o/")})
    tree["step"] = np.int32(opt_step(state))
    return tree


def opt_state_from_jax(tree, like, params=None, *,
                       cfg: Optional[ModelConfig] = None, mesh=None):
    """Fill ``like`` (the port's optimizer state, or a
    :class:`SentinelState`) in place from the JAX package's (numpy
    leaves: a dict, a ``Zero1State`` or a ``SentinelState``), each
    tensor its slice over a mesh.  Returns the state (a new
    :class:`Zero1State` where it carries a step)."""
    if isinstance(like, SentinelState):
        flat = flatten(tree, "x/")
        for l in state_leaves(extra=like):
            leaf_from_numpy(l, flat[l.key])
        return like
    flat = flatten(tree, "o/")
    for l in state_leaves(params, like, cfg=cfg, mesh=mesh):
        if l.key.startswith("o/"):
            leaf_from_numpy(l, flat[l.key], mesh)
    return with_opt_step(like, int(flat["o/step"]))
