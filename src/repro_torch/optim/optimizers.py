"""Optimizers: the port of ``repro.optim.optimizers`` (LAMB, the paper's,
and AdamW), with the global-norm clip.

The JAX package stacks the blocks of a model stage on a leading axis, so one
of its parameter leaves holds a weight of every block of the stage; the port
keeps one tensor per block.  LAMB's trust ratio and the decision to decay a
weight (``ndim >= 2``) are per JAX leaf, so the port groups the per-block
pieces of one leaf (:func:`leaf_groups`): the norms sum over the pieces, and
a stage's per-block norm scales and biases count as 2-D (stacked), so they
are decayed as in the JAX package (zamba2's twice-stacked Mamba2 vectors,
``A_log``, ``D``, ``dt_bias`` and the norm scales, too; its unstacked
shared block's norm scales are not).

The update runs on the parameters in place, under ``torch.no_grad``, and
reads each piece's ``.grad``; the moments are updated in place too.  Every
elementwise pass goes over flat chunks of at most :data:`CHUNK` elements, so
a stage's stacked expert leaf (3.6 B elements in smile-3.7b) never needs a
full-size temporary: LAMB makes two passes, one for the moments, the
direction and the norms, one that applies the direction.  The direction
goes into the gradient's buffer in place, since the gradient is spent once
the moments hold it; after LAMB's update ``.grad`` holds the applied step.

Over a mesh the parameters are the rank's slices, and ``shard_axes`` (a
tree shaped as the parameters, ``sharding.specs.sharded_axes_only``)
names the axes each leaf is cut over: LAMB's trust-ratio norms and the
clip's squared norms are summed over them, so every slice of a leaf sees
the leaf's global norms.  The scalars that share an axes tuple go in one
psum (the same sums, element by element), not one psum a leaf.
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, Iterator, List, NamedTuple,
                    Tuple)

import numpy as np
import torch

from repro_torch.sharding import comm

CHUNK = 1 << 24


@dataclasses.dataclass
class LeafGroup:
    """The per-block pieces that form one leaf of the JAX parameter tree."""
    name: str
    pieces: List[torch.Tensor]
    ndim: int                   # ndim of the JAX leaf
    where: Tuple = ()           # key path of its first piece in the tree
    stack: Tuple[int, ...] = ()  # the leaf's leading stacked dims

    def of(self, tree):
        """This group's entry in ``tree``, a tree shaped as the parameters
        (a spec or axes tree: one entry serves all the pieces)."""
        return _get(tree, self.where)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif tree is not None:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def leaf_groups(params: Dict) -> List[LeafGroup]:
    """Group the parameters as the JAX package's leaves: one group per
    top-level tensor (embedding, head, final norm), and for each stage one
    group per block parameter holding that parameter of every block (its
    ndim one more than a piece's).  zamba2's ``mamba_group`` stage stacks
    its Mamba2 blocks twice, ``(R, g, ...)``: a group holds all ``R x g``
    pieces, R-major, its ndim two more; its ``shared_attn`` block is
    unstacked, each tensor a group of its own ndim."""
    groups = []
    for key, sub in params.items():
        if key == "stages":
            continue
        for path, t in _leaves(sub, (key,)):
            groups.append(LeafGroup(".".join(path), [t], t.dim(), path))
    for i, stage in enumerate(params.get("stages", ())):
        for kind, blocks in stage.items():
            where = ("stages", i, kind)
            if isinstance(blocks, dict):            # one unstacked block
                for path, t in _leaves(blocks):
                    groups.append(LeafGroup(".".join(map(str, where + path)),
                                            [t], t.dim(), where + path))
                continue
            if not blocks:              # a stage the depth cut left empty
                continue
            stack = (len(blocks),)
            if isinstance(blocks[0], list):         # (R, g) blocks
                stack += (len(blocks[0]),)
                blocks = [b for row in blocks for b in row]
            for path, t in _leaves(blocks[0]):
                groups.append(LeafGroup(
                    ".".join(map(str, where + path)),
                    [_get(b, path) for b in blocks], t.dim() + len(stack),
                    where + (0,) * len(stack) + path, stack))
    return groups


def _chunks(t: torch.Tensor) -> Iterator[torch.Tensor]:
    flat = t.view(-1)
    for i in range(0, flat.numel(), CHUNK):
        yield flat[i:i + CHUNK]


def _grad(p: torch.Tensor) -> torch.Tensor:
    return p.grad if p.grad is not None else torch.zeros_like(p)


def _pieces(group: LeafGroup, state: Dict, gi: int):
    """(p, g, m, v) chunk by chunk over the group's pieces."""
    for p, m, v in zip(group.pieces, state["m"][gi], state["v"][gi]):
        yield from zip(_chunks(p), _chunks(_grad(p)), _chunks(m), _chunks(v))


def group_axes(groups: List[LeafGroup], shard_axes) -> List[Tuple[str, ...]]:
    """Each group's axes in ``shard_axes`` (a tree shaped as the
    parameters; None: no axes)."""
    if shard_axes is None:
        return [()] * len(groups)
    return [tuple(g.of(shard_axes)) for g in groups]


def psum_scalars(vals: List[torch.Tensor], axes: List[Tuple[str, ...]]
                 ) -> List[torch.Tensor]:
    """Each scalar of ``vals`` psum'd over its entry of ``axes``: one psum
    for all the scalars that share an axes tuple."""
    out = list(vals)
    by: Dict[Tuple[str, ...], List[int]] = {}
    for i, a in enumerate(axes):
        if a:
            by.setdefault(a, []).append(i)
    for a, idx in by.items():
        s = comm.psum(torch.stack([vals[i] for i in idx]), a,
                      label="psum.norm")
        for j, i in enumerate(idx):
            out[i] = s[j]
    return out


class Optimizer(NamedTuple):
    init: Callable[[Dict], Any]                 # params -> state
    # (params, state, lr, shard_axes=None) -> state; updates params and
    # state in place from each parameter's .grad
    update: Callable[..., Any]


def _moments_init(params: Dict) -> Dict:
    z = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    groups = leaf_groups(params)
    return {"m": [[z(p) for p in g.pieces] for g in groups],
            "v": [[z(p) for p in g.pieces] for g in groups], "step": 0}


def _bias_corrections(b1: float, b2: float, step: int):
    """``1 - b ** step`` in float32, as the JAX package computes it."""
    f32 = np.float32
    return (float(f32(1) - f32(b1) ** f32(step)),
            float(f32(1) - f32(b2) ** f32(step)))


def _update_moments(g, m, v, b1, b2):
    g = g.float()
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_(g.square().mul_(1 - b2))


def _direction(p, m, v, bc1, bc2, eps, decay):
    d = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
    if decay:
        d.add_(decay * p.float())
    return d


def adamw(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01) -> Optimizer:
    @torch.no_grad()
    def update(params, state, lr, shard_axes=None):
        # elementwise: no norm, so the shard axes play no part
        state["step"] += 1
        bc1, bc2 = _bias_corrections(b1, b2, state["step"])
        for gi, group in enumerate(leaf_groups(params)):
            decay = weight_decay if group.ndim >= 2 else 0.0
            for p, g, m, v in _pieces(group, state, gi):
                _update_moments(g, m, v, b1, b2)
                d = _direction(p, m, v, bc1, bc2, eps, decay)
                p.sub_(d.mul_(lr))
        return state

    return Optimizer(_moments_init, update)


def lamb_directions(group: LeafGroup, state: Dict, gi: int, b1, b2, eps,
                    decay, bc1, bc2, scale=None):
    """LAMB's first pass over one group: each piece's ``.grad`` (scaled by
    ``scale`` first, where given) into the moments, then replaced by the
    direction.  Returns the group's ``(|p|^2, |d|^2)``, fp32 tensors."""
    dev = group.pieces[0].device
    wn = torch.zeros((), dtype=torch.float32, device=dev)
    dn = torch.zeros((), dtype=torch.float32, device=dev)
    for p in group.pieces:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    for p, g, m, v in _pieces(group, state, gi):
        if scale is not None:
            g.mul_(scale)
        _update_moments(g, m, v, b1, b2)
        d = _direction(p, m, v, bc1, bc2, eps, decay)
        wn += p.float().square().sum()
        dn += d.square().sum()
        g.copy_(d)
    return wn, dn


def trust_rates(norms: List[torch.Tensor], lr, min_trust, max_trust
                ) -> List[torch.Tensor]:
    """Each group's ``lr * trust`` from the summed squared norms ``norms``
    (the ``n`` groups' ``|p|^2``, then their ``|d|^2``)."""
    n = len(norms) // 2
    out = []
    for wn, dn in zip(norms[:n], norms[n:]):
        wn, dn = wn.sqrt(), dn.sqrt()
        trust = torch.where((wn > 0) & (dn > 0),
                            torch.clamp(wn / torch.clamp(dn, min=1e-12),
                                        min_trust, max_trust),
                            torch.ones_like(wn))
        out.append(lr * trust)
    return out


def apply_directions(group: LeafGroup, rate) -> None:
    """LAMB's second pass: each piece minus ``rate`` times the direction
    its ``.grad`` holds."""
    for p in group.pieces:
        for pc, dc in zip(_chunks(p), _chunks(p.grad)):
            pc.sub_(dc.mul_(rate))


def lamb(b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.01,
         min_trust=0.0, max_trust=10.0) -> Optimizer:
    """LAMB [You et al. 2019] — the paper's optimizer.  The trust ratio
    ``|p| / |d|`` is taken over each JAX leaf (each :class:`LeafGroup`),
    its norms summed over the leaf's ``shard_axes``.  A first pass over
    every group updates the moments and leaves the direction in ``.grad``;
    after the norms' psums a second pass applies it."""

    @torch.no_grad()
    def update(params, state, lr, shard_axes=None):
        state["step"] += 1
        bc1, bc2 = _bias_corrections(b1, b2, state["step"])
        groups = leaf_groups(params)
        axes = group_axes(groups, shard_axes)
        wns, dns = [], []
        for gi, group in enumerate(groups):
            decay = weight_decay if group.ndim >= 2 else 0.0
            wn, dn = lamb_directions(group, state, gi, b1, b2, eps, decay,
                                     bc1, bc2)
            wns.append(wn)
            dns.append(dn)
        rates = trust_rates(psum_scalars(wns + dns, axes + axes), lr,
                            min_trust, max_trust)
        for group, rate in zip(groups, rates):
            apply_directions(group, rate)
        return state

    return Optimizer(_moments_init, update)


def make_optimizer(name: str, *, weight_decay=0.01, b1=0.9, b2=0.999,
                   eps=1e-6) -> Optimizer:
    if name == "lamb":
        return lamb(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    if name == "adamw":
        return adamw(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    raise ValueError(f"unknown optimizer {name!r}")


@torch.no_grad()
def clip_by_global_norm(params: Dict, max_norm: float,
                        shard_axes=None) -> torch.Tensor:
    """Scale every parameter's ``.grad`` in place so that the global norm is
    at most ``max_norm``; returns the norm before clipping (a tensor).  Each
    leaf's squared norm is summed over its ``shard_axes`` first."""
    groups = leaf_groups(params)
    grads, sq, axes = [], [], []
    for group, a in zip(groups, group_axes(groups, shard_axes)):
        gs = [p.grad for p in group.pieces if p.grad is not None]
        if gs:
            grads += gs
            sq.append(sum(g.float().square().sum() for g in gs))
            axes.append(a)
    total = torch.stack(psum_scalars(sq, axes)).sum().sqrt()
    scale = torch.clamp(max_norm / torch.clamp(total, min=1e-12), max=1.0)
    for g in grads:
        g.mul_(scale)
    return total
