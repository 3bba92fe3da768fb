"""ZeRO-1 optimizer-state sharding: the port of ``repro.optim.zero1``.

ZeRO-1 shards LAMB's moments, and the update, over the axes a parameter
leaf is replicated on (its sync axes, ``sharding.specs.shard_axes``)::

  per leaf:  grad --psum_scatter(sync axes)--> the owned 1/P chunk
             moments, direction and owned-chunk update (trust-ratio norms
             psum'd over the sync and shard axes)
             new chunk --all_gather(sync axes)--> the replicated leaf again

The reduce-scatter and the all-gather move what the plain gradient psum
moves, and the moments and the update shrink by the replication factor.
Leaves that are cut over every axis already (the experts on the expert
grid) have no sync axes and keep the in-place chunked LAMB of
:mod:`repro_torch.optim.optimizers`.

The JAX package's leaf stacks a stage's blocks; the port keeps a tensor a
block (:class:`~repro_torch.optim.optimizers.LeafGroup`).  A group's flat
vector is its pieces' gradients flattened and concatenated in block order,
which is the stacked JAX leaf (the rank's slice of it) flattened; it is
padded to a multiple of the sync size ``P`` and cut into ``P`` chunks, and
the rank owns chunk ``axis_index(sync)``, as in the reference, so the
moments equal the reference's chunk for chunk.  The groups that share a
sync-axes tuple go in one reduce-scatter and one all-gather a bucket of at
most :data:`CHUNK` elements, laid out ``(P, sum of chunks)`` so that each
rank receives its own chunk of every leaf (the same sums, element by
element).

The clip sees the reduced gradient, so it lives here too:
:func:`zero1_reduce_and_clip` reduces and computes the clip scale (no
state changes), and :func:`zero1_apply` updates the moments, the owned
chunks and the step clock, so that a step sentinel can skip the apply and
leave the whole :class:`Zero1State` bit-unchanged.  The update runs under
``torch.no_grad`` on the parameters in place; the moments are updated in
place too.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.optim.optimizers import (CHUNK, LeafGroup, _bias_corrections,
                                          _chunks, _direction,
                                          _update_moments, apply_directions,
                                          group_axes, lamb_directions,
                                          leaf_groups, psum_scalars,
                                          trust_rates)
from repro_torch.sharding import comm
from repro_torch.sharding.plan import MeshPlan


class Zero1State(NamedTuple):
    """Per leaf group: its owned flat fp32 chunk of each moment (a group
    with sync axes), or one fp32 tensor a piece (a group without); the
    step clock (the number of applied updates)."""
    m: List
    v: List
    step: int


def _numel(group: LeafGroup) -> int:
    return sum(p.numel() for p in group.pieces)


def _chunk_len(group: LeafGroup, parts: int) -> int:
    return -(-_numel(group) // parts)


def _mesh_order(axes, plan: MeshPlan) -> Tuple[str, ...]:
    return tuple(a for a in plan.all_axes if a in axes)


def _axes(params, sync_axes_tree, norm_axes_tree):
    groups = leaf_groups(params)
    return (groups, group_axes(groups, sync_axes_tree),
            group_axes(groups, norm_axes_tree))


def init_state_shapes(params, sync_axes_tree, norm_axes_tree,
                      plan: MeshPlan) -> Zero1State:
    """Zero moments: a group with sync axes ``S`` holds its owned chunk,
    ``ceil(n / size(S))`` elements of its ``n`` local ones (the rank's
    part of the reference's global flat moment, dim 0 over its shard and
    then its sync axes: ``specs.zero1_spec``); a group without holds one
    tensor a piece."""
    groups, sync, _ = _axes(params, sync_axes_tree, norm_axes_tree)

    def zeros():
        out = []
        for g, s in zip(groups, sync):
            dev = g.pieces[0].device
            if s:
                out.append(torch.zeros(_chunk_len(g, plan.size(s)),
                                       dtype=torch.float32, device=dev))
            else:
                out.append([torch.zeros(p.shape, dtype=torch.float32,
                                        device=dev) for p in g.pieces])
        return out

    return Zero1State(zeros(), zeros(), 0)


def _buckets(groups, sync, plan: MeshPlan) -> List[Tuple[Tuple[str, ...],
                                                         List[int]]]:
    """``[(sync axes, group indices)]``: the groups that share a sync-axes
    tuple, in group order, in runs of at most CHUNK padded elements (a
    larger group alone)."""
    by: Dict[Tuple[str, ...], List[int]] = {}
    for i, s in enumerate(sync):
        if s:
            by.setdefault(s, []).append(i)
    out = []
    for s, idx in by.items():
        P = plan.size(s)
        run: List[int] = []
        size = 0
        for i in idx:
            n = P * _chunk_len(groups[i], P)
            if run and size + n > CHUNK:
                out.append((s, run))
                run, size = [], 0
            run.append(i)
            size += n
        out.append((s, run))
    return out


def _sq(t: torch.Tensor) -> torch.Tensor:
    """The sum of squares of ``t`` in fp32, a chunk at a time."""
    return sum(c.float().square().sum() for c in _chunks(t))


def _own_chunk(group: LeafGroup, idx: int, c: int) -> torch.Tensor:
    """Elements ``[idx * c, (idx + 1) * c)`` of the group's flat vector
    (zero past its end), a fresh fp32 tensor."""
    out = torch.zeros(c, dtype=torch.float32,
                      device=group.pieces[0].device)
    lo, hi, off = idx * c, (idx + 1) * c, 0
    for p in group.pieces:
        a, b = max(lo, off), min(hi, off + p.numel())
        if a < b:
            out[a - lo:b - lo] = p.view(-1)[a - off:b - off]
        off += p.numel()
    return out


@torch.no_grad()
def zero1_reduce_and_clip(params, *, sync_axes_tree, norm_axes_tree,
                          plan: MeshPlan, grad_clip: float = 1.0):
    """Stages 1 and 2 of the ZeRO-1 step: reduce each piece's raw
    ``.grad`` into the owned chunks (and free it; a group without sync
    axes keeps its ``.grad`` tensors) and compute the global clip scale.
    Returns ``(g_own, gnorm, scale)``; nothing is scaled yet and no state
    moves, so a sentinel can judge ``g_own`` and skip
    :func:`zero1_apply`."""
    groups, sync, norm = _axes(params, sync_axes_tree, norm_axes_tree)
    for g in groups:
        for p in g.pieces:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    g_own: List = [None] * len(groups)
    for i, (g, s) in enumerate(zip(groups, sync)):
        if not s:
            g_own[i] = [p.grad for p in g.pieces]
    for s, run in _buckets(groups, sync, plan):
        P = plan.size(s)
        cs = [_chunk_len(groups[i], P) for i in run]
        dev = groups[run[0]].pieces[0].device
        buf = torch.zeros((P, sum(cs)), dtype=torch.float32, device=dev)
        off = 0
        for i, c in zip(run, cs):
            flat = torch.cat([p.grad.reshape(-1).float()
                              for p in groups[i].pieces])
            buf[:, off:off + c] = F.pad(flat, (0, P * c - flat.numel())
                                        ).view(P, c)
            off += c
        own = comm.psum_scatter(buf, s, tiled=False,
                                label="psum_scatter.sync")
        del buf
        off = 0
        for i, c in zip(run, cs):
            g_own[i] = own[off:off + c]
            off += c
            for p in groups[i].pieces:       # spent: the chunk holds it
                p.grad = None
    sq = [_sq(x) if torch.is_tensor(x) else sum(_sq(t) for t in x)
          for x in g_own]
    axes = [_mesh_order(s + n, plan) for s, n in zip(sync, norm)]
    gnorm = torch.stack(psum_scalars(sq, axes)).sum().sqrt()
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    return g_own, gnorm, scale


@torch.no_grad()
def zero1_apply(g_own, scale, state: Zero1State, params, lr, *,
                sync_axes_tree, norm_axes_tree, plan: MeshPlan, b1=0.9,
                b2=0.999, eps=1e-6, weight_decay=0.01, min_trust=0.0,
                max_trust=10.0) -> Zero1State:
    """Stage 3 of the ZeRO-1 step: the moments, LAMB's direction and
    trust ratio and the owned-chunk update over the already-reduced
    ``g_own``, then each group's updated chunks all-gathered back into its
    pieces.  The step clock bumps here, not in the reduce.  Returns the
    new state (the moments are the old ones, updated in place)."""
    groups, sync, norm = _axes(params, sync_axes_tree, norm_axes_tree)
    step = state.step + 1
    bc1, bc2 = _bias_corrections(b1, b2, step)
    moments = {"m": state.m, "v": state.v}
    wns, dns = [], []
    for i, (g, s) in enumerate(zip(groups, sync)):
        decay = weight_decay if g.ndim >= 2 else 0.0
        if s:
            # the direction goes into the chunk's buffer: the gradient is
            # spent once the moments hold it
            p_own = _own_chunk(g, comm.axis_index(s), g_own[i].numel())
            gr = g_own[i].mul_(scale)
            _update_moments(gr, state.m[i], state.v[i], b1, b2)
            gr.copy_(_direction(p_own, state.m[i], state.v[i], bc1, bc2,
                                eps, decay))
            wns.append(p_own.square().sum())
            dns.append(gr.square().sum())
        else:
            wn, dn = lamb_directions(g, moments, i, b1, b2, eps, decay,
                                     bc1, bc2, scale)
            wns.append(wn)
            dns.append(dn)
    axes = [_mesh_order(s + n, plan) for s, n in zip(sync, norm)]
    rates = trust_rates(psum_scalars(wns + dns, axes + axes), lr, min_trust,
                        max_trust)
    for g, s, rate in zip(groups, sync, rates):
        if not s:
            apply_directions(g, rate)
    for s, run in _buckets(groups, sync, plan):
        idx = comm.axis_index(s)
        new = torch.cat([_own_chunk(groups[i], idx, g_own[i].numel())
                         .sub_(g_own[i].mul_(rates[i])) for i in run])
        full = comm.all_gather(new, s, tiled=False,
                               label="all_gather.params")   # (P, sum c)
        del new
        off = 0
        for i in run:
            c = g_own[i].numel()
            flat = full[:, off:off + c].reshape(-1)
            o = 0
            for p in groups[i].pieces:
                p.view(-1).copy_(flat[o:o + p.numel()])
                o += p.numel()
            off += c
    return Zero1State(state.m, state.v, step)


def zero1_lamb_step(params, state: Zero1State, lr, *, sync_axes_tree,
                    norm_axes_tree, plan: MeshPlan, grad_clip: float = 1.0,
                    **kw):
    """One ZeRO-1 LAMB step over each piece's raw ``.grad``:
    :func:`zero1_reduce_and_clip`, then :func:`zero1_apply`.  Returns
    ``(state, gnorm)``; the parameters are updated in place."""
    g_own, gnorm, scale = zero1_reduce_and_clip(
        params, sync_axes_tree=sync_axes_tree, norm_axes_tree=norm_axes_tree,
        plan=plan, grad_clip=grad_clip)
    state = zero1_apply(g_own, scale, state, params, lr,
                        sync_axes_tree=sync_axes_tree,
                        norm_axes_tree=norm_axes_tree, plan=plan, **kw)
    return state, gnorm
