"""Composable hop-pipeline IR for MoE routing schedules.

The port of ``repro.core.pipeline``.  Switch is ONE flat dispatch hop over
the whole expert grid; SMILE is TWO nested hops (inter-node, then
intra-node on the arrived tokens).  The schedules only *declare* their hops:

* :class:`RouteDecision` — one router's verdict for one hop;
* :class:`HopSpec` — the static schedule of one hop (groups, exchange kind,
  capacity, rank-major relabeling);
* :class:`ExpertHop` — a ``route`` callable bound to its :class:`HopSpec`;
* :func:`execute_pipeline` — the executor both schedules share: route ->
  dispatch -> exchange -> inner compute (the next hop, or the expert FFN) ->
  reverse exchange -> gate-weighted combine, accumulating one
  :class:`MoEStats`.

This slice ports the ``padded`` exchange (the capacity-buffer hop that the
default ``sort`` backend uses) at ``n_ranks == 1``, where the exchange is
the identity.  The ``local`` and ``ragged`` exchanges belong to the dropless
slice and raise here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import dispatch as D
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.sharding import comm

# hop slots in the fixed-shape per-hop vectors (switch uses 1, SMILE 2)
MAX_HOPS = 2
# source-rank bins of MoEStats.wire_faults (kept so stats match the
# reference's shapes; all zero until the wire-integrity layer is ported)
WIRE_SRC_BINS = 16

EXCHANGES = ("local", "padded", "ragged")
WIRE_POLICIES = ("off", "detect", "quarantine")


# =============================================================================
# Layer stats
# =============================================================================

@dataclasses.dataclass
class MoEStats:
    """Aux outputs of a MoE layer (fp32 scalars / fixed-shape vectors), the
    fields of ``repro.core.pipeline.MoEStats``: summed LB and z losses,
    ``drop_frac`` (summed over hops) with its per-hop breakdown, and the
    router-collapse watchdog inputs (max load fraction, normalized load
    entropy per hop).  ``fault_events`` and ``wire_faults`` stay zero until
    fault containment and the wire-integrity layer are ported."""
    lb_loss: torch.Tensor
    z_loss: torch.Tensor
    drop_frac: torch.Tensor
    hop_drop_frac: torch.Tensor     # (MAX_HOPS,)
    fault_events: torch.Tensor      # (MAX_HOPS,)
    hop_max_load: torch.Tensor      # (MAX_HOPS,)
    hop_load_entropy: torch.Tensor  # (MAX_HOPS,)
    wire_faults: torch.Tensor       # (MAX_HOPS, WIRE_SRC_BINS)


def zero_stats(device=None) -> MoEStats:
    z = torch.zeros((), dtype=torch.float32, device=device)
    zv = torch.zeros((MAX_HOPS,), dtype=torch.float32, device=device)
    return MoEStats(z, z.clone(), z.clone(), zv, zv.clone(), zv.clone(),
                    torch.ones((MAX_HOPS,), dtype=torch.float32,
                               device=device),
                    torch.zeros((MAX_HOPS, WIRE_SRC_BINS),
                                dtype=torch.float32, device=device))


# =============================================================================
# Routing losses
# =============================================================================

def lb_loss_terms(probs: torch.Tensor, top1: torch.Tensor,
                  valid: torch.Tensor, num_groups: int, sync_axes
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Globally-averaged (f, P) vectors for one router (paper Eq. 4):
    ``f_i`` the fraction of tokens whose argmax picked group i, ``P_i`` the
    mean router probability on group i."""
    v = valid.float()
    cnt = comm.psum(v.sum(), sync_axes)
    one = F.one_hot(top1.long(), num_groups).float() * v[:, None]
    f = comm.psum(one.sum(0), sync_axes) / torch.clamp(cnt, min=1.0)
    p = comm.psum((probs * v[:, None]).sum(0), sync_axes) / torch.clamp(
        cnt, min=1.0)
    return f, p


def scaled_lb_loss(f: torch.Tensor, p: torch.Tensor,
                   coef: float) -> torch.Tensor:
    """``coef * groups * sum_i f_i P_i`` — min = coef at uniform routing."""
    return coef * f.shape[0] * torch.sum(f * p)


def z_loss(logits: torch.Tensor, valid: torch.Tensor, coef: float,
           sync_axes) -> torch.Tensor:
    if coef == 0.0:
        return torch.zeros((), dtype=torch.float32, device=logits.device)
    lse = torch.logsumexp(logits, dim=-1)
    v = valid.float()
    s = comm.psum((lse.square() * v).sum(), sync_axes)
    cnt = comm.psum(v.sum(), sync_axes)
    return coef * s / torch.clamp(cnt, min=1.0)


# =============================================================================
# Expert FFN (padded capacity layout)
# =============================================================================

def experts_ffn(w: Dict[str, torch.Tensor], x: torch.Tensor, act: str,
                use_kernel: bool = False) -> torch.Tensor:
    """Per-group expert FFN.  ``x``: (G, T, d); weights (G, d, f)/(G, f, d)
    in ``x.dtype`` (the model casts them once at load).

    ``use_kernel=True`` runs the grouped-FFN kernel (fp32 accumulation, one
    bf16 rounding of ``h`` and of the output); ``False`` mirrors the JAX
    package's einsum path, which rounds every product to ``x.dtype``.
    """
    w3 = w.get("w3")
    if use_kernel:
        return kops.grouped_ffn(x.contiguous(), w["w1"], w3, w["w2"], act=act)
    h = ref.activation(torch.bmm(x, w["w1"]), act)
    if w3 is not None:
        h = h * torch.bmm(x, w3)
    return torch.bmm(h, w["w2"])


# =============================================================================
# The IR
# =============================================================================

@dataclasses.dataclass
class RouteDecision:
    """One router's verdict for one hop.  Per-assignment arrays are flat
    ``(A = t * k,)``; assignment ``a`` belongs to token ``a // k``.
    ``group_ids`` are canonical virtual-group ids; the executor applies
    ``spec.perm``."""
    gates: torch.Tensor          # (A,) combine weights
    group_ids: torch.Tensor      # (A,) canonical virtual destination groups
    valid: torch.Tensor          # (A,) assignment validity
    token_valid: torch.Tensor    # (t,) token validity (losses)
    probs: torch.Tensor          # (t, loss_groups)
    logits: torch.Tensor         # (t, loss_groups)
    top1: torch.Tensor           # (t,) router argmax (LB loss f-vector)
    k: int                       # assignments per token


@dataclasses.dataclass
class HopSpec:
    """Static schedule of one dispatch hop (see ``repro.core.pipeline``).
    ``perm`` relabels canonical group ids rank-major; None = identity."""
    name: str
    axes: Tuple[str, ...]
    n_ranks: int
    num_groups: int
    exchange: str
    capacity: int = 0
    perm: Optional[torch.Tensor] = None
    recv_bound_factor: Optional[float] = None
    lb_coef: float = 0.0
    loss_groups: int = 0
    wire_integrity: str = "off"

    def __post_init__(self):
        if self.exchange not in EXCHANGES:
            raise ValueError(f"unknown exchange {self.exchange!r}; "
                             f"expected one of {EXCHANGES}")
        if self.wire_integrity not in WIRE_POLICIES:
            raise ValueError(f"unknown wire_integrity "
                             f"{self.wire_integrity!r}; expected one of "
                             f"{WIRE_POLICIES}")
        if self.num_groups % max(self.n_ranks, 1):
            raise ValueError(f"num_groups {self.num_groups} must fold onto "
                             f"{self.n_ranks} ranks")

    @property
    def groups_per_rank(self) -> int:
        return self.num_groups // max(self.n_ranks, 1)


@dataclasses.dataclass
class ExpertHop:
    """One pipeline stage: ``route(x, token_valid, outer_gid) ->
    RouteDecision`` bound to its hop schedule."""
    route: Callable[[torch.Tensor, torch.Tensor, Optional[torch.Tensor]],
                    RouteDecision]
    spec: HopSpec


# =============================================================================
# Rank-major fold/unfold (padded exchange)
# =============================================================================

def _fold_a2a(buf: torch.Tensor, groups: int, mesh_axes,
              mesh_size: int) -> torch.Tensor:
    """All2All a (groups, ...) buffer over the hop's mesh axes; the
    identity on a size-1 mesh."""
    if mesh_size == 1:
        return buf
    b = groups // mesh_size
    rest = tuple(buf.shape[1:])
    buf = comm.all_to_all(buf.reshape((mesh_size, b) + rest), mesh_axes,
                          split_axis=0, concat_axis=0)
    return buf.reshape((mesh_size * b,) + rest)


def _fold(z: torch.Tensor, spec: HopSpec) -> torch.Tensor:
    """(V, cap, ...) rank-major -> (gpr, P*cap, ...): each local group holds
    the arrivals from every source rank, source-major."""
    P, gpr = spec.n_ranks, spec.groups_per_rank
    rest = tuple(z.shape[1:])
    z = _fold_a2a(z, spec.num_groups, spec.axes, P)
    z = z.reshape((P, gpr) + rest).movedim(1, 0)
    return z.reshape((gpr, P * rest[0]) + rest[1:])


def _unfold(y: torch.Tensor, spec: HopSpec, cap: int) -> torch.Tensor:
    """Reverse exchange: the exact mirror of :func:`_fold`."""
    P, gpr = spec.n_ranks, spec.groups_per_rank
    rest = tuple(y.shape[2:])
    y = y.reshape((gpr, P, cap) + rest).movedim(1, 0)
    y = y.reshape((spec.num_groups, cap) + rest)
    return _fold_a2a(y, spec.num_groups, spec.axes, P)


# =============================================================================
# The executor
# =============================================================================

def _occupancy(st: D.CombineState, A: int, device) -> torch.Tensor:
    """Per-slot occupancy flags mirroring the token dispatch."""
    return D.dispatch_flags(torch.ones((A,), dtype=torch.float32,
                                       device=device), st)


def execute_pipeline(x: torch.Tensor, hops: Sequence[ExpertHop],
                     wsel: Dict[str, torch.Tensor], cfg, *, act: str,
                     use_kernel: bool, sync,
                     token_valid: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, MoEStats]:
    """Run a routing schedule expressed as a hop pipeline.

    ``x``: (t, d) local tokens; ``hops``: outermost-first; ``wsel``: the
    expert weights, (gpr_innermost, d, f) groups in local order; ``cfg``:
    :class:`repro_torch.common.config.MoEConfig`; ``sync``: mesh axes for
    globally-averaged stats.  ``token_valid`` (t,) bool masks top-level
    tokens (None = all valid).  Returns ``(y (t, d), stats)``.
    """
    if len(hops) > MAX_HOPS:
        raise ValueError(f"pipeline has {len(hops)} hops; MAX_HOPS is "
                         f"{MAX_HOPS}")
    if getattr(cfg, "fault_plan", None) is not None:
        raise NotImplementedError("fault injection is not ported yet")
    if cfg.dispatch_backend != "sort":
        raise NotImplementedError(
            f"dispatch_backend={cfg.dispatch_backend!r} is not ported yet "
            f"(the dropless slice brings \"dropless\"); use \"sort\"")
    dev = x.device
    simpl = cfg.sort_impl
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    lb_terms, z_terms = [], []
    hop_drops = [zero] * MAX_HOPS
    hop_maxload = [zero] * MAX_HOPS
    hop_entropy = [torch.ones((), dtype=torch.float32, device=dev)] * MAX_HOPS

    def run_hop(level: int, x: torch.Tensor, token_valid: torch.Tensor,
                outer_gid: Optional[torch.Tensor]) -> torch.Tensor:
        hop = hops[level]
        spec = hop.spec
        innermost = level == len(hops) - 1
        if spec.exchange != "padded":
            raise NotImplementedError(
                f"hop {spec.name!r}: the {spec.exchange!r} exchange belongs "
                f"to the dropless slice and is not ported yet")
        dec = hop.route(x, token_valid, outer_gid)
        A, k = dec.group_ids.shape[0], dec.k
        gid = (dec.group_ids if spec.perm is None
               else spec.perm[dec.group_ids.long()])

        # ---- losses ---------------------------------------------------------
        f, p = lb_loss_terms(dec.probs, dec.top1, dec.token_valid,
                             spec.loss_groups, sync)
        lb_terms.append(scaled_lb_loss(f, p, spec.lb_coef))
        z_terms.append(z_loss(dec.logits, dec.token_valid,
                              cfg.router_z_coef, sync))
        hop_maxload[level] = f.max()
        if spec.loss_groups > 1:
            fr = f / torch.clamp(f.sum(), min=1e-9)
            ent = -torch.sum(fr * torch.log(torch.clamp(fr, min=1e-20)))
            hop_entropy[level] = ent / math.log(spec.loss_groups)

        # ---- padded: fixed-shape capacity buffer ----------------------------
        buf, st = D.dispatch(x, gid, dec.gates, spec.num_groups,
                             spec.capacity, k=k, valid=dec.valid,
                             backend="sort", use_kernel=use_kernel,
                             sort_impl=simpl)
        recv = _fold(buf, spec)                     # (gpr, P*cap, d)
        if innermost:
            out = experts_ffn(wsel, recv, act, use_kernel)
        else:
            gpr, S, d = recv.shape
            x1 = recv.reshape(gpr * S, d)
            valid1 = _fold(_occupancy(st, A, dev), spec).reshape(gpr * S) > 0
            gid1 = torch.arange(gpr, dtype=torch.int32,
                                device=dev).repeat_interleave(S)
            out = run_hop(level + 1, x1, valid1, gid1).reshape(gpr, S, d)
        back = _unfold(out, spec, spec.capacity)
        dropped = comm.psum((dec.valid & ~st.keep).sum().float(), sync)
        total = comm.psum(dec.valid.sum().float(), sync)
        hop_drops[level] = dropped / torch.clamp(total, min=1.0)
        return D.combine(back, st)

    t = x.shape[0]
    if token_valid is None:
        token_valid = torch.ones((t,), dtype=torch.bool, device=dev)
    y = run_hop(0, x, token_valid, None)
    hop_vec = torch.stack(hop_drops)
    stats = MoEStats(sum(lb_terms[1:], lb_terms[0]),
                     sum(z_terms[1:], z_terms[0]),
                     hop_vec.sum(), hop_vec,
                     torch.zeros((MAX_HOPS,), dtype=torch.float32,
                                 device=dev),
                     torch.stack(hop_maxload), torch.stack(hop_entropy),
                     torch.zeros((MAX_HOPS, WIRE_SRC_BINS),
                                 dtype=torch.float32, device=dev))
    return y, stats
