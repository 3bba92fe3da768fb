"""Mixture-of-Experts layers with one-hop (Switch) and bi-level (SMILE) routing.

The port of ``repro.core.moe``, the paper's contribution.  Both schedules
are thin definitions over the shared executor
:func:`repro_torch.core.pipeline.execute_pipeline`:

* ``router="switch"`` — one flat hop over the whole ``(n x m)`` expert grid;
* ``router="smile"`` — bi-level routing (paper §3.2): an inter-node router
  ``p(x) in R^n`` picks ``top_g`` nodes, then an intra-node router
  ``q(x) in R^{E/n}`` routes the tokens that *arrived* at each node.  The
  combine weight ``p_i * q_j`` (Eq. 3) falls out of the nested
  gate-weighted combines.

The expert grid is *logical* ``(n, m)`` (``MoEConfig.grid``) and folds onto
the mesh's ``(inter, intra)`` ranks: hop 1 exchanges over ``plan.ep_inter``,
hop 2 over ``plan.ep_intra`` (Switch's one hop over both), each a
``torch.distributed`` All2All, and the identity on one device.  Each rank
holds the experts of its grid slots (:func:`_my_expert_weights`).
``grid=(0, 0)`` derives the grid from the mesh, which on one device is
``(1, 1)``: a SMILE config with ``top_g > 1`` then cannot route
(top-``top_g`` of one node), so single-device serving sets the grid
explicitly.

Capacity semantics follow the paper: per-group capacity
``C = ceil(k * T * capacity_factor / groups)``; overflow tokens are dropped
in arrival order.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.config import MoEConfig
from repro_torch.core import pipeline as PL
from repro_torch.core.layout import ExpertLayout, make_layout
from repro_torch.core.pipeline import MoEStats
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.sharding import comm
from repro_torch.sharding.plan import MeshPlan


# =============================================================================
# Routing math
# =============================================================================

def router_probs(x: torch.Tensor, w: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. 1: softmax router probabilities, computed in fp32.
    Returns ``(probs, logits)``, both (t, E)."""
    logits = x.float() @ w.float()
    return torch.softmax(logits, dim=-1), logits


def topk_gates(probs: torch.Tensor, k: int, renorm: bool
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k expert selection.  Returns (gates (t,k), idx (t,k) int32).

    ``k`` max-extraction rounds, the lowest index winning ties — the order
    ``lax.top_k`` guarantees and ``torch.topk`` does not promise.
    """
    gates, idx = ref.topk_lowest_index(probs, k)
    if renorm and k > 1:
        gates = ref.renorm_gates(gates)
    return gates, idx


def router_topk(x: torch.Tensor, w: torch.Tensor, k: int, renorm: bool,
                impl: str = "unfused"):
    """The routing prologue every hop shares: GEMM -> softmax -> top-k.
    Returns ``(gates (t,k), idx (t,k), probs (t,E), logits (t,E))``.

    ``impl`` is ``MoEConfig.router_impl``: ``"unfused"`` runs the plain
    ops above; ``"fused"`` runs :func:`repro_torch.kernels.ops.router_fused`
    (the fused routing kernel on the card), whose dispatch positions
    (ranks, starts) are dropped here, as in the JAX package.
    """
    if impl == "fused":
        gates, idx, probs, logits, _, _ = kops.router_fused(
            x.contiguous(), w, k, renorm=renorm)
        return gates, idx, probs, logits
    if impl != "unfused":
        raise ValueError(f"unknown router_impl {impl!r}; "
                         f"expected \"unfused\" or \"fused\"")
    probs, logits = router_probs(x, w)
    gates, idx = topk_gates(probs, k, renorm)
    return gates, idx, probs, logits


def capacity(tokens: int, k: int, factor: float, groups: int) -> int:
    return max(1, math.ceil(tokens * k * factor / groups))


# =============================================================================
# Mesh/layout helpers shared by the hop schedules
# =============================================================================

def _sync_axes(plan: MeshPlan) -> Tuple[str, ...]:
    """All mesh axes across which this step's tokens are distinct."""
    return tuple(dict.fromkeys(
        tuple(plan.dp_axes) + tuple(plan.ep_axes) + tuple(plan.tp_axes())))


def _grid(cfg: MoEConfig, plan: MeshPlan) -> Tuple[int, int]:
    n, m = cfg.grid
    if n == 0 or m == 0:
        n, m = max(plan.n_inter, 1), max(plan.n_intra, 1)
    if n % max(plan.n_inter, 1) or m % max(plan.n_intra, 1):
        raise ValueError(f"logical grid {(n, m)} must fold onto mesh grid "
                         f"({plan.n_inter}, {plan.n_intra})")
    return n, m


def _my_expert_weights(w: Dict[str, torch.Tensor], layout: ExpertLayout,
                       plan: MeshPlan, b_n: int, b_m: int):
    """This rank's expert weights as (b_n * owned, d, f) groups.

    Weights are stored (n_g, E_pn, d, f), cut over ``(inter, intra if the
    layout shards it)`` (``sharding.specs``), so the rank's leaf is
    ``(b_n, E_pn_local, d, f)``.  With ``E == n*m*h`` the groups are a
    reshape (a view); for replicated layouts (r > 1) the leaf holds every
    expert of its nodes, and the ones backing this rank's ``b_m`` slots are
    gathered (slot j holds expert j // r).
    """
    out = {}
    if layout.shard_intra:
        for k, v in w.items():
            if v is not None:
                out[k] = v.reshape((-1,) + tuple(v.shape[2:]))
        return out, b_n * w["w1"].shape[1]
    j = comm.axis_index(plan.ep_intra) * b_m
    dev = w["w1"].device
    expert_ids = (j + torch.arange(b_m, device=dev)) // layout.r   # (b_m,)
    for k, v in w.items():
        if v is not None:
            sel = v.index_select(1, expert_ids)             # (b_n, b_m, d, f)
            out[k] = sel.reshape((-1,) + tuple(v.shape[2:]))
    return out, b_n * b_m


def _rank_major_perm(V: int, vpn: int, b_n: int, b_mh: int, m_mesh: int,
                     device=None) -> Optional[torch.Tensor]:
    """Canonical (node-major) virtual-group id -> rank-major id; None when
    it is the identity (always, on one device)."""
    g = np.arange(V)
    node, vin = g // vpn, g % vpn
    rank = (node // b_n) * m_mesh + vin // b_mh
    local = (node % b_n) * b_mh + vin % b_mh
    perm = rank * (b_n * b_mh) + local
    if np.array_equal(perm, g):
        return None
    return torch.as_tensor(perm, dtype=torch.int32, device=device)


def _exchange_kind(cfg: MoEConfig, n_ranks: int, innermost: bool) -> str:
    """Map MoEConfig onto a HopSpec exchange kind (one place, all hops)."""
    if cfg.dispatch_backend != "dropless":
        return "padded"
    if innermost and n_ranks == 1:
        return "local"
    return "ragged" if cfg.ragged_a2a else "padded"


def _repeat(v: torch.Tensor, k: int) -> torch.Tensor:
    return v.repeat_interleave(k) if k > 1 else v


# =============================================================================
# One-hop (Switch) schedule
# =============================================================================

def switch_moe(params: Dict, x: torch.Tensor, cfg: MoEConfig, plan: MeshPlan,
               *, act: str = "gelu", renorm: bool = False,
               use_kernel: bool = False, token_valid=None,
               read_stats=PL.ALL_STATS) -> Tuple[torch.Tensor, MoEStats]:
    """One-hop MoE layer over local tokens ``x``: (t, d) -> (t, d)."""
    t, d = x.shape
    n_g, m_g = _grid(cfg, plan)
    layout = make_layout(cfg.num_experts, n_g, m_g)
    E, k = cfg.num_experts, cfg.top_k
    e_pn = layout.experts_per_node
    vpn = layout.virtual_per_node
    n_mesh, m_mesh = max(plan.n_inter, 1), max(plan.n_intra, 1)
    nm_mesh = plan.ep
    b_n, b_m = n_g // n_mesh, m_g // m_mesh
    b_mh = vpn // m_mesh
    V = layout.virtual_total

    def route(xx, token_valid, outer_gid):
        gates, eidx, probs, logits = router_topk(
            xx, params["router"]["w"], k, renorm, cfg.router_impl)
        e_flat = eidx.reshape(-1)                                   # (A,)
        A = e_flat.shape[0]
        node = e_flat // e_pn
        e_local = e_flat % e_pn
        if layout.r > 1:
            # spread token assignments round-robin over the r replicas
            a = torch.arange(A, device=xx.device)
            rr = (a // k + a % k) % layout.r
            v_in_node = e_local * layout.r + rr
        else:
            v_in_node = e_local
        v = (node * vpn + v_in_node).to(torch.int32)
        return PL.RouteDecision(gates.reshape(-1), v,
                                _repeat(token_valid, k), token_valid,
                                probs, logits, eidx[:, 0], k)

    spec = PL.HopSpec(
        name="flat", axes=plan.ep_axes, n_ranks=nm_mesh, num_groups=V,
        exchange=_exchange_kind(cfg, nm_mesh, innermost=True),
        capacity=capacity(t, k, cfg.capacity_factor, V),
        perm=_rank_major_perm(V, vpn, b_n, b_mh, m_mesh, x.device),
        recv_bound_factor=cfg.recv_bound_factor,
        lb_coef=cfg.lb_alpha, loss_groups=E,
        wire_integrity=cfg.wire_integrity)

    wsel, n_groups = _my_expert_weights(params["experts"], layout, plan,
                                        b_n, b_m)
    if n_groups != spec.groups_per_rank:
        raise ValueError(f"expert groups {n_groups} != hop groups per rank "
                         f"{spec.groups_per_rank}")
    return PL.execute_pipeline(x, [PL.ExpertHop(route, spec)], wsel, cfg,
                               act=act, use_kernel=use_kernel,
                               sync=_sync_axes(plan), token_valid=token_valid,
                               read_stats=read_stats)


# =============================================================================
# Bi-level (SMILE) schedule — the paper's contribution, as a 2-hop pipeline
# =============================================================================

def smile_moe(params: Dict, x: torch.Tensor, cfg: MoEConfig, plan: MeshPlan,
              *, act: str = "gelu", renorm: bool = False, top_g: int = 1,
              use_kernel: bool = False, token_valid=None,
              read_stats=PL.ALL_STATS) -> Tuple[torch.Tensor, MoEStats]:
    """Bi-level MoE layer over local tokens ``x``: (t, d) -> (t, d).

    Hop 1: inter-node router p (t, n).  Hop 2 (hop 1's inner compute):
    intra-node router q on the *arrived* tokens, kept inside the node they
    arrived at.
    """
    t, d = x.shape
    n_g, m_g = _grid(cfg, plan)
    layout = make_layout(cfg.num_experts, n_g, m_g)
    e_pn = layout.experts_per_node
    vpn = layout.virtual_per_node
    k_local = max(1, cfg.top_k // top_g)
    n_mesh, m_mesh = max(plan.n_inter, 1), max(plan.n_intra, 1)
    b_n, b_m = n_g // n_mesh, m_g // m_mesh
    b_mh = vpn // m_mesh
    V2 = b_n * vpn                          # per-device virtual groups, hop 2

    # ---------------- hop 1: route to node -----------------------------------
    def route_inter(xx, token_valid, outer_gid):
        gates, nidx, probs, logits = router_topk(
            xx, params["router_inter"]["w"], top_g, renorm, cfg.router_impl)
        return PL.RouteDecision(gates.reshape(-1), nidx.reshape(-1),
                                _repeat(token_valid, top_g), token_valid,
                                probs, logits, nidx[:, 0], top_g)

    cap1 = capacity(t, top_g, cfg.capacity_factor, n_g)
    spec1 = PL.HopSpec(
        name="inter", axes=plan.ep_inter, n_ranks=n_mesh, num_groups=n_g,
        exchange=_exchange_kind(cfg, n_mesh, innermost=False),
        capacity=cap1, perm=None,           # node ids are already rank-major
        recv_bound_factor=cfg.recv_bound_factor,
        lb_coef=cfg.lb_alpha, loss_groups=n_g,
        wire_integrity=cfg.wire_integrity)

    # ---------------- hop 2: route within node -------------------------------
    def route_intra(x1, valid1, node_row):
        gates, qidx, probs, logits = router_topk(
            x1, params["router_intra"]["w"], k_local, renorm,
            cfg.router_impl)
        q1 = qidx.reshape(-1)                                       # (A2,)
        A2 = q1.shape[0]
        if layout.r > 1:
            rr = torch.arange(A2, device=x1.device) % layout.r
            v_in_node = q1 * layout.r + rr
        else:
            v_in_node = q1
        # per-node virtual groups, node-major (canonical)
        v2 = (_repeat(node_row, k_local) * vpn + v_in_node).to(torch.int32)
        return PL.RouteDecision(gates.reshape(-1), v2,
                                _repeat(valid1, k_local), valid1,
                                probs, logits, qidx[:, 0], k_local)

    if cfg.tight_level2_capacity:
        # beyond-paper: size level-2 capacity from EXPECTED valid arrivals
        # instead of the padded level-1 buffer
        expected = max(1, math.ceil(t * top_g / n_g))
        cap2 = capacity(expected, k_local, cfg.capacity_factor, vpn)
    else:
        cap2 = capacity(n_mesh * cap1, k_local, cfg.capacity_factor, vpn)
    spec2 = PL.HopSpec(
        name="intra", axes=plan.ep_intra, n_ranks=m_mesh, num_groups=V2,
        exchange=_exchange_kind(cfg, m_mesh, innermost=True),
        capacity=cap2,
        perm=_rank_major_perm(V2, vpn, b_n, b_mh, m_mesh, x.device),
        recv_bound_factor=cfg.recv_bound_factor,
        lb_coef=cfg.lb_beta, loss_groups=e_pn,
        wire_integrity=cfg.wire_integrity)

    wsel, n_groups = _my_expert_weights(params["experts"], layout, plan,
                                        b_n, b_m)
    if n_groups != spec2.groups_per_rank:
        raise ValueError(f"expert groups {n_groups} != hop groups per rank "
                         f"{spec2.groups_per_rank}")
    return PL.execute_pipeline(
        x, [PL.ExpertHop(route_inter, spec1), PL.ExpertHop(route_intra, spec2)],
        wsel, cfg, act=act, use_kernel=use_kernel, sync=_sync_axes(plan),
        token_valid=token_valid, read_stats=read_stats)


# =============================================================================
# Parameter init
# =============================================================================

def init_moe_params(cfg: MoEConfig, d_model: int, plan: MeshPlan, *,
                    generator: torch.Generator, glu: bool = False,
                    device=None, expert_dtype=torch.float32) -> Dict:
    """Init MoE layer params from ``generator`` (its numbers differ from
    ``jax.random``; tests carry weights across with ``params_from_jax``).
    Expert tensors are stored (n_g, E_pn, d, f) in ``expert_dtype`` (the
    same bits as casting the fp32 draw); the routers stay fp32."""
    n_g, m_g = _grid(cfg, plan)
    layout = make_layout(cfg.num_experts, n_g, m_g)
    e_pn = layout.experts_per_node
    f = cfg.d_ff_expert
    scale_in = 1.0 / math.sqrt(d_model)
    scale_out = 1.0 / math.sqrt(f)

    def normal(shape, scale, dtype=torch.float32):
        w = torch.randn(shape, generator=generator, device=device)
        return w.mul_(scale).to(dtype)

    experts = {"w1": normal((n_g, e_pn, d_model, f), scale_in, expert_dtype),
               "w2": normal((n_g, e_pn, f, d_model), scale_out, expert_dtype)}
    if glu:
        experts["w3"] = normal((n_g, e_pn, d_model, f), scale_in,
                               expert_dtype)
    p: Dict = {"experts": experts}
    if cfg.router == "smile":
        p["router_inter"] = {"w": normal((d_model, n_g), scale_in)}
        p["router_intra"] = {"w": normal((d_model, e_pn), scale_in)}
    else:
        p["router"] = {"w": normal((d_model, cfg.num_experts), scale_in)}
    return p


def moe_layer(params: Dict, x: torch.Tensor, cfg: MoEConfig, plan: MeshPlan,
              *, act: str = "gelu", use_kernel: bool = False,
              token_valid=None,
              read_stats=PL.ALL_STATS) -> Tuple[torch.Tensor, MoEStats]:
    """Dispatch to the configured routing schedule.  ``x``: (t, d) local
    tokens; ``token_valid`` (t,) bool, optional live-token mask;
    ``read_stats`` the stats fields the caller reads
    (:func:`repro_torch.core.pipeline.execute_pipeline`)."""
    if cfg.router == "smile":
        return smile_moe(params, x, cfg, plan, act=act,
                         renorm=cfg.renorm_gates, top_g=cfg.top_g,
                         use_kernel=use_kernel, token_valid=token_valid,
                         read_stats=read_stats)
    return switch_moe(params, x, cfg, plan, act=act, renorm=cfg.renorm_gates,
                      use_kernel=use_kernel, token_valid=token_valid,
                      read_stats=read_stats)
