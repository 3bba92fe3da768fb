"""SMILE's bi-level routing (arXiv:2212.05191, Sec. 3.2), as the plain
reference computes it.

Each token goes in two hops: a node router picks ``top_g`` of ``n`` nodes,
then the node's router picks ``top_k / top_g`` of its ``m`` experts; the
token's output is the sum over the chosen pairs of ``p_node * q_expert *
FFN(x)`` (gates renormalised over the chosen where the config says so).
With a capacity factor (the ``sort`` dispatch) each node takes the first
``ceil(t * top_g * cf / n)`` of its assignments in token order, and each
expert the first ``ceil(cap1 * k / m * cf)`` of what arrived at its node,
in the same order; the rest are dropped.  The balance loss of each hop is
``coef * groups * sum(f * P)`` over the rows that arrived (Eq. 4).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from bench.core import flops as FL
from bench.reference import moe as MOE


def _sizes(e: Dict):
    n = e["grid"][0]
    top_g = e.get("top_g", 1)
    return n, e["num_experts"] // n, top_g, max(1, e["top_k"] // top_g)


def leaves(doc: Dict):
    """The MoE layer's leaves under the block's ``moe``, in draw order."""
    d = doc["model"]["d_model"]
    n, per, _, _ = _sizes(doc["moe"])
    return MOE.expert_leaves(doc) + [
        (("router_inter", "w"), (d, n), d ** -0.5, "fp32"),
        (("router_intra", "w"), (d, per), d ** -0.5, "fp32")]


def router_params(doc: Dict) -> int:
    """Multiply-adds a token spends in the routers."""
    d = doc["model"]["d_model"]
    n, per, _, _ = _sizes(doc["moe"])
    return d * n + d * per


def forward(p: Dict, x: torch.Tensor, m: Dict, e: Dict, quant
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SMILE over tokens x (t, d).  Returns (y (t, d), balance loss)."""
    t, d = x.shape
    n, per_node, top_g, k2 = _sizes(e)
    renorm = e.get("renorm_gates", False)
    capped = e.get("dispatch_backend", "sort") != "dropless"
    # hop 1: nodes
    p1 = torch.softmax(x @ p["router_inter"]["w"].float(), dim=-1)
    g1, n1 = MOE.topk(p1, top_g, renorm)
    lb = MOE.balance_loss(p1, e["lb_alpha"])
    a_tok = torch.arange(t, device=x.device).repeat_interleave(top_g)
    a_node, a_gate = n1.reshape(-1), g1.reshape(-1)
    cap1 = MOE.capacity(t, top_g, e["capacity_factor"], n)
    if capped:
        kept = MOE.rank_in_group(a_node, n) < cap1
        a_tok, a_node, a_gate = a_tok[kept], a_node[kept], a_gate[kept]
    # hop 2: experts of the node, over what arrived (in token order)
    xr = x[a_tok]
    p2 = torch.softmax(xr @ p["router_intra"]["w"].float(), dim=-1)
    lb = lb + MOE.balance_loss(p2, e["lb_beta"])
    g2, e2 = MOE.topk(p2, k2, renorm)
    grp = (a_node[:, None] * per_node + e2).reshape(-1)
    row = torch.arange(xr.shape[0], device=x.device).repeat_interleave(k2)
    gate = g2.reshape(-1)
    if capped:
        cap2 = MOE.capacity(cap1, k2, e["capacity_factor"], per_node)
        kept = MOE.rank_in_group(grp, n * per_node) < cap2
        grp, row, gate = grp[kept], row[kept], gate[kept]
    yr = MOE.expert_ffn(p["experts"], xr, grp, row, gate, per_node,
                        n * per_node, m["act"], quant)
    y = torch.zeros_like(x).index_add(0, a_tok, yr * a_gate[:, None])
    return y, lb


def routing_bounds(doc: Dict, tokens: int) -> Dict[str, float]:
    """The routing kernels' least time over one layer's forward at
    ``tokens`` tokens, and the ``hops`` (calls of each kernel) it makes:
    the node router and sort over the tokens, the expert router and sort
    over the node buffer (``n * cap1`` rows)."""
    d = doc["model"]["d_model"]
    e = doc["moe"]
    n, per, top_g, k2 = _sizes(e)
    cap1 = MOE.capacity(tokens, top_g, e["capacity_factor"], n)
    rows2 = n * cap1
    return {
        "router": (FL.router_fused_bound(tokens, d, n, top_g, 2)
                   + FL.router_fused_bound(rows2, d, per, k2, 2)),
        "sort": (FL.group_sort_bound(tokens * top_g, n + 1)
                 + FL.group_sort_bound(rows2 * k2, n * per + 1)),
        "hops": 2,
    }
