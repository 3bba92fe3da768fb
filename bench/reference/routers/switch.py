"""Flat top-k routing (Switch, arXiv:2101.03961; top-k over all experts
with gates renormalised where the config says so), as the plain reference
computes it: the one-hop baseline the SMILE paper measures against.

One router scores all ``E`` experts; each token goes to its ``top_k``.
With a capacity factor (the ``sort`` dispatch) each expert takes the first
``ceil(t * k * cf / E)`` of its assignments in token order; the rest are
dropped.  The balance loss is ``coef * E * sum(f * P)``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from bench.core import flops as FL
from bench.reference import moe as MOE


def leaves(doc: Dict):
    """The MoE layer's leaves under the block's ``moe``, in draw order."""
    d = doc["model"]["d_model"]
    E = doc["moe"]["num_experts"]
    return MOE.expert_leaves(doc) + [
        (("router", "w"), (d, E), d ** -0.5, "fp32")]


def router_params(doc: Dict) -> int:
    return doc["model"]["d_model"] * doc["moe"]["num_experts"]


def forward(p: Dict, x: torch.Tensor, m: Dict, e: Dict, quant
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over tokens x (t, d).  Returns (y (t, d), balance loss)."""
    t, d = x.shape
    E, k = e["num_experts"], e["top_k"]
    per_node = E // e["grid"][0]
    probs = torch.softmax(x @ p["router"]["w"].float(), dim=-1)
    g, idx = MOE.topk(probs, k, e.get("renorm_gates", False))
    lb = MOE.balance_loss(probs, e["lb_alpha"])
    grp = idx.reshape(-1)
    row = torch.arange(t, device=x.device).repeat_interleave(k)
    gate = g.reshape(-1)
    if e.get("dispatch_backend", "sort") != "dropless":
        cap = MOE.capacity(t, k, e["capacity_factor"], E)
        kept = MOE.rank_in_group(grp, E) < cap
        grp, row, gate = grp[kept], row[kept], gate[kept]
    y = MOE.expert_ffn(p["experts"], x, grp, row, gate, per_node, E,
                       m["act"], quant)
    return y, lb


def routing_bounds(doc: Dict, tokens: int) -> Dict[str, float]:
    """The router and the sort over one layer's forward at ``tokens``
    tokens, one call each."""
    d = doc["model"]["d_model"]
    E, k = doc["moe"]["num_experts"], doc["moe"]["top_k"]
    return {"router": FL.router_fused_bound(tokens, d, E, k, 2),
            "sort": FL.group_sort_bound(tokens * k, E + 1),
            "hops": 1}
