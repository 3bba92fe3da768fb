"""What the reference's MoE layers share, whatever routes their tokens:
the expert weights' leaves, top-k gates, a capacity's ranks, the balance
loss and the experts' FFN over the rows routed to them.

The experts sit on the config's logical ``(n, m)`` grid, as the port
stores them: ``w1`` and ``w3`` (n, m, d, f), ``w2`` (n, m, f, d).  The
routers (``bench/reference/routers/<router>.py``) decide which rows go to
which expert with which gate; :func:`expert_ffn` computes them.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from bench.reference.ops import act, mm


def expert_leaves(doc: Dict) -> List[Tuple[Tuple[str, ...], tuple, float,
                                          str]]:
    """``(path, shape, scale, role)`` of the expert weights, in the order
    they are drawn."""
    m, e = doc["model"], doc["moe"]
    d, fe = m["d_model"], e["d_ff_expert"]
    n = e["grid"][0]
    per = e["num_experts"] // n
    out = [(("experts", "w1"), (n, per, d, fe), d ** -0.5, "mm"),
           (("experts", "w2"), (n, per, fe, d), fe ** -0.5, "mm")]
    if m["glu"]:
        out.append((("experts", "w3"), (n, per, d, fe), d ** -0.5, "mm"))
    return out


def expert_params(doc: Dict) -> int:
    """Multiply-adds a token spends in its experts' FFNs."""
    m, e = doc["model"], doc["moe"]
    mult = 3 if m["glu"] else 2
    return e["top_k"] * mult * m["d_model"] * e["d_ff_expert"]


def topk(p: torch.Tensor, k: int, renorm: bool):
    g, i = torch.topk(p, k, dim=-1)
    if renorm and k > 1:
        g = g / g.sum(-1, keepdim=True).clamp(min=1e-9)
    return g, i


def rank_in_group(groups: torch.Tensor, num: int) -> torch.Tensor:
    """Each entry's rank among the earlier entries of its group."""
    one = F.one_hot(groups.long(), num).to(torch.int64)
    return (one.cumsum(0) - one).gather(1, groups.long()[:, None])[:, 0]


def capacity(tokens: int, k: int, factor: float, groups: int) -> int:
    return max(1, math.ceil(tokens * k * factor / groups))


def balance_loss(probs: torch.Tensor, coef: float) -> torch.Tensor:
    """``coef * groups * sum(f * P)``: ``f`` the share of rows whose top
    choice is each group, ``P`` the mean probability (SMILE Eq. 4)."""
    G = probs.shape[-1]
    f = F.one_hot(probs.argmax(-1), G).float().mean(0)
    return coef * G * torch.sum(f * probs.mean(0))


def expert_ffn(w: Dict, xr: torch.Tensor, grp: torch.Tensor,
               row: torch.Tensor, gate: torch.Tensor, per_node: int,
               num: int, kind: str, quant) -> torch.Tensor:
    """``sum`` over the assignments ``(grp, row, gate)`` of ``gate *
    FFN_grp(xr[row])``, added up per row of ``xr``: expert ``grp`` is
    ``(grp // per_node, grp % per_node)`` on the grid."""
    yr = torch.zeros_like(xr)
    order = torch.argsort(grp, stable=True)
    counts = torch.bincount(grp, minlength=num).tolist()
    start = 0
    for gid, c in enumerate(counts):
        if c == 0:
            continue
        sel = order[start:start + c]
        start += c
        node, j = divmod(gid, per_node)
        xs = xr[row[sel]]
        h = act(mm(xs, w["w1"][node, j], quant), kind)
        if "w3" in w:
            h = h * mm(xs, w["w3"][node, j], quant)
        out = mm(h, w["w2"][node, j], quant) * gate[sel, None]
        yr = yr.index_add(0, row[sel], out)
    return yr
