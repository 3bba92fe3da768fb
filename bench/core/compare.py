"""The comparisons that decide ``correct``.

Training: each of the first steps' loss against the reference's
(``loss_gap``, the largest relative gap), and each leaf's norm of the
first clipped gradient (``grad_gap``) and of the change over the first
steps (``change_gap``) against the reference's: the gap between the two
norms over the larger of the reference's norm of that leaf and of the
median leaf, the worst leaf's.  A leaf whose gradient in the reference
is under a thousandth of the median leaf's moves by round-off alone under
LAMB and is left out of both.

Serving: the widest gap between the reference's best logit and the served
token's (``logit_gap``, computed by ``serve_driver.logit_gap``).
"""
from __future__ import annotations

import statistics
from typing import Dict, List

NOUGHT = 1e-3


def kept_leaves(ref_grad: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_grad.values())
    return sorted(k for k, v in ref_grad.items() if v >= NOUGHT * med)


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves: List[str]) -> Dict[str, float]:
    med = statistics.median(ref[k] for k in leaves)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in leaves}


def train_gaps(program: Dict, reference: Dict) -> Dict[str, float]:
    keep = kept_leaves(reference["grad"])
    loss = max(abs(p - r) / max(abs(r), 1e-30)
               for p, r in zip(program["loss"], reference["loss"]))
    grad = leaf_gaps(program["grad"], reference["grad"], keep)
    change = leaf_gaps(program["change"], reference["change"], keep)
    return {"loss_gap": loss, "grad_gap": max(grad.values()),
            "grad_median_gap": statistics.median(grad.values()),
            "change_gap": max(change.values())}


def details(program: Dict, reference: Dict) -> Dict:
    """What the calibration prints beside the gaps: each step's loss gap,
    the median leaf's gaps and the three worst leaves of each norm."""
    keep = kept_leaves(reference["grad"])
    out = {"loss_steps": [abs(p - r) / max(abs(r), 1e-30) for p, r in
                          zip(program["loss"], reference["loss"])]}
    for key in ("grad", "change"):
        med = statistics.median(reference[key][k] for k in keep)
        gaps = {k: abs(program[key][k] - reference[key][k])
                / max(reference[key][k], med, 1e-30) for k in keep}
        out[f"{key}_median_leaf"] = statistics.median(gaps.values())
        out[f"{key}_worst"] = sorted(gaps.items(), key=lambda x: -x[1])[:3]
    out["left_out"] = sorted(set(reference["grad"]) - set(keep))
    return out
