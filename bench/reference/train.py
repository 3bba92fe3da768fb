"""The reference training steps: the plain model's loss and gradients
(autograd in fp32), the global-norm clip and LAMB (You et al. 2019), with
the trust ratio taken over each stacked leaf (a group of the blocks'
pieces, as ``bench.core.weights.groups`` lists them) and weight decay on
every leaf of two dimensions or more once stacked.

:func:`follow` draws the first weights from the seed, runs the steps on the
given batches (the loss is the configuration's family's ``train_loss``) and returns what the checks compare: each step's loss (of
its last micro-batch, as the program reports it), each leaf's norm of the
first clipped gradient, and each leaf's norm of the change after the last
step, the first weights drawn again leaf by leaf to take it.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from bench.core import plugins
from bench.core import weights as W
from bench.reference.ops import fp32_exact


def _bias_corrections(b1: float, b2: float, step: int):
    f32 = np.float32
    return (float(f32(1) - f32(b1) ** f32(step)),
            float(f32(1) - f32(b2) ** f32(step)))


@torch.no_grad()
def clip(pieces: List[torch.Tensor], max_norm: float) -> None:
    total = torch.sqrt(sum(p.grad.float().square().sum() for p in pieces))
    scale = torch.clamp(max_norm / torch.clamp(total, min=1e-12), max=1.0)
    for p in pieces:
        p.grad.mul_(scale)


@torch.no_grad()
def lamb(groups: Dict[str, List[torch.Tensor]], ndim: Dict[str, int],
         state: Dict, lr: float, t: Dict) -> None:
    """One LAMB step over every group, in place."""
    state["step"] = state.get("step", 0) + 1
    bc1, bc2 = _bias_corrections(t["b1"], t["b2"], state["step"])
    for name, pieces in groups.items():
        decay = t["weight_decay"] if ndim[name] >= 2 else 0.0
        for p in pieces:
            m, v = state.setdefault(id(p), (torch.zeros_like(p),
                                            torch.zeros_like(p)))
            g = p.grad
            m.mul_(t["b1"]).add_((1 - t["b1"]) * g)
            v.mul_(t["b2"]).add_(g.square() * (1 - t["b2"]))
            # the direction takes the spent gradient's buffer
            g.copy_(m).div_(bc1).div_((v / bc2).sqrt_().add_(t["eps"]))
            if decay:
                g.add_(decay * p)
        wn = torch.sqrt(sum(p.square().sum() for p in pieces))
        dn = torch.sqrt(sum(p.grad.square().sum() for p in pieces))
        trust = torch.where((wn > 0) & (dn > 0),
                            torch.clamp(wn / torch.clamp(dn, min=1e-12),
                                        0.0, 10.0), torch.ones_like(wn))
        for p in pieces:
            p.sub_(p.grad * (lr * trust))


def follow(doc: Dict, seed: int, batches: List[Dict[str, torch.Tensor]],
           n_micro: int, device, quant: Optional[str] = None,
           half_batch: bool = False) -> Dict:
    """The reference's readings over ``len(batches)`` steps.
    ``half_batch`` plants a fault: each step sees the first half of its
    rows only."""
    t = doc["train"]
    loss_of = plugins.family(doc).train_loss
    tree, drawn = W.make(doc, seed, device, torch.float32)
    groups = W.groups(drawn)
    ndim = W.group_ndim(drawn)
    pieces = [p for _, p in drawn]
    for p in pieces:
        p.requires_grad_(True)
    state: Dict = {}
    losses, first = [], {}
    with fp32_exact():
        for i, batch in enumerate(batches):
            if half_batch:
                half = batch["tokens"].shape[0] // 2
                batch = {k: v[:half] for k, v in batch.items()}
            for p in pieces:
                p.grad = None
            B = batch["tokens"].shape[0]
            mb = B // n_micro
            for j in range(n_micro):
                sl = slice(j * mb, (j + 1) * mb)
                loss = loss_of(tree, batch["tokens"][sl],
                               batch["labels"][sl], doc, quant)
                loss.backward()
                last = float(loss.detach())
            with torch.no_grad():
                for p in pieces:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                    if n_micro > 1:
                        p.grad.div_(n_micro)
            losses.append(last)
            clip(pieces, t["grad_clip"])
            if i == 0:
                first = {name: float(torch.sqrt(sum(
                    p.grad.square().sum() for p in ps)))
                    for name, ps in groups.items()}
            lamb(groups, ndim, state, t["lr"], t)
    change = W.change_norms(drawn, seed, device)
    for p in pieces:
        p.grad = None
    return {"loss": losses, "grad": first, "change": change}
