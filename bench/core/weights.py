"""Weights made on the device from ``--seed``, by the benchmark's own code.

The configuration's family (``bench/reference/<family>.py``) lists the
leaves in draw order and assembles the port's parameter tree of them.
Each leaf is one ``torch.randn`` call on the device (in the dtype it is
served in), from a generator seeded by ``(seed, leaf index)``, so any leaf
can be drawn again alone: the training cells redraw the first weights leaf
by leaf to measure how far the program moved them, and the reference
redraws them whole once the program's state is freed.  The scales follow
the port's initialisation (``1/sqrt(fan-in)``, 0.02 for the embedding and
the head, norms at one and zero).
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

from bench.core import plugins


@dataclass(frozen=True)
class Leaf:
    group: str          # the stacked leaf of the port's tree it belongs to
    layer: int          # position in the run order, -1 outside the blocks
    path: Tuple         # where it sits in the port's tree
    shape: Tuple[int, ...]
    scale: float
    role: str           # mm (served in bf16) | fp32 | ones | zeros


def leaf_seed(seed: int, index: int) -> int:
    h = hashlib.sha256(f"bench-weights:{seed}:{index}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def draw(leaf: Leaf, index: int, seed: int, device, dtype) -> torch.Tensor:
    """One leaf, drawn on ``device`` in ``dtype`` (norms in fp32)."""
    if leaf.role == "ones":
        return torch.ones(leaf.shape, dtype=torch.float32, device=device)
    if leaf.role == "zeros":
        return torch.zeros(leaf.shape, dtype=torch.float32, device=device)
    dt = dtype if leaf.role == "mm" else torch.float32
    g = torch.Generator(device=device).manual_seed(leaf_seed(seed, index))
    return torch.randn(leaf.shape, generator=g, device=device,
                       dtype=dt).mul_(leaf.scale)


def make(doc: Dict, seed: int, device, mm_dtype) -> Tuple[Dict, List]:
    """``(tree, drawn)``: the port's parameter tree and the list of
    ``(leaf, tensor)`` in draw order (the same tensors).  ``mm_dtype`` is
    the dtype of the blocks' matmul weights: bf16 for serving, fp32 (the
    masters) for training."""
    fam = plugins.family(doc)
    drawn = [(leaf, draw(leaf, i, seed, device, mm_dtype))
             for i, leaf in enumerate(fam.leaves(doc))]
    return fam.make_tree(doc, drawn), drawn


def groups(drawn) -> Dict[str, List[torch.Tensor]]:
    """Group name -> its pieces (the stacked leaves LAMB and the checks
    take a norm over)."""
    out: Dict[str, List[torch.Tensor]] = {}
    for leaf, t in drawn:
        out.setdefault(leaf.group, []).append(t)
    return out


def group_ndim(drawn) -> Dict[str, int]:
    """Each group's ndim as a stacked leaf: a block's piece stacks one
    dimension over the blocks."""
    out = {}
    for leaf, t in drawn:
        out[leaf.group] = len(leaf.shape) + (1 if leaf.layer >= 0 else 0)
    return out


@torch.no_grad()
def change_norms(drawn, seed: int, device) -> Dict[str, float]:
    """Each group's norm of (now - first weights), the first weights drawn
    again leaf by leaf."""
    sq: Dict[str, torch.Tensor] = {}
    for i, (leaf, p) in enumerate(drawn):
        p0 = draw(leaf, i, seed, device, torch.float32)
        d = (p.detach().float() - p0).square().sum()
        sq[leaf.group] = sq.get(leaf.group, 0) + d
        del p0
    return {k: math.sqrt(float(v)) for k, v in sq.items()}
