"""The meta device's stand-ins for host reads: the one place they live.

A tensor on the meta device (``torch.device("meta")``, the dry run's,
:mod:`repro_torch.launch.dryrun`) has a shape and a dtype and no values,
so a read on the host has nothing to read.  The port reads the host in
two places on the routed and training paths, and each goes through a
function here, which reads the values as before on the card and on the
CPU and takes a static stand-in only on meta:

* :func:`split_sizes` — a ragged exchange's per-peer row counts
  (``sharding.comm.ragged_all_to_all`` hands ``all_to_all_single`` host
  integers).  On meta the exchange moves the static sizes the JAX dry run
  lowers: every peer an even share of the staged rows, and of the
  receive slab.
* :func:`verdict` — the step sentinel's verdict (``train.sentinel.
  gated_update``).  On meta it is the apply path, so that the dry run
  counts the optimizer's work and memory.
"""
from __future__ import annotations

from typing import List

import torch


def is_meta(t: torch.Tensor) -> bool:
    return t.device.type == "meta"


def split_sizes(counts: torch.Tensor, rows: int) -> List[int]:
    """``counts.tolist()``; on meta, ``rows`` cut into ``len(counts)``
    even shares (the remainder to the last)."""
    if not is_meta(counts):
        return counts.tolist()
    P = counts.shape[-1]
    share = rows // P
    return [share] * (P - 1) + [rows - share * (P - 1)]


def verdict(ok: torch.Tensor) -> bool:
    """``bool(ok)``; on meta, True."""
    return True if is_meta(ok) else bool(ok)
