"""Expert-to-slot layout for the 2-D (n x m) expert grid.

The paper assumes one expert per worker (``E == n*m``).  Real configs break
that assumption in both directions, so we generalize:

* ``E == n*m*h`` with ``h >= 1``: each grid slot hosts ``h`` experts.
* ``E < n*m`` (e.g. qwen3-moe: 128 experts on a 256-slot grid): each expert is
  **replicated** ``r = n*m/E`` times *within its node*; tokens are spread
  round-robin over replicas.  Replication is the TPU-native answer to the
  grid being larger than the expert count, and doubles as hot-expert load
  spreading (beyond-paper).

Slots within a node are indexed ``j in [0, m)``; per-node experts are indexed
``e_local in [0, E_pn)`` with ``E_pn = E / n``.  The *virtual expert* id ``v``
(used for capacity accounting) enumerates ``(slot, expert_in_slot)`` pairs.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ExpertLayout:
    num_experts: int      # E (real experts)
    n_inter: int          # n (nodes)
    n_intra: int          # m (workers per node)
    h: int                # experts per slot (>= 1)
    r: int                # replicas per expert (>= 1); h > 1 implies r == 1
    shard_intra: bool     # True: expert dim0 sharded over intra axes too

    @property
    def experts_per_node(self) -> int:
        return self.num_experts // self.n_inter

    @property
    def slots(self) -> int:
        return self.n_inter * self.n_intra

    @property
    def virtual_per_node(self) -> int:
        """Capacity groups per node = m*h (== E_pn * r when replicated)."""
        return self.n_intra * self.h

    @property
    def virtual_total(self) -> int:
        return self.slots * self.h

    @property
    def local_experts(self) -> int:
        """Experts materialized per device (param leaf dim0 after sharding)."""
        return self.h if self.shard_intra else self.experts_per_node


def make_layout(num_experts: int, n_inter: int, n_intra: int) -> ExpertLayout:
    slots = n_inter * n_intra
    if num_experts % slots == 0:
        return ExpertLayout(num_experts, n_inter, n_intra,
                            h=num_experts // slots, r=1, shard_intra=True)
    if num_experts % n_inter != 0:
        raise ValueError(
            f"num_experts={num_experts} not divisible by n_inter={n_inter}")
    e_pn = num_experts // n_inter
    if n_intra % e_pn != 0:
        raise ValueError(
            f"cannot lay out {e_pn} experts/node on {n_intra} slots/node: "
            f"need E_pn | m or m | E_pn")
    return ExpertLayout(num_experts, n_inter, n_intra,
                        h=1, r=n_intra // e_pn, shard_intra=False)
