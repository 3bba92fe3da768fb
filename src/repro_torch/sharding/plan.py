"""MeshPlan: how logical parallelism roles map onto mesh axes.

The port's counterpart of ``repro.sharding.plan``.  The paper's bi-level
routing factorizes a flat expert-parallel All2All over ``N = n x m``
workers into an inter-node level and an intra-node level; a plan names the
axes of each role:

* ``dp_axes``   — pure data-parallel axes
* ``tp_axis``   — tensor-parallel axis for dense blocks
* ``ep_inter``  — SMILE level-1 ("node") axes
* ``ep_intra``  — SMILE level-2 ("GPU-within-node") axes

This slice runs on one device only: :func:`single_device_plan` has no named
axes, and every helper in :mod:`repro_torch.sharding.comm` is then the
identity.  Named axes (``torch.distributed`` process groups) arrive with the
expert-parallel slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MeshPlan:
    dp_axes: Tuple[str, ...] = ()
    tp_axis: Optional[str] = None
    ep_inter: Tuple[str, ...] = ()
    ep_intra: Tuple[str, ...] = ()
    axis_sizes: Tuple[Tuple[str, int], ...] = ()   # frozen dict of axis -> size

    def size(self, axes) -> int:
        if axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        d = dict(self.axis_sizes)
        p = 1
        for a in axes:
            p *= d.get(a, 1)
        return p

    @property
    def dp(self) -> int:
        return self.size(self.dp_axes)

    @property
    def tp(self) -> int:
        return self.size(self.tp_axis)

    @property
    def n_inter(self) -> int:
        """Number of "nodes" (paper's n)."""
        return self.size(self.ep_inter)

    @property
    def n_intra(self) -> int:
        """Workers per node (paper's m)."""
        return self.size(self.ep_intra)

    @property
    def ep(self) -> int:
        """Total expert-parallel grid slots N = n x m."""
        return self.n_inter * self.n_intra

    @property
    def ep_axes(self) -> Tuple[str, ...]:
        return tuple(self.ep_inter) + tuple(self.ep_intra)

    @property
    def all_axes(self) -> Tuple[str, ...]:
        return tuple(a for a, _ in self.axis_sizes)

    def tp_axes(self) -> Tuple[str, ...]:
        return (self.tp_axis,) if self.tp_axis else ()


def single_device_plan() -> MeshPlan:
    """Oracle plan: no named axes; every collective is the identity."""
    return MeshPlan()
