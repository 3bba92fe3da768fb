"""MeshPlan: how logical parallelism roles map onto mesh axes.

The port's counterpart of ``repro.sharding.plan``.  The paper's bi-level
routing factorizes a flat expert-parallel All2All over ``N = n x m``
workers into an inter-node level and an intra-node level; a plan names the
axes of each role:

* ``dp_axes``   — pure data-parallel axes
* ``tp_axis``   — tensor-parallel axis for dense blocks
* ``ep_inter``  — SMILE level-1 ("node") axes
* ``ep_intra``  — SMILE level-2 ("GPU-within-node") axes

:func:`single_device_plan` has no named axes, and every helper in
:mod:`repro_torch.sharding.comm` is then the identity.
:func:`plan_from_mesh` names the axes of a :class:`repro_torch.launch.mesh.
Mesh` (``torch.distributed`` process groups) as the JAX package's
``plan_from_mesh`` does: ``model`` is tensor-parallel and SMILE-intra,
``data`` SMILE-inter, every axis but ``model`` data-parallel.
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


def plan_from_mesh(mesh, *,
                   smile_inter_axes: Optional[Tuple[str, ...]] = None
                   ) -> MeshPlan:
    """The canonical plan of a mesh (anything with ``axes`` and ``shape``):
    ``model`` is tensor-parallel and SMILE-intra; every other axis (``pod``,
    ``data``) is data-parallel; SMILE-inter is ``("data",)`` unless
    ``smile_inter_axes`` says otherwise (``("pod", "data")`` routes level 1
    across pods too)."""
    names = tuple(mesh.axes)
    sizes = tuple(zip(names, (int(n) for n in mesh.shape)))
    tp = "model" if "model" in names else None
    dp = tuple(a for a in names if a != "model")
    if smile_inter_axes is None:
        smile_inter_axes = ("data",) if "data" in names else dp
    inter = tuple(a for a in smile_inter_axes if a in names)
    intra = ("model",) if tp else ()
    return MeshPlan(dp_axes=dp, tp_axis=tp, ep_inter=inter, ep_intra=intra,
                    axis_sizes=sizes)


def single_device_plan() -> MeshPlan:
    """Oracle plan: no named axes; every collective is the identity."""
    return MeshPlan()


def test_plan(n_inter: int = 2, n_intra: int = 2, pod: int = 0) -> MeshPlan:
    """The plan of a small test mesh ``([pod,] data, model)``."""
    sizes = []
    if pod:
        sizes.append(("pod", pod))
    sizes += [("data", n_inter), ("model", n_intra)]
    dp = tuple(a for a, _ in sizes if a != "model")
    return MeshPlan(dp_axes=dp, tp_axis="model", ep_inter=("data",),
                    ep_intra=("model",), axis_sizes=tuple(sizes))


# ``test_plan`` builds a plan; it is no test
test_plan.__test__ = False
