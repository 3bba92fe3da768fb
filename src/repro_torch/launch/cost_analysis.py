"""Op-by-op cost counts of one eager step: the counterpart of
``repro.launch.hlo_analysis``.

The JAX package parses the compiled HLO, where a ``while`` (scan) body
appears once and must be multiplied by its trip count.  Eager PyTorch
runs every op every time, so one real step run on the meta device and
counted as it dispatches is exact, with no loop correction.
:class:`CostMode` (a ``TorchDispatchMode``) counts:

* ``dot_flops`` — 2·M·N·K for every matmul-class op (``mm``, ``bmm``,
  ``addmm``, ``baddbmm``, which ``matmul``, ``linear`` and ``einsum``
  lower to): the tensor-core term, elementwise work ignored, as
  ``hlo_analysis``'s dot count;
* ``traffic_bytes`` — operand plus output bytes of every op that is not a
  view: the HBM proxy and upper bound, as ``hlo_analysis``'s (no fusion
  here, so every op counts);
* the live bytes of the storages the step makes (``live_bytes``,
  ``peak_bytes``, storages freed as their last tensor dies), the
  arguments' own left out: the temporary memory of the step.  Tensors
  that a reference cycle holds (PyTorch's non-reentrant checkpoint
  makes such cycles) die only when the cyclic garbage collector runs,
  whose timing varies from run to run; so by default the mode collects
  every :data:`GC_EVERY` ops, which makes the count repeatable (the
  objects older than the step frozen first, so that a collection scans
  only the step's own).  ``collect_every=0`` leaves the collector to
  Python, as a run on the card does.

The collectives come from ``sharding.comm``'s trace
(:class:`repro_torch.sharding.comm.TraceLog`), one record a call:
:func:`collective_costs` gives each its class (all-to-all, all-reduce,
all-gather, reduce-scatter), its output bytes (the buffer ``hlo_analysis``
counts), its group and whether the group spans nodes: a group spans nodes
when its ranks fall in more than one block of :data:`NODE_RANKS`
consecutive ranks (one 8-GPU NVLink node), the counterpart of
``_crosses_pod`` (DCN against ICI).  Each also splits the bytes this rank
moves to its peers into those on its own node and those off it.
:func:`collective_summary` prices them at the bandwidths the caller
passes; its defaults are NVIDIA's H100 SXM datasheet figures, constants
and not measurements.
"""
from __future__ import annotations

import gc
import math
import weakref
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

NODE_RANKS = 8                  # GPUs a node, joined by NVLink
GC_EVERY = 1000                 # ops between two cyclic collections
# datasheet constants (NVIDIA H100 SXM), not measurements
NVLINK_BYTES_PER_S = 450e9      # NVLink 4, per direction
IB_BYTES_PER_S = 50e9           # one 400 Gb/s NDR InfiniBand port a GPU

CLASSES = ("all-to-all", "all-reduce", "all-gather", "reduce-scatter")

_aten = torch.ops.aten
_MM = {_aten.mm.default, _aten.addmm.default}
_BMM = {_aten.bmm.default, _aten.baddbmm.default}


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostMode(TorchDispatchMode):
    """Counts ``dot_flops``, ``traffic_bytes`` and the live bytes of the
    storages made while it is active (``exclude``: tensors whose storages
    are not the step's own, its arguments, which an in-place op hands
    back).  ``collect_every``: ops between two forced cyclic
    collections (0: none)."""

    def __init__(self, exclude: Sequence[torch.Tensor] = (),
                 collect_every: int = GC_EVERY):
        super().__init__()
        self.collect_every = collect_every
        self.dot_flops = 0.0
        self.traffic_bytes = 0.0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.ops = 0
        self._known = {t.untyped_storage()._cdata for t in exclude
                       if torch.is_tensor(t)}

    def __enter__(self):
        if self.collect_every:
            gc.collect()
            gc.freeze()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            if self.collect_every:
                gc.unfreeze()

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._known:
            return
        self._known.add(key)
        n = st.nbytes()
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key, n: int) -> None:
        self.live_bytes -= n
        self._known.discard(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        if self.collect_every and self.ops % self.collect_every == 0:
            gc.collect()
        if func in _MM:
            a, b = (args[0], args[1]) if func is _aten.mm.default else \
                (args[1], args[2])
            self.dot_flops += 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
        elif func in _BMM:
            a, b = (args[0], args[1]) if func is _aten.bmm.default else \
                (args[1], args[2])
            self.dot_flops += (2.0 * a.shape[0] * a.shape[1] * a.shape[2]
                               * b.shape[2])
        outs = [t for t in tree_leaves(out) if torch.is_tensor(t)]
        if not func.is_view:
            ins = [t for t in tree_leaves((args, kwargs))
                   if torch.is_tensor(t)]
            self.traffic_bytes += sum(map(_bytes, ins)) + sum(
                map(_bytes, outs))
        for t in outs:
            self._track(t)
        return out


# ----------------------------------------------------------- collectives
def op_class(op: str) -> Optional[str]:
    """The class of a ``comm`` op as the wire log names it (``psum``,
    ``psum.grad``, ``all_gather.params``, ...); None for a barrier."""
    base = op.split(".")[0]
    if base.startswith("dist"):
        base = op.split(".", 1)[1]
    if base in ("psum", "pmax", "all_reduce"):
        return "all-reduce"
    if base.startswith("all_gather"):
        return "all-gather"
    if base.startswith(("psum_scatter", "reduce_scatter")):
        return "reduce-scatter"
    if base.startswith(("all_to_all", "ragged_all_to_all")):
        return "all-to-all"
    return None


def group_ranks(mesh_shape, mesh_axes, axes, rank: int) -> List[int]:
    """The global ranks of ``rank``'s group over ``axes``."""
    from repro_torch.launch.mesh import group_members
    idx = [list(mesh_axes).index(a) for a in axes]
    return next(b for b in group_members(mesh_shape, sorted(idx))
                if rank in b)


def spans_nodes(ranks: Sequence[int], node: int = NODE_RANKS) -> bool:
    return len({r // node for r in ranks}) > 1


@dataclass
class CollectiveCost:
    op: str                     # class
    label: str                  # comm's name for the call
    axes: tuple
    group: int                  # ranks in the group
    bytes: float                # output buffer bytes
    inter: bool                 # the group spans nodes
    intra_peer_bytes: float     # bytes this rank moves to peers on its node
    inter_peer_bytes: float     # and to peers off it
    count: float = 1.0


def _moved(cls: str, in_bytes: float, out_bytes: float, g: int) -> float:
    """Bytes this rank moves to the others of a group of ``g`` (ring
    algorithms, as ``collective_summary``'s factors)."""
    if g <= 1:
        return 0.0
    if cls == "all-reduce":
        return 2.0 * (g - 1) / g * out_bytes
    if cls == "all-gather":
        return (g - 1) / g * out_bytes
    if cls == "reduce-scatter":
        return (g - 1) / g * in_bytes
    return (g - 1) / g * in_bytes        # all-to-all: all but its own part


def collective_costs(calls, mesh_shape, mesh_axes, rank: int = 0,
                     node: int = NODE_RANKS) -> List[CollectiveCost]:
    """The costs of ``rank``'s traced collectives (``TraceLog.calls``) on
    a mesh of ``mesh_shape`` named ``mesh_axes``."""
    out = []
    for c in calls:
        cls = op_class(c.op)
        if cls is None or not all(a in mesh_axes for a in c.axes):
            continue
        members = group_ranks(mesh_shape, mesh_axes, c.axes, rank)
        g = len(members)
        itemsize = getattr(torch, c.dtype).itemsize
        in_b = math.prod(c.shape) * itemsize
        out_b = math.prod(c.out_shape) * itemsize
        moved = _moved(cls, in_b, out_b, g)
        near = sum(1 for r in members if r != rank and r // node == rank // node)
        far = g - 1 - near
        out.append(CollectiveCost(
            cls, c.op, tuple(c.axes), g, float(out_b),
            spans_nodes(members, node),
            moved * near / max(g - 1, 1), moved * far / max(g - 1, 1)))
    return out


def collective_summary(costs: Sequence[CollectiveCost], *,
                       intra_bw: float = NVLINK_BYTES_PER_S,
                       inter_bw: float = IB_BYTES_PER_S) -> Dict:
    """Wire seconds and bytes by class, the keys of ``hlo_analysis``'s
    summary (``intra``/``inter`` node for its ``ici``/``dcn``), plus the
    bytes a rank moves to peers on and off its node.  A collective over a
    group that spans nodes runs at ``inter_bw``, else at ``intra_bw``
    (defaults: datasheet constants)."""
    per = {k: 0.0 for k in CLASSES}
    per_bytes = {k: 0.0 for k in CLASSES}
    per_calls = {k: 0.0 for k in CLASSES}
    intra_peer = {k: 0.0 for k in CLASSES}
    inter_peer = {k: 0.0 for k in CLASSES}
    intra_s = inter_s = 0.0
    n = 0.0
    for c in costs:
        g = max(c.group, 1)
        if c.op == "reduce-scatter":
            factor = float(g - 1)
        elif c.op == "all-reduce":
            factor = 2.0 * (g - 1) / g if g > 1 else 0.0
        else:
            factor = (g - 1) / g if g > 1 else 0.0
        t = c.count * c.bytes * factor / (inter_bw if c.inter else intra_bw)
        per[c.op] += t
        per_bytes[c.op] += c.count * c.bytes
        per_calls[c.op] += c.count
        intra_peer[c.op] += c.count * c.intra_peer_bytes
        inter_peer[c.op] += c.count * c.inter_peer_bytes
        n += c.count
        if c.inter:
            inter_s += t
        else:
            intra_s += t
    return {"seconds_per_op": per, "bytes_per_op": per_bytes,
            "calls_per_op": per_calls,
            "intra_node_peer_bytes": intra_peer,
            "inter_node_peer_bytes": inter_peer,
            "intra_node_seconds": intra_s, "inter_node_seconds": inter_s,
            "total_seconds": intra_s + inter_s, "n_collectives": n,
            "bandwidths": {"intra_node_bytes_per_s": intra_bw,
                           "inter_node_bytes_per_s": inter_bw,
                           "source": "datasheet constants, not measured"
                           if (intra_bw, inter_bw) == (
                               NVLINK_BYTES_PER_S, IB_BYTES_PER_S)
                           else "given by the caller"}}


def by_group(costs: Sequence[CollectiveCost]) -> Dict[str, float]:
    """Bytes by ``op|g<size>|intra`` or ``inter``, as the JAX dry run's
    ``collectives_by_group``."""
    out: Dict[str, float] = {}
    for c in costs:
        key = f"{c.op}|g{c.group}|{'inter' if c.inter else 'intra'}"
        out[key] = out.get(key, 0.0) + c.bytes * c.count
    return out
