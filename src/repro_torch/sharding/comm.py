"""Collective-communication helpers over named mesh axes.

The port of ``repro.sharding.comm``.  Every collective the model code
issues goes through these helpers.  With an empty axis tuple
(``single_device_plan()``) each one is the identity, exactly as in the JAX
package, so the same model code is the single-device path.

A named axis tuple is a ``torch.distributed`` process group of the mesh
this process is bound to: :func:`repro_torch.launch.mesh.make_mesh` builds
the groups and binds the mesh (one mesh a process: a rank is a process,
and the model code names axes, never groups).  Inside a group the ranks
are ordered as JAX orders them, by the linear index over the named axes in
mesh order, so :func:`axis_index` and the segment order of an All2All
agree with ``lax``.  A helper over a named axis with no mesh bound raises.

Under the gloo backend a card tensor crosses the wire through the host:
each helper copies it to host memory, runs the collective there and copies
the result back (gloo's own transport is host memory); under nccl the
tensors stay on the cards.

Each collective carries a gradient (a ``torch.autograd.Function``), and
its backward is what JAX's transpose gives inside ``shard_map`` with
``check_vma=False``, where every rank's loss is a share of the total and
the gradient is of their sum: a psum's cotangent is psum'd, an
all_gather's is psum-scattered (one ``reduce_scatter_tensor``: summed
over the group, this rank's block kept) and a psum_scatter's is
all-gathered, an All2All's goes back through the inverse All2All, and a
ragged exchange's through the reverse exchange with the send and receive
sizes swapped (rows a truncating exchange cut get a zero cotangent).
Every backward runs its collective on every rank, a zero cotangent
included, so ranks whose graphs agree issue the same collectives in the
same order.  ``pmax`` and :func:`axis_index` carry none: ``pmax`` raises
on a tensor that needs a gradient (JAX has no transpose for it).  The
:class:`WireLog` keeps a backward call under its op's name with
``.grad`` added (``psum.grad``), so a step's wire reads forward and
backward apart; the training step's gradient psums log as ``psum.sync``
(under ZeRO-1 ``psum_scatter.sync``, and the updated parameters'
all-gather ``all_gather.params``) and its norms' as ``psum.norm``.

A :class:`TraceLog` bound with :func:`tracing` keeps, in order, every
collective this rank issues (its op as the wire log names it, the axes,
the dtype, the shape, and the file and line of the code that called
``comm``), and a call that names an axis the mesh lacks before it
raises: what :mod:`repro_torch.analysis.trace_lint` holds the ranks to.
On the meta device (the dry run) the ragged exchange's host read of its
split sizes takes :func:`repro_torch.common.meta.split_sizes`'s static
sizes.
"""
from __future__ import annotations

import contextlib
import math
import os
import sys
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.common import meta
from repro_torch.core.dispatch import ragged_row_membership

Axes = Union[None, str, Tuple[str, ...]]

# the mesh this process is bound to (launch.mesh.make_mesh sets it)
_MESH = None


def _norm(axes: Axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    if isinstance(axes, str):
        return (axes,)
    return tuple(axes)


def bind(mesh) -> None:
    """Bind this process to ``mesh`` (a :class:`repro_torch.launch.mesh.
    Mesh`); a later call replaces it."""
    global _MESH
    _MESH = mesh


def bound_mesh():
    """The mesh this process is bound to; raises when there is none."""
    if _MESH is None:
        raise RuntimeError("no mesh is bound in this process: build one with "
                           "repro_torch.launch.mesh.make_mesh after "
                           "torch.distributed.init_process_group")
    return _MESH


class WireLog:
    """What the collectives of one process moved, by ``(op, axes, dtype)``:
    calls, the rows and bytes this rank sent to the other ranks of the
    group (its own segment excluded; a reduction counts its whole tensor
    once), and, with ``timed``, the host seconds spent inside the helper,
    the device synchronized before and after each call so that a
    collective's time holds neither earlier kernels nor its own tail."""

    def __init__(self, timed: bool = False):
        self.timed = timed
        self.entries: Dict[Tuple[str, str, str], List[float]] = defaultdict(
            lambda: [0, 0, 0, 0.0])

    def reset(self, timed: Optional[bool] = None) -> None:
        self.entries.clear()
        if timed is not None:
            self.timed = timed

    def add(self, key, rows: int, nbytes: int, seconds: float) -> None:
        e = self.entries[key]
        e[0] += 1
        e[1] += rows
        e[2] += nbytes
        e[3] += seconds

    def summary(self) -> Dict[str, Dict[str, float]]:
        """``{"op axes dtype": {calls, rows, bytes, s}}``."""
        return {" ".join(k): dict(zip(("calls", "rows", "bytes", "s"), v))
                for k, v in sorted(self.entries.items())}


class TraceCall(NamedTuple):
    """One collective as a rank issued it."""
    op: str                        # as the wire log names it (psum.grad, ...)
    axes: Tuple[str, ...]
    dtype: str
    shape: Tuple[int, ...]
    caller: str                    # file:line of the code that called comm
    out_shape: Tuple[int, ...]     # the result's


class TraceLog:
    """Every collective of this process, in the order it was issued
    (:func:`tracing` binds one)."""

    def __init__(self):
        self.calls: List[TraceCall] = []

    def add(self, op: str, axes, x: Optional[torch.Tensor],
            out_shape=None) -> None:
        shape = () if x is None else tuple(x.shape)
        self.calls.append(TraceCall(
            op, tuple(axes),
            "" if x is None else str(x.dtype).replace("torch.", ""),
            shape, caller_outside(__file__),
            shape if out_shape is None else tuple(out_shape)))


_TRACE: Optional[TraceLog] = None


@contextlib.contextmanager
def tracing(log: TraceLog):
    """Record this process's collectives into ``log`` while the block
    runs."""
    global _TRACE
    prev, _TRACE = _TRACE, log
    try:
        yield log
    finally:
        _TRACE = prev


def caller_outside(*files: str) -> str:
    """``file:line`` of the innermost frame that lies in none of
    ``files`` and not in torch (a backward's frames are the autograd
    engine's: its caller is the code that ran ``backward``)."""
    skip = {os.path.abspath(f) for f in files}
    torch_dir = os.path.dirname(os.path.abspath(torch.__file__))
    f = sys._getframe(1)
    while f is not None:
        path = os.path.abspath(f.f_code.co_filename)
        if path not in skip and not path.startswith(torch_dir):
            return f"{path}:{f.f_lineno}"
        f = f.f_back
    return "?"


class _Call:
    """Times one collective into the bound mesh's wire log (and records
    it into the bound trace)."""

    def __init__(self, op: str, axes, x: torch.Tensor, out_shape=None):
        if _TRACE is not None:
            _TRACE.add(op, axes, x, out_shape)
        self.mesh = _MESH
        self.key = (op, "+".join(axes), str(x.dtype).replace("torch.", ""))
        self.dev = x.device if x.is_cuda else None
        self.timed = self.mesh.wire.timed
        if self.timed:
            self._sync()
        self.t0 = time.perf_counter()

    def _sync(self) -> None:
        if self.dev is not None:
            torch.cuda.synchronize(self.dev)

    def done(self, rows: int, nbytes: int) -> None:
        if self.timed:
            self._sync()
        dt = time.perf_counter() - self.t0 if self.timed else 0.0
        self.mesh.wire.add(self.key, rows, nbytes, dt)


def _group(axes: Tuple[str, ...], op: str, x=None):
    """The bound mesh's group over ``axes`` (None for the empty tuple or a
    group of one rank, where the helper is the identity).  An axis the
    mesh lacks is recorded into the bound trace (as ``op``) before the
    mesh raises."""
    if not axes:
        return None
    if _TRACE is not None and _MESH is not None and \
            not set(axes) <= set(_MESH.axes):
        _TRACE.add(op, axes, x)
    g = bound_mesh().group(axes)
    return None if g.size == 1 else g


def _wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the bound mesh's backend moves it: in host memory under
    gloo, where it is."""
    if x.is_cuda and _MESH.backend == "gloo":
        return x.cpu()
    return x


def _rows(x: torch.Tensor) -> int:
    return x.numel() // max(x.shape[-1], 1) if x.dim() > 1 else x.numel()


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _all_reduce(x: torch.Tensor, axes, g, op, what: str) -> torch.Tensor:
    c = _Call(what, axes, x)
    y = _wire(x).clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op, group=g.pg)
    y = y.to(x.device)
    c.done(_rows(x), _nbytes(x))
    return y


class _PSum(torch.autograd.Function):
    """psum; its cotangent is psum'd too."""

    @staticmethod
    def forward(ctx, x, axes, g, label):
        ctx.args = (axes, g, label)
        return _all_reduce(x, axes, g, dist.ReduceOp.SUM, label)

    @staticmethod
    def backward(ctx, ct):
        axes, g, label = ctx.args
        return (_all_reduce(ct, axes, g, dist.ReduceOp.SUM, label + ".grad"),
                None, None, None)


def psum(x, axes: Axes, *, label: str = "psum"):
    """psum over ``axes``; ``label`` is its op in the wire log (the
    training step's gradient sync and norms use their own)."""
    axes = _norm(axes)
    g = _group(axes, label, x)
    if g is None:
        return x
    return _PSum.apply(x, axes, g, label)


def pmax(x, axes: Axes):
    """pmax, which carries no gradient: the input must not need one."""
    axes = _norm(axes)
    g = _group(axes, "pmax", x)
    if g is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        raise ValueError(f"comm.pmax over {axes} has no gradient: detach "
                         f"its input (JAX has no transpose for pmax)")
    return _all_reduce(x, axes, g, dist.ReduceOp.MAX, "pmax")


def _gather(x: torch.Tensor, axes, g, axis: int, tiled: bool,
            what: str) -> torch.Tensor:
    shape = list(x.shape)
    if tiled:
        shape[axis] *= g.size
    else:
        shape.insert(axis % (x.dim() + 1), g.size)
    c = _Call(what, axes, x, shape)
    w = _wire(x).contiguous()
    parts = [torch.empty_like(w) for _ in range(g.size)]
    dist.all_gather(parts, w, group=g.pg)
    out = (torch.cat(parts, dim=axis) if tiled
           else torch.stack(parts, dim=axis)).to(x.device)
    c.done(_rows(x) * (g.size - 1), _nbytes(x) * (g.size - 1))
    return out


def _reduce_scatter(x: torch.Tensor, axes, g, axis: int, tiled: bool,
                    what: str) -> torch.Tensor:
    """``x`` summed over the group, and this rank's block along ``axis``
    kept (its entry, where ``tiled`` is off): one
    ``reduce_scatter_tensor``, which gloo runs too (the same sums as an
    all-reduce, half its bytes).  Logs the bytes this rank sends, all
    blocks but its own."""
    shape = list(x.shape)
    shape[axis] //= g.size
    c = _Call(what, axes, x, shape if tiled else
              shape[:axis] + shape[axis + 1:])
    src = _wire(x.movedim(axis, 0)).contiguous()
    if src.shape[0] % g.size:
        raise ValueError(f"comm.psum_scatter over {axes}: dim {axis} is "
                         f"{src.shape[0]}, not a multiple of {g.size} ranks")
    out = src.new_empty((src.shape[0] // g.size,) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM, group=g.pg)
    out = out.to(x.device).movedim(0, axis)
    c.done(_rows(src) * (g.size - 1) // g.size,
           _nbytes(src) * (g.size - 1) // g.size)
    return out if tiled else out.squeeze(axis)


class _AllGather(torch.autograd.Function):
    """all_gather; its cotangent is psum-scattered."""

    @staticmethod
    def forward(ctx, x, axes, g, axis, tiled, label):
        ctx.args = (axes, g, axis, tiled, label)
        return _gather(x, axes, g, axis, tiled, label)

    @staticmethod
    def backward(ctx, ct):
        axes, g, axis, tiled, label = ctx.args
        return (_reduce_scatter(ct, axes, g, axis, tiled, label + ".grad"),
                None, None, None, None, None)


class _PSumScatter(torch.autograd.Function):
    """psum_scatter; its cotangent is all-gathered."""

    @staticmethod
    def forward(ctx, x, axes, g, axis, tiled, label):
        ctx.args = (axes, g, axis, tiled, label)
        return _reduce_scatter(x, axes, g, axis, tiled, label)

    @staticmethod
    def backward(ctx, ct):
        axes, g, axis, tiled, label = ctx.args
        return (_gather(ct.contiguous(), axes, g, axis, tiled,
                        label + ".grad"),
                None, None, None, None, None)


def all_gather(x, axes: Axes, *, axis: int = 0, tiled: bool = True,
               label: str = "all_gather"):
    """Every rank's ``x`` in group order: concatenated along ``axis``
    (``tiled``) or stacked on a new ``axis``; ``label`` is its op in the
    wire log."""
    axes = _norm(axes)
    g = _group(axes, label, x)
    if g is None:
        return x
    return _AllGather.apply(x, axes, g, axis, tiled, label)


def psum_scatter(x, axes: Axes, *, scatter_dimension: int = 0,
                 tiled: bool = True, label: str = "psum_scatter"):
    """``lax.psum_scatter``: ``x`` summed over ``axes``, and this rank's
    block along ``scatter_dimension`` kept (``tiled``: the dim is cut
    into group-size blocks; else the dim is the group size and this
    rank's entry is taken, the dim dropped).  Its backward is the
    all_gather of the cotangent.  On one device ``x`` (its one entry)."""
    axes = _norm(axes)
    g = _group(axes, label, x)
    if g is None:
        return x if tiled else x.squeeze(scatter_dimension)
    return _PSumScatter.apply(x, axes, g, scatter_dimension, tiled, label)


def barrier(axes: Axes) -> None:
    """Wait until every rank of the group over ``axes`` gets here."""
    g = _group(_norm(axes), "barrier")
    if g is not None:
        if _TRACE is not None:
            _TRACE.add("barrier", _norm(axes), None)
        dist.barrier(group=g.pg)


def _a2a(x: torch.Tensor, axes, g, split_axis: int, concat_axis: int,
         what: str) -> torch.Tensor:
    c = _Call(what, axes, x)
    src = _wire(x.movedim(split_axis, 0)).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=g.pg)
    out = out.to(x.device).movedim(0, concat_axis)
    c.done(_rows(src) * (g.size - 1) // g.size,
           _nbytes(src) * (g.size - 1) // g.size)
    return out


class _AllToAll(torch.autograd.Function):
    """All2All; its cotangent goes back through the inverse All2All (split
    and concat axes swapped)."""

    @staticmethod
    def forward(ctx, x, axes, g, split_axis, concat_axis):
        ctx.args = (axes, g, split_axis, concat_axis)
        return _a2a(x, axes, g, split_axis, concat_axis, "all_to_all")

    @staticmethod
    def backward(ctx, ct):
        axes, g, split_axis, concat_axis = ctx.args
        return (_a2a(ct, axes, g, concat_axis, split_axis, "all_to_all.grad"),
                None, None, None, None)


def all_to_all(x, axes: Axes, *, split_axis: int, concat_axis: int):
    """Non-tiled All2All over ``axes``: ``x.shape[split_axis]`` equals the
    group size P; entry ``p`` along it goes to rank ``p``, and the result
    holds at index ``q`` along ``concat_axis`` what rank ``q`` sent here
    (``lax.all_to_all(tiled=False)``; every caller passes 0 and 0)."""
    axes = _norm(axes)
    g = _group(axes, "all_to_all", x)
    if g is None:
        return x
    if x.shape[split_axis] != g.size:
        raise ValueError(f"comm.all_to_all over {axes}: dim {split_axis} is "
                         f"{x.shape[split_axis]}, the group has {g.size} ranks")
    return _AllToAll.apply(x, axes, g, split_axis, concat_axis)


def axis_index(axes: Axes) -> int:
    """This rank's index in the group over ``axes`` (a host integer)."""
    axes = _norm(axes)
    if not axes:
        return 0
    return bound_mesh().group(axes).index


# ------------------------------------------------------------- ragged All2All
def excl_cumsum(c: torch.Tensor) -> torch.Tensor:
    """Exclusive int32 cumsum: the segment-offset idiom of every ragged
    layout."""
    return torch.cat([torch.zeros((1,), dtype=torch.int32, device=c.device),
                      torch.cumsum(c, 0).to(torch.int32)])[:-1]


def clamped_segment_counts(m: torch.Tensor, recv_rows: int) -> torch.Tensor:
    """Paired clamped sizes of a truncating ragged exchange: from the full
    (P, P) count matrix (``m[s, d]`` rows from source ``s`` to destination
    ``d``) and the receive bound, ``kept[s, d] = clip(recv_rows - off[s, d],
    0, m[s, d])`` with ``off`` the exclusive cumsum down each column.  Row
    ``me`` is a rank's clamped send sizes, column ``me`` its clamped
    receive sizes, so sender and receiver agree on every pair."""
    off = torch.cumsum(m, 0) - m
    return torch.minimum((recv_rows - off).clamp(min=0), m).to(m.dtype)


def native_truncation_plan(m: torch.Tensor, me: int, recv_rows: int):
    """``(send_sizes, out_off, recv_sizes)`` of rank ``me`` in a truncating
    ragged exchange, from the (P, P) count matrix every rank holds: row
    ``me`` and column ``me`` of :func:`clamped_segment_counts`, and where
    each outgoing segment lands in its destination's buffer (the unclamped
    source-major offsets, pinned so that ``out_off + send_sizes <=
    recv_rows``)."""
    kept = clamped_segment_counts(m, recv_rows)
    send_sizes = kept[me]
    recv_sizes = kept[:, me]
    out_off = torch.minimum((torch.cumsum(m, 0) - m)[me],
                            recv_rows - send_sizes)
    return send_sizes, out_off, recv_sizes


def assert_count_i32(counts: torch.Tensor, what: str) -> None:
    """The wire contract is int32 counts everywhere; raise on any other
    dtype (a silent promotion would double the count bytes)."""
    if counts.dtype != torch.int32:
        raise TypeError(f"{what} must be int32 at the collective boundary, "
                        f"got {counts.dtype}")


def exchange_counts(send_counts: torch.Tensor, axes: Axes) -> torch.Tensor:
    """Tell every peer how many rows it will receive: entry ``p`` of the
    result is how many rows rank ``p`` sends here.  The identity on one
    device."""
    assert_count_i32(send_counts, "exchange_counts(send_counts)")
    P = send_counts.shape[0]
    if not _norm(axes) or P == 1:
        return send_counts
    return all_to_all(send_counts.reshape(P, 1), axes, split_axis=0,
                      concat_axis=0).reshape(P)


def ragged_all_to_all(rows: torch.Tensor, send_counts: torch.Tensor,
                      axes: Axes, *, recv_rows: int,
                      seg_rows: Optional[int] = None,
                      recv_counts: Optional[torch.Tensor] = None,
                      allow_truncate: bool = False,
                      arrive_counts: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All2All of exact per-peer row segments.

    ``rows`` (R, ...) holds, in rank order, the segment for each peer
    (``send_counts`` (P,) rows each, at their exclusive cumsum);
    ``recv_rows`` is the size of the received layout, and ``recv_counts``
    the per-source lengths when the caller knows them (else one count
    exchange runs).  Returns ``(recv (recv_rows, ...), recv_counts (P,))``:
    source ``p``'s segment at the exclusive cumsum of ``recv_counts``,
    zeros after the last.  Calling again with ``send_counts=recv_counts``
    routes each segment back to its origin: the reverse hop.
    ``seg_rows`` bounds one segment for the JAX package's emulations and
    is not needed here.

    Over a group the exchange is one ``all_to_all_single`` with
    ``input_split_sizes`` / ``output_split_sizes``, which are host
    integers: the counts are read on the host once per call (so this path
    cannot be captured in a CUDA graph).  With ``allow_truncate`` the
    receive bound may be smaller than the arrivals: segments are cut where
    they would pass ``recv_rows`` (a prefix of each source's segment
    survives, the rest never moves), both sides sized from the (P, P)
    count matrix that one all_gather gives every rank
    (:func:`native_truncation_plan`), as the JAX package's native path
    does.  Without it, arrivals past the bound raise.  On one device
    ``recv`` is ``rows`` zero-padded or cut to ``recv_rows`` (``rows``
    itself when it has ``recv_rows`` rows), with ``recv_counts =
    send_counts``.

    ``arrive_counts`` (P,) are the rows each source really sends here,
    where the receiver's belief ``recv_counts`` may part from them (a
    quarantined or rewritten count grid): the exchange moves what the
    peers send, sized by ``arrive_counts``, and lays out what the receiver
    believes: source ``p``'s row ``i < recv_counts[p]`` at the exclusive
    cumsum of ``recv_counts`` is its arrived row ``i`` while ``i <
    arrive_counts[p]``, zero past it; arrived rows past the belief are
    discarded, and rows past ``recv_rows`` cut (no truncating plan: every
    arrival moves).  Where the belief passes what was sent, the JAX
    package's emulations read the sender's next staged rows there; this
    exchange reads zeros.  Where they agree it is the plain exchange.
    """
    assert_count_i32(send_counts, "ragged_all_to_all(send_counts)")
    if recv_counts is not None:
        assert_count_i32(recv_counts, "ragged_all_to_all(recv_counts)")
    naxes = _norm(axes)
    g = _group(naxes, "ragged_all_to_all", rows)
    rest = tuple(rows.shape[1:])
    if g is None:
        if rows.shape[0] == recv_rows:
            return rows, send_counts
        out = rows.new_zeros((recv_rows,) + rest)
        n = min(recv_rows, rows.shape[0])
        out[:n] = rows[:n]
        return out, send_counts
    if recv_counts is None:
        recv_counts = exchange_counts(send_counts, naxes)
    if arrive_counts is not None:
        assert_count_i32(arrive_counts, "ragged_all_to_all(arrive_counts)")
        sc, rc, ac = (meta.split_sizes(c, n) for c, n in (
            (send_counts, rows.shape[0]), (recv_counts, recv_rows),
            (arrive_counts, recv_rows)))
        place = (None if ac == rc and sum(rc) <= recv_rows
                 else _belief_layout(ac, rc, recv_rows))
        out = _Ragged.apply(rows, naxes, g, sc, sc, ac, recv_rows, place)
        return out, recv_counts
    sc = meta.split_sizes(send_counts, rows.shape[0])
    rc = meta.split_sizes(recv_counts, recv_rows)
    if allow_truncate and not meta.is_meta(send_counts):
        m = all_gather(send_counts, naxes, tiled=False).cpu()     # (P, P)
        send_sizes, _, recv_sizes = native_truncation_plan(m, g.index,
                                                           recv_rows)
        ssz, rsz = send_sizes.tolist(), recv_sizes.tolist()
    else:
        if sum(rc) > recv_rows:
            raise ValueError(f"ragged_all_to_all over {naxes}: {sum(rc)} rows "
                             f"arrive past the receive bound {recv_rows} "
                             f"(pass allow_truncate=True to cut them)")
        ssz, rsz = sc, rc
    out = _Ragged.apply(rows, naxes, g, sc, ssz, rsz, recv_rows, None)
    return out, recv_counts


def _belief_layout(ac: List[int], rc: List[int], recv_rows: int
                   ) -> List[Tuple[int, int, int]]:
    """The copies ``(arrived row, out row, rows)`` that lay arrivals of
    ``ac[p]`` rows a source out as the receiver believes (``rc[p]`` rows a
    source at their exclusive cumsum), cut at ``recv_rows``."""
    place, a, o = [], 0, 0
    for n_a, n_r in zip(ac, rc):
        n = max(min(n_a, n_r, recv_rows - o), 0)
        if n:
            place.append((a, o, n))
        a += n_a
        o += n_r
    return place


def _exchange(x: torch.Tensor, axes, g, ssz: List[int], rsz: List[int],
              recv_rows: int, what: str, place=None) -> torch.Tensor:
    """One ``all_to_all_single`` of the compact segments ``x`` (``ssz[p]``
    rows for peer ``p``, one after another): the ``rsz`` rows that arrive,
    source-major at row 0 of a zero slab of ``recv_rows``, or copied to
    it by ``place`` (``(arrived row, out row, rows)`` triples).  Only
    copies touch the rows: a checksummed wire's parity rows are integers
    in float lanes."""
    rest = tuple(x.shape[1:])
    c = _Call(what, axes, x, (recv_rows,) + rest)
    send = _wire(x).contiguous()
    got = send.new_empty((sum(rsz),) + rest)
    dist.all_to_all_single(got, send, rsz, ssz, group=g.pg)
    out = x.new_zeros((recv_rows,) + rest)
    if place is None:
        out[:got.shape[0]] = got
    else:
        for a, o, n in place:
            out[o:o + n] = got[a:a + n]
    sent = sum(ssz) - ssz[g.index]
    c.done(sent, sent * math.prod(rest) * x.element_size())
    return out


class _Ragged(torch.autograd.Function):
    """The ragged exchange: segment ``p`` is the first ``ssz[p]`` of the
    ``sc[p]`` rows at the exclusive cumsum of ``sc``; what arrives lies
    source-major from row 0, or where ``place`` copies it.  The backward
    gathers the cotangent of the arrived rows, sends it back with the
    sizes swapped and puts each segment's at its rows (the rows a
    truncation cut or a belief discarded, and rows past the segments, get
    zero)."""

    @staticmethod
    def forward(ctx, rows, axes, g, sc, ssz, rsz, recv_rows, place):
        starts = [sum(sc[:i]) for i in range(len(sc))]
        ctx.args = (axes, g, ssz, rsz, starts, rows.shape[0], place)
        send = (rows[:sum(sc)] if ssz == sc else
                torch.cat([rows[o:o + n] for o, n in zip(starts, ssz)]))
        return _exchange(send, axes, g, ssz, rsz, recv_rows,
                         "ragged_all_to_all", place)

    @staticmethod
    def backward(ctx, ct):
        axes, g, ssz, rsz, starts, R, place = ctx.args
        if place is None:
            arrived = ct[:sum(rsz)]
        else:
            arrived = ct.new_zeros((sum(rsz),) + tuple(ct.shape[1:]))
            for a, o, n in place:
                arrived[a:a + n] = ct[o:o + n]
        back = _exchange(arrived, axes, g, rsz, ssz, sum(ssz),
                         "ragged_all_to_all.grad")
        out = back.new_zeros((R,) + tuple(back.shape[1:]))
        o = 0
        for s, n in zip(starts, ssz):
            out[s:s + n] = back[o:o + n]
            o += n
        return out, None, None, None, None, None, None, None


# --------------------------------------------------- wire integrity (parity)
# Fold multipliers of the per-segment integrity word: both odd (units mod
# 2^32, so distinct lengths and tags map to distinct residues) and far
# apart, so that a one-row value delta cannot mimic either.
WIRE_LEN_MULT = 1000003
WIRE_TAG_MULT = 777767777

_LANE_INT = {4: torch.int32, 2: torch.int16}


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """An int64 tensor wrapped to int32 (two's complement), explicitly, the
    same on every device."""
    return ((x + 2**31) % 2**32 - 2**31).to(torch.int32)


def int_lane_view(rows: torch.Tensor) -> torch.Tensor:
    """A float slab's bits as int32 lanes (16-bit lanes sign-extended); no
    gradient.  The fold of a bf16 slab and of its fp32 upcast differ: folds
    compare only with folds of the same payload dtype."""
    return rows.detach().view(_LANE_INT[rows.element_size()]).to(torch.int32)


def words_to_rows(words: torch.Tensor, dtype) -> torch.Tensor:
    """Int32 integrity words stored as rows of a ``dtype`` slab: a 32-bit
    lane holds the whole word, a 16-bit lane its low half (the even
    elements of the little-endian int16 view)."""
    assert_count_i32(words, "words_to_rows(words)")
    if dtype.itemsize == 4:
        return words.view(dtype)
    return words.view(torch.int16)[..., 0::2].contiguous().view(dtype)


def stored_words(words: torch.Tensor, dtype) -> torch.Tensor:
    """Int32 words projected onto what a ``dtype`` slab round-trips: the
    domain in which expected words are compared with received parity rows
    (a 16-bit row holds only the low half)."""
    return int_lane_view(words_to_rows(words, dtype))


def segment_bounds(off: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """(S+1,) bounds of concatenated segments: their offsets and the end
    of the last."""
    return torch.cat([off, off[-1:] + counts[-1:]])


def segment_parity_words(rows: torch.Tensor, bounds: torch.Tensor,
                         lens: torch.Tensor, tags: torch.Tensor
                         ) -> torch.Tensor:
    """The integrity word of each segment of a concatenated-segments slab.

    ``rows`` (R, d); ``bounds`` (S+1,) ascending segment offsets (segment
    ``s`` spans ``[bounds[s], bounds[s+1])``, its first ``lens[s]`` rows
    occupied); ``tags`` (S,) the identity tag of each.  Returns (S, d)
    int32: the wrapping sum of the occupied rows' int32 lanes plus ``lens
    * WIRE_LEN_MULT + tags * WIRE_TAG_MULT``.  The fold is an int32
    ``index_add_``, which wraps and does not depend on the order of its
    adds; the length and tag term is taken in int64 and wrapped.
    """
    assert_count_i32(lens, "segment_parity_words(lens)")
    assert_count_i32(tags, "segment_parity_words(tags)")
    S = lens.shape[0]
    seg, _, valid = ragged_row_membership(bounds, lens, rows.shape[0])
    contrib = torch.where(valid[:, None], int_lane_view(rows), 0)
    fold = torch.zeros((S, rows.shape[1]), dtype=torch.int32,
                       device=rows.device)
    fold.index_add_(0, torch.where(valid, seg, 0).long(), contrib)
    term = lens.long() * WIRE_LEN_MULT + tags.long() * WIRE_TAG_MULT
    return _wrap_i32(fold.long() + term[:, None])


def checksummed_ragged_all_to_all(rows: torch.Tensor, parity: torch.Tensor,
                                  send_counts: torch.Tensor, axes: Axes, *,
                                  recv_rows: int, recv_counts: torch.Tensor,
                                  nl: int, allow_truncate: bool = False,
                                  arrive_counts: Optional[torch.Tensor] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A ragged exchange with per-segment parity rows riding the slab.

    ``rows`` (R, d) staged as :func:`ragged_all_to_all` takes them;
    ``parity`` (P*nl, d) parity rows in the payload dtype, destination-
    major (rows ``p*nl:(p+1)*nl`` ride at the tail of peer ``p``'s
    segment).  ``recv_counts`` (and ``arrive_counts``, where the belief may
    part from what arrives) are per-source data counts; the wire moves
    ``send_counts + nl`` rows a peer and ``recv_rows`` bounds the wire
    layout.  Returns ``(wire_recv, wire_recv_counts)``, which
    :func:`split_checksummed_recv` splits.  One gather builds the
    interleaved staging and one ordinary ragged exchange of the widened
    counts moves it: no extra collective.
    """
    assert_count_i32(send_counts, "checksummed_ragged_all_to_all(send_counts)")
    assert_count_i32(recv_counts, "checksummed_ragged_all_to_all(recv_counts)")
    P, R = send_counts.shape[0], rows.shape[0]
    scw = send_counts + nl
    seg, within, valid = ragged_row_membership(
        segment_bounds(excl_cumsum(scw), scw), scw, R + P * nl)
    sc_seg = send_counts[seg.long()]
    src = torch.where(within < sc_seg,
                      excl_cumsum(send_counts)[seg.long()] + within,
                      R + seg * nl + (within - sc_seg))
    ext = torch.cat([rows, parity.to(rows.dtype)])
    wire = torch.where(valid[:, None],
                       ext[torch.where(valid, src, 0).long()], 0)
    return ragged_all_to_all(
        wire, scw, axes, recv_rows=recv_rows, recv_counts=recv_counts + nl,
        allow_truncate=allow_truncate,
        arrive_counts=None if arrive_counts is None else arrive_counts + nl)


def split_checksummed_recv(wire: torch.Tensor, recv_counts: torch.Tensor,
                           nl: int, recv_rows: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A checksummed receive split back into the payload slab and the
    parity rows.  ``recv_counts`` (P,) believed data counts; ``recv_rows``
    the data slab's bound.  Returns ``(data (recv_rows, d), parity (P, nl,
    d))``: ``data`` laid out as the plain receive (source ``p`` at the
    exclusive cumsum of ``recv_counts``, zero elsewhere).  Gathers clamp at
    the slab's edge, so a caller that truncated the wire masks the sources
    whose region did not fully arrive."""
    assert_count_i32(recv_counts, "split_checksummed_recv(recv_counts)")
    P = recv_counts.shape[0]
    rest = tuple(wire.shape[1:])
    woff = excl_cumsum(recv_counts + nl)
    seg, within, valid = ragged_row_membership(
        segment_bounds(excl_cumsum(recv_counts), recv_counts), recv_counts,
        recv_rows)
    last = wire.shape[0] - 1
    src = torch.where(valid, woff[seg.long()] + within, 0).clamp(max=last)
    data = torch.where(valid.reshape((-1,) + (1,) * len(rest)),
                       wire[src.long()], 0)
    pidx = (woff[:, None] + recv_counts[:, None]
            + torch.arange(nl, dtype=torch.int32, device=wire.device)[None])
    parity = wire[pidx.reshape(-1).clamp(max=last).long()]
    return data, parity.reshape((P, nl) + rest)


def name_saved(x):
    """Identity: the JAX package tags collective outputs for its remat
    policy here; eager PyTorch has no such policy."""
    return x


# ---------------------------------------------------------------- token split
def split_tokens(x: torch.Tensor, plan_axes: Axes, size: int):
    """Evenly split the leading (token) dim of ``x`` across ``plan_axes``
    (``size`` ranks), padding it to a multiple of ``size`` first; returns
    ``(local, pad)`` with ``pad`` the padding rows added globally.  On one
    device the local shard is the whole (padded) array."""
    pad = (-x.shape[0]) % size
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    if not _norm(plan_axes):
        return x, pad
    per = x.shape[0] // size
    i = axis_index(plan_axes)
    return x[i * per:(i + 1) * per], pad


def unsplit_tokens(local: torch.Tensor, plan_axes: Axes, orig_len: int):
    """Inverse of :func:`split_tokens`: all_gather the shards in rank order
    and drop the padding rows."""
    if _norm(plan_axes):
        local = all_gather(local, plan_axes, axis=0, tiled=True)
    return local[:orig_len]
