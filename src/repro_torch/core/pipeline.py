"""Composable hop-pipeline IR for MoE routing schedules.

The port of ``repro.core.pipeline``.  Switch is ONE flat dispatch hop over
the whole expert grid; SMILE is TWO nested hops (inter-node, then
intra-node on the arrived tokens).  The schedules only *declare* their hops:

* :class:`RouteDecision` — one router's verdict for one hop;
* :class:`HopSpec` — the static schedule of one hop (groups, exchange kind,
  capacity, rank-major relabeling);
* :class:`ExpertHop` — a ``route`` callable bound to its :class:`HopSpec`;
* :func:`execute_pipeline` — the executor both schedules share: route ->
  dispatch -> exchange -> inner compute (the next hop, or the expert FFN) ->
  reverse exchange -> gate-weighted combine, accumulating one
  :class:`MoEStats`.

Three exchanges: ``padded`` (the capacity buffer of the ``sort`` and
``dense`` backends, and of ``dropless`` with ``ragged_a2a=False``: a
fixed-shape All2All), ``local`` (the dropless innermost hop on one rank:
the expert FFN straight over the tile-aligned ragged layout) and ``ragged``
(the dropless hops over ranks: exact tile-aligned segments on the wire, a
single-rank copy on one).  The ragged hop's clamped receive bound
(``recv_bound_factor``) cuts what arrives past the bound and echoes the
kept counts back on the reverse hop.

**Fault containment.**  The exchanged count grid is never trusted
(:func:`sanitize_len_grid`), and ``cfg.fault_plan``
(:mod:`repro_torch.common.faultinject`) injects faults at the hop
boundaries: count-grid corruption before the sanitizer, NaN rows into the
dispatch or receive buffers, a routing-skew storm onto the route decision,
and corruption of the received wire slab.  ``HopSpec.wire_integrity`` arms
per-segment checksums on both directions of every ragged exchange over
ranks (the parity-row wire of :mod:`repro_torch.sharding.comm`): each
flagged source is one ``fault_events`` count and one ``wire_faults[hop,
src]`` count, and ``"quarantine"`` drops its segment with exact drop
accounting through the echoed reverse hop, so a corrupting peer costs its
own tokens.  ``fault_plan=None`` with ``wire_integrity="off"`` runs the
plain path, op for op and collective for collective.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common import faultinject as FI
from repro_torch.core import dispatch as D
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.sharding import comm

# hop slots in the fixed-shape per-hop vectors (switch uses 1, SMILE 2)
MAX_HOPS = 2
# source-rank bins of MoEStats.wire_faults (ranks folded mod this; fixed so
# that stats of different meshes add)
WIRE_SRC_BINS = 16

EXCHANGES = ("local", "padded", "ragged")
WIRE_POLICIES = ("off", "detect", "quarantine")


# =============================================================================
# Layer stats
# =============================================================================

@dataclasses.dataclass
class MoEStats:
    """Aux outputs of a MoE layer (fp32 scalars / fixed-shape vectors), the
    fields of ``repro.core.pipeline.MoEStats``: summed LB and z losses,
    ``drop_frac`` (summed over hops) with its per-hop breakdown, and the
    router-collapse watchdog inputs (max load fraction, normalized load
    entropy per hop).  ``fault_events`` counts, per hop, the count-grid
    entries :func:`sanitize_len_grid` rejected on ragged hops plus the wire
    segments the checksum layer flagged (psum'd over the sync axes, summed
    over layers); ``wire_faults[hop, s]`` is the number of (receiver,
    direction) checks that flagged source rank ``s`` (mod
    :data:`WIRE_SRC_BINS`), all zero with the wire off or healthy.

    **Who reads what.**  Each entry point names the fields its caller
    reads (``read_stats`` of :func:`execute_pipeline` and
    ``models.transformer.forward``), and the executor computes and psums
    only those; a field left out holds its :func:`zero_stats` value.  The
    reference gets the same from ``jit``'s dead-code elimination.

    * training (``train.step``) and a direct ``forward()`` call read every
      field (:data:`ALL_STATS`): the losses, the logged drop and fault
      counts, the sentinel's watchdog fields;
    * the engine's paged steps read ``serve.engine.ENGINE_STATS``, the
      four numbers each tick packs;
    * the fixed-batch ``serve.decode.prefill_fn`` and ``decode_step_fn``
      read none: they issue no statistics collective.

    Field by field: ``lb_loss`` takes a hop's token count ``cnt``, its
    top-1 fractions ``f`` and its mean probabilities ``P`` (three psums);
    ``hop_max_load`` and ``hop_load_entropy`` take ``cnt`` and ``f``;
    ``z_loss`` its own two psums (none at a zero coefficient);
    ``drop_frac`` and ``hop_drop_frac`` a hop's two drop counts (on a
    padded hop, or a ragged hop that echoes); ``fault_events`` one psum a
    layer and ``wire_faults`` one more with an armed wire."""
    lb_loss: torch.Tensor
    z_loss: torch.Tensor
    drop_frac: torch.Tensor
    hop_drop_frac: torch.Tensor     # (MAX_HOPS,)
    fault_events: torch.Tensor      # (MAX_HOPS,)
    hop_max_load: torch.Tensor      # (MAX_HOPS,)
    hop_load_entropy: torch.Tensor  # (MAX_HOPS,)
    wire_faults: torch.Tensor       # (MAX_HOPS, WIRE_SRC_BINS)


ALL_STATS = frozenset(f.name for f in dataclasses.fields(MoEStats))


def zero_stats(device=None) -> MoEStats:
    z = torch.zeros((), dtype=torch.float32, device=device)
    zv = torch.zeros((MAX_HOPS,), dtype=torch.float32, device=device)
    return MoEStats(z, z.clone(), z.clone(), zv, zv.clone(), zv.clone(),
                    torch.ones((MAX_HOPS,), dtype=torch.float32,
                               device=device),
                    torch.zeros((MAX_HOPS, WIRE_SRC_BINS),
                                dtype=torch.float32, device=device))


# =============================================================================
# Routing losses
# =============================================================================

def lb_loss_terms(probs: torch.Tensor, top1: torch.Tensor,
                  valid: torch.Tensor, num_groups: int, sync_axes, *,
                  want_p: bool = True
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Globally-averaged (f, P) vectors for one router (paper Eq. 4):
    ``f_i`` the fraction of tokens whose argmax picked group i, ``P_i`` the
    mean router probability on group i (None, and no psum, without
    ``want_p``).  No backward reads ``P``'s sum (the loss's gradient
    through it is ``f`` over the count): a remat replay keeps it local."""
    v = valid.float()
    cnt = comm.psum(v.sum(), sync_axes)
    one = F.one_hot(top1.long(), num_groups).float() * v[:, None]
    f = comm.psum(one.sum(0), sync_axes) / torch.clamp(cnt, min=1.0)
    if not want_p:
        return f, None
    p = comm.psum((probs * v[:, None]).sum(0), sync_axes,
                  replay=False) / torch.clamp(cnt, min=1.0)
    return f, p


def scaled_lb_loss(f: torch.Tensor, p: torch.Tensor,
                   coef: float) -> torch.Tensor:
    """``coef * groups * sum_i f_i P_i`` — min = coef at uniform routing."""
    return coef * f.shape[0] * torch.sum(f * p)


def z_loss(logits: torch.Tensor, valid: torch.Tensor, coef: float,
           sync_axes) -> torch.Tensor:
    if coef == 0.0:
        return torch.zeros((), dtype=torch.float32, device=logits.device)
    lse = torch.logsumexp(logits, dim=-1)
    v = valid.float()
    # no backward reads the sum itself: a remat replay keeps it local
    s = comm.psum((lse.square() * v).sum(), sync_axes, replay=False)
    cnt = comm.psum(v.sum(), sync_axes)
    return coef * s / torch.clamp(cnt, min=1.0)


# =============================================================================
# Expert FFN flavours (padded / ragged / compact)
# =============================================================================

def experts_ffn(w: Dict[str, torch.Tensor], x: torch.Tensor, act: str,
                use_kernel: bool = False) -> torch.Tensor:
    """Per-group expert FFN.  ``x``: (G, T, d); weights (G, d, f)/(G, f, d)
    in ``x.dtype`` (the model casts them once at load).

    ``use_kernel=True`` runs the grouped-FFN kernel (fp32 accumulation, one
    bf16 rounding of ``h`` and of the output); ``False`` mirrors the JAX
    package's einsum path, which rounds every product to ``x.dtype``.
    """
    w3 = w.get("w3")
    if use_kernel:
        return kops.grouped_ffn(x.contiguous(), w["w1"], w3, w["w2"], act=act)
    h = ref.activation(torch.bmm(x, w["w1"]), act)
    if w3 is not None:
        h = h * torch.bmm(x, w3)
    return torch.bmm(h, w["w2"])


def experts_ffn_ragged(w: Dict[str, torch.Tensor], rows: torch.Tensor,
                       group_starts: torch.Tensor, act: str, *, block: int,
                       use_kernel: bool = False) -> torch.Tensor:
    """Expert FFN over the dropless tile-aligned ragged layout.

    ``rows``: (R, d) from :func:`repro_torch.core.dispatch.dispatch_ragged`;
    ``group_starts``: (G+1,) aligned segment offsets; ``block``: the row
    tile.  ``use_kernel=True`` runs the ragged grouped-FFN kernel; ``False``
    mirrors the JAX package's batched matmul over row tiles with each
    tile's weights gathered (every product rounded to ``rows.dtype``).
    """
    w3 = w.get("w3")
    if use_kernel:
        return kops.grouped_ffn_ragged(rows.contiguous(), group_starts,
                                       w["w1"], w3, w["w2"], block=block,
                                       act=act)
    R, d = rows.shape
    tile_gid = D.ragged_tile_gids(group_starts, R // block, block).long()
    xt = rows.reshape(R // block, block, d)
    h = ref.activation(torch.bmm(xt, w["w1"][tile_gid].to(rows.dtype)), act)
    if w3 is not None:
        h = h * torch.bmm(xt, w3[tile_gid].to(rows.dtype))
    return torch.bmm(h, w["w2"][tile_gid].to(rows.dtype)).reshape(R, d)


def experts_ffn_compact_rows(w: Dict[str, torch.Tensor], rows: torch.Tensor,
                             gid: torch.Tensor, valid: torch.Tensor,
                             num_groups: int, act: str,
                             use_kernel: bool = False,
                             sort_impl: str = "argsort") -> torch.Tensor:
    """Dropless expert compute over received rows with per-row group ids.

    ``rows``: (S, d) arrived slab; ``gid``/``valid``: (S,) local group and
    real-row flag per row.  Compacts the valid rows into the ragged layout,
    runs the FFN over exact segment lengths, and reads the results back to
    the slab's rows (invalid rows stay zero).
    """
    ones = torch.ones((rows.shape[0],), dtype=torch.float32,
                      device=rows.device)
    r2, starts, st = D.dispatch_ragged(rows, gid, ones, num_groups, k=1,
                                       valid=valid, use_kernel=use_kernel,
                                       sort_impl=sort_impl)
    out = experts_ffn_ragged(w, r2, starts, act, block=st.cap,
                             use_kernel=use_kernel)
    return D.combine(out, st)


def experts_ffn_compact(w: Dict[str, torch.Tensor], recv: torch.Tensor,
                        valid: torch.Tensor, act: str,
                        use_kernel: bool = False,
                        sort_impl: str = "argsort") -> torch.Tensor:
    """Dropless expert compute over a received (G, S, d) capacity buffer
    (``valid``: (G, S) bool): the occupied slots go through
    :func:`experts_ffn_compact_rows`, empty slots stay zero."""
    G, S, d = recv.shape
    rgid = torch.arange(G, dtype=torch.int32,
                        device=recv.device).repeat_interleave(S)
    out = experts_ffn_compact_rows(w, recv.reshape(G * S, d), rgid,
                                   valid.reshape(-1), G, act,
                                   use_kernel=use_kernel,
                                   sort_impl=sort_impl)
    return out.reshape(G, S, d)


# =============================================================================
# The IR
# =============================================================================

@dataclasses.dataclass
class RouteDecision:
    """One router's verdict for one hop.  Per-assignment arrays are flat
    ``(A = t * k,)``; assignment ``a`` belongs to token ``a // k``.
    ``group_ids`` are canonical virtual-group ids; the executor applies
    ``spec.perm``."""
    gates: torch.Tensor          # (A,) combine weights
    group_ids: torch.Tensor      # (A,) canonical virtual destination groups
    valid: torch.Tensor          # (A,) assignment validity
    token_valid: torch.Tensor    # (t,) token validity (losses)
    probs: torch.Tensor          # (t, loss_groups)
    logits: torch.Tensor         # (t, loss_groups)
    top1: torch.Tensor           # (t,) router argmax (LB loss f-vector)
    k: int                       # assignments per token


@dataclasses.dataclass
class HopSpec:
    """Static schedule of one dispatch hop (see ``repro.core.pipeline``).
    ``perm`` relabels canonical group ids rank-major; None = identity."""
    name: str
    axes: Tuple[str, ...]
    n_ranks: int
    num_groups: int
    exchange: str
    capacity: int = 0
    perm: Optional[torch.Tensor] = None
    recv_bound_factor: Optional[float] = None
    lb_coef: float = 0.0
    loss_groups: int = 0
    wire_integrity: str = "off"

    def __post_init__(self):
        if self.exchange not in EXCHANGES:
            raise ValueError(f"unknown exchange {self.exchange!r}; "
                             f"expected one of {EXCHANGES}")
        if self.wire_integrity not in WIRE_POLICIES:
            raise ValueError(f"unknown wire_integrity "
                             f"{self.wire_integrity!r}; expected one of "
                             f"{WIRE_POLICIES}")
        if self.num_groups % max(self.n_ranks, 1):
            raise ValueError(f"num_groups {self.num_groups} must fold onto "
                             f"{self.n_ranks} ranks")

    @property
    def groups_per_rank(self) -> int:
        return self.num_groups // max(self.n_ranks, 1)


@dataclasses.dataclass
class ExpertHop:
    """One pipeline stage: ``route(x, token_valid, outer_gid) ->
    RouteDecision`` bound to its hop schedule."""
    route: Callable[[torch.Tensor, torch.Tensor, Optional[torch.Tensor]],
                    RouteDecision]
    spec: HopSpec


# =============================================================================
# Rank-major fold/unfold (padded exchange)
# =============================================================================

def _fold_a2a(buf: torch.Tensor, groups: int, mesh_axes,
              mesh_size: int) -> torch.Tensor:
    """All2All a (groups, ...) buffer over the hop's mesh axes; the
    identity on a size-1 mesh."""
    if mesh_size == 1:
        return buf
    b = groups // mesh_size
    rest = tuple(buf.shape[1:])
    buf = comm.all_to_all(buf.reshape((mesh_size, b) + rest), mesh_axes,
                          split_axis=0, concat_axis=0)
    return buf.reshape((mesh_size * b,) + rest)


def _fold(z: torch.Tensor, spec: HopSpec) -> torch.Tensor:
    """(V, cap, ...) rank-major -> (gpr, P*cap, ...): each local group holds
    the arrivals from every source rank, source-major."""
    P, gpr = spec.n_ranks, spec.groups_per_rank
    rest = tuple(z.shape[1:])
    z = _fold_a2a(z, spec.num_groups, spec.axes, P)
    z = z.reshape((P, gpr) + rest).movedim(1, 0)
    return z.reshape((gpr, P * rest[0]) + rest[1:])


def _unfold(y: torch.Tensor, spec: HopSpec, cap: int) -> torch.Tensor:
    """Reverse exchange: the exact mirror of :func:`_fold`."""
    P, gpr = spec.n_ranks, spec.groups_per_rank
    rest = tuple(y.shape[2:])
    y = y.reshape((gpr, P, cap) + rest).movedim(1, 0)
    y = y.reshape((spec.num_groups, cap) + rest)
    return _fold_a2a(y, spec.num_groups, spec.axes, P)


# =============================================================================
# Ragged exchange
# =============================================================================

def recv_bound_rows(factor: float, rows: int, n_ranks: int,
                    groups_per_rank: int, block: int) -> int:
    """Static bounded receive-slab size of a clamped ragged hop: ``factor``
    times the sender's rows plus one tile of slack per (source, local
    group), rounded up to the tile, never above ``P x R``."""
    slack = n_ranks * groups_per_rank * block
    b = int(math.ceil(factor * rows)) + slack
    b = ((b + block - 1) // block) * block
    return min(b, n_ranks * rows)


def sanitize_len_grid(len_grid: torch.Tensor, block: int, src_rows: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Validate an exchanged ``(P, nl)`` count grid; quarantine bad sources.

    A negative entry, or a source whose tile-aligned running row total
    passes its ``src_rows`` staging bound, marks its whole source row bad,
    and the row is zeroed.  Returns ``(grid, events, src_bad)``: the
    sanitized grid, the number of violating entries (fp32 scalar, the hop's
    ``fault_events``), and the (P,) per-source quarantine mask.  The
    identity, with ``events == 0``, on a healthy grid.
    """
    aligned = ((len_grid + block - 1) // block) * block
    neg = len_grid < 0
    over = torch.cumsum(torch.where(neg, torch.zeros_like(aligned), aligned),
                        dim=1) > src_rows
    bad = neg | over
    src_bad = bad.any(dim=1)
    grid = torch.where(src_bad[:, None], torch.zeros_like(len_grid), len_grid)
    return grid, bad.sum().to(torch.float32), src_bad


@dataclasses.dataclass
class _RaggedHopState:
    """Everything the reverse of one ragged hop needs."""
    recv: torch.Tensor            # (B, d) received slab
    gid: torch.Tensor             # (B,) local group per slab row
    valid: torch.Tensor           # (B,) real-row flag per slab row
    recv_counts: torch.Tensor     # (P,) aligned rows per source
    send_counts: torch.Tensor     # (P,) aligned rows sent per destination
    kept: Optional[torch.Tensor]  # (P,) rows kept per source after a clamp
    rows_out: int                 # R: sender layout rows


def _aligned(len_grid: torch.Tensor, block: int) -> torch.Tensor:
    return ((len_grid + block - 1) // block) * block


def _wire_tags(me: int, P: int, nl: int, incoming: bool,
               device) -> torch.Tensor:
    """(P*nl,) int32 identity tags of a wire's segments, flat-ordered:
    ``tag = (src * P + dst) * nl + g``, outgoing tags with ``src = me``,
    incoming with ``dst = me`` (a replayed segment carries the wrong
    ``src``)."""
    other = torch.arange(P, dtype=torch.int32,
                         device=device).repeat_interleave(nl)
    g = torch.arange(nl, dtype=torch.int32, device=device).repeat(P)
    src, dst = (other, me) if incoming else (me, other)
    return (src * P + dst) * nl + g


def _ragged_forward(rows: torch.Tensor, group_starts: torch.Tensor,
                    seg_lens: torch.Tensor, spec: HopSpec, block: int,
                    fp: Optional[FI.FaultPlan] = None, level: int = 0
                    ) -> Tuple[_RaggedHopState, torch.Tensor,
                               Optional[torch.Tensor]]:
    """Forward ragged All2All of one dispatch hop: exact tile-aligned
    segments plus the (P, nl) count grid, from which the received slab's
    per-row structure is rebuilt.  Returns ``(state, sanitizer events,
    per-source wire verdicts or None)``.

    Unclamped, the slab is the worst-case ``P x R`` rows (nothing can
    drop).  With ``spec.recv_bound_factor`` and a bound below that, the
    slab is :func:`recv_bound_rows` rows: each source lands at its aligned
    offset and what falls past the bound is cut (a prefix survives), and
    ``kept`` records the rows kept of each source for the reverse hop's
    echo.

    ``fp`` injects faults at this ``level`` in the reference's order: the
    grid kinds before the sanitizer, ``nanrows`` on the plain receive, the
    wire kinds on the received wire slab.  A plan that rewrites the grid
    makes the receiver's belief part from what the peers send: the
    exchange then moves what each peer ships (the aligned row totals of
    the grid as it arrived) and lays out what the receiver believes
    (``comm.ragged_all_to_all``'s ``arrive_counts``; where the belief
    passes the sent segment the reference reads the sender's next staged
    rows and this port zeros), a bounded hop receiving every arrival and
    cutting the believed layout at the bound; and ``kept`` echoes the
    believed counts so that the senders learn which rows died.

    With ``spec.wire_integrity`` armed on a wire (``P > 1``) the exchange
    rides :func:`repro_torch.sharding.comm.checksummed_ragged_all_to_all`:
    the receiver recomputes each (src, group) word from the payload and
    the counts it believes, and a mismatching source (one not already
    quarantined by the sanitizer) is flagged; ``"quarantine"`` zero-fills
    its rows, drops their validity and echoes ``kept = 0`` for it.
    """
    P, nl = spec.n_ranks, spec.groups_per_rank
    R = rows.shape[0]
    dev = rows.device
    send_counts = D.ragged_send_counts(group_starts, nl)
    comm.assert_count_i32(seg_lens, "_ragged_forward(seg_lens)")
    len_grid = comm.all_to_all(seg_lens.reshape(P, nl), spec.axes,
                               split_axis=0, concat_axis=0)
    inject = fp is not None and fp.targets(level)
    arrived = (_aligned(len_grid, block).sum(dim=1).to(torch.int32)
               if fp is not None and fp.wants_echo and P > 1 else None)
    if inject and fp.kind == "counts":
        len_grid = FI.corrupt_len_grid(fp, level, len_grid)
    if inject and fp.kind == "dropseg":
        len_grid = FI.drop_segment(fp, level, len_grid)
    if inject and fp.kind == "inflate":
        len_grid = FI.inflate_grid(fp, level, len_grid)
    if inject and fp.kind == "dupseg":
        len_grid = FI.dup_grid(fp, level, len_grid)
    len_grid, events, san_bad = sanitize_len_grid(len_grid, block, R)
    rc = _aligned(len_grid, block).sum(dim=1).to(torch.int32)
    force_echo = fp is not None and fp.wants_echo
    factor = spec.recv_bound_factor
    clamped = (factor is not None and P > 1
               and recv_bound_rows(factor, R, P, nl, block) < P * R)
    B = recv_bound_rows(factor, R, P, nl, block) if clamped else P * R
    if spec.wire_integrity == "off" or P == 1:
        recv, _ = comm.ragged_all_to_all(rows, send_counts, spec.axes,
                                         recv_rows=B, recv_counts=rc,
                                         allow_truncate=clamped,
                                         arrive_counts=arrived)
        gid, valid = D.ragged_recv_layout(len_grid, block, B)
        if inject and fp.kind == "nanrows":
            recv = FI.nan_rows(fp, level, recv, valid)
        if clamped:
            kept = torch.minimum((B - comm.excl_cumsum(rc)).clamp(min=0), rc)
        else:
            kept = rc if force_echo else None
        return _RaggedHopState(recv, gid, valid, rc, send_counts, kept,
                               R), events, None

    # ---- checksummed wire: parity rows ride the slab ------------------------
    me = comm.axis_index(spec.axes)
    words = comm.segment_parity_words(rows, group_starts, seg_lens,
                                      _wire_tags(me, P, nl, False, dev))
    rcw = rc + nl
    slab, _ = comm.checksummed_ragged_all_to_all(
        rows, comm.words_to_rows(words, rows.dtype), send_counts, spec.axes,
        recv_rows=B + P * nl, recv_counts=rc, nl=nl, allow_truncate=clamped,
        arrive_counts=arrived)
    woff = comm.excl_cumsum(rcw)
    if inject and fp.kind == "bitflip":
        slab = FI.flip_wire(fp, level, slab, woff, rc, nl)
    if inject and fp.kind == "nanrows":
        slab = FI.nan_wire(fp, level, slab, woff, rcw)
    if inject and fp.kind == "dupseg":
        slab = FI.copy_wire_region(fp, level, slab, woff, rcw)
    recv, par = comm.split_checksummed_recv(slab, rc, nl, B)
    gid, valid = D.ragged_recv_layout(len_grid, block, B)
    sseg, swithin, sval = D.ragged_row_membership(
        comm.segment_bounds(comm.excl_cumsum(rc), rc), rc, B)
    sseg = sseg.long()
    if clamped:
        kept_wire = torch.minimum(((B + P * nl) - woff).clamp(min=0), rcw)
        full = kept_wire == rcw          # the region arrived whole
        data_kept = torch.minimum(kept_wire, rc)
        # a cut source's missing rows read clamped rows off the slab's
        # edge: zero them and drop their validity
        alive = sval & (swithin < data_kept[sseg])
        recv = torch.where(alive[:, None], recv, 0)
        valid = valid & alive
    else:
        full = torch.ones((P,), dtype=torch.bool, device=dev)
        data_kept = rc
    aligned = _aligned(len_grid, block).reshape(-1)
    expect = comm.segment_parity_words(
        recv, comm.segment_bounds(comm.excl_cumsum(aligned),
                                  aligned).to(torch.int32),
        len_grid.reshape(-1), _wire_tags(me, P, nl, True, dev))
    bad_cell = (comm.int_lane_view(par.reshape(P * nl, -1))
                != comm.stored_words(expect, recv.dtype)).any(dim=-1)
    # one corrupt (src, group) cell condemns its whole source segment; a
    # source the sanitizer quarantined is not flagged again (its zeroed
    # counts cannot match the words it sent)
    src_bad = bad_cell.reshape(P, nl).any(dim=1) & full & ~san_bad
    if spec.wire_integrity == "quarantine":
        rowbad = src_bad[sseg] & sval
        recv = torch.where(rowbad[:, None], 0, recv)
        valid = valid & ~rowbad
        kept = torch.where(src_bad, 0, data_kept)
    else:
        kept = data_kept if (clamped or force_echo) else None
    return (_RaggedHopState(recv, gid, valid, rc, send_counts, kept, R),
            events, src_bad.float())


def _ragged_reverse(y_slab: torch.Tensor, hs: _RaggedHopState,
                    spec: HopSpec
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                               Optional[torch.Tensor]]:
    """Reverse ragged All2All: each source's slab segment back to its
    origin rank at the origin offsets, (R, d) aligned with the sender's
    layout.  Returns ``(back, survived, wire verdicts or None)``.
    Without ``kept`` everything returns and no count exchange runs
    (``survived`` None).  With it (a clamp, or a plan that rewrote the
    grid), each source sends back the ``kept`` prefix of its segment; the
    exchange's own count exchange tells every sender how many of its rows
    each receiver kept (the echo), and ``survived`` (R,) marks the rows
    that returned (the others are zeros).

    With the wire armed the returning slab is checksummed too (one parity
    row a peer): the origin verifies each returning segment and, under
    ``"quarantine"``, zero-fills and un-survives the rows of flagged
    peers.  A quarantine can zero ``kept`` mid-slab, so the surviving
    segments are first compacted to the echoed offsets."""
    R = hs.rows_out
    P = spec.n_ranks
    if spec.wire_integrity == "off" or P == 1:
        if hs.kept is None:
            back, _ = comm.ragged_all_to_all(y_slab, hs.recv_counts,
                                             spec.axes, recv_rows=R,
                                             seg_rows=R,
                                             recv_counts=hs.send_counts)
            return back, None, None
        back_c, rb = comm.ragged_all_to_all(y_slab, hs.kept, spec.axes,
                                            recv_rows=R, seg_rows=R)
        # rb[p]: rows peer p kept of my segment; they arrive compacted at
        # the cumsum of rb and go back to their segment's offset
        send_starts = torch.cat([comm.excl_cumsum(hs.send_counts),
                                 hs.send_counts.sum().reshape(1).to(
                                     torch.int32)])
        seg, within, ok = D.ragged_row_membership(send_starts, rb, R)
        src = torch.where(ok, comm.excl_cumsum(rb)[seg.long()] + within, 0)
        back = torch.where(ok[:, None], back_c[src.long()], 0)
        return back, ok, None

    # ---- checksummed reverse wire -------------------------------------------
    me = comm.axis_index(spec.axes)
    dev = y_slab.device
    if hs.kept is None:
        # mirror counts: the segments already sit at the believed offsets
        sc, y_send, rb = hs.recv_counts, y_slab, hs.send_counts
    else:
        sc = hs.kept
        koff = comm.excl_cumsum(sc)
        seg, within, ok = D.ragged_row_membership(
            comm.segment_bounds(koff, sc), sc, y_slab.shape[0])
        idx = torch.where(ok, comm.excl_cumsum(hs.recv_counts)[seg.long()]
                          + within, 0)
        y_send = torch.where(ok[:, None], y_slab[idx.long()], 0)
        rb = comm.exchange_counts(sc, spec.axes)
    words = comm.segment_parity_words(
        y_send, comm.segment_bounds(comm.excl_cumsum(sc), sc), sc,
        _wire_tags(me, P, 1, False, dev))
    wire_back, _ = comm.checksummed_ragged_all_to_all(
        y_send, comm.words_to_rows(words, y_send.dtype), sc, spec.axes,
        recv_rows=R + P, recv_counts=rb, nl=1)
    back_c, par = comm.split_checksummed_recv(wire_back, rb, 1, R)
    rboff = comm.excl_cumsum(rb)
    expect = comm.segment_parity_words(
        back_c, comm.segment_bounds(rboff, rb), rb,
        _wire_tags(me, P, 1, True, dev))
    bad = (comm.int_lane_view(par.reshape(P, -1))
           != comm.stored_words(expect, back_c.dtype)).any(dim=-1)
    send_starts = torch.cat([comm.excl_cumsum(hs.send_counts),
                             hs.send_counts.sum().reshape(1).to(torch.int32)])
    seg, within, ok = D.ragged_row_membership(send_starts, rb, R)
    seg = seg.long()
    if hs.kept is None:
        back = back_c
    else:
        src = torch.where(ok, rboff[seg] + within, 0)
        back = torch.where(ok[:, None], back_c[src.long()], 0)
    if spec.wire_integrity == "quarantine":
        rowbad = bad[seg] & ok
        back = torch.where(rowbad[:, None], 0, back)
        survived = ok & ~rowbad
    else:
        survived = None if hs.kept is None else ok
    return back, survived, bad.float()


# =============================================================================
# The executor
# =============================================================================

def _occupancy(st: D.CombineState, A: int, device) -> torch.Tensor:
    """Per-slot occupancy flags mirroring the token dispatch."""
    return D.dispatch_flags(torch.ones((A,), dtype=torch.float32,
                                       device=device), st)


def execute_pipeline(x: torch.Tensor, hops: Sequence[ExpertHop],
                     wsel: Dict[str, torch.Tensor], cfg, *, act: str,
                     use_kernel: bool, sync,
                     token_valid: Optional[torch.Tensor] = None,
                     read_stats: frozenset = ALL_STATS
                     ) -> Tuple[torch.Tensor, MoEStats]:
    """Run a routing schedule expressed as a hop pipeline.

    ``x``: (t, d) local tokens; ``hops``: outermost-first; ``wsel``: the
    expert weights, (gpr_innermost, d, f) groups in local order; ``cfg``:
    :class:`repro_torch.common.config.MoEConfig`; ``sync``: mesh axes for
    globally-averaged stats.  ``token_valid`` (t,) bool masks top-level
    tokens (None = all valid).  Returns ``(y (t, d), stats)``.

    ``read_stats`` names the :class:`MoEStats` fields the caller reads:
    only their local sums and psums run, and every other field keeps its
    :func:`zero_stats` value (``y`` is the same bits whatever the set).
    The drop counts and the fault and wire vectors have no backward: a
    remat replay keeps them local (``comm.psum(..., replay=False)``).

    ``cfg.fault_plan`` is parsed once here; ``skew`` rewrites the route
    decision, ``nanrows`` the local and padded dispatch buffers, and
    :func:`_ragged_forward` takes the rest.  Every wire verdict adds to
    ``fault_events[hop]`` and ``wire_faults[hop, src]``; the per-source
    counts take one psum a layer, and only when a wire was armed (the
    choice depends on the config alone, so every rank makes it alike).
    """
    if len(hops) > MAX_HOPS:
        raise ValueError(f"pipeline has {len(hops)} hops; MAX_HOPS is "
                         f"{MAX_HOPS}")
    fp = FI.parse_fault_plan(getattr(cfg, "fault_plan", None))
    want_p = "lb_loss" in read_stats
    want_f = want_p or bool({"hop_max_load", "hop_load_entropy"}
                            & read_stats)
    want_drops = bool({"drop_frac", "hop_drop_frac"} & read_stats)
    dropless = cfg.dispatch_backend == "dropless"
    dev = x.device
    simpl = cfg.sort_impl
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    lb_terms, z_terms = [], []
    hop_drops = [zero] * MAX_HOPS
    hop_faults = [zero] * MAX_HOPS
    hop_maxload = [zero] * MAX_HOPS
    hop_entropy = [torch.ones((), dtype=torch.float32, device=dev)] * MAX_HOPS
    hop_wire = [None] * MAX_HOPS

    def run_hop(level: int, x: torch.Tensor, token_valid: torch.Tensor,
                outer_gid: Optional[torch.Tensor]) -> torch.Tensor:
        hop = hops[level]
        spec = hop.spec
        innermost = level == len(hops) - 1
        dec = hop.route(x, token_valid, outer_gid)
        if fp is not None and fp.kind == "skew" and fp.targets(level):
            dec = FI.apply_skew(fp, level, dec, spec.num_groups,
                                spec.loss_groups)
        A, k = dec.group_ids.shape[0], dec.k
        gid = (dec.group_ids if spec.perm is None
               else spec.perm[dec.group_ids.long()])
        nanrows_here = (fp is not None and fp.kind == "nanrows"
                        and fp.targets(level))

        # ---- losses ---------------------------------------------------------
        if want_f:
            f, p = lb_loss_terms(dec.probs, dec.top1, dec.token_valid,
                                 spec.loss_groups, sync, want_p=want_p)
            if want_p:
                lb_terms.append(scaled_lb_loss(f, p, spec.lb_coef))
            hop_maxload[level] = f.max()
            if spec.loss_groups > 1:
                fr = f / torch.clamp(f.sum(), min=1e-9)
                ent = -torch.sum(fr * torch.log(torch.clamp(fr, min=1e-20)))
                hop_entropy[level] = ent / math.log(spec.loss_groups)
        if "z_loss" in read_stats:
            z_terms.append(z_loss(dec.logits, dec.token_valid,
                                  cfg.router_z_coef, sync))

        # ---- local: the FFN straight over the ragged layout (no drops) -----
        if spec.exchange == "local":
            rows, starts, st = D.dispatch_ragged(
                x, gid, dec.gates, spec.num_groups, k=k, valid=dec.valid,
                use_kernel=use_kernel, sort_impl=simpl)
            if nanrows_here:
                rows = FI.nan_rows(fp, level, rows,
                                   _occupancy(st, A, dev) > 0)
            out = experts_ffn_ragged(wsel, rows, starts, act, block=st.cap,
                                     use_kernel=use_kernel)
            return D.combine(out, st)

        # ---- ragged: exact tile-aligned segments on the wire (no drops) ----
        if spec.exchange == "ragged":
            rows, starts, st = D.dispatch_ragged(
                x, gid, dec.gates, spec.num_groups, k=k, valid=dec.valid,
                use_kernel=use_kernel, sort_impl=simpl)
            seg_lens = D.ragged_seg_lens(gid, st.keep, spec.num_groups)
            hs, ev, wbad = _ragged_forward(rows, starts, seg_lens, spec,
                                           st.cap, fp=fp, level=level)
            if innermost:
                y_slab = experts_ffn_compact_rows(
                    wsel, hs.recv, hs.gid, hs.valid, spec.groups_per_rank,
                    act, use_kernel, sort_impl=simpl)
            else:
                y_slab = run_hop(level + 1, hs.recv, hs.valid, hs.gid)
            back, survived, rbad = _ragged_reverse(y_slab, hs, spec)
            # each flagged source, in either direction, is one fault event
            # and one count at (hop, source rank)
            for verdict in (wbad, rbad):
                if verdict is not None:
                    ev = ev + verdict.sum()
                    if hop_wire[level] is None:
                        hop_wire[level] = torch.zeros(
                            (WIRE_SRC_BINS,), dtype=torch.float32, device=dev)
                    hop_wire[level] = hop_wire[level].index_add(
                        0, torch.arange(spec.n_ranks, device=dev)
                        % WIRE_SRC_BINS, verdict)
            hop_faults[level] = ev
            if survived is None:
                return D.combine(back, st)
            keep = st.keep & survived[st.pos.clamp(min=0).long()]
            if want_drops:
                hop_drops[level] = _drop_frac(st.keep & ~keep, st.keep, sync)
            return D.combine(back, dataclasses.replace(st, keep=keep))

        # ---- padded: fixed-shape capacity buffer ----------------------------
        hop_backend = "sort" if dropless else cfg.dispatch_backend
        buf, st = D.dispatch(x, gid, dec.gates, spec.num_groups,
                             spec.capacity, k=k, valid=dec.valid,
                             backend=hop_backend, use_kernel=use_kernel,
                             sort_impl=simpl)
        recv = _fold(buf, spec)                     # (gpr, P*cap, d)
        if nanrows_here:
            occ = _fold(_occupancy(st, A, dev), spec) > 0
            recv = FI.nan_rows(fp, level, recv.reshape(-1, recv.shape[-1]),
                               occ.reshape(-1)).reshape(recv.shape)
        if innermost:
            if dropless:
                # the capacity buffer stays on the wire; the FFN sees only
                # the occupied slots
                rvalid = _fold(_occupancy(st, A, dev), spec) > 0
                out = experts_ffn_compact(wsel, recv, rvalid, act,
                                          use_kernel, sort_impl=simpl)
            else:
                out = experts_ffn(wsel, recv, act, use_kernel)
        else:
            gpr, S, d = recv.shape
            x1 = recv.reshape(gpr * S, d)
            valid1 = _fold(_occupancy(st, A, dev), spec).reshape(gpr * S) > 0
            gid1 = torch.arange(gpr, dtype=torch.int32,
                                device=dev).repeat_interleave(S)
            out = run_hop(level + 1, x1, valid1, gid1).reshape(gpr, S, d)
        back = _unfold(out, spec, spec.capacity)
        if want_drops:
            hop_drops[level] = _drop_frac(dec.valid & ~st.keep, dec.valid,
                                          sync)
        return D.combine(back, st)

    t = x.shape[0]
    if token_valid is None:
        token_valid = torch.ones((t,), dtype=torch.bool, device=dev)
    y = run_hop(0, x, token_valid, None)
    # run_hop calls itself through its closure cell: a reference cycle
    # that would hold every tensor it captured (the hop statistics, and
    # through their autograd graph its saved activations) until the
    # cyclic garbage collector ran; emptying the cell breaks it
    run_hop = None
    stats = zero_stats(dev)
    if lb_terms:
        stats.lb_loss = sum(lb_terms[1:], lb_terms[0])
    if z_terms:
        stats.z_loss = sum(z_terms[1:], z_terms[0])
    if want_drops:
        stats.hop_drop_frac = torch.stack(hop_drops)
        stats.drop_frac = stats.hop_drop_frac.sum()
    if "fault_events" in read_stats:
        stats.fault_events = comm.psum(torch.stack(hop_faults), sync,
                                       replay=False)
    if want_f:
        stats.hop_max_load = torch.stack(hop_maxload)
        stats.hop_load_entropy = torch.stack(hop_entropy)
    if "wire_faults" in read_stats and any(w is not None for w in hop_wire):
        zw = torch.zeros((WIRE_SRC_BINS,), dtype=torch.float32, device=dev)
        stats.wire_faults = comm.psum(torch.stack(
            [zw if w is None else w for w in hop_wire]), sync, replay=False)
    return y, stats


def _drop_frac(dropped: torch.Tensor, offered: torch.Tensor,
               sync) -> torch.Tensor:
    """The global fraction of a hop's offered assignments that dropped
    (two psums, no backward: a remat replay keeps them local)."""
    n = comm.psum(dropped.sum().float(), sync, replay=False)
    total = comm.psum(offered.sum().float(), sync, replay=False)
    return n / torch.clamp(total, min=1.0)
