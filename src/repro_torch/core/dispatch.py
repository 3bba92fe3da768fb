"""Token dispatch/combine for MoE hops: the sort, dense and dropless backends.

The port of ``repro.core.dispatch``.  Every routing hop places ``A = t*k``
routing assignments somewhere the expert FFN can run over them (dispatch),
runs expert compute, and reads the results back to token order with gate
weighting (combine)::

    buf, state = dispatch(x, group_ids, gates, num_groups, cap, k=k, ...)
    ...                                # expert FFN on buf
    y = combine(buf_back, state)       # (t, d), gate-weighted

Three backends, as in the JAX package (``MoEConfig.dispatch_backend``):

* ``"sort"`` (the default) stable-sorts assignments by destination group
  into a per-group capacity buffer ``(num_groups, cap, d)``: within a group
  they keep arrival order, so the paper's overflow-drop semantics hold (the
  first ``cap`` valid assignments of a group survive).  The buffer is built
  by *gathering* source rows (``slot_assign``), and combine is the mirrored
  gather-reduce.
* ``"dense"`` is the oracle: a one-hot cumsum for positions and a scatter
  into the same capacity buffer.  Buffers and keep masks are bit-identical
  to ``"sort"``.
* ``"dropless"`` (:func:`dispatch_ragged`) has no capacity: assignments go
  into a flat *tile-aligned ragged* layout, each group's segment starting
  at a multiple of the row tile ``block`` and holding exactly its own
  assignments, so nothing is dropped and the expert FFN runs over true
  segment lengths (``repro_torch.kernels.ops.grouped_ffn_ragged``).  The
  ``ragged_*`` helpers below build and read that layout; their integer
  outputs match the JAX package bit for bit.

With ``use_kernel=True`` the gathers of the sort and dropless backends run
through the CUDA kernels in :mod:`repro_torch.kernels.ops`.

JAX silently drops out-of-range scatter indices (``mode="drop"``) and fills
out-of-range gathers (``mode="fill"``); torch raises on them, so the
scatters here write dropped entries into one extra sentinel row that is cut
off afterwards, and the gathers mask what JAX would fill.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref

# row-tile bounds of the tile-aligned ragged layout, the JAX package's (the
# layout must match it bit for bit); see _ragged_block()
RAGGED_BLOCK_MIN = 8
RAGGED_BLOCK_MAX_KERNEL = 128
RAGGED_BLOCK_MAX_JNP = 4096


def _i32(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


# =============================================================================
# Dense backend primitives (the oracle)
# =============================================================================

def positions_in_group(group_ids: torch.Tensor, keep_in: torch.Tensor,
                       num_groups: int, cap: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each (flat) routing decision's slot within its group, by a one-hot
    cumsum.  Returns ``pos`` (A,) int32 and ``keep`` (A,) bool (valid and
    under capacity); overflow drops in arrival order."""
    gi = group_ids.to(torch.int32)
    # a comparison, not F.one_hot: an id outside [0, num_groups) gives a zero
    # row, as jax.nn.one_hot
    onehot = ((gi[:, None] == _i32(num_groups, gi.device)).to(torch.int32)
              * keep_in[:, None].to(torch.int32))
    pos = (torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot)
    pos = pos.gather(1, gi.clamp(0, num_groups - 1).long()[:, None])[:, 0]
    return pos, keep_in & (pos < cap)


def _slot_index(group_ids: torch.Tensor, pos: torch.Tensor,
                keep: torch.Tensor, num_groups: int, cap: int) -> torch.Tensor:
    """Flat slot ``group * cap + pos`` of each kept assignment; every other
    one goes to the sentinel slot ``num_groups * cap``."""
    flat = group_ids.long() * cap + pos.long()
    return torch.where(keep, flat, torch.full_like(flat, num_groups * cap))


def dispatch_scatter(x: torch.Tensor, group_ids: torch.Tensor,
                     pos: torch.Tensor, keep: torch.Tensor, num_groups: int,
                     cap: int) -> torch.Tensor:
    """Scatter tokens (A, d) into a capacity buffer (num_groups, cap, d)."""
    d = x.shape[-1]
    buf = x.new_zeros((num_groups * cap + 1, d))
    buf.index_add_(0, _slot_index(group_ids, pos, keep, num_groups, cap),
                   x * keep[:, None].to(x.dtype))
    return buf[:-1].reshape(num_groups, cap, d)


def scatter_flags(vals: torch.Tensor, group_ids: torch.Tensor,
                  pos: torch.Tensor, keep: torch.Tensor, num_groups: int,
                  cap: int) -> torch.Tensor:
    """Scatter per-assignment scalars into (num_groups, cap)."""
    buf = vals.new_zeros((num_groups * cap + 1,))
    buf.index_add_(0, _slot_index(group_ids, pos, keep, num_groups, cap),
                   vals * keep.to(vals.dtype))
    return buf[:-1].reshape(num_groups, cap)


def combine_gather(buf: torch.Tensor, group_ids: torch.Tensor,
                   pos: torch.Tensor, keep: torch.Tensor, gates: torch.Tensor,
                   out_tokens: int, k: int) -> torch.Tensor:
    """Gather expert outputs back to token order and apply gates.
    ``buf``: (groups, cap, d); ids/pos/keep/gates flat (t*k,).  Returns
    (t, d).  A slot outside the buffer reads zeros (JAX's fill mode)."""
    G, cap, d = buf.shape
    inside = ((group_ids >= 0) & (group_ids < G) & (pos >= 0) & (pos < cap))
    flat = torch.where(inside, group_ids.long() * cap + pos.long(),
                       torch.zeros_like(pos, dtype=torch.long))
    got = buf.reshape(G * cap, d)[flat] * inside[:, None].to(buf.dtype)
    got = got * (gates * keep.to(gates.dtype))[:, None].to(buf.dtype)
    return got.reshape(out_tokens, k, d).sum(dim=1)


# =============================================================================
# Sort backend primitives
# =============================================================================

def sort_positions(group_ids: torch.Tensor, valid: torch.Tensor,
                   num_groups: int, cap: int, *, sort_impl: str = "argsort"
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Within-group positions via a stable sort.

    Returns ``(pos, keep, slot_assign)``: ``pos`` (A,) int32 position within
    the group (unspecified for invalid assignments), ``keep`` (A,) bool
    (valid and under capacity), and ``slot_assign`` (num_groups*cap,) int32,
    the flat assignment index occupying each buffer slot, ``-1`` for empty
    slots.
    """
    if num_groups < 1:
        raise ValueError(f"num_groups must be >= 1, got {num_groups}")
    A = group_ids.shape[0]
    dev = group_ids.device
    if A == 0:
        return (torch.zeros((0,), dtype=torch.int32, device=dev),
                torch.zeros((0,), dtype=torch.bool, device=dev),
                torch.full((num_groups * cap,), -1, dtype=torch.int32,
                           device=dev))
    gi = group_ids.to(torch.int32)
    # invalid assignments sort after every real group -> never take a slot
    keys = torch.where(valid, gi, torch.full_like(gi, num_groups))
    ranks, starts = kops.group_sort(keys, num_groups + 1, impl=sort_impl)
    idx = torch.arange(A, dtype=torch.int32, device=dev)
    pos = ranks - starts[keys.long()]
    keep = valid & (pos < cap)
    # dropped assignments land in the sentinel slot num_groups*cap
    dst = torch.where(keep, keys * cap + pos,
                      torch.full_like(keys, num_groups * cap))
    slot_assign = torch.full((num_groups * cap + 1,), -1, dtype=torch.int32,
                             device=dev)
    slot_assign[dst.long()] = idx
    return pos, keep, slot_assign[:-1]


# =============================================================================
# Dropless (tile-aligned ragged) backend primitives
# =============================================================================

def _ragged_block(A: int, num_groups: int, block: Optional[int],
                  use_kernel: bool = False) -> int:
    """The row tile of the ragged layout, as the JAX package picks it: a
    power of two near an eighth of the mean segment (at least 8), capped at
    128 on the kernel path and 4096 on the plain one.  Static in
    ``A``/``num_groups``."""
    if block is not None:
        return block
    cap = RAGGED_BLOCK_MAX_KERNEL if use_kernel else RAGGED_BLOCK_MAX_JNP
    mean = max(A // max(num_groups, 1), 1)
    target = mean if mean < 64 else max(mean // 8, 64)
    b = RAGGED_BLOCK_MIN
    while b * 2 <= min(target, cap):
        b *= 2
    return b


def ragged_rows(A: int, num_groups: int, block: int) -> int:
    """Static row count of the ragged layout: each group wastes at most one
    partial tile, so ``ceil(A/block) + num_groups`` tiles always suffice."""
    return ((A + block - 1) // block + num_groups) * block


def ragged_positions(group_ids: torch.Tensor, valid: torch.Tensor,
                     num_groups: int, block: int, *,
                     sort_impl: str = "argsort"
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Tile-aligned ragged layout: the capacity-free sibling of
    :func:`sort_positions`.

    Group ``g``'s segment starts at ``group_starts[g]`` (a multiple of
    ``block``) and holds its valid assignments in arrival order.  Returns
    ``(rank, group_starts, row_src)``, all int32: ``rank`` (A,) the row of
    each assignment (-1 if invalid); ``group_starts`` (num_groups+1,) the
    aligned segment starts; ``row_src`` (R,) the assignment in each row, -1
    for alignment padding and the unused tail (R = :func:`ragged_rows`).
    """
    if num_groups < 1:
        raise ValueError(f"num_groups must be >= 1, got {num_groups}")
    A = group_ids.shape[0]
    G = num_groups
    R = ragged_rows(A, G, block)
    dev = group_ids.device
    if A == 0:
        return (torch.zeros((0,), dtype=torch.int32, device=dev),
                torch.zeros((G + 1,), dtype=torch.int32, device=dev),
                torch.full((R,), -1, dtype=torch.int32, device=dev))
    gi = group_ids.to(torch.int32)
    keys = torch.where(valid, gi, torch.full_like(gi, G))
    ranks, starts = kops.group_sort(keys, G + 1, impl=sort_impl)
    # raw segment bounds: bounds[g] = #keys < g, bounds[G] = valid rows
    bounds = starts[:G + 1]
    lens = bounds[1:] - bounds[:-1]
    aligned = ((lens + block - 1) // block) * block
    group_starts = torch.cat([torch.zeros((1,), dtype=torch.int32,
                                          device=dev),
                              torch.cumsum(aligned, 0).to(torch.int32)])
    kl = keys.long()
    arow = group_starts[kl] + (ranks - bounds[kl])
    arow = torch.where(valid, arow, torch.full_like(arow, R))
    rank = torch.where(valid, arow, torch.full_like(arow, -1))
    # invalid assignments land in the sentinel row R, cut off below
    row_src = torch.full((R + 1,), -1, dtype=torch.int32, device=dev)
    row_src[arow.long()] = _i32(A, dev)
    return rank, group_starts, row_src[:R]


def ragged_seg_lens(group_ids: torch.Tensor, valid: torch.Tensor,
                    num_groups: int) -> torch.Tensor:
    """Exact per-group valid-assignment counts, (num_groups,) int32: the
    raw segment lengths a ragged hop exchanges.  Ids outside
    ``[0, num_groups)`` count nowhere (JAX's drop mode)."""
    out = torch.zeros((num_groups + 1,), dtype=torch.int32,
                      device=group_ids.device)
    if group_ids.shape[0] == 0:
        return out[:num_groups]
    gi = group_ids.long()
    inside = (gi >= 0) & (gi < num_groups)
    out.index_add_(0, torch.where(inside, gi, torch.full_like(gi, num_groups)),
                   (valid & inside).to(torch.int32))
    return out[:num_groups]


def ragged_send_counts(group_starts: torch.Tensor,
                       groups_per_rank: int) -> torch.Tensor:
    """Per-destination-rank aligned row counts of a rank-major ragged
    layout: (P,) int32 straight off the (P*gpr + 1,) offsets."""
    b = group_starts[::groups_per_rank]
    return (b[1:] - b[:-1]).to(torch.int32)


def ragged_row_membership(starts: torch.Tensor, counts: torch.Tensor,
                          n_rows: int
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Map each row of a concatenated-segments layout to its segment.

    ``starts`` (S+1,) ascending segment offsets; the first ``counts[s]``
    rows of segment ``s`` are occupied.  Returns ``(seg, within, valid)``
    over ``(n_rows,)``: the owning segment (clamped on the tail), the offset
    within it, and whether the row is occupied.
    """
    S = counts.shape[0]
    ar = _i32(n_rows, starts.device)
    seg = (torch.searchsorted(starts.to(torch.int32), ar, right=True,
                              out_int32=True) - 1).clamp(0, S - 1)
    within = ar - starts[seg.long()]
    return seg, within, within < counts[seg.long()]


def ragged_recv_layout(len_grid: torch.Tensor, block: int, recv_rows: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The structure of a received ragged slab from the exchanged counts.

    ``len_grid`` (P, n_local) int32: the raw segment length per (source
    rank, local group); the slab concatenates, source-major, each source's
    tile-aligned segments.  Returns ``(gid, valid)`` over ``(recv_rows,)``:
    the local group of each row (clamped on the tail) and whether it is a
    real assignment.
    """
    P, nl = len_grid.shape
    aligned = ((len_grid + block - 1) // block) * block
    starts = torch.cat([
        torch.zeros((1,), dtype=torch.int32, device=len_grid.device),
        torch.cumsum(aligned.reshape(-1), 0).to(torch.int32)])
    seg, _, valid = ragged_row_membership(starts, len_grid.reshape(-1),
                                          recv_rows)
    return seg % nl, valid


def ragged_tile_gids(group_starts: torch.Tensor, n_tiles: int,
                     block: int) -> torch.Tensor:
    """Group owning each row tile of the ragged layout (int32); tiles past
    the last segment clamp to the final group (their rows are zeros)."""
    t0 = _i32(n_tiles, group_starts.device) * block
    gid = torch.searchsorted(group_starts.to(torch.int32), t0, right=True,
                             out_int32=True) - 1
    return gid.clamp(0, group_starts.shape[0] - 2)


# =============================================================================
# The interface
# =============================================================================

@dataclasses.dataclass
class CombineState:
    """Everything combine/flags need to invert a dispatch.

    Array fields are flat per-assignment (A = out_tokens * k,) except
    ``slot_assign`` (sort backend): (num_groups * cap,) assignment index
    per buffer slot, -1 = empty; None for the dense backend.

    The ``"dropless"`` backend reuses the fields for its flat ragged
    layout: ``pos`` holds each assignment's row in the (R,) layout (-1
    invalid), ``slot_assign`` the (R,) row -> assignment map (-1 padding),
    and ``cap`` the row tile ``block`` (there is no capacity).
    """
    group_ids: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    gates: torch.Tensor
    slot_assign: Optional[torch.Tensor]
    num_groups: int
    cap: int
    k: int
    out_tokens: int
    backend: str
    use_kernel: bool


def dispatch(x: torch.Tensor, group_ids: torch.Tensor, gates: torch.Tensor,
             num_groups: int, cap: int, *, k: int = 1,
             valid: Optional[torch.Tensor] = None, backend: str = "sort",
             use_kernel: bool = False, sort_impl: str = "argsort"
             ) -> Tuple[torch.Tensor, CombineState]:
    """Place tokens into a (num_groups, cap, d) capacity buffer.

    ``x``: (t, d) local tokens; ``group_ids``/``gates``: flat (t*k,)
    per-assignment destination group and combine weight (assignment ``a``
    belongs to token ``a // k``); ``valid``: optional (t*k,) bool — invalid
    assignments never consume capacity.  ``backend`` is ``"sort"`` or
    ``"dense"`` (``"dropless"`` has its own :func:`dispatch_ragged`).
    """
    if num_groups < 1:
        raise ValueError(f"num_groups must be >= 1, got {num_groups}")
    t, d = x.shape
    A = group_ids.shape[0]
    if A != t * k:
        raise ValueError(f"group_ids {A} != tokens {t} * k {k}")
    if valid is None:
        valid = torch.ones((A,), dtype=torch.bool, device=x.device)

    if backend == "dense":
        pos, keep = positions_in_group(group_ids, valid, num_groups, cap)
        xr = x.repeat_interleave(k, dim=0) if k > 1 else x
        buf = dispatch_scatter(xr, group_ids, pos, keep, num_groups, cap)
        return buf, CombineState(group_ids, pos, keep, gates, None,
                                 num_groups, cap, k, t, backend, use_kernel)

    if backend != "sort":
        raise ValueError(f"unknown dispatch backend {backend!r}; expected "
                         f"\"dense\" or \"sort\" (capacity-buffer backends; "
                         f"for \"dropless\" use dispatch_ragged)")
    pos, keep, slot_assign = sort_positions(group_ids, valid, num_groups, cap,
                                            sort_impl=sort_impl)
    state = CombineState(group_ids, pos, keep, gates, slot_assign,
                         num_groups, cap, k, t, backend, use_kernel)
    if t == 0:
        # empty local batch (serving): nothing to gather from
        return x.new_zeros((num_groups, cap, d)), state
    return (_gather_rows(x, slot_assign, k, use_kernel)
            .reshape(num_groups, cap, d), state)


def _gather_rows(x: torch.Tensor, slot_src: torch.Tensor, k: int,
                 use_kernel: bool) -> torch.Tensor:
    """Row ``i`` of the result is token ``slot_src[i] // k`` of ``x``, or
    zeros where ``slot_src[i] < 0``."""
    token_src = torch.where(slot_src >= 0, slot_src // k,
                            torch.full_like(slot_src, -1))
    if use_kernel:
        return kops.dispatch_gather(x.contiguous(), token_src)
    return ref.dispatch_gather_ref(x, token_src)


def dispatch_ragged(x: torch.Tensor, group_ids: torch.Tensor,
                    gates: torch.Tensor, num_groups: int, *, k: int = 1,
                    valid: Optional[torch.Tensor] = None,
                    block: Optional[int] = None, use_kernel: bool = False,
                    sort_impl: str = "argsort"
                    ) -> Tuple[torch.Tensor, torch.Tensor, CombineState]:
    """Capacity-free dispatch into the tile-aligned ragged layout.

    Same contract as :func:`dispatch` but with no capacity: returns
    ``(rows, group_starts, state)``, ``rows`` the flat (R, d) gathered
    array (R static, :func:`ragged_rows`), ``group_starts`` the
    (num_groups+1,) aligned segment offsets the ragged grouped FFN reads,
    and ``state`` for :func:`combine` / :func:`dispatch_flags`.  Nothing is
    dropped (``state.keep == valid``).
    """
    t, d = x.shape
    A = group_ids.shape[0]
    if A != t * k:
        raise ValueError(f"group_ids {A} != tokens {t} * k {k}")
    if valid is None:
        valid = torch.ones((A,), dtype=torch.bool, device=x.device)
    blk = _ragged_block(A, num_groups, block, use_kernel)
    rank, group_starts, row_src = ragged_positions(group_ids, valid,
                                                   num_groups, blk,
                                                   sort_impl=sort_impl)
    state = CombineState(group_ids, rank, valid, gates, row_src,
                         num_groups, blk, k, t, "dropless", use_kernel)
    if t == 0:
        return x.new_zeros((row_src.shape[0], d)), group_starts, state
    return _gather_rows(x, row_src, k, use_kernel), group_starts, state


def combine(buf: torch.Tensor, state: CombineState) -> torch.Tensor:
    """Read expert outputs back to (t, d) token order, weighting each
    surviving assignment by its gate.  ``buf`` is the (num_groups, cap, d)
    capacity buffer of the dense/sort backends, or the flat (R, d) ragged
    row array of the dropless backend."""
    d = buf.shape[-1]
    if state.backend == "dense":
        return combine_gather(buf, state.group_ids, state.pos, state.keep,
                              state.gates, state.out_tokens, state.k)
    if state.out_tokens == 0:
        return buf.new_zeros((0, d))
    if state.backend == "dropless":
        rows = buf                                   # already flat (R, d)
        src = torch.where(state.keep, state.pos, torch.full_like(state.pos, -1))
    else:
        rows = buf.reshape(state.num_groups * state.cap, d)
        src = torch.where(
            state.keep, state.group_ids.to(torch.int32) * state.cap + state.pos,
            torch.full_like(state.pos, -1))
    src = src.reshape(state.out_tokens, state.k)
    scale = (state.gates * state.keep.to(state.gates.dtype)
             ).reshape(state.out_tokens, state.k)
    if state.use_kernel:
        return kops.combine_gather(rows.contiguous(), src.contiguous(),
                                   scale.float().contiguous())
    return ref.combine_gather_ref(rows, src, scale)


def dispatch_flags(vals: torch.Tensor, state: CombineState) -> torch.Tensor:
    """Place per-assignment scalars (A,) into a buffer mirroring the token
    dispatch (zeros in empty slots): (num_groups, cap) for the capacity
    backends, flat (R,) for the dropless ragged layout."""
    if state.backend == "dense":
        return scatter_flags(vals, state.group_ids, state.pos, state.keep,
                             state.num_groups, state.cap)
    sa = state.slot_assign
    if vals.shape[0] == 0:                       # empty local batch
        got = torch.zeros(sa.shape, dtype=vals.dtype, device=sa.device)
    else:
        got = vals[sa.clamp(min=0).long()] * (sa >= 0).to(vals.dtype)
    if state.backend == "dropless":
        return got
    return got.reshape(state.num_groups, state.cap)
