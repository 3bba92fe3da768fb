"""Token dispatch/combine for MoE capacity buffers: the sort backend.

The port of ``repro.core.dispatch`` for ``MoEConfig.dispatch_backend =
"sort"``, the default and the serving path.  Every routing hop places
``A = t*k`` routing assignments into a per-group capacity buffer
``(num_groups, cap, d)`` (dispatch), runs expert compute, and reads the
buffer back to token order with gate weighting (combine)::

    buf, state = dispatch(x, group_ids, gates, num_groups, cap, k=k, ...)
    ...                                # expert FFN on buf
    y = combine(buf_back, state)       # (t, d), gate-weighted

Assignments are stable-sorted by destination group, so within a group they
keep arrival order and the paper's overflow-drop semantics hold: the first
``cap`` valid assignments of a group survive.  The buffer is built by
*gathering* source rows (``slot_assign``), and combine is the mirrored
gather-reduce; with ``use_kernel=True`` both gathers run through the CUDA
kernels in :mod:`repro_torch.kernels.ops`.

JAX silently drops out-of-range scatter indices (``mode="drop"``); torch
raises on them, so the scatter here writes dropped assignments into one
extra sentinel slot that is cut off afterwards.

The ``dense`` oracle backend and the ``dropless`` ragged layout are not
ported yet (the dropless slice).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref


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


@dataclasses.dataclass
class CombineState:
    """Everything combine/flags need to invert a dispatch.

    Array fields are flat per-assignment (A = out_tokens * k,) except
    ``slot_assign``: (num_groups * cap,) assignment index per buffer slot,
    -1 = empty.
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
    assignments never consume capacity.
    """
    if num_groups < 1:
        raise ValueError(f"num_groups must be >= 1, got {num_groups}")
    if backend != "sort":
        raise NotImplementedError(
            f"dispatch backend {backend!r} is not ported yet; the port has "
            f"the \"sort\" capacity backend")
    t, d = x.shape
    A = group_ids.shape[0]
    if A != t * k:
        raise ValueError(f"group_ids {A} != tokens {t} * k {k}")
    if valid is None:
        valid = torch.ones((A,), dtype=torch.bool, device=x.device)
    pos, keep, slot_assign = sort_positions(group_ids, valid, num_groups, cap,
                                            sort_impl=sort_impl)
    state = CombineState(group_ids, pos, keep, gates, slot_assign,
                         num_groups, cap, k, t, backend, use_kernel)
    if t == 0:
        # empty local batch (serving): nothing to gather from
        return x.new_zeros((num_groups, cap, d)), state
    token_src = torch.where(slot_assign >= 0, slot_assign // k,
                            torch.full_like(slot_assign, -1))
    if use_kernel:
        rows = kops.dispatch_gather(x.contiguous(), token_src)
    else:
        rows = ref.dispatch_gather_ref(x, token_src)
    return rows.reshape(num_groups, cap, d), state


def combine(buf: torch.Tensor, state: CombineState) -> torch.Tensor:
    """Read expert outputs back to (t, d) token order, weighting each
    surviving assignment by its gate.  ``buf``: (num_groups, cap, d)."""
    d = buf.shape[-1]
    if state.backend != "sort":
        raise NotImplementedError(
            f"combine for backend {state.backend!r} is not ported yet")
    if state.out_tokens == 0:
        return buf.new_zeros((0, d))
    rows = buf.reshape(state.num_groups * state.cap, d)
    src = torch.where(
        state.keep, state.group_ids.to(torch.int32) * state.cap + state.pos,
        torch.full_like(state.pos, -1)).reshape(state.out_tokens, state.k)
    scale = (state.gates * state.keep.to(state.gates.dtype)
             ).reshape(state.out_tokens, state.k)
    if state.use_kernel:
        return kops.combine_gather(rows.contiguous(), src.contiguous(),
                                   scale.float().contiguous())
    return ref.combine_gather_ref(rows, src, scale)


def dispatch_flags(vals: torch.Tensor, state: CombineState) -> torch.Tensor:
    """Place per-assignment scalars (A,) into a (num_groups, cap) buffer
    mirroring the token dispatch (zeros in empty slots)."""
    sa = state.slot_assign
    if vals.shape[0] == 0:                       # empty local batch
        got = torch.zeros(sa.shape, dtype=vals.dtype, device=sa.device)
    else:
        got = vals[sa.clamp(min=0).long()] * (sa >= 0).to(vals.dtype)
    return got.reshape(state.num_groups, state.cap)
