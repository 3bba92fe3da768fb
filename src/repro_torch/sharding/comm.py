"""Collective-communication helpers, single-device forms.

The port's counterpart of ``repro.sharding.comm``.  Every collective the
model code issues goes through these helpers.  With an empty axis tuple
(``single_device_plan()``) each one is the identity, exactly as in the JAX
package, so the same model code is the single-device path.  A named axis
raises: the ``torch.distributed`` forms come with the expert-parallel
slice.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

Axes = Union[None, str, Tuple[str, ...]]


def _norm(axes: Axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    if isinstance(axes, str):
        return (axes,)
    return tuple(axes)


def _single_device(axes: Axes, what: str) -> None:
    if _norm(axes):
        raise NotImplementedError(
            f"comm.{what} over mesh axes {_norm(axes)}: collectives over "
            f"named axes come with the expert-parallel slice; this port "
            f"runs on one device (single_device_plan())")


def psum(x, axes: Axes):
    _single_device(axes, "psum")
    return x


def pmax(x, axes: Axes):
    _single_device(axes, "pmax")
    return x


def all_gather(x, axes: Axes, *, axis: int = 0, tiled: bool = True):
    _single_device(axes, "all_gather")
    return x


def all_to_all(x, axes: Axes, *, split_axis: int, concat_axis: int):
    _single_device(axes, "all_to_all")
    return x


def axis_index(axes: Axes) -> int:
    _single_device(axes, "axis_index")
    return 0


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
    0, m[s, d])`` with ``off`` the exclusive cumsum down each column."""
    off = torch.cumsum(m, 0) - m
    return torch.minimum((recv_rows - off).clamp(min=0), m).to(m.dtype)


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
    _single_device(axes, "exchange_counts")
    return send_counts


def ragged_all_to_all(rows: torch.Tensor, send_counts: torch.Tensor,
                      axes: Axes, *, recv_rows: int,
                      seg_rows: Optional[int] = None,
                      recv_counts: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All2All of exact per-peer row segments.

    ``rows`` (R, ...) holds, in rank order, the segment for each peer
    (``send_counts`` rows each); ``recv_rows`` is the static size of the
    received layout, ``seg_rows`` a static bound on one segment, and
    ``recv_counts`` the per-source lengths when the caller knows them.
    Returns ``(recv (recv_rows, ...), recv_counts (P,))``.  On one device
    ``recv`` is ``rows`` zero-padded or cut to ``recv_rows`` (``rows``
    itself when it has ``recv_rows`` rows), with ``recv_counts =
    send_counts``.
    """
    assert_count_i32(send_counts, "ragged_all_to_all(send_counts)")
    if recv_counts is not None:
        assert_count_i32(recv_counts, "ragged_all_to_all(recv_counts)")
    _single_device(axes, "ragged_all_to_all")
    if rows.shape[0] == recv_rows:
        return rows, send_counts
    out = rows.new_zeros((recv_rows,) + tuple(rows.shape[1:]))
    n = min(recv_rows, rows.shape[0])
    out[:n] = rows[:n]
    return out, send_counts


def name_saved(x):
    """Identity: the JAX package tags collective outputs for its remat
    policy here; eager PyTorch has no such policy."""
    return x


def split_tokens(x: torch.Tensor, plan_axes: Axes, size: int):
    """Pad the leading (token) dim of ``x`` to a multiple of ``size``;
    returns ``(local, pad)``.  On one device the local shard is the whole
    (padded) array."""
    _single_device(plan_axes, "split_tokens")
    pad = (-x.shape[0]) % size
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return x, pad


def unsplit_tokens(local: torch.Tensor, plan_axes: Axes, orig_len: int):
    """Inverse of :func:`split_tokens`: drop the padding rows."""
    _single_device(plan_axes, "unsplit_tokens")
    return local[:orig_len]
