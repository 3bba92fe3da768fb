"""Collective-communication helpers, single-device forms.

The port's counterpart of ``repro.sharding.comm``.  Every collective the
model code issues goes through these helpers.  With an empty axis tuple
(``single_device_plan()``) each one is the identity, exactly as in the JAX
package, so the same model code is the single-device path.  A named axis
raises: the ``torch.distributed`` forms come with the expert-parallel
slice.
"""
from __future__ import annotations

from typing import Tuple, Union

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
