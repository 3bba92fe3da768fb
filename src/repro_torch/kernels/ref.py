"""Plain PyTorch versions of the kernels (the port of ``repro.kernels.ref``).

Each function computes what its kernel computes, in plain tensor code.  The
wrappers in :mod:`repro_torch.kernels.ops` run them for tensors on the CPU,
the tests hold them against the JAX oracles, and ``chip_smoke.py`` holds
each CUDA kernel against them on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def activation(h: torch.Tensor, act: str) -> torch.Tensor:
    """The expert activation: ``silu``, or ``gelu`` in its tanh form (the
    default of ``jax.nn.gelu``)."""
    if act == "silu":
        return F.silu(h)
    if act == "gelu":
        return F.gelu(h, approximate="tanh")
    raise ValueError(f"unknown activation {act!r}; expected 'silu' or 'gelu'")


def grouped_ffn_ref(x, w1, w3, w2, *, act: str = "gelu"):
    """x: (G, T, d); w1/w3: (G, d, f); w2: (G, f, d) -> (G, T, d).

    fp32 products; ``h`` is rounded to ``x.dtype`` once before ``w2``, and
    the output once at the end.  ``w3=None`` is the plain (non-GLU) MLP.
    """
    xf = x.float()
    h = activation(torch.bmm(xf, w1.float()), act)
    if w3 is not None:
        h = h * torch.bmm(xf, w3.float())
    y = torch.bmm(h.to(x.dtype).float(), w2.float())
    return y.to(x.dtype)


def group_sort_ref(keys: torch.Tensor, num_keys: int):
    """Stable small-domain key sort.

    ``keys``: (A,) int in ``[0, num_keys)``.  Returns ``(ranks, starts)``,
    both int32: each element's stable sorted position and the
    (num_keys + 1,) exclusive prefix counts (``starts[d]`` = #keys < d).
    A stable sort of integers is unique, so these are bit-identical to the
    JAX oracle.
    """
    if num_keys < 1:
        raise ValueError(f"num_keys must be >= 1, got {num_keys}")
    A = keys.shape[0]
    dev = keys.device
    if A == 0:
        return (torch.zeros((0,), dtype=torch.int32, device=dev),
                torch.zeros((num_keys + 1,), dtype=torch.int32, device=dev))
    skeys, order = torch.sort(keys.to(torch.int32), stable=True)
    ranks = torch.empty((A,), dtype=torch.int32, device=dev)
    ranks[order] = torch.arange(A, dtype=torch.int32, device=dev)
    bounds = torch.arange(num_keys + 1, dtype=torch.int32, device=dev)
    starts = torch.searchsorted(skeys, bounds, out_int32=True)
    return ranks, starts


def dispatch_gather_ref(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """MoE dispatch gather.  x: (T, d); src: (R,) source row per buffer
    slot, -1 = empty slot -> zeros.  Returns (R, d)."""
    R, d = src.shape[0], x.shape[1]
    if x.shape[0] == 0:
        return x.new_zeros((R, d))
    rows = x[src.clamp(min=0).long()]
    return torch.where((src >= 0)[:, None], rows, torch.zeros_like(rows))


def combine_gather_ref(rows: torch.Tensor, src: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """MoE combine gather-reduce.  rows: (R, d) flat buffer; src/scale:
    (t, k) buffer row per assignment (-1 = dropped) and gate weight.
    Returns (t, d) = sum_j scale[:, j] * rows[src[:, j]].

    Accumulates in fp32 in the order j = 0..k-1, one rounded multiply and
    one rounded add per term, and rounds to ``rows.dtype`` once: the
    arithmetic of the CUDA kernel, term for term.
    """
    t, k = src.shape
    acc = torch.zeros((t, rows.shape[1]), dtype=torch.float32,
                      device=rows.device)
    if rows.shape[0] == 0:
        return acc.to(rows.dtype)
    for j in range(k):
        s = src[:, j]
        w = torch.where(s >= 0, scale[:, j].float(),
                        torch.zeros((), device=rows.device))
        acc = acc + w[:, None] * rows[s.clamp(min=0).long()].float()
    return acc.to(rows.dtype)
