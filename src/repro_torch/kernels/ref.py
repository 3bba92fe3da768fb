"""Plain PyTorch versions of the kernels (the port of ``repro.kernels.ref``).

Each function computes what its kernel computes, in plain tensor code.  The
wrappers in :mod:`repro_torch.kernels.ops` run them for tensors on the CPU,
the tests hold them against the JAX oracles, and ``chip_smoke.py`` holds
each CUDA kernel against them on the card.
"""
from __future__ import annotations

import math

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


def _ragged_group_bounds(group_starts: torch.Tensor, R: int):
    """``[(lo, hi), ...]``: the rows of each group under the JAX oracle's
    per-row rule ``clip(searchsorted(group_starts, row, "right") - 1, 0,
    G-1)``, for ascending ``group_starts``: group 0 also takes rows before
    ``group_starts[1]``, group G-1 every row from ``group_starts[G-1]``."""
    gs = [min(max(int(v), 0), R) for v in group_starts.tolist()]
    G = len(gs) - 1
    out = []
    for g in range(G):
        lo = 0 if g == 0 else gs[g]
        hi = R if g == G - 1 else gs[g + 1]
        out.append((lo, max(lo, hi)))
    return out


def grouped_ffn_ragged_ref(rows, group_starts, w1, w3, w2, *,
                           act: str = "gelu"):
    """Ragged grouped FFN over the tile-aligned dropless layout.

    rows: (R, d) sorted by group (alignment padding rows are zero);
    group_starts: (G+1,) aligned segment offsets; w1/w3: (G, d, f); w2:
    (G, f, d).  Each row goes through its own group's expert, the group
    taken row by row as ``repro.kernels.ref.grouped_ffn_ragged_ref`` takes
    it; the rows of a group are contiguous, so each group is one slice.
    fp32 products, ``h`` rounded to ``rows.dtype`` once, an fp32 sum over
    all of f, one rounding at the end.
    """
    R, d = rows.shape
    y = torch.empty_like(rows)
    for g, (lo, hi) in enumerate(_ragged_group_bounds(group_starts, R)):
        if hi == lo:
            continue
        xf = rows[lo:hi].float()
        h = activation(xf @ w1[g].float(), act)
        if w3 is not None:
            h = h * (xf @ w3[g].float())
        y[lo:hi] = (h.to(rows.dtype).float() @ w2[g].float()).to(rows.dtype)
    return y


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


def topk_lowest_index(probs: torch.Tensor, k: int):
    """Top-k of each row by ``k`` max-extraction rounds, the lowest index
    winning ties (the order ``lax.top_k`` guarantees and ``torch.topk``
    does not promise), NaN above every number as in ``lax.top_k`` (a NaN
    row, as a fault plan makes, picks its lanes in order).  Returns
    ``(gates (t, k), idx (t, k) int32)``."""
    E = probs.shape[-1]
    if not 1 <= k <= E:
        raise ValueError(f"top-k {k} must be in [1, {E}]")
    lane = torch.arange(E, device=probs.device)
    work = probs
    gsel, isel = [], []
    for _ in range(k):
        # argmax: the first of the largest, NaN the largest
        sel = work.argmax(dim=-1, keepdim=True)
        g = work.gather(-1, sel)
        gsel.append(g)
        isel.append(sel)
        work = torch.where(lane == sel, -math.inf, work)
    return torch.cat(gsel, dim=1), torch.cat(isel, dim=1).to(torch.int32)


def renorm_gates(gates: torch.Tensor) -> torch.Tensor:
    return gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)


def router_fused_ref(x: torch.Tensor, w: torch.Tensor, k: int, *,
                     renorm: bool = False):
    """The fused routing prologue, plain: fp32 GEMM, softmax, top-k with
    the lowest index winning ties, optional gate renormalisation, and the
    counting-sort positions over the chosen ids.

    x: (t, d); w: (d, E).  Returns ``(gates (t, k), idx (t, k) int32,
    probs (t, E), logits (t, E), ranks (t*k,) int32, starts (E+1,)
    int32)``, as ``repro.kernels.ref.router_fused_ref``.
    """
    E = w.shape[1]
    logits = x.float() @ w.float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = topk_lowest_index(probs, k)
    if renorm and k > 1:
        gates = renorm_gates(gates)
    ranks, starts = group_sort_ref(idx.reshape(-1), E)
    return gates, idx, probs, logits, ranks, starts


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


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Causal softmax attention in fp32, rounded to q's dtype once.
    q/k/v: (B, T, H, hd), the same H (the wrapper repeats KV heads)."""
    B, T, H, hd = q.shape
    s = torch.einsum("bthk,bshk->bhts", q.float(), k.float()) / math.sqrt(hd)
    mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    s = torch.where(mask[None, None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhts,bshk->bthk", p, v.float())
    return o.to(q.dtype)


def rwkv6_scan_ref(r, k, v, w, u, s0):
    """Sequential WKV6 over T.  r/k/v/w: (B, T, nh, hd); u: (nh, hd); s0:
    (B, nh, hd, hd).  Per step ``y = r^T (S + u*k v^T)``, then ``S <- w*S
    + k v^T``, all fp32.  Returns ``(y (B, T, nh, hd), s_last)``, fp32."""
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    s = s0.float()
    ys = []
    for t in range(rf.shape[1]):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]       # (B, nh, i, j)
        ys.append(torch.einsum("bhi,bhij->bhj", rf[:, t], s + uf * kv))
        s = wf[:, t, :, :, None] * s + kv
    y = torch.stack(ys, 1) if ys else rf.new_zeros(rf.shape)
    return y, s


def ssd_chunk_ref(xh, dt, loga, Bc, Cc):
    """Mamba2 SSD intra-chunk terms, fp32.  xh: (B, nc, Q, nh, hd);
    dt/loga: (B, nc, Q, nh); Bc/Cc: (B, nc, Q, ds).  Returns ``(y_intra
    (B, nc, Q, nh, hd), sB (B, nc, nh, hd, ds), a_chunk (B, nc, nh))``.
    The decay exponent is set to -inf above the diagonal before ``exp``,
    so the entries that would overflow there are exact zeros."""
    xq, dq, lq, Bq, Cq = (a.float() for a in (xh, dt, loga, Bc, Cc))
    Q = xq.shape[2]
    cs = torch.cumsum(lq, dim=2)                                # (B,nc,Q,nh)
    scores = torch.einsum("bcin,bcjn->bcij", Cq, Bq)
    decay = cs[:, :, :, None, :] - cs[:, :, None, :, :]         # (B,nc,i,j,nh)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=xq.device).tril()
    decay = torch.where(mask[None, None, :, :, None], decay,
                        torch.full_like(decay, -math.inf))
    w_ij = torch.exp(decay) * scores[..., None]
    y_intra = torch.einsum("bcijh,bcjh,bcjhp->bcihp", w_ij, dq, xq)
    tail = cs[:, :, -1:, :] - cs
    sB = torch.einsum("bcjh,bcjh,bcjhp,bcjn->bchpn", torch.exp(tail), dq, xq,
                      Bq)
    a_chunk = torch.exp(cs[:, :, -1, :])
    return y_intra, sB, a_chunk
