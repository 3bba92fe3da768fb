"""Public wrappers for the hand-written Hopper kernels.

The port of ``repro.kernels.ops``.  Every wrapper follows one rule:

* a tensor on the CPU goes to the plain version in
  :mod:`repro_torch.kernels.ref` (this is how the CPU tests run);
* a CUDA tensor launches the CUDA kernel (``csrc/<name>.cu``, built at
  first use by :mod:`repro_torch.kernels._build`) or raises.

``dispatch_gather``, ``combine_gather``, ``grouped_ffn`` and
``grouped_ffn_ragged`` have no backward: on the card they raise where
autograd would need one, rather than return an output that silently carries
no gradient.  The training step runs their plain tensor code
(``use_kernel=False``), as the JAX package's does.

There is no fallback and no shape threshold: the JAX package's ``T < 16``
gates existed for TPU interpret-mode overhead, and on the card the kernels
take every shape, so decode steps launch them too.

Each wrapper counts the launches of its kernel in ``<wrapper>.launches``
(a plain integer); the count moves only where the kernel is launched, never
on the CPU path.  :func:`launch_counts` and :func:`reset_launch_counts`
read and clear all of them.

``group_sort`` keeps the JAX package's sort switch: ``impl="argsort"``
runs the plain stable sort wherever the keys lie, and ``impl="radix"`` is
the counting-sort kernel.  ``router_fused`` is a
``torch.autograd.Function``: the kernel computes the forward, and the
backward is the VJP of the plain chain.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import _build, ref

SORT_IMPLS = ("radix", "argsort")


def _stream() -> int:
    """PyTorch's current CUDA stream, as the integer ctypes passes on."""
    return torch.cuda.current_stream().cuda_stream


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")


def _on_cpu(*ts: Optional[torch.Tensor]) -> bool:
    devs = {t.device for t in ts if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}: expected cpu or cuda")
    return False


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _forward_only(name: str, *ts: Optional[torch.Tensor]) -> None:
    """Raise if autograd would need the gradient of a kernel that has no
    backward."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in ts):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward; call "
                           f"it under torch.no_grad(), or run the plain "
                           f"version (use_kernel=False) to train")


# group_sort.cu: 256 keys per step of a block, at most 1,024 blocks and
# 2**20 per-block counters, shared counters for at most 8,192 keys
SORT_TILE = 256
SORT_MAX_BLOCKS = 1024
SORT_MAX_COUNTERS = 1 << 20
SORT_MAX_KEYS = 8192


def _sort_blocks(A: int, num_keys: int):
    """``(nb, chunk)``: the counting sort's blocks and the keys each walks
    (a multiple of :data:`SORT_TILE`)."""
    nb = min(-(-A // SORT_TILE), SORT_MAX_BLOCKS,
             max(1, SORT_MAX_COUNTERS // num_keys))
    chunk = -(-A // nb)
    chunk = -(-chunk // SORT_TILE) * SORT_TILE
    return -(-A // chunk), chunk


def group_sort(keys: torch.Tensor, num_keys: int, *, impl: str = "argsort"):
    """Stable sort of small-domain int keys -> ``(ranks, starts)`` (see
    :func:`repro_torch.kernels.ref.group_sort_ref`).

    ``impl="argsort"`` runs the plain stable sort wherever ``keys`` lie;
    ``impl="radix"`` launches the counting-sort kernel on the card (keys
    int32 in ``[0, num_keys)``, ``num_keys <= 8192``, ``A < 2**31``) and
    runs the plain version on the CPU.  Both give the same bits: a stable
    integer sort is unique.
    """
    if impl not in SORT_IMPLS:
        raise ValueError(f"unknown sort_impl {impl!r}; "
                         f"expected one of {SORT_IMPLS}")
    if num_keys < 1:
        raise ValueError(f"num_keys must be >= 1, got {num_keys}")
    if impl == "argsort" or _on_cpu(keys):
        return ref.group_sort_ref(keys, num_keys)
    _require(keys.dim() == 1 and keys.dtype == torch.int32
             and keys.is_contiguous(), f"group_sort: keys must be a "
             f"contiguous (A,) int32 tensor, got {tuple(keys.shape)} "
             f"{keys.dtype}")
    _require(num_keys <= SORT_MAX_KEYS, f"group_sort: the kernel takes at "
             f"most {SORT_MAX_KEYS} keys, got num_keys={num_keys}")
    A = keys.shape[0]
    _require(A < 2 ** 31, f"group_sort: at most 2**31 - 1 keys, got {A}")
    dev = keys.device
    starts = torch.empty((num_keys + 1,), dtype=torch.int32, device=dev)
    if A == 0:
        return torch.empty((0,), dtype=torch.int32, device=dev), starts.zero_()
    ranks = torch.empty((A,), dtype=torch.int32, device=dev)
    nb, chunk = _sort_blocks(A, num_keys)
    counts = torch.empty((num_keys * nb,), dtype=torch.int32, device=dev)
    lib = _build.load("group_sort")
    _check(lib.group_sort(keys.data_ptr(), A, num_keys, nb, chunk,
                          counts.data_ptr(), ranks.data_ptr(),
                          starts.data_ptr(), _stream()), "group_sort")
    group_sort.launches += 1
    return ranks, starts


# router_fused.cu: 16 tokens per block, at most 256 experts
ROUTER_ROWS = 16
ROUTER_MAX_EXPERTS = 256


def _router_fused_cuda(x: torch.Tensor, w: torch.Tensor, k: int,
                       renorm: bool):
    _require(x.dim() == 2 and w.dim() == 2 and x.shape[1] == w.shape[0],
             f"router_fused: x (t, d) and w (d, E), got {tuple(x.shape)} "
             f"and {tuple(w.shape)}")
    _require(x.dtype in (torch.bfloat16, torch.float32), f"router_fused: x "
             f"must be bfloat16 or float32, got {x.dtype}")
    _require(w.dtype == torch.float32, f"router_fused: w must be float32, "
             f"got {w.dtype}")
    _require(x.is_contiguous() and w.is_contiguous(),
             "router_fused: x and w must be contiguous")
    t, d = x.shape
    E = w.shape[1]
    _require(E <= ROUTER_MAX_EXPERTS, f"router_fused: at most "
             f"{ROUTER_MAX_EXPERTS} experts, got {E}")
    dev = x.device
    f32, i32 = torch.float32, torch.int32
    gates = torch.empty((t, k), dtype=f32, device=dev)
    idx = torch.empty((t, k), dtype=i32, device=dev)
    probs = torch.empty((t, E), dtype=f32, device=dev)
    logits = torch.empty((t, E), dtype=f32, device=dev)
    ranks = torch.empty((t * k,), dtype=i32, device=dev)
    starts = torch.zeros((E + 1,), dtype=i32, device=dev)
    if t == 0:
        return gates, idx, probs, logits, ranks, starts
    nb = -(-t // ROUTER_ROWS)
    counts = torch.empty((E * nb,), dtype=i32, device=dev)
    lib = _build.load("router_fused")
    _check(lib.router_fused(x.data_ptr(), int(x.dtype == torch.bfloat16),
                            w.data_ptr(), t, d, E, k, logits.data_ptr(),
                            probs.data_ptr(), gates.data_ptr(),
                            idx.data_ptr(), counts.data_ptr(), nb,
                            ranks.data_ptr(), starts.data_ptr(), _stream()),
           "router_fused")
    router_fused.launches += 1
    if renorm and k > 1:
        gates = ref.renorm_gates(gates)
    return gates, idx, probs, logits, ranks, starts


class _RouterFused(torch.autograd.Function):
    """Forward: the kernel on the card, the plain version on the CPU.
    Backward: the VJP of the plain chain (fp32 GEMM, softmax, the chosen
    probabilities gathered at the forward's own ids, renormalisation), as
    the JAX package's ``custom_vjp`` does; the integer outputs carry no
    gradient."""

    @staticmethod
    def forward(ctx, x, w, k, renorm):
        if _on_cpu(x, w):
            out = ref.router_fused_ref(x, w, k, renorm=renorm)
        else:
            out = _router_fused_cuda(x, w, k, renorm)
        idx, ranks, starts = out[1], out[4], out[5]
        ctx.save_for_backward(x, w, idx)
        ctx.k, ctx.renorm = k, renorm
        ctx.mark_non_differentiable(idx, ranks, starts)
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, g_gates, _g_idx, g_probs, g_logits, _g_ranks,
                 _g_starts):
        x, w, idx = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad[:2]
        with torch.enable_grad():
            xx = x.detach().requires_grad_(need_x)
            ww = w.detach().requires_grad_(need_w)
            logits = xx.float() @ ww.float()
            probs = torch.softmax(logits, dim=-1)
            gates = probs.gather(1, idx.long())
            if ctx.renorm and ctx.k > 1:
                gates = ref.renorm_gates(gates)
            outs = [(o, g) for o, g in ((gates, g_gates), (probs, g_probs),
                                        (logits, g_logits)) if g is not None]
            if not outs:
                return None, None, None, None
            got = list(torch.autograd.grad(
                [o for o, _ in outs], [t for t in (xx, ww) if t.requires_grad],
                [g for _, g in outs]))
        gx = got.pop(0) if need_x else None
        gw = got.pop(0) if need_w else None
        return gx, gw, None, None


def router_fused(x: torch.Tensor, w: torch.Tensor, k: int, *,
                 renorm: bool = False):
    """The fused routing prologue: router GEMM, softmax, top-k (lowest index
    wins ties) and the counting-sort positions over the chosen ids.

    x: (t, d) bf16 or fp32; w: (d, E) fp32; ``1 <= k <= E <= 256``.
    Returns ``(gates (t,k), idx (t,k) int32, probs (t,E), logits (t,E),
    ranks (t*k,) int32, starts (E+1,) int32)`` (see
    :func:`repro_torch.kernels.ref.router_fused_ref`).  Differentiable in
    x and w through gates, probs and logits.  There is no shape threshold:
    every CUDA call launches the kernel.
    """
    E = w.shape[-1]
    if not 1 <= k <= E:
        raise ValueError(f"top-k {k} must be in [1, num_experts {E}]")
    return _RouterFused.apply(x, w, k, renorm)


def dispatch_gather(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """MoE dispatch: ``out[i] = x[src[i]]``, zeros where ``src[i] < 0``.
    x: (T, d); src: (R,) int32 -> (R, d).  On the card any dtype whose row
    is a multiple of 16 bytes is taken (the kernel copies bytes); ``src``
    must lie in ``[-1, T)``."""
    if _on_cpu(x, src):
        return ref.dispatch_gather_ref(x, src)
    _forward_only("dispatch_gather", x)
    _require(x.dim() == 2 and src.dim() == 1,
             f"dispatch_gather: x (T, d) and src (R,), got "
             f"{tuple(x.shape)} and {tuple(src.shape)}")
    _require(src.dtype == torch.int32, f"dispatch_gather: src must be "
             f"int32, got {src.dtype}")
    _require(x.is_contiguous() and src.is_contiguous(),
             "dispatch_gather: x and src must be contiguous")
    T, d = x.shape
    R = src.shape[0]
    row_bytes = d * x.element_size()
    _require(row_bytes % 16 == 0, f"dispatch_gather: a row of x must be a "
             f"multiple of 16 bytes, got {row_bytes}")
    out = torch.empty((R, d), dtype=x.dtype, device=x.device)
    if R == 0:
        return out
    lib = _build.load("dispatch_gather")
    _check(lib.dispatch_gather(x.data_ptr(), src.data_ptr(), out.data_ptr(),
                               T, R, row_bytes, _stream()), "dispatch_gather")
    dispatch_gather.launches += 1
    return out


def combine_gather(rows: torch.Tensor, src: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """MoE combine: ``y[i] = sum_j scale[i, j] * rows[src[i, j]]``, skipping
    ``src < 0``; fp32 accumulation in order j = 0..k-1, one rounding at the
    end.  rows: (R, d) bf16; src: (t, k) int32; scale: (t, k) fp32."""
    if _on_cpu(rows, src, scale):
        return ref.combine_gather_ref(rows, src, scale)
    _forward_only("combine_gather", rows, scale)
    _require(rows.dim() == 2 and src.dim() == 2 and src.shape == scale.shape,
             f"combine_gather: rows (R, d), src/scale (t, k), got "
             f"{tuple(rows.shape)}, {tuple(src.shape)}, {tuple(scale.shape)}")
    _require(rows.dtype == torch.bfloat16, f"combine_gather: rows must be "
             f"bfloat16 on the card, got {rows.dtype}")
    _require(src.dtype == torch.int32 and scale.dtype == torch.float32,
             f"combine_gather: src int32 and scale float32, got {src.dtype} "
             f"and {scale.dtype}")
    _require(rows.is_contiguous() and src.is_contiguous()
             and scale.is_contiguous(),
             "combine_gather: rows, src and scale must be contiguous")
    R, d = rows.shape
    t, k = src.shape
    _require(d % 8 == 0, f"combine_gather: d must be a multiple of 8, got {d}")
    out = torch.empty((t, d), dtype=rows.dtype, device=rows.device)
    if t == 0:
        return out
    lib = _build.load("combine_gather")
    _check(lib.combine_gather(rows.data_ptr(), src.data_ptr(),
                              scale.data_ptr(), out.data_ptr(), R, t, k, d,
                              _stream()), "combine_gather")
    combine_gather.launches += 1
    return out


ACTS = {"silu": 0, "gelu": 1}


def grouped_ffn(x: torch.Tensor, w1: torch.Tensor, w3: Optional[torch.Tensor],
                w2: torch.Tensor, *, act: str = "gelu") -> torch.Tensor:
    """Grouped expert FFN ``act(x @ w1) [* (x @ w3)] @ w2`` per group.
    x: (G, T, d); w1/w3: (G, d, f); w2: (G, f, d); ``w3=None`` is the plain
    MLP.  The weights come in x's dtype (the model casts them once at
    load); on the card that is bf16, and d, f are multiples of 64."""
    ws = (w1, w2) + (() if w3 is None else (w3,))
    _require(all(w.dtype == x.dtype for w in ws), f"grouped_ffn: weights "
             f"must have x's dtype {x.dtype}, got {[w.dtype for w in ws]}")
    if _on_cpu(x, w1, w3, w2):
        return ref.grouped_ffn_ref(x, w1, w3, w2, act=act)
    _forward_only("grouped_ffn", x, w1, w3, w2)
    _require(act in ACTS, f"grouped_ffn: act must be one of {tuple(ACTS)}, "
             f"got {act!r}")
    _require(x.dim() == 3, f"grouped_ffn: x (G, T, d), got {tuple(x.shape)}")
    G, T, d = x.shape
    f = w1.shape[-1]
    shapes = [(w1, (G, d, f)), (w2, (G, f, d))]
    if w3 is not None:
        shapes.append((w3, (G, d, f)))
    for w, want in shapes:
        _require(tuple(w.shape) == want, f"grouped_ffn: weight shape "
                 f"{tuple(w.shape)}, expected {want}")
    for t in (x,) + ws:
        _require(t.dtype == torch.bfloat16, f"grouped_ffn: bfloat16 on the "
                 f"card, got {t.dtype}")
        _require(t.is_contiguous(), "grouped_ffn: inputs must be contiguous")
    _require(d % 64 == 0 and f % 64 == 0, f"grouped_ffn: d and f must be "
             f"multiples of 64, got d={d}, f={f}")
    y = torch.empty_like(x)
    if G == 0 or T == 0:
        return y
    h = torch.empty((G, T, f), dtype=x.dtype, device=x.device)
    lib = _build.load("grouped_ffn")
    _check(lib.grouped_ffn(x.data_ptr(), w1.data_ptr(),
                           None if w3 is None else w3.data_ptr(),
                           w2.data_ptr(), h.data_ptr(), y.data_ptr(),
                           G, T, d, f, ACTS[act], _stream()), "grouped_ffn")
    grouped_ffn.launches += 1
    return y


# grouped_ffn_ragged.cu: a block takes min(block, 64) rows of one tile
RAGGED_MAX_ROWS_PER_BLOCK = 64


def grouped_ffn_ragged(rows: torch.Tensor, group_starts: torch.Tensor,
                       w1: torch.Tensor, w3: Optional[torch.Tensor],
                       w2: torch.Tensor, *, block: int,
                       act: str = "gelu") -> torch.Tensor:
    """Ragged grouped expert FFN over the dropless tile-aligned layout:
    row tile ``i`` (``block`` rows) goes through the expert ``g`` that owns
    it, ``act(x @ w1[g]) [* (x @ w3[g])] @ w2[g]``.

    rows: (R, d), R a multiple of ``block``, sorted by group with zeros in
    the alignment padding and past ``group_starts[G]`` (what
    :func:`repro_torch.core.dispatch.dispatch_ragged` gives); group_starts:
    (G+1,) int32 ascending segment offsets, each a multiple of ``block``;
    w1/w3: (G, d, f); w2: (G, f, d), in rows' dtype.  On the card: bf16,
    d and f multiples of 64, ``block`` a multiple of 8 that is at most 64
    or a multiple of 64.  The kernel writes zeros for the tiles past
    ``group_starts[G]`` without reading their weights: their rows are
    zeros, so the FFN would give zeros there too.
    """
    ws = (w1, w2) + (() if w3 is None else (w3,))
    _require(all(w.dtype == rows.dtype for w in ws), f"grouped_ffn_ragged: "
             f"weights must have rows' dtype {rows.dtype}, got "
             f"{[w.dtype for w in ws]}")
    if _on_cpu(rows, group_starts, w1, w3, w2):
        return ref.grouped_ffn_ragged_ref(rows, group_starts, w1, w3, w2,
                                          act=act)
    _forward_only("grouped_ffn_ragged", rows, w1, w3, w2)
    _require(act in ACTS, f"grouped_ffn_ragged: act must be one of "
             f"{tuple(ACTS)}, got {act!r}")
    _require(rows.dim() == 2 and group_starts.dim() == 1,
             f"grouped_ffn_ragged: rows (R, d) and group_starts (G+1,), got "
             f"{tuple(rows.shape)} and {tuple(group_starts.shape)}")
    R, d = rows.shape
    G = group_starts.shape[0] - 1
    f = w1.shape[-1]
    _require(G >= 1, "grouped_ffn_ragged: at least one group")
    shapes = [(w1, (G, d, f)), (w2, (G, f, d))]
    if w3 is not None:
        shapes.append((w3, (G, d, f)))
    for w, want in shapes:
        _require(tuple(w.shape) == want, f"grouped_ffn_ragged: weight shape "
                 f"{tuple(w.shape)}, expected {want}")
    _require(group_starts.dtype == torch.int32 and group_starts.is_contiguous(),
             f"grouped_ffn_ragged: group_starts must be contiguous int32, "
             f"got {group_starts.dtype}")
    for t in (rows,) + ws:
        _require(t.dtype == torch.bfloat16, f"grouped_ffn_ragged: bfloat16 "
                 f"on the card, got {t.dtype}")
        _require(t.is_contiguous(),
                 "grouped_ffn_ragged: inputs must be contiguous")
    _require(d % 64 == 0 and f % 64 == 0, f"grouped_ffn_ragged: d and f "
             f"must be multiples of 64, got d={d}, f={f}")
    step = min(block, RAGGED_MAX_ROWS_PER_BLOCK)
    _require(block >= 8 and block % 8 == 0 and block % step == 0,
             f"grouped_ffn_ragged: block must be a multiple of 8 that is at "
             f"most 64 or a multiple of 64, got {block}")
    _require(R % block == 0, f"grouped_ffn_ragged: R={R} is not a multiple "
             f"of block={block}")
    _require(R // step <= 65535, f"grouped_ffn_ragged: at most 65535 row "
             f"blocks, got {R // step}")
    y = torch.empty_like(rows)
    if R == 0:
        return y
    h = torch.empty((R, f), dtype=rows.dtype, device=rows.device)
    lib = _build.load("grouped_ffn_ragged")
    _check(lib.grouped_ffn_ragged(rows.data_ptr(), group_starts.data_ptr(),
                                  w1.data_ptr(),
                                  None if w3 is None else w3.data_ptr(),
                                  w2.data_ptr(), h.data_ptr(), y.data_ptr(),
                                  R, G, d, f, block, ACTS[act], _stream()),
           "grouped_ffn_ragged")
    grouped_ffn_ragged.launches += 1
    return y


KERNEL_WRAPPERS = (dispatch_gather, grouped_ffn, combine_gather,
                   router_fused, group_sort, grouped_ffn_ragged)
for _w in KERNEL_WRAPPERS:
    _w.launches = 0


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel since the last reset."""
    return {w.__name__: w.launches for w in KERNEL_WRAPPERS}


def reset_launch_counts() -> None:
    for w in KERNEL_WRAPPERS:
        w.launches = 0
