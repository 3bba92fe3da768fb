"""Public wrappers for the hand-written Hopper kernels.

The port of ``repro.kernels.ops``.  Every wrapper follows one rule:

* a tensor on the CPU goes to the plain version in
  :mod:`repro_torch.kernels.ref` (this is how the CPU tests run);
* a CUDA tensor launches the CUDA kernel (``csrc/<name>.cu``, built at
  first use by :mod:`repro_torch.kernels._build`) or raises.

``dispatch_gather``, ``combine_gather``, ``grouped_ffn``,
``grouped_ffn_ragged``, ``flash_attention``, ``rwkv6_scan`` and
``ssd_chunk`` have no backward (nor do their TPU kernels): on the card they
raise where autograd would need one, rather than return an output that
silently carries no gradient.  The training step runs their plain tensor
code (``use_kernel=False``), as the JAX package's does.

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

import functools
import math
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.kernels import _build, ref

SORT_IMPLS = ("radix", "argsort")


def _stream() -> int:
    """PyTorch's current CUDA stream of the current device, as the integer
    ctypes passes on (:func:`_on_cpu` holds every card tensor to that
    device)."""
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
    if dev.index != torch.cuda.current_device():
        # _stream() is the current device's: launching there would run the
        # kernel on another card's stream
        raise ValueError(f"tensors on {dev}, but the current device is "
                         f"cuda:{torch.cuda.current_device()}; make it "
                         f"current first (torch.cuda.set_device)")
    return False


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _aligned16(name: str, *ts: Optional[torch.Tensor]) -> None:
    """Raise unless every tensor's data starts on a 16-byte boundary, as
    the kernels' 16-byte copies (TMA tensor maps, cp.async) need."""
    for t in ts:
        if t is not None and t.data_ptr() % 16 != 0:
            raise ValueError(f"{name}: the kernel needs 16-byte aligned "
                             f"data, got a tensor at {t.data_ptr():#x} (a "
                             f"view at an odd offset? pass a fresh copy)")


def _forward_only(name: str, *ts: Optional[torch.Tensor]) -> None:
    """Raise if autograd would need the gradient of a kernel that has no
    backward."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in ts):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward; call "
                           f"it under torch.no_grad(), or run the plain "
                           f"version (use_kernel=False) to train")


# group_sort.cu's three-launch route: 256 keys per step of a block, at most
# 1,024 blocks and 2**20 per-block counters, shared counters for at most
# 8,192 keys
SORT_TILE = 256
SORT_MAX_BLOCKS = 1024
SORT_MAX_COUNTERS = 1 << 20
SORT_MAX_KEYS = 8192
# its one-launch route: one block of at most 16 warps, each lane holding at
# most 8 keys, over at most 1,024 key values.  Up to 4,096 keys it is as
# fast on the device as three launches or faster, and saves two launches of
# host time; past that three launches, spread over the SMs, are faster
# (chip_smoke.py's sort crossover, PERF.md)
SORT_ONE_MAX_WARPS = 16
SORT_ONE_STEPS = 8
SORT_ONE_MAX_KEYS = 1024
SORT_ONE_MAX_A = SORT_ONE_MAX_WARPS * 32 * SORT_ONE_STEPS            # 4,096


class SortRoute(NamedTuple):
    """How ``group_sort`` runs on the card (see :func:`sort_route`)."""
    launches: int      # 1: one block; 3: hist, scan, rank
    blocks: int        # 1, or the three-launch nb
    warps: int         # warps a block
    steps: int         # one launch: keys a lane holds
    chunk: int         # three launches: keys a block walks


def _sort_blocks(A: int, num_keys: int):
    """``(nb, chunk)``: the three-launch route's blocks and the keys each
    walks (a multiple of :data:`SORT_TILE`)."""
    nb = min(-(-A // SORT_TILE), SORT_MAX_BLOCKS,
             max(1, SORT_MAX_COUNTERS // num_keys))
    chunk = -(-A // nb)
    chunk = -(-chunk // SORT_TILE) * SORT_TILE
    return -(-A // chunk), chunk


def _one_launch_route(A: int) -> SortRoute:
    """The one-launch layout of ``1 <= A <= SORT_ONE_MAX_A`` keys: the
    fewest warps (a power of two) that hold them at
    :data:`SORT_ONE_STEPS` keys a lane, the keys spread evenly over them:
    warp ``w`` holds keys ``[w * steps * 32, + steps * 32)``."""
    warps = 1 << (-(-A // (32 * SORT_ONE_STEPS)) - 1).bit_length()
    return SortRoute(1, 1, warps, -(-A // (warps * 32)), 0)


def _three_launch_route(A: int, num_keys: int) -> SortRoute:
    nb, chunk = _sort_blocks(A, num_keys)
    return SortRoute(3, nb, SORT_TILE // 32, 0, chunk)


def sort_route(A: int, num_keys: int) -> SortRoute:
    """The counting sort's route for ``A >= 1`` keys over ``num_keys``
    values: one launch where the keys fit one block's registers
    (``A <= SORT_ONE_MAX_A``) and their counters its shared memory
    (``num_keys <= SORT_ONE_MAX_KEYS``), else three."""
    if A < 1:
        raise ValueError(f"sort_route: A must be >= 1, got {A}")
    if A <= SORT_ONE_MAX_A and num_keys <= SORT_ONE_MAX_KEYS:
        return _one_launch_route(A)
    return _three_launch_route(A, num_keys)


def group_sort(keys: torch.Tensor, num_keys: int, *, impl: str = "argsort"):
    """Stable sort of small-domain int keys -> ``(ranks, starts)`` (see
    :func:`repro_torch.kernels.ref.group_sort_ref`).

    ``impl="argsort"`` runs the plain stable sort wherever ``keys`` lie;
    ``impl="radix"`` launches the counting-sort kernel on the card (keys
    int32 in ``[0, num_keys)``, ``num_keys <= 8192``, ``A < 2**31``; one
    launch or three, by :func:`sort_route`) and runs the plain version on
    the CPU.  Both give the same bits: a stable integer sort is unique.
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
    if A == 0:
        return (torch.empty((0,), dtype=torch.int32, device=keys.device),
                torch.zeros((num_keys + 1,), dtype=torch.int32,
                            device=keys.device))
    return _group_sort_cuda(keys, num_keys, sort_route(A, num_keys))


def _group_sort_cuda(keys: torch.Tensor, num_keys: int, route: SortRoute):
    """Launch the counting sort of ``A >= 1`` card keys on ``route``."""
    A, dev = keys.shape[0], keys.device
    ranks = torch.empty((A,), dtype=torch.int32, device=dev)
    starts = torch.empty((num_keys + 1,), dtype=torch.int32, device=dev)
    lib = _build.load("group_sort")
    if route.launches == 1:
        err = lib.group_sort_one(keys.data_ptr(), A, num_keys, route.warps,
                                 route.steps, ranks.data_ptr(),
                                 starts.data_ptr(), _stream())
    else:
        counts = torch.empty((num_keys * route.blocks,), dtype=torch.int32,
                             device=dev)
        err = lib.group_sort_three(keys.data_ptr(), A, num_keys, route.blocks,
                                   route.chunk, counts.data_ptr(),
                                   ranks.data_ptr(), starts.data_ptr(),
                                   _stream())
    _check(err, "group_sort")
    group_sort.launches += 1
    return ranks, starts


# router_fused.cu: 16 tokens per block, at most 256 experts
ROUTER_ROWS = 16
ROUTER_MAX_EXPERTS = 256
# (device index, stream) -> router_fused.cu's last-block counter
_ROUTER_TICKETS: Dict[tuple, torch.Tensor] = {}


def _router_ticket(dev: torch.device) -> torch.Tensor:
    """The router kernel's arrival counter for the current stream: one
    int32, zero when it is made, counted up by each block of a launch and
    set back to zero by the launch's last block.  One per stream, so that
    launches on two streams, which may overlap, never share one; launches
    on one stream run in order."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    ticket = _ROUTER_TICKETS.get(key)
    if ticket is None:
        ticket = torch.zeros((1,), dtype=torch.int32, device=dev)
        _ROUTER_TICKETS[key] = ticket
    return ticket


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
    if t == 0:
        starts = torch.zeros((E + 1,), dtype=i32, device=dev)
        return gates, idx, probs, logits, ranks, starts
    starts = torch.empty((E + 1,), dtype=i32, device=dev)   # the kernel's
    nb = -(-t // ROUTER_ROWS)
    counts = torch.empty((E * nb,), dtype=i32, device=dev)
    ticket = _router_ticket(dev)
    lib = _build.load("router_fused")
    _check(lib.router_fused(x.data_ptr(), int(x.dtype == torch.bfloat16),
                            w.data_ptr(), t, d, E, k, logits.data_ptr(),
                            probs.data_ptr(), gates.data_ptr(),
                            idx.data_ptr(), counts.data_ptr(), nb,
                            ranks.data_ptr(), starts.data_ptr(),
                            ticket.data_ptr(), _stream()),
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
    load); on the card that is bf16, d and f are multiples of 64, G is at
    most 65,535, and every tensor's data is 16-byte aligned (TMA)."""
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
    _require(G <= 65535, f"grouped_ffn: at most 65535 groups, got {G}")
    _aligned16("grouped_ffn", x, w1, w3, w2)
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


# grouped_ffn_ragged.cu: a block takes min(block, 64) rows of one tile (one
# wgmma warpgroup)
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
    or a multiple of 64, and every tensor's data 16-byte aligned (TMA).
    The kernel writes zeros for the tiles past ``group_starts[G]`` without
    reading their weights: their rows are zeros, so the FFN would give
    zeros there too.
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
    _aligned16("grouped_ffn_ragged", rows, w1, w3, w2)
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


# flash_attn.cu: the widest padded head of its wgmma route, and the widest
# head of its wide route
FLASH_WGMMA_MAX_HEAD_DIM = 192
FLASH_MAX_HEAD_DIM = 512


def flash_route(hd: int) -> str:
    """Which route of ``flash_attn.cu`` runs head size ``hd``: ``"wgmma"``
    (tensor cores) up to :data:`FLASH_WGMMA_MAX_HEAD_DIM`, ``"wide"`` (the
    head dim tiled through shared memory, fp32 on the CUDA cores) past it,
    up to :data:`FLASH_MAX_HEAD_DIM`.  hd must be a positive multiple of 8
    (rows of 16 bytes); anything else raises ``ValueError``."""
    _require(0 < hd <= FLASH_MAX_HEAD_DIM and hd % 8 == 0,
             f"flash_attention: hd must be a positive multiple of 8 up to "
             f"{FLASH_MAX_HEAD_DIM}, got {hd}")
    return "wgmma" if hd <= FLASH_WGMMA_MAX_HEAD_DIM else "wide"


def flash_padded_head(hd: int) -> int:
    """The head size the flash kernel runs ``hd`` at: 32 for hd <= 32,
    else hd rounded up to a multiple of 64 (the wgmma route's 64-column
    TMA box, up to 192; the wide route's 64-column chunk past it); the
    columns past hd load as zeros.  Raises as :func:`flash_route`."""
    flash_route(hd)
    return 32 if hd <= 32 else -(-hd // 64) * 64


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Causal attention with GQA.  q: (B, T, H, hd); k/v: (B, T, KV, hd)
    with KV | H; returns (B, T, H, hd) in q's dtype.  As the JAX package's
    kernel, it takes ``T % min(128, T) == 0`` and raises otherwise, and
    assumes the positions are ``0..T-1``.

    On the CPU: the plain version on KV heads repeated H / KV times (as the
    JAX wrapper repeats them).  On the card: bf16, hd a multiple of 8 up to
    :data:`FLASH_MAX_HEAD_DIM` (the route :func:`flash_route` names, run at
    :func:`flash_padded_head`), 16-byte aligned data (TMA); the kernel
    reads each query head's KV head directly, scales q in bf16 and rounds
    the probabilities to bf16 before PV, as the Pallas body does.
    """
    _require(q.dim() == 4 and k.dim() == 4 and v.shape == k.shape,
             f"flash_attention: q (B, T, H, hd), k/v (B, T, KV, hd), got "
             f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, T, H, hd = q.shape
    KV = k.shape[2]
    _require(k.shape[:2] == q.shape[:2] and k.shape[3] == hd and KV >= 1
             and H % KV == 0, f"flash_attention: k/v {tuple(k.shape)} do "
             f"not fit q {tuple(q.shape)} (KV must divide H)")
    _require(T > 0 and T % min(128, T) == 0, f"flash_attention: T={T} must "
             f"be a multiple of min(128, T), as the TPU kernel's blocks")
    if _on_cpu(q, k, v):
        if KV != H:
            k = k.repeat_interleave(H // KV, dim=2)
            v = v.repeat_interleave(H // KV, dim=2)
        return ref.flash_attention_ref(q, k, v)
    _forward_only("flash_attention", q, k, v)
    for t in (q, k, v):
        _require(t.dtype == torch.bfloat16, f"flash_attention: bfloat16 on "
                 f"the card, got {t.dtype}")
        _require(t.is_contiguous(), "flash_attention: inputs must be "
                 "contiguous")
    flash_padded_head(hd)
    _require(B <= 65535 and H <= 65535, f"flash_attention: at most 65535 "
             f"batch rows and heads, got B={B}, H={H}")
    _aligned16("flash_attention", q, k, v)
    # the Pallas body multiplies bf16 q by a Python float, which JAX rounds
    # to bf16 first
    scale = float(torch.tensor(1.0 / math.sqrt(hd), dtype=q.dtype))
    out = torch.empty_like(q)
    lib = _build.load("flash_attn")
    _check(lib.flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               out.data_ptr(), B, T, H, KV, hd, scale,
                               _stream()), "flash_attention")
    flash_attention.launches += 1
    return out


# rwkv6_scan.cu: the head size it is written for
RWKV_HEAD_DIM = 64


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor):
    """The WKV6 recurrence.  r/k/v/w: (B, T, nh, hd); u: (nh, hd); s0:
    (B, nh, hd, hd).  Returns ``(y (B, T, nh, hd), s_last (B, nh, hd,
    hd))``, fp32 (see :func:`repro_torch.kernels.ref.rwkv6_scan_ref`).  On
    the card: every input fp32, contiguous and 16-byte aligned (the
    kernel reads them 16 bytes at a time), hd = 64."""
    if _on_cpu(r, k, v, w, u, s0):
        return ref.rwkv6_scan_ref(r, k, v, w, u, s0)
    _forward_only("rwkv6_scan", r, k, v, w, u, s0)
    _require(r.dim() == 4, f"rwkv6_scan: r (B, T, nh, hd), got "
             f"{tuple(r.shape)}")
    B, T, nh, hd = r.shape
    for name, t, want in (("k", k, r.shape), ("v", v, r.shape),
                          ("w", w, r.shape), ("u", u, (nh, hd)),
                          ("s0", s0, (B, nh, hd, hd))):
        _require(tuple(t.shape) == tuple(want), f"rwkv6_scan: {name} shape "
                 f"{tuple(t.shape)}, expected {tuple(want)}")
    for t in (r, k, v, w, u, s0):
        _require(t.dtype == torch.float32, f"rwkv6_scan: float32 on the "
                 f"card, got {t.dtype}")
        _require(t.is_contiguous(), "rwkv6_scan: inputs must be contiguous")
    _require(hd == RWKV_HEAD_DIM, f"rwkv6_scan: the kernel takes hd="
             f"{RWKV_HEAD_DIM}, got {hd}")
    _aligned16("rwkv6_scan", r, k, v, w, u, s0)
    y = torch.empty_like(r)
    s_last = torch.empty_like(s0)
    lib = _build.load("rwkv6_scan")
    _check(lib.rwkv6_scan(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                          w.data_ptr(), u.data_ptr(), s0.data_ptr(),
                          y.data_ptr(), s_last.data_ptr(), B, T, nh, hd,
                          _stream()), "rwkv6_scan")
    rwkv6_scan.launches += 1
    return y, s_last


# ssd_chunk.cu's grouped route: instantiated at these (Q, hd, ds), zamba2-
# 2.7b's and its reduced config's; a block takes a chunk and up to
# SSD_MAX_GROUP consecutive heads (at Q 128 their vectors fill what the
# block's 227 KB of shared memory leaves; the kernel's kMaxGroup, which
# tests/test_torch_ssd_chunk.py holds equal to it)
SSD_GROUPED_SHAPES = ((128, 64, 64), (32, 32, 16))
SSD_MAX_GROUP = 27
# a grouped block's start (its loads, the scores C B^T, the cumsums) in
# heads' time: the fit of tools/ssd_group_sweep.py over G = 1..27 at
# zamba2-2.7b's shape on an H100 (PERF.md section 6)
SSD_BLOCK_START = 1.2


class SsdRoute(NamedTuple):
    """How ``ssd_chunk`` runs on the card (see :func:`ssd_route`)."""
    route: str         # "grouped" or "general"
    group: int         # heads a block
    blocks: int


def ssd_route(BC: int, Q: int, nh: int, hd: int, ds: int,
              sms: int) -> SsdRoute:
    """The SSD kernel's route for ``BC = B * nc >= 1`` chunks of ``nh >= 1``
    heads on a card of ``sms`` SMs.  At the shapes the grouped kernel is
    instantiated at, one block (one an SM) takes a chunk and ``G`` heads:
    its start, ``SSD_BLOCK_START`` heads' time, then each head, so a block
    costs about ``G + SSD_BLOCK_START`` heads' time, and ``G`` is the one
    that gives the fewest such units over the waves of ``BC * ceil(nh /
    G)`` blocks (ties to the smaller ``G``).  Every other shape runs the
    general kernel, a block per (chunk, head)."""
    if BC < 1 or nh < 1 or sms < 1:
        raise ValueError(f"ssd_route: BC, nh and sms must be >= 1, got "
                         f"{BC}, {nh}, {sms}")
    if (Q, hd, ds) not in SSD_GROUPED_SHAPES:
        return SsdRoute("general", 1, BC * nh)
    best = None
    for G in range(1, min(SSD_MAX_GROUP, nh) + 1):
        blocks = BC * -(-nh // G)
        cost = -(-blocks // sms) * (G + SSD_BLOCK_START)
        if best is None or cost < best[0]:
            best = (cost, SsdRoute("grouped", G, blocks))
    return best[1]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def ssd_chunk(xh: torch.Tensor, dt: torch.Tensor, loga: torch.Tensor,
              Bc: torch.Tensor, Cc: torch.Tensor):
    """Mamba2 SSD intra-chunk terms.  xh: (B, nc, Q, nh, hd); dt/loga:
    (B, nc, Q, nh); Bc/Cc: (B, nc, Q, ds).  Returns ``(y_intra (B, nc, Q,
    nh, hd), sB (B, nc, nh, hd, ds), a_chunk (B, nc, nh))``, fp32 (see
    :func:`repro_torch.kernels.ref.ssd_chunk_ref`).  No model of the port
    calls it (nor does one of the JAX package).  On the card: fp32,
    contiguous, 16-byte aligned, Q, hd and ds multiples of 4; one launch,
    of the grouped kernel or the general one (:func:`ssd_route`); the
    general one's working set must fit a block's shared memory (the launch
    fails with an error otherwise)."""
    if _on_cpu(xh, dt, loga, Bc, Cc):
        return ref.ssd_chunk_ref(xh, dt, loga, Bc, Cc)
    _forward_only("ssd_chunk", xh, dt, loga, Bc, Cc)
    _require(xh.dim() == 5, f"ssd_chunk: xh (B, nc, Q, nh, hd), got "
             f"{tuple(xh.shape)}")
    B, nc, Q, nh, hd = xh.shape
    ds = Bc.shape[-1]
    for name, t, want in (("dt", dt, (B, nc, Q, nh)),
                          ("loga", loga, (B, nc, Q, nh)),
                          ("Bc", Bc, (B, nc, Q, ds)),
                          ("Cc", Cc, (B, nc, Q, ds))):
        _require(tuple(t.shape) == want, f"ssd_chunk: {name} shape "
                 f"{tuple(t.shape)}, expected {want}")
    for t in (xh, dt, loga, Bc, Cc):
        _require(t.dtype == torch.float32, f"ssd_chunk: float32 on the "
                 f"card, got {t.dtype}")
        _require(t.is_contiguous(), "ssd_chunk: inputs must be contiguous")
    _require(all(n > 0 and n % 4 == 0 for n in (Q, hd, ds)),
             f"ssd_chunk: Q, hd and ds must be positive multiples of 4, got "
             f"Q={Q}, hd={hd}, ds={ds}")
    _require(nh <= 65535, f"ssd_chunk: at most 65535 heads, got {nh}")
    _aligned16("ssd_chunk", xh, dt, loga, Bc, Cc)
    dev = xh.device
    y = torch.empty_like(xh)
    sB = torch.empty((B, nc, nh, hd, ds), dtype=torch.float32, device=dev)
    a_chunk = torch.empty((B, nc, nh), dtype=torch.float32, device=dev)
    if a_chunk.numel() == 0:
        return y, sB, a_chunk
    lib = _build.load("ssd_chunk")
    args = (xh.data_ptr(), dt.data_ptr(), loga.data_ptr(), Bc.data_ptr(),
            Cc.data_ptr(), y.data_ptr(), sB.data_ptr(), a_chunk.data_ptr(),
            B * nc, Q, nh, hd, ds)
    route = ssd_route(B * nc, Q, nh, hd, ds, _sm_count(
        dev.index if dev.index is not None else torch.cuda.current_device()))
    if route.route == "grouped":
        err = lib.ssd_chunk_grouped(*args, route.group, _stream())
    else:
        err = lib.ssd_chunk(*args, _stream())
    _check(err, "ssd_chunk")
    ssd_chunk.launches += 1
    return y, sB, a_chunk


KERNEL_WRAPPERS = (dispatch_gather, grouped_ffn, combine_gather,
                   router_fused, group_sort, grouped_ffn_ragged,
                   flash_attention, rwkv6_scan, ssd_chunk)
for _w in KERNEL_WRAPPERS:
    _w.launches = 0


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel since the last reset."""
    return {w.__name__: w.launches for w in KERNEL_WRAPPERS}


def reset_launch_counts() -> None:
    for w in KERNEL_WRAPPERS:
        w.launches = 0
