"""Public wrappers for the hand-written Hopper kernels.

The port of ``repro.kernels.ops``.  Every wrapper follows one rule:

* a tensor on the CPU goes to the plain version in
  :mod:`repro_torch.kernels.ref` (this is how the CPU tests run);
* a CUDA tensor launches the CUDA kernel (``csrc/<name>.cu``, built at
  first use by :mod:`repro_torch.kernels._build`) or raises.

There is no fallback and no shape threshold: the JAX package's ``T < 16``
gates existed for TPU interpret-mode overhead, and on the card the kernels
take every shape, so decode steps launch them too.

Each wrapper counts the launches of its kernel in ``<wrapper>.launches``
(a plain integer); the count moves only where the kernel is launched, never
on the CPU path.  :func:`launch_counts` and :func:`reset_launch_counts`
read and clear all of them.

``group_sort`` keeps the JAX package's sort switch: ``impl="argsort"``
runs the plain stable sort, and ``impl="radix"`` raises until the counting
sort kernel is ported.
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


def group_sort(keys: torch.Tensor, num_keys: int, *, impl: str = "argsort"):
    """Stable sort of small-domain int keys -> ``(ranks, starts)`` (see
    :func:`repro_torch.kernels.ref.group_sort_ref`)."""
    if impl not in SORT_IMPLS:
        raise ValueError(f"unknown sort_impl {impl!r}; "
                         f"expected one of {SORT_IMPLS}")
    if impl == "radix":
        raise NotImplementedError(
            "sort_impl='radix' needs the group_sort kernel, which is not "
            "ported yet; use sort_impl='argsort'")
    return ref.group_sort_ref(keys, num_keys)


def dispatch_gather(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """MoE dispatch: ``out[i] = x[src[i]]``, zeros where ``src[i] < 0``.
    x: (T, d); src: (R,) int32 -> (R, d).  On the card any dtype whose row
    is a multiple of 16 bytes is taken (the kernel copies bytes); ``src``
    must lie in ``[-1, T)``."""
    if _on_cpu(x, src):
        return ref.dispatch_gather_ref(x, src)
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


KERNEL_WRAPPERS = (dispatch_gather, grouped_ffn, combine_gather)
for _w in KERNEL_WRAPPERS:
    _w.launches = 0


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel since the last reset."""
    return {w.__name__: w.launches for w in KERNEL_WRAPPERS}


def reset_launch_counts() -> None:
    for w in KERNEL_WRAPPERS:
        w.launches = 0
