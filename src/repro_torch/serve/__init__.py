"""Serving: the fixed-batch path and the continuous-batching engine.  The
port of ``repro.serve``.

* ``decode.py``: the fixed-batch prefill / decode pair over ring-buffer
  caches (``launch.serve.serve``), and the oracle the paged path is tested
  against.  PyTorch runs eagerly, so the reference's ``build_prefill`` /
  ``build_decode_step`` have no counterpart.
* ``kvcache.py``: the page pools and the host-side :class:`PageAllocator`.
* ``engine.py``: :class:`Engine`, one prefill chunk and one fused decode
  step over all slots a tick, each step a CUDA graph on the card.
* ``batcher.py``: a deprecated shim over the engine.
"""
from repro_torch.serve.decode import decode_step_fn, greedy_sample, prefill_fn
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.kvcache import PageAllocator

__all__ = ["decode_step_fn", "greedy_sample", "prefill_fn", "Engine",
           "Request", "PageAllocator"]
