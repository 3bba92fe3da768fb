"""PyTorch + CUDA port of the SMILE mixture-of-experts system.

Mirrors the JAX package ``repro`` module by module (same paths, same
function names, same public array layouts) and never imports it or JAX.
The hot kernels of the serving path are hand-written CUDA C++ for Hopper
(``kernels/csrc``), built at first use; see ``kernels/ops.py``.
"""
