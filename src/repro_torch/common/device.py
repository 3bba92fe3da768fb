"""Where the port runs: the card unless the caller asks for the CPU.

A rank of a mesh names its device explicitly (``devices[rank]``; ranks
that share one card name it several times) and makes it current with
:func:`use_device` before its first launch: the kernels launch on the
current device's stream (``kernels/ops.py``) and size their shared memory
once a process.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``.  Asking for CUDA on a machine
    without a usable card raises instead of falling back to the CPU.
    ``"meta"`` (tensors with shapes and dtypes and no storage: the dry
    run's, :mod:`repro_torch.launch.inputs`) is taken only when it is
    asked for by name; no entry point falls back to it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was asked for but no CUDA device is "
            f"available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}: expected cuda, cpu "
                         f"or meta")
    return dev


def use_device(device) -> torch.device:
    """:func:`resolve_device`, and for a card (given as ``cuda:N``) make
    it this process's current device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            raise ValueError(f"name the card as cuda:N, got {str(device)!r}")
        torch.cuda.set_device(dev)
    return dev
