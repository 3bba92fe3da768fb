"""What the engine's own ranges say of a traced window: the arithmetic of
the ``engine.*`` metrics.

The port's engine (``serve/engine.py``) opens ``record_function`` ranges
each tick: ``engine.step``, ``engine.admit``, ``engine.prefill``,
``engine.decode``, and inside a phase ``engine.fill``, ``engine.replay``,
``engine.readback`` and ``engine.bookkeep``.  They come back in the parsed
trace's ``host_ops`` (name, host start, length), on the clock the profiler
puts the device's operations on.  Each phase ends in a blocking read of
the device's output, so the device work a phase launched lies inside its
host interval: a phase's device time is the device's busy time clipped to
its ranges.  Each metric is per tick, over the ticks traced, the base of
``engine.tick_ms``.  A program without the ranges (``engine.step`` absent)
reads None, as does a trace with no device operations (the CPU) for the
device metrics.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

SCHED = ("engine.admit", "engine.fill", "engine.bookkeep")


def ranges(tr, name: str) -> List[Tuple[float, float]]:
    """The host intervals ``(start, end)`` of the program's range
    ``name``."""
    return [(s, s + d) for n, s, d in tr.host_ops if n == name]


def busy_inside(tr, intervals) -> float:
    """Microseconds the device was busy inside ``intervals``: its
    operations clipped to each, overlaps counted once."""
    tot = 0.0
    for a, b in intervals:
        iv = sorted((max(s, a), min(s + d, b)) for _, s, d in tr.device
                    if s + d > a and s < b)
        end = a
        for s, e in iv:
            s = max(s, end)
            if e > s:
                tot += e - s
                end = e
    return tot


def _ticks(ctx):
    """The trace and the ticks traced, or None where the engine's ranges
    are absent."""
    tr, n = ctx.trace, ctx.run.get("ticks_traced", 0)
    if tr is None or not n or not ranges(tr, "engine.step"):
        return None
    return tr, n


def phase_ms(ctx, name: str) -> Optional[float]:
    """Device-busy ms inside the ``name`` ranges a tick traced (0 where
    the phase ran on no tick of the window)."""
    got = _ticks(ctx)
    if got is None or not got[0].device:
        return None
    tr, n = got
    return busy_inside(tr, ranges(tr, name)) / 1e3 / n


def prefill_ms(ctx) -> Optional[float]:
    return phase_ms(ctx, "engine.prefill")


def decode_ms(ctx) -> Optional[float]:
    return phase_ms(ctx, "engine.decode")


def sched_ms(ctx) -> Optional[float]:
    """Host ms a tick traced in the scheduler's ranges: admission, the
    prefill's input fill and the bookkeeping after each readback."""
    got = _ticks(ctx)
    if got is None:
        return None
    tr, n = got
    return sum(b - a for name in SCHED for a, b in ranges(tr, name)) \
        / 1e3 / n
