"""The arithmetic the per-layer metrics share, each over one traced
window (:class:`bench.core.trace.Trace`).  A reader that finds nothing to
read returns None, and the metric is left out of the line."""
from __future__ import annotations

from typing import Optional

from bench.core import flops as FL
from bench.core import plugins

ROUTER = ("router_kernel",)
SORT = ("one_launch_kernel", "hist_kernel", "scan_kernel", "rank_kernel")
SORT_CALLS = ("one_launch_kernel", "rank_kernel")
EXPERT_FFN = ("grouped_gemm",)


def named(*parts):
    return lambda n: any(p in n for p in parts)


def idle_share(ctx) -> Optional[float]:
    tr = ctx.trace
    if tr is None or not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def span_ms(ctx, name: str) -> Optional[float]:
    """A program range's device span, averaged over its occurrences."""
    tr = ctx.trace
    spans = tr.device_spans.get(name) if tr is not None else None
    if not spans:
        return None
    return sum(d for _, d in spans) / len(spans) / 1e3


def mfu(ctx, flops: float) -> Optional[float]:
    tr = ctx.trace
    if tr is None or flops <= 0 or tr.window_s <= 0:
        return None
    return 100.0 * flops / tr.window_s / FL.PEAKS["bf16_flops"]


def train_mfu(ctx) -> Optional[float]:
    r = ctx.run
    if not r.get("traced_steps"):
        return None
    return mfu(ctx, r["traced_steps"] * FL.train_step_flops(
        ctx.doc, r["batch"], r["seq"]))


def serve_mfu(ctx) -> Optional[float]:
    return mfu(ctx, ctx.run.get("traced_flops", 0.0))


def tick_ms(ctx) -> Optional[float]:
    tr, n = ctx.trace, ctx.run.get("ticks_traced", 0)
    if tr is None or not n:
        return None
    return 1e3 * tr.window_s / n


def share_of_busy(ctx, match) -> Optional[float]:
    tr = ctx.trace
    if tr is None or tr.busy_s <= 0:
        return None
    t = tr.device_time(match)
    return 100.0 * t / tr.busy_s if t > 0 else None


def routing_roofline(ctx) -> Optional[float]:
    """The router and sort kernels' least time over their device time:
    each call's bound from its shapes (the configuration's router sums a
    layer's calls at a micro-batch's tokens, ``bench/reference/routers``),
    as many calls as the trace holds."""
    tr, r = ctx.trace, ctx.run
    if tr is None:
        return None
    t = tr.device_time(named(*ROUTER)) + tr.device_time(named(*SORT))
    if t <= 0:
        return None
    tokens = r["batch"] // r["n_micro"] * r["seq"]
    b = plugins.router(ctx.doc).routing_bounds(ctx.doc, tokens)
    bound = (tr.count(named(*ROUTER)) / b["hops"] * b["router"]
             + tr.count(named(*SORT_CALLS)) / b["hops"] * b["sort"])
    return 100.0 * bound / t
