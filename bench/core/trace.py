"""A profiler window over a steady part of the measured window, and what the
benchmark reads from its trace.

The window is ``torch.profiler`` with CPU and CUDA activity, exported as a
Chrome trace into a temporary directory (``TMPDIR``) and read back.  From
it: every device operation (kernels, copies, sets) with its start and
length, the program's ``record_function`` ranges (``train_step.*``) as
spans on the device, and the benchmark's own spans (``bench.*``, one
around each call into the program), which bound the traced window.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
BENCH_SPAN = "bench."


@dataclass
class Trace:
    """Times in microseconds on the trace's clock."""
    device: List[Tuple[str, float, float]]          # (name, start, dur)
    device_spans: Dict[str, List[Tuple[float, float]]]
    bench_spans: List[Tuple[str, float, float]]
    host_ops: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def window(self) -> Tuple[float, float]:
        """From the first of the benchmark's spans to the end of the last,
        or of the last device operation where that ends later."""
        s0 = min(s for _, s, _ in self.bench_spans)
        e0 = max(s + d for _, s, d in self.bench_spans)
        ends = [s + d for _, s, d in self.device if s < e0]
        return s0, max([e0] + ends)

    @property
    def window_s(self) -> float:
        a, b = self.window
        return (b - a) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        a, b = self.window
        iv = sorted((max(s, a), min(s + d, b)) for _, s, d in self.device
                    if s + d > a and s < b)
        out: List[Tuple[float, float]] = []
        for s, e in iv:
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def device_time(self, match) -> float:
        """Seconds of the device operations whose name ``match`` accepts."""
        return sum(d for n, _, d in self.device if match(n)) / 1e6

    def count(self, match) -> int:
        return sum(1 for n, _, _ in self.device if match(n))

    def top_ops(self, k: int = 10) -> List[List]:
        tot: Dict[str, float] = {}
        for n, _, d in self.device:
            tot[n] = tot.get(n, 0.0) + d / 1e6
        return [[n, s] for n, s in sorted(tot.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The longest stretches with nothing on the device, each named by
        the innermost host span (the program's operator, or the
        benchmark's own span) open at its middle."""
        a, b = self.window
        busy = self.busy_intervals()
        gaps, t = [], a
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if b > t:
            gaps.append((t, b))
        gaps.sort(key=lambda g: -(g[1] - g[0]))
        out = []
        for s, e in gaps[:k]:
            mid = 0.5 * (s + e)
            inner = [(d, n) for n, hs, d in self.host_ops
                     if hs <= mid <= hs + d]
            name = min(inner)[1] if inner else "host"
            out.append([name, (e - s) / 1e6])
        return out


def _start(torch):
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


class Window:
    """``with Window(torch) as w: ...`` profiles the block; afterwards
    :meth:`collect` exports and parses the trace (slow, so a driver calls
    it once its load has stopped)."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None

    def __enter__(self):
        self.prof = _start(self.torch)
        return self

    def __exit__(self, *exc):
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        return False

    def collect(self) -> Trace:
        d = tempfile.mkdtemp(prefix="bench-trace-")
        try:
            path = os.path.join(d, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                return parse(json.load(f))
        finally:
            shutil.rmtree(d, ignore_errors=True)


def parse(doc) -> Trace:
    """The parts of a Chrome trace that the metrics read."""
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    device, gpu_ann, cpu_ann, bench, host = [], {}, {}, [], []
    launch_ts: Dict[int, float] = {}
    kernels_by_corr: Dict[int, Tuple[float, float]] = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append((name, ts, dur))
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                kernels_by_corr[corr] = (ts, dur)
        elif cat == "gpu_user_annotation":
            gpu_ann.setdefault(name, []).append((ts, dur))
        elif cat == "user_annotation":
            if name.startswith(BENCH_SPAN):
                bench.append((name, ts, dur))
            else:
                cpu_ann.setdefault(name, []).append((ts, dur))
            host.append((name, ts, dur))
        elif cat == "cuda_runtime":
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = ts
        elif cat == "cpu_op":
            host.append((name, ts, dur))
    spans = dict(gpu_ann)
    # where the trace holds no device-side ranges, a range's device span is
    # from the first to the last end of the operations launched inside it
    for name, ranges in cpu_ann.items():
        if name in spans:
            continue
        out = []
        for s, d in ranges:
            hit = [kernels_by_corr[c] for c, t in launch_ts.items()
                   if s <= t <= s + d and c in kernels_by_corr]
            if hit:
                a = min(k[0] for k in hit)
                b = max(k[0] + k[1] for k in hit)
                out.append((a, b - a))
        if out:
            spans[name] = out
    return Trace(device, spans, bench, host)
