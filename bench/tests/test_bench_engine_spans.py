"""The ``engine.*`` phase metrics (``bench/core/engine_spans.py``) on a
synthetic Chrome trace read by ``trace.parse``, and in the chat cell's
traced CPU rehearsal."""
import pytest

from bench.core import engine_spans as ES
from bench.core import plugins
from bench.core.trace import parse
from bench.tests._run import run

# two ticks (times in microseconds): the first runs a prefill chunk and a
# decode step, the second a decode step only
RANGES = [
    ("bench.engine_step", 0, 1000), ("engine.step", 10, 990),
    ("engine.admit", 20, 30), ("engine.prefill", 40, 500),
    ("engine.fill", 45, 60), ("engine.replay", 60, 80),
    ("engine.readback", 80, 480), ("engine.bookkeep", 480, 495),
    ("engine.decode", 500, 980), ("engine.replay", 505, 520),
    ("engine.readback", 520, 950), ("engine.bookkeep", 950, 975),
    ("bench.engine_step", 1000, 1500), ("engine.step", 1005, 1495),
    ("engine.admit", 1010, 1015), ("engine.decode", 1020, 1490),
    ("engine.replay", 1020, 1030), ("engine.readback", 1030, 1480),
    ("engine.bookkeep", 1480, 1488)]
DEVICE = [
    ("gpu_memcpy", "Memcpy HtoD", 70, 75),        # prefill: 5
    ("kernel", "gemm", 100, 300),                 # prefill: 100-400, 300
    ("kernel", "gather", 250, 400),               # (overlaps the one above)
    ("kernel", "straddle", 490, 510),             # 10 prefill, 10 decode
    ("kernel", "attn", 600, 900),                 # decode: 300
    ("kernel", "attn", 1100, 1400),               # decode: 300
    ("kernel", "late", 1492, 1600)]               # in no phase
PREFILL_US, DECODE_US = 315.0, 610.0
SCHED_US = (10 + 5) + 15 + (15 + 25 + 8)          # admit, fill, bookkeep


def _doc(ranges=RANGES, device=DEVICE):
    ev = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a,
           "dur": b - a} for n, a, b in ranges]
    ev += [{"ph": "X", "cat": c, "name": n, "ts": a, "dur": b - a}
           for c, n, a, b in device]
    return {"traceEvents": ev}


class _Ctx:
    def __init__(self, trace, ticks):
        self.trace, self.run = trace, {"ticks_traced": ticks}


@pytest.mark.parametrize("ticks", [1, 2])
def test_phases_clip_the_device_to_their_ranges(ticks):
    ctx = _Ctx(parse(_doc()), ticks)
    assert ES.prefill_ms(ctx) == pytest.approx(PREFILL_US / 1e3 / ticks)
    assert ES.decode_ms(ctx) == pytest.approx(DECODE_US / 1e3 / ticks)
    assert ES.sched_ms(ctx) == pytest.approx(SCHED_US / 1e3 / ticks)


def test_busy_inside_counts_overlaps_once():
    tr = parse(_doc())
    assert ES.busy_inside(tr, [(0, 2000)]) == pytest.approx(
        5 + 300 + 20 + 300 + 300 + 108)
    assert ES.busy_inside(tr, [(150, 160), (390, 395)]) == 15
    assert ES.busy_inside(tr, []) == 0.0


@pytest.mark.parametrize("name,value", [
    ("engine.prefill_ms.chat", PREFILL_US / 2e3),
    ("engine.decode_ms.chat", DECODE_US / 2e3),
    ("engine.sched_ms.chat", SCHED_US / 2e3),
    ("engine.decode_ms.offline", DECODE_US / 2e3),
    ("engine.sched_ms.offline", SCHED_US / 2e3)])
def test_metric_files_read_the_phases(name, value):
    ctx = _Ctx(parse(_doc()), 2)
    assert plugins.load("metrics", name).read(ctx) == pytest.approx(value)


def test_a_phase_absent_from_the_window_reads_zero():
    no_prefill = [r for r in RANGES if r[0] not in ("engine.prefill",
                                                     "engine.fill")]
    ctx = _Ctx(parse(_doc(ranges=no_prefill)), 2)
    assert ES.prefill_ms(ctx) == 0.0
    assert ES.decode_ms(ctx) == pytest.approx(DECODE_US / 2e3)


@pytest.mark.parametrize("reader", [ES.prefill_ms, ES.decode_ms,
                                    ES.sched_ms])
def test_none_without_the_engines_ranges(reader):
    bench_only = [r for r in RANGES if r[0].startswith("bench.")]
    assert reader(_Ctx(parse(_doc(ranges=bench_only)), 2)) is None
    assert reader(_Ctx(None, 2)) is None
    assert reader(_Ctx(parse(_doc()), 0)) is None


def test_no_device_operations_leave_only_the_host_metric():
    ctx = _Ctx(parse(_doc(device=[])), 2)
    assert ES.prefill_ms(ctx) is None and ES.decode_ms(ctx) is None
    assert ES.sched_ms(ctx) == pytest.approx(SCHED_US / 2e3)


def test_chat_rehearsal_reports_the_schedulers_time(monkeypatch):
    r = run("qwen3moe-chat", monkeypatch, trace=True, seconds=2.0)
    assert r["correct"], r["checks"]
    m = r["metrics"]
    assert m["engine.sched_ms.chat"]["value"] > 0
    assert m["engine.sched_ms.chat"]["unit"] == "ms"
    assert "engine.tick_ms.chat" in m
    # the CPU has no device operations to clip
    assert "engine.prefill_ms.chat" not in m
    assert "engine.decode_ms.chat" not in m
    names = {n for n, _ in r["breakdown"]["idle_gaps"]}
    assert names and "bench.engine_step" not in names
