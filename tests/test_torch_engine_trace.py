"""The engine's tracing on the CPU: its ``record_function`` ranges a tick,
the request-stage stamps and the queue counters of ``Engine.metrics()``.

One hand-worked schedule drives the checks.  An engine of 2 slots, pages
of 4 and prefill buckets 4 and 8 (chunks of at most 8 tokens) gets four
requests before its first tick, as (prompt tokens, new tokens):
r1 (20, 3), r2 (10, 2), r3 (5, 2), r4 (12, 4), so 3, 2, 1 and 2 chunks.

====  =======  =======  ==========================  ===============
tick  waiting  backlog  prefill chunk               decode
====  =======  =======  ==========================  ===============
1     4        0        r1 1/3 (r1, r2 admitted)    -
2     2        4        r1 2/3                      -
3     2        3        r1 3/3, live                r1 (2 of 3)
4     2        2        r2 1/2                      r1 done
5     2        1        r2 2/2, live (r3 admitted)  r2 done
6     1        1        r3 1/1, live (r4 admitted)  r3 done
7     0        2        r4 1/2                      -
8     0        1        r4 2/2, live                r4 (2 of 4)
9     0        0        -                           r4 (3 of 4)
10    0        0        -                           r4 done
====  =======  =======  ==========================  ===============

``waiting`` and ``backlog`` (prompt chunks queued for prefill, the head
prompt's remaining ones included) are counted at each tick's start.
"""
import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_reduced
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Engine
from repro_torch.sharding.plan import single_device_plan as plan

KW = dict(cache_len=32, page_size=4, n_slots=2, prefill_buckets="4,8")
REQUESTS = [(20, 3), (10, 2), (5, 2), (12, 4)]
TICKS = 10
WAITING = [4, 2, 2, 2, 2, 1, 0, 0, 0, 0]
BACKLOG = [0, 4, 3, 2, 1, 1, 2, 1, 0, 0]
PREFILL_TICKS = {1, 2, 3, 4, 5, 6, 7, 8}
DECODE_TICKS = {3, 4, 5, 6, 8, 9, 10}


@pytest.fixture(scope="module")
def model():
    cfg = get_reduced("qwen1.5-0.5b")
    return cfg, T.init_model(cfg, plan(), seed=0, device="cpu")


def _engine(model):
    cfg, params = model
    eng = Engine(params, cfg, plan(), **KW)
    rng = np.random.default_rng(5)
    for n, new in REQUESTS:
        eng.submit(rng.integers(8, 500, n).astype(np.int32), new)
    return eng


def _traced(model):
    """The schedule run under the profiler: the engine and its ranges,
    ``{name: [(start, end), ...]}`` in start order."""
    eng = _engine(model)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.run()
    spans = {}
    for e in prof.events():
        if e.name.startswith("engine."):
            spans.setdefault(e.name, []).append((e.time_range.start,
                                                 e.time_range.end))
    return eng, {k: sorted(v) for k, v in spans.items()}


def _within(span, outer):
    return outer[0] <= span[0] and span[1] <= outer[1]


def test_each_tick_opens_its_ranges(model):
    eng, spans = _traced(model)
    assert eng.ticks == TICKS
    ticks = spans["engine.step"]
    assert len(ticks) == TICKS
    assert len(spans["engine.admit"]) == TICKS

    def ticks_of(name):
        got = []
        for s in spans[name]:
            where = [i + 1 for i, t in enumerate(ticks) if _within(s, t)]
            assert len(where) == 1, name
            got += where
        return got
    pre, dec = ticks_of("engine.prefill"), ticks_of("engine.decode")
    assert sorted(pre) == sorted(PREFILL_TICKS)      # one chunk a tick
    assert sorted(dec) == sorted(DECODE_TICKS)
    phases = spans["engine.prefill"] + spans["engine.decode"]
    for name in ("engine.replay", "engine.readback", "engine.bookkeep"):
        assert len(spans[name]) == len(phases), name
    for phase in phases:        # the copy and replay, the read, the Python
        rep, back, book = ([s for s in spans[name] if _within(s, phase)]
                           for name in ("engine.replay", "engine.readback",
                                        "engine.bookkeep"))
        assert len(rep) == len(back) == len(book) == 1
        assert rep[0][1] <= back[0][0] and back[0][1] <= book[0][0]
    assert len(spans["engine.fill"]) == len(PREFILL_TICKS)
    for s in spans["engine.fill"]:
        assert sum(_within(s, p) for p in spans["engine.prefill"]) == 1


def test_stamps_split_the_time_to_first_token(model):
    eng = _engine(model)
    eng.run()
    for r in eng.requests.values():
        assert r.t_submit <= r.t_admit <= r.t_prefill <= r.t_first
        stages = ((r.t_admit - r.t_submit) + (r.t_prefill - r.t_admit)
                  + (r.t_first - r.t_prefill))
        assert stages == pytest.approx(r.t_first - r.t_submit, abs=1e-9)
    m = eng.metrics()
    reqs = list(eng.requests.values())
    qw = [r.t_admit - r.t_submit for r in reqs]
    pw = [r.t_prefill - r.t_admit for r in reqs]
    assert m["queue_wait_s_mean"] == pytest.approx(np.mean(qw), abs=1e-12)
    assert m["queue_wait_s_max"] == max(qw)
    assert m["prefill_wait_s_mean"] == pytest.approx(np.mean(pw), abs=1e-12)
    assert m["prefill_wait_s_max"] == max(pw)


def test_queue_counters_follow_the_schedule(model):
    eng = _engine(model)
    eng.run()
    m = eng.metrics()
    assert m["ticks"] == TICKS and m["completed"] == len(REQUESTS)
    assert m["waiting_max"] == max(WAITING)
    assert m["waiting_mean"] == pytest.approx(np.mean(WAITING))
    assert m["prefill_backlog_max"] == max(BACKLOG)
    assert m["prefill_backlog_mean"] == pytest.approx(np.mean(BACKLOG))
    assert eng._backlog == 0


def test_counters_before_any_tick(model):
    m = _engine(model).metrics()
    for k in ("waiting", "prefill_backlog", "queue_wait_s",
              "prefill_wait_s"):
        assert m[f"{k}_mean"] == 0.0 and m[f"{k}_max"] == 0.0


def test_the_profiler_changes_no_token_or_tick(model):
    plain = _engine(model)
    out = plain.run()
    traced, _ = _traced(model)
    assert dict(traced.finished) == out
    assert traced.ticks == plain.ticks == TICKS
    assert traced.compile_counts() == plain.compile_counts()
    keep = ("ticks", "completed", "page_occupancy_mean",
            "page_occupancy_max", "waiting_mean", "waiting_max",
            "prefill_backlog_mean", "prefill_backlog_max")
    a, b = plain.metrics(), traced.metrics()
    assert {k: a[k] for k in keep} == {k: b[k] for k in keep}


def test_run_engine_returns_the_waits(capsys):
    from repro_torch.launch import serve as S
    res = S.serve_engine("qwen1.5-0.5b", requests=5, prompt_len=12,
                         new_tokens=4, device="cpu",
                         serve_opts={"n_slots": 2, "page_size": 4})
    assert set(res.queue_wait_s) == set(res.prefill_wait_s) \
        == set(res.ttft_s)
    for uid, ttft in res.ttft_s.items():
        assert 0.0 <= res.queue_wait_s[uid] + res.prefill_wait_s[uid] \
            <= ttft
    assert res.metrics["queue_wait_s_max"] == max(res.queue_wait_s.values())
    S.print_engine_summary(S.engine_summary(res))
    assert "admission wait mean" in capsys.readouterr().out

