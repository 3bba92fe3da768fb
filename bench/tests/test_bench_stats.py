"""The serving cells' statistics: a request is timed from when it was
due, and one that never finished counts, as waiting until the run gave
up on it."""
from types import SimpleNamespace

from bench.core import serve_driver as SD


def _drive(counted, due_of, end):
    d = object.__new__(SD.Drive)
    d.counted, d.due_of, d.end, d.t0 = counted, due_of, end, 0.0
    return d


def test_p95_is_nearest_rank():
    assert SD._p95(list(range(1, 101))) == 95
    assert SD._p95([3.0]) == 3.0
    assert SD._p95(list(range(1, 21))) == 19


def test_ttft_from_due_and_failures_count():
    reqs = {}
    for uid in range(1, 21):
        # submitted 0.5 s after it was due, first token 0.1 s later
        reqs[uid] = SimpleNamespace(t_submit=uid + 0.5, t_first=uid + 0.6,
                                    t_tokens=[uid + 0.6, uid + 0.7,
                                              uid + 0.8])
    reqs[21] = SimpleNamespace(t_submit=21.0, t_first=0.0, t_tokens=[])
    eng = SimpleNamespace(requests=reqs, finished=set(range(1, 21)))
    d = _drive(list(range(1, 22)), {u: float(u) for u in range(1, 22)},
               end=121.0)
    st = d.open_stats(eng)
    assert st["attempted"] == 21 and st["failed"] == 1
    # 20 requests at 0.6 s from due, one still waiting 100 s after it
    assert abs(st["ttft_p95_s"] - 0.6) < 1e-9
    d = _drive(list(range(15, 22)), {u: float(u) for u in range(1, 22)},
               end=121.0)
    assert abs(d.open_stats(eng)["ttft_p95_s"] - 100.0) < 1e-9
    assert abs(d.open_stats(eng)["tpot_p95_s"] - 100.0) < 1e-9
