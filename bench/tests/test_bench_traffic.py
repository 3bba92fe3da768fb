"""The generator: deterministic in the seed, the same work for every seed
in another order, lengths inside their clips around their medians."""
import json
from pathlib import Path

import numpy as np
import pytest

from bench.core import traffic as TR

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"


def _mix(name):
    return json.loads((TRAFFIC / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["chat", "offline"])
def test_lengths_keep_clips_and_medians(name):
    mix = _mix(name)
    for key in ("prompt", "output"):
        d = mix[key]
        x = TR.lengths(d, 401)
        assert x.min() >= d["min"] and x.max() <= d["max"]
        assert abs(np.median(x) - d["median"]) <= 1


def test_open_loop_same_schedule_other_tokens():
    mix = _mix("chat")
    phases = {"ramp": 3.0, "window": 20.0, "tail": 5.0}
    a = TR.open_loop(mix, 5.0, 3_000_000_017, 151936, phases)
    b = TR.open_loop(mix, 5.0, 3_000_000_017, 151936, phases)
    c = TR.open_loop(mix, 5.0, 11, 151936, phases)
    assert [r.due for r in a] == [r.due for r in b]
    assert all((x.prompt == y.prompt).all() for x, y in zip(a, b))
    win = [r for r in a if r.phase == "window"]
    win_c = [r for r in c if r.phase == "window"]
    assert len(win) == len(win_c) == 100
    assert [(len(r.prompt), r.max_new, r.due) for r in win] == \
        [(len(r.prompt), r.max_new, r.due) for r in win_c]
    assert any((x.prompt != y.prompt).any() for x, y in zip(win, win_c))
    assert [len(r.prompt) for r in win] != sorted(len(r.prompt) for r in win)
    dues = [r.due for r in win]
    assert dues == sorted(dues) and 3.0 < dues[0] and dues[-1] <= 23.0 + 1e-9
    assert all(8 <= int(r.prompt.min()) and int(r.prompt.max()) < 151936
               for r in win)


def test_closed_queue_blocks_hold_the_same_lengths():
    mix = _mix("offline")
    q = TR.closed_queue(mix, 96, 3, 5, 151936)
    blocks = [sorted(len(r.prompt) for r in q[i * 96:(i + 1) * 96])
              for i in range(3)]
    assert blocks[0] == blocks[1] == blocks[2]


def test_mlm_stream():
    mix = _mix("mlm_b16s128")
    a = TR.mlm_batch(mix, 32128, 0.15, 7, 0)
    b = TR.mlm_batch(mix, 32128, 0.15, 7, 0)
    c = TR.mlm_batch(mix, 32128, 0.15, 7, 1)
    assert a["tokens"].shape == (16, 128)
    assert (a["tokens"] == b["tokens"]).all()
    assert not (a["tokens"] == c["tokens"]).all()
    share = (a["labels"] != TR.IGNORE).mean()
    assert 0.10 < share < 0.20
    rows = {tuple(r) for r in a["tokens"]}
    assert len(rows) == 16
