"""The calibration reads what a run of the cell reads: its program
readings are the checks of a run as ``bench/run.py`` makes it, and its
control reads the same served tokens or the same first steps."""
import json

import torch

from bench import calibrate
from bench.core import serve_driver as SD
from bench.core import spec
from bench.tests._run import run

SEED = 3_000_000_041


def test_training_readings_are_the_runs(monkeypatch, capsys):
    cell = "smile3.7b-train-b16s128"
    r = run(cell, monkeypatch, seed=SEED)
    assert calibrate.main(["--workload", cell, "--seeds", str(SEED),
                           "--control-seeds", str(SEED), "--reduced"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["who"] for x in lines] == ["program", "control:fp8",
                                         "fault:half_batch"]
    for k, c in r["checks"].items():
        assert lines[0][k] == c["value"], k
    limits = spec.load_cell(cell, reduced=True).limits
    assert any(lines[2][k] > v for k, v in limits.items())


def test_serving_readings_read_the_runs_tokens():
    cell = spec.load_cell("qwen3moe-chat", reduced=True)
    prog, ctl = SD.readings(cell, SEED, 2.0, torch.device("cpu"),
                            control=True)
    assert prog["who"] == "program" and ctl["who"] == "control:fp8kv"
    assert prog["served_tokens"] == ctl["served_tokens"] > 0
    assert prog["far_miss"] <= cell.limits["far_miss"]
    assert ctl["logit_gap_mean"] > prog["logit_gap_mean"]
