"""The training cell end to end on the CPU at the reduced sizes, with and
without the trace: the result line's keys, and the port against the
reference."""
import json

import pytest

from bench.tests._run import run


@pytest.mark.parametrize("cell,trace", [("smile3.7b-train-b16s128", False),
                                        ("smile3.7b-train-b16s128", True)])
def test_training_cell(cell, trace, monkeypatch):
    r = run(cell, monkeypatch, trace=trace)
    json.dumps(r)
    assert list(r)[-1] == "checks"
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"loss_gap", "grad_gap", "grad_median_gap",
                                "change_gap"}
    assert r["attempted"] >= 1 and r["failed"] == 0
    if trace:
        assert "mfu.train" in r["metrics"] and "busy_s" in r["device"]
    else:
        assert set(r["metrics"]) == {"train_tokens_per_s", "setup_s"}
