"""Both serving cells end to end on the CPU at the reduced sizes."""
import json

import pytest

from bench.tests._run import run


@pytest.mark.parametrize("cell,trace,e2e", [
    ("qwen3moe-chat", False, {"ttft_p95_ms", "tpot_p95_ms", "setup_s"}),
    ("qwen3moe-offline", True, None)])
def test_serving_cell(cell, trace, e2e, monkeypatch):
    r = run(cell, monkeypatch, trace=trace, seconds=2.0)
    json.dumps(r)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1
    if e2e:
        assert set(r["metrics"]) == e2e
    else:
        assert "engine.tick_ms.offline" in r["metrics"]
        assert len(r["breakdown"]["idle_gaps"]) >= 1
