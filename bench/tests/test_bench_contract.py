"""BENCHMARK.json against the rules every later check holds it to: its
keys, names, units, files and the reach of each metric."""
import json
import math
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
DOC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|proj|_dim$|_rank$|"
                    r"head|expansion|d_model|d_ff|experts_per_tok|top_k)")


def test_top_level_keys():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert DOC["command"] == ["python3", "bench/run.py"]
    assert DOC["paths"] == ["bench"]
    for p in DOC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert len(json.dumps(DOC)) <= 64 * 1024


def test_run_seconds_fits_24_cells():
    rs = DOC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in DOC[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names


def test_configs():
    used = {w["config"] for w in DOC["workloads"]}
    for c in DOC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).exists()
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        assert not [k for k in c["reduced"] if WIDTHS.search(k)]
        for text in (c["source"], c["why"]):
            assert 1 <= len(text) <= 200 and "\n" not in text


def test_workloads():
    configs = {c["name"] for c in DOC["configs"]}
    pairs = set()
    four = 0
    for w in DOC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        four += w["chips"] == 4
        assert NAME.match(w["traffic"])
        assert (ROOT / "bench" / "traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "bench" / "workloads" / f"{w['name']}.json").exists()
        assert 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert four <= max(1, len(DOC["workloads"]) // 4)


def test_metrics():
    for m in DOC["end_to_end"]:
        keys = {"name", "unit", "better", "bound", "source"}
        assert set(m) - {"workloads"} == keys
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25
               for m in DOC["end_to_end"])
    e2e = {m["name"]: m for m in DOC["end_to_end"]}
    for m in DOC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e
        assert 1 <= len(m["layer"]) <= 200
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").exists()
        reach = e2e[m["moves"]].get("workloads")
        for w in m.get("workloads", []):
            assert reach is None or w in reach
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in DOC["workloads"]])
def test_every_cell_reports_enough(cell):
    from bench.core import spec
    c = spec.load_cell(cell)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    assert c.limits and all(math.isfinite(v) and v > 0
                            for v in c.limits.values())
