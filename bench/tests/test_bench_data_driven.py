"""A later change adds a configuration, a traffic mix, a cell and a
per-layer metric by adding files (and their entries in BENCHMARK.json)
and editing none, also where the configuration routes otherwise or the
mix arrives otherwise; and without the program beside it the benchmark
fails."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

from bench.tests._run import run

ROOT = Path(__file__).resolve().parents[2]


BURSTS = """
import numpy as np


def gaps(mix, rate, n):
    # bursts of ``burst`` requests 10 ms apart, spaced to keep the rate
    b = mix["burst"]
    g = np.full(n, 0.01)
    g[::b] = b / rate - 0.01 * (b - 1)
    return g
"""


def _add(doc, section, entry):
    doc[section].append(entry)


def test_new_files_make_a_new_cell(tmp_path, monkeypatch):
    """A configuration with another routing (Switch's flat top-1 over all
    128 experts, one hop) under a new family file, a new mix with a new
    arrival process, two cells and a metric: files only."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = tmp_path / "bench"
    shutil.copy(b / "reference" / "transformer.py",
                b / "reference" / "encoder.py")
    cfg = json.loads((b / "configs" / "smile-3.7b.json").read_text())
    cfg.update(name="switch-3.7b", family="encoder")
    cfg["moe"].update(router="switch", lb_alpha=0.01)
    (b / "configs" / "switch-3.7b.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic" / "mlm_b16s128.json").read_text())
    mix["batch"] = 8
    (b / "traffic" / "mlm_b8s128.json").write_text(json.dumps(mix))
    (b / "workloads" / "switch-train.json").write_text(json.dumps(
        {"limits": {"loss_gap": 0.01, "grad_gap": 0.1, "change_gap": 0.1}}))
    (b / "metrics" / "steps_traced.py").write_text(
        "def read(ctx):\n    return float(ctx.run['traced_steps'])\n")
    (b / "traffic" / "bursts.py").write_text(BURSTS)
    chat = json.loads((b / "traffic" / "chat.json").read_text())
    chat.update(arrivals="bursts", burst=4)
    (b / "traffic" / "chat_bursts.json").write_text(json.dumps(chat))
    shutil.copy(b / "workloads" / "qwen3moe-chat.json",
                b / "workloads" / "qwen3moe-bursts.json")
    _add(doc, "configs", {"name": "switch-3.7b", "source": "a test",
                          "file": "bench/configs/switch-3.7b.json",
                          "reduced": [], "why": "a test"})
    _add(doc, "workloads", {"name": "switch-train", "config": "switch-3.7b",
                            "traffic": "mlm_b8s128", "chips": 1,
                            "why": "a test"})
    _add(doc, "workloads", {"name": "qwen3moe-bursts",
                            "config": "qwen3-moe-30b-a3b",
                            "traffic": "chat_bursts", "chips": 1,
                            "why": "a test"})
    _add(doc, "per_layer", {"name": "steps_traced", "unit": "steps",
                            "better": "higher", "source": "host_clock",
                            "layer": "test", "moves": "train_tokens_per_s",
                            "workloads": ["switch-train"]})
    for m in doc["end_to_end"]:
        if m["name"] == "train_tokens_per_s":
            m["workloads"].append("switch-train")
        if m["name"] in ("ttft_p95_ms", "tpot_p95_ms"):
            m["workloads"].append("qwen3moe-bursts")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    before = {p: p.read_bytes() for p in (ROOT / "bench").rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    r = run("switch-train", monkeypatch, trace=True, root=tmp_path)
    assert r["correct"], r["checks"]
    assert r["metrics"]["steps_traced"]["value"] >= 1
    assert "routing_roofline" not in r["metrics"]    # not listed there
    s = run("qwen3moe-bursts", monkeypatch, seconds=2.0, root=tmp_path)
    assert s["correct"], s["checks"]
    assert set(s["metrics"]) == {"ttft_p95_ms", "tpot_p95_ms", "setup_s"}
    assert all(p.read_bytes() == v for p, v in before.items())
    from bench.core import plugins
    plugins.use_root(tmp_path)
    leaves = plugins.load("reference", "encoder").leaves(cfg)
    assert any(lf.path[-2:] == ("router", "w") for lf in leaves)
    assert not any("router_inter" in lf.path for lf in leaves)


def test_fails_without_the_program(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        "smile3.7b-train-b16s128", "--seed", "1",
                        "--seconds", "1", "--reduced"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert p.returncode != 0
    assert not p.stdout.strip().startswith("{")
