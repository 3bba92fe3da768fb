"""The control, at a size a test run holds: the reference put in the
program's place at the next precision below the configured one (fp8
matmul operands) reads far above what the program reads, and above the
limits of the reduced cells."""
import torch

from bench.core import compare as CMP
from bench.core import serve_driver as SD
from bench.core import spec
from bench.core import traffic as TR
from bench.core import train_driver as TD
from bench.reference import train as REF

SEED = 3_000_000_031
CPU = torch.device("cpu")


def test_training_control_fails(monkeypatch):
    cell = spec.load_cell("smile3.7b-train-b16s128", reduced=True)
    doc, mix = cell.config, cell.load
    # two micro-batches a step, as a mix with ``micro_batch_size`` asks
    mix["micro_batch_size"] = mix["batch"] // 2
    n_micro = 2
    prog = TD.run(cell, SEED, 0.0, False, CPU, lambda: 0.0)
    ok = CMP.train_gaps(prog["program"], prog["reference"])
    batches = [{k: torch.as_tensor(v) for k, v in TR.mlm_batch(
        mix, doc["model"]["vocab_size"], doc["train"]["mlm_mask_prob"], SEED,
        i).items()} for i in range(TD.FIRST_STEPS)]
    low = REF.follow(doc, SEED, batches, n_micro, CPU, quant="fp8")
    bad = CMP.train_gaps(low, prog["reference"])
    assert all(v <= cell.limits[k] for k, v in ok.items()), ok
    assert any(v > cell.limits[k] for k, v in bad.items()), bad
    assert bad["grad_gap"] > 3 * ok["grad_gap"]


def test_serving_control_reads_far_above_the_program():
    """The engine's tokens for a fixed set of requests (no clock in the
    way), held to the reference: the control (fp8 matmul operands and KV)
    misses the reference's best token far more often, and its mean gap is
    many times the program's.  (At this size the gaps are too few and
    too small to set a limit between them; the chip runs at the cell's
    size set it, PERF.md.)"""
    cell = spec.load_cell("qwen3moe-chat", reduced=True)
    doc, mix = cell.config, cell.load
    tree, drawn, eng = SD.prepare(cell, SEED, CPU)
    uids = [eng.submit(r.prompt, max_new_tokens=r.max_new) for r in
            SD.make_queue(mix, SEED, 2.0, doc["model"]["vocab_size"])[:8]]
    eng.run()
    served = SD.served_of(eng.requests, uids)
    ok = SD.logit_gaps(tree, doc, served, CPU)
    bad = SD.logit_gaps(tree, doc, served, CPU, quant="fp8kv")
    assert ok["far_miss"] <= cell.limits["far_miss"]
    assert bad["logit_gap_mean"] > 5 * ok["logit_gap_mean"], (ok, bad)
    assert bad["top1_miss"] > 2 * ok["top1_miss"], (ok, bad)
