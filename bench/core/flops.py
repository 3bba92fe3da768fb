"""The yardstick's arithmetic: the chip's peaks, the model FLOPs of the
work a window did, and the least time a routing kernel could take (each
router's ``routing_bounds`` adds these up over its layer).

Peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity):
989 TFLOP/s in bf16, 67 TFLOP/s in fp32 outside the tensor cores, 3.35
TB/s of HBM.  Model FLOPs count two per multiply-add of the matmuls a
token needs (its top-k experts only, no recomputation, no padding) plus
attention's ``QK^T`` and ``PV`` over the keys the token attends to;
training counts three times the forward (forward and backward).
"""
from __future__ import annotations

from typing import Dict

from bench.core import plugins

PEAKS = {"bf16_flops": 989e12, "fp32_flops": 67e12, "hbm_bytes": 3.35e12}


def token_flops(doc: Dict, keys: float, head: bool) -> float:
    """Forward FLOPs of one token that attends to ``keys`` keys, with the
    LM head where its logits are used: the configuration's family counts
    them (``bench/reference/<family>.py``)."""
    return plugins.family(doc).token_flops(doc, keys, head)


def train_step_flops(doc: Dict, batch: int, seq: int) -> float:
    """One training step: three forwards' worth for every token, the LM
    head over every position, bidirectional attention over the sequence
    (causal: half of it on average)."""
    keys = seq if not doc["model"].get("causal", True) else (seq + 1) / 2
    return 3.0 * batch * seq * token_flops(doc, keys, head=True)


def prefill_flops(doc: Dict, start: int, length: int, last: bool) -> float:
    """A prefill chunk of ``length`` tokens from position ``start``; the
    head's logits are used for the prompt's last token only."""
    tot = 0.0
    for p in range(start, start + length):
        tot += token_flops(doc, p + 1, head=False)
    if last:
        m = doc["model"]
        tot += 2.0 * m["vocab_size"] * m["d_model"]
    return tot


def decode_flops(doc: Dict, position: int) -> float:
    """One decoded token whose input sits at ``position``."""
    return token_flops(doc, position + 1, head=True)


# -----------------------------------------------------------------------------
# Roofline bounds (seconds), each input byte read once and each output
# byte written once
# -----------------------------------------------------------------------------

def router_fused_bound(t: int, d: int, E: int, k: int, x_bytes: int) -> float:
    """The fused router: x (t, d) @ w (d, E) fp32, softmax and top-k;
    writes gates and ids (t, k), probabilities and logits (t, E) fp32,
    ranks (t * k) and starts (E + 1) int32."""
    flops = 2.0 * t * d * E
    nbytes = (t * d * x_bytes + d * E * 4 + t * k * 8 + 2 * t * E * 4
              + t * k * 4 + (E + 1) * 4)
    return max(flops / PEAKS["fp32_flops"], nbytes / PEAKS["hbm_bytes"])


def group_sort_bound(A: int, K: int) -> float:
    """The counting sort: reads A int32 keys, writes A ranks and K + 1
    starts."""
    return (8.0 * A + 4.0 * (K + 1)) / PEAKS["hbm_bytes"]
