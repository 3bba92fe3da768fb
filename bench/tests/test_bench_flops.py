"""The yardstick's counts against hand-worked values."""
import json
from pathlib import Path

import pytest

from bench.core import flops as FL
from bench.reference.routers import smile as SMILE

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _doc(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_smile_training_step():
    doc = _doc("smile-3.7b")
    # a dense block: attention 4 d^2 = 2,359,296 and FFN 2 d f = 4,718,592
    # multiply-adds, 7,077,888; a MoE block: the routers 768 x 24 more,
    # 7,096,320.  2 x 6 x (dense + moe) + 4 x 128 keys x 768 x 12
    # + 2 x 32,128 x 768
    assert FL.token_flops(doc, 128, head=True) == \
        2 * 6 * (7_077_888 + 7_096_320) + 4 * 128 * 768 * 12 \
        + 2 * 32_128 * 768 == 224_157_696
    assert FL.train_step_flops(doc, 16, 128) == 3 * 2048 * 224_157_696


def test_qwen3_tokens():
    doc = _doc("qwen3-moe-30b-a3b")
    # a block's multiply-adds, 56,672,256: q, o 2 x 2048 x 4096; k, v
    # 2 x 2048 x 512; routers 2048 x 24; 8 experts x 3 x 2048 x 768
    assert 2 * 2048 * 4096 + 2 * 2048 * 512 + 2048 * 24 \
        + 8 * 3 * 2048 * 768 == 56_672_256
    head = 2 * 151_936 * 2048
    assert FL.decode_flops(doc, 0) == 2 * 48 * 56_672_256 + 4 * 4096 * 48 \
        + head
    two = FL.prefill_flops(doc, 0, 2, last=True)
    assert two == (2 * 2 * 48 * 56_672_256 + 4 * (1 + 2) * 4096 * 48 + head)


def test_routing_bounds():
    # the fused router at (2048, 768) x (768, 16), k 1, x bf16: bound by
    # bytes, 3,481,668 of them
    b = FL.router_fused_bound(2048, 768, 16, 1, 2)
    assert b == pytest.approx(3_481_668 / 3.35e12)
    assert FL.group_sort_bound(2048, 17) == pytest.approx(16_456 / 3.35e12)
    doc = _doc("smile-3.7b")
    per = SMILE.routing_bounds(doc, 2048)
    assert per["hops"] == 2
    # hop 2 runs over the node buffer: 16 nodes x 256 slots
    assert per["router"] == pytest.approx(
        b + FL.router_fused_bound(4096, 768, 8, 1, 2))
    assert per["sort"] == pytest.approx(
        FL.group_sort_bound(2048, 17) + FL.group_sort_bound(4096, 129))
