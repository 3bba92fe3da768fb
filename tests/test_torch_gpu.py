"""The CUDA kernels against their plain versions, and the serving path
launching them, on a card.  Every test here carries the ``gpu`` marker and
skips itself when no card is present.  This file imports neither JAX nor
the JAX package, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from repro_torch.kernels import ops, ref

# fp32 accumulation in another order; h and y are rounded to bf16 once each,
# so an element can sit one bf16 ulp (2**-8 relative) apart, then propagate
# through the second product: a few ulps of a unit-scale output
FFN_TOL = dict(rtol=2e-2, atol=2e-2)


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("T,R,d", [(5, 37, 64), (1024, 8192, 2048)])
def test_dispatch_gather_kernel(T, R, d):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((T, d), generator=g, device=dev).to(torch.bfloat16)
    src = torch.randint(-1, T, (R,), generator=g, device=dev,
                        dtype=torch.int32)
    n = ops.dispatch_gather.launches
    got = ops.dispatch_gather(x, src)
    assert ops.dispatch_gather.launches == n + 1
    assert torch.equal(got, ref.dispatch_gather_ref(x, src))     # a copy


@pytest.mark.gpu
@pytest.mark.parametrize("t,k,R,d", [(3, 4, 10, 64), (1024, 4, 8192, 2048)])
def test_combine_gather_kernel(t, k, R, d):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    rows = torch.randn((R, d), generator=g, device=dev).to(torch.bfloat16)
    src = torch.randint(-1, R, (t, k), generator=g, device=dev,
                        dtype=torch.int32)
    scale = torch.rand((t, k), generator=g, device=dev)
    # the same rounded fp32 multiply, then add, per term, in the same order
    assert torch.equal(ops.combine_gather(rows, src, scale),
                       ref.combine_gather_ref(rows, src, scale))


@pytest.mark.gpu
@pytest.mark.parametrize("G,T,d,f,glu,act", [
    (3, 2, 64, 128, True, "silu"),
    (4, 70, 256, 128, False, "gelu"),
    (8, 256, 2048, 768, True, "silu"),
])
def test_grouped_ffn_kernel(G, T, d, f, glu, act):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    x = torch.randn((G, T, d), generator=g, device=dev).to(bf)
    w1 = (torch.randn((G, d, f), generator=g, device=dev) / d ** .5).to(bf)
    w3 = (torch.randn((G, d, f), generator=g, device=dev) / d ** .5).to(bf)
    w2 = (torch.randn((G, f, d), generator=g, device=dev) / f ** .5).to(bf)
    w3 = w3 if glu else None
    got = ops.grouped_ffn(x, w1, w3, w2, act=act)
    want = ref.grouped_ffn_ref(x, w1, w3, w2, act=act)
    torch.testing.assert_close(got.float(), want.float(), **FFN_TOL)


@pytest.mark.gpu
def test_serve_launches_every_kernel():
    _card()
    from repro_torch.launch.serve import serve
    res = serve("qwen3-moe-30b-a3b", reduced=True, batch=2, prompt_len=16,
                new_tokens=4, device="cuda")
    assert res.logits_finite
    per_forward = {"dispatch_gather": 4, "grouped_ffn": 2,
                   "combine_gather": 4}            # 2 layers x 2 SMILE hops
    assert res.launches["prefill"] == per_forward
    assert res.launches["decode"] == {k: 3 * v for k, v in per_forward.items()}
