"""The CUDA kernels against their plain versions, and the serving path
launching them, on a card.  Every test here carries the ``gpu`` marker and
skips itself when no card is present.  This file imports neither JAX nor
the JAX package, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import ops, ref

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import keep_logits, run_checked  # noqa: E402

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
    # the 128-row tiles: one row; one row past a tile; d and f one 64-column
    # box (narrower than a tile of either pass); one group; f 192 (a tile
    # and a half); the scoring forward's rows at 16 groups
    (5, 1, 256, 128, True, "silu"),
    (3, 129, 256, 192, True, "gelu"),
    (2, 5, 64, 64, True, "silu"),
    (1, 300, 128, 256, False, "gelu"),
    (16, 2048, 2048, 768, True, "silu"),
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
def test_grouped_ffn_kernel_limits():
    dev = _card()
    bf = torch.bfloat16
    w = torch.zeros((2, 64, 64), dtype=bf, device=dev)
    with pytest.raises(ValueError, match="multiples of 64"):
        ops.grouped_ffn(torch.zeros((2, 4, 32), dtype=bf, device=dev),
                        torch.zeros((2, 32, 64), dtype=bf, device=dev), None,
                        torch.zeros((2, 64, 32), dtype=bf, device=dev))
    # TMA reads from 16-byte boundaries: a view 2 bytes in is refused
    flat = torch.zeros(2 * 4 * 64 + 1, dtype=bf, device=dev)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.grouped_ffn(flat[1:].view(2, 4, 64), w, w, w)


def _ragged_rows(G, block, lens, tail, d, dev, g):
    """A tile-aligned ragged layout on the card: group ``i``'s ``lens[i]``
    rows at an aligned offset, zeros in the padding and in ``tail`` tiles
    past the last segment (what dispatch_ragged hands the kernel)."""
    aligned = [-(-n // block) * block for n in lens]
    starts = [0]
    for a in aligned:
        starts.append(starts[-1] + a)
    R = starts[-1] + tail * block
    rows = torch.zeros((R, d), device=dev)
    for i, n in enumerate(lens):
        rows[starts[i]:starts[i] + n] = torch.randn((n, d), generator=g,
                                                    device=dev)
    return (rows.to(torch.bfloat16),
            torch.tensor(starts, dtype=torch.int32, device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("lens,block,tail,d,f,glu,act", [
    ([8], 8, 0, 64, 128, True, "silu"),               # G=1, one tile
    ([5], 8, 2, 64, 64, False, "gelu"),               # G=1, tail tiles
    ([0, 0, 0], 8, 4, 64, 64, True, "silu"),          # every tile a tail
    ([3, 0, 17, 9, 1], 8, 3, 128, 192, False, "silu"),
    ([20, 40, 0, 33], 16, 1, 64, 128, True, "gelu"),
    ([70, 5, 64], 32, 2, 256, 128, True, "silu"),
    ([130, 0, 64, 1], 128, 1, 128, 64, True, "gelu"),  # 64 rows a block
    # 8-row tiles of different experts next to each other: a tile's 64-row
    # wgmma tile holds the next 7 tiles (other experts, then tail zeros),
    # none of which it may store
    ([8, 3, 8, 1, 7, 8, 2, 5, 8, 4], 8, 2, 128, 128, True, "silu"),
    # a full 64-row segment, then other experts, an empty one among them
    ([64, 10, 0, 64, 1], 64, 1, 128, 128, True, "gelu"),
    ([0, 64, 0, 0, 30], 64, 0, 64, 192, False, "silu"),  # empty first experts
])
def test_grouped_ffn_ragged_kernel(lens, block, tail, d, f, glu, act):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(len(lens) * 31 + block)
    bf = torch.bfloat16
    G = len(lens)
    rows, starts = _ragged_rows(G, block, lens, tail, d, dev, g)
    w1 = (torch.randn((G, d, f), generator=g, device=dev) / d ** .5).to(bf)
    w3 = (torch.randn((G, d, f), generator=g, device=dev) / d ** .5).to(bf)
    w2 = (torch.randn((G, f, d), generator=g, device=dev) / f ** .5).to(bf)
    w3 = w3 if glu else None
    n = ops.grouped_ffn_ragged.launches
    got = ops.grouped_ffn_ragged(rows, starts, w1, w3, w2, block=block,
                                 act=act)
    assert ops.grouped_ffn_ragged.launches == n + 1
    want = ref.grouped_ffn_ragged_ref(rows, starts, w1, w3, w2, act=act)
    torch.testing.assert_close(got.float(), want.float(), **FFN_TOL)
    # the tiles past the last segment come back as exact zeros
    assert not bool(got[int(starts[-1]):].any())


@pytest.mark.gpu
def test_grouped_ffn_ragged_kernel_limits():
    dev = _card()
    bf = dict(dtype=torch.bfloat16, device=dev)
    w1, w2 = torch.zeros((2, 64, 64), **bf), torch.zeros((2, 64, 64), **bf)
    starts = torch.zeros((3,), dtype=torch.int32, device=dev)
    n = ops.grouped_ffn_ragged.launches
    empty = ops.grouped_ffn_ragged(torch.zeros((0, 64), **bf), starts, w1,
                                   None, w2, block=8)
    assert empty.shape == (0, 64) and ops.grouped_ffn_ragged.launches == n
    # fp32 on the card: the kernel is bf16 only, and nothing falls back
    with pytest.raises(ValueError, match="bfloat16"):
        ops.grouped_ffn_ragged(torch.zeros((8, 64), device=dev), starts,
                               w1.float(), None, w2.float(), block=8)
    with pytest.raises(ValueError, match="block"):
        ops.grouped_ffn_ragged(torch.zeros((96, 64), **bf), starts, w1, None,
                               w2, block=96)
    with pytest.raises(ValueError, match="multiple of block"):
        ops.grouped_ffn_ragged(torch.zeros((12, 64), **bf), starts, w1, None,
                               w2, block=8)


@pytest.mark.gpu
@pytest.mark.parametrize("t,k,G,block", [(5120, 2, 128, 64),    # prefill
                                         (320, 1, 128, 8)])     # decode
def test_grouped_ffn_ragged_kernel_serving_shapes(t, k, G, block):
    """The serving hop-2 shapes, on the layout of a real dispatch_ragged
    (qwen3-moe: d=2048, f=768, 128 experts)."""
    from repro_torch.core import dispatch as D
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(t)
    bf = torch.bfloat16
    d, f = 2048, 768
    x = torch.randn((t, d), generator=g, device=dev).to(bf)
    gid = torch.randint(0, G, (t * k,), generator=g, device=dev,
                        dtype=torch.int32)
    valid = torch.rand((t * k,), generator=g, device=dev) < 0.8
    rows, starts, st = D.dispatch_ragged(x, gid, torch.ones(t * k, device=dev),
                                         G, k=k, valid=valid, use_kernel=True)
    assert st.cap == block
    w1 = (torch.randn((G, d, f), generator=g, device=dev) / d ** .5).to(bf)
    w3 = (torch.randn((G, d, f), generator=g, device=dev) / d ** .5).to(bf)
    w2 = (torch.randn((G, f, d), generator=g, device=dev) / f ** .5).to(bf)
    got = ops.grouped_ffn_ragged(rows, starts, w1, w3, w2, block=block,
                                 act="silu")
    want = ref.grouped_ffn_ragged_ref(rows, starts, w1, w3, w2, act="silu")
    torch.testing.assert_close(got.float(), want.float(), **FFN_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("A,K", [(1, 1), (5, 3), (2048, 17), (4096, 129),
                                 (1 << 20, 129), (70001, 4096),
                                 (3000, 8192)])
def test_group_sort_kernel(A, K):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(A)
    # skewed keys: half of them on one value
    keys = torch.randint(0, K, (A,), generator=g, device=dev,
                         dtype=torch.int32)
    keys = torch.where(torch.rand((A,), generator=g, device=dev) < 0.5,
                       torch.full_like(keys, K // 2), keys)
    n = ops.group_sort.launches
    ranks, starts = ops.group_sort(keys, K, impl="radix")
    assert ops.group_sort.launches == n + 1
    want_r, want_s = ref.group_sort_ref(keys, K)
    assert torch.equal(ranks, want_r) and torch.equal(starts, want_s)


def _sort_keys(A, K, draw, dev):
    g = torch.Generator(device=dev).manual_seed(A + K)
    if draw == "equal":
        return torch.full((A,), K // 2, dtype=torch.int32, device=dev)
    keys = torch.randint(0, K, (A,), generator=g, device=dev,
                         dtype=torch.int32)
    return torch.where(torch.rand((A,), generator=g, device=dev) < 0.5,
                       torch.full_like(keys, K // 2), keys)


@pytest.mark.gpu
@pytest.mark.parametrize("A,K,draw,launches", [
    (4096, 17, "skew", 1),         # the one-launch edge: a full block
    (4097, 17, "skew", 3),         # one key past it
    (4096, 1024, "skew", 1),       # the most keys and key values
    (2048, 1024, "skew", 1),       # the most key values one launch takes
    (2048, 1025, "skew", 3),       # one more
    (4096, 129, "equal", 1),       # every key on one value
    (16384, 129, "equal", 3),      # ... on three launches
    (140000, 129, "equal", 3),     # ... over more blocks
    (1 << 20, 8192, "skew", 3),    # three launches at the most key values
    (4000, 1, "equal", 1),         # K = 1
    (1, 129, "skew", 1),           # A = 1
])
def test_group_sort_kernel_routes(A, K, draw, launches):
    dev = _card()
    keys = _sort_keys(A, K, draw, dev)
    assert ops.sort_route(A, K).launches == launches
    ranks, starts = ops.group_sort(keys, K, impl="radix")
    want_r, want_s = ref.group_sort_ref(keys, K)
    assert torch.equal(ranks, want_r) and torch.equal(starts, want_s)


@pytest.mark.gpu
@pytest.mark.parametrize("A,K", [(4096, 129), (16385, 17)])
def test_group_sort_kernel_out_of_domain(A, K):
    """On either route a key outside [0, K) gets rank -1 and is not
    counted."""
    dev = _card()
    keys = _sort_keys(A, K, "skew", dev)
    g = torch.Generator(device=dev).manual_seed(5)
    bad = torch.rand((A,), generator=g, device=dev) < 0.1
    keys = torch.where(bad, torch.where(torch.rand((A,), generator=g,
                                                   device=dev) < 0.5,
                                        -1, K + 3), keys).to(torch.int32)
    ranks, starts = ops.group_sort(keys, K, impl="radix")
    assert bool((ranks[bad] == -1).all())
    want_r, want_s = ref.group_sort_ref(keys[~bad], K)
    assert torch.equal(ranks[~bad], want_r) and torch.equal(starts, want_s)


@pytest.mark.gpu
def test_group_sort_kernel_limits():
    dev = _card()
    ranks, starts = ops.group_sort(torch.zeros((0,), dtype=torch.int32,
                                               device=dev), 5, impl="radix")
    assert ranks.numel() == 0 and starts.tolist() == [0] * 6
    with pytest.raises(ValueError, match="at most 8192 keys"):
        ops.group_sort(torch.zeros((4,), dtype=torch.int32, device=dev),
                       8193, impl="radix")


def check_router_fused(got, want, k):
    """The card's router against its plain version: logits and probs within
    rtol 1e-5 / atol 4e-6 (fp32 sums in another order: each side lands up
    to ~1e-6 from the fp64 product at d=768), ids equal wherever
    the top-(k+1) probabilities are more than 1e-6 apart, ranks and starts
    bit-exact against the counting sort of the kernel's own ids, gates the
    kernel's probs at its ids.  Returns the number of rows closer."""
    gates, idx, probs, logits, ranks, starts = got
    torch.testing.assert_close(logits, want[3], rtol=1e-5, atol=4e-6)
    torch.testing.assert_close(probs, want[2], rtol=1e-5, atol=4e-6)
    E = probs.shape[1]
    top = want[2].sort(dim=1, descending=True).values[:, :min(k + 1, E)]
    close = ((top[:, :-1] - top[:, 1:]) <= 1e-6).any(dim=1) if E > 1 else \
        torch.zeros(probs.shape[0], dtype=torch.bool, device=probs.device)
    assert torch.equal(idx[~close], want[1][~close])
    r, s = ref.group_sort_ref(idx.reshape(-1), E)
    assert torch.equal(ranks, r) and torch.equal(starts, s)
    return int(close.sum())


@pytest.mark.gpu
@pytest.mark.parametrize("t,d,E,k,renorm,dtype", [
    (2048, 768, 16, 1, False, torch.bfloat16),
    (4096, 768, 8, 1, False, torch.bfloat16),
    (2048, 768, 128, 1, False, torch.bfloat16),
    (300, 64, 256, 8, True, torch.float32),
    (33, 100, 3, 3, False, torch.float32),
    # t not a multiple of the 16 rows a block; E = 1; E = 256; k = E = 256;
    # bf16 rows of 200 bytes, staged element by element (not 16-byte
    # copies)
    (2047, 768, 16, 1, False, torch.bfloat16),
    (100, 64, 1, 1, False, torch.float32),
    (2048, 768, 256, 2, True, torch.bfloat16),
    (777, 96, 256, 256, False, torch.float32),
    (129, 100, 5, 2, False, torch.bfloat16),
])
def test_router_fused_kernel(t, d, E, k, renorm, dtype):
    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(t + E)
    x = torch.randn((t, d), generator=g, device=dev).to(dtype)
    w = torch.randn((d, E), generator=g, device=dev) / d ** 0.5
    n = ops.router_fused.launches
    got = ops.router_fused(x, w, k, renorm=renorm)
    assert ops.router_fused.launches == n + 1
    want = ref.router_fused_ref(x, w, k, renorm=renorm)
    check_router_fused(got, want, k)
    gates = got[2].gather(1, got[1].long())
    if renorm and k > 1:
        gates = ref.renorm_gates(gates)
    assert torch.equal(got[0], gates)


@pytest.mark.gpu
def test_router_fused_kernel_repeats_and_streams():
    """The same inputs give the same bits call after call, on the current
    stream and on two others one after the other (the last block to arrive
    varies; each stream has its own arrival counter, zero after every
    launch)."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn((4096, 768), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn((768, 8), generator=g, device=dev) / 768 ** 0.5
    first = ops.router_fused(x, w, 1)
    runs = [ops.router_fused(x, w, 1) for _ in range(3)]
    for stream in (torch.cuda.Stream(), torch.cuda.Stream()):
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            runs.append(ops.router_fused(x, w, 1))
        stream.synchronize()
    torch.cuda.synchronize()
    for run in runs:
        for got, want in zip(run, first):
            assert torch.equal(got, want)
    tickets = [t for (i, _), t in ops._ROUTER_TICKETS.items()
               if i == dev.index or (dev.index is None and i == 0)]
    assert len(tickets) >= 3
    assert all(int(t) == 0 for t in tickets)


@pytest.mark.gpu
def test_router_fused_kernel_ties_and_grad():
    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(7)
    # bf16 inputs and two equal expert columns: exact ties on every row
    x = torch.randn((512, 64), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((64, 16), generator=g, device=dev) / 8).to(
        torch.bfloat16).float()
    w[:, 5] = w[:, 3]
    w.requires_grad_(True)
    xr = x.float().requires_grad_(True)
    got = ops.router_fused(xr, w, 2)
    idx = got[1]                   # 5 ties 3, so 5 only ever follows 3
    assert not bool((idx[:, 0] == 5).any())
    assert bool((idx[idx[:, 1] == 5, 0] == 3).all())
    check_router_fused(got, ref.router_fused_ref(xr, w, 2), 2)
    (got[0].sum() + got[2].square().sum()).backward()
    gw, gx = w.grad.clone(), xr.grad.clone()
    w.grad = xr.grad = None
    probs = torch.softmax(xr @ w, -1)
    (probs.gather(1, got[1].long()).sum() + probs.square().sum()).backward()
    torch.testing.assert_close(gw, w.grad, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(gx, xr.grad, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["dispatch_gather", "combine_gather",
                                  "grouped_ffn", "grouped_ffn_ragged",
                                  "flash_attention", "rwkv6_scan",
                                  "ssd_chunk"])
def test_forward_only_kernels_raise_under_autograd(name):
    # these kernels have no backward: under autograd they must raise, not
    # return an output that carries no gradient; under no_grad they launch
    dev = _card()
    bf = dict(dtype=torch.bfloat16, device=dev)
    x = torch.randn((16, 64), **bf)
    w = torch.randn((2, 64, 64), **bf)
    src = torch.arange(16, dtype=torch.int32, device=dev)
    calls = {
        "dispatch_gather": lambda x, w: ops.dispatch_gather(x, src),
        "combine_gather": lambda x, w: ops.combine_gather(
            x, src[:, None], torch.ones((16, 1), device=dev)),
        "grouped_ffn": lambda x, w: ops.grouped_ffn(
            x.view(2, 8, 64), w, None, w, act="gelu"),
        "grouped_ffn_ragged": lambda x, w: ops.grouped_ffn_ragged(
            x, torch.tensor([0, 8, 16], dtype=torch.int32, device=dev), w,
            None, w, block=8, act="gelu"),
        "flash_attention": lambda x, w: ops.flash_attention(
            *(x.view(1, 16, 2, 32),) * 3),
        "rwkv6_scan": lambda x, w: ops.rwkv6_scan(
            *(x.float().view(1, 16, 1, 64),) * 4, w.float()[0, :1],
            w.float()[:1].view(1, 1, 64, 64)),
        "ssd_chunk": lambda x, w: ops.ssd_chunk(
            x.float().view(1, 1, 16, 1, 64),
            *(x.float()[:, :1].contiguous().view(1, 1, 16, 1),) * 2,
            *(w.float()[0, :16, :4].contiguous().view(1, 1, 16, 4),) * 2),
    }
    before = ops.launch_counts()[name]
    with pytest.raises(RuntimeError, match="no backward"):
        calls[name](x.requires_grad_(True), w.requires_grad_(True))
    assert ops.launch_counts()[name] == before
    with torch.no_grad():
        calls[name](x, w)
    assert ops.launch_counts()[name] == before + 1


# serving always has a cache: the attention and the rwkv recurrence take
# their plain branches, and nothing calls the SSD kernel
NO_SCORING_KERNELS = {"flash_attention": 0, "rwkv6_scan": 0, "ssd_chunk": 0}


@pytest.mark.gpu
def test_serve_launches_every_kernel():
    _card()
    from repro_torch.launch.serve import serve
    res = serve("qwen3-moe-30b-a3b", reduced=True, batch=2, prompt_len=16,
                new_tokens=4, device="cuda")
    assert res.logits_finite
    per_forward = {"dispatch_gather": 4, "grouped_ffn": 2,
                   "combine_gather": 4,            # 2 layers x 2 SMILE hops
                   "router_fused": 0, "group_sort": 0,   # unfused, argsort
                   "grouped_ffn_ragged": 0, **NO_SCORING_KERNELS}
    assert res.launches["prefill"] == per_forward
    assert res.launches["decode"] == {k: 3 * v for k, v in per_forward.items()}


@pytest.mark.gpu
def test_serve_dropless_launches_the_ragged_kernel():
    _card()
    from repro_torch.launch.serve import serve
    res = serve("qwen3-moe-30b-a3b", reduced=True, batch=2, prompt_len=16,
                new_tokens=4, device="cuda",
                moe_options={"dispatch_backend": "dropless"})
    assert res.logits_finite
    per_forward = {"dispatch_gather": 4, "grouped_ffn": 0,
                   "combine_gather": 4,            # 2 layers x 2 SMILE hops
                   "router_fused": 0, "group_sort": 0,
                   "grouped_ffn_ragged": 2,        # hop 2 of each layer
                   **NO_SCORING_KERNELS}
    assert res.launches["prefill"] == per_forward
    assert res.launches["decode"] == {k: 3 * v for k, v in per_forward.items()}


# the kernel's q is scaled in bf16 and its probabilities rounded to bf16
# before PV (as the Pallas body); the plain version does both in fp32.  Each
# output is held within one bf16 ulp of the plain one (both round once)
# plus FLASH_ROW_ATOL of its row's RMS over hd: the rounded weights' noise
# scales with the row, whose size falls along the sequence.  chip_smoke.py
# holds the path's shapes to the same bound and prints both readings
FLASH_ROW_ATOL = 3e-2


def _assert_flash_close(got, want):
    got, want = got.float(), want.float()
    _, e = torch.frexp(want)
    ulp = torch.ldexp(torch.ones_like(want), e - 8)       # 8 bits in bf16
    rms = want.pow(2).mean(-1, keepdim=True).sqrt().clamp(min=1e-30)
    over = ((got - want).abs() - ulp).clamp(min=0) / rms
    assert over.max().item() <= FLASH_ROW_ATOL, over.max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,H,KV,hd", [
    (1, 1, 2, 2, 32), (2, 24, 4, 2, 64), (1, 128, 4, 4, 128),
    (2, 256, 8, 2, 128), (1, 1024, 32, 4, 128),
    # the 64-byte swizzle (hd 32) and one 128-byte box (hd 64) over many KV
    # tiles; 8 query heads per KV head; T 384, an odd number of 128-row
    # query and KV tiles (so the 2-stage K/V ring wraps mid-loop)
    (2, 512, 4, 2, 32), (1, 640, 4, 1, 64), (1, 512, 16, 2, 128),
    (2, 384, 8, 2, 128), (1, 384, 4, 4, 64),
    # head sizes run padded (TMA loads the columns past hd as zeros): 80 and
    # 96 at 128, 160 at 192 with 64-key tiles and a 3-stage ring; 8 and 40
    # at 32 and 64; GQA, T 384 (the ring wraps), T < 128
    (1, 256, 4, 4, 80), (2, 384, 8, 2, 96), (1, 384, 8, 2, 160),
    (2, 512, 4, 4, 160), (1, 64, 2, 1, 160), (2, 96, 4, 2, 160),
    (1, 24, 2, 2, 96),
    (1, 128, 2, 2, 8), (1, 256, 4, 2, 40),
    # past 192, the wide route (the head dim in 64-column chunks through
    # shared memory): hd 256 and 384, a partial last chunk (200, 456), GQA,
    # T below one 64-key tile and between two, and the widest head (512)
    (1, 256, 4, 2, 256), (2, 384, 4, 4, 384), (1, 128, 2, 1, 200),
    (1, 16, 2, 2, 256), (2, 96, 4, 2, 456), (1, 256, 2, 2, 512)])
def test_flash_attention_kernel(B, T, H, KV, hd):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(T + H)
    bf = torch.bfloat16
    q = torch.randn((B, T, H, hd), generator=g, device=dev).to(bf)
    k = torch.randn((B, T, KV, hd), generator=g, device=dev).to(bf)
    v = torch.randn((B, T, KV, hd), generator=g, device=dev).to(bf)
    n = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v)
    assert ops.flash_attention.launches == n + 1
    rep = H // KV
    want = ref.flash_attention_ref(q, k.repeat_interleave(rep, dim=2),
                                   v.repeat_interleave(rep, dim=2))
    assert got.dtype == bf
    _assert_flash_close(got, want)


@pytest.mark.gpu
def test_flash_attention_kernel_limits():
    dev = _card()
    # head sizes the rule refuses: not a multiple of 8, past the widest
    for hd in (52, 520):
        q = torch.zeros((1, 8, 2, hd), dtype=torch.bfloat16, device=dev)
        with pytest.raises(ValueError, match="multiple of 8 up to 512"):
            ops.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="bfloat16"):
        ops.flash_attention(*(torch.zeros((1, 8, 2, 64), device=dev),) * 3)
    # TMA reads from 16-byte boundaries: a view 2 bytes in is refused
    flat = torch.zeros(8 * 2 * 64 + 1, dtype=torch.bfloat16, device=dev)
    q = flat[1:].view(1, 8, 2, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.flash_attention(q, q, q)


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,nh", [(1, 1, 1), (2, 37, 3), (2, 300, 4),
                                    (4, 512, 32),
                                    (3, 1000, 5)])   # T off the 32-step chunk
def test_rwkv6_scan_kernel(B, T, nh):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(T)
    hd = 64
    r, k, v = (torch.randn((B, T, nh, hd), generator=g, device=dev)
               for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn((B, T, nh, hd), generator=g,
                                         device=dev) * 0.5 - 1.0))
    u = torch.randn((nh, hd), generator=g, device=dev)
    s0 = torch.randn((B, nh, hd, hd), generator=g, device=dev)
    n = ops.rwkv6_scan.launches
    y, s_last = ops.rwkv6_scan(r, k, v, w, u, s0)
    assert ops.rwkv6_scan.launches == n + 1
    wy, ws = ref.rwkv6_scan_ref(r, k, v, w, u, s0)
    # the readout sums over i in another order, with the bonus factored out
    # as v_j * sum_i r_i u_i k_i: fp32 rounding of terms that reach ~30, so
    # atol scales with the largest output
    torch.testing.assert_close(y, wy, rtol=1e-5,
                               atol=1e-6 * wy.abs().max().item())
    # the state update rounds w * S, then + k v, as the plain version
    assert torch.equal(s_last, ws)


def _ssd_inputs(dev, B, nc, Q, nh, hd, ds, loga_lo, loga_hi):
    g = torch.Generator(device=dev).manual_seed(Q + nh)
    xh = torch.randn((B, nc, Q, nh, hd), generator=g, device=dev)
    dt = torch.rand((B, nc, Q, nh), generator=g, device=dev) * 0.5 + 0.01
    loga = loga_lo + (loga_hi - loga_lo) * torch.rand(
        (B, nc, Q, nh), generator=g, device=dev)
    Bc = torch.randn((B, nc, Q, ds), generator=g, device=dev)
    Cc = torch.randn((B, nc, Q, ds), generator=g, device=dev)
    return xh, dt, loga, Bc, Cc


def _ssd_route(dev, B, nc, Q, nh, hd, ds):
    return ops.ssd_route(B * nc, Q, nh, hd, ds, torch.cuda
                         .get_device_properties(dev).multi_processor_count)


# (B, nc, Q, nh, hd, ds, route): the general kernel's shapes; zamba2's
# reduced config (Q 32, hd 32, ds 16) and zamba2-2.7b's (Q 128, hd 64, ds
# 64) on the grouped one, with a head count the head group does not divide
# (81 heads at 32 chunks: 21 heads a block, a tail of 18), and all 80 heads
SSD_CASES = [(1, 2, 8, 2, 4, 4, "general"),
             (2, 3, 16, 3, 8, 8, "general"),
             (1, 2, 128, 2, 64, 64, "grouped"),
             (4, 16, 32, 8, 32, 16, "grouped"),
             (1, 32, 128, 81, 64, 64, "grouped"),
             (1, 2, 128, 80, 64, 64, "grouped")]


@pytest.mark.gpu
@pytest.mark.parametrize("B,nc,Q,nh,hd,ds,route", SSD_CASES)
# log-decays of a typical step, of a strongly decaying one, of a steep one
# (three steps' growth exp(cs_i - cs_j), i < j, overflows: W must take no
# exponential of it), and of both signs (which no decay gives: cs rises and
# falls, and the grouped kernel's factors exp(cs_i - cs_i0) of W exceed 1)
@pytest.mark.parametrize("loga_lo,loga_hi", [(-0.5, 0.0), (-8.0, -5.0),
                                             (-40.0, -30.0), (-0.25, 0.25)])
def test_ssd_chunk_kernel(B, nc, Q, nh, hd, ds, route, loga_lo, loga_hi):
    dev = _card()
    plan = _ssd_route(dev, B, nc, Q, nh, hd, ds)
    assert plan.route == route
    if nh == 81:
        assert nh % plan.group != 0, plan      # a group with fewer heads
    xh, dt, loga, Bc, Cc = _ssd_inputs(dev, B, nc, Q, nh, hd, ds, loga_lo,
                                       loga_hi)
    n = ops.ssd_chunk.launches
    got = ops.ssd_chunk(xh, dt, loga, Bc, Cc)
    assert ops.ssd_chunk.launches == n + 1
    want = ref.ssd_chunk_ref(xh, dt, loga, Bc, Cc)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        # both kernels run the cumsum in step order, as torch's over this
        # (non-innermost) dimension on the card; the matrix products sum in
        # other orders, and an ulp of |cs| (up to ~64 here in the mild case)
        # is a relative error of the exponentials of up to ~1e-5 a term
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-5 * max(b.abs().max().item(),
                                                   1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("B,nc,Q,nh,hd,ds,route",
                         [SSD_CASES[1], SSD_CASES[4]])
def test_ssd_chunk_kernel_repeats_bit_for_bit(B, nc, Q, nh, hd, ds, route):
    dev = _card()
    assert _ssd_route(dev, B, nc, Q, nh, hd, ds).route == route
    args = _ssd_inputs(dev, B, nc, Q, nh, hd, ds, -1.0, 0.0)
    first = ops.ssd_chunk(*args)
    for _ in range(3):
        for a, b in zip(first, ops.ssd_chunk(*args)):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_reduced_cacheless_forwards_launch_the_scoring_kernels():
    _card()
    from repro_torch.configs import get_reduced
    from repro_torch.models import transformer as T
    from repro_torch.sharding.plan import single_device_plan
    plan = single_device_plan()
    for arch, want in (("qwen3-moe-30b-a3b", {"flash_attention": 2,
                                              "rwkv6_scan": 0}),
                       ("rwkv6-1.6b", {"flash_attention": 0,
                                       "rwkv6_scan": 2})):
        cfg = get_reduced(arch)
        params = T.init_model(cfg, plan, seed=0, device="cuda")
        toks = torch.randint(0, cfg.vocab_size, (2, 64), device="cuda")
        ops.reset_launch_counts()
        with torch.inference_mode():
            _, logits, _, _ = T.forward(
                params, toks, cfg, plan, use_kernel=True,
                positions=torch.arange(64, device="cuda"))
        counts = ops.launch_counts()
        assert {k: counts[k] for k in want} == want, (arch, counts)
        assert bool(torch.isfinite(logits).all())


@pytest.mark.gpu
def test_rwkv6_serve_runs_the_plain_recurrence():
    _card()
    from repro_torch.launch.serve import serve
    res = serve("rwkv6-1.6b", reduced=True, batch=2, prompt_len=16,
                new_tokens=4, device="cuda")
    assert res.logits_finite
    for phase in ("prefill", "decode"):
        assert all(n == 0 for n in res.launches[phase].values()), res.launches


# the continuous-batching engine at the reduced configs: 10 ragged requests
# (prompts 4-24 tokens, 4-8 new), 3 slots, pages of 4 (buckets 16 and 32)
ENGINE_CASES = {"qwen1.5": ("qwen1.5-0.5b", None),
                "qwen3-sort": ("qwen3-moe-30b-a3b", None),
                "qwen3-dropless": ("qwen3-moe-30b-a3b",
                                   {"dispatch_backend": "dropless"})}
# the tolerance of the serving tests for bf16 logits
LOGITS_ATOL = 3e-2


def _engine_setup(case, device):
    import numpy as np
    from repro_torch.common.config import ServeConfig
    from repro_torch.configs import get_reduced, with_options
    from repro_torch.launch.serve import draw_requests
    from repro_torch.models import transformer as T
    from repro_torch.sharding.plan import single_device_plan
    arch, opts = ENGINE_CASES[case]
    cfg = with_options(get_reduced(arch), **(opts or {}))
    plan = single_device_plan()
    params = T.init_model(cfg, plan, seed=0, device=device)
    sc = ServeConfig(prompt_len=24, max_new_tokens=8, n_slots=3, page_size=4)
    reqs = draw_requests(np.random.default_rng(0), 10, 24, 8, cfg.vocab_size)
    return cfg, plan, params, sc, reqs


def _engine_per_forward(cfg):
    """Kernel launches a forward of the reduced config (2 layers)."""
    out = {k: 0 for k in ops.launch_counts()}
    if cfg.moe is not None:
        out.update(dispatch_gather=4, combine_gather=4)
        out["grouped_ffn_ragged" if cfg.moe.dispatch_backend == "dropless"
            else "grouped_ffn"] = 2
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_card_matches_cpu(case):
    """The same weights and trace through the engine on the CPU (eager,
    plain versions) and on the card (CUDA graphs, kernels): equal tokens,
    or where a request first parts, logits within LOGITS_ATOL and a top-2
    margin under twice that; the same ticks."""
    _card()
    from repro_torch.serve.engine import Engine
    cfg, plan, params, sc, reqs = _engine_setup(case, "cpu")
    engines, logits = [], []
    for p in (params, _to_card(params)):
        eng = Engine(p, cfg, plan, serve=sc)
        with keep_logits(eng) as kept:
            for prompt, nt in reqs:
                eng.submit(prompt, nt)
            eng.run()
        engines.append(eng)
        logits.append(kept)
    cpu, gpu = engines
    assert cpu.ticks == gpu.ticks
    for u, want in cpu.finished.items():
        got = gpu.finished[u]
        la, lb = logits[0][u], logits[1][u]
        j = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b),
                 len(want) - 1)
        for x, y in zip(la[:j + 1], lb[:j + 1]):
            assert (x - y).abs().max().item() <= LOGITS_ATOL
        if got != want:
            top2 = la[j].topk(2).values
            assert (top2[0] - top2[1]).item() < 2 * LOGITS_ATOL, (u, j)


def _to_card(tree):
    if isinstance(tree, dict):
        return {k: _to_card(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_card(v) for v in tree)
    return tree.to("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_graph_replay_matches_eager(case):
    """A decode replay and a prefill replay against the step function run
    eagerly on a clone of the caches, with the same static inputs."""
    _card()
    from repro_torch.serve.engine import Engine
    cfg, plan, params, sc, reqs = _engine_setup(case, "cuda")
    eng = Engine(params, cfg, plan, serve=sc)
    for p, nt in reqs[:4]:
        eng.submit(p, nt)
    eng.run()                              # captures every step it used
    bucket = next(k for k in eng.steps if k != "decode")
    _, checks = run_checked(eng, reqs[:4], ("decode", bucket))
    assert set(checks) == {"decode", bucket}
    for key, ((pe, le), (pg, lg)) in checks.items():
        n = sc.n_slots if key == "decode" else 1
        assert torch.equal(pe[:n], pg[:n]), key
        assert (le.float() - lg.float()).abs().max().item() <= LOGITS_ATOL


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_captures_once_across_admit_evict_cycles(case):
    """Three passes of the trace through one engine (every page freed and
    reused, slots refilled): one capture a step, replays counted, the
    kernel counters moved only by each step's warm-up and capture, and
    every page free at the end."""
    _card()
    from repro_torch.serve.engine import Engine
    cfg, plan, params, sc, reqs = _engine_setup(case, "cuda")
    eng = Engine(params, cfg, plan, serve=sc)
    ops.reset_launch_counts()
    outs = []
    for _ in range(3):
        uids = [eng.submit(p, nt) for p, nt in reqs]
        eng.run()
        outs.append([eng.finished[u] for u in uids])
        assert eng.alloc.n_free == eng.alloc.pool_pages and not eng.busy
    assert outs[0] == outs[1] == outs[2]
    n = eng.compile_counts()
    assert n["captures"] == {"decode": 1,
                             "prefill": {b: 1 for b in n["prefill"]}}
    assert n["decode"] == 1 and set(n["prefill"]) <= set(eng.buckets)
    assert n["replays"]["decode"] >= 3 and all(
        v >= 3 for v in n["replays"]["prefill"].values())
    steps = 1 + len(n["prefill"])
    want = {k: 2 * steps * v for k, v in _engine_per_forward(cfg).items()}
    assert ops.launch_counts() == want == eng.capture_launches()


# the expert-parallel wire on one card: ranks share cuda:0 under gloo (NCCL
# refuses two ranks on one device), so the collectives cross the host

def _ragged_on_the_card(rank):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import comm
    make_mesh((2,), ("model",), device=rank.device)
    g = torch.Generator().manual_seed(rank.rank)
    rows = torch.randn((12, 64), generator=g).to(torch.bfloat16)
    counts = torch.tensor([[3, 5], [4, 2]][rank.rank], dtype=torch.int32)
    recv, rc = comm.ragged_all_to_all(rows.cuda(), counts.cuda(), "model",
                                      recv_rows=24)
    cut, _ = comm.ragged_all_to_all(rows.cuda(), counts.cuda(), "model",
                                    recv_rows=5, allow_truncate=True)
    return rows, recv.cpu(), rc.cpu(), cut.cpu(), str(recv.device)


@pytest.mark.gpu
def test_gloo_ragged_all_to_all_of_card_tensors():
    _card()
    from repro_torch.launch.mesh import RankPool
    with RankPool(2, backend="gloo", devices=["cuda:0"] * 2,
                  timeout_s=300) as pool:
        (r0, recv0, rc0, cut0, dev0), (r1, recv1, rc1, cut1, _) = pool.run(
            _ragged_on_the_card)
    assert dev0 == "cuda:0"
    assert rc0.tolist() == [3, 4] and rc1.tolist() == [5, 2]
    zeros = torch.zeros((17, 64), dtype=torch.bfloat16)
    assert torch.equal(recv0, torch.cat([r0[:3], r1[:4], zeros]))
    assert torch.equal(recv1, torch.cat([r0[3:8], r1[4:6], zeros]))
    # a receive bound of 5 keeps a prefix of the source-major layout
    assert torch.equal(cut0, torch.cat([r0[:3], r1[:2]]))
    assert torch.equal(cut1, r0[3:8])


@pytest.mark.gpu
def test_four_ranks_on_the_card_serve_dropless_as_one():
    _card()
    from chip_smoke import LOGITS_ATOL, check_tokens_and_logits
    from repro_torch.launch.serve import (gather_logits, gather_rows, serve,
                                          serve_mesh)
    kw = dict(reduced=True, batch=4, prompt_len=16, new_tokens=4, seed=0,
              moe_options={"dispatch_backend": "dropless"},
              keep_logits=True)
    one = serve("qwen3-moe-30b-a3b", device="cuda", **kw)
    out = serve_mesh("qwen3-moe-30b-a3b", (2, 2), backend="gloo",
                     devices=["cuda:0"] * 4, timeout_s=300, **kw)
    check_tokens_and_logits(one.tokens, one.logits, gather_rows(out),
                            gather_logits(out), LOGITS_ATOL,
                            "one rank against four on the card")
    for r in out:
        assert r["finite"]
        got = {k: v for k, v in r["launches"]["decode"].items() if v}
        # 2 layers: 3 gathers, 3 combines and one ragged FFN a layer
        assert got == {"dispatch_gather": 18, "combine_gather": 18,
                       "grouped_ffn_ragged": 6}, got


def _ragged_grad_on_the_card(rank):
    """The ragged exchange's backward from autograd's device thread: each
    rank's loss is sum(recv * ct) with its own small-integer cotangent."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import comm
    make_mesh((2,), ("model",), device=rank.device)
    g = torch.Generator().manual_seed(rank.rank)
    rows = torch.randn((12, 64), generator=g).to(torch.bfloat16).cuda()
    rows.requires_grad_(True)
    counts = torch.tensor([[3, 5], [4, 2]][rank.rank], dtype=torch.int32)
    ct = (torch.arange(24 * 64, dtype=torch.float32).reshape(24, 64) % 7
          + 8 * rank.rank)
    recv, _ = comm.ragged_all_to_all(rows, counts.cuda(), "model",
                                     recv_rows=24)
    (recv.float() * ct.cuda()).sum().backward()
    return rows.grad.cpu(), ct


@pytest.mark.gpu
def test_gloo_ragged_all_to_all_gradient_on_the_card():
    """The cotangent of each arrived row goes back to the row that was
    sent (rows past the segments get zero), as JAX's transpose."""
    _card()
    from repro_torch.launch.mesh import RankPool
    with RankPool(2, backend="gloo", devices=["cuda:0"] * 2,
                  timeout_s=300) as pool:
        (g0, ct0), (g1, ct1) = pool.run(_ragged_grad_on_the_card)
    bf = torch.bfloat16
    z = torch.zeros((4, 64), dtype=bf)
    assert torch.equal(g0, torch.cat([ct0[:3], ct1[:5], z[:4]]).to(bf))
    assert torch.equal(g1, torch.cat([ct0[3:7], ct1[5:7], z, z[:2]]).to(bf))


@pytest.mark.gpu
def test_four_ranks_on_the_card_train_as_one():
    """``train_mesh`` on 4 gloo ranks sharing the card against one rank's
    ``train()`` (reduced smile-3.7b, bf16, the routing kernels on): each
    step's loss within tests/distributed/_train_equiv.py's 2e-2, and each
    rank launches the routing kernels 4 times a step (1 MoE layer, 2
    hops, the forward and the remat recompute)."""
    _card()
    from repro_torch.launch.train import train, train_mesh
    kw = dict(reduced=True, steps=2, batch=8, seq=32, log_every=1,
              moe_options={"router_impl": "fused", "sort_impl": "radix"})
    _, one = train("smile-3.7b", device="cuda", **kw)
    hist, out = train_mesh("smile-3.7b", (2, 2), backend="gloo",
                           devices=["cuda:0"] * 4, timeout_s=300, **kw)
    for h, o in zip(hist, one):
        assert abs(h["loss"] - o["loss"]) <= 2e-2, (h["loss"], o["loss"])
    for r in out:
        for h in r["history"]:
            got = {k: v for k, v in h["launches"].items() if v}
            assert got == {"router_fused": 4, "group_sort": 4}, got
        assert r["peak_bytes"] > 0
