"""The plain ``ssd_chunk_ref`` (Mamba2's SSD intra-chunk terms) against the
JAX package's oracle, on numpy-drawn inputs, and the wrapper's CPU route.
No model calls the kernel, in either package: these plain versions are what
the CUDA kernel is held to on a card (tests/test_torch_gpu.py,
chip_smoke.py).

Tolerance: rtol 1e-5 and atol 1e-6 of each output's largest value.  The
same fp32 math; the sums run in other orders, and the two cumsums may
round cs differently by an ulp of |cs| a step, which the exponentials
carry as a relative error of the same size.  With ``loga <= -5`` a step,
cs reaches ~-1000 and exp(cs_i - cs_j) above the diagonal would overflow:
the outputs must stay free of NaN (the oracle masks the exponent to -inf
before exp); with ``loga <= -30`` it overflows within three steps of the
diagonal, and W is all but its diagonal.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref


def _inputs(B, nc, Q, nh, hd, ds, loga_range, seed):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, nc, Q, nh, hd)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (B, nc, Q, nh)).astype(np.float32)
    loga = rng.uniform(*loga_range, (B, nc, Q, nh)).astype(np.float32)
    Bc = rng.standard_normal((B, nc, Q, ds)).astype(np.float32)
    Cc = rng.standard_normal((B, nc, Q, ds)).astype(np.float32)
    return xh, dt, loga, Bc, Cc


@pytest.mark.parametrize("loga_range", [(-0.5, 0.0), (-8.0, -5.0),
                                        (-40.0, -30.0)],
                         ids=["mild", "strongly-negative", "steep"])
@pytest.mark.parametrize("B,nc,Q,nh,hd,ds", [(1, 1, 4, 1, 4, 4),
                                             (2, 3, 16, 2, 8, 4),
                                             (1, 2, 128, 2, 16, 8),
                                             # zamba2's reduced config
                                             (2, 4, 32, 8, 32, 16)])
def test_ssd_chunk_ref_matches_jax(B, nc, Q, nh, hd, ds, loga_range):
    args = _inputs(B, nc, Q, nh, hd, ds, loga_range, seed=Q + nh)
    want = jref.ssd_chunk_ref(*map(jnp.asarray, args))
    before = ops.launch_counts()
    got = ops.ssd_chunk(*map(torch.from_numpy, args))    # CPU: plain
    assert ops.launch_counts() == before
    shapes = [(B, nc, Q, nh, hd), (B, nc, nh, hd, ds), (B, nc, nh)]
    for g, w, shape in zip(got, want, shapes):
        w = np.asarray(w)
        assert g.shape == shape and g.dtype == torch.float32
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-6 * max(np.abs(w).max(), 1e-30))


def test_ssd_chunk_ref_is_causal():
    """y_intra at step i does not see the inputs of steps after i."""
    args = [torch.from_numpy(a) for a in
            _inputs(1, 1, 16, 2, 4, 4, (-0.5, 0.0), seed=3)]
    y, _, _ = ref.ssd_chunk_ref(*args)
    xh = args[0].clone()
    xh[:, :, 9:] += 1.0
    y2, _, _ = ref.ssd_chunk_ref(xh, *args[1:])
    assert torch.equal(y[:, :, :9], y2[:, :, :9])
    assert not torch.equal(y[:, :, 9:], y2[:, :, 9:])


# (BC, Q, nh, hd, ds, sms) -> (route, heads a block, blocks).  At zamba2-
# 2.7b's shapes on an H100 (132 SMs): 27 heads a block, 3 waves of 128
# chunks x 3 groups; a head count the group does not divide; too few chunks
# for a wave; zamba2's reduced config; shapes without a grouped kernel
SSD_ROUTES = [
    ((128, 128, 80, 64, 64, 132), ("grouped", 27, 384)),
    ((2, 128, 80, 64, 64, 132), ("grouped", 2, 80)),
    ((32, 128, 81, 64, 64, 132), ("grouped", 21, 128)),
    ((1, 128, 80, 64, 64, 132), ("grouped", 1, 80)),
    ((64, 32, 8, 32, 16, 132), ("grouped", 4, 128)),
    ((4, 8, 2, 4, 4, 132), ("general", 1, 8)),
    ((6, 16, 3, 8, 8, 132), ("general", 1, 18)),
    ((128, 64, 80, 64, 64, 132), ("general", 1, 10240)),
]


@pytest.mark.parametrize("args,want", SSD_ROUTES)
def test_ssd_route(args, want):
    assert tuple(ops.ssd_route(*args)) == want


@pytest.mark.parametrize("BC", [1, 7, 128, 1000])
@pytest.mark.parametrize("nh", [1, 5, 80, 81, 200])
@pytest.mark.parametrize("sms", [1, 132])
def test_ssd_route_group_is_the_cheapest(BC, nh, sms):
    """The grouped route's head group: at most SSD_MAX_GROUP heads, blocks
    covering every (chunk, head), and no other group giving fewer waves
    times (G + SSD_BLOCK_START) heads' time."""
    r = ops.ssd_route(BC, 128, nh, 64, 64, sms)
    assert r.route == "grouped" and 1 <= r.group <= min(ops.SSD_MAX_GROUP, nh)
    assert r.blocks == BC * -(-nh // r.group)

    def cost(G):
        return -(-(BC * -(-nh // G)) // sms) * (G + ops.SSD_BLOCK_START)

    assert all(cost(r.group) <= cost(G)
               for G in range(1, min(ops.SSD_MAX_GROUP, nh) + 1))


def test_ssd_max_group_is_the_kernels():
    """ops.SSD_MAX_GROUP is the cap the CUDA side checks (kMaxGroup)."""
    src = (Path(ops.__file__).parent / "csrc" / "ssd_chunk.cu").read_text()
    cap = re.search(r"constexpr int kMaxGroup = (\d+);", src)
    assert cap and int(cap.group(1)) == ops.SSD_MAX_GROUP


@pytest.mark.parametrize("args", [(0, 128, 80, 64, 64, 132),
                                  (4, 128, 0, 64, 64, 132),
                                  (4, 128, 80, 64, 64, 0)])
def test_ssd_route_rejects_empty(args):
    with pytest.raises(ValueError, match="ssd_route"):
        ops.ssd_route(*args)
