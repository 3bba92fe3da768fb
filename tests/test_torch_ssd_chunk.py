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
before exp).
"""
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


@pytest.mark.parametrize("loga_range", [(-0.5, 0.0), (-8.0, -5.0)],
                         ids=["mild", "strongly-negative"])
@pytest.mark.parametrize("B,nc,Q,nh,hd,ds", [(1, 1, 4, 1, 4, 4),
                                             (2, 3, 16, 2, 8, 4),
                                             (1, 2, 128, 2, 16, 8)])
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
