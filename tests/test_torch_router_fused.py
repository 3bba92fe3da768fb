"""The port's fused router (``ops.router_fused``, on the CPU its plain
version) against the JAX package's oracle ``repro.kernels.ref
.router_fused_ref``, on numpy-drawn inputs.

Integer outputs (ids, ranks, starts) must match exactly, including under
deliberate ties (bf16-rounded inputs with duplicated expert columns, where
the lowest index must win); probs and logits within rtol 1e-6 / atol 1e-6
(the same fp32 GEMM over d=32, summed in another order: a few ulps of the
O(1) partial sums, observed up to 2.8e-7, where a logit near 0 makes the
relative error large).  The gradient
(the VJP of the plain chain, a ``torch.autograd.Function``) against
``jax.vjp`` of the oracle within rtol 1e-5 / atol 1e-5 (gradients of
magnitude up to ~20 summed with cancellation over the experts).  The oracle is called directly:
rows stay under 1,024, where the JAX package's wrapper takes it too.

The CUDA kernel itself is held against the same plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.core import moe as TM
from repro_torch.kernels import ops

T_ROWS, D = 200, 32
FTOL = dict(rtol=1e-6, atol=1e-6)


def _case(E, dist, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T_ROWS, D)).astype(np.float32)
    w = (rng.standard_normal((D, E)) / np.sqrt(D)).astype(np.float32)
    if dist == "bf16_ties":
        # bf16-rounded values, every odd expert a copy of the even one
        # before it: exact logit ties on every row
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
        w = np.array(jnp.asarray(w, jnp.bfloat16).astype(jnp.float32))
        w[:, 1::2] = w[:, 0::2][:, :E // 2]
    return x, w


CASES = [(E, k, renorm, dist)
         for E in (2, 8, 16, 128) for k in (1, 2, 8) if k <= E
         for renorm in (False, True) for dist in ("normal", "bf16_ties")]


@pytest.mark.parametrize("E,k,renorm,dist", CASES)
def test_router_fused_matches_jax_oracle(E, k, renorm, dist):
    x, w = _case(E, dist, seed=E * 10 + k)
    jout = jref.router_fused_ref(jnp.asarray(x), jnp.asarray(w), k,
                                 renorm=renorm)
    tout = ops.router_fused(torch.from_numpy(x), torch.from_numpy(w), k,
                            renorm=renorm)
    names = ("gates", "idx", "probs", "logits", "ranks", "starts")
    for name, a, b in zip(names, tout, jout):
        b = np.asarray(b)
        if name in ("idx", "ranks", "starts"):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
        else:
            np.testing.assert_allclose(a.numpy(), b, **FTOL, err_msg=name)
    if dist == "bf16_ties":
        # the lowest index of each tied pair wins: an odd id only ever
        # follows its even twin
        idx = tout[1].numpy()
        first_odd = (idx[:, 0] % 2) == 1
        assert not first_odd.any()


@pytest.mark.parametrize("E,k,renorm", [(8, 2, True), (16, 1, False),
                                        (128, 8, True), (2, 2, False)])
def test_router_fused_grad_matches_jax_vjp(E, k, renorm):
    x, w = _case(E, "normal", seed=E + k)
    rng = np.random.default_rng(99)
    cts = [rng.standard_normal(s).astype(np.float32)
           for s in ((T_ROWS, k), (T_ROWS, E), (T_ROWS, E))]

    def floats(xx, ww):
        g, _, p, l, _, _ = jref.router_fused_ref(xx, ww, k, renorm=renorm)
        return g, p, l

    _, vjp = jax.vjp(floats, jnp.asarray(x), jnp.asarray(w))
    jgx, jgw = vjp(tuple(jnp.asarray(c) for c in cts))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    g, _, p, l, _, _ = ops.router_fused(tx, tw, k, renorm=renorm)
    sum((o * torch.from_numpy(c)).sum()
        for o, c in zip((g, p, l), cts)).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), rtol=1e-5,
                               atol=1e-5)


def test_router_fused_grad_through_gates_only():
    """Outputs with no gradient flowing (probs, logits unused) are fine,
    and the integer outputs carry none."""
    x, w = _case(8, "normal", seed=3)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = ops.router_fused(tx, torch.from_numpy(w), 2)
    assert not any(t.requires_grad for t in (out[1], out[4], out[5]))
    out[0].sum().backward()
    assert tx.grad is not None and torch.isfinite(tx.grad).all()


@pytest.mark.parametrize("E,k,renorm,dist", [(8, 2, True, "bf16_ties"),
                                             (16, 1, False, "normal"),
                                             (128, 8, True, "normal"),
                                             (2, 1, False, "bf16_ties")])
def test_router_topk_fused_equals_unfused(E, k, renorm, dist):
    x, w = _case(E, dist, seed=7 * E + k)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    fused = TM.router_topk(tx, tw, k, renorm, impl="fused")
    unfused = TM.router_topk(tx, tw, k, renorm, impl="unfused")
    for a, b in zip(fused, unfused):
        assert torch.equal(a, b)


def test_router_fused_rejects_bad_k():
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="top-k"):
        ops.router_fused(x, torch.zeros((8, 3)), 4)
    with pytest.raises(ValueError, match="unknown router_impl"):
        TM.router_topk(x, torch.zeros((8, 3)), 1, False, impl="bogus")
