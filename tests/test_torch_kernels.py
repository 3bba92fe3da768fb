"""The port's kernel plain versions against the JAX package's oracles
(``repro.kernels.ref``), and the wrappers' CPU route.  The CUDA kernels are
held against these plain versions on a card by tests/test_torch_gpu.py.

Inputs are drawn with numpy and handed to both sides.  fp32 cases hold the
plain versions to the oracles within 1e-5 (the same math, summed in another
order); integer outputs must match bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

FP32 = dict(rtol=1e-5, atol=1e-5)
# bf16 keeps 8 significant bits (relative spacing 2**-8 ~ 0.4%); outputs here
# are of unit scale and the two sides round intermediates at different
# places (the JAX combine oracle multiplies and sums in bf16, the port
# accumulates in fp32), so a few bf16 ulps of a unit-scale value
BF16 = dict(rtol=2e-2, atol=2e-2)


def _both(a, dtype):
    """One numpy array as a JAX array and a torch tensor of ``dtype``."""
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _np(t):
    return (np.asarray(jnp.asarray(t).astype(jnp.float32))
            if isinstance(t, jax.Array) else t.float().numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act,glu", [("silu", True), ("gelu", True),
                                     ("gelu", False)])
def test_grouped_ffn_ref_matches_oracle(dtype, act, glu):
    rng = np.random.default_rng(0)
    G, T, d, f = 3, 5, 32, 48
    x = rng.standard_normal((G, T, d)).astype(np.float32)
    w1 = (rng.standard_normal((G, d, f)) / np.sqrt(d)).astype(np.float32)
    w3 = (rng.standard_normal((G, d, f)) / np.sqrt(d)).astype(np.float32)
    w2 = (rng.standard_normal((G, f, d)) / np.sqrt(f)).astype(np.float32)
    (jx, tx), (j1, t1), (j3, t3), (j2, t2) = (_both(a, dtype)
                                              for a in (x, w1, w3, w2))
    want = jref.grouped_ffn_ref(jx, j1, j3 if glu else None, j2, act=act)
    got = ref.grouped_ffn_ref(tx, t1, t3 if glu else None, t2, act=act)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(want),
                               **(FP32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,R", [(7, 20), (16, 64), (1, 3)])
def test_dispatch_gather_ref_matches_oracle(dtype, T, R):
    rng = np.random.default_rng(T * 100 + R)
    x = rng.standard_normal((T, 24)).astype(np.float32)
    src = rng.integers(-1, T, R).astype(np.int32)
    jx, tx = _both(x, dtype)
    want = jref.dispatch_gather_ref(jx, jnp.asarray(src))
    got = ref.dispatch_gather_ref(tx, torch.from_numpy(src))
    # a pure copy: exact in either dtype
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,k,R", [(9, 1, 20), (16, 2, 40), (5, 4, 12)])
def test_combine_gather_ref_matches_oracle(dtype, t, k, R):
    rng = np.random.default_rng(t * 100 + k)
    rows = rng.standard_normal((R, 32)).astype(np.float32)
    src = rng.integers(-1, R, (t, k)).astype(np.int32)
    scale = rng.random((t, k)).astype(np.float32)
    jr, tr = _both(rows, dtype)
    want = jref.combine_gather_ref(jr, jnp.asarray(src), jnp.asarray(scale))
    got = ref.combine_gather_ref(tr, torch.from_numpy(src),
                                 torch.from_numpy(scale))
    assert got.dtype == tr.dtype
    np.testing.assert_allclose(_np(got), _np(want),
                               **(FP32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("A,num_keys", [(0, 3), (1, 1), (37, 5), (1000, 17),
                                        (4096, 129)])
def test_group_sort_ref_bit_exact(A, num_keys):
    rng = np.random.default_rng(A + num_keys)
    keys = rng.integers(0, num_keys, A).astype(np.int32)
    jr, js = jref.group_sort_ref(jnp.asarray(keys), num_keys)
    tr, ts = ref.group_sort_ref(torch.from_numpy(keys), num_keys)
    assert tr.dtype == ts.dtype == torch.int32
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_group_sort_impls():
    keys = torch.tensor([2, 0, 2, 1], dtype=torch.int32)
    r, s = ops.group_sort(keys, 3)
    assert r.tolist() == [2, 0, 3, 1] and s.tolist() == [0, 1, 2, 4]
    with pytest.raises(NotImplementedError, match="not ported"):
        ops.group_sort(keys, 3, impl="radix")
    with pytest.raises(ValueError):
        ops.group_sort(keys, 3, impl="bogus")


def test_wrappers_on_cpu_take_plain_path_without_launches():
    """A CUDA-only wrapper given CPU tensors runs the plain version and
    counts no launch."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((6, 16)).astype(np.float32))
    src = torch.tensor([0, -1, 5, 2], dtype=torch.int32)
    rows = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))
    csrc = torch.tensor([[0, 7], [-1, 3]], dtype=torch.int32)
    scale = torch.tensor([[0.5, 0.25], [1.0, 2.0]])
    xg = torch.from_numpy(rng.standard_normal((2, 3, 16)).astype(np.float32))
    w1 = torch.from_numpy(rng.standard_normal((2, 16, 8)).astype(np.float32))
    w2 = torch.from_numpy(rng.standard_normal((2, 8, 16)).astype(np.float32))
    before = ops.launch_counts()
    assert torch.equal(ops.dispatch_gather(x, src),
                       ref.dispatch_gather_ref(x, src))
    assert torch.equal(ops.combine_gather(rows, csrc, scale),
                       ref.combine_gather_ref(rows, csrc, scale))
    assert torch.equal(ops.grouped_ffn(xg, w1, None, w2, act="gelu"),
                       ref.grouped_ffn_ref(xg, w1, None, w2, act="gelu"))
    assert ops.launch_counts() == before
    assert set(before) == {"dispatch_gather", "grouped_ffn",
                           "combine_gather"}


def test_wrappers_reject_mixed_devices():
    x = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="devices"):
        ops.dispatch_gather(x, torch.zeros((2,), dtype=torch.int32,
                                           device="meta"))


def test_grouped_ffn_rejects_weights_of_another_dtype():
    """The model casts its expert weights once at load, so the wrapper
    takes weights only in x's dtype and casts nothing itself."""
    x = torch.zeros((2, 3, 16), dtype=torch.bfloat16)
    w1 = torch.zeros((2, 16, 8))
    w2 = torch.zeros((2, 8, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="dtype"):
        ops.grouped_ffn(x, w1, None, w2, act="gelu")
