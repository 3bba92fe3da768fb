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


def _ragged_case(G, block, seed, tail_tiles=0):
    """A tile-aligned ragged layout: rows sorted by group, zeros in the
    padding of each segment and in ``tail_tiles`` tiles past the last."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 3 * block, G)
    lens[rng.random(G) < 0.25] = 0                 # groups with no rows
    aligned = -(-lens // block) * block
    starts = np.concatenate([[0], np.cumsum(aligned)]).astype(np.int32)
    R = int(starts[-1]) + tail_tiles * block
    rows = np.zeros((R, 32), np.float32)
    for g in range(G):
        rows[starts[g]:starts[g] + lens[g]] = rng.standard_normal((lens[g], 32))
    return rows, starts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act,glu", [("silu", True), ("gelu", True),
                                     ("gelu", False)])
@pytest.mark.parametrize("G,block,tail", [(1, 8, 0), (5, 8, 3), (3, 16, 1),
                                          (12, 8, 0)])
def test_grouped_ffn_ragged_ref_matches_oracle(dtype, act, glu, G, block,
                                               tail):
    rows, starts = _ragged_case(G, block, seed=G + block, tail_tiles=tail)
    rng = np.random.default_rng(1)
    d, f = 32, 48
    w1 = (rng.standard_normal((G, d, f)) / np.sqrt(d)).astype(np.float32)
    w3 = (rng.standard_normal((G, d, f)) / np.sqrt(d)).astype(np.float32)
    w2 = (rng.standard_normal((G, f, d)) / np.sqrt(f)).astype(np.float32)
    (jx, tx), (j1, t1), (j3, t3), (j2, t2) = (_both(a, dtype)
                                              for a in (rows, w1, w3, w2))
    want = jref.grouped_ffn_ragged_ref(jx, jnp.asarray(starts), j1,
                                       j3 if glu else None, j2, act=act)
    got = ref.grouped_ffn_ragged_ref(tx, torch.from_numpy(starts), t1,
                                     t3 if glu else None, t2, act=act)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(_np(got), _np(want),
                               **(FP32 if dtype == "float32" else BF16))
    # the wrapper's CPU route is the plain version, with no launch
    n = ops.grouped_ffn_ragged.launches
    assert torch.equal(ops.grouped_ffn_ragged(tx, torch.from_numpy(starts), t1,
                                              t3 if glu else None, t2,
                                              block=block, act=act), got)
    assert ops.grouped_ffn_ragged.launches == n


def test_grouped_ffn_ragged_ref_edges():
    """Rows before group_starts[1] belong to group 0 and rows from
    group_starts[G-1] on to group G-1 (the oracle's clipped searchsorted);
    R = 0 gives an empty result."""
    rng = np.random.default_rng(2)
    G, d, f = 3, 16, 32
    w1 = (rng.standard_normal((G, d, f)) / 4).astype(np.float32)
    w2 = (rng.standard_normal((G, f, d)) / 4).astype(np.float32)
    rows = rng.standard_normal((24, d)).astype(np.float32)
    for starts in ([0, 8, 8, 16], [0, 0, 0, 0], [0, 24, 24, 24],
                   [0, 8, 16, 20]):
        st = np.array(starts, np.int32)
        want = jref.grouped_ffn_ragged_ref(jnp.asarray(rows), jnp.asarray(st),
                                           jnp.asarray(w1), None,
                                           jnp.asarray(w2), act="silu")
        got = ref.grouped_ffn_ragged_ref(
            torch.from_numpy(rows), torch.from_numpy(st),
            torch.from_numpy(w1), None, torch.from_numpy(w2), act="silu")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)
    empty = ref.grouped_ffn_ragged_ref(
        torch.zeros((0, d)), torch.zeros((G + 1,), dtype=torch.int32),
        torch.from_numpy(w1), None, torch.from_numpy(w2))
    assert empty.shape == (0, d)


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
    # radix on a CPU tensor: the plain version, the same bits
    r2, s2 = ops.group_sort(keys, 3, impl="radix")
    assert torch.equal(r2, r) and torch.equal(s2, s)
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
    wr = torch.from_numpy(rng.standard_normal((16, 4)).astype(np.float32))
    for a, b in zip(ops.router_fused(x, wr, 2),
                    ref.router_fused_ref(x, wr, 2)):
        assert torch.equal(a, b)
    keys = torch.tensor([3, 1, 3, 0], dtype=torch.int32)
    for a, b in zip(ops.group_sort(keys, 4, impl="radix"),
                    ref.group_sort_ref(keys, 4)):
        assert torch.equal(a, b)
    xr = torch.from_numpy(rng.standard_normal((16, 16)).astype(np.float32))
    gs = torch.tensor([0, 8, 16], dtype=torch.int32)
    assert torch.equal(
        ops.grouped_ffn_ragged(xr, gs, w1, None, w2, block=8, act="gelu"),
        ref.grouped_ffn_ragged_ref(xr, gs, w1, None, w2, act="gelu"))
    q = torch.from_numpy(rng.standard_normal((1, 4, 2, 8)).astype(np.float32))
    assert torch.equal(ops.flash_attention(q, q[:, :, :1], q[:, :, :1]),
                       ref.flash_attention_ref(q, *(q[:, :, :1].expand(
                           -1, -1, 2, -1),) * 2))
    r = torch.from_numpy(rng.random((1, 3, 1, 4)).astype(np.float32))
    s0 = torch.zeros((1, 1, 4, 4))
    for a, b in zip(ops.rwkv6_scan(r, r, r, r, r[0, 0], s0),
                    ref.rwkv6_scan_ref(r, r, r, r, r[0, 0], s0)):
        assert torch.equal(a, b)
    xs = torch.from_numpy(rng.standard_normal((1, 1, 4, 1, 4)).astype(
        np.float32))
    dl = -torch.from_numpy(rng.random((1, 1, 4, 1)).astype(np.float32))
    bcs = xs[:, :, :, 0]
    for a, b in zip(ops.ssd_chunk(xs, -dl, dl, bcs, bcs),
                    ref.ssd_chunk_ref(xs, -dl, dl, bcs, bcs)):
        assert torch.equal(a, b)
    assert ops.launch_counts() == before
    assert set(before) == {"dispatch_gather", "grouped_ffn",
                           "combine_gather", "router_fused", "group_sort",
                           "grouped_ffn_ragged", "flash_attention",
                           "rwkv6_scan", "ssd_chunk"}


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
    with pytest.raises(ValueError, match="dtype"):
        ops.grouped_ffn_ragged(x[0], torch.tensor([0, 3, 3], dtype=torch.int32),
                               w1, None, w2, block=8, act="gelu")
