"""The port's counting sort, ``ops.group_sort(impl="radix")``, against the
JAX package's oracle ``repro.kernels.ref.group_sort_ref``: exact, over
fixed cases and a hypothesis search of lengths, domains and skew.  On the
CPU the wrapper runs its plain version; the CUDA kernel is held against the
same plain version on the card (``tests/test_torch_gpu.py``).

The kernel's block layout is Python (``ops._sort_blocks``), and its three
phases (per-block histogram, key-major exclusive scan, in-order ranks) are
emulated here in numpy over that layout, so the algorithm the card runs is
checked against the oracle too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

from repro.kernels import ref as jref
from repro_torch.kernels import ops
import torch


def _check(keys: np.ndarray, K: int):
    jr, js = jref.group_sort_ref(jnp.asarray(keys), K)
    tr, ts = ops.group_sort(torch.from_numpy(keys), K, impl="radix")
    assert tr.dtype == ts.dtype == torch.int32
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    return np.asarray(jr), np.asarray(js)


def _emulate_kernel(keys: np.ndarray, K: int):
    """group_sort.cuh's three phases over ops._sort_blocks' layout."""
    A = keys.shape[0]
    nb, chunk = ops._sort_blocks(A, K)
    counts = np.zeros((K, nb), np.int64)             # key-major, block-minor
    for b in range(nb):
        counts[:, b] = np.bincount(keys[b * chunk:(b + 1) * chunk],
                                   minlength=K)
    flat = counts.reshape(-1)
    base = (np.cumsum(flat) - flat).reshape(K, nb)
    starts = np.append(base[:, 0], A)
    ranks = np.empty(A, np.int64)
    for b in range(nb):
        run = base[:, b].copy()
        for a in range(b * chunk, min((b + 1) * chunk, A)):
            ranks[a] = run[keys[a]]
            run[keys[a]] += 1
    return ranks, starts


@pytest.mark.parametrize("A,K", [(0, 3), (1, 1), (5, 3), (255, 2),
                                 (256, 17), (2048, 17), (4096, 129),
                                 (3001, 4096)])
def test_group_sort_radix_matches_jax(A, K):
    rng = np.random.default_rng(A + K)
    keys = rng.integers(0, K, A).astype(np.int32)
    _check(keys, K)


@given(A=st.integers(0, 3000), K=st.integers(1, 300),
       hot=st.floats(0.0, 1.0), seed=st.integers(0, 2 ** 31 - 1))
@settings(max_examples=25, deadline=None)
def test_group_sort_radix_property(A, K, hot, seed):
    """Any length and domain; a share ``hot`` of the keys on one value."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, K, A)
    keys = np.where(rng.random(A) < hot, K // 2, keys).astype(np.int32)
    _check(keys, K)


@pytest.mark.parametrize("A,K", [(1, 1), (700, 5), (2048, 17),
                                 (4096, 129), (70001, 257)])
def test_kernel_phases_match_oracle(A, K):
    rng = np.random.default_rng(A * K)
    keys = rng.integers(0, K, A)
    keys = np.where(rng.random(A) < 0.3, K - 1, keys).astype(np.int32)
    want_r, want_s = _check(keys, K)
    got_r, got_s = _emulate_kernel(keys, K)
    np.testing.assert_array_equal(got_r, want_r)
    np.testing.assert_array_equal(got_s, want_s)


@pytest.mark.parametrize("A,K", [(1, 1), (2048, 17), (4096, 129),
                                 (1 << 20, 129), (1 << 20, 8192),
                                 (2 ** 31 - 1, 4096)])
def test_sort_blocks_layout(A, K):
    nb, chunk = ops._sort_blocks(A, K)
    assert chunk % ops.SORT_TILE == 0
    assert (nb - 1) * chunk < A <= nb * chunk          # no empty block
    assert 1 <= nb <= ops.SORT_MAX_BLOCKS
    assert nb * K <= max(K, ops.SORT_MAX_COUNTERS)
    assert chunk < 2 ** 31


def test_group_sort_rejects_bad_args():
    keys = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(ValueError, match="num_keys"):
        ops.group_sort(keys, 0, impl="radix")
    with pytest.raises(ValueError, match="sort_impl"):
        ops.group_sort(keys, 3, impl="bitonic")
