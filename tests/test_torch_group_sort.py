"""The port's counting sort, ``ops.group_sort(impl="radix")``, against the
JAX package's oracle ``repro.kernels.ref.group_sort_ref``: exact, over
fixed cases and a hypothesis search of lengths, domains and skew.  On the
CPU the wrapper runs its plain version; the CUDA kernel is held against the
same plain version on the card (``tests/test_torch_gpu.py``).

The kernel's route and layout are Python (``ops.sort_route``: one launch
of one block, or three over ``ops._sort_blocks``' blocks),
and both routes' phases are emulated here in numpy over that layout, so
the algorithm the card runs is checked against the oracle too.
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


def _emulate_three(keys: np.ndarray, K: int):
    """group_sort.cuh's three launches over ops._sort_blocks' layout."""
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


def _emulate_one(keys: np.ndarray, K: int):
    """group_sort.cuh's one_launch_kernel over ops.sort_route's layout:
    each warp's rank in its segment, the per-(warp, key) prefix over the
    warps, one scan over the keys."""
    A = keys.shape[0]
    route = ops.sort_route(A, K)
    assert route.launches == 1
    W, seg = route.warps, route.steps * 32
    hist = np.zeros((W, K), np.int64)
    within = np.empty(A, np.int64)
    for w in range(W):
        for a in range(w * seg, min((w + 1) * seg, A)):   # 1. in one pass
            within[a] = hist[w, keys[a]]
            hist[w, keys[a]] += 1
    warp_pre = np.cumsum(hist, axis=0) - hist        # 2. over the warps
    tot = hist.sum(axis=0)
    base = np.cumsum(tot) - tot                      # 3. over the keys
    ranks = np.empty(A, np.int64)
    for a in range(A):                               # 4.
        w = a // seg
        ranks[a] = base[keys[a]] + warp_pre[w, keys[a]] + within[a]
    return ranks, np.append(base, A)


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
                                 (4096, 129), (70001, 257), (16385, 3),
                                 (40000, 1024), (3000, 1025),
                                 (4096, 1024), (3001, 129)])
def test_kernel_phases_match_oracle(A, K):
    """The route ops.sort_route picks, emulated, against the oracle; the
    three-launch route at every shape too."""
    rng = np.random.default_rng(A * K)
    keys = rng.integers(0, K, A)
    keys = np.where(rng.random(A) < 0.3, K - 1, keys).astype(np.int32)
    want_r, want_s = _check(keys, K)
    emulations = [_emulate_three]
    if ops.sort_route(A, K).launches == 1:
        emulations.append(_emulate_one)
    for emulate in emulations:
        got_r, got_s = emulate(keys, K)
        np.testing.assert_array_equal(got_r, want_r)
        np.testing.assert_array_equal(got_s, want_s)


@pytest.mark.parametrize("A,K,want", [
    # the training path's sorts: one block, 8 keys a lane
    (2048, 17, (1, 1, 8, 8, 0)),
    (4096, 129, (1, 1, 16, 8, 0)),
    # few keys: as few warps as hold them at 8 keys a lane
    (1, 1, (1, 1, 1, 1, 0)),
    (257, 3, (1, 1, 2, 5, 0)),
    (3000, 129, (1, 1, 16, 6, 0)),
    # the edge: a block holds 4,096 keys (16 warps x 32 lanes x 8); one key
    # more, or one key value more than 1,024, takes three launches
    (4096, 17, (1, 1, 16, 8, 0)),
    (4096, 1024, (1, 1, 16, 8, 0)),
    (4097, 17, (3,)),
    (4096, 1025, (3,)),
    (8192, 3, (3,)),
    (16384, 17, (3,)),
    (131072, 17, (3,)),
    (2048, 1025, (3,)),
    (1 << 20, 129, (3,)),
    (3000, 8192, (3,)),
])
def test_sort_route(A, K, want):
    route = ops.sort_route(A, K)
    assert tuple(route)[:len(want)] == want
    if route.launches == 1:
        W, steps = route.warps, route.steps
        assert route.blocks == 1 and route.chunk == 0
        assert W & (W - 1) == 0 and 1 <= W <= ops.SORT_ONE_MAX_WARPS
        assert 1 <= steps <= ops.SORT_ONE_STEPS
        assert (steps - 1) * W * 32 < A <= steps * W * 32  # fewest steps
        assert A <= ops.SORT_ONE_MAX_A and K <= ops.SORT_ONE_MAX_KEYS
    else:
        assert (route.blocks, route.chunk) == ops._sort_blocks(A, K)
        assert route.warps == ops.SORT_TILE // 32


def test_sort_route_rejects_no_keys():
    with pytest.raises(ValueError, match="A must be >= 1"):
        ops.sort_route(0, 3)


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
