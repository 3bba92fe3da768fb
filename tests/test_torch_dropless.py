"""The dropless backend of the port against the JAX package: the
tile-aligned ragged layout, dispatch_ragged -> experts_ffn_ragged ->
combine, the compact FFNs, the dense oracle backend, the single-rank comm
helpers and the single-rank ragged hop.

Inputs and parameters are drawn with numpy and handed to both sides.
Integer layouts (rows, offsets, counts, tile ids, the sanitized count grid)
must match bit for bit; float outputs within 1e-5 in fp32 (the same fp32
math, summed in another order).  The JAX side runs ``use_kernel=False``
(Pallas does not run on this JAX); the port's ``use_kernel=True`` path runs
the kernels' plain versions on the CPU, held against JAX's
``grouped_ffn_ragged_ref`` on the same layout.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch as JD
from repro.core import pipeline as JP
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.sharding import comm as jcomm
from repro_torch.core import dispatch as TD
from repro_torch.core import pipeline as TP
from repro_torch.kernels import ops as tops
from repro_torch.sharding import comm as tcomm

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _jax_sort_oracle(monkeypatch):
    # the JAX radix sort is a Pallas kernel; below RADIX_MIN_ROWS it takes
    # its bit-identical oracle
    monkeypatch.setattr(jops, "RADIX_MIN_ROWS", 1 << 30)


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _draw(A, G, p_valid, seed, sentinel=False):
    rng = np.random.default_rng(seed)
    gid = rng.integers(0, G, A).astype(np.int32)
    if sentinel and A:
        # a few ids equal to G on invalid assignments (the key every invalid
        # assignment sorts under)
        gid[rng.random(A) < 0.2] = G
    valid = (rng.random(A) < p_valid) & (gid < G)
    return gid, valid


# --------------------------------------------------------------------- layout
# (A, G, p_valid): empty, all invalid, one group, skewed, many groups
LAYOUTS = [(0, 3, 1.0), (40, 5, 0.0), (37, 1, 0.9), (64, 4, 1.0),
           (200, 16, 0.7), (1000, 128, 0.95)]


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("A,G", [(0, 3), (7, 1), (100, 4), (4096, 16),
                                 (10240, 128), (320, 128), (1 << 15, 8),
                                 (64, 64)])
def test_ragged_block_and_rows_match(A, G, use_kernel):
    blk = TD._ragged_block(A, G, None, use_kernel)
    assert blk == JD._ragged_block(A, G, None, use_kernel)
    assert TD._ragged_block(A, G, 24, use_kernel) == 24
    assert TD.ragged_rows(A, G, blk) == JD.ragged_rows(A, G, blk)


def test_ragged_block_serving_shapes():
    """The row tiles and row counts the dropless serve runs at (qwen3-moe,
    grid (16, 8), batch 8 x prompt 128, top-8 over top_g=4)."""
    assert TD._ragged_block(4096, 16, None, True) == 64
    assert TD.ragged_rows(4096, 16, 64) == 5120          # prefill hop 1
    assert TD._ragged_block(10240, 128, None, True) == 64
    assert TD.ragged_rows(10240, 128, 64) == 18432       # prefill hop 2
    assert TD._ragged_block(320, 128, None, True) == 8
    assert TD.ragged_rows(320, 128, 8) == 1344           # decode hop 2


@pytest.mark.parametrize("sort_impl", ["argsort", "radix"])
@pytest.mark.parametrize("block", [8, 64])
@pytest.mark.parametrize("A,G,p_valid", LAYOUTS)
def test_ragged_positions_bit_exact(A, G, p_valid, block, sort_impl):
    gid, valid = _draw(A, G, p_valid, seed=A + G, sentinel=True)
    want = JD.ragged_positions(jnp.asarray(gid), jnp.asarray(valid), G,
                               block, sort_impl=sort_impl)
    got = TD.ragged_positions(torch.from_numpy(gid), torch.from_numpy(valid),
                              G, block, sort_impl=sort_impl)
    for t, j in zip(got, want):
        assert t.dtype == torch.int32
        _eq(t, j)
    _eq(TD.ragged_seg_lens(torch.from_numpy(gid), torch.from_numpy(valid), G),
        JD.ragged_seg_lens(jnp.asarray(gid), jnp.asarray(valid), G))
    starts = got[1]
    R = got[2].shape[0]
    for n_tiles in (R // block, R // block + 3):
        _eq(TD.ragged_tile_gids(starts, n_tiles, block),
            JD.ragged_tile_gids(jnp.asarray(starts.numpy()), n_tiles, block))


def test_ragged_seg_lens_drops_ids_outside():
    """Ids equal to G (and valid) count nowhere, as JAX's drop mode."""
    gid = np.array([0, 3, 1, 3, 2], np.int32)
    valid = np.array([True, True, False, True, True])
    _eq(TD.ragged_seg_lens(torch.from_numpy(gid), torch.from_numpy(valid), 3),
        JD.ragged_seg_lens(jnp.asarray(gid), jnp.asarray(valid), 3))


@pytest.mark.parametrize("P,nl,block,recv_rows", [(1, 4, 8, 96), (1, 1, 64, 64),
                                                  (2, 3, 8, 200),
                                                  (4, 2, 16, 300)])
def test_ragged_counts_and_recv_layout_bit_exact(P, nl, block, recv_rows):
    rng = np.random.default_rng(P * 10 + nl)
    grid = rng.integers(0, 3 * block, (P, nl)).astype(np.int32)
    grid[0, -1] = 0                                      # an empty segment
    for t, j in zip(TD.ragged_recv_layout(torch.from_numpy(grid), block,
                                          recv_rows),
                    JD.ragged_recv_layout(jnp.asarray(grid), block,
                                          recv_rows)):
        _eq(t, j)
    aligned = ((grid + block - 1) // block) * block
    starts = np.concatenate([[0], np.cumsum(aligned.reshape(-1))]).astype(
        np.int32)
    _eq(TD.ragged_send_counts(torch.from_numpy(starts), nl),
        JD.ragged_send_counts(jnp.asarray(starts), nl))
    for t, j in zip(TD.ragged_row_membership(torch.from_numpy(starts),
                                             torch.from_numpy(grid.reshape(-1)),
                                             recv_rows),
                    JD.ragged_row_membership(jnp.asarray(starts),
                                             jnp.asarray(grid.reshape(-1)),
                                             recv_rows)):
        _eq(t, j)


@pytest.mark.parametrize("case", ["healthy", "negative", "over", "both"])
def test_sanitize_len_grid_bit_exact(case):
    block, src_rows = 8, 64
    grid = np.array([[3, 9, 0, 16], [8, 8, 8, 8], [1, 2, 3, 4]], np.int32)
    if case in ("negative", "both"):
        grid[2, 1] = -5
    if case in ("over", "both"):
        grid[1, 3] = 41                          # source 1 past its 64 rows
    want = JP.sanitize_len_grid(jnp.asarray(grid), block, src_rows)
    got = TP.sanitize_len_grid(torch.from_numpy(grid), block, src_rows)
    _eq(got[0], want[0])
    assert float(got[1]) == float(want[1])
    _eq(got[2], want[2])
    assert float(got[1]) == {"healthy": 0, "negative": 1, "over": 1,
                             "both": 2}[case]
    for args in [(2.0, 5120, 4, 4, 64), (1.0, 100, 2, 3, 8),
                 (8.0, 64, 2, 1, 8)]:
        assert TP.recv_bound_rows(*args) == JP.recv_bound_rows(*args)


# ------------------------------------------------ dispatch -> FFN -> combine
def _ffn_weights(rng, G, d, f):
    w = {"w1": rng.standard_normal((G, d, f)) / np.sqrt(d),
         "w3": rng.standard_normal((G, d, f)) / np.sqrt(d),
         "w2": rng.standard_normal((G, f, d)) / np.sqrt(f)}
    return {k: v.astype(np.float32) for k, v in w.items()}


@pytest.mark.parametrize("glu,act", [(True, "silu"), (False, "gelu")])
@pytest.mark.parametrize("sort_impl", ["argsort", "radix"])
@pytest.mark.parametrize("t,k,G,p_valid", [(0, 2, 3, 1.0), (20, 2, 4, 0.0),
                                           (30, 1, 1, 0.9), (48, 2, 4, 0.8),
                                           (64, 4, 16, 1.0)])
def test_dispatch_ragged_ffn_combine_match(t, k, G, p_valid, sort_impl, glu,
                                           act):
    rng = np.random.default_rng(t * 7 + G)
    d, f = 16, 24
    A = t * k
    gid, valid = _draw(A, G, p_valid, seed=t + k)
    x = rng.standard_normal((t, d)).astype(np.float32)
    gates = rng.random(A).astype(np.float32)
    w = _ffn_weights(rng, G, d, f)
    if not glu:
        del w["w3"]
    jrows, jstarts, jst = JD.dispatch_ragged(
        jnp.asarray(x), jnp.asarray(gid), jnp.asarray(gates), G, k=k,
        valid=jnp.asarray(valid), sort_impl=sort_impl)
    trows, tstarts, tst = TD.dispatch_ragged(
        torch.from_numpy(x), torch.from_numpy(gid), torch.from_numpy(gates),
        G, k=k, valid=torch.from_numpy(valid), sort_impl=sort_impl)
    _eq(trows, jrows)                                    # a gather: exact
    _eq(tstarts, jstarts)
    for name in ("pos", "keep", "slot_assign"):
        _eq(getattr(tst, name), getattr(jst, name))
    assert tst.cap == jst.cap and tst.backend == "dropless"
    _eq(TD.dispatch_flags(torch.ones(A), tst),
        JD.dispatch_flags(jnp.ones(A), jst))

    jw = {n: jnp.asarray(v) for n, v in w.items()}
    tw = {n: torch.from_numpy(v) for n, v in w.items()}
    jy = JP.experts_ffn_ragged(jw, jrows, jstarts, act, block=jst.cap)
    ty = TP.experts_ffn_ragged(tw, trows, tstarts, act, block=tst.cap)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(TD.combine(ty, tst).numpy(),
                               np.asarray(JD.combine(jy, jst)), **TOL)

    # the port's kernel path (its own row tile, the kernel's cap of 128)
    # against JAX's ragged oracle on the same layout
    krows, kstarts, kst = TD.dispatch_ragged(
        torch.from_numpy(x), torch.from_numpy(gid), torch.from_numpy(gates),
        G, k=k, valid=torch.from_numpy(valid), use_kernel=True,
        sort_impl=sort_impl)
    before = tops.launch_counts()
    ky = TP.experts_ffn_ragged(tw, krows, kstarts, act, block=kst.cap,
                               use_kernel=True)
    want = jref.grouped_ffn_ragged_ref(
        jnp.asarray(krows.numpy()), jnp.asarray(kstarts.numpy()), jw["w1"],
        jw.get("w3"), jw["w2"], act=act)
    np.testing.assert_allclose(ky.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(TD.combine(ky, kst).numpy(),
                               np.asarray(JD.combine(jy, jst)), **TOL)
    assert tops.launch_counts() == before           # CPU: plain versions


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("G,S,p_valid", [(4, 10, 0.6), (1, 7, 1.0),
                                         (8, 5, 0.0)])
def test_compact_ffns_match(G, S, p_valid, use_kernel):
    rng = np.random.default_rng(G * S)
    d, f = 16, 32
    recv = rng.standard_normal((G, S, d)).astype(np.float32)
    valid = rng.random((G, S)) < p_valid
    recv = recv * valid[..., None]                 # empty slots are zeros
    w = _ffn_weights(rng, G, d, f)
    jw = {n: jnp.asarray(v) for n, v in w.items()}
    tw = {n: torch.from_numpy(v) for n, v in w.items()}
    jy = JP.experts_ffn_compact(jw, jnp.asarray(recv), jnp.asarray(valid),
                                "silu")
    ty = TP.experts_ffn_compact(tw, torch.from_numpy(recv),
                                torch.from_numpy(valid), "silu",
                                use_kernel=use_kernel)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert not ty.numpy()[~valid].any()           # empty slots stay zero
    # the rows form, on a slab with per-row group ids
    gid = rng.integers(0, G, G * S).astype(np.int32)
    rows = recv.reshape(G * S, d)
    jr = JP.experts_ffn_compact_rows(jw, jnp.asarray(rows), jnp.asarray(gid),
                                     jnp.asarray(valid.reshape(-1)), G,
                                     "gelu")
    tr = TP.experts_ffn_compact_rows(tw, torch.from_numpy(rows),
                                     torch.from_numpy(gid),
                                     torch.from_numpy(valid.reshape(-1)), G,
                                     "gelu", use_kernel=use_kernel,
                                     sort_impl="radix")
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **TOL)


# ------------------------------------------------------------- dense backend
@pytest.mark.parametrize("A,G,cap,p_valid", [(0, 3, 2, 1.0), (50, 4, 20, 1.0),
                                             (50, 4, 6, 0.8),
                                             (200, 16, 3, 0.5)])
def test_dense_backend_matches(A, G, cap, p_valid):
    rng = np.random.default_rng(A + G + cap + 1)
    k = 2 if A % 2 == 0 else 1
    t, d = A // k, 8
    gid, valid = _draw(A, G, p_valid, seed=A * 3 + G)
    x = rng.standard_normal((t, d)).astype(np.float32)
    gates = rng.random(A).astype(np.float32)
    jpos, jkeep = JD.positions_in_group(jnp.asarray(gid), jnp.asarray(valid),
                                        G, cap)
    tpos, tkeep = TD.positions_in_group(torch.from_numpy(gid),
                                        torch.from_numpy(valid), G, cap)
    _eq(tkeep, jkeep)
    _eq(tpos[tkeep], np.asarray(jpos)[np.asarray(jkeep)])
    jbuf, jst = JD.dispatch(jnp.asarray(x), jnp.asarray(gid),
                            jnp.asarray(gates), G, cap, k=k,
                            valid=jnp.asarray(valid), backend="dense")
    tbuf, tst = TD.dispatch(torch.from_numpy(x), torch.from_numpy(gid),
                            torch.from_numpy(gates), G, cap, k=k,
                            valid=torch.from_numpy(valid), backend="dense")
    _eq(tbuf, jbuf)                   # one assignment per slot: exact
    # the dense and sort buffers are the same bits
    sbuf, _ = TD.dispatch(torch.from_numpy(x), torch.from_numpy(gid),
                          torch.from_numpy(gates), G, cap, k=k,
                          valid=torch.from_numpy(valid), backend="sort")
    assert torch.equal(tbuf, sbuf)
    vals = rng.random(A).astype(np.float32)
    np.testing.assert_array_equal(
        TD.dispatch_flags(torch.from_numpy(vals), tst).numpy(),
        np.asarray(JD.dispatch_flags(jnp.asarray(vals), jst)))
    y_buf = rng.standard_normal((G, cap, d)).astype(np.float32)
    np.testing.assert_allclose(
        TD.combine(torch.from_numpy(y_buf), tst).numpy(),
        np.asarray(JD.combine(jnp.asarray(y_buf), jst)), **TOL)


def test_dispatch_rejects_dropless_and_unknown_backends():
    x = torch.zeros((4, 8))
    gid = torch.zeros((4,), dtype=torch.int32)
    for backend in ("dropless", "bogus"):
        with pytest.raises(ValueError, match="dispatch backend"):
            TD.dispatch(x, gid, torch.ones(4), 2, 4, backend=backend)


# ------------------------------------------------ comm and the ragged hop
def test_single_rank_comm_helpers_match():
    c = np.array([3, 0, 5, 8], np.int32)
    _eq(tcomm.excl_cumsum(torch.from_numpy(c)),
        jcomm.excl_cumsum(jnp.asarray(c)))
    m = np.random.default_rng(0).integers(0, 9, (4, 4)).astype(np.int32)
    for recv_rows in (0, 7, 20, 100):
        _eq(tcomm.clamped_segment_counts(torch.from_numpy(m), recv_rows),
            jcomm.clamped_segment_counts(jnp.asarray(m), recv_rows))
    _eq(tcomm.exchange_counts(torch.from_numpy(c[:1]), ()),
        jcomm.exchange_counts(jnp.asarray(c[:1]), ()))
    rows = np.arange(24, dtype=np.float32).reshape(6, 4)
    sc = np.array([6], np.int32)
    for recv_rows in (4, 6, 9):
        t, tc = tcomm.ragged_all_to_all(torch.from_numpy(rows),
                                        torch.from_numpy(sc), (),
                                        recv_rows=recv_rows)
        j, jc = jcomm.ragged_all_to_all(jnp.asarray(rows), jnp.asarray(sc),
                                        (), recv_rows=recv_rows)
        _eq(t, j)
        _eq(tc, jc)
    with pytest.raises(TypeError, match="int32"):
        tcomm.ragged_all_to_all(torch.from_numpy(rows),
                                torch.tensor([6], dtype=torch.int64), (),
                                recv_rows=6)
    with pytest.raises(TypeError, match="int32"):
        tcomm.assert_count_i32(torch.zeros(2), "counts")
    # a named axis needs the process's mesh (launch.mesh.make_mesh)
    with pytest.raises(RuntimeError, match="no mesh is bound"):
        tcomm.exchange_counts(torch.from_numpy(c), ("ep",))
    with pytest.raises(RuntimeError, match="no mesh is bound"):
        tcomm.ragged_all_to_all(torch.from_numpy(rows), torch.from_numpy(sc),
                                "ep", recv_rows=6)


@pytest.mark.parametrize("wire", ["off", "detect"])
@pytest.mark.parametrize("A,G,block", [(60, 4, 8), (0, 3, 8), (300, 16, 16)])
def test_single_rank_ragged_hop_matches(A, G, block, wire):
    """One rank: the forward hop is a copy of the layout with the count
    grid's structure, the reverse hands the rows back; the wire checksums
    are inert on a single-rank hop, as in the JAX package."""
    rng = np.random.default_rng(A + G)
    d = 8
    gid, valid = _draw(A, G, 0.8, seed=A)
    x = rng.standard_normal((max(A, 1), d)).astype(np.float32)[:A]
    jrows, jstarts, jst = JD.dispatch_ragged(jnp.asarray(x), jnp.asarray(gid),
                                             jnp.ones(A), G,
                                             valid=jnp.asarray(valid),
                                             block=block)
    trows, tstarts, tst = TD.dispatch_ragged(torch.from_numpy(x),
                                             torch.from_numpy(gid),
                                             torch.ones(A), G,
                                             valid=torch.from_numpy(valid),
                                             block=block)
    kw = dict(name="inter", axes=(), n_ranks=1, num_groups=G,
              exchange="ragged", wire_integrity=wire)
    jseg = JD.ragged_seg_lens(jnp.asarray(gid), jnp.asarray(valid), G)
    tseg = TD.ragged_seg_lens(torch.from_numpy(gid), torch.from_numpy(valid),
                              G)
    jhs, jev, jbad = JP._ragged_forward(jrows, jstarts, jseg,
                                        JP.HopSpec(**kw), block)
    ths, tev, tbad = TP._ragged_forward(trows, tstarts, tseg,
                                        TP.HopSpec(**kw), block)
    assert jbad is None and tbad is None
    assert float(tev) == float(jev) == 0
    for f in dataclasses.fields(jhs):
        a, b = getattr(ths, f.name), getattr(jhs, f.name)
        if b is None or isinstance(b, int):
            assert a == b, f.name
        else:
            _eq(a, b)
    y = rng.standard_normal(tuple(trows.shape)).astype(np.float32)
    jback, jsurv, _ = JP._ragged_reverse(jnp.asarray(y), jhs,
                                         JP.HopSpec(**kw))
    assert jsurv is None
    tback, tsurv, trbad = TP._ragged_reverse(torch.from_numpy(y), ths,
                                             TP.HopSpec(**kw))
    assert tsurv is None and trbad is None
    _eq(tback, jback)
