"""The paged KV cache of the port against the JAX package: the page
allocator's ids over scripted and drawn alloc/free sequences, the paged
attention step on numpy-drawn inputs (the pools after the write bit for bit,
the output within the tolerance of the serving tests), and the per-block
cache tree.

Tolerance of the attention output: fp32 inputs agree within 2e-5 (the
softmax's sums in another order, as ``test_torch_layers.ATTN``); bf16 within
one bf16 rounding of a unit-scale output (2**-8).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.common.config import ModelConfig as JModelConfig
from repro.configs import get_reduced as jget_reduced
from repro.models import layers as JL
from repro.serve import kvcache as JKV
from repro.sharding.plan import single_device_plan as jplan
from repro_torch.common.config import ModelConfig as TModelConfig
from repro_torch.configs import get_reduced as tget_reduced
from repro_torch.models import layers as TL
from repro_torch.serve import kvcache as TKV
from repro_torch.sharding.plan import single_device_plan as tplan

ATTN = {"float32": dict(rtol=2e-5, atol=2e-5),
        "bfloat16": dict(rtol=2 ** -8, atol=2 ** -8)}


# =============================================================================
# PageAllocator
# =============================================================================

def test_allocator_reservation_and_free():
    a = TKV.PageAllocator(pool_pages=8, page_size=4)
    assert a.n_free == 8 and a.occupancy == 0.0
    assert TKV.pages_needed(1, 4) == 1 and TKV.pages_needed(4, 4) == 1
    assert TKV.pages_needed(5, 4) == 2 and TKV.pages_needed(0, 4) == 1
    p1 = a.alloc(13)                      # ceil(13/4) = 4 pages
    assert p1 is not None and len(p1) == 4 and a.n_free == 4
    p2 = a.alloc(16)
    assert p2 is not None and len(p2) == 4 and a.n_free == 0
    assert a.occupancy == 1.0
    assert a.alloc(1) is None and not a.can_fit(1)
    a.free(p1)
    assert a.n_free == 4 and a.can_fit(16) and not a.can_fit(17)
    a.free(p2)
    assert a.n_free == 8 and sorted(p1 + p2) == list(range(8))


def test_allocator_lifo_reuse_and_double_free():
    a = TKV.PageAllocator(pool_pages=4, page_size=2)
    p1 = a.alloc(4)
    a.free(p1)
    p2 = a.alloc(4)
    assert p2 == p1[::-1]                 # freed pages are reused first
    a.free(p2)
    with pytest.raises(AssertionError):
        a.free(p2)                        # double free
    with pytest.raises(AssertionError):
        a.free([99])                      # out-of-range page id


def _replay_allocators(ops, pool_pages, page_size):
    """Run the same alloc/free script through both allocators; every
    result, free count and occupancy must agree."""
    j = JKV.PageAllocator(pool_pages, page_size)
    t = TKV.PageAllocator(pool_pages, page_size)
    held = []
    for kind, n in ops:
        if kind == "alloc":
            pj, pt = j.alloc(n), t.alloc(n)
            assert pj == pt
            if pj is not None:
                held.append(pj)
        elif held:
            pages = held.pop(n % len(held))
            j.free(pages)
            t.free(pages)
        assert (j.n_free, j.occupancy) == (t.n_free, t.occupancy)
        assert j._free == t._free


def test_allocator_scripted_matches_reference():
    ops = [("alloc", 13), ("alloc", 3), ("alloc", 40), ("free", 0),
           ("alloc", 7), ("free", 1), ("alloc", 1), ("alloc", 64),
           ("free", 0), ("free", 0), ("alloc", 20), ("alloc", 5)]
    _replay_allocators(ops, pool_pages=12, page_size=4)


@given(seed=st.integers(0, 2 ** 31 - 1), pool=st.integers(1, 40),
       page=st.integers(1, 16))
@settings(max_examples=40, deadline=None)
def test_allocator_drawn_sequences_match_reference(seed, pool, page):
    rng = np.random.default_rng(seed)
    ops = [("alloc", int(rng.integers(0, pool * page + 2)))
           if rng.random() < 0.6 else ("free", int(rng.integers(0, 1000)))
           for _ in range(30)]
    _replay_allocators(ops, pool, page)


# =============================================================================
# paged_attention
# =============================================================================

def _cfgs(H, KV, hd):
    kw = dict(name="t", arch_type="dense", num_layers=1, d_model=H * hd,
              num_heads=H, num_kv_heads=KV, head_dim=hd, d_ff=64,
              vocab_size=64, attention="full")
    return JModelConfig(**kw), TModelConfig(**kw)


def _case(rng, page, B, T, H, KV, hd, P, mp, dtype):
    """Pools with random (dirty) content, a page table with sentinel and
    negative entries, and positions with dead rows, rows past the table
    and a partly filled last page."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    pool_k, pool_v = f(P, page, KV, hd), f(P, page, KV, hd)
    table = np.full((B, mp), P, np.int32)        # the engine's sentinel
    perm = rng.permutation(P)
    for b in range(B):
        n = int(rng.integers(1, mp + 1))
        table[b, :n] = perm[b * mp:b * mp + n]
    table[0, -1] = -1                            # a negative entry
    start = rng.integers(0, mp * page - T + 1, size=B)
    pos = (start[:, None] + np.arange(T)[None]).astype(np.int32)
    pos[B - 1, :] = -1                           # a dead row
    pos[0, 0] = -1                               # a dead token in a live row
    pos[1, -1] = mp * page + 2                   # past the table
    return dict(q=f(B, T, H, hd), k=f(B, T, KV, hd), v=f(B, T, KV, hd),
                pool_k=pool_k, pool_v=pool_v, table=table, pos=pos)


@pytest.mark.parametrize("page,H,KV,window,dtype", [
    (1, 4, 4, 0, "float32"),
    (3, 4, 2, 0, "float32"),
    (3, 8, 2, 5, "float32"),
    (16, 4, 1, 0, "float32"),
    (16, 8, 2, 7, "bfloat16"),
    (3, 4, 2, 0, "bfloat16"),
])
def test_paged_attention_matches_reference(page, H, KV, window, dtype):
    rng = np.random.default_rng(page * 100 + H + KV + window)
    hd, B, T = 8, 4, 3 if page > 1 else 2
    mp = max(2, 24 // page)
    P = B * mp + 2
    c = _case(rng, page, B, T, H, KV, hd, P, mp, dtype)
    jcfg, tcfg = _cfgs(H, KV, hd)
    jd, td = ((jnp.float32, torch.float32) if dtype == "float32"
              else (jnp.bfloat16, torch.bfloat16))
    # pools in the engine's bf16, projections in the compute dtype
    jcache = {"pool_k": jnp.asarray(c["pool_k"]).astype(jnp.bfloat16),
              "pool_v": jnp.asarray(c["pool_v"]).astype(jnp.bfloat16),
              "table": jnp.asarray(c["table"])}
    want, jnew = JL.paged_attention(
        *(jnp.asarray(c[n]).astype(jd) for n in "qkv"), jcache,
        jnp.asarray(c["pos"]), jcfg, jplan(), h_loc=H, window=window)
    tcache = {"pool_k": torch.from_numpy(c["pool_k"]).to(torch.bfloat16),
              "pool_v": torch.from_numpy(c["pool_v"]).to(torch.bfloat16),
              "table": torch.from_numpy(c["table"])}
    before = tcache["pool_k"].clone()
    got, tnew = TL.paged_attention(
        *(torch.from_numpy(c[n]).to(td) for n in "qkv"), tcache,
        torch.from_numpy(c["pos"]), tcfg, tplan(), window=window)
    assert tnew is tcache                         # written in place
    for name in ("pool_k", "pool_v"):
        np.testing.assert_array_equal(
            tcache[name].float().numpy(),
            np.asarray(jnew[name].astype(jnp.float32)), err_msg=name)
    assert not torch.equal(before, tcache["pool_k"])   # something was written
    live = c["pos"][:, :, None, None] >= 0        # dead rows are garbage
    live = np.broadcast_to(live, got.shape)
    np.testing.assert_allclose(got.float().numpy()[live],
                               np.asarray(want.astype(jnp.float32))[live],
                               **ATTN[dtype])
    assert torch.isfinite(got.float()).all()


def test_paged_write_drops_only_what_the_reference_drops():
    """Dead rows, rows past the table and unmapped entries write nothing:
    every other pool row keeps its dirty content bit for bit."""
    rng = np.random.default_rng(11)
    B, T, H, KV, hd, page, mp, P = 3, 4, 2, 2, 8, 2, 3, 9
    c = _case(rng, page, B, T, H, KV, hd, P, mp, "float32")
    c["pos"][:] = -1                              # nothing live
    _, tcfg = _cfgs(H, KV, hd)
    tcache = {"pool_k": torch.from_numpy(c["pool_k"]).to(torch.bfloat16),
              "pool_v": torch.from_numpy(c["pool_v"]).to(torch.bfloat16),
              "table": torch.from_numpy(c["table"])}
    before = {k: v.clone() for k, v in tcache.items()}
    TL.paged_attention(*(torch.from_numpy(c[n]) for n in "qkv"), tcache,
                       torch.from_numpy(c["pos"]), tcfg, tplan())
    for k in before:
        assert torch.equal(before[k], tcache[k]), k


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen3-moe-30b-a3b",
                                  "smile-3.7b"])
def test_init_paged_caches_matches_reference_tree(arch):
    """One pool per attention block, the reference's shapes (its stages
    stack them on a leading axis; the port keeps a list per stage)."""
    jcfg, tcfg = jget_reduced(arch), tget_reduced(arch)
    want = JKV.init_paged_caches(jcfg, 6, 4, jplan())
    got = TKV.init_paged_caches(tcfg, 6, 4, tplan(), device="cpu")
    assert len(got) == len(want)
    for jst, tst in zip(want, got):
        pairs = ([(jst[k], tst[k]) for k in ("dense", "moe")]
                 if "dense" in tst else [(jst, tst)])
        for jc, blocks in pairs:
            assert len(blocks) == jc["pool_k"].shape[0]
            for blk in blocks:
                assert set(blk) == {"pool_k", "pool_v"}
                for name, t in blk.items():
                    assert tuple(t.shape) == jc[name].shape[1:]
                    assert t.dtype == torch.bfloat16 and not t.any()
    tbl = torch.zeros((2, 3), dtype=torch.int32)
    inj = TKV.inject_tables(got, tbl)
    blk0 = inj[0]["dense"][0] if isinstance(inj[0], dict) else inj[0][0]
    raw0 = got[0]["dense"][0] if isinstance(got[0], dict) else got[0][0]
    assert blk0["table"] is tbl and blk0["pool_k"] is raw0["pool_k"]
    stripped = TKV.strip_tables(inj)
    flat = stripped[0]["dense"][0] if isinstance(stripped[0], dict) \
        else stripped[0][0]
    assert set(flat) == {"pool_k", "pool_v"}


def test_paged_caches_reject_recurrent_stages():
    with pytest.raises(ValueError, match="attention stages"):
        TKV.init_paged_caches(tget_reduced("rwkv6-1.6b"), 4, 4, tplan(),
                              device="cpu")
