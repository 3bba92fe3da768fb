"""Norms, rotary embeddings and attention of the port against the JAX
package, on numpy-drawn inputs and weights.

fp32 cases hold the port to the reference within 1e-5 (2e-5 where an
attention softmax is accumulated over chunks in another order); the bf16
norm case within one bf16 rounding of a unit-scale value (2**-8 relative).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import ModelConfig as JModelConfig
from repro.models import layers as JL
from repro.sharding.plan import single_device_plan as jplan
from repro_torch.common.config import ModelConfig as TModelConfig
from repro_torch.models import layers as TL
from repro_torch.sharding.plan import single_device_plan as tplan

TOL = dict(rtol=1e-5, atol=1e-5)
ATTN = dict(rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_norm_matches(kind, dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32) * 3
    p = {"scale": rng.standard_normal(32).astype(np.float32),
         "bias": rng.standard_normal(32).astype(np.float32)}
    if kind == "rmsnorm":
        del p["bias"]
    jd, td = ((jnp.float32, torch.float32) if dtype == "float32"
              else (jnp.bfloat16, torch.bfloat16))
    want = JL.apply_norm(jax.tree.map(jnp.asarray, p),
                         jnp.asarray(x).astype(jd), kind)
    got = TL.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x).to(td), kind)
    assert got.dtype == td
    tol = TOL if dtype == "float32" else dict(rtol=2 ** -8, atol=2 ** -8)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("per_row", [False, True])
def test_apply_rope_matches(per_row):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 3, 16)).astype(np.float32)
    pos = (rng.integers(0, 200, (2, 6)) if per_row
           else np.arange(6) + 150).astype(np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    # positions up to ~200 rad: fp32 sin/cos of other libraries differ by an
    # ulp of the angle, ~1e-5 absolute
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=5e-5, atol=5e-5)


def _attn_cfgs(causal, window):
    kw = dict(d_model=32, num_heads=4, num_kv_heads=2, head_dim=8,
              causal=causal, rope_theta=1e4,
              attention="sliding" if window else "full", window=window or 8192)
    return JModelConfig(**kw), TModelConfig(**kw)


def _attn_params(rng, d=32, H=4, KV=2, hd=8):
    return {"wq": rng.standard_normal((d, H, hd)) / np.sqrt(d),
            "wk": rng.standard_normal((d, KV, hd)) / np.sqrt(d),
            "wv": rng.standard_normal((d, KV, hd)) / np.sqrt(d),
            "wo": rng.standard_normal((H, hd, d)) / np.sqrt(H * hd)}


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 3)])
def test_attention_cacheless_matches(causal, window):
    jcfg, tcfg = _attn_cfgs(causal, window)
    rng = np.random.default_rng(2)
    p = {k: v.astype(np.float32) for k, v in _attn_params(rng).items()}
    x = rng.standard_normal((2, 7, 32)).astype(np.float32)
    pos = np.arange(7, dtype=np.int32)
    want, _ = JL.attention_forward(jax.tree.map(jnp.asarray, p),
                                   jnp.asarray(x), jcfg, jplan(),
                                   positions=jnp.asarray(pos), window=window)
    got, _ = TL.attention_forward({k: torch.from_numpy(v)
                                   for k, v in p.items()},
                                  torch.from_numpy(x), tcfg, tplan(),
                                  positions=torch.from_numpy(pos),
                                  window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN)


@pytest.mark.parametrize("W", [16, 9])
def test_attention_ring_cache_matches(W):
    """Prefill 6 tokens into a W-slot ring cache, then 4 decode steps; with
    W=9 the ring wraps and overwrites the oldest slots."""
    jcfg, tcfg = _attn_cfgs(True, 0)
    rng = np.random.default_rng(3)
    p = {k: v.astype(np.float32) for k, v in _attn_params(rng).items()}
    jp = jax.tree.map(jnp.asarray, p)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jc = JL.init_attention_cache(jcfg, 2, W, jplan(), dtype=jnp.float32)
    tc = TL.init_attention_cache(tcfg, 2, W, tplan(), dtype=torch.float32)
    steps = [np.arange(6)] + [np.array([6 + i]) for i in range(4)]
    for pos in steps:
        x = rng.standard_normal((2, len(pos), 32)).astype(np.float32)
        want, jc = JL.attention_forward(jp, jnp.asarray(x), jcfg, jplan(),
                                        positions=jnp.asarray(pos, jnp.int32),
                                        cache=jc)
        got, tc = TL.attention_forward(tp, torch.from_numpy(x), tcfg,
                                       tplan(),
                                       positions=torch.from_numpy(
                                           pos.astype(np.int32)),
                                       cache=tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN)
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), **TOL)


def test_chunked_attention_chunks_match_reference():
    """Streaming over several key chunks (chunk < Tk) against the
    reference's padded chunking."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((1, 5, 4, 8)).astype(np.float32)
    k = rng.standard_normal((1, 11, 2, 8)).astype(np.float32)
    v = rng.standard_normal((1, 11, 2, 8)).astype(np.float32)
    qp = np.arange(6, 11, dtype=np.int32)
    kp = np.arange(11, dtype=np.int32)
    kp[3] = -1                                        # an empty cache slot
    want = JL.chunked_attention(*map(jnp.asarray, (q, k, v, qp, kp)),
                                causal=True, chunk=4)
    got = TL.chunked_attention(*map(torch.from_numpy, (q, k, v, qp, kp)),
                               causal=True, chunk=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN)


def _partial_inputs(Tq):
    """Queries at positions 6.. over 11 cache slots (one empty): every
    query sees at least one key."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, Tq, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 11, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 11, 2, 8)).astype(np.float32)
    qp = np.arange(6, 6 + Tq, dtype=np.int32)
    kp = np.arange(11, dtype=np.int32)
    kp[3] = -1
    return q, k, v, qp, kp


@pytest.mark.parametrize("Tq,chunk", [(1, 4), (5, 4), (5, 1024)])
def test_chunked_attention_partials_match(Tq, chunk):
    """``return_partial=True``: the running max, sum and accumulator
    against the reference's, and the single-rank merge (no axes) against
    both packages' attention output."""
    q, k, v, qp, kp = _partial_inputs(Tq)
    jargs, targs = (tuple(map(jnp.asarray, (q, k, v, qp, kp))),
                    tuple(map(torch.from_numpy, (q, k, v, qp, kp))))
    want = JL.chunked_attention(*jargs, causal=True, chunk=chunk,
                                return_partial=True)
    got = TL.chunked_attention(*targs, causal=True, chunk=chunk,
                               return_partial=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **ATTN)
    shape = (2, Tq, 4, 8)
    jout = JL.merge_attention_partials(*want, None, shape, jnp.float32)
    tout = TL.merge_attention_partials(*got, None, shape, torch.float32)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **ATTN)
    np.testing.assert_allclose(
        tout.numpy(), np.asarray(JL.chunked_attention(*jargs, causal=True)),
        **ATTN)


def _merge_on_rank(rank, Tq):
    """One of two ranks: the partials over its half of the keys, merged
    over ``model``."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding.plan import plan_from_mesh
    plan = plan_from_mesh(make_mesh((2,), ("model",), device=rank.device))
    q, k, v, qp, kp = map(torch.from_numpy, _partial_inputs(Tq))
    half = slice(6 * rank.rank, 6 * rank.rank + 6)
    m, l, acc = TL.chunked_attention(q, k[:, half], v[:, half], qp, kp[half],
                                     causal=True, return_partial=True)
    return TL.merge_attention_partials(m, l, acc, plan.tp_axis, q.shape,
                                       torch.float32).numpy()


def test_merge_attention_partials_over_two_ranks(tmp_path):
    """Two gloo ranks, each holding half of the keys (the sequence-sharded
    cache's layout), merge their partials (pmax, then psums over
    ``model``): both get the reference's attention over all the keys."""
    from repro_torch.launch.mesh import RankPool
    Tq = 5
    want = np.asarray(JL.chunked_attention(
        *map(jnp.asarray, _partial_inputs(Tq)), causal=True))
    with RankPool(2, backend="gloo", devices=["cpu"] * 2, threads=1,
                  timeout_s=120,
                  init_method=f"file://{tmp_path / 'store'}") as pool:
        got = pool.run(_merge_on_rank, Tq)
    for out in got:
        np.testing.assert_allclose(out, want, **ATTN)


@pytest.mark.parametrize("window", [0, 3])
def test_attention_paged_cache_matches(window):
    """A prefill of 5 tokens and 3 decode steps of two sequences through
    the paged cache (pages of 3, the second sequence on pages another one
    left dirty, one row dead at the last step), fp32 projections over the
    bf16 pools: outputs within ATTN, pools bit for bit."""
    jcfg, tcfg = _attn_cfgs(True, window)
    rng = np.random.default_rng(5)
    p = {k: v.astype(np.float32) for k, v in _attn_params(rng).items()}
    jp = jax.tree.map(jnp.asarray, p)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    P, page = 7, 3
    dirty = rng.standard_normal((P, page, 2, 8)).astype(np.float32)
    table = np.array([[4, 1, 6], [0, 2, P]], np.int32)   # P: unmapped
    jc = {"pool_k": jnp.asarray(dirty).astype(jnp.bfloat16),
          "pool_v": jnp.asarray(-dirty).astype(jnp.bfloat16),
          "table": jnp.asarray(table)}
    tc = {"pool_k": torch.from_numpy(dirty).to(torch.bfloat16),
          "pool_v": torch.from_numpy(-dirty).to(torch.bfloat16),
          "table": torch.from_numpy(table)}
    steps = [np.tile(np.arange(5), (2, 1))] + [
        np.array([[5 + i], [5 + i if i < 2 else -1]]) for i in range(3)]
    for pos in steps:
        pos = pos.astype(np.int32)
        x = rng.standard_normal((2, pos.shape[1], 32)).astype(np.float32)
        want, jc = JL.attention_forward(jp, jnp.asarray(x), jcfg, jplan(),
                                        positions=jnp.asarray(pos), cache=jc,
                                        window=window)
        got, tc = TL.attention_forward(tp, torch.from_numpy(x), tcfg,
                                       tplan(), positions=torch.from_numpy(pos),
                                       cache=tc, window=window)
        live = pos >= 0
        np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                                   **ATTN)
        for name in ("pool_k", "pool_v"):
            np.testing.assert_array_equal(
                tc[name].float().numpy(),
                np.asarray(jc[name].astype(jnp.float32)))
