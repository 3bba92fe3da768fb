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


def test_unported_attention_paths_raise():
    _, tcfg = _attn_cfgs(True, 0)
    x = torch.zeros((1, 2, 32))
    p = {k: torch.from_numpy(v.astype(np.float32))
         for k, v in _attn_params(np.random.default_rng(0)).items()}
    with pytest.raises(NotImplementedError, match="paged"):
        TL.attention_forward(p, x, tcfg, tplan(),
                             positions=torch.arange(2),
                             cache={"pool_k": None})
    q = torch.zeros((1, 4, 2, 8))
    with pytest.raises(NotImplementedError, match="flash"):
        TL.chunked_attention(q, q, q, torch.arange(4), torch.arange(4),
                             causal=True, use_kernel=True)
