"""The cache-less causal forward of the port (the flash-attention path)
against the JAX package, on numpy-drawn inputs.

* The plain ``flash_attention_ref`` against JAX's oracle: fp32 within rtol
  1e-5 / atol 1e-6 (the same fp32 math summed in another order); bf16
  outputs equal or one bf16 ulp apart (both compute in fp32 from the same
  bf16 inputs and round once at the end).
* ``chunked_attention(..., use_kernel=True)`` (the flash branch; on the CPU
  the wrapper runs the plain version on repeated KV heads) against JAX's
  ``chunked_attention(..., use_kernel=False)``, with the same bounds (where
  a bf16 output cancels to near zero, within the fp32 atol instead).  The
  bf16 cases use head sizes whose scale 1/sqrt(hd) is a power of two (16,
  64): JAX's plain path multiplies q by the scale in bf16 before the
  product, the oracle divides the fp32 product, and only for such scales
  are the two the same number.  hd=128 is held in fp32.
* The reduced qwen3-moe-30b-a3b ``forward(use_kernel=True)`` without caches
  against JAX's ``forward(use_kernel=False)``: per-token relative error at
  the 90th percentile under 2e-2 (tighter than tests/test_use_kernel.py's
  3e-2; measured 8e-3 here and 7e-3 for the card against the CPU) and
  under 5% of the tokens over 3e-2, as there (measured 0 here, but 1.6%
  for the card against the CPU, so no tighter bound holds for both): both
  sides compute in bf16 with other rounding points, and a near-tied router
  decision may flip a token.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.kernels import ref as jref
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.sharding.plan import single_device_plan as jplan
from repro_torch.configs import get_reduced as tget_reduced
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.sharding.plan import single_device_plan as tplan
from repro_torch.weights import params_from_jax

FP32 = dict(rtol=1e-5, atol=1e-6)


def _ordered(bits: np.ndarray) -> np.ndarray:
    """bf16 bit patterns (int16) on one ordered integer line, so that
    neighbouring bf16 values are one apart (across zero too)."""
    b = bits.astype(np.int32)
    return np.where(b < 0, -(b & 0x7FFF), b)


def assert_within_one_bf16_ulp(got: torch.Tensor, want) -> None:
    """Equal or one bf16 ulp apart; where a sum cancels to near zero its
    ulp is finer than the fp32 sums' own rounding, so there the bound is
    the fp32 atol."""
    want = np.asarray(want)
    g = _ordered(got.contiguous().view(torch.int16).numpy())
    w = _ordered(want.view(np.int16))
    near = np.abs(got.float().numpy() - want.astype(np.float32)) <= 1e-6
    bad = (np.abs(g - w) > 1) & ~near
    assert not bad.any(), (f"{int(bad.sum())} of {bad.size} outputs more "
                           f"than one bf16 ulp apart")


def _qkv(shape, kv, seed, scale=1.0):
    B, T, H, hd = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, hd)).astype(np.float32) * scale
    k = rng.standard_normal((B, T, kv, hd)).astype(np.float32) * scale
    v = rng.standard_normal((B, T, kv, hd)).astype(np.float32)
    return q, k, v


def _as(dtype, *arrays):
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return ([jnp.asarray(a).astype(jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


# (B, T, H, KV, hd): T = 1, ragged T < 128, T = 128, two 128-blocks, GQA;
# then the head sizes of zamba2-2.7b (80), phi3-vision (96) and stablelm-12b
# (160), which the card's kernel runs padded (see ops.flash_padded_head)
SHAPES = [(1, 1, 2, 2, 16), (2, 24, 4, 2, 64), (1, 128, 4, 1, 64),
          (2, 256, 2, 2, 128), (1, 128, 8, 2, 128),
          (1, 128, 4, 4, 80), (2, 64, 4, 2, 96), (1, 256, 4, 1, 160)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H,KV,hd", SHAPES)
def test_flash_attention_matches_jax_oracle(B, T, H, KV, hd, dtype):
    q, k, v = _qkv((B, T, H, hd), KV, seed=T + hd, scale=2.0)
    (jq, jk, jv), (tq, tk, tv) = _as(dtype, q, k, v)
    rep = H // KV
    want = jref.flash_attention_ref(jq, jnp.repeat(jk, rep, axis=2),
                                    jnp.repeat(jv, rep, axis=2))
    plain = ref.flash_attention_ref(tq, tk.repeat_interleave(rep, dim=2),
                                    tv.repeat_interleave(rep, dim=2))
    before = ops.launch_counts()
    got = ops.flash_attention(tq, tk, tv)           # CPU: the plain version
    assert ops.launch_counts() == before
    assert torch.equal(got, plain) and got.dtype == tq.dtype
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)
    else:
        assert_within_one_bf16_ulp(got, want)


@pytest.mark.parametrize("dtype,hd", [("float32", 128), ("float32", 64),
                                      ("bfloat16", 64), ("bfloat16", 16)])
@pytest.mark.parametrize("T,H,KV", [(1, 4, 2), (32, 4, 4), (128, 8, 2)])
def test_chunked_attention_kernel_branch_matches_jax(T, H, KV, dtype, hd):
    q, k, v = _qkv((2, T, H, hd), KV, seed=7 * T + H)
    (jq, jk, jv), (tq, tk, tv) = _as(dtype, q, k, v)
    pos = np.arange(T, dtype=np.int32)
    want = JL.chunked_attention(jq, jk, jv, jnp.asarray(pos),
                                jnp.asarray(pos), causal=True, chunk=64,
                                use_kernel=False)
    got = TL.chunked_attention(tq, tk, tv, torch.from_numpy(pos),
                               torch.from_numpy(pos), causal=True,
                               use_kernel=True)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    else:
        assert_within_one_bf16_ulp(got, want)


# the flash kernel's head-size rule: any positive multiple of 8 up to 512,
# run at 32 (hd <= 32) or at hd rounded up to 64 columns (the wgmma route's
# TMA box up to 192, the wide route's chunk past it)
@pytest.mark.parametrize("hd,padded", [(8, 32), (16, 32), (32, 32), (40, 64),
                                       (64, 64), (72, 128), (80, 128),
                                       (96, 128), (128, 128), (136, 192),
                                       (160, 192), (192, 192), (200, 256),
                                       (256, 256), (384, 384), (512, 512)])
def test_flash_padded_head(hd, padded):
    assert ops.flash_padded_head(hd) == padded


@pytest.mark.parametrize("hd", [0, -8, 4, 12, 52, 100, 520, 1024])
def test_flash_padded_head_refuses(hd):
    with pytest.raises(ValueError, match="multiple of 8 up to 512"):
        ops.flash_padded_head(hd)


@pytest.mark.parametrize("hd,route", [(8, "wgmma"), (128, "wgmma"),
                                      (192, "wgmma"), (200, "wide"),
                                      (256, "wide"), (384, "wide"),
                                      (512, "wide")])
def test_flash_route(hd, route):
    """Head sizes past 192 take the wide route (the head dim tiled through
    shared memory), the rest the wgmma route."""
    assert ops.flash_route(hd) == route


@pytest.mark.parametrize("T", [130, 200, 384 + 64])
def test_flash_attention_rejects_t_off_the_block(T):
    q = torch.zeros((1, T, 2, 16))
    with pytest.raises(ValueError, match="min\\(128, T\\)"):
        ops.flash_attention(q, q, q)
    # the same gate decides in chunked_attention: the kernel branch raises
    with pytest.raises(ValueError, match="min\\(128, T\\)"):
        TL.chunked_attention(q, q, q, torch.arange(T), torch.arange(T),
                             causal=True, use_kernel=True)


def test_flash_attention_rejects_kv_heads_that_do_not_divide():
    q = torch.zeros((1, 8, 4, 16))
    kv = torch.zeros((1, 8, 3, 16))
    with pytest.raises(ValueError, match="KV must divide H"):
        ops.flash_attention(q, kv, kv)


def test_reduced_qwen3_cacheless_kernel_forward_matches_jax():
    arch = "qwen3-moe-30b-a3b"
    jcfg, tcfg = jget_reduced(arch), tget_reduced(arch)
    jparams = JT.init_model(jax.random.PRNGKey(0), jcfg, jplan())
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    B, S = 2, 64
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    _, want, _, _ = JT.forward(jparams, jnp.asarray(toks), jcfg, jplan(),
                               positions=jnp.arange(S), use_kernel=False)
    before = ops.launch_counts()
    with torch.inference_mode():
        _, got, _, caches = TT.forward(
            tparams, torch.from_numpy(toks), tcfg, tplan(),
            positions=torch.arange(S, dtype=torch.int32), use_kernel=True)
    assert caches is None
    assert ops.launch_counts() == before        # CPU: plain versions only
    a, b = np.asarray(want, np.float32), got.float().numpy()
    per_tok = (np.abs(a - b).max(axis=-1).reshape(-1)
               / (np.abs(a).max() + 1e-9))
    assert np.percentile(per_tok, 90) < 2e-2, np.percentile(per_tok, 90)
    assert (per_tok > 3e-2).mean() < 0.05, (per_tok > 3e-2).mean()
