"""The dense decoders the port already builds, against the JAX package, on
their reduced configs (2 layers): llama3-405b, stablelm-12b,
deepseek-coder-33b and qwen1.5-0.5b, each through the plain forward, the
cache-less kernel forward (``use_kernel=True``: on the CPU the flash
kernel's plain version) and the ring-cache decode (prefill, then decode
steps fed JAX's greedy tokens).

Weights come from the JAX package's ``init_model`` through
``params_from_jax``; tokens are drawn with numpy ``default_rng``.  The JAX
side runs with ``use_kernel=False`` (Pallas does not run on this JAX).
Both packages compute in fp32 (the JAX package's ``embed_inputs`` pinned
to fp32, the ring caches pinned to fp32 on both sides, in the test only):
logits within ``FP32_REL`` (1e-4) of the largest, greedy tokens equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.sharding.plan import single_device_plan as jplan
from repro_torch.configs import get_reduced as tget_reduced
from repro_torch.kernels import ops as tops
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.sharding.plan import single_device_plan as tplan
from repro_torch.weights import params_from_jax
from test_torch_mla import _rel

ARCHS = ("llama3-405b", "stablelm-12b", "deepseek-coder-33b", "qwen1.5-0.5b")
MODES = ("plain", "kernel", "decode")
FP32_REL = 1e-4
B, S, STEPS = 2, 32, 3


@pytest.fixture(autouse=True)
def _fp32(monkeypatch):
    monkeypatch.setattr(JT, "embed_inputs",
                        functools.partial(JT.embed_inputs, dtype=jnp.float32))
    monkeypatch.setattr(JL, "init_attention_cache", functools.partial(
        JL.init_attention_cache, dtype=jnp.float32))
    monkeypatch.setattr(TL, "init_attention_cache", functools.partial(
        TL.init_attention_cache, dtype=torch.float32))


@pytest.fixture(scope="module")
def jparams_of():
    """The JAX package's parameters of each arch, drawn once a module."""
    drawn = {}

    def get(arch):
        if arch not in drawn:
            cfg = jget_reduced(arch)
            drawn[arch] = jax.jit(lambda k: JT.init_model(k, cfg, jplan()))(
                jax.random.PRNGKey(0))
        return drawn[arch]
    return get


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_dense_arch_matches_jax(arch, mode, jparams_of):
    jcfg = jget_reduced(arch)
    tcfg = tget_reduced(arch).replace(dtype="float32")
    jparams = jparams_of(arch)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    toks = np.random.default_rng(1).integers(
        8, jcfg.vocab_size, (B, S)).astype(np.int32)
    caches = mode == "decode"
    jc = JT.init_caches(jcfg, B, S + STEPS, jplan()) if caches else None
    tc = (TT.init_caches(tcfg, B, S + STEPS, tplan(), device="cpu")
          if caches else None)
    jfwd = jax.jit(lambda p, t, pos, c: JT.forward(p, t, jcfg, jplan(),
                                                  positions=pos, caches=c))
    before = tops.launch_counts()
    for i in range(STEPS + 1 if caches else 1):
        pos = (np.arange(S) if i == 0 else np.array([S + i - 1])).astype(
            np.int32)
        _, want, _, jc = jfwd(jparams, jnp.asarray(toks), jnp.asarray(pos),
                              jc)
        with torch.inference_mode():
            _, got, _, tc = TT.forward(
                tparams, torch.from_numpy(toks), tcfg, tplan(),
                positions=torch.from_numpy(pos), caches=tc,
                use_kernel=mode != "plain")
        want = np.asarray(want)
        assert got.shape == want.shape
        assert _rel(got.numpy(), want) < FP32_REL, (i, _rel(got, want))
        np.testing.assert_array_equal(got[:, -1].argmax(-1).numpy(),
                                      want[:, -1].argmax(-1))
        toks = want[:, -1].argmax(-1).astype(np.int32)[:, None]
    assert tops.launch_counts() == before       # CPU: plain versions only
