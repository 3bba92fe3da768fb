"""rwkv6-1.6b in the port against the JAX package, on numpy-drawn inputs
and on the JAX package's weights (carried across by ``params_from_jax``).

Tolerances:

* the plain ``rwkv6_scan_ref`` against JAX's oracle: rtol 1e-5 and atol
  1e-6 of the largest output (the same fp32 recurrence; the readout's sum
  over i runs in another order, and its rounding scales with its terms,
  which reach ~30 here, not with an output that cancels to near 0); two
  halves of T with the state carried give the whole bit for bit (the same
  steps in the same order);
* the time-mix and channel-mix against JAX in fp32: within 1e-5 of the
  largest output (the group norm divides by sqrt(var + 1e-3), and at the
  second position var is ~0, which amplifies fp32 ordering noise there);
* the reduced model's cache-less ``forward(use_kernel=True)`` against JAX's
  ``forward(use_kernel=False)``: within 1e-4 of max |logit| in fp32 (the
  tolerance tests/test_models.py holds rwkv6's decode to); in the config's
  bf16 within 1e-2 (measured 5.1e-3): there the amplified noise at the
  second position flips bf16 roundings of the block outputs, whose one-ulp
  steps the next layer amplifies again and the WKV state carries to every
  later position (EXPERIMENTS.md §Num-1).  A second test splits that gap:
  XLA's CPU compiler keeps some results in fp32 where the program rounds
  to bf16 (its default ``xla_allow_excess_precision``), and the port
  rounds as written; compiled with that option off, JAX lands 2.8e-3 from
  the port, no more than the 3.3e-3 by which the port itself moves when
  its fp32 weights move by one ulp;
* decode token by token against the full forward, in the port: 1e-4 of
  max |logit|, as tests/test_models.py;
* ``serve`` against ``repro.launch.serve.serve`` in fp32 (both packages'
  embeddings pinned to fp32, for the reason above): the same greedy
  tokens, last logits within 1e-4 of their largest.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.kernels import ref as jref
from repro.launch import serve as JSERVE
from repro.models import rwkv6 as JR
from repro.models import transformer as JT
from repro.sharding.plan import single_device_plan as jplan
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import get_reduced as tget_reduced
from repro_torch.data.pipeline import synthetic_tokens
from repro_torch.kernels import ops, ref
from repro_torch.launch.serve import generate
from repro_torch.models import rwkv6 as TR
from repro_torch.models import transformer as TT
from repro_torch.sharding.plan import single_device_plan as tplan
from repro_torch.weights import params_from_jax

ARCH = "rwkv6-1.6b"


def _scan_inputs(B, T, nh, hd, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, nh, hd)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.normal(-1.0, 0.5, (B, T, nh, hd)))).astype(
        np.float32)
    u = rng.standard_normal((nh, hd)).astype(np.float32)
    s0 = rng.standard_normal((B, nh, hd, hd)).astype(np.float32)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("B,T,nh,hd", [(1, 1, 1, 8), (2, 20, 3, 8),
                                       (2, 33, 2, 64)])
def test_rwkv6_scan_ref_matches_jax(B, T, nh, hd):
    args = _scan_inputs(B, T, nh, hd, seed=T)
    wy, ws = jref.rwkv6_scan_ref(*map(jnp.asarray, args))
    before = ops.launch_counts()
    ty, ts = ops.rwkv6_scan(*map(torch.from_numpy, args))   # CPU: plain
    assert ops.launch_counts() == before
    for got, want in ((ty, wy), (ts, ws)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())


def test_rwkv6_scan_state_carry_composes():
    r, k, v, w, u, s0 = map(torch.from_numpy, _scan_inputs(2, 24, 2, 8, 5))
    y, s = ref.rwkv6_scan_ref(r, k, v, w, u, s0)
    y1, s1 = ref.rwkv6_scan_ref(r[:, :10], k[:, :10], v[:, :10], w[:, :10],
                                u, s0)
    y2, s2 = ref.rwkv6_scan_ref(r[:, 10:], k[:, 10:], v[:, 10:], w[:, 10:],
                                u, s1)
    assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(s2, s)
    # T = 0 hands the state back untouched
    y0, sz = ref.rwkv6_scan_ref(r[:, :0], k[:, :0], v[:, :0], w[:, :0], u, s0)
    assert y0.shape == (2, 0, 2, 8) and torch.equal(sz, s0)


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                        jax.tree.map(np.asarray, tree))


def _close_to(got, want, rel=1e-5):
    want = np.asarray(want)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _caches(B, d, nh, hd, seed):
    rng = np.random.default_rng(seed)
    return {"wkv": rng.standard_normal((B, nh, hd, hd)).astype(np.float32),
            "x_prev_t": rng.standard_normal((B, 1, d)).astype(np.float32),
            "x_prev_c": rng.standard_normal((B, 1, d)).astype(np.float32)}


@pytest.mark.parametrize("mix", ["tmix", "cmix"])
@pytest.mark.parametrize("with_cache", [False, True])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_rwkv_mixes_match_jax(mix, with_cache, use_kernel):
    jcfg, tcfg = jget_reduced(ARCH), tget_reduced(ARCH)
    key = jax.random.PRNGKey(3)
    jp = (JR.init_rwkv_tmix(key, jcfg) if mix == "tmix"
          else JR.init_rwkv_cmix(key, jcfg))
    if mix == "tmix":    # a nonzero bonus, as a trained model has
        jp["u"] = jnp.asarray(np.random.default_rng(2).standard_normal(
            jp["u"].shape).astype(np.float32))
    tp = _to_torch(jp)
    B, T, d = 2, 12, jcfg.d_model
    hd = jcfg.rwkv.head_dim
    x = np.random.default_rng(1).standard_normal((B, T, d)).astype(np.float32)
    c = _caches(B, d, d // hd, hd, seed=4) if with_cache else None
    jc = None if c is None else jax.tree.map(jnp.asarray, c)
    tc = None if c is None else {k: torch.from_numpy(v.copy())
                                 for k, v in c.items()}
    if mix == "tmix":
        want, wc = JR.rwkv_tmix_forward(jp, jnp.asarray(x), jcfg, jplan(),
                                        cache=jc, use_kernel=False)
        got, gc = TR.rwkv_tmix_forward(tp, torch.from_numpy(x), tcfg,
                                       tplan(), cache=tc,
                                       use_kernel=use_kernel)
    else:
        want, wc = JR.rwkv_cmix_forward(jp, jnp.asarray(x), jcfg, jplan(),
                                        cache=jc)
        got, gc = TR.rwkv_cmix_forward(tp, torch.from_numpy(x), tcfg,
                                       tplan(), cache=tc)
    _close_to(got.numpy(), want)
    if with_cache:
        assert gc is tc                          # updated in place
        for name, arr in wc.items():
            _close_to(gc[name].numpy(), arr)
    else:
        assert gc is None and wc is None


def _model_pair(fp32, monkeypatch):
    jcfg, tcfg = jget_reduced(ARCH), tget_reduced(ARCH)
    if fp32:
        monkeypatch.setattr(JT, "embed_inputs", functools.partial(
            JT.embed_inputs, dtype=jnp.float32))
        tcfg = tcfg.replace(dtype="float32")
    jparams = JT.init_model(jax.random.PRNGKey(0), jcfg, jplan())
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 1e-2)])
def test_reduced_cacheless_kernel_forward_matches_jax(dtype, tol,
                                                      monkeypatch):
    jcfg, tcfg, jparams, tparams = _model_pair(dtype == "float32",
                                               monkeypatch)
    B, S = 2, 48
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    _, want, _, _ = JT.forward(jparams, jnp.asarray(toks), jcfg, jplan(),
                               positions=jnp.arange(S), use_kernel=False)
    before = ops.launch_counts()
    with torch.inference_mode():
        _, got, _, caches = TT.forward(
            tparams, torch.from_numpy(toks), tcfg, tplan(),
            positions=torch.arange(S, dtype=torch.int32), use_kernel=True)
    assert caches is None and ops.launch_counts() == before
    a = np.asarray(want, np.float32)
    err = np.abs(a - got.numpy()).max() / np.abs(a).max()
    assert err < tol, err


def _nudged(params, seed):
    """``params`` with every fp32 weight one ulp up or down at random."""
    g = torch.Generator().manual_seed(seed)

    def nudge(t):
        if t.dtype != torch.float32:
            return t
        up = torch.rand(t.shape, generator=g) < 0.5
        inf = torch.full_like(t, float("inf"))
        return torch.where(up, torch.nextafter(t, inf),
                           torch.nextafter(t, -inf))
    return torch.utils._pytree.tree_map(nudge, params)


def test_reduced_bf16_gap_is_xla_precision_and_fp32_noise(monkeypatch):
    jcfg, tcfg, jparams, tparams = _model_pair(False, monkeypatch)
    B, S = 2, 48
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jt = jnp.asarray(toks)
    fwd = jax.jit(lambda p, t: JT.forward(p, t, jcfg, jplan(),
                                          positions=jnp.arange(S),
                                          use_kernel=False)[1])
    loose = np.asarray(fwd(jparams, jt), np.float32)
    strict = np.asarray(fwd.lower(jparams, jt).compile(compiler_options={
        "xla_allow_excess_precision": False})(jparams, jt), np.float32)

    def port(params):
        with torch.inference_mode():
            _, lg, _, _ = TT.forward(
                params, torch.from_numpy(toks), tcfg, tplan(),
                positions=torch.arange(S, dtype=torch.int32),
                use_kernel=True)
        return lg.float().numpy()

    got = port(tparams)
    scale = np.abs(strict).max()

    def gap(a):
        return np.abs(a - got).max() / scale

    # rounding where the program says brings JAX nearer the port, and what
    # is left is no more than fp32 noise of one ulp makes in the port
    assert gap(strict) < gap(loose)
    assert gap(strict) <= 2 * gap(port(_nudged(tparams, 0)))
    assert gap(strict) < 6e-3


def test_reduced_decode_matches_full_forward():
    cfg = tget_reduced(ARCH)
    params = TT.init_model(cfg, tplan(), seed=0, device="cpu")
    B, S = 2, 16
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32))
    with torch.inference_mode():
        _, full, _, _ = TT.forward(params, toks, cfg, tplan(),
                                   positions=torch.arange(S), use_kernel=True)
        caches = TT.init_caches(cfg, B, 2 * S, tplan(), device="cpu")
        for t in range(S):
            _, lg, _, caches = TT.forward(
                params, toks[:, t:t + 1], cfg, tplan(),
                positions=torch.tensor([t]), caches=caches, use_kernel=True)
    ref_last = full[:, -1].numpy()
    err = np.abs(lg[:, -1].numpy() - ref_last).max() / np.abs(ref_last).max()
    assert err < 1e-4, err


def test_serve_matches_jax_serve(monkeypatch):
    jcfg, tcfg, jparams, tparams = _model_pair(True, monkeypatch)
    B, S, new = 2, 16, 4
    want_tokens = JSERVE.serve(ARCH, reduced=True, batch=B, prompt_len=S,
                               new_tokens=new, seed=0)
    # JAX's serve draws its weights from PRNGKey(seed) and its prompts from
    # default_rng(seed), as _model_pair and these prompts do
    prompts = synthetic_tokens(np.random.default_rng(0), B, S,
                               jcfg.vocab_size)
    res = generate(tparams, torch.as_tensor(prompts), tcfg, tplan(),
                   new_tokens=new)
    np.testing.assert_array_equal(res.tokens, want_tokens)
    assert res.launches["prefill"]["rwkv6_scan"] == 0
    # the last step's logits, from each package's forward with caches fed
    # the same tokens
    jc = JT.init_caches(jcfg, B, S + new, jplan())
    tc = TT.init_caches(tcfg, B, S + new, tplan(), device="cpu")
    _, want, _, jc = JT.forward(jparams, jnp.asarray(prompts), jcfg, jplan(),
                                positions=jnp.arange(S), caches=jc)
    with torch.inference_mode():
        _, got, _, tc = TT.forward(tparams, torch.as_tensor(prompts), tcfg,
                                   tplan(), positions=torch.arange(S),
                                   caches=tc, use_kernel=True)
        for i in range(new - 1):
            step = want_tokens[:, i:i + 1]
            _, want, _, jc = JT.forward(
                jparams, jnp.asarray(step), jcfg, jplan(),
                positions=jnp.array([S + i]), caches=jc)
            _, got, _, tc = TT.forward(
                tparams, torch.as_tensor(step), tcfg, tplan(),
                positions=torch.tensor([S + i]), caches=tc, use_kernel=True)
    want = np.asarray(want[:, -1])
    err = np.abs(got[:, -1].float().numpy() - want).max() / np.abs(want).max()
    assert err < 1e-4, err


def test_cast_for_compute_casts_only_tmix_wo():
    cfg = tget_reduced(ARCH)
    params = TT.init_model(cfg, tplan(), seed=0, device="cpu")
    (stage,) = params["stages"]
    assert len(stage["blocks"]) == cfg.num_layers
    for blk in stage["blocks"]:
        assert set(blk) == {"ln1", "tmix", "ln2", "cmix"}
        assert set(blk["ln1"]) == {"scale", "bias"}        # LayerNorm
        for name, w in blk["tmix"].items():
            want = torch.bfloat16 if name == "wo" else torch.float32
            leaves = w.values() if isinstance(w, dict) else [w]
            assert all(t.dtype == want for t in leaves), name
        assert all(t.dtype == torch.float32 for t in blk["cmix"].values())


def test_full_rwkv6_config_is_supported_and_others_still_raise():
    """rwkv6 builds, and so does every other architecture: no config of
    the registry raises any more (zamba2's Mamba2 stage was the last), and
    the reduced zamba2, deepseek-v3, musicgen and phi-3-vision build."""
    from repro_torch.configs import ASSIGNED, PAPER
    plan = tplan()
    for arch in ASSIGNED + PAPER:
        TT._check_supported(tget_config(arch))
    for arch in ("zamba2-2.7b", "deepseek-v3-671b", "musicgen-large",
                 "phi-3-vision-4.2b"):
        TT._check_supported(tget_config(arch))
        assert "stages" in TT.init_model(tget_reduced(arch), plan,
                                         device="cpu")
