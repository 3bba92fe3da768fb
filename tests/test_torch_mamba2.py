"""zamba2's Mamba2 stage (the ``mamba_group`` hybrid) against the JAX
package, on the reduced zamba2-2.7b config: 4 layers in 2 groups of 2
Mamba2 blocks and the shared attention block, d 256, 16 SSM heads of 32,
``d_state`` 16, chunk 32.

Weights come from the JAX package's ``init_model`` through
``params_from_jax``, with each Mamba2 block's ``A_log``, ``D``, ``dt_bias``
and gated-norm scale redrawn from numpy ``default_rng`` (their inits are
constants, which would leave the decay and the skip untested); inputs are
drawn with ``default_rng`` too.  The reference's zamba2 calls no Pallas
kernel, so its path runs as it is.

Tolerances, fp32 unless said (``ModelConfig.dtype="float32"``, the JAX
package's ``embed_inputs`` pinned to fp32 in the test): both packages do
the same fp32 math in other orders.  One ``mamba2_forward`` (output and new
states) within ``FP32_REL`` (1e-5) of each tensor's largest value, the
whole model's logits within ``LOGITS_REL`` (1e-4) of the largest, greedy
tokens equal, every gradient leaf within rtol 1e-4 plus ``GRAD_ATOL_REL``
(1e-5) of the leaf's largest value of ``jax.grad`` (the embedding's
gradient sums a token's terms from every position, which cancel: 6.9e-6
off at a largest value of 0.98, where every other leaf keeps within 1e-6),
one LAMB step's parameters within 1e-6.  The conv states
(and the shared block's ring cache) are bf16 by default in both packages
whatever the compute dtype; the tight cases pin them to fp32 on both sides
(in the test only; ROADMAP.md's trap "bf16 caches amplify sum orders"),
and one serve keeps them bf16, within ``BF16_REL`` (1e-2) of the largest
logit.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import TrainConfig as JTrainConfig
from repro.configs import get_reduced as jget_reduced
from repro.models import layers as JL
from repro.models import mamba2 as JM2
from repro.models import transformer as JT
from repro.data.pipeline import make_batch as jmake_batch
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim import make_schedule as jmake_schedule
from repro.optim import optimizers as JO
from repro.serve import decode as JDEC
from repro.sharding import specs as JS_
from repro.sharding.plan import single_device_plan as jplan
from repro.sharding.plan import test_plan as jtest_plan
from repro.train import step as JS
from repro_torch.common.config import TrainConfig as TTrainConfig
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import get_reduced as tget_reduced
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as TL
from repro_torch.models import mamba2 as TM2
from repro_torch.models import transformer as TT
from repro_torch.optim import leaf_groups
from repro_torch.optim import make_optimizer as tmake_optimizer
from repro_torch.optim import make_schedule as tmake_schedule
from repro_torch.sharding import specs as TS_
from repro_torch.sharding.plan import single_device_plan as tplan
from repro_torch.sharding.plan import test_plan as ttest_plan
from repro_torch.train import step as TS
from repro_torch.weights import (flatten, opt_state_to_jax, params_from_jax,
                                 params_to_jax)
from test_torch_train import _pairs

ARCH = "zamba2-2.7b"
FP32_REL = 1e-5
LOGITS_REL = 1e-4
BF16_REL = 1e-2
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-5
B, S, STEPS = 2, 32, 8


def _fp32_jax(monkeypatch):
    monkeypatch.setattr(JT, "embed_inputs",
                        functools.partial(JT.embed_inputs, dtype=jnp.float32))


def _fp32_caches(monkeypatch):
    """The conv states and the shared block's ring cache in fp32, on both
    sides."""
    for mod, f32 in ((JM2, jnp.float32), (TM2, torch.float32)):
        monkeypatch.setattr(mod, "init_mamba2_cache", functools.partial(
            mod.init_mamba2_cache, dtype=f32))
    for mod, f32 in ((JL, jnp.float32), (TL, torch.float32)):
        monkeypatch.setattr(mod, "init_attention_cache", functools.partial(
            mod.init_attention_cache, dtype=f32))


def _cfgs(dtype="float32"):
    return jget_reduced(ARCH), tget_reduced(ARCH).replace(dtype=dtype)


@pytest.fixture(scope="module")
def jparams():
    """JAX's reduced zamba2 with each Mamba2 block's ``A_log``, ``D``,
    ``dt_bias`` and gated-norm scale redrawn (stacked (R, g, nh))."""
    p = jax.jit(lambda k: JT.init_model(k, jget_reduced(ARCH), jplan()))(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    m = dict(p["stages"][0]["mamba"]["mamba"])
    draw = lambda a, mu, sd: jnp.asarray(
        mu + sd * rng.standard_normal(a.shape), jnp.float32)
    m["A_log"] = draw(m["A_log"], 0.0, 0.5)
    m["dt_bias"] = draw(m["dt_bias"], 0.0, 0.5)
    m["D"] = draw(m["D"], 1.0, 0.1)
    m["norm"] = {"scale": draw(m["norm"]["scale"], 1.0, 0.1)}
    stage = {**p["stages"][0],
             "mamba": {**p["stages"][0]["mamba"], "mamba": m}}
    return {**p, "stages": (stage,)}


def _tparams(jparams, tcfg, compute_cast=True):
    return params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                           device="cpu", compute_cast=compute_cast)


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return np.abs(np.asarray(got, np.float32) - want).max() / np.abs(
        want).max()


def _layer(jparams):
    """Group 0's first Mamba2 block: the JAX leaves and the port's."""
    jp = jax.tree.map(lambda a: np.asarray(a[0, 0]),
                      jparams["stages"][0]["mamba"]["mamba"])
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jp, tp


def _caches(jcfg, tcfg, kind):
    """A fp32 Mamba2 cache for both sides: zeros, or drawn from
    ``default_rng``."""
    jc = JM2.init_mamba2_cache(jcfg, B, jplan(), dtype=jnp.float32)
    if kind == "nonzero":
        rng = np.random.default_rng(11)
        jc = {k: jnp.asarray(rng.standard_normal(v.shape), jnp.float32)
              for k, v in jc.items()}
    return jc, {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}


# =============================================================================
# The Mamba2 block alone
# =============================================================================

@pytest.mark.parametrize("state", [False, True])
def test_causal_conv_matches_jax(state):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, 9, 24)).astype(np.float32)
    w = rng.standard_normal((24, 4)).astype(np.float32)
    st = rng.standard_normal((B, 3, 24)).astype(np.float32) if state else None
    want, wst = JM2._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                 None if st is None else jnp.asarray(st))
    got, gst = TM2._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                None if st is None else torch.from_numpy(st))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(gst.numpy(), np.asarray(wst))
    # a bf16 state before fp32 inputs comes back fp32, as JAX promotes it
    _, gst = TM2._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                              torch.zeros((B, 3, 24), dtype=torch.bfloat16))
    assert gst.dtype == torch.float32


@pytest.mark.parametrize("cache,T", [(None, 64), ("zero", 64),
                                     ("nonzero", 64), ("zero", 16),
                                     ("nonzero", 1)])
def test_mamba2_forward_matches_jax(cache, T, jparams):
    """One block: the chunked path over T 64 (2 chunks) without a cache,
    from a zero and from a nonzero cache, over T 16 (< chunk 32), and the
    O(1) step (T 1 with a cache): the output and every new state."""
    jcfg, tcfg = _cfgs()
    jp, tp = _layer(jparams)
    x = np.random.default_rng(3).standard_normal(
        (B, T, jcfg.d_model)).astype(np.float32)
    jc, tc = (None, None) if cache is None else _caches(jcfg, tcfg, cache)
    want, jc = JM2.mamba2_forward(jp, jnp.asarray(x), jcfg, jplan(),
                                  cache=jc)
    got, tc = TM2.mamba2_forward(tp, torch.from_numpy(x), tcfg, tplan(),
                                 cache=tc)
    assert got.shape == want.shape == x.shape
    assert _rel(got.numpy(), want) < FP32_REL, _rel(got.numpy(), want)
    if cache is None:
        assert tc is None
        return
    assert set(tc) == set(jc) == {"ssm", "conv_x", "conv_B", "conv_C"}
    for k in jc:
        assert tc[k].dtype == torch.float32 and tc[k].shape == jc[k].shape
        assert _rel(tc[k].numpy(), jc[k]) < FP32_REL, (k, _rel(
            tc[k].numpy(), jc[k]))


def test_mamba2_forward_refuses_a_ragged_chunk(jparams):
    """T 48 over chunk 32: both packages refuse it."""
    jcfg, tcfg = _cfgs()
    jp, tp = _layer(jparams)
    x = np.zeros((B, 48, jcfg.d_model), np.float32)
    with pytest.raises(AssertionError, match="divisible"):
        JM2.mamba2_forward(jp, jnp.asarray(x), jcfg, jplan())
    with pytest.raises(ValueError, match="divisible by ssd chunk 32"):
        TM2.mamba2_forward(tp, torch.from_numpy(x), tcfg, tplan())


def test_intra_chunk_equals_the_kernels_plain_version():
    """The chunked path's intra-chunk terms are the ``ssd_chunk`` kernel's
    function: ``ssd_intra_chunk`` against ``kernels.ref.ssd_chunk_ref`` on
    the reduced config's shapes (Q 32, 16 heads of 32, d_state 16)."""
    rng = np.random.default_rng(5)
    b, nc, Q, nh, hd, ds = 2, 3, 32, 16, 32, 16
    xh = rng.standard_normal((b, nc, Q, nh, hd))
    dt = 0.01 + 0.5 * rng.random((b, nc, Q, nh))
    loga = -dt * np.exp(rng.standard_normal(nh))
    Bc, Cc = rng.standard_normal((2, b, nc, Q, ds))
    args = [torch.from_numpy(a.astype(np.float32))
            for a in (xh, dt, loga, Bc, Cc)]
    for got, want in zip(TM2.ssd_intra_chunk(*args),
                         tref.ssd_chunk_ref(*args)):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# =============================================================================
# The reduced model: structure, the forward, serving, training
# =============================================================================

def test_reduced_model_builds_in_groups():
    """``R`` lists of ``g`` Mamba2 blocks and one shared block; the serving
    form casts a Mamba2 block's projections and convolutions only."""
    cfg = tget_reduced(ARCH)
    (stage,) = TT.init_model(cfg, tplan(), device="cpu")["stages"]
    assert set(stage) == {"mamba", "shared_attn"}
    assert [len(g) for g in stage["mamba"]] == [2, 2]
    assert set(stage["shared_attn"]) == {"ln1", "attn", "ln2", "ffn"}
    for blk in (b for g in stage["mamba"] for b in g):
        for name, t in blk["mamba"].items():
            want = torch.bfloat16 if name in TM2.CAST else torch.float32
            leaves = t.values() if isinstance(t, dict) else [t]
            assert all(v.dtype == want for v in leaves), name
        assert blk["ln1"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("use_kernel", [False, True])
def test_reduced_forward_matches_jax(use_kernel, jparams, monkeypatch):
    """The cache-less forward over 2 x 64 tokens (2 chunks): logits within
    1e-4 of the largest; ``use_kernel=True`` launches nothing and gives
    the same bits as ``False`` (the reference ignores it here too)."""
    _fp32_jax(monkeypatch)
    jcfg, tcfg = _cfgs()
    tparams = _tparams(jparams, tcfg)
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (B, 64)).astype(np.int32)
    _, want, _, _ = jax.jit(lambda p, t: JT.forward(
        p, t, jcfg, jplan(), positions=jnp.arange(64)))(jparams,
                                                       jnp.asarray(toks))
    before = tops.launch_counts()
    with torch.inference_mode():
        run = lambda k: TT.forward(
            tparams, torch.from_numpy(toks), tcfg, tplan(),
            positions=torch.arange(64, dtype=torch.int32), use_kernel=k)[1]
        got = run(use_kernel)
        other = run(not use_kernel)
    assert tops.launch_counts() == before
    assert torch.equal(got, other)
    assert _rel(got.numpy(), want) < LOGITS_REL, _rel(got.numpy(), want)


@pytest.mark.parametrize("caches", ["fp32", "bf16"])
def test_reduced_serve_matches_jax(caches, jparams, monkeypatch):
    """Prefill of 32 tokens (one chunk) and 8 greedy decode steps on the
    O(1) path, each side fed its own tokens, against JAX's
    ``prefill_fn``/``decode_step_fn``: tokens equal; logits within 1e-4 of
    the largest with the caches pinned to fp32, within 1e-2 with the
    packages' bf16 conv states and ring cache (which fp32 compute turns
    fp32 after the prefill in both)."""
    _fp32_jax(monkeypatch)
    if caches == "fp32":
        _fp32_caches(monkeypatch)
    jcfg, tcfg = _cfgs()
    tparams = _tparams(jparams, tcfg)
    seen = []
    sample = JDEC.greedy_sample

    def greedy_sample(logits, plan):
        jax.debug.callback(lambda a: seen.append(np.asarray(a)), logits)
        return sample(logits, plan)

    monkeypatch.setattr(JDEC, "greedy_sample", greedy_sample)
    toks = np.random.default_rng(0).integers(
        8, jcfg.vocab_size, (B, S)).astype(np.int32)
    L = S + STEPS
    jpre = jax.jit(functools.partial(JDEC.prefill_fn, cfg=jcfg, plan=jplan()))
    jdec = jax.jit(functools.partial(JDEC.decode_step_fn, cfg=jcfg,
                                     plan=jplan()))
    tok, jc = jpre(jparams, jnp.asarray(toks), JT.init_caches(jcfg, B, L,
                                                              jplan()))
    jtoks = [np.asarray(tok)]
    for i in range(STEPS):
        tok, jc = jdec(jparams, tok, jc, jnp.int32(S + i))
        jtoks.append(np.asarray(tok))
    jax.effects_barrier()
    from repro_torch.serve.decode import decode_step_fn, prefill_fn
    tc = TT.init_caches(tcfg, B, L, tplan(), device="cpu")
    assert tc[0][0]["mamba"][0]["conv_x"].dtype == (
        torch.float32 if caches == "fp32" else torch.bfloat16)
    run = dict(cfg=tcfg, plan=tplan())
    with torch.inference_mode():
        ttok, tc, lg = prefill_fn(tparams, torch.from_numpy(toks), tc, **run)
        tlog, ttoks = [lg.numpy()], [ttok.numpy()]
        for i in range(STEPS):
            ttok, tc, lg = decode_step_fn(tparams, ttok, tc, S + i, **run)
            tlog.append(lg.numpy())
            ttoks.append(ttok.numpy())
    assert tc[0][1]["mamba"][1]["conv_x"].dtype == torch.float32
    tol = LOGITS_REL if caches == "fp32" else BF16_REL
    assert len(seen) == len(tlog) == STEPS + 1
    for i, (a, b) in enumerate(zip(tlog, seen)):
        assert _rel(a, b) < tol, (i, _rel(a, b))
    np.testing.assert_array_equal(np.stack(ttoks), np.stack(jtoks))


def test_reduced_training_step_matches_jax(jparams, monkeypatch):
    """The loss and every gradient leaf (the twice-stacked Mamba2 leaves
    and the unstacked shared block) against ``jax.grad`` with remat, then
    one LAMB step through the port's ``build_train_step`` against the JAX
    package's clip and LAMB: the twice-stacked vectors (``A_log``, ``D``,
    ``dt_bias``, the norm scales) are decayed, the shared block's norm
    scales are not, as ``p.ndim >= 2`` decides in JAX."""
    _fp32_jax(monkeypatch)
    jcfg, tcfg = _cfgs()
    assert jcfg.remat and tcfg.remat
    tparams = _tparams(jparams, tcfg, compute_cast=False)
    batch = jmake_batch(jcfg, B, 64, seed=0, step=0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jgrads, jm = jax.jit(jax.grad(lambda p: JS._ce_loss(p, jb, jcfg,
                                                        jplan()),
                                  has_aux=True))(jparams)
    for _, p, _ in _pairs(tparams, tparams):
        p.requires_grad_(True)
    loss, tm = TS._ce_loss(tparams, TS.to_device(batch, "cpu"), tcfg,
                           tplan())
    loss.backward()
    np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]), rtol=1e-5)
    want = _tparams(jgrads, tcfg, compute_cast=False)
    n = 0
    for path, p, g in _pairs(tparams, want):
        torch.testing.assert_close(p.grad, g, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_REL * g.abs().max().item(),
                                   msg=path)
        n += 1
    assert n == 4 * 14 + 9 + 3     # Mamba2 blocks, the shared one, the ends
    decayed = {g.name: g.ndim >= 2 for g in leaf_groups(tparams)}
    assert decayed["stages.0.mamba.mamba.A_log"]
    assert decayed["stages.0.mamba.ln1.scale"]
    assert not decayed["stages.0.shared_attn.ln1.scale"]

    kw = dict(global_batch_size=B, seq_len=64, steps=1, warmup_steps=1)
    jt, tt = JTrainConfig(**kw), TTrainConfig(**kw)
    jopt, topt = jmake_optimizer("lamb"), tmake_optimizer("lamb")
    lr = jmake_schedule("cosine", 3e-4, 1, 1)(1)

    @jax.jit
    def lamb_step(g, p):
        g_upd, _ = JO.clip_by_global_norm(g, jt.grad_clip)
        return jopt.update(g_upd, jopt.init(p), p, lr)[0]
    jnew = lamb_step(jgrads, jparams)
    tparams = _tparams(jparams, tcfg, compute_cast=False)
    tstep = TS.build_train_step(tcfg, tt, tplan(), topt,
                                tmake_schedule("cosine", 3e-4, 1, 1),
                                tparams, batch)
    tnew, _, _ = tstep(tparams, topt.init(tparams), batch, 1)
    want = _tparams(jnew, tcfg, compute_cast=False)
    for path, p, w in _pairs(tnew, want):
        torch.testing.assert_close(p.detach(), w, rtol=0, atol=1e-6,
                                   msg=path)


# =============================================================================
# The JAX layout: converters, checkpoint keys, specs; the registry
# =============================================================================

def test_jax_layout_keys_and_shapes(jparams):
    """``params_to_jax`` gives the reference's tree (the Mamba2 leaves
    stacked (R, g, ...), the shared block whole), and the optimizer
    state's checkpoint keys and shapes are the reference's LAMB state's."""
    _, tcfg = _cfgs()
    tparams = _tparams(jparams, tcfg, compute_cast=False)
    want = flatten(jax.tree.map(np.asarray, jparams))
    got = flatten(params_to_jax(tparams))
    assert set(got) == set(want)
    assert want["stages/0/mamba/mamba/A_log"].shape == (2, 2, 16)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jstate = jmake_optimizer("lamb").init(jparams)
    topt = tmake_optimizer("lamb")
    want = flatten({k: jstate[k] for k in ("m", "v")}, "o/")
    got = flatten(opt_state_to_jax(topt.init(tparams), tparams), "o/")
    got.pop("o/step")
    assert {k: v.shape for k, v in got.items()} == {
        k: np.shape(v) for k, v in want.items()}


def _jax_flat_specs(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(JS_._path_names(p)): tuple(s) for p, s in flat}


def test_specs_match_jax(jparams):
    """Every parameter and cache leaf's spec over a (data 2, model 2) plan
    against JAX's (a stacked leaf's leading dims replicated there)."""
    jcfg, tcfg = _cfgs()
    jp, tp = jtest_plan(2, 2), ttest_plan(2, 2)
    tparams = _tparams(jparams, tcfg, compute_cast=False)
    want = _jax_flat_specs(JS_.param_specs(jparams, jcfg, jp))
    got = TS_.param_specs(tparams, tcfg, tp)
    groups = leaf_groups(tparams)
    assert len(groups) == len(want)
    for g in groups:
        w = want[g.name.replace(".", "/")]
        w += (None,) * (g.ndim - len(w))       # JAX's P() of a replicated leaf
        assert w[:len(g.stack)] == (None,) * len(g.stack), g.name
        assert tuple(g.of(got)) == w[len(g.stack):], g.name
    assert tuple(got["stages"][0]["mamba"][1][0]["mamba"]["wx"]) == (
        None, "model")

    Bg, L = 4, 64
    want = _jax_flat_specs(JS_.cache_specs(
        JT.init_caches(jcfg, Bg, L, jplan()), jcfg, jp, Bg))
    caches = TT.init_caches(tcfg, Bg, L, tplan(), device="cpu")
    got = TS_.cache_specs(caches, tcfg, tp, Bg)
    seen = set()

    def check(path, leaf):
        # (stage, group, "mamba", block, name) or (stage, group, "attn",
        # name): JAX stacks the Mamba2 caches (R, g), the ring cache (R,)
        spec = got
        for k in path:
            spec = spec[k] if isinstance(spec, dict) else spec[int(k)]
        i, _, part, *rest = path
        key = "/".join((i, part, rest[-1]))
        lead = 2 if part == "mamba" else 1
        assert want[key] == (None,) * lead + tuple(spec), key
        seen.add(key)
    TS_.map_tree(check, caches)
    assert seen == set(want)
    assert want["0/mamba/ssm"] == (None, None, "data", "model", None, None)


def test_full_config_stages_and_count():
    """The full zamba2 is 9 groups of 6 Mamba2 blocks (a depth that is no
    multiple of 6 is refused), and its ``param_count`` is the reference's
    (it counts the x/z projections twice: 3.84 B, where the built model
    has 2.42 B)."""
    from repro.configs import get_config as jget_config
    cfg = tget_config(ARCH)
    TT._check_supported(cfg)
    assert [(s.kind, s.repeats) for s in TT.build_stages(cfg)] == [
        ("mamba_group", 9)]
    assert cfg.param_count() == jget_config(ARCH).param_count()
    assert round(cfg.param_count() / 1e9, 2) == 3.84
    with pytest.raises(ValueError, match="multiple of ssm_layers_per_attn"):
        TT.build_stages(cfg.replace(num_layers=50))
