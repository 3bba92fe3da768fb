"""deepseek-v3's latent attention (MLA) and multi-token-prediction head
against the JAX package, on the reduced deepseek-v3-671b config (2 layers:
a dense MLA layer and a MoE layer with a shared expert and SMILE routing,
grid (2, 2); the MTP head's dense MLA block).

Weights come from the JAX package's ``init_model`` through
``params_from_jax``; inputs are drawn with numpy ``default_rng``.  The JAX
side runs with ``use_kernel=False`` (Pallas does not run on this JAX) and
its routing kernels take their oracles; the port runs its kernel path
where the test says so (on the CPU: the kernels' plain versions).

Tolerances.  In fp32 (``ModelConfig.dtype="float32"``, the JAX package's
``embed_inputs`` pinned to fp32 in the test) both packages do the same fp32
math in other orders: logits within ``FP32_REL`` (1e-4) of the largest,
tokens and the routers' expert ids equal, ``ce`` and ``mtp`` within 1e-5,
every gradient leaf (the MTP head's included) within rtol 1e-4 / atol
1e-6 of ``jax.grad``, and one LAMB step's parameters within 1e-6.  The
latent cache is bf16 in both packages whatever the compute dtype; the
tight cases pin it to fp32 on both sides (in the test only: a latent on a
bf16 rounding edge, nudged by another fp32 sum order, rounds the other
way, as ROADMAP.md's trap "bf16 caches amplify sum orders" sets out), and
the bf16 cache is held within ``BF16_REL`` (1e-2) of the largest logit;
the served config's bf16 compute within ``LOGITS_ATOL``, the bf16
tolerance of ``test_torch_serve.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.core import moe as JMOE
from repro.data.pipeline import make_batch as jmake_batch
from repro.kernels import ops as jops
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim import make_schedule as jmake_schedule
from repro.optim import optimizers as JO
from repro.sharding.plan import single_device_plan as jplan
from repro.train import step as JS
from repro_torch.common.config import TrainConfig as TTrainConfig
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import get_reduced as tget_reduced
from repro_torch.core import moe as TMOE
from repro_torch.kernels import ops as tops
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.optim import make_optimizer as tmake_optimizer
from repro_torch.optim import make_schedule as tmake_schedule
from repro_torch.serve.engine import Engine
from repro_torch.sharding.plan import single_device_plan as tplan
from repro_torch.train import step as TS
from repro_torch.weights import params_from_jax
from test_torch_train import _pairs

ARCH = "deepseek-v3-671b"
OPTS = dict(router_impl="fused", sort_impl="radix")
FP32_REL = 1e-4
BF16_REL = 1e-2
LOGITS_ATOL = 3e-2      # test_torch_serve.py's bf16 tolerance
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
B, S, STEPS = 2, 16, 4


@pytest.fixture(autouse=True)
def _jax_oracles(monkeypatch):
    monkeypatch.setattr(jops, "RADIX_MIN_ROWS", 1 << 30)
    monkeypatch.setattr(jops, "ROUTER_FUSED_MIN_ROWS", 1 << 30)


def _fp32_jax(monkeypatch):
    monkeypatch.setattr(JT, "embed_inputs",
                        functools.partial(JT.embed_inputs, dtype=jnp.float32))


def _fp32_latent_cache(monkeypatch):
    monkeypatch.setattr(JL, "init_mla_cache", functools.partial(
        JL.init_mla_cache, dtype=jnp.float32))
    monkeypatch.setattr(TL, "init_mla_cache", functools.partial(
        TL.init_mla_cache, dtype=torch.float32))


def _cfgs(dtype="float32"):
    return jget_reduced(ARCH), tget_reduced(ARCH).replace(dtype=dtype)


@pytest.fixture(scope="module")
def jparams():
    return jax.jit(lambda k: JT.init_model(k, jget_reduced(ARCH), jplan()))(
        jax.random.PRNGKey(0))


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return np.abs(np.asarray(got, np.float32) - want).max() / np.abs(
        want).max()


def _record_topk(monkeypatch):
    """The expert ids of every top-k call, in call order, on both sides
    (JAX's from inside its layer scan, through a debug callback)."""
    seen = {"jax": [], "torch": []}
    jtop, ttop = JMOE.topk_gates, TMOE.topk_gates

    def jrec(probs, k, renorm):
        g, i = jtop(probs, k, renorm)
        jax.debug.callback(lambda a: seen["jax"].append(np.asarray(a)), i,
                           ordered=True)
        return g, i

    def trec(probs, k, renorm):
        g, i = ttop(probs, k, renorm)
        seen["torch"].append(i.numpy().copy())
        return g, i

    monkeypatch.setattr(JMOE, "topk_gates", jrec)
    monkeypatch.setattr(TMOE, "topk_gates", trec)
    return seen


# =============================================================================
# mla_forward alone
# =============================================================================

@pytest.mark.parametrize("cache", [None, "float32", "bfloat16"])
def test_mla_forward_matches_jax(cache, jparams):
    """One MLA layer: the naive path over a prompt (no cache, or writing
    the ring cache), then ``STEPS`` cached single-token steps on the
    absorbed path, against ``repro.models.layers.mla_forward``."""
    jcfg, tcfg = _cfgs()
    jp = jax.tree.map(lambda a: np.asarray(a[0]),
                      jparams["stages"][0]["blocks"]["attn"])
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    rng = np.random.default_rng(3)
    xs = rng.standard_normal((STEPS + 1, B, S, jcfg.d_model)).astype(
        np.float32)
    W = S + STEPS
    if cache is None:
        jc = tc = None
    else:
        jc = JL.init_mla_cache(jcfg, B, W, jplan(), dtype=getattr(jnp, cache))
        tc = TL.init_mla_cache(tcfg, B, W, tplan(),
                               dtype=getattr(torch, cache))
    tol = BF16_REL if cache == "bfloat16" else FP32_REL
    for i in range(STEPS + 1 if cache else 1):
        x = xs[i] if i == 0 else xs[i][:, :1]
        pos = np.arange(S) if i == 0 else np.array([S + i - 1])
        pos = pos.astype(np.int32)
        want, jc = JL.mla_forward(jp, jnp.asarray(x), jcfg, jplan(),
                                  positions=jnp.asarray(pos), cache=jc)
        got, tc = TL.mla_forward(tp, torch.from_numpy(x), tcfg, tplan(),
                                 positions=torch.from_numpy(pos), cache=tc)
        assert got.shape == want.shape == x.shape
        assert _rel(got.numpy(), want) < tol, (i, _rel(got.numpy(), want))
    if cache is not None:
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        assert tc["ckv"].dtype == getattr(torch, cache)
        assert _rel(tc["ckv"].float().numpy(), jc["ckv"]) < tol


def test_absorbed_decode_equals_the_naive_path():
    """The absorbed step computes the naive path's attention: the same
    layer over the same latent cache gives the same output both ways
    (fp32, fp32 cache)."""
    _, tcfg = _cfgs()
    gen = torch.Generator().manual_seed(0)
    p = TL.init_mla(tcfg, generator=gen)
    x = torch.randn((B, S + 1, tcfg.d_model), generator=gen)
    c = TL.init_mla_cache(tcfg, B, S + 1, tplan(), dtype=torch.float32)
    naive, _ = TL.mla_forward(p, x, tcfg, tplan(),
                              positions=torch.arange(S + 1), cache=c)
    c = TL.init_mla_cache(tcfg, B, S + 1, tplan(), dtype=torch.float32)
    TL.mla_forward(p, x[:, :S], tcfg, tplan(), positions=torch.arange(S),
                   cache=c)
    step, _ = TL.mla_forward(p, x[:, S:], tcfg, tplan(),
                             positions=torch.tensor([S]), cache=c)
    torch.testing.assert_close(step, naive[:, S:], rtol=1e-5, atol=1e-6)


# =============================================================================
# The reduced model: serve, the cache-less kernel forward, a training step
# =============================================================================

def _serve_both(jparams, tparams, jcfg, tcfg, seen=None):
    """Prefill ``S`` tokens, then ``STEPS`` decode steps fed JAX's greedy
    tokens; yields ``(step, JAX logits, port logits, JAX stats, port
    stats)``."""
    toks = np.random.default_rng(0).integers(
        8, jcfg.vocab_size, (B, S)).astype(np.int32)
    jc = JT.init_caches(jcfg, B, S + STEPS, jplan())
    jfwd = jax.jit(lambda p, t, pos, c: JT.forward(p, t, jcfg, jplan(),
                                                  positions=pos, caches=c))
    tc = TT.init_caches(tcfg, B, S + STEPS, tplan(), device="cpu")
    for i in range(STEPS + 1):
        pos = (np.arange(S) if i == 0 else np.array([S + i - 1])).astype(
            np.int32)
        _, jl, js, jc = jfwd(jparams, jnp.asarray(toks), jnp.asarray(pos),
                             jc)
        jax.effects_barrier()
        with torch.inference_mode():
            _, tl, ts, tc = TT.forward(tparams, torch.from_numpy(toks), tcfg,
                                       tplan(), positions=torch.from_numpy(
                                           pos), caches=tc, use_kernel=True)
        yield i, np.asarray(jl), tl.float().numpy(), js, ts
        toks = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]


def test_reduced_serve_matches_jax_fp32(jparams, monkeypatch):
    """Prefill and 4 absorbed decode steps in fp32 (latent cache pinned to
    fp32): greedy tokens and every router's expert ids equal, the MoE
    statistics exact, logits within 1e-4 of the largest."""
    _fp32_jax(monkeypatch)
    _fp32_latent_cache(monkeypatch)
    seen = _record_topk(monkeypatch)
    jcfg, tcfg = _cfgs()
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    before = tops.launch_counts()
    for i, jl, tl, js, ts in _serve_both(jparams, tparams, jcfg, tcfg):
        assert tl.shape == jl.shape
        assert _rel(tl, jl) < FP32_REL, (i, _rel(tl, jl))
        np.testing.assert_array_equal(tl[:, -1].argmax(-1),
                                      jl[:, -1].argmax(-1))
        for f in ("drop_frac", "hop_drop_frac", "hop_max_load"):
            np.testing.assert_array_equal(
                np.asarray(getattr(ts, f)), np.asarray(getattr(js, f)), f)
    assert tops.launch_counts() == before       # CPU: plain versions only
    # SMILE's two hops a MoE layer a forward
    assert len(seen["torch"]) == len(seen["jax"]) == 2 * (STEPS + 1)
    for a, b in zip(seen["torch"], seen["jax"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_serve_with_the_bf16_latent_cache(dtype, jparams,
                                                  monkeypatch):
    """The latent cache as both packages make it (bf16): in fp32 compute
    the logits within 1e-2 of the largest; in the served config's bf16
    compute within ``LOGITS_ATOL`` (3e-2, the bf16 tolerance of
    ``test_torch_serve.py``: the two frameworks round bf16 intermediates
    at other places; the reading is 1.0-1.7e-2 of the largest logit here
    with every route equal).  Greedy tokens equal where the top-2 margin
    is more than twice the tolerance."""
    if dtype == "float32":
        _fp32_jax(monkeypatch)
    jcfg, tcfg = _cfgs(dtype)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    tc = TT.init_caches(tcfg, B, S, tplan(), device="cpu")
    assert tc[0][0]["ckv"].dtype == torch.bfloat16
    n_sure = 0
    for i, jl, tl, _, _ in _serve_both(jparams, tparams, jcfg, tcfg):
        tol = (BF16_REL * np.abs(jl).max() if dtype == "float32"
               else LOGITS_ATOL)
        assert np.abs(tl - jl).max() < tol, (i, np.abs(tl - jl).max())
        top2 = np.sort(jl[:, -1], axis=-1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > 2 * tol
        n_sure += sure.sum()
        np.testing.assert_array_equal(tl[:, -1].argmax(-1)[sure],
                                      jl[:, -1].argmax(-1)[sure])
    assert n_sure >= B * (STEPS + 1) // 2       # the check has teeth


def test_reduced_cacheless_kernel_forward_matches_jax(jparams, monkeypatch):
    """The cache-less forward through the kernel path (MoE kernels; MLA
    takes no kernel, as in the reference) against JAX's plain forward,
    fp32: logits within 1e-4 of the largest."""
    _fp32_jax(monkeypatch)
    jcfg, tcfg = _cfgs()
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (B, 32)).astype(np.int32)
    _, want, _, _ = JT.forward(jparams, jnp.asarray(toks), jcfg, jplan(),
                               positions=jnp.arange(32))
    with torch.inference_mode():
        _, got, _, caches = TT.forward(
            tparams, torch.from_numpy(toks), tcfg, tplan(),
            positions=torch.arange(32, dtype=torch.int32), use_kernel=True)
    assert caches is None
    assert _rel(got.numpy(), want) < FP32_REL


def test_reduced_training_step_matches_jax(jparams, monkeypatch):
    """The loss with the MTP head (``ce``, ``mtp``), every gradient leaf
    against ``jax.grad`` (the MTP head's unstacked leaves included), then
    one LAMB step through both packages' ``build_train_step``: the
    updated parameters within 1e-6."""
    _fp32_jax(monkeypatch)
    jcfg = jget_reduced(ARCH).replace(moe=jget_reduced(
        ARCH).moe.with_options(**OPTS))
    tcfg = tget_reduced(ARCH).replace(moe=tget_reduced(
        ARCH).moe.with_options(**OPTS), dtype="float32")
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu", compute_cast=False)
    batch = jmake_batch(jcfg, B, 32, seed=0, step=0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jgrads, jm = jax.jit(jax.grad(lambda p: JS._ce_loss(p, jb, jcfg,
                                                        jplan()),
                                  has_aux=True))(jparams)
    for _, p, _ in _pairs(tparams, tparams):
        p.requires_grad_(True)
    loss, tm = TS._ce_loss(tparams, TS.to_device(batch, "cpu"), tcfg,
                           tplan())
    loss.backward()
    assert float(jm["mtp"]) > 0
    for k in ("ce", "mtp", "loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), tcfg,
                           device="cpu", compute_cast=False)
    n = 0
    for path, p, g in _pairs(tparams, want):
        torch.testing.assert_close(p.grad, g, **GRAD_TOL, msg=path)
        n += path.startswith(".mtp")
    assert n == len(list(_pairs(tparams["mtp"], tparams["mtp"])))
    assert n >= 12

    # one LAMB step: the JAX package's clip and LAMB on its gradients,
    # against the port's whole step through build_train_step
    kw = dict(global_batch_size=B, seq_len=32, steps=1, warmup_steps=1)
    jt, tt = JTrainConfig(**kw), TTrainConfig(**kw)
    jopt, topt = jmake_optimizer("lamb"), tmake_optimizer("lamb")
    lr = jmake_schedule("cosine", 3e-4, 1, 1)(1)

    @jax.jit
    def lamb_step(g, p):
        g_upd, _ = JO.clip_by_global_norm(g, jt.grad_clip)
        return jopt.update(g_upd, jopt.init(p), p, lr)[0]
    jnew = lamb_step(jgrads, jparams)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu", compute_cast=False)
    tstep = TS.build_train_step(tcfg, tt, tplan(), topt,
                                tmake_schedule("cosine", 3e-4, 1, 1),
                                tparams, batch)
    tnew, _, tm = tstep(tparams, topt.init(tparams), batch, 1)
    np.testing.assert_allclose(float(tm["mtp"]), float(jm["mtp"]), rtol=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, jnew), tcfg,
                           device="cpu", compute_cast=False)
    for path, p, w in _pairs(tnew, want):
        torch.testing.assert_close(p.detach(), w, rtol=0, atol=1e-6,
                                   msg=path)


# =============================================================================
# Structure: the engine's gate, the full config
# =============================================================================

def test_engine_refuses_mla():
    cfg = tget_reduced(ARCH)
    assert not TT.paged_cache_supported(cfg)
    params = TT.init_model(cfg, tplan(), device="cpu")
    with pytest.raises(ValueError, match="MLA"):
        Engine(params, cfg, tplan())


def test_full_config_builds_on_the_meta_device():
    """The full deepseek-v3 config passes the port's checks and its
    stages are the reference's: 3 dense layers, 58 MoE layers, the MTP
    head; ``param_count`` is the reference's (its MTP term counts a MoE
    layer, though the head's block is dense)."""
    cfg = tget_config(ARCH)
    TT._check_supported(cfg)
    assert [(s.kind, s.repeats) for s in TT.build_stages(cfg)] == [
        ("dense", 3), ("moe", 58)]
    assert cfg.param_count() == jget_config(ARCH).param_count()
