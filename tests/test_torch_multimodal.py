"""musicgen's codebooks and phi-3-vision's image tokens against the JAX
package, on their reduced configs (2 layers): the forward, the fixed-batch
serve (prefill, then decode steps fed JAX's greedy tokens) and the loss
with its gradients.

musicgen-large reads tokens (B, K, S) (K = 4 codebooks, their embeddings
summed), gives logits (B, T, K, V) from a head per codebook and decodes
(B, K) tokens a step.  phi-3-vision-4.2b writes projected image embeddings
over the token embeddings at ``image_pos``; its serve is text only, as the
reference's.

Weights come from the JAX package's ``init_model`` through
``params_from_jax``; inputs are drawn with numpy ``default_rng`` (the
training batches by the data pipeline, equal array for array in both
packages).  Both packages compute in fp32 (``ModelConfig.dtype`` on the
port's side, the JAX package's ``embed_inputs`` pinned to fp32 in the
test), and the ring KV caches are pinned to fp32 on both sides (in the
test only; ROADMAP.md's trap "bf16 caches amplify sum orders"): logits
within ``FP32_REL`` (1e-4) of the largest, tokens equal, the loss within
1e-5 and every gradient leaf within rtol 1e-4 / atol 1e-6 of
``jax.grad``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.data.pipeline import make_batch as jmake_batch
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serve import decode as JDEC
from repro.sharding.plan import single_device_plan as jplan
from repro.train import evaluate as JE
from repro.train import step as JS
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import get_reduced as tget_reduced
from repro_torch.launch.serve import serve
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.serve import decode as TDEC
from repro_torch.serve.engine import Engine
from repro_torch.sharding.plan import single_device_plan as tplan
from repro_torch.train import evaluate as TE
from repro_torch.train import step as TS
from repro_torch.weights import params_from_jax
from test_torch_mla import _rel
from test_torch_train import _pairs

MUSIC, VISION = "musicgen-large", "phi-3-vision-4.2b"
FP32_REL = 1e-4
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
B, S, STEPS = 2, 32, 4


@pytest.fixture(autouse=True)
def _fp32(monkeypatch):
    monkeypatch.setattr(JT, "embed_inputs",
                        functools.partial(JT.embed_inputs, dtype=jnp.float32))
    monkeypatch.setattr(JL, "init_attention_cache", functools.partial(
        JL.init_attention_cache, dtype=jnp.float32))
    monkeypatch.setattr(TL, "init_attention_cache", functools.partial(
        TL.init_attention_cache, dtype=torch.float32))


@pytest.fixture(scope="module")
def setup():
    """``setup(arch, compute_cast=True)``: the JAX config and parameters
    (drawn once a module) and the port's fp32 config and parameters
    carried across."""
    drawn = {}

    def get(arch, compute_cast=True):
        jcfg = jget_reduced(arch)
        if arch not in drawn:
            drawn[arch] = jax.jit(lambda k: JT.init_model(k, jcfg, jplan()))(
                jax.random.PRNGKey(0))
        tcfg = tget_reduced(arch).replace(dtype="float32")
        tparams = params_from_jax(jax.tree.map(np.asarray, drawn[arch]),
                                  tcfg, device="cpu",
                                  compute_cast=compute_cast)
        return jcfg, tcfg, drawn[arch], tparams
    return get


def _image_inputs(cfg, seed=2):
    rng = np.random.default_rng(seed)
    P = cfg.vision_tokens
    emb = rng.standard_normal((B, P, cfg.vision_embed_dim)).astype(
        np.float32)
    pos = np.stack([rng.permutation(S)[:P] for _ in range(B)]).astype(
        np.int32)
    return {"image_embeds": emb, "image_pos": pos}


def _tokens(cfg, seed=1):
    shape = (B, cfg.num_codebooks, S) if cfg.num_codebooks > 1 else (B, S)
    return np.random.default_rng(seed).integers(
        8, cfg.vocab_size, shape).astype(np.int32)


# =============================================================================
# The forward
# =============================================================================

@pytest.mark.parametrize("arch,images", [(MUSIC, False), (VISION, False),
                                         (VISION, True)])
def test_forward_matches_jax(arch, images, setup):
    """The cache-less forward (the port's kernel path: on the CPU the
    plain versions) against JAX's, with and without image embeddings
    (at positions drawn anywhere in each row)."""
    jcfg, tcfg, jparams, tparams = setup(arch)
    toks = _tokens(jcfg)
    extra = _image_inputs(jcfg) if images else None
    _, want, _, _ = jax.jit(lambda p, t, e: JT.forward(
        p, t, jcfg, jplan(), positions=jnp.arange(S), extra=e))(
        jparams, jnp.asarray(toks),
        None if extra is None else jax.tree.map(jnp.asarray, extra))
    with torch.inference_mode():
        _, got, _, _ = TT.forward(
            tparams, torch.from_numpy(toks), tcfg, tplan(),
            positions=torch.arange(S, dtype=torch.int32), use_kernel=True,
            extra=None if extra is None else {
                k: torch.from_numpy(v) for k, v in extra.items()})
    V = jcfg.vocab_size
    assert got.shape == want.shape == ((B, S, 4, V) if arch == MUSIC
                                       else (B, S, V))
    assert _rel(got.numpy(), want) < FP32_REL
    if images:
        # the images moved the logits: the rows are not the text's
        _, text, _, _ = TT.forward(tparams, torch.from_numpy(toks), tcfg,
                                   tplan(), positions=torch.arange(S))
        assert _rel(text.detach().numpy(), want) > 1e-2


# =============================================================================
# Serving
# =============================================================================

@pytest.mark.parametrize("arch", [MUSIC, VISION])
def test_serve_matches_jax(arch, setup, monkeypatch):
    """``prefill_fn`` then ``STEPS`` ``decode_step_fn`` calls on both
    sides, each fed JAX's tokens ((B, K) a step under musicgen's
    codebooks): tokens equal, logits within 1e-4 of the largest."""
    jcfg, tcfg, jparams, tparams = setup(arch)
    toks = _tokens(jcfg)
    jc = JT.init_caches(jcfg, B, S + STEPS, jplan())
    tc = TT.init_caches(tcfg, B, S + STEPS, tplan(), device="cpu")
    seen = []
    sample = JDEC.greedy_sample
    pf = jax.jit(lambda p, t, c: JDEC.prefill_fn(p, t, c, cfg=jcfg,
                                                 plan=jplan()))
    dc = jax.jit(lambda p, t, c, s: JDEC.decode_step_fn(p, t, c, s, cfg=jcfg,
                                                        plan=jplan()))

    def greedy(logits, plan):
        jax.debug.callback(lambda a: seen.append(np.asarray(a)), logits,
                           ordered=True)
        return sample(logits, plan)
    monkeypatch.setattr(JDEC, "greedy_sample", greedy)
    jtok, jc = pf(jparams, jnp.asarray(toks), jc)
    jax.effects_barrier()
    with torch.inference_mode():
        ttok, tc, tl = TDEC.prefill_fn(tparams, torch.from_numpy(toks),
                                       tc, cfg=tcfg, plan=tplan())
    for i in range(STEPS + 1):
        want = seen[-1]
        assert tl.shape == want.shape
        assert _rel(tl.numpy(), want) < FP32_REL, (i, _rel(tl, want))
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        if i == STEPS:
            break
        fed = torch.from_numpy(np.array(jtok))
        jtok, jc = dc(jparams, jtok, jc, jnp.int32(S + i))
        jax.effects_barrier()
        with torch.inference_mode():
            ttok, tc, tl = TDEC.decode_step_fn(tparams, fed, tc, S + i,
                                               cfg=tcfg, plan=tplan())
    assert ttok.shape == ((B, 4) if arch == MUSIC else (B,))


def test_serve_draws_a_prompt_stream_a_codebook():
    """``serve`` draws K prompt streams as the reference's launcher does
    and returns (B, K, new_tokens) tokens."""
    from repro.data.pipeline import synthetic_tokens as jsynthetic
    from repro_torch.launch.serve import serve_prompts
    cfg = tget_reduced(MUSIC)
    rng = np.random.default_rng(0)
    want = np.stack([jsynthetic(rng, 2, 8, cfg.vocab_size)
                     for _ in range(cfg.num_codebooks)], 1)
    got = serve_prompts(cfg, 2, 8, 0, "cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    res = serve(MUSIC, batch=2, prompt_len=8, new_tokens=3, device="cpu")
    assert res.tokens.shape == (2, 4, 3) and res.logits_finite


def test_engine_refuses_codebooks_and_admits_vision_text():
    for arch, ok in ((MUSIC, False), (VISION, True)):
        cfg = tget_reduced(arch)
        assert TT.paged_cache_supported(cfg) == ok
    cfg = tget_reduced(MUSIC)
    with pytest.raises(ValueError, match="single-stream"):
        Engine(TT.init_model(cfg, tplan(), device="cpu"), cfg, tplan())


# =============================================================================
# Training
# =============================================================================

@pytest.mark.parametrize("arch", [MUSIC, VISION])
def test_loss_and_gradients_match_jax(arch, setup):
    """The data pipeline's batch (musicgen: labels (B, K, S) with the delay
    pattern; phi-3-vision: image embeddings at positions 1..P with their
    labels ignored): the loss, every gradient leaf, and ``evaluate``'s
    cross-entropy."""
    jcfg, tcfg, jparams, tparams = setup(arch, compute_cast=False)
    batch = jmake_batch(jcfg, B, S, seed=0, step=0)
    if arch == VISION:
        assert {"image_embeds", "image_pos"} <= set(batch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jgrads, jm = jax.jit(jax.grad(
        lambda p: JS._ce_loss(p, jb, jcfg, jplan()), has_aux=True))(jparams)
    for _, p, _ in _pairs(tparams, tparams):
        p.requires_grad_(True)
    loss, tm = TS._ce_loss(tparams, TS.to_device(batch, "cpu"), tcfg,
                           tplan())
    loss.backward()
    for k in ("ce", "loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    assert float(tm["mtp"]) == float(jm["mtp"]) == 0.0
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), tcfg,
                           device="cpu", compute_cast=False)
    n = 0
    for path, p, g in _pairs(tparams, want):
        torch.testing.assert_close(p.grad, g, **GRAD_TOL, msg=path)
        n += 1
    assert n > 20
    if arch == VISION:
        assert float(tparams["vision_proj"]["w"].grad.abs().max()) > 0
    else:
        assert tparams["embed"]["table"].grad.shape[0] == 4
    jev = JE.evaluate(jparams, jcfg, jplan(), batch=B, seq=S, n_batches=1)
    tev = TE.evaluate(tparams, tcfg, tplan(), batch=B, seq=S, n_batches=1)
    np.testing.assert_allclose(tev["eval_ce"], jev["eval_ce"], rtol=1e-5)
    assert tev["eval_tokens"] == jev["eval_tokens"]


@pytest.mark.parametrize("arch", [MUSIC, VISION])
def test_full_config_stages_and_leaves(arch):
    """The full config passes the port's checks; the leaves beside the
    stages are the reference's (codebook tables and heads, no LM head; the
    vision projection)."""
    cfg = tget_config(arch)
    TT._check_supported(cfg)
    small = tget_reduced(arch)
    p = TT.init_model(small, tplan(), device="cpu")
    if arch == MUSIC:
        assert set(p) == {"embed", "heads", "stages", "final_norm"}
        assert tuple(p["heads"]["w"].shape) == (4, small.vocab_size,
                                                small.d_model)
    else:
        assert set(p) == {"embed", "lm_head", "vision_proj", "stages",
                          "final_norm"}
        assert tuple(p["vision_proj"]["w"].shape) == (small.vision_embed_dim,
                                                      small.d_model)


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", MUSIC, VISION])
def test_checkpoint_loads_in_jax_under_the_reference_keys(arch, tmp_path,
                                                        setup):
    """The port's checkpoint of the new leaves (MLA, the MTP head, the
    codebook tables and heads, the vision projection) with LAMB's moments
    loads into the JAX package's own parameter and optimizer trees, leaf
    for leaf; the port's parameters come back through ``params_from_jax``
    and ``params_to_jax`` unchanged."""
    from repro.optim import make_optimizer as jmake_optimizer
    from repro.train import checkpoint as JC
    from repro_torch.optim import make_optimizer as tmake_optimizer
    from repro_torch.train.checkpoint import save_checkpoint
    from repro_torch.weights import opt_state_to_jax, params_to_jax
    jcfg, tcfg, jparams, _ = setup(arch)
    params = TT.init_model(tcfg, tplan(), seed=1, device="cpu",
                           compute_cast=False)
    state = tmake_optimizer("lamb").init(params)
    for g in state["m"]:
        for t in g:
            t.normal_()
    path = str(tmp_path / "port.npz")
    save_checkpoint(path, params, state, step=3)
    like_p = jax.tree.map(np.zeros_like, jax.tree.map(np.asarray, jparams))
    like_o = jax.tree.map(np.zeros_like, jax.tree.map(
        np.asarray, jmake_optimizer("lamb").init(jparams)))
    p, o, step = JC.load_checkpoint(path, like_p, like_o)
    assert step == 3
    for want, got in ((params_to_jax(params), p),
                      (opt_state_to_jax(state, params), o)):
        la = jax.tree_util.tree_flatten_with_path(want)[0]
        lb = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        assert len(la) == len(lb)
        for path_, a in la:
            np.testing.assert_array_equal(np.asarray(lb[path_]), a)
    back = params_from_jax(params_to_jax(params), tcfg, device="cpu",
                           compute_cast=False)
    assert all(torch.equal(a, b) for _, a, b in _pairs(params, back))
