"""The whole serving slice on the reduced qwen3-moe-30b-a3b config: the
JAX package and the port on the same weights (carried across by
``params_from_jax``), prefill then 3 decode steps fed the JAX side's greedy
tokens, compared logit by logit.

Tolerance: ``LOGITS_ATOL`` absolute on fp32 logits of magnitude ~1.  Both
sides compute in bf16 (8 significant bits) and round intermediates at
different places (XLA and PyTorch fuse and order their bf16 matmuls and
elementwise ops differently), through 2 layers and an LM head; the observed
gap is ~1e-2.  Greedy tokens must agree wherever the top-2 margin exceeds
twice the tolerance.

With ``use_kernel=True`` the port runs its kernel path (on the CPU: the
kernels' plain versions), and the JAX side runs its kernel path with each
Pallas kernel replaced by what it computes in plain jnp (Pallas does not
run on this JAX): the grouped-FFN and dispatch oracles from
``repro.kernels.ref``, and for the combine the fp32-accumulating gather-
reduce of ``combine_gather_pallas`` (its ``ref`` oracle multiplies in bf16).

The dropless case serves the same config under ``dispatch_backend=
"dropless"`` (``with_options``): the JAX package's ``prefill_fn`` and
``decode_step_fn`` pick the tokens both sides are fed, and the logits of
each step are held to JAX's forward from the same caches, at the same
tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.configs import with_options as jwith_options
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import transformer as JT
from repro.serve import decode as JDEC
from repro.sharding.plan import single_device_plan as jplan
from repro_torch.configs import get_reduced as tget_reduced
from repro_torch.configs import with_options as twith_options
from repro_torch.kernels import ops as tops
from repro_torch.models import transformer as TT
from repro_torch.serve import decode as TDEC
from repro_torch.sharding.plan import single_device_plan as tplan
from repro_torch.weights import params_from_jax

ARCH = "qwen3-moe-30b-a3b"
LOGITS_ATOL = 3e-2      # chip_smoke.py holds the card to the CPU with this


def _pallas_free_jax_kernels(monkeypatch):
    def grouped_ffn(x, w1, w3, w2, *, act="gelu"):
        cast = lambda w: None if w is None else w.astype(x.dtype)
        return jref.grouped_ffn_ref(x, cast(w1), cast(w3), cast(w2), act=act)

    def combine_gather(rows, src, scale):
        t, k = src.shape
        got = jnp.take(rows, jnp.maximum(src, 0).reshape(-1), axis=0)
        w = jnp.where(src >= 0, scale, 0).reshape(-1, 1)
        acc = (got.astype(jnp.float32) * w.astype(jnp.float32)).reshape(
            t, k, -1).sum(axis=1)
        return acc.astype(rows.dtype)

    monkeypatch.setattr(jops, "grouped_ffn", grouped_ffn)
    monkeypatch.setattr(jops, "dispatch_gather", jref.dispatch_gather_ref)
    monkeypatch.setattr(jops, "combine_gather", combine_gather)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_reduced_slice_matches_jax(use_kernel, monkeypatch):
    if use_kernel:
        _pallas_free_jax_kernels(monkeypatch)
    jcfg, tcfg = jget_reduced(ARCH), tget_reduced(ARCH)
    jparams = JT.init_model(jax.random.PRNGKey(0), jcfg, jplan())
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    B, S, steps = 2, 16, 3
    tokens = np.random.default_rng(0).integers(
        8, jcfg.vocab_size, (B, S)).astype(np.int32)
    jcache = JT.init_caches(jcfg, B, S + steps, jplan())
    tcache = TT.init_caches(tcfg, B, S + steps, tplan(), device="cpu")
    before = tops.launch_counts()
    n_sure = n_all = 0
    for i in range(steps + 1):
        pos = np.arange(S) if i == 0 else np.array([S + i - 1])
        pos = pos.astype(np.int32)
        _, jl, js, jcache = JT.forward(jparams, jnp.asarray(tokens), jcfg,
                                       jplan(), positions=jnp.asarray(pos),
                                       caches=jcache, use_kernel=use_kernel)
        with torch.inference_mode():
            _, tl, ts, tcache = TT.forward(
                tparams, torch.from_numpy(tokens), tcfg, tplan(),
                positions=torch.from_numpy(pos), caches=tcache,
                use_kernel=use_kernel)
        jl, tl = np.asarray(jl), tl.numpy()
        assert tl.shape == jl.shape == (B, len(pos), jcfg.vocab_size)
        np.testing.assert_allclose(tl, jl, rtol=0, atol=LOGITS_ATOL,
                                   err_msg=f"step {i}")
        top2 = np.sort(jl, axis=-1)[..., -2:]
        sure = top2[..., 1] - top2[..., 0] > 2 * LOGITS_ATOL
        n_sure, n_all = n_sure + sure.sum(), n_all + sure.size
        np.testing.assert_array_equal(tl.argmax(-1)[sure], jl.argmax(-1)[sure])
        np.testing.assert_allclose(float(ts.lb_loss), float(js.lb_loss),
                                   rtol=1e-3)
        assert float(ts.drop_frac) == float(js.drop_frac)
        tokens = jl[:, -1].argmax(-1).astype(np.int32)[:, None]
    assert n_sure >= n_all // 2                 # the check has teeth
    assert tops.launch_counts() == before      # CPU: plain versions only


DROPLESS = dict(dispatch_backend="dropless")


@pytest.mark.parametrize("use_kernel", [False, True])
def test_reduced_dropless_serve_matches_jax(use_kernel):
    jcfg = jwith_options(jget_reduced(ARCH), **DROPLESS)
    tcfg = twith_options(tget_reduced(ARCH), **DROPLESS)
    jparams = JT.init_model(jax.random.PRNGKey(0), jcfg, jplan())
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    B, S, steps = 2, 16, 3
    prompts = np.random.default_rng(0).integers(
        8, jcfg.vocab_size, (B, S)).astype(np.int32)
    jcache = JT.init_caches(jcfg, B, S + steps, jplan())
    tcache = TT.init_caches(tcfg, B, S + steps, tplan(), device="cpu")
    run = dict(cfg=tcfg, plan=tplan(), use_kernel=use_kernel)
    before = tops.launch_counts()
    n_sure = n_all = 0
    jtok = None
    for i in range(steps + 1):
        if i == 0:
            _, jl, _, _ = JT.forward(jparams, jnp.asarray(prompts), jcfg,
                                     jplan(), positions=jnp.arange(S),
                                     caches=jcache)
            nxt, jcache = JDEC.prefill_fn(jparams, jnp.asarray(prompts),
                                          jcache, cfg=jcfg, plan=jplan())
            with torch.inference_mode():
                ttok, tcache, tl = TDEC.prefill_fn(
                    tparams, torch.from_numpy(prompts), tcache, **run)
        else:
            pos = jnp.int32(S + i - 1)
            _, jl, _, _ = JT.forward(jparams, jtok[:, None], jcfg, jplan(),
                                     positions=pos[None], caches=jcache)
            nxt, jcache = JDEC.decode_step_fn(jparams, jtok, jcache, pos,
                                              cfg=jcfg, plan=jplan())
            with torch.inference_mode():
                ttok, tcache, tl = TDEC.decode_step_fn(
                    tparams, torch.from_numpy(np.array(jtok)), tcache,
                    S + i - 1, **run)
        jl, tl = np.asarray(jl)[:, -1], tl.numpy()
        np.testing.assert_array_equal(np.asarray(nxt), jl.argmax(-1))
        np.testing.assert_allclose(tl, jl, rtol=0, atol=LOGITS_ATOL,
                                   err_msg=f"step {i}")
        top2 = np.sort(jl, axis=-1)[..., -2:]
        sure = top2[..., 1] - top2[..., 0] > 2 * LOGITS_ATOL
        n_sure, n_all = n_sure + sure.sum(), n_all + sure.size
        np.testing.assert_array_equal(ttok.numpy()[sure],
                                      np.asarray(nxt)[sure])
        jtok = nxt                   # both sides are fed JAX's greedy tokens
    assert n_sure >= n_all // 2
    assert tops.launch_counts() == before      # CPU: plain versions only


def test_params_from_jax_dropless_same_as_sort():
    """The dispatch backend is a runtime option: the dropless config has
    the sort config's parameters, in the JAX package and in the port."""
    jsort, jdl = jget_reduced(ARCH), jwith_options(jget_reduced(ARCH),
                                                   **DROPLESS)
    tree = jax.tree.map(np.asarray,
                        JT.init_model(jax.random.PRNGKey(3), jdl, jplan()))
    same = jax.tree.map(np.asarray,
                        JT.init_model(jax.random.PRNGKey(3), jsort, jplan()))
    assert all(jax.tree.leaves(jax.tree.map(np.array_equal, tree, same)))
    dl = params_from_jax(tree, twith_options(tget_reduced(ARCH), **DROPLESS),
                         device="cpu")
    srt = params_from_jax(tree, tget_reduced(ARCH), device="cpu")
    flat_dl, flat_srt = jax.tree.leaves(dl), jax.tree.leaves(srt)
    assert len(flat_dl) == len(flat_srt) > 20
    assert all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(flat_dl, flat_srt))
    fresh = TT.init_model(twith_options(tget_reduced(ARCH), **DROPLESS),
                          tplan(), seed=0, device="cpu")
    assert [tuple(t.shape) for t in jax.tree.leaves(fresh)] == \
        [tuple(t.shape) for t in flat_dl]


def test_serve_on_cpu_runs_the_kernel_path():
    from repro_torch.launch.serve import serve
    res = serve(ARCH, reduced=True, batch=2, prompt_len=8, new_tokens=3,
                device="cpu")
    assert res.tokens.shape == (2, 3)
    assert res.logits_finite
    assert ((res.tokens >= 0) & (res.tokens < 512)).all()
    # the CPU runs the plain versions: no kernel launches in either phase
    assert all(v == 0 for ph in res.launches.values() for v in ph.values())
    # the dropless backend through the same entry point: the same weights
    # and prompts, so the same greedy tokens wherever the margin is clear
    dl = serve(ARCH, reduced=True, batch=2, prompt_len=8, new_tokens=3,
               device="cpu", moe_options=DROPLESS)
    assert dl.inputs.cfg.moe.dispatch_backend == "dropless"
    assert dl.tokens.shape == (2, 3) and dl.logits_finite
    assert all(v == 0 for ph in dl.launches.values() for v in ph.values())


def test_serve_asking_for_cuda_without_a_card_raises(monkeypatch):
    from repro_torch.launch.serve import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve(ARCH, reduced=True, batch=1, prompt_len=4, new_tokens=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.init_model(tget_reduced(ARCH), tplan())
