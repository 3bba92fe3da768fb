"""The port's optimizers, clip and schedules against the JAX package's, on
the same numpy-drawn parameters and gradients, over 3 steps.

The parameter tree has the JAX package's stage layout: one stage of R=3
blocks whose leaves are stacked on a leading axis in JAX, and kept as 3
per-block pieces in the port, beside unstacked top-level leaves.  LAMB's
trust ratio and its weight decay (``ndim >= 2``) are per JAX leaf, so the
port must group the pieces: a stage's per-block norm scales are 1-D pieces
of a 2-D leaf and are decayed; the top-level final norm is 1-D and is not.

Tolerance: rtol 1e-6 (the same fp32 elementwise math; the norms are sums
in another order).  The schedules: rtol 1e-6 plus an atol of 1e-7 of the
base rate, for the cosine tail where ``1 + cos`` cancels to a few ulps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import make_optimizer as jmake_optimizer
from repro.optim import make_schedule as jmake_schedule
from repro.optim.optimizers import clip_by_global_norm as jclip
from repro_torch.optim import clip_by_global_norm as tclip
from repro_torch.optim import leaf_groups
from repro_torch.optim import make_optimizer as tmake_optimizer
from repro_torch.optim import make_schedule as tmake_schedule

R = 3
TOL = dict(rtol=1e-6, atol=1e-7)


def _tree(rng, scale=1.0):
    """A JAX-layout tree of numpy arrays: top-level leaves and one stage
    whose block leaves are stacked (R, ...)."""
    n = lambda *s: (scale * rng.standard_normal(s)).astype(np.float32)
    return {"embed": {"table": n(11, 8)},
            "stages": ({"blocks": {"w": n(R, 8, 6),
                                   "ln": {"scale": 1.0 + n(R, 8),
                                          "bias": n(R, 8)}}},),
            "final_norm": {"scale": 1.0 + n(8)}}


def _split(tree):
    """The JAX-layout tree as the port's: each stage a list of blocks."""
    def blocks(t, r):
        if isinstance(t, dict):
            return {k: blocks(v, r) for k, v in t.items()}
        return torch.tensor(t[r])
    out = {k: {kk: torch.tensor(vv) for kk, vv in v.items()}
           for k, v in tree.items() if k != "stages"}
    out["stages"] = tuple({kind: [blocks(sub, r) for r in range(R)]
                           for kind, sub in st.items()}
                          for st in tree["stages"])
    return out


def _pieces(params):
    """Leaf name -> its pieces (jax.tree.map sorts dict keys, so trees are
    paired by name, not by order)."""
    return {g.name: g.pieces for g in leaf_groups(params)}


def _set_grads(tparams, gtree):
    g = _pieces(_split(gtree))
    for name, pieces in _pieces(tparams).items():
        for p, q in zip(pieces, g[name]):
            p.grad = q.clone()


def _assert_same(tparams, jtree, grads=False, **tol):
    want = _pieces(_split(jax.tree.map(np.asarray, jtree)))
    got = _pieces(tparams)
    assert set(got) == set(want)
    for name, pieces in got.items():
        for p, q in zip(pieces, want[name]):
            np.testing.assert_allclose((p.grad if grads else p).numpy(),
                                       q.numpy(), **tol, err_msg=name)


@pytest.mark.parametrize("name", ["lamb", "adamw"])
def test_optimizer_matches_jax_over_3_steps(name):
    rng = np.random.default_rng(0)
    jtree = _tree(rng)
    jparams = jax.tree.map(jnp.asarray, jtree)
    tparams = _split(jtree)
    jopt, topt = jmake_optimizer(name), tmake_optimizer(name)
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    for step in range(3):
        gtree = _tree(rng, scale=0.1)
        jparams, jstate = jopt.update(jax.tree.map(jnp.asarray, gtree),
                                      jstate, jparams, 1e-2)
        _set_grads(tparams, gtree)
        tstate = topt.update(tparams, tstate, 1e-2)
        _assert_same(tparams, jparams, **TOL)
    assert tstate["step"] == 3 == int(jstate["step"])


def test_lamb_groups_stacked_pieces():
    """With zero gradients LAMB's direction is the decay alone: the pieces
    of the stage's stacked norm leaves shrink (2-D in JAX, decayed), the
    top-level 1-D final norm does not move, and the three pieces of one
    leaf share one trust ratio, so they shrink by one factor."""
    rng = np.random.default_rng(1)
    jtree = _tree(rng)
    tparams = _split(jtree)
    opt = tmake_optimizer("lamb", weight_decay=0.1)
    state = opt.init(tparams)
    before = [[p.clone() for p in g.pieces] for g in leaf_groups(tparams)]
    _set_grads(tparams, jax.tree.map(np.zeros_like, jtree))
    opt.update(tparams, state, 1e-2)
    for g, old in zip(leaf_groups(tparams), before):
        ratios = [float((p / q).mean()) for p, q in zip(g.pieces, old)]
        if g.name == "final_norm.scale":
            assert ratios == [1.0]
        else:
            assert all(r < 1.0 for r in ratios), g.name
            np.testing.assert_allclose(ratios, ratios[0], rtol=1e-6,
                                       err_msg=g.name)
    # and JAX agrees on the same zero-gradient step
    jopt = jmake_optimizer("lamb", weight_decay=0.1)
    jparams = jax.tree.map(jnp.asarray, jtree)
    jparams, _ = jopt.update(jax.tree.map(jnp.zeros_like, jparams),
                             jopt.init(jparams), jparams, 1e-2)
    _assert_same(tparams, jparams, **TOL)


@pytest.mark.parametrize("max_norm", [1e-3, 1.0, 1e3])
def test_clip_matches_jax(max_norm):
    rng = np.random.default_rng(2)
    gtree = _tree(rng)
    jg, jnorm = jclip(jax.tree.map(jnp.asarray, gtree), max_norm)
    tparams = _split(_tree(rng))
    _set_grads(tparams, gtree)
    tnorm = tclip(tparams, max_norm)
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
    _assert_same(tparams, jg, grads=True, **TOL)


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("warmup,total", [(10, 100), (1, 3), (0, 7)])
def test_schedule_matches_jax(kind, warmup, total):
    base = 3e-4
    jfn = jmake_schedule(kind, base, warmup, total)
    tfn = tmake_schedule(kind, base, warmup, total)
    for step in range(total + 3):
        np.testing.assert_allclose(tfn(step), float(jfn(step)), rtol=1e-6,
                                   atol=1e-7 * base, err_msg=str(step))
