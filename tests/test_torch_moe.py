"""Routing, sort dispatch/combine and the MoE layer of the port against the
JAX package, in fp32, on numpy-drawn inputs and parameters.

Integer routing outputs (expert ids, positions, keep masks, slot maps) must
match bit for bit; float outputs and MoEStats within 1e-5 (the same fp32
math, reduced in another order).  The layer matrix crosses SMILE and Switch
with a layout of one expert per slot (E=8 on the (2, 4) grid, h=1) and a
replicated one (E=4 on the (2, 4) grid, r=2, the reduced qwen3-moe layout),
and ample against starved capacity, so overflow drops are exercised.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import MoEConfig as JMoEConfig
from repro.core import dispatch as JD
from repro.core import moe as JM
from repro.sharding.plan import single_device_plan as jplan
from repro_torch.common.config import MoEConfig as TMoEConfig
from repro_torch.core import dispatch as TD
from repro_torch.core import moe as TM
from repro_torch.sharding.plan import single_device_plan as tplan

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.mark.parametrize("k,E,renorm", [(1, 4, False), (2, 8, True),
                                        (4, 16, True)])
def test_router_topk_matches(k, E, renorm):
    rng = np.random.default_rng(E + k)
    x = rng.standard_normal((40, 16)).astype(np.float32)
    w = rng.standard_normal((16, E)).astype(np.float32)
    w[:, 2] = w[:, 1]          # exact ties: the lowest index must win
    jg, ji, jp, jl = JM.router_topk(jnp.asarray(x), jnp.asarray(w), k, renorm)
    tg, ti, tp, tl = TM.router_topk(torch.from_numpy(x), torch.from_numpy(w),
                                    k, renorm)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    for a, b in ((tg, jg), (tp, jp), (tl, jl)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_topk_gates_ties_lowest_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3]])
    _, idx = TM.topk_gates(probs, 2, False)
    assert idx.tolist() == [[0, 1], [1, 2]]


@pytest.mark.parametrize("A,G,cap,p_valid", [(0, 3, 2, 1.0), (50, 4, 20, 1.0),
                                             (50, 4, 6, 0.8),
                                             (200, 16, 3, 0.5)])
def test_sort_dispatch_combine_match(A, G, cap, p_valid):
    rng = np.random.default_rng(A + G + cap)
    k = 2 if A % 2 == 0 else 1
    t, d = A // k, 8
    gid = rng.integers(0, G, A).astype(np.int32)
    valid = rng.random(A) < p_valid
    x = rng.standard_normal((t, d)).astype(np.float32)
    gates = rng.random(A).astype(np.float32)

    jpos, jkeep, jsa = JD.sort_positions(jnp.asarray(gid), jnp.asarray(valid),
                                         G, cap)
    tpos, tkeep, tsa = TD.sort_positions(torch.from_numpy(gid),
                                         torch.from_numpy(valid), G, cap)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(tsa.numpy(), np.asarray(jsa))

    jbuf, jst = JD.dispatch(jnp.asarray(x), jnp.asarray(gid),
                            jnp.asarray(gates), G, cap, k=k,
                            valid=jnp.asarray(valid))
    tbuf, tst = TD.dispatch(torch.from_numpy(x), torch.from_numpy(gid),
                            torch.from_numpy(gates), G, cap, k=k,
                            valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(
        TD.dispatch_flags(torch.ones(A), tst).numpy(),
        np.asarray(JD.dispatch_flags(jnp.ones(A), jst)))
    y_buf = rng.standard_normal((G, cap, d)).astype(np.float32)
    np.testing.assert_allclose(
        TD.combine(torch.from_numpy(y_buf), tst).numpy(),
        np.asarray(JD.combine(jnp.asarray(y_buf), jst)), **TOL)


def _layer_cfgs(router, layout, cf):
    if layout == "h1":     # E = n*m: one expert per slot
        kw = dict(num_experts=8, top_k=4 if router == "smile" else 2,
                  top_g=2)
    else:                  # E < n*m: every expert replicated r=2 times
        kw = dict(num_experts=4, top_k=2, top_g=2)
    kw.update(renorm_gates=True, d_ff_expert=16, capacity_factor=cf,
              router=router, grid=(2, 4), router_z_coef=1e-3,
              lb_alpha=0.005, lb_beta=0.01)
    return JMoEConfig(**kw), TMoEConfig(**kw)


def _layer_params(rng, cfg, d):
    n_g = cfg.grid[0]
    e_pn, f = cfg.num_experts // n_g, cfg.d_ff_expert
    p = {"experts": {
        "w1": rng.standard_normal((n_g, e_pn, d, f)) / np.sqrt(d),
        "w3": rng.standard_normal((n_g, e_pn, d, f)) / np.sqrt(d),
        "w2": rng.standard_normal((n_g, e_pn, f, d)) / np.sqrt(f)}}
    if cfg.router == "smile":
        p["router_inter"] = {"w": rng.standard_normal((d, n_g))}
        p["router_intra"] = {"w": rng.standard_normal((d, e_pn))}
    else:
        p["router"] = {"w": rng.standard_normal((d, cfg.num_experts))}
    return jax.tree.map(lambda a: a.astype(np.float32), p)


def _tmap(fn, tree):
    return {k: _tmap(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("cf", [4.0, 0.5], ids=["ample", "starved"])
@pytest.mark.parametrize("layout", ["h1", "r2"])
@pytest.mark.parametrize("router", ["smile", "switch"])
def test_moe_layer_matches(router, layout, cf, use_kernel):
    jcfg, tcfg = _layer_cfgs(router, layout, cf)
    rng = np.random.default_rng(7)
    t, d = 48, 32
    params = _layer_params(rng, jcfg, d)
    x = rng.standard_normal((t, d)).astype(np.float32)
    valid = rng.random(t) < 0.9
    jy, js = JM.moe_layer(_tmap(jnp.asarray, params), jnp.asarray(x), jcfg,
                          jplan(), act="silu",
                          token_valid=jnp.asarray(valid))
    ty, ts = TM.moe_layer(_tmap(torch.from_numpy, params),
                          torch.from_numpy(x), tcfg, tplan(), act="silu",
                          use_kernel=use_kernel,
                          token_valid=torch.from_numpy(valid))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for field in dataclasses.fields(js):
        np.testing.assert_allclose(
            _np(getattr(ts, field.name)), np.asarray(getattr(js, field.name)),
            err_msg=field.name, **TOL)
    if cf == 0.5:
        assert float(ts.drop_frac) > 0      # the starved case really drops
    else:
        assert float(ts.drop_frac) == 0


def test_capacity_and_grid_helpers_match():
    for args in [(10, 2, 2.0, 4), (1, 1, 0.1, 8), (1024, 4, 2.0, 16)]:
        assert TM.capacity(*args) == JM.capacity(*args)
    cfg = TMoEConfig(num_experts=128, top_k=8, top_g=4, grid=(16, 8))
    assert TM._grid(cfg, tplan()) == (16, 8)
    assert TM._grid(TMoEConfig(), tplan()) == (1, 1)


def test_full_qwen3_grid_zero_cannot_route_on_one_device():
    """The fault recorded in ROADMAP: qwen3-moe's grid=(0, 0) folds to
    (1, 1) on one device, and top-4 of one node cannot route."""
    from repro_torch.configs import get_config
    cfg = get_config("qwen3-moe-30b-a3b").moe
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError):
        TM.router_topk(x, torch.zeros((8, 1)), cfg.top_g, True)
    assert TM._grid(cfg, tplan()) == (1, 1)
