"""ZeRO-1, the step sentinel and checkpoints over a ``(data 2, model 2)``
mesh of gloo ranks on the CPU, against the JAX package's ``shard_map``
step and the port's own plain mesh step.

Four gloo ranks (a module-wide :class:`RankPool`) run the port; the JAX
side runs once in a subprocess (8 fake CPU devices; ``JaxSide`` in
``tests/test_torch_mesh.py``).  Both start from the same numpy-drawn
weights and batches, in fp32 (the JAX package's ``embed_inputs`` pinned to
fp32 in its subprocess, its fused router and radix sort on their
oracles, ``remat=False``).

* Three ZeRO-1 LAMB steps with the sentinel on, of reduced ``smile-3.7b``
  (sort) and reduced ``llama3-405b`` (dense: every leaf is ZeRO-sharded,
  over ``data`` or over both axes), against JAX's ``build_train_step(...,
  mesh=, zero1=True, sentinel=True)``.  After step 1 the port writes a
  checkpoint over the mesh (each leaf gathered to rank 0, ZeRO-1's flat
  moments to the reference's global flat arrays), which is held to JAX's
  step 1 and read back by the JAX package's ``load_checkpoint``: loss and
  gradient norm within ``JAX_BOUNDS`` (``_train_equiv.py``'s), the
  updated parameters within ``PARAM_ATOL`` and the moments within
  ``MOMENT_REL`` of each leaf's largest (bounds from the readings in the
  module's constants), the step clock 1.  The sentinel's carry after step
  3: counters equal, ``loss_ema`` within ``EMA_REL``.  Step 1 is also held
  to the port's plain mesh step within ``tests/test_torch_ep_train.py``'s
  ``ONE_RANK`` bounds.
* The sentinel, plain and ZeRO-1: a healthy step is bit-identical to the
  sentinel-off step; a NaN in one element of rank 3's slice of the last
  MoE layer's experts, in the weight or in its gradient alone (the loss
  finite, so that under ZeRO-1 only the verdict's psum tells the other
  ranks), gives ``skip == 1`` on every rank and leaves every rank's
  parameters and optimizer state (the step clock too) bit-unchanged, and
  bumps ``nonfinite`` and ``skipped``.
* ``train(..., mesh=)`` halted at step 2 of 4 and resumed is
  bit-identical to the uninterrupted run on every rank, plain and ZeRO-1
  (sentinel on).
* ``specs.gather_leaf`` inverts ``shard_leaf`` for specs in and out of
  mesh order, and ``comm.psum_scatter`` and its backward hold to numpy.
* Fault containment in training (``chip_smoke.py`` phase 19 (c) on the
  reduced config): a bit flip quarantined on the checksummed wire, counted
  once a rank and layer, the step going on; a ``nanrows`` step skipped.
"""
import functools
import os

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import RankPool
from repro_torch.sharding import comm
from test_torch_ep_serve import flat, jax_tree, unflat
from test_torch_ep_train import JAX_BOUNDS, ONE_RANK, _rank_mesh
from test_torch_mesh import JaxSide

MESH = ((2, 2), ("data", "model"))
WORLD = 4
TIMEOUT_S = 180
OPTS = dict(router_impl="fused", sort_impl="radix")
CASES = {"smile": ("smile-3.7b", OPTS), "llama3": ("llama3-405b", {})}
GB, SEQ = 8, 32
LR, WARMUP, HORIZON = 1e-3, 2, 100
STEPS = 3
# against JAX after one ZeRO-1 step (fp32): the updated parameters, and
# each moment leaf relative to its largest element.  Readings (smile,
# llama3): parameters 1.2e-7 and 1.5e-7 apart, moments 2.4e-6 and 2.8e-6,
# the loss equal and the gradient norm 0 and 7.1e-8 relative; loss_ema
# after three steps equal.  Against the port's plain mesh step: 6.0e-8
# and 1.5e-8.  The bounds leave about seven times the readings for sums
# in other orders.
PARAM_ATOL = 1e-6
MOMENT_REL = 2e-5
EMA_REL = 1e-6


def train_cfg(case: str, package: str = "torch"):
    if package == "jax":
        from repro.configs import get_reduced, with_options
    else:
        from repro_torch.configs import get_reduced, with_options
    arch, opts = CASES[case]
    return with_options(get_reduced(arch), **opts).replace(dtype="float32")


def batches(cfg) -> list:
    """The global batches of the steps: random tokens, a label at ~15% of
    them."""
    out = []
    for i in range(STEPS):
        rng = np.random.default_rng(40 + i)
        tokens = rng.integers(0, cfg.vocab_size, (GB, SEQ)).astype(np.int32)
        labels = np.where(rng.random((GB, SEQ)) < 0.15, tokens, -1)
        out.append({"tokens": tokens, "labels": labels.astype(np.int32)})
    return out


def params_file(out_dir, case: str):
    return os.path.join(str(out_dir), f"params-{case}.npz")


# =============================================================================
# The JAX side (a subprocess with 8 fake devices)
# =============================================================================

def _jax_main(out_dir: str) -> None:
    import jax
    import jax.numpy as jnp

    from repro.common.config import TrainConfig
    from repro.kernels import ops as jops
    from repro.models import transformer as JT
    from repro.optim import make_optimizer, make_schedule
    from repro.sharding.compat import make_mesh
    from repro.sharding.plan import test_plan
    from repro.train.checkpoint import _flatten
    from repro.train.sentinel import init_sentinel_state
    from repro.train.step import build_train_step, zero1_state

    save = JaxSide.saver(out_dir)
    jops.RADIX_MIN_ROWS = 1 << 30
    jops.ROUTER_FUSED_MIN_ROWS = 1 << 30
    JT.embed_inputs = functools.partial(JT.embed_inputs, dtype=jnp.float32)
    mesh = make_mesh(*MESH)
    plan = test_plan(2, 2)
    for case in CASES:
        cfg = train_cfg(case, "jax").replace(remat=False)
        params = jax.tree.map(jnp.asarray, unflat(dict(np.load(
            params_file(out_dir, case)))))
        bs = [{k: jnp.asarray(v) for k, v in b.items()}
              for b in batches(cfg)]
        tcfg = TrainConfig(global_batch_size=GB, seq_len=SEQ, lr=LR,
                           warmup_steps=WARMUP, grad_clip=1.0, sentinel=True)
        opt = make_optimizer("lamb")
        step, _ = build_train_step(cfg, tcfg, plan, opt,
                                   make_schedule("cosine", LR, WARMUP,
                                                 HORIZON),
                                   params, bs[0], mesh=mesh, zero1=True,
                                   sentinel=True)
        p, o, sent = params, zero1_state(params, cfg, plan), \
            init_sentinel_state()
        for i, b in enumerate(bs):
            p, o, m, sent = step(p, o, b, jnp.int32(i + 1), sent)
            if i == 0:
                out = {f"p/{k}": v for k, v in _flatten(p).items()}
                out.update({f"o/{k}": v for k, v in _flatten(o).items()})
                out.update(loss=m["loss"], grad_norm=m["grad_norm"])
                save(f"zero1/{case}", out)
        save(f"sentinel/{case}", {f"x/{k}": v
                                  for k, v in _flatten(sent).items()})


# =============================================================================
# Fixtures and rank tasks
# =============================================================================

@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax")
    for case in CASES:
        np.savez(params_file(out, case), **flat(jax_tree(train_cfg(case))))
    js = JaxSide("test_torch_zero1", out)
    yield js
    js.close()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_side):
    rdzv = tmp_path_factory.mktemp("rdzv") / "store"
    with RankPool(WORLD, backend="gloo", devices=["cpu"] * WORLD, threads=1,
                  timeout_s=TIMEOUT_S, init_method=f"file://{rdzv}") as pool:
        pool.run(_make_mesh)
        yield pool


def _make_mesh(rank):
    from repro_torch.launch.mesh import make_mesh
    make_mesh(*MESH, device=rank.device)


def _setup(case, file, *, zero1, sentinel):
    """The rank's slices of the case's weights, its step (LAMB, ZeRO-1 or
    not, the sentinel on or off) and fresh optimizer and sentinel
    states."""
    from repro_torch.common.config import TrainConfig
    from repro_torch.optim import make_optimizer, make_schedule
    from repro_torch.sharding import specs as S
    from repro_torch.sharding.plan import plan_from_mesh
    from repro_torch.train.sentinel import init_sentinel_state
    from repro_torch.train.step import build_train_step, zero1_state
    from repro_torch.weights import params_from_jax
    mesh = comm.bound_mesh()
    plan = plan_from_mesh(mesh)
    cfg = train_cfg(case)
    full = params_from_jax(unflat(dict(np.load(file))), cfg, device="cpu",
                           compute_cast=False)
    params = S.shard_params(full, S.param_specs(full, cfg, plan), mesh)
    opt = make_optimizer("lamb")
    tcfg = TrainConfig(global_batch_size=GB, seq_len=SEQ, lr=LR,
                       warmup_steps=WARMUP, grad_clip=1.0)
    step = build_train_step(cfg, tcfg, plan, opt,
                            make_schedule("cosine", LR, WARMUP, HORIZON),
                            params, batches(cfg)[0], mesh=mesh, zero1=zero1,
                            sentinel=sentinel)
    state = zero1_state(params, cfg, plan) if zero1 else opt.init(params)
    return params, state, init_sentinel_state(), step, cfg, mesh


def _zero1_task(rank, case, file, ckpt):
    """Three ZeRO-1 steps with the sentinel; a checkpoint after step 1."""
    from repro_torch.train.checkpoint import save_checkpoint
    from repro_torch.weights import opt_state_to_jax
    params, state, sent, step, cfg, mesh = _setup(case, file, zero1=True,
                                                  sentinel=True)
    for i, b in enumerate(batches(cfg)):
        params, state, m, sent = step(params, state, b, i + 1, sent)
        if i == 0:
            m1 = {k: float(v) for k, v in m.items()}
            save_checkpoint(ckpt, params, state, 1, extra=sent, cfg=cfg,
                            mesh=mesh)
    return {"m1": m1, "sent": opt_state_to_jax(sent), "step": state.step}


def _plain_task(rank, case, file):
    """One plain (not ZeRO-1) mesh step: its metrics and the updated
    parameters gathered whole."""
    from repro_torch.weights import params_to_jax
    params, state, _, step, cfg, mesh = _setup(case, file, zero1=False,
                                               sentinel=False)
    params, state, m = step(params, state, batches(cfg)[0], 1)
    return {"m": {k: float(v) for k, v in m.items()},
            "p": flat(params_to_jax(params, cfg=cfg, mesh=mesh))}


def _bits(params, state) -> list:
    """Every tensor of the parameters and the optimizer state, copied."""
    from repro_torch.weights import state_leaves
    return [t.detach().clone() for leaf in state_leaves(params, state)
            for t in leaf.tensors]


def _same_bits(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x.view(torch.int32),
                                           y.view(torch.int32))
        for x, y in zip(a, b))


def _healthy_task(rank, case, file, zero1):
    """The same step with the sentinel off and on: bit-identical."""
    got = []
    for sentinel in (False, True):
        params, state, sent, step, cfg, _ = _setup(case, file, zero1=zero1,
                                                   sentinel=sentinel)
        out = step(params, state, batches(cfg)[0], 1,
                   *((sent,) if sentinel else ()))
        got.append((_bits(out[0], out[1]), out[2]))
    return {"same": _same_bits(got[0][0], got[1][0]),
            "skip": float(got[1][1]["skip"]),
            "loss": (float(got[0][1]["loss"]), float(got[1][1]["loss"]))}


def _nan_first(g: torch.Tensor) -> torch.Tensor:
    g = g.clone()
    g.view(-1)[0] = float("nan")
    return g


def _poisoned_task(rank, case, file, zero1, where):
    """NaN in one element of rank 3's slice of the last MoE layer's
    experts (after every routing decision of the forward), then one
    sentinel step: in the weight (``where="param"``), or in its gradient
    alone, so that the loss and every other rank's gradients stay finite
    and only the verdict's psum tells them (``"grad"``)."""
    from repro_torch.optim import leaf_groups
    from repro_torch.weights import opt_step
    params, state, sent, step, cfg, _ = _setup(case, file, zero1=zero1,
                                               sentinel=True)
    if rank.rank == 3:
        w1 = [g for g in leaf_groups(params)
              if g.name.endswith(".experts.w1")][-1].pieces[-1]
        if where == "param":
            with torch.no_grad():
                w1.view(-1)[0] = float("nan")
        else:
            w1.register_hook(_nan_first)
    before = _bits(params, state)
    params, state, m, sent = step(params, state, batches(cfg)[0], 1, sent)
    return {"skip": float(m["skip"]), "loss": float(m["loss"]),
            "same": _same_bits(before, _bits(params, state)),
            "step": opt_step(state),
            "nonfinite": float(sent.nonfinite),
            "skipped": float(sent.skipped), "steps": float(sent.steps)}


def _resume_task(rank, root, zero1):
    """train(mesh=) for 4 steps; halted at 2 with a snapshot a step; and
    resumed: the resumed run's parameters against the uninterrupted
    run's, bit for bit."""
    from repro_torch.launch.train import train
    from repro_torch.optim import leaf_groups
    mesh = comm.bound_mesh()
    kw = dict(reduced=True, steps=4, batch=GB, seq=SEQ, lr=LR, log_every=1,
              sentinel=True, zero1=zero1, moe_options=OPTS, mesh=mesh)
    d = os.path.join(str(root), f"run-zero1-{zero1}")
    full, _ = train("smile-3.7b", **kw)
    train("smile-3.7b", ckpt_dir=d, ckpt_every=1, halt_after=2, **kw)
    res, hist = train("smile-3.7b", ckpt_dir=d, ckpt_every=1, resume=True,
                      **kw)
    flat_ = lambda p: [t.detach() for g in leaf_groups(p) for t in g.pieces]
    return {"same": _same_bits(flat_(full), flat_(res)),
            "first": hist[0]["step"],
            "restored": hist[-2]["checkpoints"]["restored"]["step"]}


def _gather_task(rank):
    """gather_leaf over specs in and out of mesh order against the full
    leaf every rank draws."""
    from repro_torch.sharding import specs as S
    mesh = comm.bound_mesh()
    x = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
    out = []
    for spec in [(("model", "data"), None, None), (("data", "model"), None,
                                                   None),
                 ("model", "data", None), (None, None, "data")]:
        got = S.gather_leaf(S.shard_leaf(x, spec, mesh), spec, mesh)
        out.append(bool(torch.equal(got, x)))
    return out


def _psum_scatter_task(rank):
    """psum_scatter over each axes tuple, tiled along dim 1 and untiled,
    and the gradient of sum(psum_scatter(x) * ct)."""
    out = {}
    for name, axes in (("data", "data"), ("model", "model"),
                       ("both", ("data", "model"))):
        P = comm.bound_mesh().size(axes)
        x = (torch.arange(3 * 4 * P, dtype=torch.float32).reshape(3, 4 * P)
             * (rank.rank + 1)).requires_grad_(True)
        y = comm.psum_scatter(x, axes, scatter_dimension=1)
        ct = torch.full_like(y, float(rank.rank + 1))
        (y * ct).sum().backward()
        z = comm.psum_scatter(x.detach().reshape(3, P, 4), axes,
                              scatter_dimension=1, tiled=False)
        out[name] = (y.detach().numpy(), x.grad.numpy(), z.numpy(),
                     comm.axis_index(axes))
    return out


# =============================================================================
# Tests
# =============================================================================

def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


@pytest.mark.parametrize("case", list(CASES))
def test_zero1_steps_match_jax_and_the_plain_mesh_step(case, ranks, jax_side,
                                                      tmp_path):
    from repro.train.checkpoint import load_checkpoint as jload
    file = params_file(jax_side.out, case)
    ckpt = str(tmp_path / "zero1.npz")
    got = ranks.run(_zero1_task, case, file, ckpt, timeout_s=TIMEOUT_S)
    m1 = [g["m1"] for g in got]
    for k in ("loss", "grad_norm", "skip"):       # replicated metrics
        assert max(m[k] for m in m1) == min(m[k] for m in m1), k
    assert m1[0]["skip"] == 0.0 and all(g["step"] == STEPS for g in got)
    ref = jax_side.get(f"zero1/{case}", timeout_s=TIMEOUT_S)
    assert abs(m1[0]["loss"] - float(ref["loss"])) <= JAX_BOUNDS["loss"]
    assert (abs(m1[0]["grad_norm"] - float(ref["grad_norm"]))
            / float(ref["grad_norm"])) <= JAX_BOUNDS["grad_norm_rel"]
    # the checkpoint the ranks wrote after step 1: the JAX layout, under
    # the reference's keys, ZeRO-1's moments global flat arrays
    mine = dict(np.load(ckpt))
    want = {k: v for k, v in ref.items() if "/" in k}
    assert set(want) <= set(mine), sorted(set(want) - set(mine))[:5]
    assert int(mine["o/step"]) == 1 and int(mine["__step__"]) == 1
    perr = max(float(np.abs(mine[k] - want[k]).max()) for k in want
               if k.startswith("p/"))
    merr = max(_rel(mine[k], want[k]) for k in want
               if k.startswith(("o/m/", "o/v/")))
    assert perr <= PARAM_ATOL, (case, "params", perr)
    assert merr <= MOMENT_REL, (case, "moments", merr)
    # the JAX package reads the file into its own trees
    p_like = unflat({k[2:]: v for k, v in want.items() if k.startswith("p/")})
    o_like = {"m": unflat({k[4:]: v for k, v in want.items()
                           if k.startswith("o/m/")}),
              "v": unflat({k[4:]: v for k, v in want.items()
                           if k.startswith("o/v/")}),
              "step": np.int32(0)}
    _, o, step = jload(ckpt, p_like, o_like)
    assert step == 1 and int(o["step"]) == 1
    # the sentinel's carry after three steps
    sent = jax_side.get(f"sentinel/{case}", timeout_s=TIMEOUT_S)
    for g in got:
        for k, v in g["sent"].items():
            if k == "loss_ema":
                assert _rel(v, sent[f"x/{k}"]) <= EMA_REL, (k, v)
            else:
                assert float(v) == float(sent[f"x/{k}"]), (k, v)
    assert float(got[0]["sent"]["steps"]) == STEPS
    # the port's plain mesh step from the same weights
    plain = ranks.run(_plain_task, case, file, timeout_s=TIMEOUT_S)
    mp = plain[0]["m"]
    assert abs(m1[0]["loss"] - mp["loss"]) <= ONE_RANK["loss"]
    assert (abs(m1[0]["grad_norm"] - mp["grad_norm"]) / mp["grad_norm"]
            <= ONE_RANK["grad_norm_rel"])
    err = max(float(np.abs(mine["p/" + k] - v).max())
              for k, v in plain[0]["p"].items())
    assert err <= ONE_RANK["param"], (case, "against the plain step", err)


@pytest.mark.parametrize("zero1", [False, True], ids=["plain", "zero1"])
def test_healthy_sentinel_step_is_bit_identical(zero1, ranks, jax_side):
    got = ranks.run(_healthy_task, "smile", params_file(jax_side.out,
                                                        "smile"), zero1,
                    timeout_s=TIMEOUT_S)
    for g in got:
        assert g["same"] and g["skip"] == 0.0
        assert g["loss"][0] == g["loss"][1]


@pytest.mark.parametrize("where", ["param", "grad"])
@pytest.mark.parametrize("zero1", [False, True], ids=["plain", "zero1"])
def test_poisoned_step_is_skipped_on_every_rank(zero1, where, ranks,
                                                jax_side):
    got = ranks.run(_poisoned_task, "smile", params_file(jax_side.out,
                                                         "smile"), zero1,
                    where, timeout_s=TIMEOUT_S)
    if where == "grad":
        assert all(np.isfinite(g["loss"]) for g in got)
    for r, g in enumerate(got):
        assert g["skip"] == 1.0, (r, g)
        assert g["same"], (r, "state moved on a skipped step")
        assert g["step"] == 0, (r, "the step clock moved")
        assert (g["nonfinite"], g["skipped"], g["steps"]) == (1.0, 1.0, 1.0)


@pytest.mark.parametrize("zero1", [False, True], ids=["plain", "zero1"])
def test_resume_over_the_mesh_is_bit_identical(zero1, ranks, tmp_path):
    got = ranks.run(_resume_task, tmp_path, zero1, timeout_s=TIMEOUT_S)
    for r, g in enumerate(got):
        assert g["same"], (r, "resumed run parts from the uninterrupted one")
        assert g["first"] == 3 and g["restored"] == 2, g


def _fault_train_task(rank):
    from chip_smoke import FAULT_TRAIN, _fault_train_rank
    rank.state.setdefault("mesh", comm.bound_mesh())
    return _fault_train_rank(rank, dict(FAULT_TRAIN, reduced=True,
                                        num_layers=None, moe_grid=None))


def test_faulted_steps_under_zero1_and_the_sentinel(ranks):
    """``chip_smoke.py`` phase 19 (c) on reduced smile-3.7b, dropless: a
    bit flip on hop 0's wire under ``quarantine`` is flagged once a rank
    and layer (the remat recompute counts nothing more) and the step goes
    on; a ``nanrows`` step is skipped with everything bit-unchanged."""
    from chip_smoke import check_fault_train

    from repro_torch.common import faultinject as FI
    out = ranks.run(_fault_train_task, timeout_s=TIMEOUT_S)
    layers, victim = check_fault_train(out, WORLD)
    assert layers == 1                 # reduced smile-3.7b: one MoE layer
    assert victim == FI.wire_victim(FI.parse_fault_plan("bitflip:0"), 0, 2)


def test_gather_leaf_inverts_shard_leaf(ranks):
    for g in ranks.run(_gather_task, timeout_s=TIMEOUT_S):
        assert all(g), g


def test_psum_scatter_and_its_gradient(ranks):
    got = ranks.run(_psum_scatter_task, timeout_s=TIMEOUT_S)
    for name, axes in (("data", "data"), ("model", "model"),
                       ("both", ("data", "model"))):
        P = 4 if name == "both" else 2
        members = [r for r in range(WORLD)
                   if all(_rank_mesh(r).index(a) == _rank_mesh(0).index(a)
                          for a in ("data", "model") if a not in
                          comm._norm(axes))]
        for r in range(WORLD):
            grp = [q for q in range(WORLD)
                   if all(_rank_mesh(q).index(a) == _rank_mesh(r).index(a)
                          for a in ("data", "model")
                          if a not in comm._norm(axes))]
            x = np.arange(3 * 4 * P, dtype=np.float32).reshape(3, 4 * P)
            total = sum(x * (q + 1) for q in grp)
            y, gx, z, i = got[r][name]
            np.testing.assert_array_equal(y, total[:, 4 * i:4 * (i + 1)])
            np.testing.assert_array_equal(z, total.reshape(3, P, 4)[:, i])
            # d/dx of sum over the group of sum(y_q * ct_q): each rank's
            # cotangent lands on its own block, the same on every rank
            want = np.concatenate([np.full((3, 4), float(q + 1))
                                   for q in grp], axis=1)
            np.testing.assert_array_equal(gx, want)
        assert len(members) == P
