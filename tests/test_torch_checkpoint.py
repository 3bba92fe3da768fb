"""Checkpoints and the step sentinel of the port on one rank, against the
JAX package's ``repro.train.checkpoint`` and ``repro.train.sentinel``.

* The reference's ``tests/test_checkpoint.py`` cases, held for the port's
  ``train/checkpoint.py``: a round trip with the sentinel's carry as
  extras, a missing key with its near matches, a shape mismatch,
  unreadable and foreign files, the keep-last-K rotation and its manifest,
  a corrupt newest snapshot falling back, and strays without a manifest.
* Each package reads the other's files: a snapshot the port writes loads
  in ``repro.train.checkpoint.load_checkpoint`` into JAX's trees with equal
  arrays, and one JAX writes loads in the port.
* ``train()`` halted at step 2 of 4 and resumed (sentinel on) is
  bit-identical to the uninterrupted run, and still is after the newest
  snapshot is truncated (resume falls back to step 1 and says "checksum").
* The reference's ``tests/test_sentinel.py`` unit cases for the port's
  sentinel (the same constants), and on reduced ``smile-3.7b``, plain and
  ZeRO-1: a healthy sentinel step is bit-identical to the sentinel-off
  step; a NaN in the experts skips the step, leaves the parameters and
  the optimizer state bit-unchanged and bumps the counters.
* The reference's fault-plan sentinel cases: a ``nanrows`` plan makes the
  loss NaN and the step skipped, plain and ZeRO-1, with every tensor
  bit-unchanged and the loss EMA untouched; a ``skew`` plan counts one
  router alarm, in both packages.
"""
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.train import checkpoint as JC
from repro.train import sentinel as JS
from repro_torch.launch import train as TL
from repro_torch.optim import leaf_groups, make_optimizer
from repro_torch.train import sentinel as S
from repro_torch.train.checkpoint import (CheckpointError, CheckpointManager,
                                          load_checkpoint, save_checkpoint)
from repro_torch.weights import (opt_state_from_jax, opt_state_to_jax,
                                 params_from_jax, params_to_jax)

OPTS = dict(router_impl="fused", sort_impl="radix")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: one intra-op thread (the suite's workers share the
    host's cores, and threads that wait on each other cost more than the
    work)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- unit level

def _params(fill: float = 0.0):
    return {"layer": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)
                      + fill, "b": torch.zeros(3)},
            "head": torch.full((4,), 2.5 + fill)}


def _zeros_like(tree):
    return {k: (_zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v))
            for k, v in tree.items()}


def _sent(loss_ema=1.5, steps=3.0):
    s = S.init_sentinel_state()
    s.loss_ema.fill_(loss_ema)
    s.steps.fill_(steps)
    return s


def _equal(a, b):
    la = [t for g in leaf_groups(a) for t in g.pieces]
    lb = [t for g in leaf_groups(b) for t in g.pieces]
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def test_roundtrip_with_extras(tmp_path):
    path = str(tmp_path / "c.npz")
    params = _params()
    opt = make_optimizer("lamb").init(params)
    opt["m"][0][0].fill_(1.0)
    opt["step"] = 4
    save_checkpoint(path, params, opt, step=7, extra=_sent())
    p, o, x = _zeros_like(params), make_optimizer("lamb").init(params), \
        S.init_sentinel_state()
    p, o, step, x = load_checkpoint(path, p, o, extra_like=x)
    assert step == 7 and o["step"] == 4
    assert _equal(p, params)
    assert torch.equal(o["m"][0][0], opt["m"][0][0])
    assert float(x.loss_ema) == 1.5 and float(x.steps) == 3.0
    # the 3-tuple form without extras
    p, o, step = load_checkpoint(path, _zeros_like(params),
                                 make_optimizer("lamb").init(params))
    assert step == 7 and o is not None


def test_missing_key_reports_near_match(tmp_path):
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, _params())
    like = {"layer": {"w_new": torch.zeros(2, 3)}}
    with pytest.raises(CheckpointError, match="nearest stored keys"):
        load_checkpoint(path, like)
    with pytest.raises(CheckpointError, match="p/layer/w_new"):
        load_checkpoint(path, like)


def test_shape_mismatch(tmp_path):
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, _params())
    like = _params()
    like["head"] = torch.zeros(5)
    with pytest.raises(CheckpointError, match=r"stored shape \(4,\)"):
        load_checkpoint(path, like)
    # nothing was written into the trees before the mismatch was found
    assert float(like["layer"]["w"].abs().sum()) == 15.0


def test_unreadable_and_foreign_files(tmp_path):
    junk = tmp_path / "junk.npz"
    junk.write_bytes(b"this is not a zip archive")
    with pytest.raises(CheckpointError, match="cannot read"):
        load_checkpoint(str(junk), _params())
    foreign = str(tmp_path / "foreign.npz")
    np.savez(foreign, a=np.zeros(3))
    with pytest.raises(CheckpointError, match="__step__"):
        load_checkpoint(foreign, _params())


def test_manager_rotation_and_manifest(tmp_path):
    d = str(tmp_path / "run")
    mgr = CheckpointManager(d, keep=3)
    for step in (1, 2, 3, 4, 5):
        mgr.save(step, _params(step))
    files = sorted(f for f in os.listdir(d) if f.endswith(".npz"))
    assert files == ["ckpt_00000003.npz", "ckpt_00000004.npz",
                     "ckpt_00000005.npz"]
    entries = mgr._read_manifest()
    assert [e["step"] for e in entries] == [3, 4, 5]
    assert all(e["sha256"] and e["bytes"] > 0 for e in entries)
    assert [s["step"] for s in mgr.saves] == [1, 2, 3, 4, 5]
    p, _, step = mgr.restore_latest(_zeros_like(_params()))
    assert step == 5 and _equal(p, _params(5))
    assert mgr.restored["step"] == 5


def test_manager_corrupt_newest_falls_back(tmp_path):
    d = str(tmp_path / "run")
    mgr = CheckpointManager(d, keep=3)
    for step in (1, 2, 3):
        mgr.save(step, _params(step))
    newest = mgr.path_for(3)
    data = open(newest, "rb").read()
    with open(newest, "wb") as f:
        f.write(data[: len(data) // 2])
    msgs = []
    p, _, step = mgr.restore_latest(_zeros_like(_params()), log=msgs.append)
    assert step == 2 and _equal(p, _params(2))
    assert any("checksum" in m for m in msgs)
    for step in (1, 2):
        with open(mgr.path_for(step), "wb") as f:
            f.write(b"gone")
    assert mgr.restore_latest(_params(), log=msgs.append) is None


def test_manager_stray_without_manifest(tmp_path):
    d = str(tmp_path / "run")
    mgr = CheckpointManager(d, keep=3)
    mgr.save(4, _params(4))
    os.remove(mgr.manifest_path)        # a copied directory, no manifest
    got = CheckpointManager(d).restore_latest(_zeros_like(_params()))
    assert got is not None and got[2] == 4 and _equal(got[0], _params(4))


# ------------------------------------------------- files across the packages

def _trained(steps=1, zero1=False, **moe_options):
    """Reduced smile-3.7b after ``steps`` sentinel steps on the CPU: its
    parameters, optimizer state and sentinel carry (``moe_options``, such
    as a fault plan, on top of the fused router and the radix sort)."""
    from repro_torch.configs import get_reduced, with_options
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models.transformer import init_model
    from repro_torch.optim import make_schedule
    from repro_torch.common.config import TrainConfig
    from repro_torch.sharding.plan import single_device_plan
    from repro_torch.train.step import build_train_step, zero1_state
    cfg = with_options(get_reduced("smile-3.7b"), **OPTS, **moe_options)
    plan = single_device_plan()
    params = init_model(cfg, plan, seed=3, device="cpu", compute_cast=False)
    opt = make_optimizer("lamb")
    batch = make_batch(cfg, 2, 16, 0, 0)
    step = build_train_step(cfg, TrainConfig(global_batch_size=2, seq_len=16),
                            plan, opt, make_schedule("cosine", 1e-3, 1, 10),
                            params, batch, zero1=zero1, sentinel=True)
    state = zero1_state(params, cfg, plan) if zero1 else opt.init(params)
    sent = S.init_sentinel_state()
    for i in range(steps):
        params, state, m, sent = step(params, state, batch, i + 1, sent)
    return cfg, params, state, sent, step, batch


def _assert_trees_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("zero1", [False, True], ids=["lamb", "zero1"])
def test_port_file_loads_in_jax(zero1, tmp_path):
    cfg, params, state, sent, _, _ = _trained(zero1=zero1)
    path = str(tmp_path / "port.npz")
    save_checkpoint(path, params, state, step=1, extra=sent)
    p_want, o_want = params_to_jax(params), opt_state_to_jax(state, params)
    x_want = JS.SentinelState(**opt_state_to_jax(sent))
    like_o = jax.tree.map(np.zeros_like, o_want)
    p, o, step, x = JC.load_checkpoint(
        path, jax.tree.map(np.zeros_like, p_want), like_o,
        extra_like=JS.init_sentinel_state())
    assert step == 1 and int(o["step"]) == 1
    _assert_trees_equal(p, p_want)
    _assert_trees_equal(o, o_want)
    _assert_trees_equal(x, x_want)


def test_jax_file_loads_in_port(tmp_path):
    cfg, params, state, sent, _, _ = _trained()
    jp, jo = params_to_jax(params), opt_state_to_jax(state, params)
    jx = JS.SentinelState(**opt_state_to_jax(sent))
    path = str(tmp_path / "jax.npz")
    JC.save_checkpoint(path, jp, jo, step=1, extra=jx)
    _, fresh, fresh_state, fresh_sent, _, _ = _trained(steps=0)
    p, o, step, x = load_checkpoint(path, fresh, fresh_state,
                                    extra_like=fresh_sent)
    assert step == 1 and o["step"] == 1
    assert _equal(p, params)
    assert all(torch.equal(a, b) for ga, gb in zip(o["m"], state["m"])
               for a, b in zip(ga, gb))
    assert float(x.loss_ema) == float(sent.loss_ema)
    # the converters agree: JAX's tree back into the port's state
    back = opt_state_from_jax(jo, _trained(steps=0)[2], params)
    assert back["step"] == 1 and all(
        torch.equal(a, b) for ga, gb in zip(back["v"], state["v"])
        for a, b in zip(ga, gb))
    q = params_from_jax(jp, cfg, device="cpu", compute_cast=False)
    assert _equal(q, params)


# ------------------------------------------------------- end to end (train)

_KW = dict(reduced=True, steps=4, batch=2, seq=16, lr=1e-3, seed=0,
           log_every=10, sentinel=True, device="cpu", moe_options=OPTS)


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("resume")
    p_full, _ = TL.train("smile-3.7b", **_KW)
    halted = str(root / "halted")
    TL.train("smile-3.7b", ckpt_dir=halted, ckpt_every=1, ckpt_keep=3,
             halt_after=2, **_KW)
    snaps = sorted(f for f in os.listdir(halted) if f.endswith(".npz"))
    assert snaps == ["ckpt_00000001.npz", "ckpt_00000002.npz"]
    return p_full, halted, root


def test_resume_is_bit_identical(train_runs, capsys):
    p_full, halted, root = train_runs
    d = str(root / "clean")
    shutil.copytree(halted, d)
    p_res, hist = TL.train("smile-3.7b", ckpt_dir=d, ckpt_every=1,
                           ckpt_keep=3, resume=True, **_KW)
    assert "resumed from step 2" in capsys.readouterr().out
    assert _equal(p_res, p_full)
    assert hist[-1]["sentinel"]["steps"] == 4.0


def test_resume_falls_back_past_truncated_snapshot(train_runs, capsys):
    """The newest snapshot truncated: resume restores step 1, the data
    stream replays step 2, and the run is still bit-identical."""
    p_full, halted, root = train_runs
    d = str(root / "corrupt")
    shutil.copytree(halted, d)
    victim = os.path.join(d, "ckpt_00000002.npz")
    data = open(victim, "rb").read()
    with open(victim, "wb") as f:
        f.write(data[: len(data) // 2])
    p_res, _ = TL.train("smile-3.7b", ckpt_dir=d, ckpt_every=1, ckpt_keep=3,
                        resume=True, **_KW)
    out = capsys.readouterr().out
    assert "checksum" in out and "resumed from step 1" in out
    assert _equal(p_res, p_full)


def test_resume_requires_ckpt_dir():
    with pytest.raises(ValueError, match="ckpt-dir"):
        TL.train("smile-3.7b", resume=True, **_KW)


# ------------------------------------------------------------- the sentinel

def test_constants_are_the_references():
    for k in ("EMA_DECAY", "SPIKE_FACTOR", "WARMUP_STEPS", "MAX_LOAD_THRESH",
              "ENTROPY_THRESH"):
        assert getattr(S, k) == getattr(JS, k), k
    assert S.FIELDS == tuple(f.name for f in
                             __import__("dataclasses").fields(JS.SentinelState))


def test_step_verdict_flags():
    sent = S.init_sentinel_state()
    g = [torch.ones(4), torch.zeros(2)]
    t = lambda v: torch.tensor(v, dtype=torch.float32)
    ok, nf, sp = S.step_verdict(t(1.0), g, sent, ())
    assert bool(ok) and not bool(nf) and not bool(sp)
    ok, nf, _ = S.step_verdict(t(float("nan")), g, sent, ())
    assert not bool(ok) and bool(nf)
    bad = [torch.ones(4), torch.zeros(2)]
    bad[0][2] = float("inf")
    ok, nf, _ = S.step_verdict(t(1.0), bad, sent, ())
    assert not bool(ok) and bool(nf)
    # integer tensors never trip the check
    ok, _, _ = S.step_verdict(t(1.0), [torch.tensor(7)], sent, ())
    assert bool(ok)


def test_spike_detector_arms_after_warmup():
    sent = S.init_sentinel_state()
    g = [torch.ones(2)]
    t = lambda v: torch.tensor(v, dtype=torch.float32)
    no = torch.tensor(False)
    ok, _, sp = S.step_verdict(t(1e9), g, sent, ())
    assert bool(ok) and not bool(sp)            # no baseline before warmup
    for _ in range(S.WARMUP_STEPS):
        ok, nf, sp = S.step_verdict(t(2.0), g, sent, ())
        sent = S.update_sentinel(sent, t(2.0), ok, nf, sp, no)
    assert float(sent.loss_ema) == pytest.approx(2.0)
    ok, nf, sp = S.step_verdict(t(2.0 * S.SPIKE_FACTOR + 1.0), g, sent, ())
    assert not bool(ok) and bool(sp) and not bool(nf)
    sent2 = S.update_sentinel(sent, t(1e6), ok, nf, sp, no)
    assert float(sent2.loss_ema) == float(sent.loss_ema)
    assert float(sent2.skipped) == 1.0 and float(sent2.spikes) == 1.0


def test_router_alarm_thresholds():
    t = lambda v: torch.tensor(v, dtype=torch.float32)
    assert bool(S.router_alarm(t(0.95), t(0.8)))     # load concentration
    assert bool(S.router_alarm(t(0.3), t(0.01)))     # entropy collapse
    assert not bool(S.router_alarm(t(0.3), t(0.9)))  # healthy


def test_gated_update_identity_on_bad_step():
    called = []

    def upd(g, o, p):
        called.append(1)
        return {"w": p["w"] - g}, {"m": o["m"] + 1}

    params, opt = {"w": torch.arange(4.0)}, {"m": torch.ones(4)}
    p1, o1 = S.gated_update(torch.tensor(True), upd, torch.full((4,), 2.0),
                            opt, params)
    assert torch.equal(p1["w"], torch.arange(4.0) - 2.0) and called
    p0, o0 = S.gated_update(torch.tensor(False), upd, None, opt, params)
    assert p0 is params and o0 is opt and len(called) == 1


def _bits(params, state):
    from repro_torch.weights import state_leaves
    return [t.detach().clone().view(torch.int32)
            for leaf in state_leaves(params, state) for t in leaf.tensors]


@pytest.mark.parametrize("zero1", [False, True], ids=["plain", "zero1"])
def test_sentinel_step_healthy_and_poisoned(zero1):
    cfg, p_on, s_on, sent, step, batch = _trained(zero1=zero1)
    assert float(sent.steps) == 1.0 and float(sent.skipped) == 0.0
    from repro_torch.configs import get_reduced, with_options
    from repro_torch.models.transformer import init_model
    from repro_torch.optim import make_schedule
    from repro_torch.common.config import TrainConfig
    from repro_torch.sharding.plan import single_device_plan
    from repro_torch.train.step import build_train_step, zero1_state
    plan = single_device_plan()
    p_off = init_model(cfg, plan, seed=3, device="cpu", compute_cast=False)
    opt = make_optimizer("lamb")
    off = build_train_step(cfg, TrainConfig(global_batch_size=2, seq_len=16),
                           plan, opt, make_schedule("cosine", 1e-3, 1, 10),
                           p_off, batch, zero1=zero1)
    s_off = zero1_state(p_off, cfg, plan) if zero1 else opt.init(p_off)
    p_off, s_off, m = off(p_off, s_off, batch, 1)
    assert all(torch.equal(a, b) for a, b in zip(_bits(p_off, s_off),
                                                 _bits(p_on, s_on)))
    # a NaN in the last MoE layer's experts: skipped, bit-unchanged
    w1 = [g for g in leaf_groups(p_on) if g.name.endswith(".experts.w1")]
    with torch.no_grad():
        w1[-1].pieces[-1].view(-1)[0] = float("nan")
    before = _bits(p_on, s_on)
    p_on, s_on, m, sent = step(p_on, s_on, batch, 2, sent)
    assert float(m["skip"]) == 1.0 and not np.isfinite(float(m["loss"]))
    assert all(torch.equal(a, b) for a, b in zip(before, _bits(p_on, s_on)))
    assert (s_on.step if zero1 else s_on["step"]) == 1
    assert (float(sent.nonfinite), float(sent.skipped),
            float(sent.ema_steps)) == (1.0, 1.0, 1.0)


@pytest.mark.parametrize("zero1", [False, True], ids=["plain", "zero1"])
def test_sentinel_skips_a_nanrows_plan(zero1):
    """``tests/test_sentinel.py``'s poisoned steps: every MoE layer's
    dispatch buffer gets NaN rows, so the loss is NaN and the update is
    skipped."""
    cfg, params, state, sent, step, batch = _trained(0, zero1,
                                                     fault_plan="nanrows")
    before = _bits(params, state)
    params, state, m, sent = step(params, state, batch, 1, sent)
    assert not np.isfinite(float(m["loss"])) and float(m["skip"]) == 1.0
    assert all(torch.equal(a, b) for a, b in zip(before, _bits(params,
                                                               state)))
    assert (state.step if zero1 else state["step"]) == 0
    assert (float(sent.nonfinite), float(sent.skipped), float(sent.steps),
            float(sent.ema_steps)) == (1.0, 1.0, 1.0, 0.0)


def test_skew_plan_counts_a_router_alarm_in_both_packages(monkeypatch):
    """Every assignment on one group: the watchdog's max load is 1 and
    the sentinel counts a router alarm (without skipping the step), in the
    port and in the JAX package (its site RNG seeded as the port's)."""
    import random

    import jax.numpy as jnp

    from repro.common import faultinject as JFI
    from repro.common.config import TrainConfig as JTrainConfig
    from repro.configs import get_reduced as jreduced
    from repro.data.pipeline import make_batch as jbatch
    from repro.models.transformer import init_model as jinit
    from repro.optim import make_optimizer as jopt
    from repro.optim import make_schedule as jsched
    from repro.sharding.plan import single_device_plan as jplan
    from repro.train.step import build_train_step as jbuild
    cfg, params, state, sent, step, batch = _trained(0, fault_plan="skew")
    params, state, m, sent = step(params, state, batch, 1, sent)
    assert float(m["skip"]) == 0.0 and float(m["max_load"]) == 1.0
    assert float(sent.router_alarms) == 1.0

    monkeypatch.setattr(JFI, "_rng", lambda fp, level, *tag: random.Random(
        repr((fp.seed, fp.kind, level) + tag)))
    jcfg = jreduced("smile-3.7b")
    jcfg = jcfg.replace(moe=jcfg.moe.with_options(fault_plan="skew"))
    jp = jinit(jax.random.PRNGKey(0), jcfg, jplan())
    jb = {k: jnp.asarray(v) for k, v in jbatch(jcfg, 2, 16, 0, 0).items()}
    opt = jopt("lamb")
    fn, _ = jbuild(jcfg, JTrainConfig(global_batch_size=2, seq_len=16,
                                      steps=10, optimizer="lamb",
                                      sentinel=True),
                   jplan(), opt, jsched("cosine", 1e-3, 1, 10), jp, jb,
                   mesh=None, sentinel=True)
    _, _, jm, jsent = fn(jp, opt.init(jp), jb, jnp.int32(1),
                         JS.init_sentinel_state())
    assert float(jm["skip"]) == 0.0 and float(jm["max_load"]) == 1.0
    assert float(jsent.router_alarms) == 1.0
