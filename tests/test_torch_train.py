"""The training slice against the JAX package: reduced smile-3.7b and
switch-3.7b with ``router_impl="fused"`` and ``sort_impl="radix"`` at batch
4 x seq 64, on the same weights (carried across by ``params_from_jax`` in
its fp32 training form) and the same batches.

In fp32 (``ModelConfig.dtype="float32"``; the JAX package's forward embeds
in bf16 whatever the config says, so its ``embed_inputs`` is pinned to fp32
here) the loss and every gradient leaf agree within rtol 1e-4 / atol 1e-6:
the same fp32 math, summed in other orders through 2 layers, remat and an
LM head.  The MoE statistics are exact (the same routing decisions), and a
3-step LAMB loss curve through ``build_train_step`` agrees within 1e-4.
With the default bf16 compute the step-1 loss agrees within 2e-2 (bf16
rounds at other places in the two frameworks).

The dropless backend (``--dispatch-backend dropless``, ragged hops on and
off) is held to the same gradients and loss curve: its expert FFN runs the
plain ragged path (``use_kernel=False``) on both sides, as the JAX train
step does.

The robust runtime's options of ``train()`` (``zero1``, ``sentinel``,
``resume``, ``ckpt``, ``ckpt_every``, ``ckpt_dir``, ``ckpt_keep``) and
``--zero1`` through the CLI each run a step or two and do what they say
(``test_train_option_runs``, ``test_cli_zero1_runs``; the JAX-side
comparisons of those are in ``test_torch_zero1.py`` and
``test_torch_checkpoint.py``).

Pallas does not run on this JAX, so the JAX side's fused router and radix
sort take their oracles (``ROUTER_FUSED_MIN_ROWS`` and ``RADIX_MIN_ROWS``
raised past every call here; the JAX package's own tests hold the oracles
bit-identical to the kernels); the port's wrappers run their plain versions
on the CPU.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.configs import with_options as jwith_options
from repro.common.config import TrainConfig as JTrainConfig
from repro.data.pipeline import make_batch as jmake_batch
from repro.kernels import ops as jops
from repro.models import transformer as JT
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim import make_schedule as jmake_schedule
from repro.sharding.plan import single_device_plan as jplan
from repro.train import evaluate as JE
from repro.train import step as JS
from repro_torch.common.config import TrainConfig as TTrainConfig
from repro_torch.configs import get_reduced as tget_reduced
from repro_torch.configs import with_options as twith_options
from repro_torch.launch import train as TL
from repro_torch.optim import make_optimizer as tmake_optimizer
from repro_torch.optim import make_schedule as tmake_schedule
from repro_torch.sharding.plan import single_device_plan as tplan
from repro_torch.train import evaluate as TE
from repro_torch.train import step as TS
from repro_torch.weights import params_from_jax

OPTS = dict(router_impl="fused", sort_impl="radix")
B, S = 4, 64
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True)
def _jax_oracles(monkeypatch):
    monkeypatch.setattr(jops, "RADIX_MIN_ROWS", 1 << 30)
    monkeypatch.setattr(jops, "ROUTER_FUSED_MIN_ROWS", 1 << 30)


def _fp32_jax(monkeypatch):
    monkeypatch.setattr(JT, "embed_inputs",
                        functools.partial(JT.embed_inputs, dtype=jnp.float32))


def _setup(arch, fp32, seed=0, opts=OPTS):
    jcfg = jwith_options(jget_reduced(arch), **opts)
    tcfg = twith_options(tget_reduced(arch), **opts)
    if fp32:
        tcfg = tcfg.replace(dtype="float32")
    jparams = JT.init_model(jax.random.PRNGKey(seed), jcfg, jplan())
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu", compute_cast=False)
    return jcfg, tcfg, jparams, tparams


def _pairs(a, b, path=""):
    """Walk two port parameter trees in step: (path, tensor_a, tensor_b)."""
    if isinstance(a, dict):
        for k in a:
            yield from _pairs(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _pairs(x, y, f"{path}[{i}]")
    elif a is not None:
        yield path, a, b


def _check_loss_and_grads(arch, opts, monkeypatch):
    _fp32_jax(monkeypatch)
    jcfg, tcfg, jparams, tparams = _setup(arch, fp32=True, opts=opts)
    batch = jmake_batch(jcfg, B, S, seed=0, step=0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jgrads, jm = jax.grad(
        lambda p: JS._ce_loss(p, jb, jcfg, jplan()), has_aux=True)(jparams)
    for _, t, _ in _pairs(tparams, tparams):
        t.requires_grad_(True)
    loss, tm = TS._ce_loss(tparams, TS.to_device(batch, "cpu"), tcfg,
                           tplan())
    loss.backward()
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    for k in ("ce", "lb", "z"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    for k in ("drop_frac", "max_load"):
        assert float(tm[k]) == float(jm[k]), k
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), tcfg,
                           device="cpu", compute_cast=False)
    n = 0
    for path, p, g in _pairs(tparams, want):
        torch.testing.assert_close(p.grad, g, **GRAD_TOL, msg=path)
        n += 1
    assert n > 20
    return tm


def _check_loss_curve(arch, micro, opts, monkeypatch):
    _fp32_jax(monkeypatch)
    jcfg, tcfg, jparams, tparams = _setup(arch, fp32=True, seed=1, opts=opts)
    steps = 3
    kw = dict(global_batch_size=B, seq_len=S, steps=steps, warmup_steps=1,
              micro_batch_size=micro)
    jt, tt = JTrainConfig(**kw), TTrainConfig(**kw)
    jopt, topt = jmake_optimizer("lamb"), tmake_optimizer("lamb")
    jsched = jmake_schedule("cosine", 3e-4, 1, steps)
    tsched = tmake_schedule("cosine", 3e-4, 1, steps)
    b0 = jmake_batch(jcfg, B, S, seed=0, step=0)
    jstep, _ = JS.build_train_step(jcfg, jt, jplan(), jopt, jsched, jparams,
                                   {k: jnp.asarray(v) for k, v in b0.items()})
    tstep = TS.build_train_step(tcfg, tt, tplan(), topt, tsched, tparams, b0)
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    drops = []
    for i in range(steps):
        b = jmake_batch(jcfg, B, S, seed=0, step=i)
        jparams, jstate, jm = jstep(jparams, jstate,
                                    {k: jnp.asarray(v) for k, v in b.items()},
                                    jnp.int32(i + 1))
        tparams, tstate, tm = tstep(tparams, tstate, b, i + 1)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-4, i
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        assert float(tm["drop_frac"]) == float(jm["drop_frac"])
        drops.append(float(tm["drop_frac"]))
    return drops


@pytest.mark.parametrize("arch", ["smile-3.7b", "switch-3.7b"])
def test_loss_and_grads_match_jax_fp32(arch, monkeypatch):
    _check_loss_and_grads(arch, OPTS, monkeypatch)


@pytest.mark.parametrize("arch,micro", [("smile-3.7b", 0),
                                        ("switch-3.7b", 0),
                                        ("smile-3.7b", 2)])
def test_loss_curve_matches_jax_fp32(arch, micro, monkeypatch):
    """Three LAMB steps; ``micro=2`` accumulates two micro-batches of 2
    (the JAX package's ``lax.scan``, a Python loop in the port)."""
    _check_loss_curve(arch, micro, OPTS, monkeypatch)


# --dispatch-backend dropless, with ragged hops on and off
DROPLESS = {"ragged": dict(OPTS, dispatch_backend="dropless",
                           ragged_a2a=True),
            "padded": dict(OPTS, dispatch_backend="dropless",
                           ragged_a2a=False)}


@pytest.mark.parametrize("hops", list(DROPLESS))
def test_dropless_loss_and_grads_match_jax_fp32(hops, monkeypatch):
    tm = _check_loss_and_grads("smile-3.7b", DROPLESS[hops], monkeypatch)
    if hops == "ragged":
        assert float(tm["drop_frac"]) == 0       # nothing drops anywhere


@pytest.mark.parametrize("hops", list(DROPLESS))
def test_dropless_loss_curve_matches_jax_fp32(hops, monkeypatch):
    drops = _check_loss_curve("smile-3.7b", 0, DROPLESS[hops], monkeypatch)
    if hops == "ragged":
        assert drops == [0.0, 0.0, 0.0]


def test_cli_dropless_trains(monkeypatch):
    """``--dispatch-backend dropless`` through the launcher's flags (derived
    from MOE_OPTIONS): the config carries the backend, the loss is finite
    and no kernel launches on the CPU."""
    got = {}
    real = TL.train

    def spy(*a, **kw):
        got["params"], got["hist"] = real(*a, **kw)
        got["opts"] = kw["moe_options"]
        return got["params"], got["hist"]

    monkeypatch.setattr(TL, "train", spy)
    monkeypatch.setattr("sys.argv", [
        "train", "--arch", "smile-3.7b", "--reduced", "--device", "cpu",
        "--steps", "1", "--batch", "2", "--seq", "16", "--log-every", "1",
        "--dispatch-backend", "dropless", "--ragged-a2a", "off"])
    TL.main()
    assert got["opts"] == {"dispatch_backend": "dropless",
                           "ragged_a2a": False}
    h = got["hist"][0]
    assert np.isfinite(h["loss"])
    assert all(v == 0 for v in h["launches"].values())


@pytest.mark.parametrize("arch", ["smile-3.7b", "switch-3.7b"])
def test_bf16_step1_loss_matches_jax(arch):
    jcfg, tcfg, jparams, tparams = _setup(arch, fp32=False, seed=2)
    batch = jmake_batch(jcfg, B, S, seed=3, step=0)
    jloss, _ = JS._ce_loss(jparams, {k: jnp.asarray(v)
                                     for k, v in batch.items()},
                           jcfg, jplan())
    with torch.no_grad():
        tloss, _ = TS._ce_loss(tparams, TS.to_device(batch, "cpu"), tcfg,
                               tplan())
    assert abs(float(tloss) - float(jloss)) <= 2e-2


def test_evaluate_matches_jax_fp32(monkeypatch):
    _fp32_jax(monkeypatch)
    jcfg, tcfg, jparams, tparams = _setup("smile-3.7b", fp32=True, seed=5)
    jev = JE.evaluate(jparams, jcfg, jplan(), batch=B, seq=S, n_batches=2)
    tev = TE.evaluate(tparams, tcfg, tplan(), batch=B, seq=S, n_batches=2)
    assert tev["eval_tokens"] == jev["eval_tokens"]
    np.testing.assert_allclose(tev["eval_ce"], jev["eval_ce"], rtol=1e-5)


def _tiny(**kw):
    return TL.train("smile-3.7b", steps=kw.pop("steps", 2), batch=2, seq=16,
                    lr=1e-3, log_every=1, device="cpu", moe_options=OPTS,
                    **kw)


@pytest.fixture(scope="module")
def one_thread():
    """Tiny tensors: one intra-op thread (the suite's workers share the
    host's cores, and threads that wait on each other cost more than the
    work)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def plain_run(one_thread):
    """Two plain steps: the parameters the options are held to."""
    return _tiny()[0]


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for _, x, y in _pairs(a, b))


def _option_zero1(tmp_path, capsys, plain):
    """ZeRO-1 on one rank shards nothing: LAMB, to the bit."""
    p, h = _tiny(zero1=True)
    assert _same(p, plain) and np.isfinite(h[-1]["loss"])


def _option_sentinel(tmp_path, capsys, plain):
    p, h = _tiny(sentinel=True)
    assert [e["skip"] for e in h[:2]] == [0.0, 0.0]
    assert h[-1]["sentinel"] == {"steps": 2.0, "skipped": 0.0,
                                 "nonfinite": 0.0, "spikes": 0.0,
                                 "router_alarms": h[-1]["sentinel"][
                                     "router_alarms"]}
    assert _same(p, plain)


def _option_resume(tmp_path, capsys, plain):
    d = str(tmp_path / "run")
    _tiny(steps=2, ckpt_dir=d, ckpt_every=1, halt_after=1)
    p, h = _tiny(steps=2, ckpt_dir=d, resume=True)
    assert "resumed from step 1" in capsys.readouterr().out
    assert h[0]["step"] == 2 and _same(p, plain)


def _option_ckpt(tmp_path, capsys, plain):
    from repro_torch.train.checkpoint import load_checkpoint
    path = str(tmp_path / "final.npz")
    p, _ = _tiny(ckpt=path)
    like, _ = _tiny(steps=0)
    got, _, step = load_checkpoint(path, like)
    assert step == 2 and _same(got, p) and _same(got, plain)


def _option_ckpt_every(tmp_path, capsys, plain):
    d = tmp_path / "run"
    _, h = _tiny(steps=3, ckpt_dir=str(d), ckpt_every=2)
    assert sorted(os.listdir(d)) == ["ckpt_00000002.npz", "manifest.json"]
    assert [s["step"] for s in h[-1]["checkpoints"]["saves"]] == [2]


def _option_ckpt_dir(tmp_path, capsys, plain):
    """An empty run directory: resume starts fresh."""
    d = str(tmp_path / "empty")
    p, _ = _tiny(ckpt_dir=d, resume=True)
    assert "no valid checkpoint" in capsys.readouterr().out
    assert _same(p, plain)


def _option_ckpt_keep(tmp_path, capsys, plain):
    d = tmp_path / "run"
    _tiny(steps=3, ckpt_dir=str(d), ckpt_every=1, ckpt_keep=2)
    assert sorted(os.listdir(d)) == ["ckpt_00000002.npz",
                                     "ckpt_00000003.npz", "manifest.json"]


TRAIN_OPTIONS = {"zero1": _option_zero1, "sentinel": _option_sentinel,
                 "resume": _option_resume, "ckpt": _option_ckpt,
                 "ckpt_every": _option_ckpt_every,
                 "ckpt_dir": _option_ckpt_dir,
                 "ckpt_keep": _option_ckpt_keep}


@pytest.mark.parametrize("flag", list(TRAIN_OPTIONS))
def test_train_option_runs(flag, tmp_path, capsys, plain_run):
    """Each robust-runtime option of ``train()`` runs a step or two on the
    CPU and does what it says."""
    TRAIN_OPTIONS[flag](tmp_path, capsys, plain_run)


def test_cli_zero1_runs(monkeypatch, one_thread):
    got = {}
    real = TL.train

    def spy(*a, **kw):
        got["kw"] = kw
        got["params"], got["hist"] = real(*a, **kw)
        return got["params"], got["hist"]

    monkeypatch.setattr(TL, "train", spy)
    monkeypatch.setattr("sys.argv", ["train", "--arch", "smile-3.7b",
                                     "--reduced", "--device", "cpu",
                                     "--steps", "2", "--batch", "2",
                                     "--seq", "16", "--log-every", "1",
                                     "--zero1", "--sentinel"])
    TL.main()
    assert got["kw"]["zero1"] is True and got["kw"]["sentinel"] is True
    assert [h["step"] for h in got["hist"][:2]] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in got["hist"][:2])


def test_train_runs_and_logs():
    params, hist = TL.train("smile-3.7b", steps=2, batch=2, seq=16,
                            log_every=1, device="cpu",
                            moe_options=OPTS, moe_grid=(2, 2))
    assert [h["step"] for h in hist] == [1, 2]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in hist)
    # on the CPU the wrappers run their plain versions: no launches
    assert all(v == 0 for h in hist for v in h["launches"].values())
    assert params["embed"]["table"].dtype == torch.float32


def test_params_from_jax_forms():
    """Serving casts the blocks' matmul weights to the compute dtype once;
    training keeps every parameter fp32, equal to the JAX leaves."""
    jcfg, tcfg = jget_reduced("smile-3.7b"), tget_reduced("smile-3.7b")
    tree = jax.tree.map(np.asarray,
                        JT.init_model(jax.random.PRNGKey(6), jcfg, jplan()))
    serve = params_from_jax(tree, tcfg, device="cpu")
    train = params_from_jax(tree, tcfg, device="cpu", compute_cast=False)
    blk_s, blk_t = serve["stages"][0]["moe"][0], train["stages"][0]["moe"][0]
    assert blk_s["moe"]["experts"]["w1"].dtype == torch.bfloat16
    assert blk_s["attn"]["wq"].dtype == torch.bfloat16
    assert blk_s["moe"]["router_inter"]["w"].dtype == torch.float32
    assert all(t.dtype == torch.float32 for _, t, _ in _pairs(train, train))
    want = tree["stages"][0]["moe"]["moe"]["experts"]["w1"][0]
    np.testing.assert_array_equal(blk_t["moe"]["experts"]["w1"].numpy(), want)
    assert torch.equal(blk_s["moe"]["experts"]["w1"],
                       blk_t["moe"]["experts"]["w1"].to(torch.bfloat16))
