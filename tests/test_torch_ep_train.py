"""Training over a ``(data 2, model 2)`` mesh of gloo ranks on the CPU,
against the JAX package's ``shard_map`` step and the port's own one rank.

Four gloo ranks (a module-wide :class:`RankPool` with its mesh built
once) run the port; the JAX side runs once per module in a subprocess (8
fake CPU devices, the ragged All2All emulated; ``JaxSide`` in
``tests/test_torch_mesh.py``).  Both sides draw their inputs from numpy
``default_rng``.

* Each collective's gradient (psum, the tiled and stacked all_gather, the
  All2All, the ragged exchange there and back and truncated, the token
  split) against ``jax.grad`` inside ``shard_map``: each rank's loss is
  ``sum(f(x) * ct)`` with its own cotangent ``ct``; within 1e-6 of the
  largest value (sums in other orders).
* One LAMB step of the reduced ``smile-3.7b`` (sort and dropless),
  ``switch-3.7b`` and ``qwen3-moe-30b-a3b`` in fp32 (the JAX package's
  ``embed_inputs`` pinned to fp32 in its subprocess, its fused router and
  radix sort on their oracles), from numpy-drawn parameters carried across
  by ``params_from_jax``: against JAX's ``build_train_step(..., mesh=)``
  within ``JAX_BOUNDS`` (the loss and gradient norm at
  ``tests/distributed/_train_equiv.py``'s 2e-2 and 6e-2 relative; the
  updated parameters at 1e-6, far inside its 5e-3, which is more than one
  LAMB step at lr 1e-3 moves any element: a step that left the parameters
  as they were would pass it), and against the port's one-rank step
  within ``ONE_RANK``.  The readings on the four cases: against one rank
  at most 9.5e-7 of the loss (qwen3-moe; 6.28), 9.2e-8 relative of the
  gradient norm and 1.8e-7 of any updated parameter; against JAX 4.8e-7,
  9.4e-8 and 1.2e-7.  The parameter bounds leave about five times that
  room for sums in other orders, and the step must move some parameter by
  ``MOVED`` times the bound.  Each leaf's
  synced gradient is held to one rank's too (``GRAD_REL``; readings
  1.5e-6 to 2.2e-6 of the leaf's largest), since LAMB's first step is
  nearly the gradient's sign.  The port's ranks remat their blocks (the
  JAX side does not: the same numbers).
* Two micro-batches over the mesh against one rank fed the same two
  micro-batches; ``evaluate`` over the mesh against one rank;
  ``train(..., mesh=)`` for 2 steps against one rank's ``train()`` (bf16,
  the step-1 bound of ``_train_equiv.py``), and the CLI under
  ``torchrun`` (env://).
"""
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import RankPool
from repro_torch.sharding import comm
from test_torch_ep_serve import flat, jax_tree, unflat
from test_torch_mesh import JaxSide

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MESH = ((2, 2), ("data", "model"))
WORLD = 4
AXES = {"data": "data", "model": "model", "data+model": ("data", "model")}
SIZES = {"data": 2, "model": 2, "data+model": 4}
FLOAT_REL = 1e-6
TIMEOUT_S = 180
OPTS = dict(router_impl="fused", sort_impl="radix")
# name -> (arch, options): the paper's MLM encoders and the MoE decoder
CASES = {"smile-sort": ("smile-3.7b", {}),
         "smile-dropless": ("smile-3.7b", {"dispatch_backend": "dropless"}),
         "switch-sort": ("switch-3.7b", {}),
         "qwen3-sort": ("qwen3-moe-30b-a3b", {})}
GB, SEQ = 8, 32                 # global batch: 4 rows a dp rank
LR, WARMUP, HORIZON = 1e-3, 2, 100
# against the JAX package: tests/distributed/_train_equiv.py's loss and
# gradient-norm bounds; the updated parameters from the readings (see the
# module docstring)
JAX_BOUNDS = dict(loss=2e-2, grad_norm_rel=6e-2, param=1e-6)
# against the port's own one rank in fp32 (see the module docstring)
ONE_RANK = dict(loss=5e-6, grad_norm_rel=1e-6, param=1e-6)
# the step's largest move of a parameter, at least this many times the
# parameter bounds
MOVED = 100
TRUNC_ROWS = 9
# each leaf's gradient against one rank's, relative to the leaf's largest
GRAD_REL = 2e-5


def train_cfg(case: str, package: str = "torch"):
    if package == "jax":
        from repro.configs import get_reduced, with_options
    else:
        from repro_torch.configs import get_reduced, with_options
    arch, opts = CASES[case]
    return with_options(get_reduced(arch), **OPTS, **opts).replace(
        dtype="float32")


def train_batch(cfg) -> dict:
    """The global batch: random tokens, a label at ~15% of them (MLM)."""
    rng = np.random.default_rng(21)
    tokens = rng.integers(0, cfg.vocab_size, (GB, SEQ)).astype(np.int32)
    labels = np.where(rng.random((GB, SEQ)) < 0.15, tokens, -1)
    return {"tokens": tokens, "labels": labels.astype(np.int32)}


def params_file(out_dir, case: str) -> Path:
    return Path(out_dir) / f"params-{case}.npz"


def grad_inputs(name: str) -> dict:
    """Every rank's inputs and cotangents of the collective forms over
    axes ``name``: (WORLD, ...) arrays, block ``r`` for rank ``r``."""
    P = SIZES[name]
    rng = np.random.default_rng(30 + list(AXES).index(name))
    R = 12
    f32 = np.float32
    counts = np.stack([rng.multinomial(int(rng.integers(0, R + 1)),
                                       [1 / P] * P) for _ in range(WORLD)])
    out_shapes = {"psum": (6, 5), "all_gather0": (P * 6, 5),
                  "all_gather1": (6, P * 5), "all_gather_stack": (P, 6, 5),
                  "all_to_all": (P, 3, 5), "ragged": (P * R, 5),
                  "ragged_back": (R, 5), "trunc": (TRUNC_ROWS, 5),
                  "split": (7, 5)}
    inp = dict(x=rng.standard_normal((WORLD, 6, 5)).astype(f32),
               a2a=rng.standard_normal((WORLD, P, 3, 5)).astype(f32),
               rows=rng.standard_normal((WORLD, R, 5)).astype(f32),
               tokens=rng.standard_normal((WORLD, 7, 5)).astype(f32),
               counts=counts.astype(np.int32))
    for k, s in out_shapes.items():
        inp[f"ct_{k}"] = rng.standard_normal((WORLD,) + s).astype(f32)
    return inp


def grad_forms(C, axes, P, counts):
    """form -> (input name, f): the collectives whose gradients are held,
    written once for both packages (``C`` is the package's comm)."""
    R = 12

    def ragged_back(rows):
        recv, rc = C.ragged_all_to_all(rows, counts, axes, recv_rows=P * R)
        return C.ragged_all_to_all(recv, rc, axes, recv_rows=R,
                                   recv_counts=counts)[0]

    return {
        "psum": ("x", lambda x: C.psum(x, axes)),
        "all_gather0": ("x", lambda x: C.all_gather(x, axes, axis=0)),
        "all_gather1": ("x", lambda x: C.all_gather(x, axes, axis=1)),
        "all_gather_stack": ("x", lambda x: C.all_gather(x, axes, axis=0,
                                                         tiled=False)),
        "all_to_all": ("a2a", lambda x: C.all_to_all(x, axes, split_axis=0,
                                                     concat_axis=0)),
        "ragged": ("rows", lambda r: C.ragged_all_to_all(
            r, counts, axes, recv_rows=P * R)[0]),
        "ragged_back": ("rows", ragged_back),
        "trunc": ("rows", lambda r: C.ragged_all_to_all(
            r, counts, axes, recv_rows=TRUNC_ROWS, allow_truncate=True)[0]),
        "split": ("tokens", lambda t: C.unsplit_tokens(
            C.split_tokens(t, axes, P)[0], axes, 7)),
    }


FORMS = list(grad_forms(None, None, 1, None))


# =============================================================================
# The JAX side (a subprocess with 8 fake devices)
# =============================================================================

def _jax_main(out_dir: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as Pspec

    from repro.common.config import TrainConfig
    from repro.kernels import ops as jops
    from repro.models import transformer as JT
    from repro.optim import make_optimizer, make_schedule
    from repro.sharding import comm as JC
    from repro.sharding.compat import make_mesh, shard_map
    from repro.sharding.plan import test_plan
    from repro.train.step import build_train_step

    save = JaxSide.saver(out_dir)
    jops.RADIX_MIN_ROWS = 1 << 30
    jops.ROUTER_FUSED_MIN_ROWS = 1 << 30
    JT.embed_inputs = functools.partial(JT.embed_inputs, dtype=jnp.float32)
    mesh = make_mesh(*MESH)
    plan = test_plan(2, 2)
    fl = Pspec(("data", "model"))

    for name, axes in AXES.items():
        inp = grad_inputs(name)
        keys = sorted(inp)

        def f(*blocks):
            loc = {k: b[0] for k, b in zip(keys, blocks)}
            out = {}
            for form, (arg, fn) in grad_forms(JC, axes, SIZES[name],
                                              loc["counts"]).items():
                ct = loc[f"ct_{form}"]
                out[form] = jax.grad(
                    lambda a: jnp.sum(fn(a) * ct))(loc[arg])[None]
            return out

        fn = jax.jit(shard_map(f, mesh=mesh, in_specs=(fl,) * len(keys),
                               out_specs=fl))
        save(f"grad/{name}", fn(*(jnp.asarray(inp[k]) for k in keys)))

    for case in CASES:
        cfg = train_cfg(case, "jax").replace(remat=False)
        params = jax.tree.map(jnp.asarray, unflat(dict(np.load(
            params_file(out_dir, case)))))
        batch = {k: jnp.asarray(v) for k, v in train_batch(cfg).items()}
        tcfg = TrainConfig(global_batch_size=GB, seq_len=SEQ, lr=LR,
                           warmup_steps=WARMUP, grad_clip=1.0)
        opt = make_optimizer("lamb")
        step, _ = build_train_step(cfg, tcfg, plan, opt,
                                   make_schedule("cosine", LR, WARMUP,
                                                 HORIZON),
                                   params, batch, mesh=mesh)
        p, _, m = step(params, opt.init(params), batch, jnp.int32(1))
        out = {f"p/{k}": v for k, v in flat(jax.tree.map(np.asarray,
                                                         p)).items()}
        out.update(loss=m["loss"], grad_norm=m["grad_norm"])
        save(f"train/{case}", out)


# =============================================================================
# Fixtures and rank tasks
# =============================================================================

@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax")
    for case in CASES:
        np.savez(params_file(out, case), **flat(jax_tree(train_cfg(case))))
    js = JaxSide("test_torch_ep_train", out)
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


def port_flat(tree) -> dict:
    """The port's parameter tree as ``{"a/0/b": numpy}``."""
    from repro_torch.sharding.specs import map_tree
    out = {}
    map_tree(lambda path, t: out.__setitem__(
        "/".join(path), t.detach().numpy().copy()), tree)
    return out


def full_params(case: str, arrays: dict):
    """The JAX package's tree (flat numpy) as the port's fp32 parameters."""
    from repro_torch.weights import params_from_jax
    return params_from_jax(unflat(arrays), train_cfg(case), device="cpu",
                           compute_cast=False)


def _tcfg(**kw):
    from repro_torch.common.config import TrainConfig
    return TrainConfig(global_batch_size=GB, seq_len=SEQ, lr=LR,
                       warmup_steps=WARMUP, grad_clip=1.0, **kw)


def _step(params, cfg, plan, mesh, batch, micro: int = 0):
    """One LAMB step of the port; the params are updated in place."""
    from repro_torch.optim import make_optimizer, make_schedule
    from repro_torch.train.step import build_train_step
    opt = make_optimizer("lamb")
    step = build_train_step(cfg, _tcfg(micro_batch_size=micro), plan, opt,
                            make_schedule("cosine", LR, WARMUP, HORIZON),
                            params, batch, mesh=mesh)
    _, _, m = step(params, opt.init(params), batch, 1)
    return {k: float(v) for k, v in m.items()}


def _rank_params(case, file):
    from repro_torch.sharding import specs as S_
    from repro_torch.sharding.plan import plan_from_mesh
    mesh = comm.bound_mesh()
    plan = plan_from_mesh(mesh)
    full = full_params(case, dict(np.load(file)))
    cfg = train_cfg(case)
    return S_.shard_params(full, S_.param_specs(full, cfg, plan), mesh), \
        cfg, plan, mesh


def _train_task(rank, case, file, micro=0):
    params, cfg, plan, mesh = _rank_params(case, file)
    mesh.wire.reset()
    m = _step(params, cfg, plan, mesh, train_batch(cfg), micro)
    return {"metrics": m, "params": port_flat(params),
            "wire": mesh.wire.summary()}


def _grads_task(rank, case, file):
    """The rank's gradients of one step, synced over the replicated axes:
    each leaf's ``.grad`` after the psums, before the clip."""
    from repro_torch.optim import leaf_groups
    from repro_torch.optim.optimizers import group_axes
    from repro_torch.sharding import specs as S_
    from repro_torch.train.step import _loss_backward, sync_grads
    params, cfg, plan, mesh = _rank_params(case, file)
    groups = leaf_groups(params)
    for g in groups:
        for p in g.pieces:
            p.requires_grad_(True)
    batch = S_.shard_params({k: torch.from_numpy(v) for k, v in
                             train_batch(cfg).items()},
                            S_.batch_specs(train_batch(cfg), plan), mesh)
    _loss_backward(params, batch, cfg, plan, 1)
    sync_grads(groups, group_axes(groups, S_.shard_axes(
        S_.param_specs(params, cfg, plan), plan)))
    return port_flat(S_.map_tree(lambda _, p: p.grad, params))


def _eval_task(rank, case, file):
    from repro_torch.train.evaluate import evaluate
    params, cfg, plan, _ = _rank_params(case, file)
    return evaluate(params, cfg, plan, batch=GB, seq=SEQ, n_batches=2)


def _grad_task(rank, name):
    inp = grad_inputs(name)
    loc = {k: torch.from_numpy(v[rank.rank]) for k, v in inp.items()}
    out = {}
    for form, (arg, fn) in grad_forms(comm, AXES[name], SIZES[name],
                                      loc["counts"]).items():
        x = loc[arg].clone().requires_grad_(True)
        (fn(x) * loc[f"ct_{form}"]).sum().backward()
        out[form] = x.grad.numpy()
    return out


def _pmax_task(rank):
    x = torch.ones(3, requires_grad=True)
    try:
        comm.pmax(x, "model")
    except ValueError as e:
        return str(e)
    return ""


def _train_loop_task(rank):
    from repro_torch.launch.train import train
    _, hist = train("smile-3.7b", reduced=True, steps=2, batch=GB, seq=SEQ,
                    log_every=1, moe_options=OPTS, mesh=comm.bound_mesh())
    return hist


# =============================================================================
# Helpers of the comparisons
# =============================================================================

def _close(got, want, rel, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max()) / scale
    assert err <= rel, f"{what}: {err:.3e} of max |ref| > {rel}"


def _rank_mesh(r: int):
    """A rank's mesh coordinates alone (no process groups): what
    ``shard_params`` needs to cut that rank's slice here."""
    from repro_torch.launch.mesh import Mesh
    return Mesh(MESH[0], MESH[1], r, torch.device("cpu"), "gloo", {},
                comm.WireLog())


def _max_param_err(got_ranks, full, case) -> float:
    """The largest difference between each rank's updated slices and its
    slice of ``full`` (the port's parameter tree)."""
    from repro_torch.sharding import specs as S_
    from repro_torch.sharding.plan import plan_from_mesh
    worst = 0.0
    for r, got in enumerate(got_ranks):
        mesh = _rank_mesh(r)
        plan = plan_from_mesh(mesh)
        want = port_flat(S_.shard_params(
            full, S_.param_specs(full, train_cfg(case), plan), mesh))
        assert set(want) == set(got)
        for k in want:
            worst = max(worst, float(np.abs(got[k] - want[k]).max()))
    return worst


def _max_moved(new, old) -> float:
    """The largest change of any element from tree ``old`` to ``new``."""
    a, b = port_flat(new), port_flat(old)
    assert set(a) == set(b)
    return max(float(np.abs(a[k] - b[k]).max()) for k in a)


def _check(m, want_loss, want_gnorm, err, bounds, what):
    dl = abs(m["loss"] - want_loss)
    dg = abs(m["grad_norm"] - want_gnorm) / max(want_gnorm, 1e-6)
    assert dl <= bounds["loss"], (what, "loss", dl)
    assert dg <= bounds["grad_norm_rel"], (what, "grad_norm", dg)
    assert err <= bounds["param"], (what, "params", err)


def _one_rank(case, arrays, batch=None, micro=0):
    """The port's one-rank step: (metrics, updated params)."""
    from repro_torch.sharding.plan import single_device_plan
    full = full_params(case, arrays)
    cfg = train_cfg(case)
    m = _step(full, cfg, single_device_plan(), None,
              train_batch(cfg) if batch is None else batch, micro)
    return m, full


# =============================================================================
# Tests
# =============================================================================

@pytest.mark.parametrize("name", list(AXES))
@pytest.mark.parametrize("form", FORMS)
def test_collective_grad_matches_jax(form, name, ranks, jax_side):
    got = ranks.run(_grad_task, name, timeout_s=TIMEOUT_S)
    ref = jax_side.get(f"grad/{name}", timeout_s=TIMEOUT_S)
    _close(np.stack([g[form] for g in got]), ref[form], FLOAT_REL,
           f"{name} {form}")


def test_pmax_refuses_a_gradient(ranks):
    assert all("no gradient" in e for e in ranks.run(_pmax_task))


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_lamb_step_matches_jax_and_one_rank(case, ranks, jax_side):
    file = params_file(jax_side.out, case)
    got = ranks.run(_train_task, case, file, timeout_s=TIMEOUT_S)
    ms = [g["metrics"] for g in got]
    for k in ("loss", "grad_norm", "ce", "lb"):    # replicated metrics
        assert max(m[k] for m in ms) == min(m[k] for m in ms), k
    arrays = dict(np.load(file))
    m1, one = _one_rank(case, arrays)
    _check(ms[0], m1["loss"], m1["grad_norm"],
           _max_param_err([g["params"] for g in got], one, case), ONE_RANK,
           f"{case} against one rank")
    ref = jax_side.get(f"train/{case}", timeout_s=TIMEOUT_S)
    jfull = full_params(case, {k[2:]: v for k, v in ref.items()
                               if k.startswith("p/")})
    _check(ms[0], float(ref["loss"]), float(ref["grad_norm"]),
           _max_param_err([g["params"] for g in got], jfull, case),
           JAX_BOUNDS, f"{case} against JAX")
    moved = _max_moved(jfull, full_params(case, arrays))
    assert moved >= MOVED * max(JAX_BOUNDS["param"], ONE_RANK["param"]), (
        case, "the step barely moved the parameters", moved)
    # both hops' wire carried gradients back: the All2All's (ragged under
    # dropless) backward over each hop's axis, and the tp psums'
    wire = got[0]["wire"]
    op = ("ragged_all_to_all" if CASES[case][1].get("dispatch_backend")
          == "dropless" else "all_to_all")
    hops = ("data", "model") if case.startswith(("smile", "qwen3")) else (
        "data+model",)
    for axis in hops:
        assert wire[f"{op}.grad {axis} float32"]["calls"] > 0, (axis, wire)
    assert wire["psum.grad model float32"]["calls"] > 0


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_grads_match_one_rank(case, ranks, jax_side):
    """Every leaf's gradient, assembled by the backward's collectives and
    the psums over the replicated axes, against the one rank's gradient
    of the same leaf, sliced (LAMB's first step is almost the sign of the
    gradient, so the updated parameters alone would not see a leaf's
    gradient off by a factor)."""
    from repro_torch.sharding import specs as S_
    from repro_torch.sharding.plan import plan_from_mesh, single_device_plan
    from repro_torch.train.step import _loss_backward
    file = params_file(jax_side.out, case)
    got = ranks.run(_grads_task, case, file, timeout_s=TIMEOUT_S)
    full = full_params(case, dict(np.load(file)))
    S_.map_tree(lambda _, p: p.requires_grad_(True), full)
    cfg = train_cfg(case)
    _loss_backward(full, {k: torch.from_numpy(v) for k, v in
                          train_batch(cfg).items()},
                   cfg, single_device_plan(), 1)
    grads = S_.map_tree(lambda _, p: p.grad, full)
    worst = 0.0
    for r, g in enumerate(got):
        mesh = _rank_mesh(r)
        want = port_flat(S_.shard_params(
            grads, S_.param_specs(grads, cfg, plan_from_mesh(mesh)), mesh))
        for k in want:
            scale = max(float(np.abs(want[k]).max()), 1e-30)
            err = float(np.abs(g[k] - want[k]).max()) / scale
            worst = max(worst, err)
    assert worst <= GRAD_REL, (case, worst)


def test_micro_batches_over_the_mesh_match_one_rank(ranks, jax_side):
    """Two micro-batches of 2 rows a dp rank; the one rank is fed the
    global batch reordered so that its two micro-batches of 4 rows hold
    the same rows (each dp rank's first two, then its last two)."""
    case = "smile-sort"
    file = params_file(jax_side.out, case)
    got = ranks.run(_train_task, case, file, 2, timeout_s=TIMEOUT_S)
    b = train_batch(train_cfg(case))
    order = [0, 1, 4, 5, 2, 3, 6, 7]
    m1, one = _one_rank(case, dict(np.load(file)),
                        {k: v[order] for k, v in b.items()}, micro=4)
    _check(got[0]["metrics"], m1["loss"], m1["grad_norm"],
           _max_param_err([g["params"] for g in got], one, case), ONE_RANK,
           "two micro-batches")


def test_evaluate_over_the_mesh_matches_one_rank(ranks, jax_side):
    from repro_torch.sharding.plan import single_device_plan
    from repro_torch.train.evaluate import evaluate
    case = "switch-sort"
    file = params_file(jax_side.out, case)
    got = ranks.run(_eval_task, case, file, timeout_s=TIMEOUT_S)
    one = evaluate(full_params(case, dict(np.load(file))), train_cfg(case),
                   single_device_plan(), batch=GB, seq=SEQ, n_batches=2)
    for ev in got:
        assert ev["eval_tokens"] == one["eval_tokens"]
        np.testing.assert_allclose(ev["eval_ce"], one["eval_ce"], rtol=1e-5)


def test_train_over_the_mesh_matches_one_rank(ranks):
    """``train(..., mesh=)`` on every rank (the config's bf16): the same
    weights and batches as one rank's ``train()``, 2 steps within
    ``_train_equiv.py``'s loss bound; the log entries carry the step's
    wire."""
    from repro_torch.launch.train import train
    hists = ranks.run(_train_loop_task, timeout_s=TIMEOUT_S)
    _, one = train("smile-3.7b", reduced=True, steps=2, batch=GB, seq=SEQ,
                   log_every=1, moe_options=OPTS, device="cpu")
    for h in hists:
        assert [e["step"] for e in h] == [1, 2]
        assert [e["loss"] for e in h] == [e["loss"] for e in hists[0]]
        for e, o in zip(h, one):
            assert abs(e["loss"] - o["loss"]) <= JAX_BOUNDS["loss"]
    assert any(k.startswith("psum.grad") for k in hists[0][-1]["wire"])


def test_cli_under_torchrun():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
           "--arch", "smile-3.7b", "--reduced", "--steps", "2", "--batch",
           "8", "--seq", "16", "--log-every", "1", "--mesh", "2,2",
           "--backend", "gloo", "--devices", "cpu", "--launcher", "env"]
    p = subprocess.run(cmd, env=env, capture_output=True, text=True,
                       timeout=TIMEOUT_S)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("step ")]
    assert len(lines) == 2, p.stdout         # rank 0 alone prints
    assert all("nan" not in ln for ln in lines)
