"""The expert-parallel wire on ``torch.distributed`` ranks against the JAX
package's ``shard_map`` on fake devices, on the CPU.

Eight gloo ranks (a module-wide :class:`RankPool`, rendezvous through a
``file://`` store under the test's tmp dir) hold a ``(data 4, model 2)``
mesh.  The JAX side runs once per module in a subprocess with 8 fake CPU
devices (``XLA_FLAGS=--xla_force_host_platform_device_count=8``) and the
native ragged All2All emulated (``REPRO_RAGGED_A2A_EMULATION=a2a``: XLA:CPU
lacks the op); it writes numpy arrays that the tests compare with the
ranks' results.  Both sides draw their inputs from numpy ``default_rng``
with the same seeds.  Device ``(d, m)`` of the JAX mesh holds block
``2 d + m`` of an input split over ``("data", "model")``, and so does rank
``2 d + m``.

* ``comm``'s collective forms against their ``lax`` counterparts over
  ``"data"``, ``"model"`` and ``("data", "model")``: floats within 1e-6
  of the largest value (the sum runs in another order), everything else
  bit for bit.
* The MoE layer on 8 ranks against ``tests/distributed/_moe_equiv.py``'s
  cases (both routers, sort and dropless, the ragged and the padded wire):
  the integer routing outputs and counts of every dispatch and ragged hop
  (group ids, positions, keep masks, segment starts, send and receive
  counts) bit for bit; outputs and the psum'd statistics within 1e-5 of
  their largest value (fp32, d = 32).
* The clamped receive bound, ``tests/distributed/_recv_bound.py``'s cases:
  one ragged hop with every token sent to rank 0 (the bounded slab, the
  kept counts echoed back, returned rows at their origin offsets), the
  layers under that skew with and without a clamping bound (drops
  accounted), and a bound too large to clamp, which must give the
  unbounded run's bits.
* The pure parts: group membership and order, the plan of a mesh, and the
  truncation plan of a ragged exchange, against the JAX package.

The served model over a mesh is in ``tests/test_torch_ep_serve.py``.
Nothing here runs a JAX function in this process but the pure ones.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import RankPool, coords_of, group_members
from repro_torch.sharding import comm

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
MESH = ((4, 2), ("data", "model"))
AXES = {"data": "data", "model": "model", "data+model": ("data", "model")}
WORLD = 8
FLOAT_REL = 1e-6           # a psum's order of summation
MOE_REL = 1e-5             # fp32 MoE outputs and statistics
D_MOE = 32
# tests/distributed/_moe_equiv.py's cases: (grid, E, k, g, backend)
MOE_CASES = [((4, 2), 8, 1, 1, "sort"), ((4, 4), 16, 2, 1, "sort"),
             ((4, 4), 8, 4, 2, "sort"), ((4, 8), 8, 2, 2, "sort"),
             ((8, 4), 32, 1, 1, "sort"),
             ((4, 4), 16, 2, 1, "dropless"), ((4, 4), 8, 4, 2, "dropless"),
             ((4, 2), 8, 1, 1, "dropless"), ((4, 8), 8, 2, 2, "dropless")]
TIMEOUT_S = 120


def _equiv_runs() -> dict:
    """name -> MoE run: each _moe_equiv.py case under both routers, the
    dropless ones on the ragged and on the padded wire; 64 tokens, d 32."""
    runs = {}
    for router in ("switch", "smile"):
        for grid, E, k, g, backend in MOE_CASES:
            for ragged in ((True, False) if backend == "dropless"
                           else (True,)):
                wire = ("" if backend == "sort"
                        else "-ragged" if ragged else "-padded")
                runs[f"{router}-{grid[0]}x{grid[1]}-E{E}-k{k}-g{g}-"
                     f"{backend}{wire}"] = dict(
                    kw=dict(num_experts=E, top_k=k, top_g=g, d_ff_expert=64,
                            capacity_factor=16.0, router=router, grid=grid,
                            renorm_gates=(k > 1), dispatch_backend=backend,
                            ragged_a2a=ragged),
                    d=D_MOE, tokens=64, skew=False, seed=len(runs))
    return runs


def _recv_bound_runs() -> dict:
    """name -> MoE run: _recv_bound.py's layers.  Under skew every token
    picks expert or node 0 (rank 0), unbounded and with a bound that
    clamps (a tighter factor on SMILE's 4-rank first hop, where the
    tile-aligned layout leaves more room); without skew, factor None
    (held to JAX) and factor P = 8 (held to the None run's bits)."""
    runs = {}
    for seed, (router, factor) in enumerate((("switch", 1.5),
                                             ("smile", 0.75)), 100):
        for f in (None, factor):
            runs[f"skew-{router}-bound{f}"] = dict(
                kw=dict(num_experts=16, top_k=1, top_g=1, d_ff_expert=32,
                        router=router, grid=(4, 2),
                        dispatch_backend="dropless", ragged_a2a=True,
                        recv_bound_factor=f),
                d=16, tokens=8 * 64, skew=True, seed=seed)
        runs[f"noclamp-{router}"] = dict(
            kw=dict(num_experts=16, top_k=2, top_g=2, d_ff_expert=32,
                    capacity_factor=8.0, router=router, grid=(4, 2),
                    renorm_gates=True, dispatch_backend="dropless",
                    ragged_a2a=True),
            d=16, tokens=8 * 32, skew=False, seed=seed + 10)
    return runs


MOE_RUNS = {**_equiv_runs(), **_recv_bound_runs()}


def moe_inputs(name: str):
    """Full parameters (both packages' layout) and the tokens of a run
    (a skewed layer's two runs draw the same)."""
    run = MOE_RUNS[name]
    kw, d = run["kw"], run["d"]
    rng = np.random.default_rng(run["seed"])
    n_g, E, f = kw["grid"][0], kw["num_experts"], kw["d_ff_expert"]

    def normal(shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    p = {"experts": {"w1": normal((n_g, E // n_g, d, f), d),
                     "w2": normal((n_g, E // n_g, f, d), f)}}
    router = "router_inter" if kw["router"] == "smile" else "router"
    if kw["router"] == "smile":
        p["router_inter"] = {"w": normal((d, n_g), d)}
        p["router_intra"] = {"w": normal((d, E // n_g), d)}
    else:
        p["router"] = {"w": normal((d, E), d)}
    x = rng.standard_normal((run["tokens"], d)).astype(np.float32)
    if run["skew"]:
        # all-positive tokens and a one-column router: every token picks
        # expert (or node) 0
        w = np.zeros_like(p[router]["w"])
        w[:, 0] = 8.0
        p[router]["w"] = w
        x = np.abs(x) + np.float32(0.1)
    return p, x


# _recv_bound.py's hop: 64 tokens a rank, 2 local groups a rank, every
# token to rank 0's groups, receive bound factor 1.5
SKEW_HOP = dict(nl=2, tokens=64, d=16, factor=1.5)


def skew_hop_rows(rank: int):
    rng = np.random.default_rng(99)
    x = rng.standard_normal((WORLD * SKEW_HOP["tokens"], SKEW_HOP["d"]))
    t = SKEW_HOP["tokens"]
    return x[rank * t:(rank + 1) * t].astype(np.float32)


def shard_intra(kw: dict) -> bool:
    """Whether the layout cuts the experts over the intra axis too."""
    n_g, m_g = kw["grid"]
    E = kw["num_experts"]
    return E % (n_g * m_g) == 0


def comm_inputs(name: str):
    """Every rank's inputs of the collective forms over axes ``name``:
    (WORLD, ...) arrays, block ``r`` for rank ``r``."""
    P = {"data": 4, "model": 2, "data+model": 8}[name]
    rng = np.random.default_rng(list(AXES).index(name))
    R = 16
    counts = np.stack([rng.multinomial(int(rng.integers(0, R + 1)),
                                       [1 / P] * P) for _ in range(WORLD)])
    return dict(
        x=rng.standard_normal((WORLD, 6, 5)).astype(np.float32),
        ints=rng.integers(-50, 50, (WORLD, 6)).astype(np.int32),
        a2a=rng.standard_normal((WORLD, P, 3, 5)).astype(np.float32),
        rows=rng.standard_normal((WORLD, R, 5)).astype(np.float32),
        counts=counts.astype(np.int32),
        uniform=np.full((WORLD, P), R // P, np.int32),
        tokens=rng.standard_normal((WORLD, 7, 5)).astype(np.float32))


# the receive bound of the truncating exchange: below most arrivals
TRUNC_ROWS = 11


def comm_outputs(C, x, ints, a2a, rows, counts, uniform, tokens, axes, P):
    """The forms under test, written once for both packages: ``C`` is the
    package's comm module, each argument this rank's block."""
    out = {}
    out["psum"] = C.psum(x, axes)
    out["pmax"] = C.pmax(x, axes)
    out["psum_int"] = C.psum(ints, axes)
    out["all_gather0"] = C.all_gather(x, axes, axis=0, tiled=True)
    out["all_gather1"] = C.all_gather(x, axes, axis=1, tiled=True)
    out["all_gather_stack"] = C.all_gather(ints, axes, axis=0, tiled=False)
    out["all_to_all"] = C.all_to_all(a2a, axes, split_axis=0, concat_axis=0)
    out["exchange_counts"] = C.exchange_counts(counts, axes)
    for tag, sc in (("uniform", uniform), ("ragged", counts)):
        recv, rc = C.ragged_all_to_all(rows, sc, axes,
                                       recv_rows=P * rows.shape[0])
        out[f"{tag}_recv"], out[f"{tag}_rc"] = recv, rc
        back, _ = C.ragged_all_to_all(recv, rc, axes,
                                      recv_rows=rows.shape[0],
                                      recv_counts=sc)
        out[f"{tag}_back"] = back
    recv, rc = C.ragged_all_to_all(rows, counts, axes, recv_rows=TRUNC_ROWS,
                                   allow_truncate=True)
    out["trunc_recv"], out["trunc_rc"] = recv, rc
    local, pad = C.split_tokens(tokens, axes, P)
    out["split"] = local
    out["unsplit"] = C.unsplit_tokens(local, axes, tokens.shape[0])
    return out


# =============================================================================
# The JAX side (run in a subprocess with 8 fake devices)
# =============================================================================

def _jax_main(out_dir: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as Pspec

    from repro.common.config import MoEConfig
    from repro.core import dispatch as JD
    from repro.core import pipeline as JPL
    from repro.core.moe import moe_layer
    from repro.sharding import comm as JC
    from repro.sharding.compat import make_mesh, shard_map
    from repro.sharding.plan import test_plan

    mesh = make_mesh(*MESH)
    flat = Pspec(("data", "model"))
    save = JaxSide.saver(out_dir)

    for name, axes in AXES.items():
        inp = comm_inputs(name)
        P = inp["a2a"].shape[1]
        keys = sorted(inp)

        def f(*blocks):
            loc = {k: b[0] for k, b in zip(keys, blocks)}
            o = comm_outputs(JC, axes=axes, P=P, **loc)
            o["axis_index"] = JC.axis_index(axes).reshape(1)
            return {k: v[None] for k, v in o.items()}

        fn = jax.jit(shard_map(f, mesh=mesh, in_specs=(flat,) * len(keys),
                               out_specs=flat))
        save(f"comm/{name}", fn(*(jnp.asarray(inp[k]) for k in keys)))

    plan = test_plan(n_inter=4, n_intra=2)
    for name, run in MOE_RUNS.items():
        kw = run["kw"]
        cfg = MoEConfig(**kw)
        params, x = moe_inputs(name)
        espec = Pspec("data", "model" if shard_intra(kw) else None, None,
                      None)
        pspecs = {k: ({"w1": espec, "w2": espec} if k == "experts"
                      else {"w": Pspec(None, None)}) for k in params}
        shapes = []

        def f(params, x):
            rec = []
            undo = record_hooks(JD, JPL, rec, lambda a: a.astype(jnp.int32)
                                .reshape(-1))
            try:
                y, st = moe_layer(params, x, cfg, plan, act="gelu")
            finally:
                undo()
            shapes[:] = [r.shape[0] for r in rec]
            stats = jnp.concatenate([st.lb_loss.reshape(1),
                                     st.z_loss.reshape(1),
                                     st.drop_frac.reshape(1),
                                     st.hop_drop_frac, st.fault_events])
            return y, stats, jnp.concatenate(rec)[None]

        fn = jax.jit(shard_map(
            f, mesh=mesh, in_specs=(pspecs, Pspec(("data", "model"), None)),
            out_specs=(Pspec(("data", "model"), None), Pspec(),
                       Pspec(("data", "model"), None))))
        y, stats, rec = fn(jax.tree.map(jnp.asarray, params), jnp.asarray(x))
        save(f"moe/{name}", {"y": y, "stats": stats, "rec": rec,
                             "rec_lens": np.asarray(shapes, np.int64)})

    nl, t = SKEW_HOP["nl"], SKEW_HOP["tokens"]
    V = WORLD * nl

    def hop(xx):
        gid = jnp.arange(t, dtype=jnp.int32) % nl
        rows, starts, st = JD.dispatch_ragged(xx, gid, jnp.ones((t,)), V,
                                              k=1)
        seg_lens = JD.ragged_seg_lens(gid, st.keep, V)
        spec = JPL.HopSpec(name="t", axes=plan.ep_axes, n_ranks=WORLD,
                           num_groups=V, exchange="ragged",
                           recv_bound_factor=SKEW_HOP["factor"])
        hs, ev, _ = JPL._ragged_forward(rows, starts, seg_lens, spec, st.cap)
        back, ok, _ = JPL._ragged_reverse(hs.recv * 2.0, hs, spec)
        return {"back": back, "ok": ok, "kept": hs.kept,
                "rc": hs.recv_counts, "recv": hs.recv, "ev": ev.reshape(1),
                "slab": jnp.int32(hs.recv.shape[0]).reshape(1)}

    fn = jax.jit(shard_map(lambda xx: {k: v[None] for k, v in
                                       hop(xx).items()},
                           mesh=mesh, in_specs=flat, out_specs=flat))
    xs = np.concatenate([skew_hop_rows(r) for r in range(WORLD)])
    save("skew_hop", fn(jnp.asarray(xs)))


def record_hooks(D, PL, rec: list, as_int):
    """Wrap one package's ``dispatch``, ``dispatch_ragged`` and
    ``_ragged_forward`` so that each call appends its integer outputs to
    ``rec``, in call order: the dispatched group ids, positions and keep
    mask (sort) or segment starts (dropless), and a ragged hop's send and
    receive counts.  Returns a function that undoes the wrapping."""
    orig = (D.dispatch, D.dispatch_ragged, PL._ragged_forward)

    def dispatch(x, gid, *a, **kw):
        buf, st = orig[0](x, gid, *a, **kw)
        rec.extend([as_int(gid), as_int(st.pos), as_int(st.keep)])
        return buf, st

    def dispatch_ragged(x, gid, *a, **kw):
        rows, starts, st = orig[1](x, gid, *a, **kw)
        rec.extend([as_int(gid), as_int(st.pos), as_int(starts)])
        return rows, starts, st

    def ragged_forward(*a, **kw):
        out = orig[2](*a, **kw)
        hs = out[0]
        rec.extend([as_int(hs.send_counts), as_int(hs.recv_counts)]
                   + ([] if hs.kept is None else [as_int(hs.kept)]))
        return out

    D.dispatch, D.dispatch_ragged = dispatch, dispatch_ragged
    PL._ragged_forward = ragged_forward

    def undo():
        D.dispatch, D.dispatch_ragged, PL._ragged_forward = orig
    return undo


class JaxSide:
    """A test module's JAX subprocess: started at once, with 8 fake CPU
    devices and the ragged All2All emulated; it runs the module's
    ``_jax_main(out_dir)``, which saves each section of results as soon as
    it has it, so a test waits only for its own section."""

    def __init__(self, module: str, out: Path):
        env = dict(os.environ,
                   XLA_FLAGS="--xla_force_host_platform_device_count=8",
                   REPRO_RAGGED_A2A_EMULATION="a2a", JAX_PLATFORMS="cpu")
        code = (f"import sys; sys.path[:0] = [{str(HERE)!r}, {str(SRC)!r}]; "
                f"import {module} as m; m._jax_main({str(out)!r})")
        self.out = out
        self.err = out / "stderr.txt"
        with open(self.err, "w") as err:
            self.proc = subprocess.Popen([sys.executable, "-c", code],
                                         env=env, stdout=subprocess.DEVNULL,
                                         stderr=err)

    @staticmethod
    def _file(out_dir, section: str) -> Path:
        return Path(out_dir) / (section.replace("/", "~") + ".npz")

    @staticmethod
    def saver(out_dir):
        """``save(section, {name: array})``, written whole or not at all."""
        def save(section, arrays):
            path = JaxSide._file(out_dir, section)
            tmp = path.with_suffix(".part.npz")
            np.savez(tmp, **{k: np.asarray(v) for k, v in arrays.items()})
            os.replace(tmp, path)
        return save

    def get(self, section: str, timeout_s: float = 300.0) -> dict:
        path = self._file(self.out, section)
        deadline = time.monotonic() + timeout_s
        while not path.exists():
            if self.proc.poll() is not None and not path.exists():
                raise AssertionError(
                    f"the JAX side exited ({self.proc.returncode}) without "
                    f"{section}:\n{self.err.read_text()[-4000:]}")
            if time.monotonic() > deadline:
                raise AssertionError(f"the JAX side gave no {section} in "
                                     f"{timeout_s} s")
            time.sleep(0.1)
        return dict(np.load(path))

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    js = JaxSide("test_torch_mesh", tmp_path_factory.mktemp("jax"))
    yield js
    js.close()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_side):
    rdzv = tmp_path_factory.mktemp("rdzv") / "store"
    with RankPool(WORLD, backend="gloo", devices=["cpu"] * WORLD, threads=1,
                  timeout_s=TIMEOUT_S, init_method=f"file://{rdzv}") as pool:
        pool.run(_make_mesh)
        yield pool


# =============================================================================
# The torch side (tasks run on every rank)
# =============================================================================

def _make_mesh(rank):
    from repro_torch.launch.mesh import make_mesh
    make_mesh(*MESH, device=rank.device)


def _comm_task(rank, name):
    inp = comm_inputs(name)
    P = inp["a2a"].shape[1]
    loc = {k: torch.from_numpy(v[rank.rank]) for k, v in inp.items()}
    out = comm_outputs(comm, axes=AXES[name], P=P, **loc)
    out["axis_index"] = torch.tensor([comm.axis_index(AXES[name])])
    return {k: v.numpy() for k, v in out.items()}


def _moe_task(rank, name, options=None):
    """The layer on this rank's tokens; ``options`` replace config fields
    (the no-clamp runs' second bound)."""
    import dataclasses

    from repro_torch.common.config import MoEConfig
    from repro_torch.core import dispatch as D
    from repro_torch.core import pipeline as PL
    from repro_torch.core.moe import moe_layer
    from repro_torch.sharding.plan import test_plan
    from repro_torch.sharding.specs import shard_leaf
    kw = MOE_RUNS[name]["kw"]
    cfg = dataclasses.replace(MoEConfig(**kw), **(options or {}))
    params, x = moe_inputs(name)
    mesh = comm.bound_mesh()
    espec = ("data", "model" if shard_intra(kw) else None, None, None)
    tp = {k: {n: shard_leaf(torch.from_numpy(v), espec if k == "experts"
                            else (None, None), mesh)
              for n, v in d.items()} for k, d in params.items()}
    n = x.shape[0] // WORLD
    xl = torch.from_numpy(x[rank.rank * n:(rank.rank + 1) * n])
    rec = []
    undo = record_hooks(D, PL, rec, lambda t: t.to(torch.int32).reshape(-1))
    try:
        with torch.inference_mode():
            y, st = moe_layer(tp, xl, cfg, test_plan(4, 2), act="gelu")
    finally:
        undo()
    stats = torch.cat([st.lb_loss.reshape(1), st.z_loss.reshape(1),
                       st.drop_frac.reshape(1), st.hop_drop_frac,
                       st.fault_events])
    return y.numpy(), stats.numpy(), [r.numpy() for r in rec]


def _skew_hop_task(rank):
    from repro_torch.core import dispatch as D
    from repro_torch.core import pipeline as PL
    from repro_torch.sharding.plan import test_plan
    nl, t = SKEW_HOP["nl"], SKEW_HOP["tokens"]
    V = WORLD * nl
    xx = torch.from_numpy(skew_hop_rows(rank.rank))
    gid = torch.arange(t, dtype=torch.int32) % nl
    with torch.inference_mode():
        rows, starts, st = D.dispatch_ragged(xx, gid, torch.ones((t,)), V,
                                             k=1)
        seg_lens = D.ragged_seg_lens(gid, st.keep, V)
        spec = PL.HopSpec(name="t", axes=test_plan(4, 2).ep_axes,
                          n_ranks=WORLD, num_groups=V, exchange="ragged",
                          recv_bound_factor=SKEW_HOP["factor"])
        hs, ev, _ = PL._ragged_forward(rows, starts, seg_lens, spec, st.cap)
        back, ok, _ = PL._ragged_reverse(hs.recv * 2.0, hs, spec)
    return {"back": back.numpy(), "ok": ok.numpy(), "kept": hs.kept.numpy(),
            "rc": hs.recv_counts.numpy(), "recv": hs.recv.numpy(),
            "ev": ev.reshape(1).numpy(),
            "slab": np.asarray([hs.recv.shape[0]], np.int32),
            "rows": rows.numpy()}


def _fail_on_rank_one(rank):
    if rank.rank == 1:
        raise ValueError("rank one fails")
    import torch.distributed as dist
    dist.barrier()


# =============================================================================
# Tests
# =============================================================================

def _close(got, want, rel, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.floating):
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got.astype(np.float64) - want).max()) / scale
        assert err <= rel, f"{what}: {err:.3e} of max |ref| > {rel}"
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("name", list(AXES))
def test_comm_forms_match_lax(name, ranks, jax_side):
    got = ranks.run(_comm_task, name, timeout_s=TIMEOUT_S)
    ref = jax_side.get(f"comm/{name}")
    for k in got[0]:
        _close(np.stack([g[k] for g in got]), ref[k], FLOAT_REL,
               f"{name} {k}")
    # the truncating exchange really truncated somewhere
    assert (ref["trunc_rc"].sum(1) > TRUNC_ROWS).any()


def _check_moe(got, jax_side, name):
    ref = jax_side.get(f"moe/{name}")
    lens = ref["rec_lens"]
    for r, (y, stats, rec) in enumerate(got):
        assert [len(a) for a in rec] == list(lens), (r, name)
        want = np.split(ref["rec"][r], np.cumsum(lens)[:-1])
        for i, (a, b) in enumerate(zip(rec, want)):
            np.testing.assert_array_equal(a, b, err_msg=f"{name} rank {r} "
                                          f"record {i}")
        _close(stats, ref["stats"], MOE_REL, f"{name} stats")
    _close(np.concatenate([g[0] for g in got]), ref["y"],
           MOE_REL, f"{name} y")


@pytest.mark.parametrize("name", list(_equiv_runs()))
def test_moe_layer_matches_shard_map(name, ranks, jax_side):
    got = ranks.run(_moe_task, name, timeout_s=TIMEOUT_S)
    _check_moe(got, jax_side, name)
    if "dropless" in name:
        assert all(g[1][2] == 0.0 for g in got)       # nothing can drop


@pytest.mark.parametrize("router", ["switch", "smile"])
def test_recv_bound_layer_under_skew(router, ranks, jax_side):
    out = {}
    for name in (n for n in MOE_RUNS if n.startswith(f"skew-{router}-")):
        out[name] = got = ranks.run(_moe_task, name, timeout_s=TIMEOUT_S)
        _check_moe(got, jax_side, name)
    (u_name, u), (b_name, b) = out.items()
    assert u[0][1][2] == 0.0 and b[0][1][2] > 0.0, (u[0][1], b[0][1])
    # every row is clamp-dropped (zeros) or the unbounded run's row
    yu = np.concatenate([g[0] for g in u])
    yb = np.concatenate([g[0] for g in b])
    zero = ~np.abs(yb).sum(-1).astype(bool)
    assert zero.any() and np.abs(yu[zero]).sum() > 0
    np.testing.assert_allclose(yb[~zero], yu[~zero], rtol=1e-5, atol=1e-6)
    if router == "switch":                     # one hop, k = 1
        assert np.isclose(b[0][1][2], zero.mean())


@pytest.mark.parametrize("router", ["switch", "smile"])
def test_recv_bound_that_cannot_clamp_is_the_unbounded_path(router, ranks,
                                                            jax_side):
    name = f"noclamp-{router}"
    got = ranks.run(_moe_task, name, timeout_s=TIMEOUT_S)
    _check_moe(got, jax_side, name)
    bound = ranks.run(_moe_task, name, {"recv_bound_factor": float(WORLD)},
                      timeout_s=TIMEOUT_S)
    for (y, stats, rec), (yb, sb, rb) in zip(got, bound):
        np.testing.assert_array_equal(yb, y)
        np.testing.assert_array_equal(sb, stats)
        assert stats[2] == 0.0


def test_recv_bound_hop_under_skew(ranks, jax_side):
    got = ranks.run(_skew_hop_task, timeout_s=TIMEOUT_S)
    ref = jax_side.get("skew_hop")
    for k in ("back", "ok", "kept", "rc", "recv", "ev", "slab"):
        _close(np.stack([g[k] for g in got]), ref[k], 0.0, k)
    B, R = int(got[0]["slab"][0]), got[0]["rows"].shape[0]
    assert B < WORLD * R                     # the slab is bounded
    kept = np.stack([g["kept"] for g in got])
    assert kept[0].sum() == B and kept[1:].sum() == 0
    for q, g in enumerate(got):
        # what returns to q from rank 0 is what rank 0 kept of q's rows
        assert g["ok"].sum() == kept[0][q]
        np.testing.assert_array_equal(g["back"][g["ok"]],
                                      2.0 * g["rows"][g["ok"]])
        assert not g["back"][~g["ok"]].any()


def test_a_failing_rank_fails_the_run(tmp_path):
    with RankPool(2, backend="gloo", devices=["cpu", "cpu"], threads=1,
                  timeout_s=60,
                  init_method=f"file://{tmp_path / 'store'}") as pool:
        with pytest.raises(RuntimeError, match="rank one fails"):
            pool.run(_fail_on_rank_one)


def test_backend_and_devices_are_checked():
    from repro_torch.launch.mesh import check_devices
    with pytest.raises(ValueError, match="one card a rank"):
        check_devices("nccl", ["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="cuda:N"):
        check_devices("nccl", ["cpu", "cpu"])
    with pytest.raises(ValueError, match="unknown backend"):
        check_devices("mpi", ["cpu"])
    with pytest.raises(ValueError, match="2 ranks need 2 devices"):
        RankPool(2, backend="gloo", devices=["cpu"])


def test_group_order_is_jax_order():
    ranks_of = np.arange(8).reshape(4, 2)        # jax.make_mesh's grid
    assert coords_of(5, (4, 2)) == (2, 1)
    assert group_members((4, 2), (0,)) == [list(ranks_of[:, m])
                                           for m in range(2)]
    assert group_members((4, 2), (1,)) == [list(ranks_of[d])
                                           for d in range(4)]
    assert group_members((4, 2), (0, 1)) == [list(range(8))]
    assert group_members((2, 2, 2), (0, 2)) == [[0, 1, 4, 5], [2, 3, 6, 7]]


def test_plan_from_mesh_matches_jax():
    from types import SimpleNamespace

    from repro.sharding import plan as JP
    from repro_torch.sharding import plan as TP
    for shape, axes in (((2, 2), ("data", "model")),
                        ((2, 4, 2), ("pod", "data", "model"))):
        jmesh = SimpleNamespace(axis_names=axes,
                                shape=dict(zip(axes, shape)))
        tmesh = SimpleNamespace(axes=axes, shape=shape)
        for inter in (None, ("pod", "data")):
            j = JP.plan_from_mesh(jmesh, smile_inter_axes=inter)
            t = TP.plan_from_mesh(tmesh, smile_inter_axes=inter)
            assert vars(t) == vars(j)
    assert vars(TP.test_plan(2, 4, pod=2)) == vars(JP.test_plan(2, 4, pod=2))


@pytest.mark.parametrize("recv_rows", [0, 5, 17, 40])
def test_truncation_plan_matches_jax(recv_rows):
    import jax.numpy as jnp

    from repro.sharding import comm as JC
    m = np.random.default_rng(recv_rows).integers(0, 9, (4, 4)).astype(
        np.int32)
    for me in range(4):
        want = JC.native_truncation_plan(jnp.asarray(m), me, recv_rows)
        got = comm.native_truncation_plan(torch.from_numpy(m), me, recv_rows)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
