"""The collectives of the mesh paths, per step, against the JAX program's,
on a ``(data 2, model 2)`` mesh of gloo ranks on the CPU.

The JAX side runs once in a subprocess (``tests/test_torch_mesh.py``'s
``JaxSide``: 8 fake CPU devices, 4 of them in the mesh, the ragged All2All
emulated), its ``embed_inputs`` pinned to fp32 so that both packages run
the same fp32 programs.  The port's side is what ``sharding.comm``'s trace
records on each of 4 ranks, classed and sized by
``launch.cost_analysis.collective_costs`` (a psum or pmax is an
all-reduce; a call's bytes are its output buffer's, ``analyze_hlo``'s
convention).

* The fixed-batch serve (``serve.decode.prefill_fn`` / ``decode_step_fn``,
  reduced qwen3-moe, sort and dropless) against ``analyze_hlo`` of the
  compiled ``build_prefill`` / ``build_decode_step`` (its loop trip
  counts applied): 5 all-reduces, 2 all-gathers, 10 (sort) or 12
  (dropless) all-to-alls a step, the all-reduce and all-gather bytes
  equal, and the sort path's all-to-all bytes too (the dropless hops'
  ragged segments are exact rows in the port and padded blocks in the JAX
  package's emulation).  No statistics collective runs: ``jit`` drops
  them there, the port does not compute them.
* The engine's paged prefill chunk and decode step against the JAX
  engine's step functions with the statistics cut to the four fields its
  ``_record_stats`` reads (the jitted step returns the whole ``MoEStats``,
  whose ``P`` and z-loss psums no reader uses; XLA:CPU's combiner then
  packs the statistic psums into tuple all-reduces, which the port does
  not do), counted in the lowered program (:func:`lowered_collectives`):
  per hop the token count and the top-1 fractions, the drop counts of a
  padded hop, the fault vector once a layer.
* A training step of reduced smile-3.7b (one dense and one MoE block):
  remat on minus remat off, by class, against the lowered JAX step's
  difference: +6 all-reduces (both blocks' attention psum, each hop's
  count and fractions) and +5 all-to-alls; under
  ``remat_save_collectives`` +4 and +5 (the attention psums saved), the
  bytes equal too.
* Bit-equality: each serve and engine step's tokens and logits (and the
  engine's four telemetry numbers) against the same call with every
  statistic computed; the step's loss, gradient norm, updated parameters
  and every leaf's synced gradient with the flag on against off, and the
  flag's step against JAX's with the flag on (``test_torch_ep_train.py``'s
  bounds, ``GRAD_REL`` on the gradient norm).
"""
import copy
import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import RankPool
from repro_torch.sharding import comm
from test_torch_ep_serve import flat, jax_tree, serve_cfg, unflat
from test_torch_ep_train import (GRAD_REL, HORIZON, JAX_BOUNDS, _check,
                                 _max_param_err, _rank_params, _tcfg,
                                 full_params, port_flat, train_batch,
                                 train_cfg)
from test_torch_mesh import JaxSide

MESH = ((2, 2), ("data", "model"))
WORLD = 4
TIMEOUT_S = 180
B, T = 4, 16                    # the fixed batch: prompts of T tokens
SLOTS, PAGE, POOL, BUCKET, CHUNK = 2, 4, 16, 16, 5
MAX_PAGES = 8
TRAIN_CASE = "smile-sort"
TRAIN_VARIANTS = {"off": dict(remat=False), "on": dict(remat=True),
                  "rsc": dict(remat=True, remat_save_collectives=True)}
CLASSES = ("all-reduce", "all-gather", "all-to-all")
SERVE_WANT = {"sort": 10, "dropless": 12}     # all-to-alls a serve step


def prompts() -> np.ndarray:
    return np.random.default_rng(7).integers(8, 512, (B, T)).astype(np.int32)


def params_file(out_dir) -> Path:
    return Path(out_dir) / "params-train.npz"


# =============================================================================
# Counting a lowered JAX program
# =============================================================================

_OP = re.compile(r"^(?:ROOT )?[\w.\-]+ = (.*?) ([a-z][\w\-]*)\((.*)$")


def lowered_collectives(text: str) -> dict:
    """``{class: [calls, bytes]}`` of a lowered (pre-optimization) HLO
    module's text, ``lowered.as_text(dialect="hlo")``: every collective
    from the entry computation down, a ``while`` body times its trip count
    (the largest integer constant of its condition, as ``analyze_hlo``
    reads it), bytes the output shape's.  Before XLA's passes each psum
    is one all-reduce: what the program issues."""
    from repro.launch.hlo_analysis import _shape_bytes
    comps, cur, entry = {}, None, None
    for raw in text.splitlines():
        line = raw.strip()
        if (line.endswith("{") and " = " not in line
                and not line.startswith("HloModule")):
            head = line.split()
            name = head[1] if head[0] == "ENTRY" else head[0]
            entry = name if head[0] == "ENTRY" else entry
            cur = comps[name] = {"colls": [], "subs": [], "lines": []}
            continue
        if line == "}" or cur is None:
            cur = None
            continue
        cur["lines"].append(line)
        m = _OP.match(line)
        if not m:
            continue
        shape, op, rest = m.groups()
        if op in CLASSES or op == "reduce-scatter":
            cur["colls"].append((op, _shape_bytes(shape)))
        if op == "while":
            cur["subs"].append((re.search(r"body=([\w.\-]+)", rest).group(1),
                                re.search(r"condition=([\w.\-]+)",
                                          rest).group(1)))
        else:
            for sub in re.findall(r"(?:to_apply|calls)=([\w.\-]+)", rest):
                cur["subs"].append((sub, None))
            for grp in re.findall(r"branch_computations=\{([^}]*)\}", rest):
                cur["subs"] += [(b.strip(), None) for b in grp.split(",")]

    def trips(cond):
        return max([int(x) for line in comps[cond]["lines"]
                    for x in re.findall(r"constant\((\d+)\)", line)] or [1])

    out: dict = {}

    def walk(name, mult):
        for op, nbytes in comps[name]["colls"]:
            acc = out.setdefault(op, [0.0, 0.0])
            acc[0] += mult
            acc[1] += mult * nbytes
        for sub, cond in comps[name]["subs"]:
            if sub in comps:
                walk(sub, mult * (trips(cond) if cond else 1))

    walk(entry, 1)
    return out


def compiled_collectives(compiled_text: str) -> dict:
    """``{class: [calls, bytes]}`` of ``analyze_hlo`` over a compiled
    program (4 devices), its loop trip counts applied."""
    from repro.launch.hlo_analysis import analyze_hlo
    out: dict = {}
    for c in analyze_hlo(compiled_text, 4, False).collectives:
        acc = out.setdefault(c["op"], [0.0, 0.0])
        acc[0] += c.get("count", 1.0)
        acc[1] += c.get("count", 1.0) * c["bytes"]
    return out


def as_arrays(counts: dict) -> dict:
    return {k: np.asarray(v, np.float64) for k, v in counts.items()}


# =============================================================================
# The JAX side (a subprocess with 8 fake devices)
# =============================================================================

def _engine_reads(fn):
    """A JAX engine step function whose statistics are the four fields
    ``Engine._record_stats`` reads."""
    def f(*a, **k):
        out = fn(*a, **k)
        s = out[-2]
        return out[:-2] + ((s.drop_frac, s.hop_max_load, s.hop_load_entropy,
                            s.fault_events), out[-1])
    return f


def _jax_main(out_dir: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as Pspec

    from repro.common.config import InputShape, TrainConfig
    from repro.kernels import ops as jops
    from repro.launch import inputs as JI
    from repro.models import transformer as JT
    from repro.optim import make_optimizer, make_schedule
    from repro.serve import decode as JDEC
    from repro.serve import engine as JE
    from repro.serve import kvcache as JKV
    from repro.sharding.compat import make_mesh
    from repro.sharding.plan import test_plan
    from repro.sharding.specs import cache_specs
    from repro.train.step import build_train_step

    save = JaxSide.saver(out_dir)
    jops.RADIX_MIN_ROWS = 1 << 30
    jops.ROUTER_FUSED_MIN_ROWS = 1 << 30
    JT.embed_inputs = functools.partial(JT.embed_inputs, dtype=jnp.float32)
    mesh = make_mesh(*MESH)
    plan = test_plan(2, 2)

    for backend in SERVE_WANT:
        cfg = serve_cfg(backend, "jax")
        ps, _ = JI.params_struct(cfg, plan, mesh)
        ts, _ = JI.prefill_batch_struct(cfg, InputShape("p", T, B, "prefill"),
                                        plan, mesh)
        csh = jax.eval_shape(lambda: JT.init_caches(cfg, B, T, plan))
        cs = JI._sds(csh, cache_specs(csh, cfg, plan, B), mesh)
        fn = JDEC.build_prefill(cfg, plan, ps, ts, cs, mesh=mesh)
        save(f"serve/{backend}/prefill", as_arrays(compiled_collectives(
            fn.lower(ps, ts, cs).compile().as_text())))
        (tst, cst, sst), _ = JI.decode_state_struct(
            cfg, InputShape("d", T, B, "decode"), plan, mesh)
        fn = JDEC.build_decode_step(cfg, plan, ps, tst, cst, mesh=mesh)
        save(f"serve/{backend}/decode", as_arrays(compiled_collectives(
            fn.lower(ps, tst, cst, sst).compile().as_text())))

    JE.paged_decode_step_fn = _engine_reads(JE.paged_decode_step_fn)
    JE.paged_prefill_fn = _engine_reads(JE.paged_prefill_fn)
    JE._stats_specs = lambda: (Pspec(),) * 4
    i32 = jnp.int32
    for backend in SERVE_WANT:
        cfg = serve_cfg(backend, "jax")
        ps, _ = JI.params_struct(cfg, plan, mesh)
        caches = JKV.init_paged_caches(cfg, POOL, PAGE, plan)
        fn = JE.build_paged_decode_step(cfg, plan, ps, caches, mesh)
        lo = fn.lower(ps, jnp.zeros((SLOTS,), i32), caches,
                      jnp.zeros((SLOTS, MAX_PAGES), i32),
                      jnp.zeros((SLOTS,), i32), jnp.ones((SLOTS,), bool))
        save(f"engine/{backend}/decode",
             as_arrays(lowered_collectives(lo.as_text(dialect="hlo"))))
        fn = JE.build_paged_prefill(cfg, plan, ps, caches, mesh)
        lo = fn.lower(ps, jnp.zeros((1, BUCKET), i32), caches,
                      jnp.zeros((1, MAX_PAGES), i32), i32(0), i32(CHUNK))
        save(f"engine/{backend}/prefill",
             as_arrays(lowered_collectives(lo.as_text(dialect="hlo"))))

    params = jax.tree.map(jnp.asarray,
                          unflat(dict(np.load(params_file(out_dir)))))
    batch = {k: jnp.asarray(v) for k, v in
             train_batch(train_cfg(TRAIN_CASE, "jax")).items()}
    opt = make_optimizer("lamb")
    tc = _tcfg()
    tcfg = TrainConfig(global_batch_size=tc.global_batch_size,
                       seq_len=tc.seq_len, lr=tc.lr,
                       warmup_steps=tc.warmup_steps, grad_clip=tc.grad_clip)
    sched = make_schedule("cosine", tc.lr, tc.warmup_steps, HORIZON)
    for name, kw in TRAIN_VARIANTS.items():
        cfg = train_cfg(TRAIN_CASE, "jax").replace(**kw)
        step, _ = build_train_step(cfg, tcfg, plan, opt, sched, params,
                                   batch, mesh=mesh)
        state = opt.init(params)
        save(f"train/{name}", as_arrays(lowered_collectives(
            step.lower(params, state, batch, jnp.int32(1)).as_text(
                dialect="hlo"))))
    # the flag's step run (it donates the parameters: the last use)
    p, _, m = step(params, opt.init(params), batch, jnp.int32(1))
    out = {f"p/{k}": v for k, v in flat(jax.tree.map(np.asarray,
                                                     p)).items()}
    out.update(loss=m["loss"], grad_norm=m["grad_norm"])
    save("train/step_rsc", out)


# =============================================================================
# Fixtures and rank tasks
# =============================================================================

@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax")
    np.savez(params_file(out), **flat(jax_tree(train_cfg(TRAIN_CASE))))
    js = JaxSide("test_torch_collective_parity", out)
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


def _traced(fn, *args, **kw):
    """``fn(*args, **kw)`` and this rank's collectives in it,
    ``{class: [calls, bytes]}``."""
    from repro_torch.launch import cost_analysis as CA
    log = comm.TraceLog()
    with comm.tracing(log):
        out = fn(*args, **kw)
    mesh = comm.bound_mesh()
    return out, port_counts(CA.collective_costs(log.calls, mesh.shape,
                                                mesh.axes, mesh.rank))


def port_counts(costs) -> dict:
    """``{class: [calls, bytes]}`` of the port's collective costs."""
    from repro_torch.launch import cost_analysis as CA
    s = CA.collective_summary(costs)
    return {c: [s["calls_per_op"][c], s["bytes_per_op"][c]]
            for c in CA.CLASSES if s["calls_per_op"][c]}


def _serve_task(rank, backend):
    """Prefill and one decode step of the fixed-batch serve: each step's
    collectives, and whether its tokens and logits are the bits of the
    same forward with every statistic computed."""
    from repro_torch.core.pipeline import ALL_STATS
    from repro_torch.models import transformer as TR
    from repro_torch.serve.decode import (decode_step_fn, greedy_sample,
                                          prefill_fn)
    from repro_torch.sharding import specs as S_
    from repro_torch.sharding.plan import plan_from_mesh
    mesh = comm.bound_mesh()
    plan = plan_from_mesh(mesh)
    cfg = serve_cfg(backend)
    params = TR.init_model(cfg, plan, seed=0, device="cpu", mesh=mesh)
    toks = S_.shard_params(torch.from_numpy(prompts()),
                           S_.batch_specs(torch.zeros(B, T), plan), mesh)
    caches = TR.init_caches(cfg, toks.shape[0], T + 4, plan, device="cpu")
    every = copy.deepcopy(caches)

    def all_stats(tok, pos):
        nonlocal every
        _, lg, _, every = TR.forward(params, tok, cfg, plan, positions=pos,
                                    caches=every, use_kernel=True,
                                    read_stats=ALL_STATS)
        return greedy_sample(lg[:, -1], plan), lg[:, -1]

    out, same = {}, []
    with torch.no_grad():
        (nxt, caches, last), out["prefill"] = _traced(
            prefill_fn, params, toks, caches, cfg=cfg, plan=plan)
        ref = all_stats(toks, torch.arange(T, dtype=torch.int32))
        same.append(torch.equal(nxt, ref[0]) and torch.equal(last, ref[1]))
        (nxt2, caches, last), out["decode"] = _traced(
            decode_step_fn, params, nxt, caches, T, cfg=cfg, plan=plan)
        ref = all_stats(nxt[:, None], torch.full((1,), T, dtype=torch.int32))
        same.append(torch.equal(nxt2, ref[0]) and torch.equal(last, ref[1]))
    out["same"] = same
    return out


def _engine_task(rank, backend):
    """The engine's paged prefill chunk and decode step: their collectives,
    and whether tokens, logits and the four telemetry numbers are the bits
    of the same steps with every statistic computed."""
    from repro_torch.core.pipeline import ALL_STATS
    from repro_torch.models import transformer as TR
    from repro_torch.serve import engine as E
    from repro_torch.serve import kvcache as KV
    from repro_torch.sharding.plan import plan_from_mesh
    mesh = comm.bound_mesh()
    plan = plan_from_mesh(mesh)
    cfg = serve_cfg(backend)
    params = TR.init_model(cfg, plan, seed=0, device="cpu", mesh=mesh)
    rng = np.random.default_rng(3)
    toks = torch.zeros((1, BUCKET), dtype=torch.int32)
    toks[0, :CHUNK] = torch.from_numpy(rng.integers(8, 512, CHUNK))
    table = torch.arange(SLOTS * MAX_PAGES, dtype=torch.int32).reshape(
        SLOTS, MAX_PAGES) % POOL
    i32 = functools.partial(torch.tensor, dtype=torch.int32)
    tok = torch.from_numpy(rng.integers(8, 512, SLOTS).astype(np.int32))
    live = torch.tensor([True, False])

    def steps():
        """The prefill chunk (``paged_prefill_fn``'s body, which keeps
        the logits) and a decode step on a fresh pool."""
        caches = KV.init_paged_caches(cfg, POOL, PAGE, plan, device="cpu",
                                      mesh=mesh)
        (nxt, lg, st, caches), pre = _traced(
            E._prefill, params, toks, caches, table[:1], i32(0), i32(CHUNK),
            cfg=cfg, plan=plan)
        (dn, dl, ds, _), dec = _traced(
            E.paged_decode_step_fn, params, tok, caches, table,
            i32([CHUNK, 0]), live, cfg=cfg, plan=plan)
        return ([nxt, lg, E._pack(nxt.reshape(1), st), dn, dl,
                 E._pack(dn, ds)], pre, dec)

    with torch.no_grad():
        got, pre, dec = steps()
        read = E.ENGINE_STATS
        E.ENGINE_STATS = ALL_STATS
        try:
            want, _, _ = steps()
        finally:
            E.ENGINE_STATS = read
    return {"prefill": pre, "decode": dec,
            "same": [torch.equal(a, b) for a, b in zip(got, want)]}


def _train_setup(variant, file):
    """The rank's slice of the JAX side's parameters and a LAMB step of
    reduced smile-3.7b under ``variant``."""
    from repro_torch.optim import make_optimizer, make_schedule
    from repro_torch.train.step import build_train_step
    params, _, plan, mesh = _rank_params(TRAIN_CASE, file)
    cfg = train_cfg(TRAIN_CASE).replace(**TRAIN_VARIANTS[variant])
    opt = make_optimizer("lamb")
    step = build_train_step(cfg, _tcfg(), plan, opt,
                            make_schedule("cosine", _tcfg().lr,
                                          _tcfg().warmup_steps, HORIZON),
                            params, train_batch(cfg), mesh=mesh)
    return params, cfg, plan, mesh, opt, step


def _train_task(rank, variant, file):
    """One LAMB step of reduced smile-3.7b under ``variant``: its
    collectives, metrics and updated parameters."""
    params, cfg, _, _, opt, step = _train_setup(variant, file)
    (_, _, m), counts = _traced(step, params, opt.init(params),
                                train_batch(cfg), 1)
    return {"counts": counts, "params": port_flat(params),
            "metrics": {k: float(v) for k, v in m.items()}}


def _grads_task(rank, variant, file):
    """Each leaf's gradient of the step's loss under ``variant``, synced
    over the axes it is replicated on (``test_torch_ep_train``'s)."""
    from repro_torch.optim import leaf_groups
    from repro_torch.optim.optimizers import group_axes
    from repro_torch.sharding import specs as S_
    from repro_torch.train.step import _loss_backward, sync_grads
    params, cfg, plan, mesh, _, _ = _train_setup(variant, file)
    groups = leaf_groups(params)
    for g in groups:
        for p in g.pieces:
            p.requires_grad_(True)
    batch = train_batch(cfg)
    _loss_backward(params, S_.shard_params(
        {k: torch.from_numpy(v) for k, v in batch.items()},
        S_.batch_specs(batch, plan), mesh), cfg, plan, 1)
    sync_grads(groups, group_axes(groups, S_.shard_axes(
        S_.param_specs(params, cfg, plan), plan)))
    return port_flat(S_.map_tree(lambda _, p: p.grad, params))


# =============================================================================
# Tests
# =============================================================================

def _assert_counts(got: dict, want: dict, what: str, bytes_of=CLASSES):
    for cls in CLASSES:
        g = got.get(cls, [0.0, 0.0])
        w = [float(x) for x in want.get(cls, [0.0, 0.0])]
        assert g[0] == w[0], f"{what}: {cls} calls {g[0]} != JAX's {w[0]}"
        if cls in bytes_of:
            assert g[1] == w[1], (f"{what}: {cls} bytes {g[1]} != JAX's "
                                  f"{w[1]}")


@pytest.mark.parametrize("backend", list(SERVE_WANT))
def test_fixed_batch_serve_issues_the_jax_collectives(ranks, jax_side,
                                                      backend):
    outs = ranks.run(_serve_task, backend)
    with_bytes = CLASSES if backend == "sort" else CLASSES[:2]
    for kind in ("prefill", "decode"):
        want = jax_side.get(f"serve/{backend}/{kind}")
        assert [want["all-reduce"][0], want["all-gather"][0],
                want["all-to-all"][0]] == [5, 2, SERVE_WANT[backend]]
        for r, out in enumerate(outs):
            _assert_counts(out[kind], want, f"rank {r} {backend} {kind}",
                           with_bytes)
    assert all(all(o["same"]) for o in outs), [o["same"] for o in outs]


@pytest.mark.parametrize("backend", list(SERVE_WANT))
def test_engine_steps_issue_what_the_jax_engine_reads(ranks, jax_side,
                                                      backend):
    outs = ranks.run(_engine_task, backend)
    with_bytes = CLASSES if backend == "sort" else CLASSES[:2]
    for kind in ("prefill", "decode"):
        want = jax_side.get(f"engine/{backend}/{kind}")
        for r, out in enumerate(outs):
            _assert_counts(out[kind], want, f"rank {r} engine {backend} "
                           f"{kind}", with_bytes)
    assert all(all(o["same"]) for o in outs), [o["same"] for o in outs]


def test_remat_replays_what_the_backward_needs(ranks, jax_side):
    file = params_file(jax_side.out)
    runs = {v: ranks.run(_train_task, v, str(file)) for v in TRAIN_VARIANTS}
    want = {v: jax_side.get(f"train/{v}") for v in TRAIN_VARIANTS}
    for v in ("on", "rsc"):
        for r in range(WORLD):
            got = {c: [a - b for a, b in zip(
                runs[v][r]["counts"].get(c, [0, 0]),
                runs["off"][r]["counts"].get(c, [0, 0]))] for c in CLASSES}
            jdiff = {c: [float(a - b) for a, b in zip(
                want[v].get(c, [0, 0]), want["off"].get(c, [0, 0]))]
                for c in CLASSES}
            _assert_counts(got, jdiff, f"rank {r} remat {v} minus off")
    assert [want[v]["all-reduce"][0] - want["off"]["all-reduce"][0]
            for v in ("on", "rsc")] == [6, 4]
    assert [want[v]["all-to-all"][0] - want["off"]["all-to-all"][0]
            for v in ("on", "rsc")] == [5, 5]
    # the flag changes what crosses the wire, not one bit of the step
    for r in range(WORLD):
        on, rsc = runs["on"][r], runs["rsc"][r]
        assert on["metrics"]["loss"] == rsc["metrics"]["loss"]
        assert on["metrics"]["grad_norm"] == rsc["metrics"]["grad_norm"]
        for k in on["params"]:
            np.testing.assert_array_equal(rsc["params"][k], on["params"][k])
    # and its step is JAX's with the flag on
    j = jax_side.get("train/step_rsc")
    full = full_params(TRAIN_CASE, {k[2:]: v for k, v in j.items()
                                    if k.startswith("p/")})
    err = _max_param_err([o["params"] for o in runs["rsc"]], full, TRAIN_CASE)
    for o in runs["rsc"]:
        _check(o["metrics"], float(j["loss"]), float(j["grad_norm"]), err,
               dict(JAX_BOUNDS, grad_norm_rel=GRAD_REL), "rsc against JAX")


def test_saved_collectives_keep_every_gradient_bit(ranks, jax_side):
    file = str(params_file(jax_side.out))
    on, rsc, off = (ranks.run(_grads_task, v, file)
                    for v in ("on", "rsc", "off"))
    for a, b, c in zip(on, rsc, off):
        assert set(a) == set(b) == set(c)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k])
            np.testing.assert_array_equal(c[k], a[k])
