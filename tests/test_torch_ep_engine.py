"""Serving over a ``(data 2, model 2)`` mesh of gloo ranks on the CPU, the
rest of the expert-parallel wire: the continuous-batching engine
(``Engine(..., mesh=)``), the sequence-sharded ring KV cache
(``kv_seq_shard``) and rwkv6 under tensor parallelism, each against the
JAX package's own mesh path, and the port's mesh against its one rank.

The JAX side runs once per module in a subprocess (8 fake CPU devices, the
ragged All2All emulated; ``tests/test_torch_mesh.py``'s ``JaxSide``), with
its ``embed_inputs`` pinned to fp32 there only, so both packages compute in
fp32 (the paged pools stay bf16 on both sides).  Its parameters are the
port's structure with every random leaf drawn anew from numpy
``default_rng`` (``tests/test_torch_ep_serve.py``'s ``jax_tree``); the
four ranks carry them across with ``params_from_jax`` and cut their slices
with ``sharding.specs``.

* The engine: JAX's ``Engine(mesh=)`` against the port's on reduced
  qwen3-moe (``sort``, ``dropless``) and reduced qwen1.5-0.5b, 5 ragged
  requests over 2 slots (pages of 4, a cache of 32), so pages are freed
  and reused.  JAX's decode logits come from its ``_decode`` wrapped here
  (its second output, vocabulary-cut over ``model`` and assembled by
  ``shard_map``).  Held: each request's tokens equal, on all four ranks;
  every decode step's live rows' logits within ``LOGITS_REL`` of the
  largest; the telemetry of every step (drop fraction, hop max load,
  entropy) within ``TELEMETRY_ATOL``; the occupancy trace, the ticks and
  the compile counts equal.
* The sequence-sharded ring cache and rwkv6: JAX's ``build_prefill`` /
  ``build_decode_step`` with ``mesh=`` against the port's ``generate`` on
  the ranks: tokens equal, every step's logits within ``LOGITS_REL`` of the
  largest (read out of JAX's ``greedy_sample`` as in
  ``test_torch_ep_serve.py``).  The sequence-sharded cases pin the ring
  caches to fp32 on both sides too (``init_attention_cache``'s dtype, in
  the test only): with bf16 caches a K/V value on a bf16 rounding edge,
  nudged by the merged partials' other sum order, rounds the other way,
  and the JAX package's own sharded and unsharded caches then part by
  2.0e-4 of the largest logit (1.1e-6 with fp32 caches).
* The port alone: the mesh engine against the one-rank engine in the
  served bf16 under chip_smoke.py's check (tokens equal or, where a
  request first parts, a near tie); the rwkv6 cache-less forward gathered
  over the ranks against one rank within ``RWKV_FORWARD_REL``; the CLI's
  ``--engine --mesh 2,2`` under ``torchrun``.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import RankPool
from test_torch_ep_serve import flat, jax_tree, unflat
from test_torch_mesh import JaxSide

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import (LOGITS_ATOL, check_request_tokens,  # noqa: E402
                        engine_route_parts, keep_logits, record_engine_moe)

QWEN3, QWEN15, RWKV = "qwen3-moe-30b-a3b", "qwen1.5-0.5b", "rwkv6-1.6b"
MESH = ((2, 2), ("data", "model"))
ENGINE_KW = dict(cache_len=32, page_size=4, n_slots=2)
ENGINE_CASES = {"qwen3-sort": (QWEN3, "sort"),
                "qwen3-dropless": (QWEN3, "dropless"),
                "qwen1.5": (QWEN15, None)}
SEQ_CASES = {"qwen1.5": (QWEN15, None), "qwen3-dropless": (QWEN3, "dropless")}
B, S, NEW = 4, 12, 4
LOGITS_REL = 1e-4
TELEMETRY_ATOL = 1e-6
TELEMETRY = ("drop_frac", "hop_max_load", "hop_load_entropy")
RWKV_FORWARD_REL = 1e-5
TIMEOUT_S = 180


def model_cfg(arch, backend=None, package="torch", dtype="float32",
              seq_shard=False):
    if package == "jax":
        from repro.configs import get_reduced, with_options
    else:
        from repro_torch.configs import get_reduced, with_options
    cfg = get_reduced(arch)
    if backend:
        cfg = with_options(cfg, dispatch_backend=backend)
    return cfg.replace(dtype=dtype, kv_seq_shard=seq_shard)


def trace(vocab: int):
    """5 ragged requests of 3-14 prompt tokens and 2-6 new ones."""
    rng = np.random.default_rng(11)
    return [(rng.integers(8, vocab, int(rng.integers(3, 15))).astype(np.int32),
             int(rng.integers(2, 7))) for _ in range(5)]


def prompts(vocab: int) -> np.ndarray:
    return np.random.default_rng(5).integers(8, vocab, (B, S)).astype(
        np.int32)


def params_file(out_dir, arch) -> Path:
    return Path(out_dir) / f"params-{arch}.npz"


# =============================================================================
# The JAX side
# =============================================================================

def _jax_main(out_dir: str) -> None:
    import functools

    import jax
    import jax.numpy as jnp
    from jax import lax

    from repro.models import transformer as JT
    from repro.serve import decode as JDEC
    from repro.serve.engine import Engine as JEngine
    from repro.sharding.compat import make_mesh
    from repro.sharding.plan import test_plan

    save = JaxSide.saver(out_dir)
    JT.embed_inputs = functools.partial(JT.embed_inputs, dtype=jnp.float32)
    mesh = make_mesh(*MESH)
    plan = test_plan(2, 2)

    def load(arch):
        return jax.tree.map(jnp.asarray,
                            unflat(dict(np.load(params_file(out_dir, arch)))))

    for case, (arch, backend) in ENGINE_CASES.items():
        cfg = model_cfg(arch, backend, "jax")
        eng = JEngine(load(arch), cfg, plan, mesh=mesh, **ENGINE_KW)
        decode, steps = eng._decode, []

        def wrapped(*args, decode=decode, steps=steps):
            live = np.array(args[5])        # before the tick rewrites it
            out = decode(*args)
            steps.append((live, np.asarray(out[1])))
            return out

        eng._decode = wrapped
        uids = [eng.submit(p, nt) for p, nt in trace(cfg.vocab_size)]
        out = eng.run()
        tel = np.array([[t[k] for k in TELEMETRY] for t in eng.telemetry])
        save(f"engine/{case}", {
            "uids": np.array(uids),
            "tokens": np.concatenate([out[u] for u in uids]),
            "lengths": np.array([len(out[u]) for u in uids]),
            "live": np.stack([s[0] for s in steps]),
            "logits": np.stack([s[1] for s in steps]),
            "telemetry": tel, "occupancy": np.array(eng.occupancy),
            "ticks": np.array(eng.ticks),
            "decode_compiles": np.array(decode._cache_size())})

    seen = []
    sample = JDEC.greedy_sample

    def greedy_sample(logits, plan):
        jax.debug.callback(
            lambda lg, d, m: seen.append((int(d), int(m), np.asarray(lg))),
            logits, lax.axis_index("data"), lax.axis_index("model"))
        return sample(logits, plan)

    JDEC.greedy_sample = greedy_sample

    def serve(cfg, params, section):
        toks = jnp.asarray(prompts(cfg.vocab_size))
        caches = JT.init_caches(cfg, B, S + NEW, plan)
        pf = JDEC.build_prefill(cfg, plan, params, toks, caches, mesh=mesh)
        logits, out = [], []

        def step(fn, *args):
            seen.clear()
            tok, c = fn(*args)
            jax.block_until_ready(tok)
            jax.effects_barrier()
            parts = {(d, m): lg for d, m, lg in seen}
            logits.append(np.concatenate([np.concatenate(
                [parts[(d, m)] for m in range(2)], -1) for d in range(2)]))
            out.append(np.asarray(tok))
            return tok, c

        tok, caches = step(pf, params, toks, caches)
        dc = JDEC.build_decode_step(cfg, plan, params, tok, caches, mesh=mesh)
        for i in range(NEW - 1):
            tok, caches = step(dc, params, tok, caches, jnp.int32(S + i))
        save(section, {"tokens": np.stack(out, -1),
                       "logits": np.stack(logits)})

    serve(model_cfg(RWKV, None, "jax"), load(RWKV), "rwkv")
    from repro.models import layers as JL
    JL.init_attention_cache = functools.partial(JL.init_attention_cache,
                                                dtype=jnp.float32)
    for case, (arch, backend) in SEQ_CASES.items():
        serve(model_cfg(arch, backend, "jax", seq_shard=True), load(arch),
              f"seq_shard/{case}")


# =============================================================================
# Fixtures and rank tasks
# =============================================================================

@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax")
    for arch in (QWEN3, QWEN15, RWKV):
        np.savez(params_file(out, arch), **flat(jax_tree(model_cfg(arch))))
    js = JaxSide("test_torch_ep_engine", out)
    yield js
    js.close()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_side):
    rdzv = tmp_path_factory.mktemp("rdzv") / "store"
    with RankPool(4, backend="gloo", devices=["cpu"] * 4, threads=1,
                  timeout_s=TIMEOUT_S, init_method=f"file://{rdzv}") as pool:
        yield pool


def _mesh(rank):
    """The rank's mesh and plan, made once a process."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding.plan import plan_from_mesh
    st = rank.state
    if "mesh" not in st:
        st["mesh"] = make_mesh(*MESH, device=rank.device)
        st["plan"] = plan_from_mesh(st["mesh"])
    return st["mesh"], st["plan"]


def _where(mesh) -> dict:
    return {"dp_index": mesh.index("data"), "tp_index": mesh.index("model")}


def _with_specs(tree, specs):
    """``(leaf, spec)`` of each tensor of ``tree`` in order."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _with_specs(tree[k], specs[k])
    elif isinstance(tree, (list, tuple)):
        for t, sp in zip(tree, specs):
            yield from _with_specs(t, sp)
    else:
        yield tree, specs


def _jax_params(mesh, plan, path, cfg):
    """The rank's slice of the JAX package's parameters in ``path``."""
    from repro_torch.sharding import specs as S_
    from repro_torch.weights import params_from_jax
    full = params_from_jax(unflat(dict(np.load(path))), cfg, device="cpu")
    return S_.shard_params(full, S_.param_specs(full, cfg, plan), mesh)


def _engine_from_jax_params(rank, path, arch, backend):
    from repro_torch.common.config import ServeConfig
    from repro_torch.serve import kvcache as KV
    from repro_torch.serve.engine import Engine
    from repro_torch.sharding import specs as S_
    from repro_torch.weights import params_from_jax
    mesh, plan = _mesh(rank)
    cfg = model_cfg(arch, backend)
    sc = ServeConfig(**ENGINE_KW)
    full = params_from_jax(unflat(dict(np.load(path))), cfg, device="cpu")
    pools = KV.init_paged_caches(cfg, sc.resolved_pool_pages(), sc.page_size,
                                 plan, device="cpu")
    specs = S_.engine_step_specs(full, pools, cfg, plan)
    eng = Engine(S_.shard_params(full, specs["params"], mesh), cfg, plan,
                 serve=sc, mesh=mesh)
    # each rank's pools are allocated at their slice of the full ones
    for (x, spec), (y, _) in zip(_with_specs(pools, specs["caches"]),
                                 _with_specs(eng.caches, specs["caches"])):
        assert S_.local_shape(tuple(x.shape), spec, mesh) == tuple(y.shape)
    steps, step_of = [], eng._step

    def step(key):
        run = step_of(key)
        if key != "decode":
            return run

        def call():
            live = eng._live.copy()
            out = run()
            steps.append((live, out[1].float().numpy()))
            return out
        return call

    eng._step = step
    uids = [eng.submit(p, nt) for p, nt in trace(cfg.vocab_size)]
    out = eng.run()
    return {"uids": uids, "tokens": out, "steps": steps,
            "telemetry": eng.telemetry, "occupancy": eng.occupancy,
            "ticks": eng.ticks, "compiles": eng.compile_counts(),
            **_where(mesh)}


def _serve_from_jax_params(rank, path, arch, backend, seq_shard):
    import functools

    from repro_torch.launch.serve import generate
    from repro_torch.models import layers as L
    from repro_torch.sharding import specs as S_
    mesh, plan = _mesh(rank)
    cfg = model_cfg(arch, backend, seq_shard=seq_shard)
    toks = S_.shard_params(torch.from_numpy(prompts(cfg.vocab_size)),
                           S_.batch_specs(torch.zeros(B, S), plan), mesh)
    init = L.init_attention_cache
    if seq_shard:             # fp32 ring caches, as on the JAX side
        L.init_attention_cache = functools.partial(init, dtype=torch.float32)
    try:
        res = generate(_jax_params(mesh, plan, path, cfg), toks, cfg, plan,
                       new_tokens=NEW, keep_logits=True)
    finally:
        L.init_attention_cache = init
    return {"tokens": res.tokens, "logits": res.logits, **_where(mesh)}


def _own_engine(rank, arch, backend):
    """The port's mesh engine on its own weights (seed 0, the served
    bf16), the logits of each generated token kept."""
    from repro_torch.models.transformer import init_model
    from repro_torch.serve.engine import Engine
    mesh, plan = _mesh(rank)
    cfg = model_cfg(arch, backend, dtype="bfloat16")
    params = init_model(cfg, plan, seed=0, device="cpu", mesh=mesh)
    eng = Engine(params, cfg, plan, mesh=mesh, **ENGINE_KW)
    with keep_logits(eng) as kept, record_engine_moe(eng) as moe:
        for p, nt in trace(cfg.vocab_size):
            eng.submit(p, nt)
        out = eng.run()
    return {"tokens": out, "logits": {u: [x.numpy() for x in v]
                                      for u, v in kept.items()},
            "moe": moe, "counts": eng.compile_counts(), **_where(mesh)}


def _rwkv_forward(rank, tokens):
    from repro_torch.models.transformer import forward, init_model
    from repro_torch.sharding import specs as S_
    mesh, plan = _mesh(rank)
    cfg = model_cfg(RWKV)
    params = init_model(cfg, plan, seed=0, device="cpu", mesh=mesh)
    toks = torch.from_numpy(tokens)
    toks = S_.shard_params(toks, S_.batch_specs(toks, plan), mesh)
    with torch.no_grad():
        _, logits, _, _ = forward(params, toks, cfg, plan,
                                  positions=torch.arange(toks.shape[1]),
                                  use_kernel=True)
    return {"logits": logits.numpy()[None], **_where(mesh)}


def _tp_pieces(results, key):
    """Data rank 0's two model ranks' ``key``, in model order."""
    return [r[key] for r in sorted(results, key=lambda r: r["tp_index"])
            if r["dp_index"] == 0]


# =============================================================================
# Tests
# =============================================================================

@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_mesh_engine_matches_jax(case, ranks, jax_side):
    arch, backend = ENGINE_CASES[case]
    got = ranks.run(_engine_from_jax_params, params_file(jax_side.out, arch),
                    arch, backend, timeout_s=TIMEOUT_S)
    ref = jax_side.get(f"engine/{case}", timeout_s=TIMEOUT_S)
    want = dict(zip(ref["uids"].tolist(), np.split(
        ref["tokens"], np.cumsum(ref["lengths"])[:-1])))
    for r in got:
        assert r["uids"] == ref["uids"].tolist()
        assert {u: list(t) for u, t in want.items()} == r["tokens"], r[
            "tp_index"]
    # every decode step's live rows, the vocabulary from both model ranks
    pieces = _tp_pieces(got, "steps")
    assert len(pieces[0]) == len(ref["logits"])
    for i, (live, lg) in enumerate(zip(ref["live"], ref["logits"])):
        assert (pieces[0][i][0].astype(bool) == live).all() and live.any()
        mine = np.concatenate([p[i][1] for p in pieces], -1)[live]
        rel = np.abs(mine - lg[live]).max() / np.abs(lg[live]).max()
        assert rel <= LOGITS_REL, (i, rel)
    for r in got:
        tel = np.array([[t[k] for k in TELEMETRY] for t in r["telemetry"]])
        np.testing.assert_allclose(tel, ref["telemetry"], rtol=0,
                                   atol=TELEMETRY_ATOL)
        assert r["occupancy"] == ref["occupancy"].tolist()
        assert r["ticks"] == int(ref["ticks"])
        assert r["compiles"]["decode"] == int(ref["decode_compiles"]) == 1


@pytest.mark.parametrize("case", list(SEQ_CASES) + ["rwkv6"])
def test_mesh_serve_matches_jax(case, ranks, jax_side):
    """The sequence-sharded ring cache (each model rank holds 8 of the 16
    slots, every KV head) and rwkv6 with its heads cut over ``model``."""
    from repro_torch.launch.serve import gather_logits, gather_rows
    arch, backend = SEQ_CASES.get(case, (RWKV, None))
    seq_shard = case != "rwkv6"
    got = ranks.run(_serve_from_jax_params, params_file(jax_side.out, arch),
                    arch, backend, seq_shard, timeout_s=TIMEOUT_S)
    ref = jax_side.get(f"seq_shard/{case}" if seq_shard else "rwkv",
                       timeout_s=TIMEOUT_S)
    np.testing.assert_array_equal(gather_rows(got), ref["tokens"])
    lg = gather_logits(got)
    rel = np.abs(lg - ref["logits"]).max() / np.abs(ref["logits"]).max()
    assert rel <= LOGITS_REL, rel


def test_mesh_engine_bf16_matches_one_rank(ranks):
    """The port's mesh engine against its one-rank engine on the same
    weights and trace, reduced qwen3-moe dropless in the served bf16, under
    chip_smoke.py's check: routing is discrete, and a token whose router
    has two candidates closer than bf16's noise between the two sums takes
    other experts on one side (``engine_route_parts``); so each request is
    held up to the token whose tick parted its route (tokens equal or a
    near tie where they first part, logits within ``LOGITS_ATOL``), and at
    least half the requests must keep their route to the end.  All four
    ranks' tokens equal.  (In fp32 the two engines' logits lie within
    1e-6 of each other on this trace; in bf16 one request's route parts at
    its prefill, and its logits then lie 0.14 apart.)"""
    from repro_torch.models.transformer import init_model
    from repro_torch.serve.engine import Engine
    from repro_torch.sharding.plan import single_device_plan
    got = ranks.run(_own_engine, QWEN3, "dropless", timeout_s=TIMEOUT_S)
    cfg = model_cfg(QWEN3, "dropless", dtype="bfloat16")
    plan = single_device_plan()
    eng = Engine(init_model(cfg, plan, seed=0, device="cpu"), cfg, plan,
                 **ENGINE_KW)
    with keep_logits(eng) as kept, record_engine_moe(eng) as moe:
        for p, nt in trace(cfg.vocab_size):
            eng.submit(p, nt)
        want = eng.run()
    assert all(r["tokens"] == got[0]["tokens"] for r in got)
    assert got[0]["counts"] == eng.compile_counts()
    pieces = _tp_pieces(got, "logits")
    mesh_lg = {u: [np.concatenate([p[u][i] for p in pieces])
                   for i in range(len(pieces[0][u]))] for u in pieces[0]}
    upto, _, _ = engine_route_parts(moe, _tp_pieces(got, "moe"))
    kept_route = sum(upto[u] >= len(want[u]) for u in want)
    assert 2 * kept_route >= len(want), upto
    n_same, _ = check_request_tokens(
        want, {u: [x.numpy() for x in v] for u, v in kept.items()},
        got[0]["tokens"], mesh_lg, LOGITS_ATOL, "mesh engine, bf16",
        upto=upto)
    assert n_same >= kept_route


def test_rwkv6_forward_over_ranks_matches_one_rank(ranks):
    """The cache-less kernel forward (the plain scan on the CPU) of reduced
    rwkv6 over the mesh, its logits gathered (rows over ``data``, the
    vocabulary over ``model``), against one rank's, fp32."""
    from repro_torch.launch.serve import gather_logits
    from repro_torch.models.transformer import forward, init_model
    from repro_torch.sharding.plan import single_device_plan
    cfg = model_cfg(RWKV)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                               (4, 16)).astype(np.int32)
    got = gather_logits(ranks.run(_rwkv_forward, tokens,
                                  timeout_s=TIMEOUT_S))[0]
    plan = single_device_plan()
    with torch.no_grad():
        _, want, _, _ = forward(init_model(cfg, plan, seed=0, device="cpu"),
                                torch.from_numpy(tokens), cfg, plan,
                                positions=torch.arange(16), use_kernel=True)
    want = want.numpy()
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= RWKV_FORWARD_REL, rel


def test_engine_cli_under_torchrun():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "-m", "repro_torch.launch.serve",
           "--arch", QWEN3, "--reduced", "--engine", "--requests", "2",
           "--prompt-len", "8", "--new-tokens", "3", "--mesh", "2,2",
           "--backend", "gloo", "--devices", "cpu", "--launcher", "env"]
    p = subprocess.run(cmd, env=env, capture_output=True, text=True,
                       timeout=TIMEOUT_S)
    assert p.returncode == 0, p.stderr[-3000:]
    from repro_torch.launch.serve import serve_engine
    one = serve_engine(QWEN3, reduced=True, requests=2, prompt_len=8,
                       new_tokens=3, device="cpu")
    n_tok = sum(len(v) for v in one.tokens.values())
    assert (f"engine, rank 0 of 4 (env://, gloo): 2 requests, {n_tok} "
            f"tokens in {one.ticks} ticks") in p.stdout, p.stdout
