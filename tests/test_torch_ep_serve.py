"""The reduced qwen3-moe-30b-a3b served over a ``(data 2, model 2)`` mesh of
gloo ranks on the CPU: the JAX package's multi-device serve
(``build_prefill`` / ``build_decode_step`` with ``mesh=``), and the port's
own one-rank serve.

The JAX side runs once per module in a subprocess (8 fake CPU devices, the
ragged All2All emulated; see ``tests/test_torch_mesh.py``'s ``JaxSide``).
Its parameters are the port's (``init_model`` on the CPU for the structure
and each leaf's scale, every random leaf drawn anew from numpy
``default_rng``), stacked into the JAX package's tree; the ranks carry
them across with ``params_from_jax`` and cut their slices with
``sharding.specs``.  Both packages compute in fp32 (the JAX package's
``embed_inputs`` pinned to fp32 in its subprocess; nothing in
``src/repro`` changes), so the greedy tokens must be equal and every
step's logits within ``LOGITS_REL`` of the largest; JAX's logits are read
out of its ``greedy_sample`` with ``jax.debug.callback``, one vocabulary
slice a device.  The same comparison runs in the served config's bf16
(the JAX side's ``embed_inputs`` as it is), where the tokens must be
equal and the logits within chip_smoke.py's ``LOGITS_ATOL``.

The port's one-rank serve against its four-rank serve runs the config as
served (bf16), dropless, through ``serve_mesh`` (one spawned process a
rank), under ``chip_smoke.py`` phase 16's check: tokens equal or, where a
row first parts, a near tie.  The CLI runs under ``torchrun`` (env://).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import RankPool
from test_torch_mesh import JaxSide

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import LOGITS_ATOL, check_tokens_and_logits  # noqa: E402

ARCH = "qwen3-moe-30b-a3b"
MESH = ((2, 2), ("data", "model"))
B, S, NEW = 4, 16, 4
LOGITS_REL = 1e-4
BACKENDS = ("sort", "dropless")
RUNS = [("float32", b) for b in BACKENDS] + [("bfloat16", b)
                                             for b in BACKENDS]
TIMEOUT_S = 180


def serve_cfg(backend: str, package: str = "torch",
              dtype: str = "float32"):
    """The reduced config under ``backend``, in ``dtype``."""
    if package == "jax":
        from repro.configs import get_reduced, with_options
    else:
        from repro_torch.configs import get_reduced, with_options
    return with_options(get_reduced(ARCH), dispatch_backend=backend
                        ).replace(dtype=dtype)


def prompts() -> np.ndarray:
    return np.random.default_rng(5).integers(8, 512, (B, S)).astype(np.int32)


def jax_tree(cfg, seed: int = 0) -> dict:
    """The JAX package's parameter tree (numpy): the port's structure and
    leaf scales (``init_model`` on the CPU), each random leaf drawn anew
    from ``default_rng``, each stage's blocks stacked on a leading axis."""
    from repro_torch.models.transformer import build_stages, init_model
    from repro_torch.sharding.plan import single_device_plan
    from repro_torch.sharding.specs import map_tree
    rng = np.random.default_rng(seed)
    port = init_model(cfg, single_device_plan(), seed=seed, device="cpu",
                      compute_cast=False)

    def redraw(path, t):
        sd = float(t.std()) if t.numel() > 1 else 0.0
        a = t.numpy()
        return (a if sd == 0.0 else
                (rng.standard_normal(a.shape) * sd).astype(np.float32))

    port = map_tree(redraw, port)
    stages = []
    for st, sp in zip(build_stages(cfg), port["stages"]):
        stages.append({k: stack(v) for k, v in sp.items()})
    return {**{k: v for k, v in port.items() if k != "stages"},
            "stages": tuple(stages)}


def stack(blocks: list):
    if isinstance(blocks[0], dict):
        return {k: stack([b[k] for b in blocks]) for k in blocks[0]}
    return np.stack(blocks)


def flat(tree, prefix="") -> dict:
    """Nested dicts and tuples -> {"a/0/b": array}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(flat(v, f"{prefix}{k}/"))
    return out


def unflat(arrays: dict) -> dict:
    """Inverse of :func:`flat` (numeric keys become tuple entries)."""
    tree: dict = {}
    for key, a in arrays.items():
        node = tree
        *path, last = key.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = a

    def fix(t):
        if not isinstance(t, dict):
            return t
        if t and all(k.isdigit() for k in t):
            return tuple(fix(t[str(i)]) for i in range(len(t)))
        return {k: fix(v) for k, v in t.items()}
    return fix(tree)


def params_path(out_dir) -> Path:
    return Path(out_dir) / "params.npz"


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
    from repro.sharding.compat import make_mesh
    from repro.sharding.plan import test_plan

    save = JaxSide.saver(out_dir)
    embed = JT.embed_inputs
    JT.embed_inputs = functools.partial(embed, dtype=jnp.float32)
    seen = []
    sample = JDEC.greedy_sample

    def greedy_sample(logits, plan):
        jax.debug.callback(
            lambda lg, d, m: seen.append((int(d), int(m), np.asarray(lg))),
            logits, lax.axis_index("data"), lax.axis_index("model"))
        return sample(logits, plan)

    JDEC.greedy_sample = greedy_sample
    mesh = make_mesh(*MESH)
    plan = test_plan(2, 2)
    params = jax.tree.map(jnp.asarray,
                          unflat(dict(np.load(params_path(out_dir)))))
    toks = jnp.asarray(prompts())
    for dtype, backend in RUNS:
        # fp32 runs embed in fp32 (pinned above); bf16 runs as configured
        JT.embed_inputs = (embed if dtype == "bfloat16" else
                           functools.partial(embed, dtype=jnp.float32))
        cfg = serve_cfg(backend, "jax", dtype)
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
        save(f"serve/{dtype}/{backend}", {"tokens": np.stack(out, -1),
                                          "logits": np.stack(logits)})


# =============================================================================
# Fixtures and rank tasks
# =============================================================================

@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax")
    np.savez(params_path(out), **flat(jax_tree(serve_cfg("sort"))))
    js = JaxSide("test_torch_ep_serve", out)
    yield js
    js.close()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_side):
    rdzv = tmp_path_factory.mktemp("rdzv") / "store"
    with RankPool(4, backend="gloo", devices=["cpu"] * 4, threads=1,
                  timeout_s=TIMEOUT_S, init_method=f"file://{rdzv}") as pool:
        yield pool


def _serve_from_jax_params(rank, params_file, backend, dtype="float32"):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import generate, serve_prompts
    from repro_torch.sharding import specs as S_
    from repro_torch.sharding.plan import plan_from_mesh
    from repro_torch.weights import params_from_jax
    mesh = make_mesh(*MESH, device=rank.device)
    plan = plan_from_mesh(mesh)
    cfg = serve_cfg(backend, dtype=dtype)
    full = params_from_jax(unflat(dict(np.load(params_file))), cfg,
                           device="cpu")
    params = S_.shard_params(full, S_.param_specs(full, cfg, plan), mesh)
    toks = S_.shard_params(torch.from_numpy(prompts()),
                           S_.batch_specs(torch.zeros(B, S), plan), mesh)
    res = generate(params, toks, cfg, plan, new_tokens=NEW, keep_logits=True)
    return {"tokens": res.tokens, "logits": res.logits,
            "dp_index": mesh.index("data"), "tp_index": mesh.index("model"),
            "wire": res.wire}


# =============================================================================
# Tests
# =============================================================================

@pytest.mark.parametrize("backend", BACKENDS)
def test_mesh_serve_matches_jax(backend, ranks, jax_side):
    from repro_torch.launch.serve import gather_logits, gather_rows
    got = ranks.run(_serve_from_jax_params, params_path(jax_side.out),
                    backend, timeout_s=TIMEOUT_S)
    ref = jax_side.get(f"serve/float32/{backend}", timeout_s=TIMEOUT_S)
    np.testing.assert_array_equal(gather_rows(got), ref["tokens"])
    lg = gather_logits(got)
    rel = np.abs(lg - ref["logits"]).max() / np.abs(ref["logits"]).max()
    assert rel <= LOGITS_REL, rel
    # the hops ran on the wire: SMILE's inter hop over "data", its intra
    # hop over "model", ragged under dropless and padded under sort
    op = "ragged_all_to_all" if backend == "dropless" else "all_to_all"
    for axis in ("data", "model"):
        assert got[0]["wire"]["decode"][f"{op} {axis} float32"]["calls"] > 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_mesh_serve_bf16_matches_jax(backend, ranks, jax_side):
    """The served config's bf16 on both sides: the tp output projections'
    partials are rounded to bf16 and psum'd in bf16 as the reference does
    (``row_parallel``): every row's tokens equal, and every step's logits
    within chip_smoke.py's ``LOGITS_ATOL`` (3e-2; the reading is 1.12e-2
    under both backends: bf16 rounds at other places in the two
    frameworks too)."""
    from repro_torch.launch.serve import gather_logits, gather_rows
    got = ranks.run(_serve_from_jax_params, params_path(jax_side.out),
                    backend, "bfloat16", timeout_s=TIMEOUT_S)
    ref = jax_side.get(f"serve/bfloat16/{backend}", timeout_s=TIMEOUT_S)
    n_same, worst = check_tokens_and_logits(
        ref["tokens"], ref["logits"], gather_rows(got), gather_logits(got),
        LOGITS_ATOL, f"bf16 mesh serve, {backend}")
    assert n_same == B


def test_four_ranks_serve_as_one(monkeypatch):
    from repro_torch.launch.serve import gather_logits, gather_rows, serve
    from repro_torch.launch.serve import serve_mesh
    kw = dict(reduced=True, batch=B, prompt_len=S, new_tokens=NEW, seed=0,
              moe_options={"dispatch_backend": "dropless"},
              keep_logits=True)
    one = serve(ARCH, device="cpu", **kw)
    out = serve_mesh(ARCH, (2, 2), backend="gloo", devices=["cpu"] * 4,
                     threads=1, timeout_s=TIMEOUT_S, **kw)
    n_same, worst = check_tokens_and_logits(
        one.tokens, one.logits, gather_rows(out), gather_logits(out),
        LOGITS_ATOL, "one rank against four")
    assert n_same >= 1


def test_cli_under_torchrun():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "-m", "repro_torch.launch.serve",
           "--arch", ARCH, "--reduced", "--batch", "4", "--prompt-len", "8",
           "--new-tokens", "3", "--mesh", "2,2", "--backend", "gloo",
           "--devices", "cpu", "--launcher", "env"]
    p = subprocess.run(cmd, env=env, capture_output=True, text=True,
                       timeout=TIMEOUT_S)
    assert p.returncode == 0, p.stderr[-3000:]
    from repro_torch.launch.serve import serve
    one = serve(ARCH, device="cpu", reduced=True, batch=4, prompt_len=8,
                new_tokens=3, seed=0)
    assert f"generated (first row): {one.tokens[0].tolist()}" in p.stdout
