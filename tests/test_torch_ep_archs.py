"""deepseek-v3's latent attention and MTP head and musicgen's codebooks over
a ``(data 2, model 2)`` mesh of gloo ranks on the CPU, against the JAX
package's ``shard_map`` on 4 of 8 fake devices (one subprocess a module,
the ragged All2All emulated; ``JaxSide`` in ``tests/test_torch_mesh.py``).

* The reduced deepseek-v3 and musicgen serves (``build_prefill`` /
  ``build_decode_step`` with ``mesh=`` on the JAX side, ``generate`` on
  every rank on the port's): MLA's heads (``wq_b``, ``wk_b``, ``wv_b``,
  ``wo``) and the codebook tables and heads cut over ``model``, the latent
  cache's rows over ``data``.  Greedy tokens ((B, K) a step under
  musicgen) equal and every step's logits within ``LOGITS_REL`` (1e-4) of
  the largest; JAX's logits are read out of its ``greedy_sample`` with
  ``jax.debug.callback``, one vocabulary slice a device.
* One LAMB step of the reduced deepseek-v3 (its MoE layer, the MTP head,
  the fused router and the radix sort): the loss, ``mtp`` and the
  gradient norm within 1e-5 relative and every updated parameter within
  1e-6 of JAX's ``build_train_step(..., mesh=)``.

Parameters are the port's structure with every random leaf drawn from
numpy ``default_rng`` (``test_torch_ep_serve.jax_tree``).  Both packages
compute in fp32 (the JAX package's ``embed_inputs`` pinned to fp32 in its
subprocess), and the serves pin the latent and ring caches to fp32 on
both sides (in the test only; ROADMAP.md's trap "bf16 caches amplify sum
orders").
"""
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import RankPool
from test_torch_ep_serve import flat, jax_tree, unflat
from test_torch_mesh import JaxSide

DEEPSEEK, MUSIC = "deepseek-v3-671b", "musicgen-large"
MESH = ((2, 2), ("data", "model"))
B, S, NEW = 4, 16, 4
GB, SEQ = 8, 32
LOGITS_REL = 1e-4
LOSS_REL = 1e-5
PARAM_ATOL = 1e-6
LR, WARMUP, HORIZON = 1e-3, 2, 100
OPTS = dict(router_impl="fused", sort_impl="radix")
TIMEOUT_S = 240


def cfg_of(arch: str, package: str = "torch", train: bool = False):
    if package == "jax":
        from repro.configs import get_reduced, with_options
    else:
        from repro_torch.configs import get_reduced, with_options
    cfg = get_reduced(arch).replace(dtype="float32")
    return with_options(cfg, **OPTS) if train else cfg


def prompts(arch: str) -> np.ndarray:
    cfg = cfg_of(arch)
    shape = (B, cfg.num_codebooks, S) if cfg.num_codebooks > 1 else (B, S)
    return np.random.default_rng(5).integers(
        8, cfg.vocab_size, shape).astype(np.int32)


def train_batch(cfg) -> dict:
    from repro_torch.data.pipeline import make_batch
    return make_batch(cfg, GB, SEQ, seed=0, step=0)


def params_file(out_dir, arch: str) -> Path:
    return Path(out_dir) / f"params-{arch}.npz"


# =============================================================================
# The JAX side
# =============================================================================

def _jax_main(out_dir: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax import lax

    from repro.common.config import TrainConfig
    from repro.kernels import ops as jops
    from repro.models import layers as JL
    from repro.models import transformer as JT
    from repro.optim import make_optimizer, make_schedule
    from repro.serve import decode as JDEC
    from repro.sharding.compat import make_mesh
    from repro.sharding.plan import test_plan
    from repro.train.step import build_train_step

    save = JaxSide.saver(out_dir)
    jops.RADIX_MIN_ROWS = 1 << 30
    jops.ROUTER_FUSED_MIN_ROWS = 1 << 30
    JT.embed_inputs = functools.partial(JT.embed_inputs, dtype=jnp.float32)
    JL.init_mla_cache = functools.partial(JL.init_mla_cache,
                                          dtype=jnp.float32)
    JL.init_attention_cache = functools.partial(JL.init_attention_cache,
                                                dtype=jnp.float32)
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

    def load(arch):
        return jax.tree.map(jnp.asarray,
                            unflat(dict(np.load(params_file(out_dir, arch)))))

    for arch in (DEEPSEEK, MUSIC):
        cfg = cfg_of(arch, "jax")
        params = load(arch)
        toks = jnp.asarray(prompts(arch))
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
        save(f"serve/{arch}", {"tokens": np.stack(out, -1),
                               "logits": np.stack(logits)})

    cfg = cfg_of(DEEPSEEK, "jax", train=True).replace(remat=False)
    params = load(DEEPSEEK)
    batch = {k: jnp.asarray(v) for k, v in train_batch(cfg).items()}
    tcfg = TrainConfig(global_batch_size=GB, seq_len=SEQ, lr=LR,
                       warmup_steps=WARMUP, grad_clip=1.0)
    opt = make_optimizer("lamb")
    step_fn, _ = build_train_step(
        cfg, tcfg, plan, opt, make_schedule("cosine", LR, WARMUP, HORIZON),
        params, batch, mesh=mesh)
    p, _, m = step_fn(params, opt.init(params), batch, jnp.int32(1))
    out = {f"p/{k}": v for k, v in flat(jax.tree.map(np.asarray, p)).items()}
    out.update({k: m[k] for k in ("loss", "ce", "mtp", "grad_norm")})
    save(f"train/{DEEPSEEK}", out)


# =============================================================================
# Fixtures and rank tasks
# =============================================================================

@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax")
    for arch in (DEEPSEEK, MUSIC):
        np.savez(params_file(out, arch), **flat(jax_tree(cfg_of(arch))))
    js = JaxSide("test_torch_ep_archs", out)
    yield js
    js.close()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_side):
    rdzv = tmp_path_factory.mktemp("rdzv") / "store"
    with RankPool(4, backend="gloo", devices=["cpu"] * 4, threads=1,
                  timeout_s=TIMEOUT_S, init_method=f"file://{rdzv}") as pool:
        pool.run(_make_mesh)
        yield pool


def _make_mesh(rank):
    from repro_torch.launch.mesh import make_mesh
    make_mesh(*MESH, device=rank.device)


def _rank_params(arch, file, train=False):
    from repro_torch.sharding import comm
    from repro_torch.sharding import specs as S_
    from repro_torch.sharding.plan import plan_from_mesh
    from repro_torch.weights import params_from_jax
    mesh = comm.bound_mesh()
    plan = plan_from_mesh(mesh)
    cfg = cfg_of(arch, train=train)
    full = params_from_jax(unflat(dict(np.load(file))), cfg, device="cpu",
                           compute_cast=not train)
    return (S_.shard_params(full, S_.param_specs(full, cfg, plan), mesh),
            cfg, plan, mesh)


def _serve_task(rank, arch, file):
    from repro_torch.launch.serve import generate
    from repro_torch.models import layers as TL
    from repro_torch.sharding import specs as S_
    TL.init_mla_cache = functools.partial(TL.init_mla_cache,
                                          dtype=torch.float32)
    TL.init_attention_cache = functools.partial(TL.init_attention_cache,
                                                dtype=torch.float32)
    params, cfg, plan, mesh = _rank_params(arch, file)
    toks = torch.from_numpy(prompts(arch))
    toks = S_.shard_params(toks, S_.batch_specs(toks, plan), mesh)
    mesh.wire.reset()
    res = generate(params, toks, cfg, plan, new_tokens=NEW, keep_logits=True)
    return {"tokens": res.tokens, "logits": res.logits,
            "dp_index": mesh.index("data"), "tp_index": mesh.index("model"),
            "wire": res.wire}


def _train_task(rank, file):
    from repro_torch.common.config import TrainConfig
    from repro_torch.optim import make_optimizer, make_schedule
    from repro_torch.sharding.specs import map_tree
    from repro_torch.train.step import build_train_step
    params, cfg, plan, mesh = _rank_params(DEEPSEEK, file, train=True)
    batch = train_batch(cfg)
    opt = make_optimizer("lamb")
    tcfg = TrainConfig(global_batch_size=GB, seq_len=SEQ, lr=LR,
                       warmup_steps=WARMUP, grad_clip=1.0)
    step = build_train_step(cfg, tcfg, plan, opt,
                            make_schedule("cosine", LR, WARMUP, HORIZON),
                            params, batch, mesh=mesh)
    _, _, m = step(params, opt.init(params), batch, 1)
    out = {}
    map_tree(lambda path, t: out.__setitem__(
        "/".join(path), t.detach().numpy().copy()), params)
    return {"metrics": {k: float(v) for k, v in m.items()}, "params": out,
            "dp_index": mesh.index("data"), "tp_index": mesh.index("model")}


# =============================================================================
# Tests
# =============================================================================

@pytest.mark.parametrize("arch", [DEEPSEEK, MUSIC])
def test_mesh_serve_matches_jax(arch, ranks, jax_side):
    from repro_torch.launch.serve import gather_logits, gather_rows
    got = ranks.run(_serve_task, arch, params_file(jax_side.out, arch),
                    timeout_s=TIMEOUT_S)
    ref = jax_side.get(f"serve/{arch}", timeout_s=TIMEOUT_S)
    tokens = gather_rows(got)
    assert tokens.shape == ref["tokens"].shape == (
        (B, 4, NEW) if arch == MUSIC else (B, NEW))
    np.testing.assert_array_equal(tokens, ref["tokens"])
    lg = gather_logits(got)
    rel = np.abs(lg - ref["logits"]).max() / np.abs(ref["logits"]).max()
    assert rel <= LOGITS_REL, rel
    # the heads ran cut over "model": the output projections' psums
    assert got[0]["wire"]["decode"]["psum model float32"]["calls"] > 0


def test_mesh_training_step_matches_jax(ranks, jax_side):
    """One LAMB step of the reduced deepseek-v3 with its MTP head over the
    mesh: the loss, ``ce``, ``mtp`` and the gradient norm, and each rank's
    slice of every updated parameter (the MTP head's included) against
    JAX's."""
    from repro_torch.sharding import specs as S_
    from repro_torch.sharding.plan import plan_from_mesh
    got = ranks.run(_train_task, params_file(jax_side.out, DEEPSEEK),
                    timeout_s=TIMEOUT_S)
    ref = jax_side.get(f"train/{DEEPSEEK}", timeout_s=TIMEOUT_S)
    for k in ("loss", "ce", "mtp", "grad_norm"):
        for r in got:
            np.testing.assert_allclose(r["metrics"][k], float(ref[k]),
                                       rtol=LOSS_REL, err_msg=k)
    assert float(ref["mtp"]) > 0
    # JAX's updated parameters, cut as the ranks hold them
    cfg = cfg_of(DEEPSEEK, train=True)
    want = _port_tree(ref, cfg)
    n_mtp = 0
    for r in got:
        mesh = _FakeMesh(r["dp_index"], r["tp_index"])
        specs = S_.param_specs(want, cfg, plan_from_mesh(mesh))
        mine = S_.shard_params(want, specs, mesh)
        flat_want = {}
        S_.map_tree(lambda path, t: flat_want.__setitem__(
            "/".join(path), t.numpy()), mine)
        assert set(flat_want) == set(r["params"])
        for k, v in r["params"].items():
            np.testing.assert_allclose(v, flat_want[k], rtol=0,
                                       atol=PARAM_ATOL, err_msg=k)
            n_mtp += k.startswith("mtp/")
    assert n_mtp >= 4 * 12


def _port_tree(ref, cfg):
    from repro_torch.weights import params_from_jax
    arrays = {k[2:]: v for k, v in ref.items() if k.startswith("p/")}
    return params_from_jax(unflat(arrays), cfg, device="cpu",
                           compute_cast=False)


class _FakeMesh:
    """The sizes and one rank's coordinates of the (data 2, model 2) mesh,
    for cutting a rank's slices on the host (``specs.shard_params``)."""

    axes = ("data", "model")
    shape = (2, 2)
    axis_sizes = (("data", 2), ("model", 2))
    device = torch.device("cpu")

    def __init__(self, d, m):
        self.coords = {"data": d, "model": m}

    def size(self, axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return int(np.prod([dict(self.axis_sizes)[a] for a in axes]))

    def index(self, axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        i = 0
        for a in axes:
            i = i * dict(self.axis_sizes)[a] + self.coords[a]
        return i
