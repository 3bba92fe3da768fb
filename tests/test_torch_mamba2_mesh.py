"""zamba2's Mamba2 stage over a ``(data 2, model 2)`` mesh of gloo ranks on
the CPU, against the JAX package's ``shard_map`` on 4 of 8 fake devices
(one subprocess, the ragged All2All emulated; ``JaxSide`` in
``tests/test_torch_mesh.py``).

* The reduced zamba2 serve (``build_prefill`` / ``build_decode_step`` with
  ``mesh=`` on the JAX side, ``generate`` on every rank on the port's): a
  Mamba2 block's heads (``wx``, ``wz``, ``wdt``, ``conv_x``, ``A_log``,
  ``D``, ``dt_bias``, the gated norm's scale, ``wo``) and the SSM and
  ``conv_x`` states cut over ``model``, the batch over ``data``; the gated
  norm's sum of squares psum'd over ``model``.  Greedy tokens equal and
  every step's logits within ``LOGITS_REL`` (1e-4) of the largest.
* One LAMB step (the collectives' gradients through the Mamba2 blocks):
  the loss and the gradient norm within 1e-5 relative and every
  parameter, gathered whole (the Mamba2 leaves stacked (R, g)), within
  1e-6 of JAX's ``build_train_step(..., mesh=)``; ZeRO-1's step gives
  the plain step's parameters within 1e-6.

Parameters are the port's ``init_model`` draw with the Mamba2 blocks'
``A_log``, ``D``, ``dt_bias`` and gated-norm scales redrawn from numpy
``default_rng``, carried to JAX's layout by ``params_to_jax``.  Both
packages compute in fp32 (the JAX package's ``embed_inputs`` pinned to
fp32 in its subprocess), and the serve pins the conv states and the ring
cache to fp32 on both sides (in the test only; ROADMAP.md's trap "bf16
caches amplify sum orders").
"""
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import RankPool
from test_torch_ep_serve import flat, unflat
from test_torch_mesh import JaxSide

ARCH = "zamba2-2.7b"
MESH = ((2, 2), ("data", "model"))
B, S, NEW = 4, 32, 4
GB, SEQ = 8, 64
LOGITS_REL = 1e-4
LOSS_REL = 1e-5
PARAM_ATOL = 1e-6
LR, WARMUP, HORIZON = 1e-3, 2, 100
TIMEOUT_S = 240


def cfg_of(package: str = "torch"):
    if package == "jax":
        from repro.configs import get_reduced
    else:
        from repro_torch.configs import get_reduced
    return get_reduced(ARCH).replace(dtype="float32")


def prompts() -> np.ndarray:
    return np.random.default_rng(5).integers(
        8, cfg_of().vocab_size, (B, S)).astype(np.int32)


def train_batch(cfg) -> dict:
    from repro_torch.data.pipeline import make_batch
    return make_batch(cfg, GB, SEQ, seed=0, step=0)


def params_file(out_dir) -> Path:
    return Path(out_dir) / "params.npz"


def jax_layout_params() -> dict:
    """The JAX layout (numpy) of the port's fp32 draw, each Mamba2 block's
    vectors redrawn."""
    from repro_torch.models.transformer import init_model
    from repro_torch.sharding.plan import single_device_plan
    from repro_torch.weights import params_to_jax
    p = init_model(cfg_of(), single_device_plan(), seed=0, device="cpu",
                   compute_cast=False)
    rng = np.random.default_rng(7)
    for group in p["stages"][0]["mamba"]:
        for blk in group:
            m = blk["mamba"]
            for t, mu, sd in ((m["A_log"], 0.0, 0.5), (m["dt_bias"], 0.0, 0.5),
                              (m["D"], 1.0, 0.1), (m["norm"]["scale"], 1.0,
                                                   0.1)):
                t.copy_(torch.from_numpy(
                    mu + sd * rng.standard_normal(t.shape)))
    return params_to_jax(p)


# =============================================================================
# The JAX side
# =============================================================================

def _jax_main(out_dir: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax import lax

    from repro.common.config import TrainConfig
    from repro.models import layers as JL
    from repro.models import mamba2 as JM2
    from repro.models import transformer as JT
    from repro.optim import make_optimizer, make_schedule
    from repro.serve import decode as JDEC
    from repro.sharding.compat import make_mesh
    from repro.sharding.plan import test_plan
    from repro.train.step import build_train_step

    save = JaxSide.saver(out_dir)
    JT.embed_inputs = functools.partial(JT.embed_inputs, dtype=jnp.float32)
    JM2.init_mamba2_cache = functools.partial(JM2.init_mamba2_cache,
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
    cfg = cfg_of("jax")

    def load():
        return jax.tree.map(jnp.asarray,
                            unflat(dict(np.load(params_file(out_dir)))))

    params = load()
    toks = jnp.asarray(prompts())
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
    save("serve", {"tokens": np.stack(out, -1), "logits": np.stack(logits)})

    params = load()                 # a train step donates its parameters
    batch = {k: jnp.asarray(v) for k, v in train_batch(cfg).items()}
    tcfg = TrainConfig(global_batch_size=GB, seq_len=SEQ, lr=LR,
                       warmup_steps=WARMUP, grad_clip=1.0)
    opt = make_optimizer("lamb")
    step_fn, _ = build_train_step(
        cfg, tcfg, plan, opt, make_schedule("cosine", LR, WARMUP, HORIZON),
        params, batch, mesh=mesh)
    p, _, m = step_fn(params, opt.init(params), batch, jnp.int32(1))
    out = {f"p/{k}": v for k, v in flat(jax.tree.map(np.asarray, p)).items()}
    out.update({k: m[k] for k in ("loss", "ce", "grad_norm")})
    save("train", out)


# =============================================================================
# Fixtures and rank tasks
# =============================================================================

@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax")
    np.savez(params_file(out), **flat(jax_layout_params()))
    js = JaxSide("test_torch_mamba2_mesh", out)
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


def _rank_params(file, train=False):
    from repro_torch.sharding import comm
    from repro_torch.sharding import specs as S_
    from repro_torch.sharding.plan import plan_from_mesh
    from repro_torch.weights import params_from_jax
    mesh = comm.bound_mesh()
    plan = plan_from_mesh(mesh)
    cfg = cfg_of()
    full = params_from_jax(unflat(dict(np.load(file))), cfg, device="cpu",
                           compute_cast=not train)
    return (S_.shard_params(full, S_.param_specs(full, cfg, plan), mesh),
            cfg, plan, mesh)


def _serve_task(rank, file):
    from repro_torch.launch.serve import generate
    from repro_torch.models import layers as TL
    from repro_torch.models import mamba2 as TM2
    from repro_torch.sharding import specs as S_
    TM2.init_mamba2_cache = functools.partial(TM2.init_mamba2_cache,
                                              dtype=torch.float32)
    TL.init_attention_cache = functools.partial(TL.init_attention_cache,
                                                dtype=torch.float32)
    params, cfg, plan, mesh = _rank_params(file)
    toks = torch.from_numpy(prompts())
    toks = S_.shard_params(toks, S_.batch_specs(toks, plan), mesh)
    res = generate(params, toks, cfg, plan, new_tokens=NEW, keep_logits=True)
    return {"tokens": res.tokens, "logits": res.logits,
            "dp_index": mesh.index("data"), "tp_index": mesh.index("model"),
            "wire": res.wire,
            "heads": params["stages"][0]["mamba"][0][0]["mamba"]["A_log"]
            .numel()}


def _train_task(rank, file, zero1):
    from repro_torch.common.config import TrainConfig
    from repro_torch.optim import make_optimizer, make_schedule
    from repro_torch.train.step import build_train_step, zero1_state
    from repro_torch.weights import params_to_jax
    params, cfg, plan, mesh = _rank_params(file, train=True)
    batch = train_batch(cfg)
    opt = make_optimizer("lamb")
    tcfg = TrainConfig(global_batch_size=GB, seq_len=SEQ, lr=LR,
                       warmup_steps=WARMUP, grad_clip=1.0)
    step = build_train_step(cfg, tcfg, plan, opt,
                            make_schedule("cosine", LR, WARMUP, HORIZON),
                            params, batch, mesh=mesh, zero1=zero1)
    state = zero1_state(params, cfg, plan) if zero1 else opt.init(params)
    params, _, m = step(params, state, batch, 1)
    whole = flat(params_to_jax(params, cfg=cfg, mesh=mesh))
    return {"metrics": {k: float(v) for k, v in m.items()},
            "params": whole if rank.rank == 0 else None}


# =============================================================================
# Tests
# =============================================================================

def test_mesh_serve_matches_jax(ranks, jax_side):
    from repro_torch.launch.serve import gather_logits, gather_rows
    got = ranks.run(_serve_task, params_file(jax_side.out),
                    timeout_s=TIMEOUT_S)
    ref = jax_side.get("serve", timeout_s=TIMEOUT_S)
    assert all(r["heads"] == 8 for r in got)       # 16 SSM heads over 2
    tokens = gather_rows(got)
    assert tokens.shape == ref["tokens"].shape == (B, NEW)
    np.testing.assert_array_equal(tokens, ref["tokens"])
    lg = gather_logits(got)
    rel = np.abs(lg - ref["logits"]).max() / np.abs(ref["logits"]).max()
    assert rel <= LOGITS_REL, rel
    # the gated norm's sum of squares and the row-parallel outputs
    assert got[0]["wire"]["decode"]["psum model float32"]["calls"] > 0


def test_mesh_training_step_matches_jax(ranks, jax_side):
    """One LAMB step over the mesh, plain and under ZeRO-1, against JAX's:
    the loss, ``ce`` and the gradient norm, and every parameter gathered
    whole."""
    file = params_file(jax_side.out)
    plain = ranks.run(_train_task, file, False, timeout_s=TIMEOUT_S)
    zero1 = ranks.run(_train_task, file, True, timeout_s=TIMEOUT_S)
    ref = jax_side.get("train", timeout_s=TIMEOUT_S)
    for r in plain + zero1:
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(r["metrics"][k], float(ref[k]),
                                       rtol=LOSS_REL, err_msg=k)
    want = {k[2:]: v for k, v in ref.items() if k.startswith("p/")}
    p, z = plain[0]["params"], zero1[0]["params"]
    assert set(p) == set(z) == set(want)
    assert p["stages/0/mamba/mamba/wx"].shape == (2, 2, 256, 512)
    for k, v in want.items():
        np.testing.assert_allclose(p[k], v, rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)
        np.testing.assert_allclose(z[k], p[k], rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)
