"""The dry run on the meta device against the JAX package's, on the CPU.

* The meta device: ``resolve_device`` takes ``"meta"`` only by name; the
  parameters drawn on the CPU for a fixed seed keep their bits (digests of
  the draw before the meta device was taken); on meta they have the CPU
  draw's names, shapes and dtypes and no storage.
* Parameters at full size: for all ten assigned configs the port's meta
  parameters (``launch.inputs.params_struct``) equal
  ``repro.launch.inputs.params_struct(cfg, single_device_plan())`` leaf by
  leaf (names through ``weights.state_leaves``, stacked shapes, dtypes).
* A rank's slices at reduced size under a ``(2, 2)`` plan: the local
  shapes of the parameters, the decode caches and the batches equal the
  JAX package's specs applied to its shapes.
* ``dot_flops`` of one prefill against ``repro.launch.hlo_analysis.
  analyze_hlo`` of the same forward compiled on the CPU: equal at 1,024
  tokens for reduced qwen1.5-0.5b and reduced qwen3-moe-30b-a3b (sort
  dispatch); at 16 tokens the JAX package's attention pads its key chunk
  to 1,024 (``chunked_attention(chunk=1024)``), and the difference is
  exactly those padded keys' two dots a layer.
* All-to-all bytes of the reduced qwen3-moe prefill on a ``(2, 2)`` fake
  mesh against ``analyze_hlo`` of the JAX program lowered on 4 fake CPU
  devices (one subprocess): equal in fp32; in bf16 XLA:CPU widens every
  bf16 collective to fp32 before it runs, so the JAX count is the port's
  with each bf16 payload counted twice.
* The CLI writes its JSON (a decode step of qwen1.5-0.5b over the
  production mesh, a few seconds).

Nothing here imports ``repro.launch.dryrun``, which rewrites
``XLA_FLAGS`` at import.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.common.config import InputShape
from repro_torch.common.device import resolve_device
from repro_torch.configs import ASSIGNED, get_config, get_reduced
from repro_torch.launch import cost_analysis as CA
from repro_torch.launch import inputs as I
from repro_torch.models.transformer import init_model
from repro_torch.optim import leaf_groups
from repro_torch.sharding import specs as S
from repro_torch.sharding.plan import single_device_plan, test_plan
from repro_torch import weights as W
from test_torch_mesh import JaxSide

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
QWEN3 = "qwen3-moe-30b-a3b"
JAX_KEY_CHUNK = 1024     # repro.models.layers.chunked_attention's chunk
# sha256 (first 32 hex digits) of every leaf's key and bytes of
# init_model(get_reduced(arch), single_device_plan(), seed=3, device="cpu",
# compute_cast=cc), taken on the tree before the meta device was accepted
CPU_DIGESTS = {
    ("qwen3-moe-30b-a3b", False): "f92e56027385b84de0d8df7afc5e7ea6",
    ("qwen3-moe-30b-a3b", True): "531dfcd0982445c7d74236d417911766",
    ("deepseek-v3-671b", False): "66e06e814e09da3406d9d010357dfd34",
    ("deepseek-v3-671b", True): "6157b2b5d6aed3c43dd1afaf002ecc8d",
    ("zamba2-2.7b", False): "cd636b928da06260ba0215a33df1b68c",
    ("zamba2-2.7b", True): "77ea57bcd6ba3fa8641a2044f1ee9a3b",
}


def _digest(params) -> str:
    import hashlib
    h = hashlib.sha256()
    for leaf in W.state_leaves(params):
        for t in leaf.tensors:
            h.update(leaf.key.encode())
            h.update(t.detach().contiguous().view(torch.uint8).numpy()
                     .tobytes())
    return h.hexdigest()[:32]


# =============================================================================
# The meta device
# =============================================================================

def test_meta_device_only_by_name():
    assert resolve_device("meta").type == "meta"
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("mps")


@pytest.mark.parametrize("arch,cc", sorted(CPU_DIGESTS))
def test_cpu_draw_keeps_its_bits(arch, cc):
    p = init_model(get_reduced(arch), single_device_plan(), seed=3,
                   device="cpu", compute_cast=cc)
    assert _digest(p) == CPU_DIGESTS[(arch, cc)]


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "zamba2-2.7b",
                                  "musicgen-large"])
def test_meta_draw_is_the_cpu_draw_without_storage(arch):
    cfg = get_reduced(arch)
    cpu = W.state_leaves(init_model(cfg, single_device_plan(),
                                    device="cpu"))
    meta = W.state_leaves(init_model(cfg, single_device_plan(),
                                     device="meta"))
    assert [l.key for l in meta] == [l.key for l in cpu]
    for m, c in zip(meta, cpu):
        for tm, tc in zip(m.tensors, c.tensors):
            assert tm.device.type == "meta"
            assert (tm.shape, tm.dtype) == (tc.shape, tc.dtype)


# =============================================================================
# Parameters at full size, against the JAX package
# =============================================================================

def _jax_name(path) -> str:
    parts = []
    for k in path:
        for attr in ("key", "idx", "name"):
            if hasattr(k, attr):
                parts.append(str(getattr(k, attr)))
                break
    return "/".join(parts)


def _jax_leaves(tree):
    import jax
    return {_jax_name(p): x for p, x in
            jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def jax_full_params():
    from repro.configs import get_config as jget
    from repro.launch.inputs import params_struct
    from repro.sharding.plan import single_device_plan as jsp
    return {a: {k: (tuple(x.shape), str(x.dtype)) for k, x in
                _jax_leaves(params_struct(jget(a), jsp())[0]).items()}
            for a in ASSIGNED}


@pytest.mark.parametrize("arch", ASSIGNED)
def test_full_size_meta_params_match_jax(arch, jax_full_params):
    params, _ = I.params_struct(get_config(arch), single_device_plan())
    got = {l.key[2:]: (W.global_shape(l), str(l.tensors[0].dtype)
                       .replace("torch.", ""))
           for l in W.state_leaves(params)}
    assert all(t.device.type == "meta" for t in
               (x for l in W.state_leaves(params) for x in l.tensors))
    assert got == jax_full_params[arch]


# =============================================================================
# A rank's slices under a (2, 2) plan, at reduced size
# =============================================================================

SMALL = {"train": InputShape("t", 32, 4, "train"),
         "prefill": InputShape("p", 32, 4, "prefill"),
         "decode": InputShape("d", 32, 4, "decode")}


def _pad(spec, nd):
    spec = tuple(spec)
    return spec + (None,) * (nd - len(spec))


def _jax_local(struct_tree, spec_tree, plan):
    import jax
    specs = {_jax_name(p): s for p, s in jax.tree_util.tree_leaves_with_path(
        spec_tree, is_leaf=lambda x: type(x).__name__ == "PartitionSpec")}
    return {k: S.local_shape(tuple(x.shape), _pad(specs[k], x.ndim), plan)
            for k, x in _jax_leaves(struct_tree).items()}


def _stacked(tree, prefix=""):
    """The port's per-block lists stacked as the JAX package stacks them:
    ``{name: shape}``."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_stacked(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, tuple):
        out = {}
        for i, v in enumerate(tree):
            out.update(_stacked(v, f"{prefix}{i}/"))
        return out
    if isinstance(tree, list):
        subs = [_stacked(v, prefix) for v in tree]
        return {k: (len(tree),) + s for k, s in subs[0].items()}
    return {prefix[:-1]: tuple(tree.shape)}


@pytest.mark.parametrize("arch", ASSIGNED)
def test_rank_local_shapes_match_jax_specs(arch):
    from repro.configs import get_reduced as jred
    from repro.launch import inputs as JI
    from repro.sharding.plan import test_plan as jplan
    cfg, jcfg = get_reduced(arch), jred(arch)
    plan, jp = test_plan(2, 2), jplan(2, 2)
    # parameters: the rank's slice of each leaf, stacked dims first
    params, pspec = I.params_struct(cfg, plan)
    got = {g.name.replace(".", "/"): tuple(g.stack) + S.local_shape(
        tuple(g.pieces[0].shape), g.of(pspec), plan)
        for g in leaf_groups(params)}
    jps, jspec = JI.params_struct(jcfg, jp)
    assert got == _jax_local(jps, jspec, jp)
    # batches: a rank's rows
    from repro.common.config import InputShape as JShape
    jshape = {k: JShape(v.name, v.seq_len, v.global_batch, v.kind)
              for k, v in SMALL.items()}
    batch, bspec = I.train_batch_struct(cfg, SMALL["train"], plan)
    jb, jbspec = JI.train_batch_struct(jcfg, jshape["train"], jp)
    assert _stacked(I.local(batch, bspec, plan)) == _jax_local(jb, jbspec, jp)
    toks, tspec = I.prefill_batch_struct(cfg, SMALL["prefill"], plan)
    jt, jtspec = JI.prefill_batch_struct(jcfg, jshape["prefill"], jp)
    assert (tuple(I.local(toks, tspec, plan).shape)
            == S.local_shape(tuple(jt.shape), _pad(jtspec, jt.ndim), jp))
    if not cfg.causal:
        return
    # decode caches as a rank allocates them, and its tokens
    (tok, caches, _), (tspec, _) = I.decode_state_struct(
        cfg, SMALL["decode"], plan, rank=True)
    (jtok, jc, _), (jtspec, jcspec, _) = JI.decode_state_struct(
        jcfg, jshape["decode"], jp)
    assert _stacked(caches) == _jax_local(jc, jcspec, jp)
    assert (tuple(I.local(tok, tspec, plan).shape)
            == S.local_shape(tuple(jtok.shape), _pad(jtspec, jtok.ndim), jp))


# =============================================================================
# dot_flops against the JAX package's HLO count
# =============================================================================

def _jax_prefill_dot_flops(arch: str, B: int, T: int) -> float:
    import jax
    from repro.common.config import InputShape as JShape
    from repro.configs import get_reduced as jred
    from repro.launch import inputs as JI
    from repro.launch.hlo_analysis import analyze_hlo
    from repro.models.transformer import init_caches
    from repro.serve.decode import build_prefill
    from repro.sharding.plan import single_device_plan as jsp
    cfg = jred(arch)
    ps, _ = JI.params_struct(cfg, jsp())
    ts, _ = JI.prefill_batch_struct(cfg, JShape("p", T, B, "prefill"), jsp())
    cs = jax.eval_shape(lambda: init_caches(cfg, B, T, jsp()))
    fn = build_prefill(cfg, jsp(), ps, ts, cs)
    return analyze_hlo(fn.lower(ps, ts, cs).compile().as_text(), 1,
                       False).dot_flops


def _port_prefill(arch, B, T, mesh_shape=(), cfg=None):
    from repro_torch.launch import dryrun as D
    try:
        return D.run_step(arch, "prefill_32k",
                          cfg=cfg or get_reduced(arch),
                          shape=InputShape("p", T, B, "prefill"),
                          mesh_shape=mesh_shape,
                          mesh_axes=("data", "model") if mesh_shape else ())
    finally:
        D.leave_world()


def _padded_key_flops(cfg, B: int, T: int) -> float:
    """The two dots a layer over the JAX attention's key chunk padded
    from T to JAX_KEY_CHUNK keys: scores (B, H, C, T) over hd and the
    weighted values (B, H, hd, T) over C, of which the port computes the
    T real keys."""
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    return cfg.num_layers * 2 * (2.0 * B * H * (JAX_KEY_CHUNK - T) * T * hd)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", QWEN3])
def test_dot_flops_match_jax_hlo(arch):
    # at a multiple of the key chunk both count the same dots
    B, T = 1, JAX_KEY_CHUNK
    assert _port_prefill(arch, B, T)["dot_flops"] == \
        _jax_prefill_dot_flops(arch, B, T)
    # below it the JAX attention computes padded keys; the rest is equal
    B, T = 2, 16
    diff = _jax_prefill_dot_flops(arch, B, T) - \
        _port_prefill(arch, B, T)["dot_flops"]
    assert diff == _padded_key_flops(get_reduced(arch), B, T)


# =============================================================================
# All-to-all bytes against the JAX program on 4 fake devices
# =============================================================================

A2A_B, A2A_T = 4, 16


def _jax_main(out_dir):
    """The JAX side (a subprocess with 8 fake devices): analyze_hlo of the
    reduced qwen3-moe prefill lowered over a (2, 2) mesh of 4 of them, in
    fp32 and bf16."""
    import jax
    from repro.common.config import InputShape as JShape
    from repro.configs import get_reduced as jred
    from repro.launch import inputs as JI
    from repro.launch.hlo_analysis import analyze_hlo, collective_summary
    from repro.models.transformer import init_caches
    from repro.serve.decode import build_prefill
    from repro.sharding.plan import plan_from_mesh
    from repro.sharding.specs import cache_specs
    save = JaxSide.saver(out_dir)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                             ("data", "model"))
    plan = plan_from_mesh(mesh)
    shape = JShape("p", A2A_T, A2A_B, "prefill")
    for dtype in ("float32", "bfloat16"):
        cfg = jred(QWEN3).replace(dtype=dtype)
        ps, _ = JI.params_struct(cfg, plan, mesh)
        ts, _ = JI.prefill_batch_struct(cfg, shape, plan, mesh)
        cshapes = jax.eval_shape(lambda: init_caches(cfg, A2A_B, A2A_T,
                                                     plan))
        cs = JI._sds(cshapes, cache_specs(cshapes, cfg, plan, A2A_B), mesh)
        fn = build_prefill(cfg, plan, ps, ts, cs, mesh=mesh)
        costs = analyze_hlo(fn.lower(ps, ts, cs).compile().as_text(), 4,
                            False)
        summ = collective_summary(costs)
        save(f"a2a/{dtype}", {k.replace("-", "_"): v for k, v in
                              summ["bytes_per_op"].items()})


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    js = JaxSide("test_torch_dryrun", tmp_path_factory.mktemp("jax"))
    yield js
    js.close()


def test_all_to_all_bytes_match_jax_on_four_devices(jax_side):
    for dtype in ("float32", "bfloat16"):
        r = _port_prefill(QWEN3, A2A_B, A2A_T, mesh_shape=(2, 2),
                          cfg=get_reduced(QWEN3).replace(dtype=dtype))
        a2a = [c for c in r["collectives"] if c.op == "all-to-all"]
        assert a2a and all(c.group == 2 and not c.inter for c in a2a)
        got = sum(c.bytes * c.count for c in a2a)
        want = float(jax_side.get(f"a2a/{dtype}")["all_to_all"])
        if dtype == "float32":
            assert got == want
        else:
            # XLA:CPU runs a bf16 all-to-all as fp32: each bf16 payload's
            # bytes twice over
            bf16 = sum(c.bytes for c, t in zip(a2a, [
                t for t in r["trace"] if CA.op_class(t.op) == "all-to-all"])
                if t.dtype == "bfloat16")
            assert bf16 > 0 and got + bf16 == want


def test_group_spans_nodes_by_blocks_of_eight():
    # rank 0 of the 16 x 16 production mesh: its model group is ranks
    # 0-15 (two nodes), its data group every 16th rank
    model = CA.group_ranks((16, 16), ("data", "model"), ("model",), 0)
    assert model == list(range(16)) and CA.spans_nodes(model)
    assert not CA.spans_nodes(list(range(8)))
    assert CA.group_ranks((16, 16), ("data", "model"), ("data",), 0) == \
        list(range(0, 256, 16))


# =============================================================================
# The CLI
# =============================================================================

def test_cli_writes_its_json(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen1.5-0.5b", "--shape", "decode_32k", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads((tmp_path / "qwen1.5-0.5b__decode_32k__single.json")
                     .read_text())
    assert res["mesh"] == "16x16" and res["world"] == 256
    assert res["dot_flops"] > 0 and res["traffic_bytes"] > 0
    mem = res["memory"]
    assert mem["argument_bytes"] > 0 and mem["temp_bytes"] > 0
    assert res["fits"] == (mem["peak_bytes"] <= res["hbm_bytes"])
    coll = res["collectives"]
    for key in ("intra_node_peer_bytes", "inter_node_peer_bytes"):
        assert set(coll[key]) == set(CA.CLASSES)
    assert math.isclose(sum(coll["bytes_per_op"].values()),
                        sum(res["collectives_by_group"].values()))
