"""Fault containment over ``torch.distributed`` ranks, on the CPU: the
port's fault injection and checksummed ragged wire against
``tests/distributed/_faults.py``'s matrix and the JAX package.

Eight gloo ranks (a module-wide :class:`RankPool`) hold a ``(data 4,
model 2)`` mesh, as in ``tests/test_torch_mesh.py``, and run
``_faults.py``'s layer (``base_cfg``: 16 experts top-2 over ``top_g`` 2,
grid (4, 4), dropless with ragged hops, d 32, 64 tokens, parameters drawn
with numpy) for Switch and SMILE:

* every cell of the matrix, held to ``_faults.py``'s exact assertions
  (event counts, per-(hop, source rank) localization, drop fractions of
  exactly ``1/P``, bit-equality of the healthy policies and of the inert
  plan with the plain path, finite outputs), the expectations drawn from
  the port's own site selectors;
* a subset of the cells against the JAX package's ``shard_map`` on 8 fake
  devices (one subprocess, ``JaxSide``, with the native ragged All2All
  emulated and ``faultinject._rng`` seeded as the port seeds it, which
  Python 3.12 needs): the integer statistics and drop fractions equal, the
  outputs within ``test_torch_mesh.py``'s MoE tolerance, NaN where JAX has
  NaN.  No output is compared where the believed counts pass the sent
  segment (``inflate`` and ``dupseg`` under ``off`` or ``detect``): there
  the reference reads the sender's next staged rows and the port zeros;
* a ``counts`` plan on the gloo wire, which must quarantine without
  hanging (the exchange moves what the peers send and lays out what the
  receiver believes);
* a bounded hop (``recv_bound_factor``) under ``dropseg:0`` against JAX;
* the plain path (no plan, wire off) pinned to the bits and the
  collectives the tree before the harness gave.
"""
import hashlib
import random
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.common import faultinject as FI
from repro_torch.launch.mesh import RankPool
from repro_torch.sharding import comm
from test_torch_mesh import JaxSide

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import check_fault_cell, fault_cells  # noqa: E402

MESH = ((4, 2), ("data", "model"))
WORLD = NDEV = 8
D = 32
TOKENS = 64
MOE_REL = 1e-5             # fp32 MoE outputs and statistics (test_torch_mesh)
TIMEOUT_S = 120
REPAIR_TIMEOUT_S = 30
# level -> (P, groups a rank) of each hop on this mesh (_faults.py's HOPS)
HOPS = {"switch": {0: (8, 2)}, "smile": {0: (4, 1), 1: (2, 2)}}
BOUND = 0.5                # the bounded cell's recv_bound_factor


def base_kw(router):
    return dict(num_experts=16, top_k=2, top_g=2, d_ff_expert=64,
                capacity_factor=16.0, router=router, grid=(4, 4),
                renorm_gates=True, dispatch_backend="dropless",
                ragged_a2a=True)


def cells(router):
    """name -> with_options kwargs: _faults.py's matrix for ``router``
    (``chip_smoke.fault_cells``, which phase 19 runs on the card)."""
    return fault_cells(sorted(HOPS[router]))


# the cells held against JAX (no output compared where a belief passes the
# sent segment: none of these)
JAX_CELLS = {
    "smile": ["healthy", "healthy-detect", "healthy-quarantine", "counts",
              "dropseg:1", "skew", "nanrows", "quarantine-bitflip:0",
              "quarantine-inflate:1", "quarantine-dupseg:0",
              "quarantine-nanrows:0", "quarantine-counts",
              "detect-bitflip:0"],
    "switch": ["healthy", "counts", "dropseg:0", "quarantine-dupseg:0",
               "detect-bitflip:0"],
}
BOUNDED = ("smile", {"recv_bound_factor": BOUND, "fault_plan": "dropseg:0"})


def rng_shim(fp, level, *tag):
    """``faultinject._rng`` as the port derives it (a str seed, which
    Python 3.12 takes; the JAX package's tuple seed it refuses)."""
    return random.Random(repr((fp.seed, fp.kind, level) + tag))


def layer_inputs(router):
    """Full parameters in both packages' layout, and the 64 tokens."""
    rng = np.random.default_rng({"switch": 0, "smile": 1}[router])
    kw = base_kw(router)
    n_g, E, f = kw["grid"][0], kw["num_experts"], kw["d_ff_expert"]

    def normal(shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    p = {"experts": {"w1": normal((n_g, E // n_g, D, f), D),
                     "w2": normal((n_g, E // n_g, f, D), f)}}
    if router == "smile":
        p["router_inter"] = {"w": normal((D, n_g), D)}
        p["router_intra"] = {"w": normal((D, E // n_g), D)}
    else:
        p["router"] = {"w": normal((D, E), D)}
    return p, rng.standard_normal((TOKENS, D)).astype(np.float32)


STAT_KEYS = ("drop_frac", "hop_drop_frac", "fault_events", "hop_max_load",
             "hop_load_entropy", "wire_faults")


# =============================================================================
# The JAX side (a subprocess with 8 fake devices)
# =============================================================================

def _jax_main(out_dir: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as Pspec

    from repro.common import faultinject as JFI
    from repro.common.config import MoEConfig
    from repro.core.moe import moe_layer
    from repro.sharding.compat import make_mesh, shard_map
    from repro.sharding.plan import test_plan

    JFI._rng = rng_shim
    mesh = make_mesh(*MESH)
    plan = test_plan(n_inter=4, n_intra=2)
    save = JaxSide.saver(out_dir)
    espec = Pspec("data", "model", None, None)
    todo = [(r, c, cells(r)[c]) for r in ("smile", "switch")
            for c in JAX_CELLS[r]]
    todo.append((BOUNDED[0], "bounded", BOUNDED[1]))
    for router, name, opts in todo:
        cfg = MoEConfig(**base_kw(router)).with_options(**opts)
        params, x = layer_inputs(router)
        pspecs = {k: ({"w1": espec, "w2": espec} if k == "experts"
                      else {"w": Pspec(None, None)}) for k in params}

        def f(params, x):
            y, st = moe_layer(params, x, cfg, plan, act="gelu")
            return y, {k: getattr(st, k) for k in STAT_KEYS}

        fn = jax.jit(shard_map(
            f, mesh=mesh, in_specs=(pspecs, Pspec(("data", "model"), None)),
            out_specs=(Pspec(("data", "model"), None),
                       {k: Pspec() for k in STAT_KEYS})))
        try:
            y, st = fn(jax.tree.map(jnp.asarray, params), jnp.asarray(x))
            save(f"{router}/{name}", {"y": y, **st})
        except Exception as e:                     # noqa: BLE001
            save(f"{router}/{name}", {"error": np.asarray(repr(e)[:2000])})


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    js = JaxSide("test_torch_faults", tmp_path_factory.mktemp("jax"))
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


def _layer_task(rank, router, opts):
    """The layer on this rank's 8 tokens under ``opts``: its output rows,
    the statistics, and the wire log's calls."""
    from repro_torch.common.config import MoEConfig
    from repro_torch.core.moe import moe_layer
    from repro_torch.sharding.plan import test_plan
    from repro_torch.sharding.specs import shard_leaf
    cfg = MoEConfig(**base_kw(router)).with_options(**opts)
    params, x = layer_inputs(router)
    mesh = comm.bound_mesh()
    espec = ("data", "model", None, None)
    tp = {k: {n: shard_leaf(torch.from_numpy(v), espec if k == "experts"
                            else (None, None), mesh)
              for n, v in d.items()} for k, d in params.items()}
    n = TOKENS // WORLD
    xl = torch.from_numpy(x[rank.rank * n:(rank.rank + 1) * n])
    mesh.wire.reset()
    with torch.inference_mode():
        y, st = moe_layer(tp, xl, cfg, test_plan(4, 2), act="gelu")
    return (y.numpy(), {k: getattr(st, k).numpy() for k in STAT_KEYS},
            mesh.wire.summary())


_RUNS = {}


def port_run(ranks, router, name, opts=None):
    """The cell's global output and statistics (each rank's statistics
    must be rank 0's: they are psum'd), run once a module."""
    key = (router, name)
    if key not in _RUNS:
        got = ranks.run(_layer_task, router,
                        cells(router)[name] if opts is None else opts,
                        timeout_s=TIMEOUT_S)
        for r, g in enumerate(got):
            for k in STAT_KEYS:
                np.testing.assert_array_equal(g[1][k], got[0][1][k],
                                              err_msg=f"rank {r} {k}")
        _RUNS[key] = dict(y=np.concatenate([g[0] for g in got]),
                          wire=[g[2] for g in got], **got[0][1])
    return _RUNS[key]


# =============================================================================
# Tests
# =============================================================================

MATRIX = [(router, name) for router in ("switch", "smile")
          for name in cells(router)]


@pytest.mark.parametrize("router,name", MATRIX,
                         ids=[f"{r}-{n}" for r, n in MATRIX])
def test_fault_matrix(router, name, ranks):
    y0 = port_run(ranks, router, "healthy")["y"]
    check_fault_cell(name, port_run(ranks, router, name), y0, HOPS[router],
                     NDEV)


def _against_jax(r, ref, what):
    assert "error" not in ref, f"{what}: the JAX side raised {ref['error']}"
    for k in ("fault_events", "wire_faults", "drop_frac", "hop_drop_frac"):
        np.testing.assert_array_equal(r[k], ref[k], err_msg=f"{what} {k}")
    for k in ("hop_max_load", "hop_load_entropy"):
        np.testing.assert_allclose(r[k], ref[k], rtol=MOE_REL, atol=MOE_REL,
                                   err_msg=f"{what} {k}")
    y, want = r["y"], ref["y"]
    np.testing.assert_array_equal(np.isnan(y), np.isnan(want),
                                  err_msg=f"{what} NaN rows")
    ok = ~np.isnan(want)
    scale = max(float(np.abs(want[ok]).max()), 1e-30)
    err = float(np.abs(y[ok].astype(np.float64) - want[ok]).max()) / scale
    assert err <= MOE_REL, f"{what} y: {err:.3e} of max |ref| > {MOE_REL}"


JAX_MATRIX = [(r, n) for r in JAX_CELLS for n in JAX_CELLS[r]]


@pytest.mark.parametrize("router,name", JAX_MATRIX,
                         ids=[f"{r}-{n}" for r, n in JAX_MATRIX])
def test_cell_matches_jax(router, name, ranks, jax_side):
    _against_jax(port_run(ranks, router, name),
                 jax_side.get(f"{router}/{name}"), f"{router} {name}")


def test_bounded_hop_under_dropseg_matches_jax(ranks, jax_side):
    router, opts = BOUNDED
    r = port_run(ranks, router, "bounded", opts)
    _against_jax(r, jax_side.get(f"{router}/bounded"), "bounded dropseg:0")
    Pn = HOPS[router][0][0]
    assert r["hop_drop_frac"][0] >= np.float32(1.0 / Pn)


def test_counts_plan_on_the_wire_quarantines_without_hanging(ranks):
    """The receiver's sanitizer zeroes the poisoned sources' counts while
    the peers still send their segments: the exchange must move what they
    send (a mismatch hangs or fails gloo's all_to_all_single)."""
    got = ranks.run(_layer_task, "smile", {"fault_plan": "counts@3"},
                    timeout_s=REPAIR_TIMEOUT_S)
    fp = FI.parse_fault_plan("counts@3")
    want = [NDEV * FI.expected_count_events(fp, lvl, *HOPS["smile"][lvl])
            for lvl in (0, 1)]
    for y, st, _ in got:
        np.testing.assert_array_equal(st["fault_events"], want)
        assert st["drop_frac"] > 0.0 and np.isfinite(y).all()


# the plain path's output and statistics (a SHA-256 of their bytes, its
# first 16 hex digits) and its collectives on rank 0 (op axes dtype ->
# (calls, rows, bytes)), as the tree before the fault harness gave them
PLAIN_DIGEST = {"switch": "67cc751881af9465", "smile": "717d47f2ea45f544"}
PLAIN_WIRE = {
    "switch": {"all_to_all data+model int32": (1, 7, 56),
               "psum data+model float32": (4, 35, 140),
               "ragged_all_to_all data+model float32": (2, 168, 21504)},
    "smile": {"all_to_all data int32": (1, 3, 12),
              "all_to_all model int32": (1, 1, 8),
              "psum data+model float32": (7, 20, 80),
              "ragged_all_to_all data float32": (2, 48, 6144),
              "ragged_all_to_all model float32": (2, 128, 16384)},
}


@pytest.mark.parametrize("router", ["switch", "smile"])
def test_plain_path_is_unchanged(router, ranks):
    """No plan and the wire off: the plain path's bits and collectives; the
    healthy detect and quarantine runs give its bits, with one more psum
    (of the source counts) a layer, and under quarantine a count exchange
    (the reverse echoes the kept counts) and two drop psums a ragged
    hop."""
    r = port_run(ranks, router, "healthy")
    h = hashlib.sha256(r["y"].tobytes())
    for k in sorted(STAT_KEYS):
        h.update(r[k].tobytes())
    assert h.hexdigest()[:16] == PLAIN_DIGEST[router]
    wire = {k: (e["calls"], e["rows"], e["bytes"])
            for k, e in r["wire"][0].items()}
    assert wire == PLAIN_WIRE[router], wire
    calls = {k: e["calls"] for k, e in r["wire"][0].items()}
    for pol in ("detect", "quarantine"):
        w = port_run(ranks, router, f"healthy-{pol}")
        np.testing.assert_array_equal(w["y"], r["y"])
        for k in STAT_KEYS:
            np.testing.assert_array_equal(w[k], r[k], err_msg=k)
        extra = {k: e["calls"] - calls.get(k, 0)
                 for k, e in w["wire"][0].items()
                 if e["calls"] != calls.get(k, 0)}
        hops = [k for k in calls if k.startswith("all_to_all")
                and k.endswith("int32")]
        want = {"psum data+model float32": 1}
        if pol == "quarantine":
            # and each hop's drop accounting: two psums
            want = {"psum data+model float32": 1 + 2 * len(hops),
                    **{k: 1 for k in hops}}
        assert extra == want, extra
