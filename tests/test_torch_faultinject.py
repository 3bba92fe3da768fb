"""The port's fault-injection harness and parity-row wire format against
the JAX package's, in one process on the CPU.

* ``parse_fault_plan`` on valid and malformed specs;
* every site selector, over a sweep of (seed, level, P, nl), with the
  JAX package's ``faultinject._rng`` seeded as the port seeds it (its
  tuple seed is refused by Python 3.11 and later);
* every injector, element by element, on count grids and slabs drawn with
  numpy ``default_rng``;
* ``int_lane_view``, ``words_to_rows``, ``stored_words`` and
  ``segment_parity_words`` bit for bit in fp32 and bf16, with lengths and
  tags whose terms wrap int32;
* the one-device checksummed exchange and its split.
"""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import faultinject as JFI
from repro.core import pipeline as JP
from repro.sharding import comm as JC
from repro_torch.common import faultinject as FI
from repro_torch.common.config import MoEConfig
from repro_torch.core import pipeline as TP
from repro_torch.sharding import comm as TC


@pytest.fixture(autouse=True)
def jax_rng(monkeypatch):
    """The JAX package's site RNG seeded as the port seeds it."""
    monkeypatch.setattr(JFI, "_rng", lambda fp, level, *tag: random.Random(
        repr((fp.seed, fp.kind, level) + tag)))


def _np(x):
    """Bits of a tensor or array as numpy (16-bit floats as int16)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.itemsize == 2 and a.dtype.kind == "V" \
        or str(a.dtype) == "bfloat16" else a


def _eq(t, j, what=""):
    np.testing.assert_array_equal(_np(t), _np(j), err_msg=what)


def _pair(x, dtype):
    """``x`` as a torch tensor and a JAX array of ``dtype`` with the same
    bits (the packages round NaN to bf16 differently)."""
    j = jnp.asarray(x).astype(dtype)
    if dtype == "float32":
        return torch.from_numpy(np.array(x, np.float32)), j
    bits = np.asarray(j).view(np.int16).copy()
    return torch.from_numpy(bits).view(torch.bfloat16), j


VALID_SPECS = ["counts", "nanrows", "dropseg", "skew", "bitflip", "inflate",
               "dupseg", "counts@3", "bitflip:1", "dupseg@12:0", " skew@-4 ",
               "nanrows:-1", "none", "off", "", None]
BAD_SPECS = ["count", "counts@x", "counts:y", "counts:-2", "bitflip@1@2",
             "@3", ":0", "nanrows:0:1"]


@pytest.mark.parametrize("spec", VALID_SPECS)
def test_parse_valid_like_reference(spec):
    assert FI.parse_fault_plan(spec) == (
        None if JFI.parse_fault_plan(spec) is None
        else FI.FaultPlan(**dataclasses.asdict(JFI.parse_fault_plan(spec))))
    p = FI.parse_fault_plan(spec)
    if p is not None:
        jp = JFI.parse_fault_plan(spec)
        assert p.wants_echo == jp.wants_echo
        assert [p.targets(lv) for lv in (0, 1)] == [jp.targets(lv)
                                                     for lv in (0, 1)]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_parse_rejects_like_reference(spec):
    with pytest.raises(ValueError):
        JFI.parse_fault_plan(spec)
    with pytest.raises(ValueError):
        FI.parse_fault_plan(spec)
    # and MoEConfig.with_options validates it (the CLI's --fault-plan)
    with pytest.raises(ValueError):
        MoEConfig().with_options(fault_plan=spec)


def test_constants_are_the_references():
    assert FI.FAULT_KINDS == JFI.FAULT_KINDS
    assert (FI.COUNT_POISON, FI.N_COUNT_FAULTS, FI.N_NAN_ROWS) == (
        JFI.COUNT_POISON, JFI.N_COUNT_FAULTS, JFI.N_NAN_ROWS)
    assert (TC.WIRE_LEN_MULT, TC.WIRE_TAG_MULT) == (JC.WIRE_LEN_MULT,
                                                    JC.WIRE_TAG_MULT)
    assert TP.WIRE_SRC_BINS == JP.WIRE_SRC_BINS


def test_rng_is_stable_across_processes():
    """A str seed is hashed with SHA-512 (no salt): these draws are fixed."""
    fp = FI.FaultPlan("bitflip", 0, -1)
    assert [FI.wire_victim(fp, lv, 8) for lv in (0, 1)] == [
        random.Random(repr((0, "bitflip", lv, 8))).randrange(8)
        for lv in (0, 1)]
    import subprocess
    import sys
    code = ("import random; print(random.Random(repr((0, 'counts', 1, 4, 2)))"
            ".sample(range(8), 2))")
    a = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env={"PYTHONHASHSEED": "1"}).stdout
    b = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env={"PYTHONHASHSEED": "2"}).stdout
    assert a == b and a.strip()


SWEEP = [(seed, level, P, nl) for seed in (0, 1, 7) for level in (0, 1)
         for P, nl in ((1, 1), (2, 2), (4, 1), (8, 2), (16, 3))]
SELECTORS = ["count_fault_sites", "expected_count_events", "dropseg_victim",
             "nan_row_sites", "skew_target", "wire_victim", "inflate_site",
             "wire_fault_victim"]


@pytest.mark.parametrize("name", SELECTORS)
def test_site_selectors_match(name):
    for kind in FI.FAULT_KINDS:
        for seed, level, P, nl in SWEEP:
            fp, jp = FI.FaultPlan(kind, seed), JFI.FaultPlan(kind, seed)
            args = {"count_fault_sites": (P, nl),
                    "expected_count_events": (P, nl),
                    "dropseg_victim": (P,), "nan_row_sites": (P * nl + 5,),
                    "skew_target": (P * nl,), "wire_victim": (P,),
                    "inflate_site": (P, nl),
                    "wire_fault_victim": (P, nl)}[name]
            assert getattr(FI, name)(fp, level, *args) == getattr(
                JFI, name)(jp, level, *args), (name, kind, seed, level, P, nl)
    assert FI.expected_nan_rows() == JFI.expected_nan_rows()


def _grid(seed, P, nl):
    return np.random.default_rng(seed).integers(0, 40, (P, nl)).astype(
        np.int32)


@pytest.mark.parametrize("name", ["corrupt_len_grid", "drop_segment",
                                  "inflate_grid", "dup_grid"])
def test_grid_injectors_match(name):
    kind = {"corrupt_len_grid": "counts", "drop_segment": "dropseg",
            "inflate_grid": "inflate", "dup_grid": "dupseg"}[name]
    for seed, level, P, nl in SWEEP:
        g = _grid(seed + level, P, nl)
        tg = torch.from_numpy(g)
        t = getattr(FI, name)(FI.FaultPlan(kind, seed), level, tg)
        j = getattr(JFI, name)(JFI.FaultPlan(kind, seed), level,
                               jnp.asarray(g))
        _eq(t, j, f"{name} {seed} {level} {P} {nl}")
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(tg.numpy(), g)     # out of place


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nan_rows_match(masked, dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((23, 5)).astype(np.float32)
    valid = rng.random(23) < 0.4
    for seed, level in ((0, 0), (5, 1)):
        fp, jp = FI.FaultPlan("nanrows", seed), JFI.FaultPlan("nanrows", seed)
        tx, jx = _pair(x, dtype)
        t = FI.nan_rows(fp, level, tx, torch.from_numpy(valid)
                        if masked else None)
        j = JFI.nan_rows(jp, level, jx, jnp.asarray(valid)
                         if masked else None)
        _eq(t, j, f"nanrows {seed} {level}")
        assert int(torch.isnan(t).any(1).sum()) == 3


def _wire_case(seed, P, nl, dtype):
    """A received wire slab with its per-source data counts (multiples of
    4) and starts, and a few spare rows."""
    rng = np.random.default_rng(seed)
    rc = (rng.integers(0, 4, P) * 4).astype(np.int32)
    rows = int((rc + nl).sum()) + 6
    x = rng.standard_normal((rows, 6)).astype(np.float32)
    woff = np.concatenate([[0], np.cumsum(rc + nl)[:-1]]).astype(np.int32)
    return x.astype(dtype) if dtype == "float32" else x, rc, woff


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["bitflip", "nanrows", "dupseg"])
def test_wire_injectors_match(kind, dtype):
    for seed, level, P, nl in [s for s in SWEEP
                               if s[0] != 1 and s[2] in (2, 8, 16)]:
        x, rc, woff = _wire_case(seed + 11 * level, P, nl, dtype)
        tx, jx = _pair(x, dtype)
        rcw = rc + nl
        fp, jp = FI.FaultPlan(kind, seed), JFI.FaultPlan(kind, seed)
        T = lambda a: torch.from_numpy(a)                    # noqa: E731
        if kind == "bitflip":
            t = FI.flip_wire(fp, level, tx, T(woff), T(rc), nl)
            j = JFI.flip_wire(jp, level, jx, jnp.asarray(woff),
                              jnp.asarray(rc), nl)
        elif kind == "nanrows":
            t = FI.nan_wire(fp, level, tx, T(woff), T(rcw))
            j = JFI.nan_wire(jp, level, jx, jnp.asarray(woff),
                             jnp.asarray(rcw))
        else:
            t = FI.copy_wire_region(fp, level, tx, T(woff), T(rcw))
            j = JFI.copy_wire_region(jp, level, jx, jnp.asarray(woff),
                                     jnp.asarray(rcw))
        _eq(t, j, f"{kind} {seed} {level} {P} {nl}")


def test_flip_wire_passes_gradient_to_the_other_rows():
    x, rc, woff = _wire_case(4, 4, 2, "float32")
    tx = torch.from_numpy(x).requires_grad_()
    fp = FI.FaultPlan("bitflip")
    y = FI.flip_wire(fp, 0, tx, torch.from_numpy(woff), torch.from_numpy(rc),
                     2)
    y.sum().backward()
    v = FI.wire_victim(fp, 0, 4)
    hit = np.zeros(len(x), bool)
    hit[woff[v]:woff[v] + rc[v] + 2] = True
    np.testing.assert_array_equal(tx.grad.numpy()[:, 0], (~hit).astype(
        np.float32))


def test_skew_matches():
    dec_t = TP.RouteDecision(torch.ones(12), torch.arange(12) % 5,
                             torch.ones(12, dtype=torch.bool),
                             torch.ones(6, dtype=torch.bool),
                             torch.ones(6, 3), torch.ones(6, 3),
                             torch.arange(6) % 3, 2)
    dec_j = JP.RouteDecision(jnp.ones(12), jnp.arange(12) % 5,
                             jnp.ones(12, bool), jnp.ones(6, bool),
                             jnp.ones((6, 3)), jnp.ones((6, 3)),
                             jnp.arange(6) % 3, 2)
    for seed, level in ((0, 0), (3, 1)):
        t = FI.apply_skew(FI.FaultPlan("skew", seed), level, dec_t, 5, 3)
        j = JFI.apply_skew(JFI.FaultPlan("skew", seed), level, dec_j, 5, 3)
        _eq(t.group_ids, j.group_ids)
        _eq(t.top1, j.top1)
        _eq(t.gates, j.gates)


# ------------------------------------------------------------ parity words

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lane_views_match(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((7, 9)) * 1e3).astype(np.float32)
    x[0, :3] = [np.nan, -0.0, 1e-40]
    tx, jx = _pair(x, dtype)
    _eq(TC.int_lane_view(tx), JC.int_lane_view(jx))
    w = rng.integers(-2**31, 2**31, (5, 9), dtype=np.int64).astype(np.int32)
    tw, jw = torch.from_numpy(w), jnp.asarray(w)
    _eq(TC.words_to_rows(tw, getattr(torch, dtype)),
        JC.words_to_rows(jw, jnp.dtype(dtype)))
    _eq(TC.stored_words(tw, getattr(torch, dtype)),
        JC.stored_words(jw, jnp.dtype(dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segment_parity_words_match(dtype, seed):
    rng = np.random.default_rng(seed)
    S, d = 6, 16
    lens = rng.integers(0, 9, S).astype(np.int32)
    lens[seed % S] = 0
    cap = lens + rng.integers(0, 4, S)
    bounds = np.concatenate([[0], np.cumsum(cap)]).astype(np.int32)
    # tags past 2^31 / WIRE_TAG_MULT and lengths whose terms wrap
    tags = rng.integers(0, 4000, S).astype(np.int32)
    lens_big = lens.copy()
    lens_big[1] = 3000                      # 3000 * 1000003 > 2^31
    x = (rng.standard_normal((int(bounds[-1]) + 3, d)) * 1e4).astype(
        np.float32)
    for L in (lens, lens_big):
        if L is lens_big:
            L = np.minimum(L, cap).astype(np.int32)   # within the segment
            L[1] = cap[1]
            tags[1] = 2**31 // JC.WIRE_TAG_MULT + 5
        tx, jx = _pair(x, dtype)
        args = [torch.from_numpy(a) for a in (bounds, L, tags)]
        t = TC.segment_parity_words(tx, *args)
        j = JC.segment_parity_words(jx, *(jnp.asarray(a) for a in
                                          (bounds, L, tags)))
        assert t.dtype == torch.int32
        _eq(t, j, f"{dtype} {seed}")
    # the term wraps int32 for real tags: tag 3 and up
    big = TC.segment_parity_words(
        torch.zeros((1, 1)), torch.tensor([0, 1], dtype=torch.int32),
        torch.tensor([1], dtype=torch.int32),
        torch.tensor([3], dtype=torch.int32))
    want = (1000003 + 3 * 777767777 + 2**31) % 2**32 - 2**31
    assert int(big) == want < 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nl", [1, 2])
def test_checksummed_exchange_one_device_matches(nl, dtype):
    """No mesh axes: the staging and the split against JAX's, and the split
    gives back the data and the parity rows that were sent."""
    rng = np.random.default_rng(nl)
    P = 3
    sc = (rng.integers(0, 3, P) * 2).astype(np.int32)
    R = int(sc.sum()) + 2
    x = rng.standard_normal((R, 4)).astype(np.float32)
    par = rng.integers(-2**31, 2**31, (P * nl, 4), dtype=np.int64).astype(
        np.int32)
    if dtype == "bfloat16":
        # XLA:CPU rewrites a bf16 NaN pattern in a select (0x7ff2 becomes
        # 0x7fc0; ROADMAP "Reference caveats"): the JAX side is held on
        # other patterns, the port's round trip on every one below
        low = (par & 0x7FFF).astype(np.int64)
        par = np.where(low > 0x7F80, par ^ 0x4000, par).astype(np.int32)
    td = getattr(torch, dtype)
    tx, jx = _pair(x, dtype)
    tpar = TC.words_to_rows(torch.from_numpy(par), td)
    jpar = JC.words_to_rows(jnp.asarray(par), jnp.dtype(dtype))
    B = R + P * nl + 4
    t, tcnt = TC.checksummed_ragged_all_to_all(
        tx, tpar, torch.from_numpy(sc), (), recv_rows=B,
        recv_counts=torch.from_numpy(sc), nl=nl)
    j, jcnt = JC.checksummed_ragged_all_to_all(
        jx, jpar, jnp.asarray(sc), (), recv_rows=B,
        recv_counts=jnp.asarray(sc), nl=nl)
    _eq(t, j)
    _eq(tcnt, jcnt)
    td_, tp_ = TC.split_checksummed_recv(t, torch.from_numpy(sc), nl, R)
    jd_, jp_ = JC.split_checksummed_recv(j, jnp.asarray(sc), nl, R)
    _eq(td_, jd_)
    _eq(tp_, jp_)
    _eq(td_[:int(sc.sum())], tx[:int(sc.sum())])
    _eq(tp_.reshape(P * nl, -1), tpar)
    # every bit pattern rides the port's wire unchanged, NaNs included
    nan = torch.tensor([[0x7FF2, 0x7F81, -2, 0x7FC0]], dtype=torch.int32)
    nan = TC.words_to_rows(nan.expand(P * nl, 4).contiguous(), td)
    w, _ = TC.checksummed_ragged_all_to_all(
        tx, nan, torch.from_numpy(sc), (), recv_rows=B,
        recv_counts=torch.from_numpy(sc), nl=nl)
    _eq(TC.split_checksummed_recv(w, torch.from_numpy(sc), nl, R)[1]
        .reshape(P * nl, -1), nan)


def test_wire_tags_match():
    for me, P, nl in ((0, 4, 1), (3, 4, 2), (1, 2, 2), (5, 8, 3)):
        for incoming in (False, True):
            _eq(TP._wire_tags(me, P, nl, incoming, "cpu"),
                JP._wire_tags(jnp.int32(me), P, nl, incoming))


def test_fault_plan_on_one_device_layer_matches():
    """A layer on one device under each plan (local hops: only ``skew`` and
    ``nanrows`` act there) against the JAX package's."""
    from repro.common.config import MoEConfig as JMoEConfig
    from repro.core.moe import moe_layer as jmoe
    from repro.sharding.plan import single_device_plan as jplan
    from repro_torch.core.moe import moe_layer as tmoe
    from repro_torch.sharding.plan import single_device_plan as tplan
    rng = np.random.default_rng(5)
    d, E = 16, 8
    kw = dict(num_experts=E, top_k=2, top_g=2, d_ff_expert=32, grid=(2, 4),
              router="smile", dispatch_backend="dropless", ragged_a2a=True,
              renorm_gates=True)
    p = {"experts": {"w1": rng.standard_normal((2, 4, d, 32)).astype(
        np.float32) / 4, "w2": rng.standard_normal((2, 4, 32, d)).astype(
        np.float32) / 6},
         "router_inter": {"w": rng.standard_normal((d, 2)).astype(
             np.float32) / 4},
         "router_intra": {"w": rng.standard_normal((d, 4)).astype(
             np.float32) / 4}}
    x = rng.standard_normal((24, d)).astype(np.float32)
    for plan in ("skew", "nanrows", "counts", "bitflip@2", "dupseg:1"):
        jcfg = JMoEConfig(**kw).with_options(fault_plan=plan)
        jy, jst = jax.jit(lambda p, x: jmoe(p, x, jcfg, jplan(),
                                            act="gelu"))(
            {k: {n: jnp.asarray(v) for n, v in g.items()}
             for k, g in p.items()}, jnp.asarray(x))
        ty, tst = tmoe({k: {n: torch.from_numpy(v) for n, v in g.items()}
                        for k, g in p.items()}, torch.from_numpy(x),
                       MoEConfig(**kw).with_options(fault_plan=plan),
                       tplan(), act="gelu")
        jy = np.asarray(jy)
        np.testing.assert_array_equal(np.isnan(ty.numpy()), np.isnan(jy))
        ok = ~np.isnan(jy)
        np.testing.assert_allclose(ty.numpy()[ok], jy[ok], rtol=1e-5,
                                   atol=1e-6, err_msg=plan)
        for k in ("fault_events", "wire_faults", "hop_drop_frac"):
            _eq(getattr(tst, k), getattr(jst, k), f"{plan} {k}")
