"""The continuous-batching engine of the port against the JAX package's, on
the reduced configs: the same ragged request trace through both engines
with the same weights (numpy-drawn, carried across by ``params_from_jax``),
then the cases of ``tests/test_kvcache.py`` and ``tests/test_serving.py``
on the port alone.

Tolerance: ``LOGITS_ATOL`` of ``test_torch_serve.py``.  Both packages
compute in bf16 and round intermediates at different places, so greedy
tokens may part where the top-2 margin is a near-tie.  Every request must
give the reference's tokens, or, where they first part, the port's logits
there must lie within ``LOGITS_ATOL`` of the reference's forward over the
same prefix, and that forward's top-2 margin under ``2 * LOGITS_ATOL``.
Tick counts and compile counts must be equal: the schedule does not
depend on token values.
"""
import sys
import traceback
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_reduced as jget_reduced
from repro.configs import with_options as jwith_options
from repro.models import transformer as JT
from repro.serve.engine import Engine as JEngine
from repro.sharding.plan import single_device_plan as jplan
from repro_torch.configs import get_reduced as tget_reduced
from repro_torch.configs import with_options as twith_options
from repro_torch.kernels import ops as tops
from repro_torch.models import transformer as TT
from repro_torch.serve import decode as TDEC
from repro_torch.serve.batcher import Batcher
from repro_torch.serve.engine import Engine, derive_buckets
from repro_torch.sharding.plan import single_device_plan as tplan
from repro_torch.weights import params_from_jax

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import keep_logits, run_checked  # noqa: E402

LOGITS_ATOL = 3e-2
DROPLESS = dict(dispatch_backend="dropless")
ENGINE_KW = dict(cache_len=32, page_size=4, n_slots=2)


def _numpy_params(jtree, seed):
    """The reference's parameter tree with every leaf that varies redrawn
    from numpy ``default_rng(seed)`` at its own scale (norm scales, biases
    and other constant leaves kept)."""
    rng = np.random.default_rng(seed)

    def draw(a):
        a = np.asarray(a)
        sd = float(a.astype(np.float32).std())
        if sd == 0.0:
            return a
        return (rng.standard_normal(a.shape) * sd).astype(a.dtype)
    return jax.tree.map(draw, jtree)


def _pair(arch, opts=None, seed=0):
    jcfg, tcfg = jget_reduced(arch), tget_reduced(arch)
    if opts:
        jcfg, tcfg = jwith_options(jcfg, **opts), twith_options(tcfg, **opts)
    tree = _numpy_params(JT.init_model(jax.random.PRNGKey(0), jcfg, jplan()),
                         seed)
    jparams = jax.tree.map(jnp.asarray, tree)
    return jcfg, tcfg, jparams, params_from_jax(tree, tcfg, device="cpu")


def _trace(n=6, seed=7, vocab=500, min_new=2):
    rng = np.random.default_rng(seed)
    return [(rng.integers(8, vocab, int(rng.integers(3, 22))).astype(np.int32),
             int(rng.integers(min_new, 9))) for _ in range(n)]


def _run(eng, trace):
    uids = [eng.submit(p, nt) for p, nt in trace]
    return uids, eng.run()


def _assert_same_tokens(jout, teng, tout, tlogits, jparams, jcfg):
    """Equal tokens, or a near-tie where they first part (module doc)."""
    n_same = 0
    for uid, want in jout.items():
        got = tout[uid]
        assert len(got) == len(want), uid
        if got == want:
            n_same += 1
            continue
        j = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        req = teng.requests[uid]
        seq = np.concatenate([req.prompt, np.asarray(want[:j], np.int32)])
        _, jl, _, _ = JT.forward(jparams, jnp.asarray(seq)[None], jcfg,
                                 jplan(), positions=jnp.arange(len(seq)))
        jl = np.asarray(jl)[0, -1]
        tl = tlogits[uid][j].numpy()
        top2 = np.sort(jl)[-2:]
        assert np.abs(tl - jl).max() <= LOGITS_ATOL, (uid, j)
        assert top2[1] - top2[0] < 2 * LOGITS_ATOL, (uid, j)
    assert n_same >= len(jout) // 2            # the check has teeth


CASES = {"qwen1.5": ("qwen1.5-0.5b", None),
         # prompts in chunks of 4 and 8 tokens; requests of 1 new token
         "qwen1.5-chunked": ("qwen1.5-0.5b", None),
         "qwen3-sort": ("qwen3-moe-30b-a3b", None),
         "qwen3-dropless": ("qwen3-moe-30b-a3b", DROPLESS),
         "llama3-405b": ("llama3-405b", None),
         "stablelm-12b": ("stablelm-12b", None),
         "deepseek-coder-33b": ("deepseek-coder-33b", None)}


@pytest.mark.parametrize("case", list(CASES))
def test_engine_matches_jax_engine(case):
    """A ragged trace (6 requests of 3-21 prompt tokens and 2-8 new ones,
    2 slots, pages of 4, buckets 16 and 32; the chunked case: buckets 4 and
    8, so a prompt takes up to 6 chunks, and 1-8 new tokens) through both
    engines: tokens, ticks, compile counts and the scheduler's metrics."""
    arch, opts = CASES[case]
    jcfg, tcfg, jparams, tparams = _pair(arch, opts)
    kw, trace = ENGINE_KW, _trace(vocab=jcfg.vocab_size)
    if case == "qwen1.5-chunked":
        kw = dict(ENGINE_KW, prefill_buckets="4,8")
        trace = _trace(n=7, seed=3, vocab=jcfg.vocab_size, min_new=1)
        assert min(nt for _, nt in trace) == 1
    jeng = JEngine(jparams, jcfg, jplan(), **kw)
    teng = Engine(tparams, tcfg, tplan(), **kw)
    before = tops.launch_counts()
    juids, jout = _run(jeng, trace)
    with keep_logits(teng) as tlogits:
        tuids, tout = _run(teng, trace)
    assert juids == tuids
    assert tops.launch_counts() == before          # CPU: plain versions only
    _assert_same_tokens(jout, teng, tout, tlogits, jparams, jcfg)
    assert teng.ticks == jeng.ticks
    assert teng.compile_counts() == jeng.compile_counts()
    jm, tm = jeng.metrics(), teng.metrics()
    for k in ("ticks", "completed", "page_occupancy_mean",
              "page_occupancy_max", "moe_fault_events"):
        assert tm[k] == jm[k], k
    for k in ("moe_drop_frac_mean", "moe_hop_max_load_max",
              "moe_hop_load_entropy_min"):
        assert tm[k] == pytest.approx(jm[k], abs=1e-5), k
    assert teng.alloc.n_free == teng.alloc.pool_pages


@pytest.mark.parametrize("case", ["qwen1.5", "qwen3-sort", "qwen3-dropless"])
def test_step_functions_match_reference(case):
    """``paged_prefill_fn`` (two chunks of one prompt, one of another, each
    padded to its bucket) and ``paged_decode_step_fn`` (two live slots and a
    dead one) against the reference's, fed the reference's tokens: logits
    within LOGITS_ATOL, greedy tokens equal where the margin is clear, the
    drop fractions equal, the pools within a few bf16 ulps of the largest
    K/V."""
    from repro.serve import engine as JENG
    from repro.serve import kvcache as JKV
    from repro_torch.serve import engine as TENG
    from repro_torch.serve import kvcache as TKV
    arch, opts = CASES[case]
    jcfg, tcfg, jp, tp = _pair(arch, opts)
    P, page = 10, 4
    jc = JKV.init_paged_caches(jcfg, P, page, jplan())
    tc = TKV.init_paged_caches(tcfg, P, page, tplan(), device="cpu")
    table = np.array([[3, 5, 1, 7, P], [0, 2, P, P, P], [P] * 5], np.int32)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(8, jcfg.vocab_size, n).astype(np.int32)
               for n in (13, 6)]
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)
    nxt = []
    for row, p, chunks in ((0, prompts[0], ((0, 8), (8, 5))),
                           (1, prompts[1], ((0, 6),))):
        for start, n in chunks:
            S = 8
            toks = np.zeros((1, S), np.int32)
            toks[0, :n] = p[start:start + n]
            tbl = table[row:row + 1]
            jn, js, jc = JENG.paged_prefill_fn(
                jp, jnp.asarray(toks), jc, jnp.asarray(tbl), jnp.int32(start),
                jnp.int32(n), cfg=jcfg, plan=jplan())
            with torch.no_grad():
                tn, ts, tc = TENG.paged_prefill_fn(
                    tp, torch.from_numpy(toks), tc, torch.from_numpy(tbl),
                    i32(start), i32(n), cfg=tcfg, plan=tplan())
            assert float(ts.drop_frac) == pytest.approx(float(js.drop_frac))
        nxt.append(int(jn))
    tok = np.array(nxt + [0], np.int32)
    pos = np.array([13, 6, 0], np.int32)
    live = np.array([True, True, False])
    for step in range(3):
        jt, jl, js, jc = JENG.paged_decode_step_fn(
            jp, jnp.asarray(tok), jc, jnp.asarray(table), jnp.asarray(pos),
            jnp.asarray(live), cfg=jcfg, plan=jplan())
        with torch.no_grad():
            tt, tl, ts, tc = TENG.paged_decode_step_fn(
                tp, torch.from_numpy(tok), tc, torch.from_numpy(table),
                torch.from_numpy(pos), torch.from_numpy(live), cfg=tcfg,
                plan=tplan())
        jl, tl = np.asarray(jl)[:2], tl.numpy()[:2]
        np.testing.assert_allclose(tl, jl, rtol=0, atol=LOGITS_ATOL)
        top2 = np.sort(jl, axis=-1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > 2 * LOGITS_ATOL
        np.testing.assert_array_equal(tt.numpy()[:2][sure],
                                      np.asarray(jt)[:2][sure])
        assert float(ts.drop_frac) == pytest.approx(float(js.drop_frac))
        tok, pos = np.asarray(jt).astype(np.int32), pos + live
    for jst, tst in zip(jc, tc):
        pairs = ([(jst[k], tst[k]) for k in ("dense", "moe")]
                 if isinstance(tst, dict) else [(jst, tst)])
        for jpool, blocks in pairs:
            for r, blk in enumerate(blocks):
                for name in ("pool_k", "pool_v"):
                    want = np.asarray(jpool[name][r].astype(jnp.float32))
                    got = blk[name].float().numpy()
                    scale = np.abs(want).max()
                    # a second layer's K/V carry the first layer's bf16
                    # rounding differences: a few bf16 ulps of the largest
                    np.testing.assert_allclose(got, want, rtol=0,
                                               atol=2 ** -6 * scale)


# reads of a device tensor on the host (each a sync on the card, which a
# CUDA graph capture refuses), and ops whose output shape depends on data
HOST_READS = {"_local_scalar_dense", "nonzero", "masked_select", "_unique2",
              "unique_dim", "unique_consecutive"}


class _HostReads(TorchDispatchMode):
    """Records the ops of HOST_READS with the innermost line of the port
    that called them.  ``F.one_hot`` is let through: on the CPU it reads
    its input's min and max to check the classes, on the card it leaves
    that to a device assert."""

    def __init__(self):
        super().__init__()
        self.hits = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.__name__.split(".")[0] in HOST_READS:
            frames = [f for f in traceback.extract_stack()
                      if "repro_torch" in f.filename]
            where = frames[-1] if frames else None
            if where is None or "one_hot(" not in (where.line or ""):
                self.hits.append((func.__name__, where and
                                  f"{where.filename}:{where.lineno}"))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case", ["qwen1.5", "qwen3-sort", "qwen3-dropless"])
def test_engine_steps_read_nothing_on_the_host(case):
    """The decode and prefill steps (what the card captures as CUDA graphs)
    read no device value on the host and make no data-dependent shape (a
    capture refuses both).  On the CPU the kernel wrappers run their plain
    versions, which the card does not run."""
    arch, opts = CASES[case]
    cfg = tget_reduced(arch)
    if opts:
        cfg = twith_options(cfg, **opts)
    params = TT.init_model(cfg, tplan(), seed=0, device="cpu")
    eng = Engine(params, cfg, tplan(), **ENGINE_KW)
    for p, nt in _trace(n=3, vocab=cfg.vocab_size):
        eng.submit(p, nt)
    mode = _HostReads()
    for key in ("decode", 16, 32):
        eng._step(key)
    steps = dict(eng.steps)

    def watched(step):
        def call():
            with mode:
                return step.fn(step.caches)
        return call
    for key, step in steps.items():
        eng.steps[key] = watched(step)
    eng.run()
    assert not mode.hits, mode.hits[:5]


def _ring_decode(cfg, params, prompt, new_tokens, cache_len):
    """The port's fixed-batch prefill + ring-buffer decode of one prompt."""
    caches = TT.init_caches(cfg, 1, cache_len, tplan(), device="cpu")
    run = dict(cfg=cfg, plan=tplan())
    with torch.no_grad():
        tok, caches, _ = TDEC.prefill_fn(
            params, torch.from_numpy(prompt)[None], caches, **run)
        out = [int(tok[0])]
        for i in range(new_tokens - 1):
            tok, caches, _ = TDEC.decode_step_fn(params, tok, caches,
                                                 len(prompt) + i, **run)
            out.append(int(tok[0]))
    return out


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen3-moe-30b-a3b"])
def test_paged_matches_ring_across_page_boundaries(arch):
    """Greedy tokens through the paged engine equal the port's ring-cache
    fixed-batch decode.  page_size=3 with an 8-token prompt puts page
    boundaries inside the prefill chunk, at the prefill/decode handoff and
    between decode steps; the last page is partly filled."""
    cfg = tget_reduced(arch)
    params = TT.init_model(cfg, tplan(), seed=0, device="cpu")
    prompt = np.random.default_rng(2).integers(
        8, cfg.vocab_size, 8).astype(np.int32)
    eng = Engine(params, cfg, tplan(), cache_len=16, page_size=3, n_slots=2)
    uid = eng.submit(prompt, max_new_tokens=6)
    assert eng.run()[uid] == _ring_decode(cfg, params, prompt, 6, 16)


# the engine's first-token logits against the ring-cache prefill's: fp32
# compute leaves only fp32 sums in other orders; bf16 rounds each layer's
# output, where those sums land an ulp apart near a rounding edge
PAGED_RING_ATOL = {"float32": 1e-4, "bfloat16": LOGITS_ATOL}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "llama3-405b"])
def test_paged_first_token_logits_match_ring(arch, dtype):
    """Each request's first-token logits through the paged engine (ragged
    prompts, pages of 3, prompts in one or two chunks) against the port's
    ring-cache prefill of the same prompt, within PAGED_RING_ATOL."""
    cfg = tget_reduced(arch).replace(dtype=dtype)
    params = TT.init_model(cfg, tplan(), seed=0, device="cpu")
    trace = _trace(n=5, seed=11, vocab=cfg.vocab_size)
    eng = Engine(params, cfg, tplan(), cache_len=32, page_size=3, n_slots=2,
                 prefill_buckets="8,16")
    with keep_logits(eng) as logits:
        uids, _ = _run(eng, trace)
    errs = []
    for uid, (prompt, _) in zip(uids, trace):
        caches = TT.init_caches(cfg, 1, 32, tplan(), device="cpu")
        with torch.no_grad():
            _, _, want = TDEC.prefill_fn(params, torch.from_numpy(prompt)[None],
                                         caches, cfg=cfg, plan=tplan())
        errs.append((logits[uid][0] - want[0].float()).abs().max().item())
    assert max(errs) <= PAGED_RING_ATOL[dtype], errs


@pytest.mark.parametrize("case", ["qwen1.5", "qwen3-sort"])
def test_kept_logits_and_replay_check(case):
    """The checks ``chip_smoke.py`` runs on the engine, here on the CPU:
    every generated token's kept logits give that token as their argmax;
    a step called again after its tick (the card's replay) equals its
    eager function on a clone of the caches, and leaves the engine's
    tokens as they were."""
    arch, opts = CASES[case]
    cfg = twith_options(tget_reduced(arch), **(opts or {}))
    params = TT.init_model(cfg, tplan(), seed=0, device="cpu")
    trace = _trace(vocab=cfg.vocab_size)
    plain = Engine(params, cfg, tplan(), **ENGINE_KW)
    _, want = _run(plain, trace)
    eng = Engine(params, cfg, tplan(), **ENGINE_KW)
    with keep_logits(eng) as logits:
        uids, checks = run_checked(eng, trace, ("decode", 16, 32))
    assert [eng.finished[u] for u in uids] == [want[u] for u in sorted(want)]
    for u in uids:
        assert [int(lg.argmax()) for lg in logits[u]] == eng.finished[u]
    for key, ((pe, le), (pg, lg)) in checks.items():
        assert torch.equal(pe, pg) and torch.equal(le, lg), key
    # the wrapped tick is the engine's own again
    assert not {"_step", "_prefill_tick", "_decode_tick"} & set(vars(eng))


def _qwen15():
    cfg = tget_reduced("qwen1.5-0.5b")
    return cfg, TT.init_model(cfg, tplan(), seed=0, device="cpu")


def test_dirty_page_reuse_after_evict():
    """Freed pages are reused without zeroing: a request admitted onto
    pages a finished request just released decodes the same tokens as on a
    fresh engine."""
    cfg, params = _qwen15()
    rng = np.random.default_rng(3)
    prompt_a = rng.integers(8, 500, 9).astype(np.int32)
    prompt_b = rng.integers(8, 500, 7).astype(np.int32)
    kw = dict(cache_len=16, page_size=4, n_slots=1, pool_pages=4)
    eng = Engine(params, cfg, tplan(), **kw)
    uid_a = eng.submit(prompt_a, max_new_tokens=5)
    eng.run()
    assert eng.alloc.n_free == 4
    uid_b = eng.submit(prompt_b, max_new_tokens=6)
    out = eng.run()
    fresh = Engine(params, cfg, tplan(), **kw)
    uid_f = fresh.submit(prompt_b, max_new_tokens=6)
    assert out[uid_b] == fresh.run()[uid_f]
    assert uid_a in eng.finished
    # the pages B ran on held A's KV: dirty, not zeroed
    assert set(eng.requests[uid_b].pages) <= set(eng.requests[uid_a].pages)


def test_pool_exhaustion_queues_instead_of_failing():
    cfg, params = _qwen15()
    rng = np.random.default_rng(4)
    eng = Engine(params, cfg, tplan(), cache_len=16, page_size=4, n_slots=4,
                 pool_pages=5)
    uids = [eng.submit(rng.integers(8, 500, 8).astype(np.int32), 4)
            for _ in range(3)]
    seen_waiting = False
    while eng.busy:
        eng.step()
        seen_waiting |= bool(eng.waiting) and any(
            r is None for r in eng.slot_req)
    assert seen_waiting                    # a free slot, but no pages
    assert sorted(eng.finished) == sorted(uids)
    assert eng.alloc.n_free == 5


def test_oversized_request_rejected():
    cfg, params = _qwen15()
    eng = Engine(params, cfg, tplan(), cache_len=16, page_size=4, n_slots=2,
                 pool_pages=2)
    with pytest.raises(ValueError, match="cache_len"):
        eng.submit(np.arange(12, dtype=np.int32), max_new_tokens=8)
    with pytest.raises(ValueError, match="page pool"):
        eng.submit(np.arange(8, dtype=np.int32), max_new_tokens=4)


def test_compile_counts_once_per_shape():
    """The decode step is built once, and each prefill bucket once, across
    ragged prompt lengths and many admit/evict cycles (the reference's
    recompile-determinism test)."""
    cfg, params = _qwen15()
    rng = np.random.default_rng(5)
    eng = Engine(params, cfg, tplan(), cache_len=64, page_size=8, n_slots=2,
                 prefill_buckets="8,16,32")
    for plen in [3, 8, 11, 16, 20, 5, 40]:   # 40: two chunks of 32 and 8
        eng.submit(rng.integers(8, 500, plen).astype(np.int32),
                   max_new_tokens=3)
    eng.run()
    n = eng.compile_counts()
    assert n == {"decode": 1, "prefill": {8: 1, 16: 1, 32: 1}}, n
    assert set(eng.steps) == {"decode", 8, 16, 32}
    assert "captures" not in n              # no graph on the CPU
    assert derive_buckets(64) == (16, 32, 64)
    assert derive_buckets(160) == (16, 32, 64, 128, 160)
    assert derive_buckets(12) == (12,)


def test_batcher_completes_ragged_requests():
    cfg, params = _qwen15()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        b = Batcher(params, cfg, tplan(), n_slots=2, cache_len=64,
                    prompt_len=8)
    rng = np.random.default_rng(0)
    lens = [3, 7, 2, 5, 4]
    uids = [b.submit(rng.integers(8, 500, 8).astype(np.int32),
                     max_new_tokens=n) for n in lens]
    out = b.run()
    assert sorted(out) == sorted(uids)
    for uid, n in zip(uids, lens):
        assert len(out[uid]) == n
        assert all(0 <= t < cfg.vocab_size for t in out[uid])
    assert b.ticks <= sum(lens)           # continuous, not run-to-completion


def test_batcher_matches_plain_decode():
    """One request through the Batcher equals a direct prefill + decode."""
    cfg, params = _qwen15()
    prompt = np.random.default_rng(1).integers(8, 500, 8).astype(np.int32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        b = Batcher(params, cfg, tplan(), n_slots=2, cache_len=64,
                    prompt_len=8)
    uid = b.submit(prompt, max_new_tokens=5)
    assert b.run()[uid] == _ring_decode(cfg, params, prompt, 5, 64)


def test_batcher_shim_deprecation():
    cfg, params = _qwen15()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        Batcher(params, cfg, tplan(), n_slots=2, cache_len=64, prompt_len=8)
    assert any(issubclass(x.category, DeprecationWarning) for x in w)


def test_engine_no_starvation_and_pages_freed():
    cfg, params = _qwen15()
    rng = np.random.default_rng(6)
    eng = Engine(params, cfg, tplan(), cache_len=32, page_size=4, n_slots=2)
    uids = [eng.submit(rng.integers(8, 500, int(rng.integers(2, 10)))
                       .astype(np.int32), int(rng.integers(1, 5)))
            for _ in range(9)]
    out = eng.run()
    assert sorted(out) == sorted(uids)
    assert eng.alloc.n_free == eng.alloc.pool_pages
    assert not eng.busy and all(r is None for r in eng.slot_req)
    assert not eng._live.any() and (eng.table_np == eng._sentinel).all()
    m = eng.metrics()
    assert m["completed"] == 9 and 0.0 < m["page_occupancy_max"] <= 1.0


def test_engine_deterministic_seeded_trace():
    cfg, params = _qwen15()

    def trace(eng):
        rng = np.random.default_rng(7)
        for _ in range(5):
            eng.submit(rng.integers(8, 500, int(rng.integers(3, 9)))
                       .astype(np.int32), int(rng.integers(2, 6)))
        return eng.run(), eng.ticks

    kw = dict(cache_len=32, page_size=4, n_slots=2)
    assert trace(Engine(params, cfg, tplan(), **kw)) == \
        trace(Engine(params, cfg, tplan(), **kw))


def test_engine_sjf_admits_shortest_first():
    cfg, params = _qwen15()
    rng = np.random.default_rng(8)
    eng = Engine(params, cfg, tplan(), cache_len=32, page_size=4, n_slots=1,
                 admit_policy="sjf")
    long = eng.submit(rng.integers(8, 500, 12).astype(np.int32), 2)
    short = eng.submit(rng.integers(8, 500, 3).astype(np.int32), 2)
    first_done = None
    while eng.busy:
        eng.step()
        if eng.finished and first_done is None:
            first_done = next(iter(eng.finished))
    assert first_done == short and long in eng.finished


def test_engine_rejects_recurrent_state_archs():
    cfg = tget_reduced("rwkv6-1.6b")
    params = TT.init_model(cfg, tplan(), seed=0, device="cpu")
    with pytest.raises(ValueError, match="ROADMAP"):
        Engine(params, cfg, tplan())
    assert not TT.paged_cache_supported(cfg)
    assert TT.paged_cache_supported(tget_reduced("qwen3-moe-30b-a3b"))


def test_launch_serve_engine_on_cpu(monkeypatch, capsys):
    """``python -m repro_torch.launch.serve --engine`` at a reduced size on
    the CPU, with registry-derived flags; and ``serve_engine``'s result."""
    import sys
    from repro_torch.launch import serve as S
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "qwen3-moe-30b-a3b", "--reduced", "--engine",
        "--requests", "4", "--prompt-len", "12", "--new-tokens", "4",
        "--n-slots", "2", "--page-size", "4", "--admit-policy", "sjf",
        "--device", "cpu"])
    S.main()
    out = capsys.readouterr().out
    assert "engine: 4 requests" in out and "time to first token" in out
    res = S.serve_engine("qwen1.5-0.5b", requests=5, prompt_len=12,
                         new_tokens=4, device="cpu",
                         serve_opts={"n_slots": 2, "page_size": 4})
    assert sorted(res.tokens) == [1, 2, 3, 4, 5]
    assert all(2 <= len(v) <= 4 for v in res.tokens.values())
    assert set(res.ttft_s) == set(res.tokens) and res.ticks > 0
    assert all(t >= 0 for t in res.ttft_s.values())
    assert res.replays == 0 and not any(res.capture_launches.values())
    assert res.metrics["completed"] == 5
    eng = res.engine
    lens = sorted(len(r.prompt) for r in eng.requests.values())
    assert lens[0] >= 12 // 4 and lens[-1] <= 12      # the reference's draw


def test_serve_engine_asking_for_cuda_without_a_card_raises(monkeypatch):
    from repro_torch.launch.serve import serve_engine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_engine("qwen1.5-0.5b", requests=1, prompt_len=4, new_tokens=2)
