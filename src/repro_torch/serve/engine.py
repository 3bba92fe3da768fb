"""Continuous-batching engine: one fused batched decode step over a paged KV
cache.  The port of ``repro.serve.engine``.

One engine tick is (at most) ONE prefill chunk plus ONE fused decode step:

* **decode** runs all ``n_slots`` sequences through one step of a fixed
  shape: dead slots carry position ``-1`` (their KV write is dropped, their
  output ignored) and a ``live`` mask that the MoE layers read as
  ``token_valid``;
* **prefill** is bucketed and chunked: a prompt goes through in
  ``prefill_buckets``-sized chunks, one chunk a tick, each bucket length a
  step of its own, so a long prompt never stalls the decode of sequences
  already in flight;
* **admit / evict** run against the page pool (``serve.kvcache``):
  reservation-based admission (all ``ceil((prompt + max_new) / page)``
  pages up front), pages freed the tick a request finishes, and reused
  without zeroing (the paged-attention read mask hides stale data).

Where the reference compiles each step once per shape (``jax.jit``), the
port captures it once per shape as a **CUDA graph** on the card: the decode
step at ``n_slots``, and each prefill bucket at its first use, all in one
shared memory pool (``torch.cuda.graph_pool_handle()``).  Each capture
follows one warm-up call on a side stream, which builds and sizes the
kernels and runs the tick for real: the paged write is idempotent (the same
K/V to the same slots), so the replay that follows gives the same outputs.
The per-tick inputs live in static device buffers: one int32 buffer for the
decode step (tokens, positions, liveness, page table) and one for each
bucket (chunk start and length, the slot's page-table row, the padded
chunk), each filled by one host-to-device copy from a pinned host buffer a
tick.  The host's scheduler arrays (``_tok``, ``_pos``, ``_live``,
``table_np``) are numpy views of the decode buffer.  Each step's next
tokens and the bits of its four fp32 MoE telemetry numbers come back as
one int32 vector, in one device-to-host copy.  A capture that fails
raises; there is no eager fallback.  On the CPU the steps run eagerly
(there is no graph).

Over a mesh of ranks (``Engine(..., mesh=)``, the reference's steps under
``shard_map``) every rank builds an engine on its slice of the
parameters, and the pools hold its slice (``sharding.specs.
engine_step_specs``: replicated over dp, KV heads over tp).  Every rank
runs the same scheduler on the same submits: admission depends only on
page counts and finishing only on ``max_new_tokens``, never on token
values, so the ranks stay in step and issue the same collectives.  The
decode batch is all ``n_slots`` rows on every rank, replicated over dp as
in the reference.  **Under a mesh the steps run eagerly, on the card
too**: a collective over gloo is staged through the host, and the ragged
hop reads its split sizes on the host, so no capture could hold a step.
The pinned input buffers and the single device-to-host copy a step stay.

The kernel wrappers' launch counters (``kernels.ops``) move only on a
Python call: under a graph they count the warm-up and the capture, never a
replay.  Each step counts its replays, and keeps the launches its warm-up
and capture made (:meth:`Engine.compile_counts`,
:meth:`Engine.capture_launches`).

**Tracing.**  A tick opens ``torch.profiler.record_function`` ranges,
which a profiler puts in one trace with the device's operations, on its
clock: ``engine.step`` (the tick), ``engine.admit`` (pages and slots for
waiting requests), ``engine.prefill`` (one prompt chunk, on a tick that
runs one) and ``engine.decode`` (the fused decode step, on a tick with a
live slot).  Inside a phase: ``engine.fill`` (prefill only: the bucket's
host buffer), ``engine.replay`` (the host-to-device copy and the graph's
replay, or the eager call), ``engine.readback`` (the device-to-host copy
and the telemetry) and ``engine.bookkeep`` (the scheduler's Python after
it).  Each phase ends in a blocking read, so the host's admit, fill and
bookkeep run while the device has nothing queued.  A request's stamps, all
on the ``time.monotonic`` clock, split its time to first token:
``t_admit - t_submit`` waits for admission, ``t_prefill - t_admit`` for
the prefill queue, ``t_first - t_prefill`` is its own prefill.
:meth:`Engine.metrics` keeps the two waits of the requests that have their
first token, and at each tick's start the requests waiting for admission
and the prompt chunks queued for prefill, as running sums and maxima.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.common.config import ModelConfig, ServeConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import transformer as T
from repro_torch.serve import kvcache as KV
from repro_torch.serve.decode import greedy_sample
from repro_torch.sharding.plan import MeshPlan


# =============================================================================
# Step functions
# =============================================================================

# the MoEStats fields a tick keeps (_pack), the only ones its steps compute
ENGINE_STATS = frozenset({"drop_frac", "hop_max_load", "hop_load_entropy",
                          "fault_events"})

def paged_decode_step_fn(params, tok, caches, table, seq_pos, live, *,
                         cfg: ModelConfig, plan: MeshPlan,
                         use_kernel: bool = True):
    """One fused batched decode tick over the paged KV cache.

    tok/seq_pos/live: (B,) current input token, its position, slot
    liveness; table: (B, max_pages) int32 page table.  Returns (next_tok
    (B,) int32, logits (B, V) fp32, MoEStats, caches); the pools are
    updated in place.  Dead slots give finite garbage tokens the scheduler
    ignores.  Of the MoEStats only the :data:`ENGINE_STATS` fields are
    computed (the others hold zeros).
    """
    positions = torch.where(live, seq_pos, -1)[:, None]          # (B, 1)
    tree = KV.inject_tables(caches, table)
    _, logits, stats, tree = T.forward(params, tok[:, None], cfg, plan,
                                       positions=positions, caches=tree,
                                       use_kernel=use_kernel,
                                       token_valid=live[:, None],
                                       read_stats=ENGINE_STATS)
    lg = logits[:, 0, :]
    return greedy_sample(lg, plan), lg, stats, KV.strip_tables(tree)


def _prefill(params, tokens, caches, table_row, start, n_real, *,
             cfg: ModelConfig, plan: MeshPlan, use_kernel: bool = True):
    """:func:`paged_prefill_fn`, also returning the last real token's
    logits (V,) fp32."""
    S = tokens.shape[1]
    t = torch.arange(S, dtype=torch.int32, device=tokens.device)
    valid = t < n_real
    positions = torch.where(valid, start + t, -1)[None, :]       # (1, S)
    tree = KV.inject_tables(caches, table_row)
    _, logits, stats, tree = T.forward(params, tokens, cfg, plan,
                                       positions=positions, caches=tree,
                                       use_kernel=use_kernel,
                                       token_valid=valid[None, :],
                                       read_stats=ENGINE_STATS)
    last = (n_real - 1).clamp(0, S - 1).reshape(1).long()
    lg = logits[0].index_select(0, last)                          # (1, V)
    return greedy_sample(lg, plan)[0], lg[0], stats, KV.strip_tables(tree)


def paged_prefill_fn(params, tokens, caches, table_row, start, n_real, *,
                     cfg: ModelConfig, plan: MeshPlan,
                     use_kernel: bool = True):
    """One bucketed prefill chunk of one sequence.

    tokens: (1, S_bucket), the prompt slice padded to the bucket length;
    table_row: (1, max_pages); start: 0-dim int32 tensor, the absolute
    position of ``tokens[0, 0]``; n_real: 0-dim int32 tensor, the real
    tokens in the chunk.  Returns (next_tok, a 0-dim int32 that means
    something only on a prompt's last chunk; MoEStats; caches).  Every
    chunk of a long prompt runs the same function: the earlier chunks' KV
    is already in the pool and the page-table view covers it.
    """
    nxt, _, stats, caches = _prefill(params, tokens, caches, table_row,
                                     start, n_real, cfg=cfg, plan=plan,
                                     use_kernel=use_kernel)
    return nxt, stats, caches


def _pack(nxt: torch.Tensor, stats) -> torch.Tensor:
    """The next tokens, then the bits of the four fp32 numbers the engine
    keeps of a step's MoEStats (drop fraction, worst hop max load, worst
    hop load entropy, fault events), as one int32 vector."""
    tel = torch.stack([stats.drop_frac.float(), stats.hop_max_load.max(),
                       stats.hop_load_entropy.min(),
                       stats.fault_events.sum().float()])
    return torch.cat([nxt.reshape(-1).to(torch.int32),
                      tel.view(torch.int32)])


# =============================================================================
# A step at one shape: eager on the CPU, a CUDA graph on the card
# =============================================================================

class _Step:
    """One step function at one shape.  ``fn(caches)`` reads the engine's
    static input buffer and returns ``(packed, logits)`` (:func:`_pack`).
    On the CPU a call runs ``fn`` eagerly.  On the card the first call runs
    it once on a side stream (the warm-up), captures it into a CUDA graph
    in the shared ``pool``, and replays the graph; every later call replays
    it.  ``calls`` counts the calls (the replays, on the card); ``out`` is
    the last call's output."""

    def __init__(self, name: str, fn: Callable, caches: Tuple, pool):
        self.name, self.fn, self.caches, self.pool = name, fn, caches, pool
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self.captures = 0
        self.calls = 0
        self.launches: Dict[str, int] = {}   # kernel -> warm-up + capture

    def __call__(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.pool is None:
            self.out = self.fn(self.caches)
        else:
            if self.graph is None:
                self._capture()
            self.graph.replay()
        self.calls += 1
        return self.out

    def _capture(self) -> None:
        before = kops.launch_counts()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.fn(self.caches)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        failed = None
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                try:
                    self.out = self.fn(self.caches)
                except Exception as e:     # the op that broke the capture
                    failed = e
                    raise
        except Exception as e:
            cause = failed or e
            raise RuntimeError(f"CUDA graph capture of the {self.name} step "
                               f"failed: {type(cause).__name__}: {cause}"
                               ) from cause
        self.graph = graph
        self.captures += 1
        after = kops.launch_counts()
        self.launches = {k: after[k] - before[k] for k in after}


# =============================================================================
# Requests + engine
# =============================================================================

@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                    # (S,) int32
    max_new_tokens: int
    generated: List[int] = dataclasses.field(default_factory=list)
    pages: List[int] = dataclasses.field(default_factory=list)
    t_submit: float = 0.0                 # time.monotonic, as every stamp
    t_admit: float = 0.0                  # given its slot and pages
    t_prefill: float = 0.0                # its first chunk began
    t_first: float = 0.0                  # its first token
    t_tokens: List[float] = dataclasses.field(default_factory=list)


class _Running:
    """The count, sum and maximum of a series of values >= 0, kept without
    the series."""

    def __init__(self):
        self.n, self.total, self.max = 0, 0.0, 0.0

    def add(self, x: float) -> None:
        self.n += 1
        self.total += x
        self.max = max(self.max, x)

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0


def derive_buckets(cache_len: int, lo: int = 16) -> Tuple[int, ...]:
    """Doubling chunk lengths up to ``cache_len`` (each a step of its own)."""
    if cache_len <= lo:
        return (cache_len,)
    out, s = [], lo
    while s < cache_len:
        out.append(s)
        s *= 2
    out.append(cache_len)
    return tuple(out)


StepKey = Union[str, int]                 # "decode", or a bucket length


class Engine:
    """Continuous-batching serving engine over the paged KV cache, on the
    device the parameters lie on.  The MoE hops run the kernel path
    (``use_kernel=True``), as the fixed-batch serve does.

    With ``mesh`` (:func:`repro_torch.launch.mesh.make_mesh`, whose plan
    is ``plan``) ``params`` are the rank's slices, and every rank of the
    mesh must build its engine and submit the same requests in the same
    order.  Its steps then run eagerly on the card (no CUDA graph: the
    collectives cross the host), which :meth:`compile_counts` shows as 0
    captures.  ``use_kernel=False`` runs the plain path (which also takes
    fp32 compute), as ``launch.serve.generate`` does."""

    def __init__(self, params, cfg: ModelConfig, plan: MeshPlan, *,
                 serve: Optional[ServeConfig] = None, mesh=None,
                 use_kernel: bool = True, **overrides):
        serve = serve or ServeConfig()
        if overrides:
            serve = dataclasses.replace(serve, **overrides)
        if not T.paged_cache_supported(cfg):
            raise ValueError(
                "Engine supports causal single-stream GQA attention archs "
                "(full/sliding); MLA absorbed decode and SSM/RWKV recurrent "
                "state over paged pools are ROADMAP follow-ups")
        self.params, self.cfg, self.plan = params, cfg, plan
        self.serve, self.mesh, self.use_kernel = serve, mesh, use_kernel
        self.device = params["embed"]["table"].device
        if mesh is not None and self.device != mesh.device:
            raise ValueError(f"parameters on {self.device}, the mesh's rank "
                             f"on {mesh.device}")
        self.cache_len = serve.resolved_cache_len()
        self.page_size = serve.page_size
        self.n_slots = serve.n_slots
        pool_pages = serve.resolved_pool_pages()
        self.max_pages = KV.pages_needed(self.cache_len, self.page_size)
        self.buckets = (tuple(int(x) for x in serve.prefill_buckets.split(","))
                        if serve.prefill_buckets
                        else derive_buckets(self.cache_len))
        if list(self.buckets) != sorted(self.buckets) or self.buckets[0] < 1:
            raise ValueError(f"prefill_buckets must be ascending positive "
                             f"lengths, got {serve.prefill_buckets!r}")

        self.alloc = KV.PageAllocator(pool_pages, self.page_size)
        self.caches = KV.init_paged_caches(cfg, pool_pages, self.page_size,
                                           plan, device=self.device,
                                           mesh=mesh)
        B, mp = self.n_slots, self.max_pages
        self._sentinel = pool_pages                   # OOB page id == unmapped
        # a step is a CUDA graph on the card, except over a mesh: gloo
        # stages each collective through the host and the ragged hop reads
        # its split sizes there, which no capture can hold
        self._graphed = self.device.type == "cuda" and mesh is None
        self._pool = torch.cuda.graph_pool_handle() if self._graphed else None
        # the decode step's input: [tok (B) | pos (B) | live (B) | table
        # (B * mp)]; the scheduler's arrays are views of its host side
        self._dec_in = self._buffers(3 * B + B * mp)
        h = self._dec_in[0].numpy()
        self._tok, self._pos, self._live = h[:B], h[B:2 * B], h[2 * B:3 * B]
        self.table_np = h[3 * B:].reshape(B, mp)
        self.table_np[:] = self._sentinel
        # each bucket's input: [start | n_real | table row (mp) | chunk (S)]
        self._pre_in: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.slot_req: List[Optional[Request]] = [None] * B

        self.waiting: Deque[Request] = deque()
        self.prefilling: Deque[List] = deque()        # [req, slot, start]
        self.requests: Dict[int, Request] = {}        # uid -> Request (all)
        self.finished: Dict[int, List[int]] = {}
        self._uid = 0
        self.ticks = 0
        self.occupancy: List[float] = []
        self.telemetry: List[Dict[str, float]] = []
        self.steps: Dict[StepKey, _Step] = {}
        self._backlog = 0                 # prompt chunks queued in prefilling
        self.queue_stats = {k: _Running() for k in (
            "waiting", "prefill_backlog", "queue_wait_s", "prefill_wait_s")}

    def _buffers(self, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(host, device) int32 buffers of ``n``; the host one pinned on the
        card, so its copy is one asynchronous transfer."""
        host = torch.zeros((n,), dtype=torch.int32,
                           pin_memory=self.device.type == "cuda")
        return host, torch.zeros((n,), dtype=torch.int32, device=self.device)

    # ------------------------------------------------------------------ steps
    def _decode_fn(self, caches):
        B, mp = self.n_slots, self.max_pages
        d = self._dec_in[1]
        nxt, lg, stats, _ = paged_decode_step_fn(
            self.params, d[:B], caches, d[3 * B:].view(B, mp), d[B:2 * B],
            d[2 * B:3 * B] > 0, cfg=self.cfg, plan=self.plan,
            use_kernel=self.use_kernel)
        return _pack(nxt, stats), lg

    def _prefill_fn(self, bucket: int):
        mp = self.max_pages
        d = self._pre_in[bucket][1]

        def fn(caches):
            nxt, lg, stats, _ = _prefill(
                self.params, d[2 + mp:].view(1, bucket), caches,
                d[2:2 + mp].view(1, mp), d[0], d[1], cfg=self.cfg,
                plan=self.plan, use_kernel=self.use_kernel)
            return _pack(nxt, stats), lg
        return fn

    def _step(self, key: StepKey) -> _Step:
        if key not in self.steps:
            if key == "decode":
                name, fn = "decode", self._decode_fn
            else:
                self._pre_in[key] = self._buffers(2 + self.max_pages + key)
                name, fn = f"prefill bucket {key}", self._prefill_fn(key)
            self.steps[key] = _Step(name, fn, self.caches, self._pool)
        return self.steps[key]

    def _run(self, key: StepKey, inputs) -> np.ndarray:
        """Copy ``inputs``' host buffer to the device, run the step, and
        read its packed output (one device-to-host copy): the next tokens."""
        host, dev = inputs
        with record_function("engine.replay"):
            dev.copy_(host, non_blocking=True)
            packed, _ = self._step(key)()
        with record_function("engine.readback"):
            out = packed.cpu().numpy()
            tel = out[-4:].view(np.float32)
            self.telemetry.append({"drop_frac": float(tel[0]),
                                   "hop_max_load": float(tel[1]),
                                   "hop_load_entropy": float(tel[2]),
                                   "fault_events": float(tel[3])})
        return out[:-4]

    # ------------------------------------------------------------------ submit
    def submit(self, prompt, max_new_tokens: int = 16) -> int:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        total = len(prompt) + max_new_tokens
        if total > self.cache_len:
            raise ValueError(f"request needs {total} positions > cache_len="
                             f"{self.cache_len}")
        if KV.pages_needed(total, self.page_size) > self.alloc.pool_pages:
            raise ValueError("request can never fit the page pool")
        self._uid += 1
        req = Request(self._uid, prompt, max_new_tokens,
                      t_submit=time.monotonic())
        self.waiting.append(req)
        self.requests[self._uid] = req
        return self._uid

    # ------------------------------------------------------------------ sched
    def _pick_waiting(self) -> Request:
        if self.serve.admit_policy == "sjf":
            best = min(self.waiting, key=lambda r: (len(r.prompt), r.uid))
            self.waiting.remove(best)
            return best
        return self.waiting.popleft()

    def _admit(self) -> None:
        while self.waiting:
            free_slots = [i for i, r in enumerate(self.slot_req) if r is None]
            if not free_slots:
                return
            nxt = (min(self.waiting, key=lambda r: (len(r.prompt), r.uid))
                   if self.serve.admit_policy == "sjf" else self.waiting[0])
            total = len(nxt.prompt) + nxt.max_new_tokens
            pages = self.alloc.alloc(total)
            if pages is None:
                return                                # head-of-line waits
            req = self._pick_waiting()
            assert req is nxt
            req.t_admit = time.monotonic()
            req.pages = pages
            self._backlog += max(1, -(-len(req.prompt) // self.buckets[-1]))
            slot = free_slots[0]
            self.table_np[slot] = self._sentinel
            self.table_np[slot, :len(pages)] = pages
            self.slot_req[slot] = req
            self.prefilling.append([req, slot, 0])

    def _prefill_tick(self) -> None:
        if not self.prefilling:
            return
        with record_function("engine.prefill"):
            ent = self.prefilling[0]
            req, slot, start = ent
            if start == 0:
                req.t_prefill = time.monotonic()
            with record_function("engine.fill"):
                chunk = min(len(req.prompt) - start, self.buckets[-1])
                bucket = next(b for b in self.buckets if b >= chunk)
                self._step(bucket)
                inputs = self._pre_in[bucket]
                h, mp = inputs[0].numpy(), self.max_pages
                h[0], h[1] = start, chunk
                h[2:2 + mp] = self.table_np[slot]
                h[2 + mp:] = 0
                h[2 + mp:2 + mp + chunk] = req.prompt[start:start + chunk]
            nxt = self._run(bucket, inputs)
            with record_function("engine.bookkeep"):
                self._backlog -= 1
                ent[2] = start + chunk
                if ent[2] >= len(req.prompt):         # prompt done -> go live
                    self._go_live(req, slot, int(nxt[0]))

    def _go_live(self, req: Request, slot: int, tok: int) -> None:
        """The prompt's last chunk gave ``tok``: the request leaves the
        prefill queue and decodes in its slot."""
        self.prefilling.popleft()
        now = time.monotonic()
        req.t_first = now
        req.t_tokens.append(now)
        req.generated.append(tok)
        self.queue_stats["queue_wait_s"].add(req.t_admit - req.t_submit)
        self.queue_stats["prefill_wait_s"].add(req.t_prefill - req.t_admit)
        self._tok[slot] = tok
        self._pos[slot] = len(req.prompt)
        self._live[slot] = True
        self._maybe_finish(slot)                      # max_new_tokens == 1

    def _maybe_finish(self, slot: int) -> None:
        req = self.slot_req[slot]
        if req is not None and len(req.generated) >= req.max_new_tokens:
            self.finished[req.uid] = req.generated
            self.alloc.free(req.pages)
            self.table_np[slot] = self._sentinel
            self._live[slot] = False
            self.slot_req[slot] = None

    def _decode_tick(self) -> None:
        if not self._live.any():
            return
        with record_function("engine.decode"):
            nxt = self._run("decode", self._dec_in)
            with record_function("engine.bookkeep"):
                now = time.monotonic()
                for i in range(self.n_slots):
                    if not self._live[i]:
                        continue
                    req = self.slot_req[i]
                    tok = int(nxt[i])
                    req.generated.append(tok)
                    req.t_tokens.append(now)
                    self._pos[i] += 1
                    self._tok[i] = tok
                    self._maybe_finish(i)

    # ------------------------------------------------------------------ drive
    def step(self) -> None:
        """One engine tick: admit -> one prefill chunk -> one fused decode."""
        with record_function("engine.step"), torch.no_grad():
            self.ticks += 1
            self.queue_stats["waiting"].add(len(self.waiting))
            self.queue_stats["prefill_backlog"].add(self._backlog)
            with record_function("engine.admit"):
                self._admit()
            self._prefill_tick()
            self._decode_tick()
            self.occupancy.append(self.alloc.occupancy)

    @property
    def busy(self) -> bool:
        return bool(self.waiting or self.prefilling or self._live.any())

    def run(self, max_ticks: int = 100_000) -> Dict[int, List[int]]:
        while self.busy:
            assert self.ticks < max_ticks, "engine failed to drain"
            self.step()
        return dict(self.finished)

    # ---------------------------------------------------------------- metrics
    def compile_counts(self) -> Dict[str, Any]:
        """Step callables built: ``decode`` (0 or 1) and ``prefill`` {bucket:
        1}, the reference's compile counts.  On the card also ``captures``
        and, for graphed steps, ``replays``, or for eager ones (over a
        mesh) ``calls``, each in the same form."""
        def per(attr):
            return {"decode": (getattr(self.steps["decode"], attr)
                               if "decode" in self.steps else 0),
                    "prefill": {k: getattr(s, attr)
                                for k, s in self.steps.items()
                                if k != "decode"}}
        out = {"decode": int("decode" in self.steps),
               "prefill": {k: 1 for k in self.steps if k != "decode"}}
        if self.device.type == "cuda":
            out["captures"] = per("captures")
            out["replays" if self._graphed else "calls"] = per("calls")
        return out

    def capture_launches(self) -> Dict[str, int]:
        """Kernel launches counted over every step's warm-up and capture."""
        tot = {k: 0 for k in kops.launch_counts()}
        for s in self.steps.values():
            for k, n in s.launches.items():
                tot[k] += n
        return tot

    def metrics(self) -> Dict[str, Any]:
        occ = np.asarray(self.occupancy or [0.0])
        tel = self.telemetry or [{}]

        def agg(key, red):
            vals = [t[key] for t in tel if key in t]
            return float(red(vals)) if vals else 0.0
        return {
            "ticks": self.ticks,
            "completed": len(self.finished),
            "page_occupancy_mean": float(occ.mean()),
            "page_occupancy_max": float(occ.max()),
            "moe_drop_frac_mean": agg("drop_frac", np.mean),
            "moe_hop_max_load_max": agg("hop_max_load", np.max),
            "moe_hop_load_entropy_min": agg("hop_load_entropy", np.min),
            "moe_fault_events": agg("fault_events", np.sum),
            "compiles": self.compile_counts(),
            # the waits of the requests that have their first token; the
            # queues at each tick's start
            **{f"{k}_{s}": float(getattr(q, s))
               for k, q in self.queue_stats.items()
               for s in ("mean", "max")},
        }

