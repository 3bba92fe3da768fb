#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code:

1. Card and build: print the card's name and power limit (nvidia-smi) and
   build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc, one
   process per source, in parallel).
2. Kernels against their plain PyTorch versions on the card, at the shapes
   of the serving path (qwen3-moe-30b-a3b at full width, logical expert grid
   (16, 8), batch 8, prompt 128; decode t=8, also the engine's decode tick;
   the engine's prefill chunks of 128 and 64 tokens) and of the training path
   (smile-3.7b at full width, grid (16, 8), batch 16 x seq 128: the routers
   (2048, 768) x (768, 16) and (4096, 768) x (768, 8), the sorts 2,048 keys
   over 17 values and 4,096 over 129; plus the Switch baseline's flat
   router over 128 experts, a bf16 case with ties, sorts at the edge of the
   one-launch route (4,096 keys) and one past it, one with every key
   equal, and 2**20-key sorts over 129 and 8,192 values; and the ragged grouped FFN at the dropless
   serve's hop-2 shapes, on the layout of a real dispatch_ragged: 18,432
   rows of which 8,192 real at prefill, 1,344 of which 64 at decode, and
   the engine's prefill chunks' (4,096 rows of which 1,024 real at 128
   tokens, 2,048 of which 512 at 64); and
   the grouped FFN at phase 9's hop-2 capacity, 128 groups of 2,048 rows):
   errors, and times from CUDA events beside the least time the card could
   take and the library call's, with the kernel's ratio to each.  The
   gathers are timed cold (an L2 flush before each call).  Each routing
   call's CUDA kernels are listed by name with their device times: one a
   call at the training shapes, or the run fails.  Then both routes of the
   counting sort, each forced, up to the one-launch edge; last, the launch
   floor: an empty kernel through the same ctypes path.
3. The path: ``repro_torch.launch.serve.serve`` on qwen3-moe-30b-a3b at full
   width with the depth cut to 4 of 48 layers, random weights from seed 0,
   batch 8, prompt 128, 32 new tokens.  Every kernel must have launched in
   both prefill and decode, and the logits must be finite.  Then the same
   weights and prompts through ``generate`` again, warm, and once more
   under the profiler.
4. Card against CPU: the reduced qwen3-moe config, prefill plus 3 decode
   steps on the CPU (plain versions) and on the card (kernels), logits held
   within the tolerance of the CPU slice test.
5. The training path: ``repro_torch.launch.train.train`` on smile-3.7b at
   full width and depth (12 layers, 3.7 B parameters, fp32 masters, LAMB),
   grid (16, 8), ``router_impl="fused"``, ``sort_impl="radix"``, batch 16 x
   seq 128, random weights from seed 0: one warm-up step, 3 timed steps,
   then 2 more steps of the same run under the profiler, for the device
   time by kernel and the routing kernels' CUDA launches a step.  Both
   routing wrappers must be called 24 times a step (6 MoE layers x 2 hops,
   forward and remat recompute), loss and gradient norm must be finite.
6. Card against CPU, training: reduced smile-3.7b, 3 steps from the same
   weights and batches on the CPU (plain versions) and on the card
   (kernels), each step's loss within 3e-2.
7. The dropless path: ``serve`` as in phase 3 with ``moe_options=
   {"dispatch_backend": "dropless"}``: the ragged grouped FFN must launch 4
   times a forward and the padded one never.  Then the same weights and
   prompts warm through ``generate`` under the sort and the dropless
   configs in turns (sort, dropless, dropless, sort), the FFN rows each
   computes against the real rows, and a profile of one dropless run.
8. Card against CPU, dropless: phase 4 under the dropless config (where
   nothing overflows capacity at this size, so both configs give the same
   logits, bit for bit, on each device; the launch counts show which FFN
   kernel ran).
9. The cache-less kernel forward (``repro_torch.models.transformer.forward(
   ..., use_kernel=True)`` without caches: a whole prompt scored in one
   pass) of qwen3-moe-30b-a3b at full width, 4 of 48 layers, grid (16, 8),
   random weights from seed 0, batch 2 x 4,096 tokens: a forward must
   launch the flash kernel 4 times and the MoE kernels as serving does
   (grouped_ffn 4, dispatch 8, combine 8), and give finite logits; then a
   warm forward (time, tokens/s, peak memory) and a profiled one (device
   busy, the shares of flash and of the grouped FFN's GEMM).
10. Card against CPU: the reduced qwen3-moe config's cache-less kernel
    forward, within the tolerance of its CPU test against the JAX package.
11. rwkv6-1.6b at full width and depth (24 layers, 1.6 B parameters): the
    cache-less kernel forward at batch 4 x 4,096 (the WKV6 kernel must
    launch 24 times a forward), timed and profiled as phase 9; then
    ``serve`` at batch 8, prompt 128, 32 new tokens, which runs the plain
    recurrence of the cached path as the JAX package does: no kernel may
    launch; finite logits, then warm, and profiled over a prefill and 3
    decode steps.
12. Card against CPU, reduced rwkv6: the cache-less kernel forward in fp32
    and bf16, and prefill plus 3 cached decode steps in fp32, within the
    tolerances of its CPU tests.
13. The continuous-batching engine (``repro_torch.launch.serve.
    run_engine``, ``repro_torch.serve.engine.Engine``) on qwen3-moe-30b-a3b
    at full width, 4 of 48 layers, grid (16, 8), random weights from seed
    0, under sort and then dropless on the same weights: ``ServeConfig``'s
    defaults (8 slots, pages of 16, cache 160, buckets 16/32/64/128/160)
    and 16 ragged requests from seed 0 (prompts 32-128 tokens, 16-32 new
    ones).  Each step is a CUDA graph, captured at first use.  The first
    run (every launch count set to 0 just before and read just after):
    every request completes and every page is freed; one capture for the
    decode step and one for each bucket used, and the replays; the kernel
    counts equal phase 3's (sort) or phase 7's (dropless) per forward times
    the warm-ups plus captures, since a replay counts nothing.  Then, on
    the same engine: the trace warm (its times; the same tokens, no new
    capture, no count moved); the trace with the logits kept, where the
    first tick that runs the decode step and the first that runs the
    busiest bucket are each followed by that step's replay against its
    eager function on a clone of the caches (tokens equal, logits within
    phase 4's tolerance), each request's first-token logits against the
    fixed-batch forward of its prompt (within phase 4's tolerance), all
    logits finite; 8 requests whose decode-only ticks are
    timed (the decode step as a replay against eager, beside phase 3's
    fixed-batch eager step) and profiled.
14. The engine on qwen1.5-0.5b at full width and depth (24 layers), as
    phase 13; it runs no kernel of the port (every count 0), and its
    first-token logits are held to ``QWEN15_FIRST_TOKEN_ATOL``.  Beside it
    the fixed-batch ``generate`` of the same config, warm.  Then the
    first-token comparison again with fp32 compute, held to
    ``FP32_FIRST_TOKEN_ATOL``: the two attentions part only by bf16
    rounding.
15. The engine, card against CPU: reduced qwen3-moe (sort, dropless) and
    reduced qwen1.5 on the same weights and 12 ragged requests: the same
    ticks, and each request's tokens equal or, where they first part, a
    near tie (logits within the tolerance of phase 4, the top-2 margin
    under twice it).
16. The expert-parallel wire: phase 3's serve over a ``(data 2, model 2)``
    mesh of 4 ranks, one process each (``repro_torch.launch.mesh.
    RankPool``), all on the one card under gloo (NCCL refuses two ranks on
    one device), so every collective crosses the host.  Each rank draws
    phase 3's weights (seed 0) and keeps its slice: 32 experts, 16 query
    and 2 KV heads, half the vocabulary; 4 prompts a data rank.  On the
    kernel path (bf16), three configs, each run checked, warm and with the
    time inside ``comm`` taken (the card synchronized around each
    collective): dropless, sort at capacity factor 4 (where no token can
    drop: ``drop_frac`` 0 on every rank and on one rank) and sort at the
    config's factor 2 (its ``drop_frac`` beside one rank's).  Every rank's
    logits must be finite and its launch counts (set to 0 before the run)
    equal its path's per forward: sort 8/4/8, dropless 12 gathers, 12
    combines, 4 ragged FFNs.  Against the one-rank serve of the same
    weights in this process: routing is discrete, and the ranks' sums run
    in other orders, so a token whose router has two near-tied candidates
    takes other experts on one side (``ROUTE_REL``; in bf16 in every row
    at prefill).  So on the kernel path the prefill logits are held as the
    JAX package holds its own bf16 mesh serve (within 5% of the largest)
    and the token agreement and the parted routes are printed; then
    dropless and sort at factor 4 run in fp32 on the plain path, where
    each row is held as phase 15 holds the card to the CPU (tokens equal
    or, where they first part, a near tie; logits within phase 4's
    tolerance) up to the step where its route first parts, at most 1% of
    the token-layers may part and at least half the rows must keep their
    route to the end.  Printed: the slowest rank's prefill and
    decode-step times beside one rank's, and the rows and bytes each rank
    sends at each hop (inter over ``data``, intra over ``model``) a
    forward.  Phase 2 holds the four kernels at a rank's prefill shapes
    too.
17. Training over the same mesh: ``repro_torch.launch.train.train(...,
    mesh=)`` on every rank (``RankPool`` tasks) for smile-3.7b at full
    width with the depth cut to 6 of 12 layers (3 MoE layers; a rank holds
    ~0.49 B fp32 parameters with their gradients and LAMB moments), grid
    (16, 8), global batch 16 x 128 (8 rows a data rank, 512 MoE tokens a
    rank), LAMB, ``router_impl="fused"``, ``sort_impl="radix"``, bf16
    compute: one warm-up step, 3 timed steps, then one step with each
    collective timed (the card synchronized around it); then switch-3.7b,
    the same cut, for 2 steps.  First, in this process, the one-rank
    ``train()`` of the same weights and batches for one step (then
    freed): the mesh's step-1 loss and gradient norm must lie within
    ``tests/distributed/_train_equiv.py``'s bounds of it.  Every rank's
    launch counts (set to 0 just before each run, read just after) must be
    the routing wrappers' 12 (SMILE) or 6 (Switch) calls a step, the other
    kernels' 0 (the expert FFN and the gathers are plain code in training,
    as in the JAX train step), and each arch's routing calls' shapes must
    be the ones phase 2 holds for it.  Printed: the slowest rank's step times and
    tokens/s, each rank's peak memory, a step's collectives by op, axes
    and direction (forward, the backward's ``.grad``, the gradient sync,
    the norms) with rows, bytes and time, and each hop's All2All bytes
    forward and backward for both routers.
18. The robust runtime.  (a) On phase 17's ranks (no second spawn), its
    smile-3.7b config, weights and batches under ZeRO-1 LAMB with the step
    sentinel, through ``build_train_step(..., zero1=True,
    sentinel=True)``: the same 4 steps (one warm-up, 3 timed); step 1's
    gradient norm within 6e-2 relative of phase 17's, steps 2-4's losses
    within 2e-2; the launch counts (set to 0 just before, read just after)
    the routing wrappers' alone, at phase 2's shapes.  A fifth step times
    each collective, as phase 17's fifth does.  Then one step with a
    NaN in one element of rank 3's slice of the last MoE layer's experts:
    every rank must report ``skip == 1`` and keep every tensor of its
    parameters and ZeRO-1 state bit-unchanged (a digest of each, taken on
    the card before and after), and the step clock.  (b) On one rank,
    ``train()`` on smile-3.7b at full width with 2 of 12 layers (a dense
    and a MoE layer), batch 16 x 128, the sentinel on: 4 steps twice, which
    must be bit-identical; then ``ckpt_every=2, ckpt_keep=1,
    halt_after=2`` and ``resume=True``, whose final parameters must be the
    first run's, bit for bit; the snapshots are deleted.  Printed: the
    slowest rank's ms a step and tokens/s and each rank's peak memory
    beside phase 17's, a step's collectives by op and direction (ZeRO-1's
    ``psum_scatter`` and ``all_gather`` over ``data`` beside phase 17's
    gradient psum), the snapshot's bytes and its save, checksum and
    restore seconds.
19. Fault containment, on phase 17's ranks (no second spawn; it runs
    between phase 18's two parts), the kernel path (bf16):
    (a) ``tests/distributed/_faults.py``'s matrix (``fault_cells``: the
    healthy layer under each wire policy, the inert plan, each fault
    kind under ``off``, each wire fault on each hop under ``quarantine``,
    ``counts`` under ``quarantine``, ``bitflip:0`` under ``detect``) on
    qwen3-moe-30b-a3b's MoE layer (phase 16's weights and slice, 256
    tokens a rank, both SMILE hops ragged) and switch-3.7b's (d 768, 128
    experts top-1, 512 tokens a rank), dropless, held to _faults.py's
    exact accounting (``check_fault_cell``: events ``4 x`` the expected,
    ``wire_faults`` at (hop, victim) only, drops of exactly ``1/P``,
    healthy ``detect``/``quarantine`` and the inert plan bit-equal to the
    plain path), with every rank's launch counts its path's a call;
    (b) phase 16's dropless serve (8 new tokens) under ``detect`` and
    ``quarantine`` beside ``off``: tokens and logits bit-equal to ``off``
    on every rank; then each policy twice, warm, in turns (off, detect,
    quarantine, and back) with the collectives timed: the slowest rank's
    prefill and decode-step times, and rank 0's collectives a forward by
    op with their rows, bytes and time;
    (c) phase 17's smile-3.7b cut to one dense and one MoE layer,
    dropless, under ZeRO-1 and the sentinel: a step with ``bitflip:0``
    under ``quarantine`` continues on every rank (finite loss, ``skip``
    0) with ``wire_faults`` at (hop 0, victim) only, ``4 x`` the MoE
    layers; a ``nanrows`` step with the wire off is skipped on every
    rank with every tensor and the step clock bit-unchanged.
20. The rest of serving over phase 16's mesh (4 ranks sharing the card
    under gloo, a new ``RankPool``), after the one-rank runs of the same
    weights in this process.  (a) The continuous-batching engine over the
    mesh (``Engine(..., mesh=)``: every rank runs the same scheduler, the
    decode batch is all 8 slots replicated over ``data``, the steps run
    eagerly) on qwen3-moe-30b-a3b at phase 13's cut (dropless, then sort
    at ``NO_DROP_CF``, where no token drops on either side) and on
    qwen1.5-0.5b at full width and depth, the first 8 of phase 13's
    requests: a bf16 kernel-path run (every launch count set to 0 just
    before and read just after: each rank's its path's per forward times
    the forwards run; 0 captures; the wire timed: the slowest rank's tick,
    TTFT and TPOT mean, p50 and p90, tokens/s, and rank 0's time inside
    ``comm`` by op; rank 0 keeps each kernel's first call at each shape of
    the decode step and of the largest prefill bucket and holds it against
    its plain version after the run), then an fp32 plain-path run.  Every
    rank's tokens equal in each run.  Against the one-rank engine: in bf16
    each request's first-token logits within 5% of the largest (phase
    16's bf16 bound) and the token agreement printed; in fp32 each
    request's tokens equal (or a near tie) and its logits within phase 4's
    tolerance up to the token whose tick parted its route
    (``engine_route_parts``), at most 1% of the token-layers parted and at
    least half the requests keeping their route.  (b) Phase 16's dropless
    serve (a ring cache of 160) with ``kv_seq_shard`` (80 slots a model
    rank, every KV head, the queries all-gathered and the softmax
    partials merged) against the same serve without it, on phase 3's
    weights (the KV projections all-gathered over ``model``), each row
    held by phase 16's ``check_tokens_and_logits`` up to where its route
    parts: fp32 on the plain path (at most 1% of the token-layers parted,
    half the rows keeping their route), bf16 on the kernel path (its
    prefill logits printed), with each rank's launches.  (c) rwkv6-1.6b at
    full width and depth over tensor parallelism (16 of 32 heads a rank):
    the fixed-batch serve (batch 8, prompt 128, 8 new tokens) and the
    cache-less kernel forward (4 x 2,048 tokens; 24 WKV6 launches a rank,
    the kernel held at a rank's shape) against one rank, fp32 within
    phase 4's tolerance (bf16 printed: one extra bf16 rounding a layer, the
    reference's, moves rwkv6's logits at 24 layers by more than their
    spread).
21. The remaining transformer architectures, on one card.  (a)
    deepseek-v3-671b served at full width (MLA: 128 heads, q rank 1,536,
    kv rank 512; 256 experts of 2,048 and a shared one, top-8 over top_g
    4) with the depth cut to 4 of 61 layers (its three dense layers and
    one MoE layer), grid (8, 32) (DeepSeek-V3's n_group 8, topk_group 4),
    the sort dispatch in bf16, batch 8, prompt 128, 8 new tokens (its
    decode steps on the absorbed MLA path): launches, times, peak memory;
    then each of the MoE layer's kernels held against its plain version on
    its first call at each shape the serve gave it (hop 1 at d 7,168 into
    8 nodes, the grouped FFN over 256 experts at prefill and decode, the
    combines), phase 2's tolerances.  (b) deepseek-v3 training at full
    width, one dense MLA layer of 61 and the MTP head, LAMB, batch 4 x
    128: ms a step, ``ce``, ``mtp``, peak memory; then the reduced config
    (its MoE layer, the MTP head, the fused router and the radix sort)
    one step on the card against the CPU.  (c) musicgen-large at full
    width and depth: the serve (batch 8 x 4 codebooks), the cache-less
    kernel forward at 2 x 2,048 (48 flash launches) and a training step.
    (d) phi-3-vision-4.2b at full width: the text serve at full depth, the
    cache-less kernel forward at 2 x 1,024 tokens with 576 image
    embeddings at positions 1-576, and training steps with images at 16 of
    32 layers.  (e) Each reduced config card against CPU: phase 4's
    comparison (bf16, the card's kernels), then fp32 on the plain path,
    where the card must give the CPU's tokens (every codebook's) with its
    logits within phase 4's tolerance.
22. zamba2-2.7b at full width and depth, on one card (54 Mamba2 layers
    in 9 groups of 6, each followed by the one shared attention block;
    2.42 B parameters), weights from seed 0.  (a) ``serve`` in bf16, batch
    8, prompt 128 (one SSD chunk), 16 new tokens: prefill and decode
    times, peak memory, ``param_count`` (the reference's, 3.84 B) beside
    the built count, and every kernel's launches, which must be 0: the
    reference's zamba2 calls no kernel (its Mamba2 ignores
    ``use_kernel``, its shared block runs with ``use_kernel=False``).  (b)
    The cache-less ``forward(..., use_kernel=True)`` at 2 x 2,048 tokens
    (16 chunks): time, peak memory, launches (all 0).  (c) Layer 0's
    intra-chunk inputs ``(xh, dt, loga, B, C)`` of (b), kept on their way
    into ``mamba2.ssd_intra_chunk``: ``ssd_chunk`` against that plain
    function on them, phase 2's tolerance, two calls bit for bit (the
    kernel row "zamba2 path").  (d) ``train()`` at full depth, fp32
    masters, bf16 compute, remat per group, LAMB, batch 2 x 1,024, 3
    steps: ms a step, finite ``ce``, peak memory.  (e) The reduced config
    card against CPU: phase 4's comparison in bf16, printed (one bf16
    rounding a Mamba2 block moves its logits by as much as the tolerance),
    then fp32 on the plain path (the CPU's tokens, logits within phase 4's
    tolerance) and one fp32 training step's loss within phase 6's.
23. The tooling (``repro_torch.analysis``, ``repro_torch.launch.dryrun``).
    (a) The kernel pass over this run's build of all nine kernels: each
    kernel function's registers, spill bytes and static shared memory as
    ``ptxas -v`` reported them in phase 1, and, for each launch
    configuration the profiler recorded in phase 2's timed calls (the
    path's shapes), its threads and its static plus dynamic shared
    memory; an ``smem-budget`` or ``register-limit`` finding fails the
    run, a ``register-spill`` finding is printed with its bytes.  (b) In a
    fresh process (the fake process group must not meet earlier phases'
    groups): the dry run on the meta device of phase 3's serve (qwen3-moe,
    4 of 48 layers, grid (16, 8), batch 8, prompt 128, a 160-token cache)
    and phase 5's training step (smile-3.7b, full depth, batch 16 x 128,
    one pass, LAMB; the plain router, as the meta device runs no kernel):
    the predicted peak (``argument_bytes`` plus ``temp_bytes``) and
    ``argument_bytes`` beside the peak those phases measured
    (``torch.cuda.max_memory_allocated``), with the ratio.  (c) The
    production sweep's headline, four dry runs in parallel processes:
    qwen3-moe-30b-a3b and deepseek-v3-671b at ``train_4k`` on the 16 x 16
    mesh of 256 ranks under SMILE and under Switch (2 of a rank's 16
    micro-batches run, the counts of the forward and backward scaled to
    16): the All2All bytes a rank sends to peers on its 8-GPU node and off
    it, and ``fits``.  The phase prints the card's memory as
    ``torch.cuda.get_device_properties`` gives it, the dry run's default.
24. A ``{"kernels": [...]}`` line, then the card line, then the last line
    ``{"ok": true, "device": {...}}``.

Phase 2 also holds the routing kernels at a phase-17 mesh rank's training
shapes (SMILE's routers (512, 768) x (768, 16) and (1,024, 768) x (768, 8),
sorts of 512 keys over 17 values and 1,024 over 65; Switch's router (512,
768) x (768, 128) and sort of 512 keys over 129 values), and the three kernels of
the cache-less forward against their plain versions: flash attention at
the qwen3 phase's shapes (and at T 128, with as many KV heads as query
heads, and at head sizes 80, 96 and 160, and 256 and 384 on the kernel's
wide route, against ``scaled_dot_product_attention`` as the library's
time), the
WKV6 scan at rwkv6's (4, 4,096, 32, 64) with a nonzero state and bonus
(its final state bit for bit), and the Mamba2 SSD intra-chunk kernel, which
no model calls (phase 22 holds it on the tensors zamba2's forward
computes): its grouped route at zamba2-2.7b's shapes with a typical, a
strongly negative and a steep log-decay (with its blocks, head group and
shared memory), and its general route at chunks of 64 steps; two calls
must give the same bits.  Each phase prints its wall time.

It needs one CUDA card; without one, or without the repository's ``src``
beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the training phase holds ~60 GiB of long-lived tensors beside short-lived
# ones of many sizes; growable segments keep the allocator from fragmenting
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
BF16_TC_FLOPS = 989e12             # H100 SXM dense bf16 tensor cores
FP32_FLOPS = 67e12                 # H100 SXM fp32, outside the tensor cores

# serving shapes: qwen3-moe-30b-a3b, d=2048, f=768, 128 experts, top-8 over
# top_g=4 of 16 nodes, capacity factor 2, batch 8 x prompt 128 (t=1024),
# decode (t=8, also the engine's decode tick at 8 slots) and the engine's
# prefill chunks of one prompt padded to buckets 128 and 64 (t=128, 64).
# At t tokens hop 1 has a capacity of t/2 a node (8t rows) and hop 2 of t/4
# an expert (32t rows over 128 experts)
D_MODEL, D_FF = 2048, 768
# name -> (tokens t, rows R, k) per dispatch/combine hop
GATHER_SHAPES = {
    "prefill hop-1": (1024, 8192, 4),
    "prefill hop-2": (8192, 32768, 2),
    "decode hop-1": (8, 64, 4),
    "decode hop-2": (64, 256, 2),
    "engine 128 hop-1": (128, 1024, 4),
    "engine 128 hop-2": (1024, 4096, 2),
    "engine 64 hop-1": (64, 512, 4),
    "engine 64 hop-2": (512, 2048, 2),
    # a rank of phase 16's (data 2, model 2) mesh at prefill: 4 prompts of
    # 128 tokens split over model, 256 tokens; hop 2 runs on the 2,048 rows
    # hop 1's exchange hands it, into its 64 groups at capacity 128
    "mesh prefill hop-2": (2048, 8192, 2),
}
# (G, T); "scoring" is phase 9's hop 2: 8,192 tokens x 8 experts over 128
# groups at capacity factor 2
FFN_SHAPES = {"prefill": (128, 256), "decode": (128, 2),
              "engine 128": (128, 32), "engine 64": (128, 16),
              "scoring": (128, 2048),
              # a mesh rank's 32 experts, their arrivals from both model
              # ranks at capacity 128
              "mesh prefill": (32, 256)}
# the dropless serve's hop 2: the hop-1 slab's rows (real ones), k=2 experts
# of the arrival node's 8 each, over 128 expert groups.  The slab holds the
# 4t hop-1 assignments in tiles of b rows, one partial tile a node:
# (ceil(4t / b) + 16) * b rows, b = 64 at t = 1,024, 32 at 128, 16 at 64, 8
# at 8 (core/dispatch.py ``_ragged_block``, ``ragged_rows``)
RAGGED_SHAPES = {"prefill hop-2": (5120, 4096), "decode hop-2": (160, 32),
                 "engine 128 hop-2": (1024, 512),
                 "engine 64 hop-2": (512, 256),
                 # a mesh rank at prefill: the hop-2 exchange's slab (2 x
                 # 12,288 rows, about 2,048 real arrivals) compacted over
                 # the rank's 32 experts, one each: 26,624 rows, block 64
                 "mesh prefill": (24576, 2048, 32, 1)}
N_NODES, PER_NODE, K_LOCAL = 16, 8, 2
# the tolerance of tests/test_torch_serve.py for bf16 logits
LOGITS_ATOL = 3e-2
FFN_RTOL = FFN_ATOL = 2e-2
# training shapes: smile-3.7b, d=768, batch 16 x seq 128 (t=2048), grid
# (16, 8): (name, t, E, k, dtype, ties) per router call and (name, A, keys)
# per sort
ROUTER_SHAPES = [("train hop-1", 2048, 16, 1, "bf16", False),
                 ("train hop-2", 4096, 8, 1, "bf16", False),
                 # a rank of phase 17's (data 2, model 2) mesh: 8 rows of
                 # 128 a data rank, split over model (512 tokens); hop 2
                 # routes the 8 local nodes' arrivals from both data ranks
                 # at capacity 64 (1,024 rows)
                 ("mesh train hop-1", 512, 16, 1, "bf16", False),
                 ("mesh train hop-2", 1024, 8, 1, "bf16", False),
                 # switch-3.7b on the same rank: one flat hop over all 128
                 # experts (another template than "switch flat" at 2,048)
                 ("mesh switch flat", 512, 128, 1, "bf16", False),
                 ("switch flat", 2048, 128, 1, "bf16", False),
                 ("bf16 ties k2", 2048, 16, 2, "bf16", True)]
# (name, A, keys, draw): "skew" puts a third of the keys on one value, as a
# hot expert; "equal" puts them all on one.  4,096 is the largest A the
# one-launch route takes (ops.SORT_ONE_MAX_A), one more the smallest that
# takes three launches; 2**20 keys run three launches at 129 key values
# and at the most the kernel takes
SORT_SHAPES = [("train hop-1", 2048, 17, "skew"),
               ("train hop-2", 4096, 129, "skew"),
               # phase 17's mesh rank: hop 2 sorts into its 8 local nodes'
               # 8 experts each (64 groups)
               ("mesh train hop-1", 512, 17, "skew"),
               ("mesh train hop-2", 1024, 65, "skew"),
               ("mesh switch flat", 512, 129, "skew"),
               ("all equal", 4096, 129, "equal"),
               ("one-launch edge", 4096, 17, "skew"),
               ("past the edge", 4097, 17, "skew"),
               ("2**20 keys", 1 << 20, 129, "skew"),
               ("2**20 over 8192", 1 << 20, 8192, "skew")]
# both sort routes, each forced, at these key counts (up to the one-launch
# edge) and key values: whether one launch still pays at its edge
SORT_CROSSOVER_A = (1024, 2048, 3072, 4096)
SORT_CROSSOVER_K = (17, 129, 1024)
# the training paths' shapes, where one call must launch one kernel
ONE_KERNEL_SHAPES = ("train hop-1", "train hop-2", "mesh train hop-1",
                     "mesh train hop-2", "mesh switch flat")
# the router's logits are fp32 sums of 768 products; the kernel and cuBLAS
# (TF32 off) each land up to ~1e-6 from the fp64 product at these shapes
# (measured on the card: 8.8e-7 and 9.7e-7), in other directions, so their
# difference reaches ~2e-6 where a logit is near 0; probs inherit it
ROUTER_RTOL, ROUTER_ATOL = 1e-5, 4e-6
# bf16 compute with other summation orders, through 2 layers and 3 steps
TRAIN_LOSS_ATOL = 3e-2

SOURCES = {
    "dispatch_gather": ("src/repro_torch/kernels/csrc/dispatch_gather.cu",
                        "src/repro/kernels/moe_dispatch.py:49"),
    "grouped_ffn": ("src/repro_torch/kernels/csrc/grouped_ffn.cu",
                    "src/repro/kernels/grouped_ffn.py:103"),
    "combine_gather": ("src/repro_torch/kernels/csrc/combine_gather.cu",
                       "src/repro/kernels/moe_dispatch.py:94"),
    "router_fused": ("src/repro_torch/kernels/csrc/router_fused.cu",
                     "src/repro/kernels/router_fused.py:150"),
    "group_sort": ("src/repro_torch/kernels/csrc/group_sort.cu",
                   "src/repro/kernels/radix_sort.py:115"),
    "grouped_ffn_ragged": ("src/repro_torch/kernels/csrc/grouped_ffn_ragged.cu",
                           "src/repro/kernels/grouped_ffn.py:148"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attn.cu",
                        "src/repro/kernels/flash_attn.py:54"),
    "rwkv6_scan": ("src/repro_torch/kernels/csrc/rwkv6_scan.cu",
                   "src/repro/kernels/rwkv6_scan.py:42"),
    "ssd_chunk": ("src/repro_torch/kernels/csrc/ssd_chunk.cu",
                  "src/repro/kernels/ssd_chunk.py:55"),
}

# the cache-less scoring forward's kernels: (B, T, H, KV, hd) per flash call
# (qwen3-moe-30b-a3b's attention at the path's batch 2 x 4,096, at T 128,
# with KV = H, and at other models' head sizes), rwkv6-1.6b's WKV at batch
# 4 x 4,096, and the SSD terms
# at zamba2-2.7b's shapes (no model calls that kernel) with a typical and a
# strongly negative log-decay per step
FLASH_SHAPES = {"qwen3 path": (2, 4096, 32, 4, 128),
                "T 128": (2, 128, 32, 4, 128),
                "KV = H": (1, 2048, 16, 16, 128),
                # the head sizes of zamba2-2.7b, phi3-vision and
                # stablelm-12b, which the kernel runs padded to 128 and 192
                "hd 80": (1, 2048, 32, 32, 80),
                "hd 96": (1, 2048, 32, 32, 96),
                "hd 160": (1, 2048, 32, 8, 160),
                # phase 21's cache-less forwards: musicgen-large (2 x 2,048
                # tokens, 32 heads of 64) and phi-3-vision (2 x 1,024, 32
                # heads of 96)
                "musicgen path": (2, 2048, 32, 32, 64),
                "phi3 path": (2, 1024, 32, 32, 96),
                # past 192: the wide route (no config of either package
                # has such heads; the Pallas kernel takes any)
                "hd 256": (1, 2048, 16, 8, 256),
                "hd 384": (1, 2048, 8, 8, 384)}
# the kernel scales q in bf16 and rounds the probabilities to bf16 before
# PV (as the Pallas body); the plain version does both in fp32.  Each output
# is held within one bf16 ulp of the plain one (both round once: values that
# straddle a rounding boundary land an ulp apart) plus FLASH_ROW_ATOL of its
# row's RMS over hd (the rounded weights' noise scales with the row, whose
# size falls as 1/sqrt(t) along the sequence; a dropped 64-key tile moves a
# row's largest error at t = 4,096 by tenths of its RMS).  Both readings
# are printed
FLASH_ROW_ATOL = 3e-2
RWKV_SHAPE = (4, 4096, 32, 64)                       # (B, T, nh, hd)
# y's sum over i runs in another order than the plain version's product:
# fp32 rounding of terms of the outputs' size
RWKV_RTOL, RWKV_ATOL_REL = 1e-5, 1e-6
# (B, nc, Q, nh, hd, ds, loga low, loga high) per SSD call: zamba2-2.7b's
# chunks (Q 128, 80 heads of 64, d_state 64) with a typical, a strongly
# negative and a steep log-decay a step (the grouped route; at the last,
# three steps' growth exp(cs_i - cs_j), i < j, overflows), and chunks of 64
# steps, which only the general route takes
SSD_SHAPES = {"zamba2 typical": (4, 32, 128, 80, 64, 64, -1.0, 0.0),
              "zamba2 loga<=-5": (4, 32, 128, 80, 64, 64, -8.0, -5.0),
              "zamba2 loga<=-30": (4, 32, 128, 80, 64, 64, -40.0, -30.0),
              "Q 64 (general)": (4, 32, 64, 80, 64, 64, -1.0, 0.0)}
# the matrix products sum in other orders than the plain version's, and a
# cumsum in another order would round cs by up to an ulp of |cs| a step,
# which the exponentials carry as a relative error (both kernels keep the
# plain version's step order)
SSD_RTOL, SSD_ATOL_REL = 1e-4, 1e-5
# the tolerances of tests/test_torch_flash_attn.py (qwen3, bf16: per-token
# relative error at the 90th percentile, share of tokens over 3e-2) and of
# tests/test_torch_rwkv6.py (rwkv6: max error over max |logit|, by dtype)
QWEN_P90, QWEN_FLIPPED = 2e-2, 0.05
RWKV_LOGITS_REL = {"float32": 1e-4, "bfloat16": 1e-2}


# profiler windows kernel_times takes before it falls back to per-launch means
PROFILE_WINDOWS = 5


class ProfilerSawNothing(RuntimeError):
    """No profiler window of :func:`kernel_times` saw a kernel."""


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3, flush=None) -> float:
    """CUDA-event time per call of ``fn``: over ``iters`` calls in a row,
    or, with ``flush``, over each call alone after ``flush()`` has pushed
    its data out of L2."""
    import torch
    for _ in range(warmup):
        fn()
    if flush is None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    pairs = []
    for _ in range(iters):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def kernel_times(torch, fn, iters: int = 20, flush=None):
    """``{kernel name: (device ms, launches)}`` per call of ``fn``, from the
    profiler's CUDA activity: the card's own time, without the host's.
    With ``flush``, ``flush()`` runs before each call and its kernels are
    left out by name (:class:`L2Flush`)."""
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    skip = flush.names if flush is not None else set()

    def body():
        for _ in range(iters):
            if flush is not None:
                flush()
            fn()

    # the profiler at times drops launches from a window (17 of 20 calls'
    # kernels, three windows in a row, late in phase 2; every kernel of
    # five windows in phase 22, after 21 phases, whatever the pads or the
    # activities, while phase 22 alone sees them all): each window is
    # padded with idle host time at both ends, and a window in which a
    # kernel did not launch a whole number of times a call is taken again
    best = {}
    for window in range(PROFILE_WINDOWS):
        out = {}
        prof = profile_window(torch, body)
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.key not in skip:
                us = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
                us0, n = out.get(e.key, (0.0, 0))
                out[e.key] = (us0 + us, n + e.count)
        if out and all(n % iters == 0 for _, n in out.values()):
            if window:
                print(f"    (the profiler dropped launches in {window} "
                      f"window(s) before this one)")
            keep_launches(prof)
            return {k: (us / iters / 1e3, n // iters)
                    for k, (us, n) in out.items()}
        if (sum(n for _, n in out.values())
                > sum(n for _, n in best.values())):
            best = out
    # every window lost some: each kernel's launches a call rounded, its
    # time the mean of the launches the profiler kept
    got = {k: (us / n * max(1, round(n / iters)) / 1e3,
               max(1, round(n / iters))) for k, (us, n) in best.items()}
    if not got:
        raise ProfilerSawNothing("the profiler saw no kernel in "
                                 f"{PROFILE_WINDOWS} windows")
    print(f"    (the profiler dropped launches in {PROFILE_WINDOWS} "
          f"windows; kept {sum(n for _, n in best.values())} of "
          f"{iters * sum(c for _, c in got.values())}: per-launch means)")
    return got


# the launch configurations (registers, threads, shared memory) of the
# kernels kernel_times saw, for phase 23 (a)'s kernel pass
LAUNCHES_SEEN = set()


def keep_launches(prof) -> None:
    """Add a timed window's kernel launches to :data:`LAUNCHES_SEEN`."""
    from repro_torch.analysis import kernel_lint
    LAUNCHES_SEEN.update(kernel_lint.launches_from_profile(prof))


def profile_window(torch, body, pad_s: float = 0.005):
    """A profiler window of CUDA activity around ``body()``, with
    ``pad_s`` of idle host time before the first launch and after the
    last kernel has finished."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        body()
        torch.cuda.synchronize()
        time.sleep(pad_s)
    return prof


def device_ms(torch, fn, iters: int = 20, flush=None) -> float:
    """Device time per call of the kernels ``fn`` launches (see
    :func:`kernel_times`); where no profiler window saw a kernel, the
    CUDA-event time of a call (:func:`time_ms`), which adds the launch's
    host time to the kernels', and says so."""
    try:
        times = kernel_times(torch, fn, iters, flush)
    except ProfilerSawNothing as e:
        print(f"    ({e}: CUDA-event time a call instead)")
        return time_ms(fn, iters, flush=flush)
    return sum(ms for ms, _ in times.values())


class L2Flush:
    """A write of zeros over a buffer twice the card's 50 MB L2, so that
    the next call finds its data in device memory, as a call on the path
    does after the layer's other work.  ``names`` holds its kernels' names,
    which :func:`kernel_times` leaves out."""

    def __init__(self, torch):
        from torch.autograd import DeviceType
        self.buf = torch.empty((100 << 20,), dtype=torch.uint8, device="cuda")
        self()
        torch.cuda.synchronize()

        def body():
            for _ in range(5):
                self()

        self.names = {e.key for e in profile_window(torch, body)
                      .key_averages() if e.device_type == DeviceType.CUDA}

    def __call__(self):
        self.buf.zero_()


def split_line(split) -> str:
    """A kernel split as 'n kernels a call: name ms (launches), ...'."""
    n = sum(c for _, c in split.values())
    parts = ", ".join(f"{name[:60]} {ms:.4f} ms x{c:g}"
                      for name, (ms, c) in sorted(split.items(),
                                                  key=lambda kv: -kv[1][0]))
    return f"{n:g} kernels a call: {parts}"


def bound(nbytes: float, ops: float, peak_ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak_ops
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops
            else "operations")


def make_row(name, shape, got, want, ms, plain_ms, b, library_ms=None):
    """A kernel's row (its error against the plain version, its times and
    bound) and the line that prints it."""
    err = (got.float() - want.float()).abs().max().item()
    rel = err / max(want.float().abs().max().item(), 1e-30)
    lib = ("n/a" if library_ms is None else f"{library_ms:.4f} ms, kernel "
           f"{ms / library_ms:.2f}x of it")
    line = (f"  {name:15s} {shape:13s} max abs err {err:.3e} (over max "
            f"|ref|: {rel:.2e})  kernel {ms:.4f} ms  plain "
            f"{plain_ms:.4f} ms  bound {b[0]:.4f} ms ({b[1]}; kernel at "
            f"{100 * b[0] / ms:.1f}% of it)  library {lib}")
    return dict(name=name, shape=shape, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
                library_ms=library_ms), line


def add_row(rows, name, shape, got, want, ms, plain_ms, b,
            library_ms=None):
    row, line = make_row(name, shape, got, want, ms, plain_ms, b,
                         library_ms)
    rows.setdefault(name, []).append(row)
    print(line)


def phase_kernels(torch, ops, ref):
    """Each kernel against its plain version at the path's shapes."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    bf = torch.bfloat16
    rows = {}

    def record(name, shape, got, want, ms, plain_ms, b, library_ms=None):
        add_row(rows, name, shape, got, want, ms, plain_ms, b, library_ms)

    # the gathers are timed cold (an L2 flush before each call): on the
    # path the layer's other work has pushed their rows out of L2, and
    # warm, the rows of a 1,024-token hop fit in it and beat HBM's bound
    flush = L2Flush(torch)
    for shape, (t, R, k) in GATHER_SHAPES.items():
        # dispatch: x (t, d) -> (R, d); a quarter of the slots empty
        x = torch.randn((t, D_MODEL), generator=gen, device=dev).to(bf)
        src = torch.randint(0, t, (R,), generator=gen, device=dev,
                            dtype=torch.int32)
        empty = torch.rand((R,), generator=gen, device=dev) < 0.25
        src = torch.where(empty, torch.full_like(src, -1), src)
        got = ops.dispatch_gather(x, src)
        want = ref.dispatch_gather_ref(x, src)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"dispatch_gather {shape}: not bit-exact")
        used = torch.unique(src[src >= 0]).numel()
        nbytes = used * D_MODEL * 2 + R * 4 + R * D_MODEL * 2

        def dispatch():
            return ops.dispatch_gather(x, src)

        print(f"  dispatch_gather {shape}: device time, L2 flushed before "
              f"each call {device_ms(torch, dispatch, flush=flush):.4f} ms, "
              f"warm {device_ms(torch, dispatch):.4f} ms a call")
        record("dispatch_gather", shape, got, want,
               time_ms(dispatch, flush=flush),
               time_ms(lambda: ref.dispatch_gather_ref(x, src), flush=flush),
               bound(nbytes, 0, FP32_FLOPS))

        # combine: the hop's R buffer rows back to its t tokens, k each
        buf = torch.randn((R, D_MODEL), generator=gen, device=dev).to(bf)
        csrc = torch.randint(0, R, (t, k), generator=gen, device=dev,
                             dtype=torch.int32)
        drop = torch.rand((t, k), generator=gen, device=dev) < 0.1
        csrc = torch.where(drop, torch.full_like(csrc, -1), csrc)
        scale = torch.rand((t, k), generator=gen, device=dev)
        got = ops.combine_gather(buf, csrc, scale)
        want = ref.combine_gather_ref(buf, csrc, scale)
        torch.cuda.synchronize()
        wf = want.float()
        ulp = torch.where(wf == 0, torch.full_like(wf, 1e-30),
                          wf.abs() * 2.0 ** -7)
        if not bool(((got.float() - wf).abs() <= ulp).all()):
            raise AssertionError(f"combine_gather {shape}: more than 1 bf16 "
                                 f"ulp from the plain version")
        valid = int((csrc >= 0).sum())
        used = torch.unique(csrc[csrc >= 0]).numel()
        nbytes = used * D_MODEL * 2 + t * k * 8 + t * D_MODEL * 2

        def combine():
            return ops.combine_gather(buf, csrc, scale)

        print(f"  combine_gather  {shape}: device time, L2 flushed before "
              f"each call {device_ms(torch, combine, flush=flush):.4f} ms, "
              f"warm {device_ms(torch, combine):.4f} ms a call")
        record("combine_gather", shape, got, want,
               time_ms(combine, flush=flush),
               time_ms(lambda: ref.combine_gather_ref(buf, csrc, scale),
                       flush=flush),
               bound(nbytes, 2.0 * valid * D_MODEL, FP32_FLOPS))
    del flush

    for shape, (G, T) in FFN_SHAPES.items():
        x = torch.randn((G, T, D_MODEL), generator=gen, device=dev).to(bf)
        w1 = (torch.randn((G, D_MODEL, D_FF), generator=gen, device=dev)
              / D_MODEL ** 0.5).to(bf)
        w3 = (torch.randn((G, D_MODEL, D_FF), generator=gen, device=dev)
              / D_MODEL ** 0.5).to(bf)
        w2 = (torch.randn((G, D_FF, D_MODEL), generator=gen, device=dev)
              / D_FF ** 0.5).to(bf)
        got = ops.grouped_ffn(x, w1, w3, w2, act="silu")
        want = ref.grouped_ffn_ref(x, w1, w3, w2, act="silu")
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        if not bool((diff <= FFN_ATOL + FFN_RTOL * want.float().abs()).all()):
            raise AssertionError(f"grouped_ffn {shape}: outside rtol "
                                 f"{FFN_RTOL} / atol {FFN_ATOL}")

        def library():
            return torch.bmm(F.silu(torch.bmm(x, w1)) * torch.bmm(x, w3), w2)

        nbytes = (2 * G * T * D_MODEL + 3 * G * D_MODEL * D_FF) * 2
        flops = 2.0 * G * T * D_MODEL * D_FF * 3
        dms = device_ms(torch, lambda: ops.grouped_ffn(x, w1, w3, w2,
                                                        act="silu"), iters=5)
        print(f"  grouped_ffn     {shape}: device time {dms:.4f} ms a call")
        record("grouped_ffn", shape, got, want,
               time_ms(lambda: ops.grouped_ffn(x, w1, w3, w2, act="silu")),
               time_ms(lambda: ref.grouped_ffn_ref(x, w1, w3, w2,
                                                   act="silu")),
               bound(nbytes, flops, BF16_TC_FLOPS), time_ms(library))
    return rows


def hop2_layout(torch, gen, slab: int, real: int,
                groups: int = N_NODES * PER_NODE, k: int = K_LOCAL):
    """A dropless expert-FFN layout from a real ``dispatch_ragged`` on the
    card: ``slab`` arrival rows (the first ``real`` real, the rest zeros,
    as an exchange hands them over), each routed to K_LOCAL distinct
    experts of its arrival node (or, with ``k=1``, to one of ``groups``).
    Returns ``(rows, group_starts, block, valid assignments)``."""
    from repro_torch.core import dispatch as D
    dev = torch.device("cuda")
    valid_row = torch.arange(slab, device=dev) < real
    x = torch.randn((slab, D_MODEL), generator=gen, device=dev)
    x = (x * valid_row[:, None]).to(torch.bfloat16)
    if k == 1:
        gid = torch.randint(0, groups, (slab,), generator=gen, device=dev,
                            dtype=torch.int32)
    else:
        node = torch.randint(0, N_NODES, (slab,), generator=gen, device=dev)
        q = torch.rand((slab, PER_NODE), generator=gen, device=dev).argsort(
            dim=1)[:, :k]
        gid = (node[:, None] * PER_NODE + q).reshape(-1).to(torch.int32)
    valid = valid_row.repeat_interleave(k)
    gates = torch.rand((slab * k,), generator=gen, device=dev)
    rows, starts, st = D.dispatch_ragged(x, gid, gates, groups, k=k,
                                         valid=valid, use_kernel=True)
    return rows, starts, st.cap, gid[valid]


def phase_ragged_ffn(torch, ops, ref, rows_out):
    """The ragged grouped FFN against its plain version at the dropless
    serve's hop-2 shapes."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(99)
    bf = torch.bfloat16
    G = N_NODES * PER_NODE
    w1 = (torch.randn((G, D_MODEL, D_FF), generator=gen, device=dev)
          / D_MODEL ** 0.5).to(bf)
    w3 = (torch.randn((G, D_MODEL, D_FF), generator=gen, device=dev)
          / D_MODEL ** 0.5).to(bf)
    w2 = (torch.randn((G, D_FF, D_MODEL), generator=gen, device=dev)
          / D_FF ** 0.5).to(bf)
    for shape, (slab, real, *layout) in RAGGED_SHAPES.items():
        rows, starts, block, gids = hop2_layout(torch, gen, slab, real,
                                                *layout)
        g = starts.shape[0] - 1
        v1, v3, v2 = w1[:g], w3[:g], w2[:g]

        def kernel():
            return ops.grouped_ffn_ragged(rows, starts, v1, v3, v2,
                                          block=block, act="silu")

        got = kernel()
        want = ref.grouped_ffn_ragged_ref(rows, starts, v1, v3, v2,
                                          act="silu")
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        if not bool((diff <= FFN_ATOL + FFN_RTOL * want.float().abs()).all()):
            raise AssertionError(f"grouped_ffn_ragged {shape}: outside rtol "
                                 f"{FFN_RTOL} / atol {FFN_ATOL}")
        end = int(starts[-1])
        if bool(got[end:].any()):
            raise AssertionError(f"grouped_ffn_ragged {shape}: tail tiles "
                                 f"not zero")
        R, n_real = rows.shape[0], gids.numel()
        experts = torch.unique(gids).numel()
        nbytes = (experts * 3 * D_MODEL * D_FF + 2 * n_real * D_MODEL) * 2
        flops = 6.0 * D_MODEL * D_FF * n_real
        print(f"  grouped_ffn_ragged {shape}: R {R} rows, block {block}, "
              f"{R // block} tiles; {n_real} real rows, {end} rows in "
              f"{end // block} tiles computed (the rest are tail tiles, "
              f"written as zeros); {experts} experts touched; device time "
              f"{device_ms(torch, kernel):.4f} ms a call")
        add_row(rows_out, "grouped_ffn_ragged", shape, got, want,
                time_ms(kernel),
                time_ms(lambda: ref.grouped_ffn_ragged_ref(
                    rows, starts, v1, v3, v2, act="silu")),
                bound(nbytes, flops, BF16_TC_FLOPS))


def check_router(torch, ref, got, want, k, shape):
    """The router kernel against its plain version on the same inputs:
    logits and probs within ROUTER_RTOL / ROUTER_ATOL; ids equal on every
    row whose top-(k+1) probabilities are more than 1e-6 apart; ranks and
    starts bit-exact against the counting sort of the kernel's own ids;
    gates the kernel's probs at its ids.  Returns the rows closer."""
    gates, idx, probs, logits, ranks, starts = got
    for what, a, b in (("logits", logits, want[3]), ("probs", probs, want[2])):
        bad = (a - b).abs() > ROUTER_ATOL + ROUTER_RTOL * b.abs()
        if bool(bad.any()):
            raise AssertionError(
                f"router_fused {shape}: {int(bad.sum())} {what} outside "
                f"rtol {ROUTER_RTOL} / atol {ROUTER_ATOL}; max abs err "
                f"{(a - b).abs().max().item():.3e}")
    E = probs.shape[1]
    top = want[2].sort(dim=1, descending=True).values[:, :min(k + 1, E)]
    close = ((top[:, :-1] - top[:, 1:]) <= 1e-6).any(dim=1)
    if not torch.equal(idx[~close], want[1][~close]):
        raise AssertionError(f"router_fused {shape}: ids differ on rows "
                             f"whose top-{k + 1} probabilities are apart")
    r, st = ref.group_sort_ref(idx.reshape(-1), E)
    if not (torch.equal(ranks, r) and torch.equal(starts, st)):
        raise AssertionError(f"router_fused {shape}: ranks/starts differ "
                             f"from the counting sort of its ids")
    if not torch.equal(gates, probs.gather(1, idx.long())):
        raise AssertionError(f"router_fused {shape}: gates are not the "
                             f"probs at the chosen ids")
    return int(close.sum())


def phase_routing_kernels(torch, ops, ref, rows):
    """The training path's two kernels against their plain versions, each
    call's kernels by name from the profiler (a call at the path's shapes
    must launch exactly one)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4321)
    d = 768

    def split(what, shape, fn):
        got = kernel_times(torch, fn)
        print(f"    {what} {shape}: {split_line(got)}")
        n = sum(c for _, c in got.values())
        if shape in ONE_KERNEL_SHAPES and n != 1:
            raise AssertionError(f"{what} {shape}: {n:g} kernels a call, "
                                 f"expected 1")
        return sum(ms for ms, _ in got.values())

    for shape, t, E, k, _, ties in ROUTER_SHAPES:
        x = torch.randn((t, d), generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn((d, E), generator=gen, device=dev) / d ** 0.5
        if ties:
            # bf16-rounded weights with two equal columns: every row ties
            w = w.to(torch.bfloat16).float()
            w[:, 5] = w[:, 3]
        got = ops.router_fused(x, w, k)
        want = ref.router_fused_ref(x, w, k)
        torch.cuda.synchronize()
        closer = check_router(torch, ref, got, want, k, shape)
        exact = x.double() @ w.double()

        def kernel():
            return ops.router_fused(x, w, k)

        dms = split("router_fused", shape, kernel)
        print(f"  router_fused    {shape}: {closer} of {t} rows have top-"
              f"{k + 1} probabilities within 1e-6; logits max abs err "
              f"against fp64: kernel "
              f"{(got[3].double() - exact).abs().max().item():.3e}, plain "
              f"{(want[3].double() - exact).abs().max().item():.3e}; device "
              f"time {dms:.4f} ms a call")
        nbytes = (t * d * 2 + d * E * 4 + 2 * t * E * 4 + 3 * t * k * 4
                  + (E + 1) * 4)
        add_row(rows, "router_fused", shape,
                torch.cat([got[3].flatten(), got[2].flatten()]),
                torch.cat([want[3].flatten(), want[2].flatten()]),
                time_ms(kernel), time_ms(lambda: ref.router_fused_ref(x, w, k)),
                bound(nbytes, 2.0 * t * d * E, FP32_FLOPS))
    for shape, A, K, draw in SORT_SHAPES:
        keys = sort_keys(torch, gen, A, K, draw)
        got = ops.group_sort(keys, K, impl="radix")
        want = ref.group_sort_ref(keys, K)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                             want[1])):
            raise AssertionError(f"group_sort {shape}: not bit-exact")

        def kernel():
            return ops.group_sort(keys, K, impl="radix")

        dms = split("group_sort", shape, kernel)
        lib_dms = device_ms(torch, lambda: torch.sort(keys, stable=True))
        print(f"  group_sort      {shape}: {A} keys over {K}, "
              f"{ops.sort_route(A, K)}; bit-exact; device "
              f"time {dms:.4f} ms a call; torch.sort(stable=True) "
              f"{lib_dms:.4f} ms (kernel {dms / lib_dms:.2f}x of it)")
        add_row(rows, "group_sort", shape, torch.cat(got).float(),
                torch.cat(want).float(), time_ms(kernel),
                time_ms(lambda: ref.group_sort_ref(keys, K)),
                bound(8.0 * A + 4.0 * (K + 1), 0, FP32_FLOPS),
                time_ms(lambda: torch.sort(keys, stable=True)))


def sort_keys(torch, gen, A, K, draw):
    """A keys in [0, K) as SORT_SHAPES' ``draw`` says."""
    dev = torch.device("cuda")
    if draw == "equal":
        return torch.full((A,), K // 3, dtype=torch.int32, device=dev)
    keys = torch.randint(0, K, (A,), generator=gen, device=dev,
                         dtype=torch.int32)
    hot = torch.rand((A,), generator=gen, device=dev) < 1 / 3
    return torch.where(hot, torch.full_like(keys, K // 3), keys)


def phase_sort_crossover(torch, ops, ref):
    """Both routes of the counting sort, each forced, held bit-exact and
    timed on the device at SORT_CROSSOVER_A x SORT_CROSSOVER_K, up to
    the one-launch route's edge."""
    gen = torch.Generator(device="cuda").manual_seed(99)
    for K in SORT_CROSSOVER_K:
        cells = []
        for A in SORT_CROSSOVER_A:
            keys = sort_keys(torch, gen, A, K, "skew")
            want = ref.group_sort_ref(keys, K)
            times = []
            for route in (ops._one_launch_route(A),
                          ops._three_launch_route(A, K)):
                got = ops._group_sort_cuda(keys, K, route)
                if not (torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1])):
                    raise AssertionError(f"group_sort {A} keys over {K}, "
                                         f"{route}: not bit-exact")
                times.append(device_ms(
                    torch, lambda: ops._group_sort_cuda(keys, K, route)))
            cells.append(f"{A} {times[0]:.4f}/{times[1]:.4f}")
        print(f"  group_sort routes over {K} values, keys one/three-launch "
              f"device ms: {', '.join(cells)}")


def phase_launch_floor(torch, ops):
    """An empty kernel launched through the kernels' ctypes path: the least
    device time and CUDA-event time that any one-launch kernel pays."""
    from repro_torch.kernels import _build
    lib = _build.load("group_sort")

    def empty():
        ops._check(lib.launch_floor(ops._stream()), "launch_floor")

    dms = device_ms(torch, empty, iters=100)
    ms = time_ms(empty, iters=100)
    print(f"  launch floor (an empty kernel through ctypes): device "
          f"{dms:.4f} ms, CUDA events {ms:.4f} ms a call")
    return dms, ms


SERVE = dict(arch="qwen3-moe-30b-a3b", reduced=False, num_layers=4,
             moe_grid=(16, 8))
# torch.cuda.max_memory_allocated of phase 3's serve and phase 5's
# training run, for phase 23 (b)
MEASURED_PEAKS = {}


def phase_serve(torch, ops):
    """The main path: serve() once, every launch count set to 0 just
    before and read just after."""
    from repro_torch.launch.serve import serve
    from repro_torch.common.config import ServeConfig
    sc = ServeConfig()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = serve(SERVE["arch"], reduced=False, batch=sc.batch_size,
                prompt_len=sc.prompt_len, new_tokens=sc.max_new_tokens,
                seed=0, device="cuda", num_layers=SERVE["num_layers"],
                moe_grid=SERVE["moe_grid"])
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    MEASURED_PEAKS["serve"] = peak
    steps = res.decode_steps
    print(f"  first call: prefill {res.prefill_s * 1e3:.2f} ms "
          f"({sc.batch_size} x {sc.prompt_len} tokens); decode "
          f"{res.decode_s / steps * 1e3:.2f} ms per step over {steps} steps "
          f"({steps * res.batch / res.decode_s:.1f} tokens/s)")
    print(f"  first generated row: {res.tokens[0].tolist()}")
    print(f"  launches: prefill {res.launches['prefill']}, "
          f"decode {res.launches['decode']}")
    print(f"  max_memory_allocated {peak / 2**30:.2f} GiB")
    if not res.logits_finite:
        raise AssertionError("serve: non-finite logits")
    for phase, n in (("prefill", 1), ("decode", steps)):
        want = {k: v * n for k, v in SORT_PER_FORWARD.items()}
        if res.launches[phase] != want:
            raise AssertionError(f"serve {phase}: launches "
                                 f"{res.launches[phase]}, expected {want}")
    if res.tokens.shape != (sc.batch_size, sc.max_new_tokens):
        raise AssertionError(f"serve: tokens {res.tokens.shape}")
    return launches, res


def phase_warm(torch, first, profiled_tokens=None):
    """serve()'s weights and prompts through generate() again: warm times,
    then the same run (or one of ``profiled_tokens`` new tokens) under the
    profiler for the device time by kernel, the idle share, and the host's
    op, launch and synchronization counts."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import generate
    inp = first.inputs
    new_tokens = first.tokens.shape[1]

    def run(n=new_tokens):
        return generate(inp.params, inp.prompts, inp.cfg, inp.plan,
                        new_tokens=n)

    res = run()
    steps = res.decode_steps
    print(f"  warm: prefill {res.prefill_s * 1e3:.2f} ms; decode "
          f"{res.decode_s / steps * 1e3:.2f} ms per step "
          f"({steps * res.batch / res.decode_s:.1f} tokens/s); tokens equal "
          f"to the first call: {bool((res.tokens == first.tokens).all())}")
    warm_step_ms = res.decode_s / steps * 1e3
    torch.cuda.synchronize()
    n = profiled_tokens or new_tokens
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(n)
        wall_us = (time.perf_counter() - t0) * 1e6
    profile_summary(prof, wall_us, n, "forward")
    return warm_step_ms


def profile_summary(prof, wall_us: float, n: int, unit: str, top: int = 12,
                    shares=(), counted=()):
    """Device time by kernel, idle share, and the host's op, launch and
    synchronization counts per ``unit`` from a profiled run of ``n`` units
    that took ``wall_us``; for each name in ``shares``, the share of the
    busy time of the kernels whose names hold it; for each name in
    ``counted``, the launches per ``unit`` of the kernels whose names hold
    it.  Returns the device busy time in us and ``{name: launches per
    unit}`` for ``counted``."""
    from torch.autograd import DeviceType
    dev, runtime, count = {}, {}, {}
    for e in prof.key_averages():
        # device-side kernel entries only: a CPU op's entry repeats the time
        # of the kernels it launched, and a profiler range's device span
        # (train_step.*) covers kernels counted on their own
        if (e.device_type == DeviceType.CUDA
                and not e.key.startswith("train_step.")):
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            dev[e.key] = dev.get(e.key, 0.0) + us
            count[e.key] = count.get(e.key, 0) + e.count
        elif e.key.startswith("cuda"):
            runtime[e.key] = runtime.get(e.key, 0) + e.count
    busy = sum(dev.values())
    # aten ops not called from another aten op (a profiler range is no op)
    top_ops = sum(1 for e in prof.events() if e.name.startswith("aten::")
                  and (e.cpu_parent is None
                       or not e.cpu_parent.name.startswith("aten::")))
    launches = sum(k for name, k in runtime.items() if "Launch" in name)
    syncs = sum(k for name, k in runtime.items() if "Synchronize" in name)
    print(f"  profiled ({n} {unit}s, profiler on): wall "
          f"{wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms, idle "
          f"share {1 - busy / wall_us:.3f}; per {unit} "
          f"{top_ops / n:.0f} top-level aten ops, {launches / n:.0f} "
          f"kernel launches, {syncs / n:.2f} host synchronizations")
    for name, us in sorted(dev.items(), key=lambda kv: -kv[1])[:top]:
        print(f"    {us / 1e3:8.3f} ms  {100 * us / max(busy, 1e-9):5.1f}%  "
              f"{name[:90]}")
    for part in shares:
        us = sum(v for k, v in dev.items() if part in k)
        print(f"  {part}: {us / 1e3:.3f} ms of device time per {n} {unit}s, "
              f"{100 * us / max(busy, 1e-9):.1f}% of busy")
    per_unit = {}
    for part in counted:
        names = {k: c for k, c in count.items() if part in k}
        per_unit[part] = sum(names.values()) / n
        print(f"  kernels named *{part}*: {per_unit[part]:g} "
              f"launches and {sum(dev[k] for k in names) / n / 1e3:.3f} ms "
              f"of device time a {unit} ({len(names)} kernels)")
    return busy, per_unit


def phase_card_vs_cpu(torch, ops, moe_options=None,
                      arch="qwen3-moe-30b-a3b", held=True):
    """A reduced config (qwen3-moe by default, under ``moe_options``):
    prefill + 3 decode steps, CPU plain versions against the card's
    kernels, the CPU's tokens fed to both (under K > 1 codebooks, K a
    step).  Prints the card run's launches, and checks that a MoE
    config's expert FFN ran the kernel of its backend.  The logits are
    held within LOGITS_ATOL, or only printed where ``held`` is False."""
    import numpy as np
    from repro_torch.configs import get_reduced, with_options
    from repro_torch.models import transformer as T
    from repro_torch.sharding.plan import single_device_plan
    cfg = with_options(get_reduced(arch), **(moe_options or {}))
    plan = single_device_plan()
    params = T.init_model(cfg, plan, seed=0, device="cpu")

    B, S, steps = 2, 16, 3
    K = cfg.num_codebooks
    toks = np.random.default_rng(0).integers(
        8, cfg.vocab_size, (B, K, S) if K > 1 else (B, S))
    runs = {}
    ops.reset_launch_counts()
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        caches = T.init_caches(cfg, B, S + steps, plan, device=dev)
        outs = []
        tok = torch.as_tensor(toks, dtype=torch.int32, device=dev)
        with torch.inference_mode():
            for i in range(steps + 1):
                pos = (torch.arange(S, dtype=torch.int32, device=dev) if i == 0
                       else torch.tensor([S + i - 1], dtype=torch.int32,
                                         device=dev))
                _, logits, _, caches = T.forward(p, tok, cfg, plan,
                                                 positions=pos, caches=caches,
                                                 use_kernel=True)
                outs.append(logits.float().cpu())
                nxt = (runs["cpu"][i] if dev == "cuda" else logits.cpu())
                tok = nxt[:, -1].argmax(-1).to(torch.int32)[..., None].to(
                    dev)
        runs[dev] = outs
    launches = ops.launch_counts()
    print(f"  {arch}: card launches over the {steps + 1} forwards: "
          f"{launches}")
    if cfg.moe is not None:
        ffn = ("grouped_ffn_ragged" if cfg.moe.dispatch_backend == "dropless"
               else "grouped_ffn")
        other = ({"grouped_ffn", "grouped_ffn_ragged"} - {ffn}).pop()
        if not (launches[ffn] > 0 and launches[other] == 0):
            raise AssertionError(f"card against CPU: the expert FFN should "
                                 f"run {ffn} only, launches {launches}")
    for i, (a, b) in enumerate(zip(runs["cpu"], runs["cuda"])):
        err = (a - b).abs().max().item()
        what = "prefill" if i == 0 else f"decode {i}"
        print(f"  {what}: max |logits_cpu - logits_card| {err:.3e} "
              f"({'tolerance' if held else 'printed, not held; phase 4'}"
              f" {LOGITS_ATOL}, |logits| max {a.abs().max().item():.3f})")
        if held and not err <= LOGITS_ATOL:
            raise AssertionError(f"card against CPU, {what}: {err}")


# serving always has a cache (the attention and the rwkv recurrence take
# their plain branches), training runs use_kernel=False, and nothing calls
# the SSD kernel
NO_SCORING_KERNELS = {"flash_attention": 0, "rwkv6_scan": 0, "ssd_chunk": 0}
DROPLESS = {"dispatch_backend": "dropless"}
# per forward of the 4-layer dropless serve: both SMILE hops gather and
# combine; hop 2 runs the ragged FFN and nothing runs the padded one
DROPLESS_PER_FORWARD = {"dispatch_gather": 8, "grouped_ffn": 0,
                        "combine_gather": 8, "router_fused": 0,
                        "group_sort": 0, "grouped_ffn_ragged": 4,
                        **NO_SCORING_KERNELS}


def phase_serve_dropless(torch, ops):
    """The dropless path: serve() once under the dropless config, every
    launch count set to 0 just before and read just after; then, warm and
    in turns on the same weights and prompts, the sort and the dropless
    configs through generate(); the FFN rows each path computes; a profile
    of one dropless run."""
    from repro_torch.configs import with_options
    from repro_torch.launch.serve import generate, serve
    from repro_torch.common.config import ServeConfig
    from torch.profiler import ProfilerActivity, profile
    sc = ServeConfig()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = serve(SERVE["arch"], reduced=False, batch=sc.batch_size,
                prompt_len=sc.prompt_len, new_tokens=sc.max_new_tokens,
                seed=0, device="cuda", num_layers=SERVE["num_layers"],
                moe_grid=SERVE["moe_grid"], moe_options=DROPLESS)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = res.decode_steps
    print(f"  first call: prefill {res.prefill_s * 1e3:.2f} ms; decode "
          f"{res.decode_s / steps * 1e3:.2f} ms per step; launches: prefill "
          f"{res.launches['prefill']}, decode {res.launches['decode']}; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB")
    if not res.logits_finite:
        raise AssertionError("dropless serve: non-finite logits")
    for phase, n in (("prefill", 1), ("decode", steps)):
        want = {k: v * n for k, v in DROPLESS_PER_FORWARD.items()}
        if res.launches[phase] != want:
            raise AssertionError(f"dropless serve {phase}: launches "
                                 f"{res.launches[phase]}, expected {want}")
    if res.tokens.shape != (sc.batch_size, sc.max_new_tokens):
        raise AssertionError(f"dropless serve: tokens {res.tokens.shape}")

    inp = res.inputs
    cfgs = {"dropless": inp.cfg,
            "sort": with_options(inp.cfg, dispatch_backend="sort")}

    def run(name):
        return generate(inp.params, inp.prompts, cfgs[name], inp.plan,
                        new_tokens=sc.max_new_tokens)

    times = {"sort": [], "dropless": []}
    tokens = {}
    for name in ("sort", "dropless", "dropless", "sort"):
        torch.cuda.reset_peak_memory_stats()
        r = run(name)
        times[name].append((r.prefill_s * 1e3, r.decode_s / steps * 1e3,
                            steps * r.batch / r.decode_s,
                            torch.cuda.max_memory_allocated() / 2**30))
        tokens[name] = r.tokens
    for name, ts in times.items():
        for i, (pf, dc, tps, mem) in enumerate(ts):
            print(f"  warm {name:8s} run {i + 1}: prefill {pf:.2f} ms; "
                  f"decode {dc:.2f} ms per step ({tps:.1f} tokens/s); peak "
                  f"{mem:.2f} GiB")
    same = float((tokens["sort"] == tokens["dropless"]).mean())
    print(f"  greedy tokens equal between sort and dropless: {same:.3f} of "
          f"{tokens['sort'].size} (sort drops over capacity, dropless never)")

    # the FFN rows each path computes at hop 2, against the real rows it was
    # handed (rows that are not all zeros), seen through the executor's FFN
    # calls (the kernels' wrappers and their counts stay as they are)
    from repro_torch.core import pipeline as PL
    seen = []
    orig = (PL.experts_ffn, PL.experts_ffn_ragged)

    def padded(w, x, *a, **kw):
        seen.append((x.shape[0] * x.shape[1],
                     int((x.reshape(-1, x.shape[-1]) != 0).any(-1).sum())))
        return orig[0](w, x, *a, **kw)

    def ragged(w, rows, starts, *a, **kw):
        seen.append((int(starts[-1]), int((rows != 0).any(-1).sum())))
        return orig[1](w, rows, starts, *a, **kw)

    PL.experts_ffn, PL.experts_ffn_ragged = padded, ragged
    try:
        for name in ("sort", "dropless"):
            seen.clear()
            run(name)
            per = len(seen) // (steps + 1)
            for what, calls in (("prefill", seen[:per]),
                                ("decode", seen[per:])):
                rows_c = sum(c for c, _ in calls) / max(len(calls), 1)
                real = sum(r for _, r in calls) / max(len(calls), 1)
                print(f"  {name:8s} {what}: FFN rows computed {rows_c:.1f} "
                      f"a call against {real:.1f} real rows "
                      f"({len(calls)} calls)")
    finally:
        PL.experts_ffn, PL.experts_ffn_ragged = orig

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run("dropless")
        wall_us = (time.perf_counter() - t0) * 1e6
    profile_summary(prof, wall_us, sc.max_new_tokens, "forward")
    return launches


TRAIN = dict(arch="smile-3.7b", reduced=False, batch=16, seq=128,
             optimizer="lamb", moe_grid=(16, 8),
             moe_options={"router_impl": "fused", "sort_impl": "radix"})
# 6 MoE layers x 2 SMILE hops, in the forward and in the remat recompute
TRAIN_LAUNCHES = {"router_fused": 24, "group_sort": 24,
                  "dispatch_gather": 0, "grouped_ffn": 0,
                  "combine_gather": 0, "grouped_ffn_ragged": 0,
                  **NO_SCORING_KERNELS}


# the routing kernels' names (router_fused.cu's and group_sort.cuh's), whose
# CUDA launches phase 5 counts a step
ROUTING_KERNELS = ("router_kernel", "group_sort_phases")
# one warm-up step, 3 timed steps, then 2 steps under the profiler
TRAIN_TIMED, TRAIN_PROFILED = 3, 2


def phase_train(torch, ops):
    """The training path: train() once, every launch count set to 0 just
    before and read just after: one warm-up step, TRAIN_TIMED timed steps,
    then TRAIN_PROFILED warm steps under the profiler (started and stopped
    between steps through train()'s ``on_step``)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.train import train
    from repro_torch.optim import leaf_groups
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    first, last = 1 + TRAIN_TIMED, 1 + TRAIN_TIMED + TRAIN_PROFILED
    span = {}

    def on_step(step):
        # train() has synced the device at the end of each logged step
        if step == first:
            span["peak_timed"] = torch.cuda.max_memory_allocated()
            prof.start()
            span["t0"] = time.perf_counter()
        elif step == last:
            span["wall_us"] = (time.perf_counter() - span["t0"]) * 1e6
            prof.stop()

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    params, hist = train(steps=last, log_every=1, device="cuda",
                         on_step=on_step, **TRAIN)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    MEASURED_PEAKS["train"] = peak
    n_params = sum(p.numel() for g in leaf_groups(params)
                   for p in g.pieces)
    del params
    tokens = TRAIN["batch"] * TRAIN["seq"]
    for h in hist:
        what = (" (warm-up)" if h["step"] == 1 else
                " (profiled)" if h["step"] > first else "")
        print(f"  step {h['step']}{what}: "
              f"{h['step_ms']:.2f} ms ({tokens / h['step_ms'] * 1e3:,.0f} "
              f"tokens/s)  loss {h['loss']:.4f} ce {h['ce']:.4f} lb "
              f"{h['lb']:.5f} drop_frac {h['drop_frac']:.4f} grad norm "
              f"{h['grad_norm']:.4f}  launches {h['launches']}")
        if not (all(math.isfinite(h[k]) for k in ("loss", "grad_norm"))):
            raise AssertionError(f"train step {h['step']}: non-finite loss "
                                 f"or grad norm")
        if h["launches"] != TRAIN_LAUNCHES:
            raise AssertionError(f"train step {h['step']}: launches "
                                 f"{h['launches']}, expected "
                                 f"{TRAIN_LAUNCHES}")
    timed = [h["step_ms"] for h in hist[1:first]]
    print(f"  timed steps ({TRAIN_TIMED}): mean "
          f"{sum(timed) / len(timed):.2f} ms, "
          f"{tokens * len(timed) / sum(timed) * 1e3:,.0f} tokens/s; "
          f"{n_params / 1e9:.3f} B parameters; max_memory_allocated "
          f"{span['peak_timed'] / 2**30:.2f} GiB over steps 1-{first}, "
          f"{peak / 2**30:.2f} GiB over all {last}")
    print(f"  profile of steps {first + 1}-{last} of the same run (warm):")
    _, counted = profile_summary(prof, span["wall_us"], TRAIN_PROFILED,
                                 "step", top=15, counted=ROUTING_KERNELS)
    print(f"  routing wrapper calls a step: router_fused "
          f"{TRAIN_LAUNCHES['router_fused']}, group_sort "
          f"{TRAIN_LAUNCHES['group_sort']}; their CUDA kernels a step: "
          f"{counted['router_kernel']:g} and "
          f"{counted['group_sort_phases']:g}")
    # one CUDA kernel a wrapper call (rounded: the profiler at times drops
    # a launch, see kernel_times)
    if (round(counted["router_kernel"] / TRAIN_LAUNCHES["router_fused"]) != 1
            or round(counted["group_sort_phases"]
                     / TRAIN_LAUNCHES["group_sort"]) != 1):
        raise AssertionError(f"routing CUDA kernels a step {counted}, "
                             f"expected one a wrapper call")
    # each range shows twice: its host span (CPU) and its device span, from
    # its first kernel's start to its last kernel's end (CUDA)
    from torch.autograd import DeviceType
    for e in prof.key_averages():
        if e.key.startswith("train_step."):
            if e.device_type == DeviceType.CUDA:
                us = getattr(e, "device_time_total",
                             getattr(e, "cuda_time_total", 0.0))
                print(f"    {e.key:26s} device span "
                      f"{us / TRAIN_PROFILED / 1e3:9.3f} ms a step")
            else:
                print(f"    {e.key:26s} host span   "
                      f"{e.cpu_time_total / TRAIN_PROFILED / 1e3:9.3f} ms "
                      f"a step")
    gc.collect()
    torch.cuda.empty_cache()
    return launches, timed, peak


def _to(tree, dev):
    """A copy of a parameter tree on ``dev``."""
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    return tree.to(dev, copy=True)


def phase_train_card_vs_cpu(torch, arch="smile-3.7b", steps=3, dtype=None):
    """A reduced config (smile-3.7b by default; fused router and radix
    sort; its compute dtype, or ``dtype``), ``steps`` steps from the same
    weights and batches on the CPU (plain versions) and on the card
    (kernels); each step's loss within TRAIN_LOSS_ATOL."""
    from repro_torch.common.config import TrainConfig
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch.train import train_config
    from repro_torch.models import transformer as T
    from repro_torch.optim import make_optimizer, make_schedule
    from repro_torch.sharding.plan import single_device_plan
    from repro_torch.train.step import build_train_step
    cfg = train_config(arch, reduced=True, moe_options=TRAIN["moe_options"])
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    plan = single_device_plan()
    B, S = 8, 64
    params = T.init_model(cfg, plan, seed=0, device="cpu", compute_cast=False)
    tcfg = TrainConfig(global_batch_size=B, seq_len=S, steps=steps,
                       warmup_steps=1)
    losses = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        opt = make_optimizer("lamb")
        batches = [make_batch(cfg, B, S, 0, i) for i in range(steps)]
        step = build_train_step(cfg, tcfg, plan, opt,
                                make_schedule("cosine", 3e-4, 1, steps), p,
                                batches[0])
        state = opt.init(p)
        losses[dev] = []
        for i, b in enumerate(batches):
            p, state, m = step(p, state, b, i + 1)
            losses[dev].append(float(m["loss"]))
    for i, (a, b) in enumerate(zip(losses["cpu"], losses["cuda"])):
        print(f"  {arch} step {i + 1}: loss cpu {a:.5f}, card {b:.5f}, |diff| "
              f"{abs(a - b):.3e} (tolerance {TRAIN_LOSS_ATOL})")
        if not abs(a - b) <= TRAIN_LOSS_ATOL:
            raise AssertionError(f"training card against CPU, step {i + 1}")


def bf16_ulp(torch, x):
    """The spacing of bf16 numbers at each element of ``x`` (8 significant
    bits)."""
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def flash_error(torch, got, want):
    """Check the flash kernel's output against the plain one (see
    FLASH_ROW_ATOL) and return the readings: the largest error in bf16
    ulps of the plain output where it does not cancel (|ref| >= its row's
    RMS), and the largest error beyond one ulp over its row's RMS."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ulp = bf16_ulp(torch, want)
    rms = want.pow(2).mean(-1, keepdim=True).sqrt().clamp(min=1e-30)
    over = (err - ulp).clamp(min=0) / rms
    big = want.abs() >= rms
    ulps = (err / ulp)[big].max().item() if bool(big.any()) else 0.0
    return ulps, over.max().item()


def phase_scoring_kernels(torch, ops, ref, rows):
    """The cache-less forward's kernels against their plain versions:
    flash attention at qwen3's shapes, the WKV6 scan at rwkv6's, and the
    SSD intra-chunk terms at zamba2's (held only against the plain
    version: no model calls them)."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2024)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    for shape, (B, T, H, KV, hd) in FLASH_SHAPES.items():
        q, k, v = (randn(B, T, n, hd).to(bf) for n in (H, KV, KV))
        rep = H // KV

        def kernel():
            return ops.flash_attention(q, k, v)

        def plain():
            return ref.flash_attention_ref(q, k.repeat_interleave(rep, 2),
                                           v.repeat_interleave(rep, 2))

        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=KV != H)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        ulps, over = flash_error(torch, got, want)
        lib_ulps, lib_over = flash_error(
            torch, library().transpose(1, 2), want)
        print(f"  flash_attention {shape}: (B, T, H, KV, hd) = "
              f"{(B, T, H, KV, hd)}; against the plain version: at most "
              f"{ulps:.0f} bf16 ulps where |ref| >= its row's RMS, at most "
              f"{over:.3e} of a row's RMS beyond one ulp (bound "
              f"{FLASH_ROW_ATOL}); scaled_dot_product_attention: {lib_ulps:.0f}"
              f" ulps, {lib_over:.3e}; device time "
              f"{device_ms(torch, kernel, iters=5):.4f} ms a call")
        if not over <= FLASH_ROW_ATOL:
            raise AssertionError(f"flash_attention {shape}: {over} of a row's "
                                 f"RMS beyond one bf16 ulp, over "
                                 f"{FLASH_ROW_ATOL}")
        nbytes = 2.0 * (2 * B * T * H * hd + 2 * B * T * KV * hd)
        flops = 4.0 * B * H * hd * T * (T + 1) / 2          # causal pairs
        add_row(rows, "flash_attention", shape, got, want, time_ms(kernel),
                time_ms(plain, iters=3, warmup=1),
                bound(nbytes, flops, BF16_TC_FLOPS), time_ms(library))

    B, T, nh, hd = RWKV_SHAPE
    r, k, v = (randn(B, T, nh, hd) for _ in range(3))
    w = torch.exp(-torch.exp(randn(B, T, nh, hd) * 0.5 - 1.0))  # in (0, 1)
    u, s0 = randn(nh, hd), randn(B, nh, hd, hd)                 # nonzero

    def kernel():
        return ops.rwkv6_scan(r, k, v, w, u, s0)

    def plain():
        return ref.rwkv6_scan_ref(r, k, v, w, u, s0)

    (y, s_last), (wy, ws) = kernel(), plain()
    torch.cuda.synchronize()
    tol = RWKV_RTOL * wy.abs() + RWKV_ATOL_REL * wy.abs().max()
    y_share = ((y - wy).abs() / tol).max().item()
    if not y_share <= 1.0:
        raise AssertionError(f"rwkv6_scan: y outside rtol {RWKV_RTOL} / atol "
                             f"{RWKV_ATOL_REL} of its largest value "
                             f"({y_share:.3f} of the bound)")
    # the state update rounds w * S, then + k v, as the plain version
    if not torch.equal(s_last, ws):
        raise AssertionError("rwkv6_scan: s_last not bit-exact against the "
                             "plain version")
    print(f"  rwkv6_scan (B, T, nh, hd) = {RWKV_SHAPE}: s_last bit-exact; "
          f"y's largest error {(y - wy).abs().max().item():.3e}, "
          f"{y_share:.3f} of its bound; max |y| "
          f"{wy.abs().max().item():.3f}; device time "
          f"{device_ms(torch, kernel, iters=5):.4f} ms a call")
    nbytes = 4.0 * (5 * B * T * nh * hd + nh * hd + 2 * B * nh * hd * hd)
    # a step's least work: the readout sum_i r_i S_ij (an FMA per (i, j)),
    # the state update w_i S_ij + k_i v_j (3 flops per (i, j)), and the
    # bonus v_j sum_i r_i u_i k_i (5 flops per i)
    flops = B * nh * T * (5.0 * hd * hd + 5.0 * hd)
    add_row(rows, "rwkv6_scan", "rwkv6 path", torch.cat([y.flatten(),
                                                         s_last.flatten()]),
            torch.cat([wy.flatten(), ws.flatten()]), time_ms(kernel),
            time_ms(plain, iters=2, warmup=1),
            bound(nbytes, flops, FP32_FLOPS))

    for shape, (B, nc, Q, nh, hd, ds, lo, hi) in SSD_SHAPES.items():
        phase_ssd(torch, ops, ref, rows, gen, shape, B, nc, Q, nh, hd, ds,
                  lo, hi)


def phase_ssd(torch, ops, ref, rows, gen, shape, B, nc, Q, nh, hd, ds, lo,
              hi):
    """The SSD kernel against its plain version at one shape, on inputs
    drawn from ``gen`` with a log-decay a step in ``[lo, hi]``
    (:func:`hold_ssd`)."""
    dev = torch.device("cuda")
    xh = torch.randn((B, nc, Q, nh, hd), generator=gen, device=dev)
    dt = 0.001 + 0.099 * torch.rand((B, nc, Q, nh), generator=gen,
                                    device=dev)
    loga = lo + (hi - lo) * torch.rand((B, nc, Q, nh), generator=gen,
                                       device=dev)
    Bc, Cc = (torch.randn((B, nc, Q, ds), generator=gen, device=dev)
              for _ in range(2))
    hold_ssd(torch, ops, rows, shape, (xh, dt, loga, Bc, Cc),
             ref.ssd_chunk_ref, f"loga in [{lo}, {hi}] a step")


def hold_ssd(torch, ops, rows, shape, args, plain_fn, what):
    """``ops.ssd_chunk`` on ``args`` ``(xh, dt, loga, Bc, Cc)`` against
    ``plain_fn`` on the same: its route (ops.ssd_route), blocks, head group
    and shared memory, its errors (SSD_RTOL + SSD_ATOL_REL of the largest
    value), two calls' bits, its device time and share of the bound."""
    from repro_torch.kernels import _build
    xh, dt, loga, Bc, Cc = args
    B, nc, Q, nh, hd = xh.shape
    ds = Bc.shape[-1]

    def kernel():
        return ops.ssd_chunk(xh, dt, loga, Bc, Cc)

    def plain():
        return plain_fn(xh, dt, loga, Bc, Cc)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    for name, a, b in zip(("y_intra", "sB", "a_chunk"), got, want):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"ssd_chunk {shape}: {name} not finite")
        tol = SSD_RTOL * b.abs() + SSD_ATOL_REL * b.abs().max()
        if not bool(((a - b).abs() <= tol).all()):
            raise AssertionError(f"ssd_chunk {shape}: {name} outside "
                                 f"rtol {SSD_RTOL} / atol {SSD_ATOL_REL} "
                                 f"of its largest value")
    again = kernel()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"ssd_chunk {shape}: two calls differ")
    rel = [((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
           for a, b in zip(got, want)]
    nbytes = 4.0 * (2 * B * nc * Q * nh * hd + 2 * B * nc * Q * nh
                    + 2 * B * nc * Q * ds + B * nc * nh * hd * ds
                    + B * nc * nh)
    tri = Q * (Q + 1) / 2.0
    flops = (B * nc * 2.0 * ds * tri          # C B^T, once a chunk
             + B * nc * nh * (tri * (2.0 * hd + 4.0)   # W and W x
                              + 2.0 * Q * hd * ds + 3.0 * Q))  # sB
    b = bound(nbytes, flops, FP32_FLOPS)
    route = ops.ssd_route(B * nc, Q, nh, hd, ds,
                          torch.cuda.get_device_properties(0)
                          .multi_processor_count)
    lib = _build.load("ssd_chunk")
    smem = (lib.ssd_chunk_grouped_smem(Q, hd, ds, route.group)
            if route.route == "grouped" else None)
    dev_ms = device_ms(torch, kernel, iters=5)
    print(f"  ssd_chunk {shape}: (B, nc, Q, nh, hd, ds) = "
          f"{(B, nc, Q, nh, hd, ds)}, {what}; route "
          f"{route.route}: {route.blocks} blocks of 256 threads, "
          f"{route.group} head(s) a block"
          + (f", {smem} bytes of shared memory a block" if smem else "")
          + f"; max err over max |ref| of y_intra, sB, a_chunk: "
          f"{', '.join(f'{e:.2e}' for e in rel)}; two calls bit-identical; "
          f"device time {dev_ms:.4f} ms a call, {100 * b[0] / dev_ms:.1f}% "
          f"of the {b[0]:.4f} ms bound")
    add_row(rows, "ssd_chunk", shape, torch.cat([t.flatten() for t in got]),
            torch.cat([t.flatten() for t in want]), time_ms(kernel),
            time_ms(plain, iters=3, warmup=1), b)


# the cache-less kernel forward (forward(..., use_kernel=True), no caches):
# qwen3-moe-30b-a3b at full width, 4 of 48 layers, grid (16, 8), batch 2 x
# 4,096; rwkv6-1.6b at full width and depth, batch 4 x 4,096
SCORE_QWEN = dict(arch="qwen3-moe-30b-a3b", num_layers=4, moe_grid=(16, 8),
                  batch=2, seq=4096)
SCORE_RWKV = dict(arch="rwkv6-1.6b", num_layers=None, moe_grid=None,
                  batch=4, seq=4096)
ZERO_LAUNCHES = {"dispatch_gather": 0, "grouped_ffn": 0, "combine_gather": 0,
                 "router_fused": 0, "group_sort": 0, "grouped_ffn_ragged": 0,
                 "flash_attention": 0, "rwkv6_scan": 0, "ssd_chunk": 0}
QWEN_SCORE_LAUNCHES = {**ZERO_LAUNCHES, "dispatch_gather": 8,
                       "grouped_ffn": 4, "combine_gather": 8,
                       "flash_attention": 4}
RWKV_SCORE_LAUNCHES = {**ZERO_LAUNCHES, "rwkv6_scan": 24}


def phase_scoring_forward(torch, ops, run_cfg, per_forward, shares,
                          images=0):
    """The cache-less kernel forward once through
    ``repro_torch.models.transformer.forward``, every launch count set to 0
    just before and read just after; then warm, and once under the
    profiler.  Tokens (B, S), or (B, K, S) under K > 1 codebooks;
    ``images`` image embeddings a row (drawn from seed 0) written at
    positions 1..images.  Returns the launch counts of the first
    forward."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import serve_config, serve_prompts
    from repro_torch.models import transformer as T
    from repro_torch.sharding.plan import single_device_plan
    gc.collect()
    torch.cuda.empty_cache()
    cfg = serve_config(run_cfg["arch"], reduced=False,
                       num_layers=run_cfg["num_layers"],
                       moe_grid=run_cfg["moe_grid"])
    plan = single_device_plan()
    B, S = run_cfg["batch"], run_cfg["seq"]
    params = T.init_model(cfg, plan, seed=0, device="cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    toks = serve_prompts(cfg, B, S, 0, "cuda")
    pos = torch.arange(S, dtype=torch.int32, device="cuda")
    extra = None
    if images:
        gen = torch.Generator(device="cuda").manual_seed(0)
        extra = {"image_embeds": torch.randn(
            (B, images, cfg.vision_embed_dim), generator=gen, device="cuda"),
            "image_pos": torch.arange(1, images + 1, dtype=torch.int32,
                                      device="cuda").repeat(B, 1)}

    def run():
        with torch.inference_mode():
            _, logits, _, _ = T.forward(params, toks, cfg, plan,
                                        positions=pos, use_kernel=True,
                                        extra=extra)
        return logits

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits = run()
    finite = bool(torch.isfinite(logits).all())
    cold = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    shape = tuple(logits.shape)
    del logits
    print(f"  {cfg.name}: {cfg.num_layers} layers, {n_params / 1e9:.3f} B "
          f"parameters, batch {B} x {S} tokens"
          + (f" ({images} image embeddings a row)" if images else "")
          + f"; launches {launches}; logits {shape} finite: {finite}")
    if not finite:
        raise AssertionError(f"{cfg.name} forward: non-finite logits")
    K = cfg.num_codebooks
    if shape != ((B, S, K, cfg.vocab_size) if K > 1
                 else (B, S, cfg.vocab_size)):
        raise AssertionError(f"{cfg.name} forward: logits {shape}")
    if launches != per_forward:
        raise AssertionError(f"{cfg.name} forward: launches {launches}, "
                             f"expected {per_forward}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    print(f"  first forward {cold * 1e3:.2f} ms; warm {warm * 1e3:.2f} ms "
          f"({B * S / warm:,.0f} tokens/s); max_memory_allocated over the "
          f"first forward {peak / 2**30:.2f} GiB")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    profile_summary(prof, wall_us, 1, "forward", shares=shares)
    del params, toks
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def phase_scoring_card_vs_cpu(torch, ops, arch, dtype="bfloat16"):
    """A reduced config's cache-less forward (use_kernel=True), on the CPU
    (plain versions) and on the card (kernels), from the same weights and
    tokens, within the CPU tests' tolerances against the JAX package."""
    import numpy as np
    from repro_torch.configs import get_reduced
    from repro_torch.models import transformer as T
    from repro_torch.sharding.plan import single_device_plan
    cfg = get_reduced(arch).replace(dtype=dtype)
    plan = single_device_plan()
    params = T.init_model(cfg, plan, seed=0, device="cpu")
    B, S = 2, 64
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    out = {}
    for dev in ("cpu", "cuda"):
        ops.reset_launch_counts()
        with torch.inference_mode():
            _, logits, _, _ = T.forward(
                _to(params, dev), torch.as_tensor(toks, device=dev), cfg,
                plan, positions=torch.arange(S, device=dev), use_kernel=True)
        out[dev] = logits.float().cpu().numpy()
        counts = {k: n for k, n in ops.launch_counts().items() if n}
        print(f"  {arch} ({dtype}) on {dev}: launches {counts}")
    a, b = out["cpu"], out["cuda"]
    if cfg.moe is not None:
        per_tok = np.abs(a - b).max(-1).reshape(-1) / np.abs(a).max()
        p90, flipped = np.percentile(per_tok, 90), (per_tok > 3e-2).mean()
        print(f"  per-token error over max |logit|: p90 {p90:.3e} (bound "
              f"{QWEN_P90}); tokens over 3e-2: {flipped:.4f} (bound "
              f"{QWEN_FLIPPED})")
        if not (p90 < QWEN_P90 and flipped < QWEN_FLIPPED):
            raise AssertionError(f"{arch} card against CPU: p90 {p90}, "
                                 f"flipped {flipped}")
    else:
        err = np.abs(a - b).max() / np.abs(a).max()
        print(f"  max error over max |logit| {err:.3e} (bound "
              f"{RWKV_LOGITS_REL[dtype]})")
        if not err < RWKV_LOGITS_REL[dtype]:
            raise AssertionError(f"{arch} ({dtype}) card against CPU: {err}")


def phase_rwkv_serve(torch, ops):
    """rwkv6-1.6b through serve() at full depth (batch 8, prompt 128, 32 new
    tokens), every launch count set to 0 just before and read just after:
    serving runs the plain recurrence, so no kernel launches at all.  Then
    warm, and profiled over a prefill and 3 decode steps (the profiler's
    own processing of ~4,600 host ops a forward takes about a minute over
    all 32)."""
    from repro_torch.common.config import ServeConfig
    from repro_torch.launch.serve import serve
    sc = ServeConfig()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = serve("rwkv6-1.6b", reduced=False, batch=sc.batch_size,
                prompt_len=sc.prompt_len, new_tokens=sc.max_new_tokens,
                seed=0, device="cuda")
    launches = ops.launch_counts()
    steps = res.decode_steps
    print(f"  first call: prefill {res.prefill_s * 1e3:.2f} ms "
          f"({sc.batch_size} x {sc.prompt_len} tokens); decode "
          f"{res.decode_s / steps * 1e3:.2f} ms per step over {steps} steps "
          f"({steps * res.batch / res.decode_s:.1f} tokens/s); "
          f"max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"  first generated row: {res.tokens[0].tolist()}")
    if not res.logits_finite:
        raise AssertionError("rwkv6 serve: non-finite logits")
    if launches != ZERO_LAUNCHES:
        raise AssertionError(f"rwkv6 serve: launches {launches}, expected "
                             f"none (serving runs the plain recurrence)")
    if res.tokens.shape != (sc.batch_size, sc.max_new_tokens):
        raise AssertionError(f"rwkv6 serve: tokens {res.tokens.shape}")
    phase_warm(torch, res, profiled_tokens=4)
    del res
    gc.collect()
    torch.cuda.empty_cache()


def phase_rwkv_serve_card_vs_cpu(torch, ops):
    """Reduced rwkv6 in fp32: prefill + 3 decode steps with the caches (the
    serving path's plain recurrence) on the CPU and on the card, the CPU's
    tokens fed to both; logits within the fp32 bound of the CPU tests."""
    import numpy as np
    from repro_torch.configs import get_reduced
    from repro_torch.models import transformer as T
    from repro_torch.sharding.plan import single_device_plan
    cfg = get_reduced("rwkv6-1.6b").replace(dtype="float32")
    plan = single_device_plan()
    params = T.init_model(cfg, plan, seed=0, device="cpu")
    B, S, steps = 2, 16, 3
    toks = np.random.default_rng(0).integers(8, cfg.vocab_size, (B, S))
    runs = {}
    ops.reset_launch_counts()
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        caches = T.init_caches(cfg, B, S + steps, plan, device=dev)
        tok = torch.as_tensor(toks, dtype=torch.int32, device=dev)
        outs = []
        with torch.inference_mode():
            for i in range(steps + 1):
                pos = (torch.arange(S, device=dev) if i == 0
                       else torch.tensor([S + i - 1], device=dev))
                _, logits, _, caches = T.forward(p, tok, cfg, plan,
                                                 positions=pos, caches=caches,
                                                 use_kernel=True)
                outs.append(logits[:, -1].float().cpu().numpy())
                nxt = runs["cpu"][i] if dev == "cuda" else outs[-1]
                tok = torch.as_tensor(nxt.argmax(-1)[:, None],
                                      dtype=torch.int32, device=dev)
        runs[dev] = outs
    if ops.launch_counts() != ZERO_LAUNCHES:
        raise AssertionError(f"rwkv6 cached steps launched kernels: "
                             f"{ops.launch_counts()}")
    bound_ = RWKV_LOGITS_REL["float32"]
    for i, (a, b) in enumerate(zip(runs["cpu"], runs["cuda"])):
        err = np.abs(a - b).max() / np.abs(a).max()
        what = "prefill" if i == 0 else f"decode {i}"
        print(f"  {what}: max error over max |logit| {err:.3e} (bound "
              f"{bound_})")
        if not err < bound_:
            raise AssertionError(f"rwkv6 serve card against CPU, {what}: "
                                 f"{err}")



# the engine phases: ServeConfig's defaults (8 slots, pages of 16, prompt
# 128 + 32 new = cache 160, prefill buckets 16/32/64/128/160) and 16 ragged
# requests from seed 0 (prompts of 32-128 tokens, 16-32 new tokens): twice
# the slots, so admission waits and freed pages are reused
ENGINE_REQUESTS = 16
# per forward of the 4-layer sort serve (phase 3)
SORT_PER_FORWARD = {**ZERO_LAUNCHES, "dispatch_gather": 8, "grouped_ffn": 4,
                    "combine_gather": 8}
ENGINE_TIMED_TICKS = 10
ENGINE_PROFILED_TICKS = 4
# the reduced engine, card against CPU: 12 requests, prompts 8-32 tokens,
# 8-16 new, 4 slots, pages of 8 (buckets 16/32/48)
SMALL_ENGINE = dict(requests=12, prompt_len=32, new_tokens=16, n_slots=4,
                    page_size=8)
# qwen1.5-0.5b's first-token logits from the engine against the fixed-batch
# forward.  The two attentions (paged: a direct softmax over a gathered
# view; ring: an online softmax in chunks) sum in fp32 in other orders, and
# each layer rounds its output (bf16 compute) and its K/V (bf16 caches) to
# bf16: a value near a rounding edge lands an ulp apart, and 24 layers
# carry it on.  On an H100 the gap read 4.549e-02 in bf16 and 1.086e-03
# with fp32 compute (bf16 caches), max |logit| 3.24; each limit is 2-3x
# its reading.  A lost or misplaced key would move both alike
QWEN15_FIRST_TOKEN_ATOL = 0.1
FP32_FIRST_TOKEN_ATOL = 3e-3


def engine_requests(cfg, n, prompt_len, new_tokens):
    import numpy as np
    from repro_torch.launch.serve import draw_requests
    return draw_requests(np.random.default_rng(0), n, prompt_len, new_tokens,
                         cfg.vocab_size)


def _pct(vals, q):
    import numpy as np
    return float(np.percentile(np.asarray(vals), q))


def print_request_times(eng, uids, wall_s, what):
    """Tokens/s, time to first token and time per output token of the
    requests ``uids`` of ``eng``, whose run took ``wall_s``."""
    import numpy as np
    reqs = [eng.requests[u] for u in uids]
    ttft = [r.t_first - r.t_submit for r in reqs]
    gaps = np.concatenate([np.diff(r.t_tokens) for r in reqs])
    n_tok = sum(len(r.generated) for r in reqs)
    print(f"  {what}: {len(reqs)} requests, {n_tok} tokens in "
          f"{wall_s * 1e3:.2f} ms ({n_tok / wall_s:,.1f} tokens/s); time to "
          f"first token mean {np.mean(ttft) * 1e3:.2f} ms, p50 "
          f"{_pct(ttft, 50) * 1e3:.2f}, p90 {_pct(ttft, 90) * 1e3:.2f}; time "
          f"per output token mean {gaps.mean() * 1e3:.3f} ms, p90 "
          f"{_pct(gaps, 90) * 1e3:.3f}")


@contextlib.contextmanager
def keep_logits(eng):
    """While open, each token the engine ``eng`` generates has its logits,
    (V,) fp32 on the host, appended to the yielded ``{uid: [logits,
    ...]}``: one device-to-host copy of a step's logits a step.  It wraps
    the engine's tick, which alone knows the request of each row."""
    kept, last = {}, []
    step_of, prefill_tick, decode_tick = (eng._step, eng._prefill_tick,
                                          eng._decode_tick)

    def step(key):
        run = step_of(key)

        def call():
            out = run()
            last[:] = [out[1].float().cpu()]
            return out
        return call

    def prefill():
        req = eng.prefilling[0][0] if eng.prefilling else None
        n = len(req.generated) if req is not None else 0
        prefill_tick()
        if req is not None and len(req.generated) > n:
            kept.setdefault(req.uid, []).append(last[0])

    def decode():
        live = [(i, r) for i, r in enumerate(eng.slot_req) if eng._live[i]]
        decode_tick()
        for i, r in live:
            kept.setdefault(r.uid, []).append(last[0][i])

    eng._step, eng._prefill_tick, eng._decode_tick = step, prefill, decode
    try:
        yield kept
    finally:
        del eng._step, eng._prefill_tick, eng._decode_tick


def check_replay(step):
    """The engine step ``step``, run by the tick just ended, called again
    (a graph replay on the card) against its function run eagerly on a clone
    of the caches, both on that tick's static inputs.  The call writes the
    K/V the tick wrote to the same slots again and reads no position the
    tick's later work wrote, so the engine's state does not change.
    Returns ``((packed, logits) eager, (packed, logits) of the call)``."""
    import torch
    from repro_torch.serve.kvcache import clone_caches
    with torch.no_grad():
        eager = [t.clone() for t in step.fn(clone_caches(step.caches))]
        return eager, [t.clone() for t in step()]


def run_checked(eng, reqs, keys):
    """Submit ``reqs`` to ``eng`` and run it until it drains; after the
    first tick that runs each step of ``keys``, :func:`check_replay` it.
    Returns ``(uids, {key: check})``."""
    uids = [eng.submit(p, nt) for p, nt in reqs]
    checks = {}
    while eng.busy:
        calls = {k: s.calls for k, s in eng.steps.items()}
        eng.step()
        for k in keys:
            if (k not in checks and k in eng.steps
                    and eng.steps[k].calls > calls.get(k, 0)):
                checks[k] = check_replay(eng.steps[k])
    if set(checks) != set(keys):
        raise AssertionError(f"steps {set(keys) - set(checks)} never ran")
    return uids, checks


def first_token_gaps(torch, eng, kept, uids, reqs, params, cfg, plan):
    """Each request's first-token logits from the engine (``kept``) against
    the fixed-batch path's forward (ring caches) over its prompt padded to
    its engine bucket, the padding invalid as the engine marks it, so that
    the MoE capacity is the engine's.  Returns (max abs differences, share
    of equal greedy tokens, max |logit|)."""
    from repro_torch.models import transformer as T
    agree, errs = 0, []
    with torch.no_grad():
        for u, (p, _) in zip(uids, reqs):
            S = next(b for b in eng.buckets if b >= len(p))
            toks = torch.zeros((1, S), dtype=torch.int32, device="cuda")
            toks[0, :len(p)] = torch.as_tensor(p, device="cuda")
            valid = torch.arange(S, device="cuda")[None] < len(p)
            _, lf, _, _ = T.forward(
                params, toks, cfg, plan,
                positions=torch.arange(S, dtype=torch.int32, device="cuda"),
                caches=T.init_caches(cfg, 1, S, plan, device="cuda"),
                use_kernel=True, token_valid=valid)
            lf = lf[0, len(p) - 1].float().cpu()
            le = kept[u][0]
            agree += int(lf.argmax()) == int(le.argmax())
            errs.append((lf - le).abs().max().item())
    top = max(kept[u][0].abs().max().item() for u in uids)
    return errs, agree / len(errs), top


def check_engine_done(eng, reqs, uids, what):
    """(a): every request of ``uids`` completed with its token count, and
    every page is free."""
    for u, (_, nt) in zip(uids, reqs):
        if len(eng.finished.get(u, ())) != nt:
            raise AssertionError(f"{what}: request {u} gave "
                                 f"{len(eng.finished.get(u, ()))} of {nt} "
                                 f"tokens")
    if eng.busy or eng.alloc.n_free != eng.alloc.pool_pages:
        raise AssertionError(f"{what}: {eng.alloc.n_free} of "
                             f"{eng.alloc.pool_pages} pages free, busy "
                             f"{eng.busy}")


def phase_engine(torch, ops, params, cfg, plan, per_forward, fixed_step_ms,
                 first_token_atol=LOGITS_ATOL):
    """The continuous-batching engine through ``launch.serve.run_engine``
    on ``params`` under ``cfg``, every launch count set to 0 just before and
    read just after: 16 ragged requests on a new engine (its steps captured
    as CUDA graphs on first use).  Then the same engine again: the trace
    warm (graphs replayed, no capture); the trace with the logits kept and
    one decode replay and one prefill replay held to the eager step on a
    clone of the caches; the first-token logits against the fixed-batch
    forward, held to ``first_token_atol``; then 8
    requests, of which ticks of decode only are timed (graph replay against
    the eager step) and profiled."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.common.config import ServeConfig
    from repro_torch.launch.serve import run_engine
    sc = ServeConfig()
    reqs = engine_requests(cfg, ENGINE_REQUESTS, sc.prompt_len,
                           sc.max_new_tokens)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = run_engine(params, cfg, plan, reqs, sc)
    launches = ops.launch_counts()
    eng = res.engine
    uids = sorted(res.tokens)
    counts = eng.compile_counts()
    check_engine_done(eng, reqs, uids, f"{cfg.name} engine")
    # (b) one capture a step; a prompt of at most 160 tokens is one chunk
    used = {}
    for p, _ in reqs:
        b = next(b for b in eng.buckets if b >= len(p))
        used[b] = used.get(b, 0) + 1
    dec_tokens = sum(nt - 1 for _, nt in reqs)
    print(f"  first run (captures on first use): {res.ticks} ticks; "
          f"buckets used {dict(sorted(used.items()))}; compile counts "
          f"{counts}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print_request_times(eng, uids, res.wall_s, "first run")
    if not (counts["decode"] == 1 and counts["captures"]["decode"] == 1
            and counts["prefill"] == {b: 1 for b in used}
            and counts["captures"]["prefill"] == {b: 1 for b in used}
            and counts["replays"]["prefill"] == used
            and -(-dec_tokens // sc.n_slots) <= counts["replays"]["decode"]
            <= dec_tokens):
        raise AssertionError(f"{cfg.name} engine: compile counts {counts}, "
                             f"buckets used {used}, {dec_tokens} decoded "
                             f"tokens")
    # (c) the counters move at warm-up and capture only
    n_steps = 1 + len(used)
    want = {k: v * 2 * n_steps for k, v in per_forward.items()}
    if launches != want or eng.capture_launches() != want:
        raise AssertionError(f"{cfg.name} engine: launches {launches}, at "
                             f"capture {eng.capture_launches()}, expected "
                             f"{want} ({n_steps} steps x warm-up + capture)")
    run_forwards = res.replays + n_steps
    executed = {k: v * run_forwards for k, v in per_forward.items() if v}
    print(f"  launches counted (warm-ups + captures of {n_steps} steps): "
          f"{ {k: v for k, v in launches.items() if v} }; replays "
          f"{res.replays}; launches executed (warm-ups + replays) x per "
          f"forward: {executed}")
    m = res.metrics
    print(f"  page occupancy mean {m['page_occupancy_mean']:.3f}, max "
          f"{m['page_occupancy_max']:.3f}; moe drop_frac mean "
          f"{m['moe_drop_frac_mean']:.4f}, hop max load max "
          f"{m['moe_hop_max_load_max']:.4f}, hop load entropy min "
          f"{m['moe_hop_load_entropy_min']:.4f}, fault events "
          f"{m['moe_fault_events']:g}")

    # the same trace warm on the same engine: replays only
    t0 = time.perf_counter()
    warm = [eng.submit(p, nt) for p, nt in reqs]
    eng.run()
    wall = time.perf_counter() - t0
    check_engine_done(eng, reqs, warm, f"{cfg.name} engine, warm")
    print_request_times(eng, warm, wall, "warm run")
    same = all(eng.finished[w] == res.tokens[u] for w, u in zip(warm, uids))
    after = eng.compile_counts()
    moved = {k: v - launches[k] for k, v in ops.launch_counts().items()
             if v != launches[k]}
    print(f"  warm run: {eng.ticks - res.ticks} ticks, tokens equal to the "
          f"first run's: {same}; captures {after['captures']}; launches "
          f"counted since the first run: {moved}")
    if not same or after["captures"] != counts["captures"] \
            or ops.launch_counts() != launches:
        raise AssertionError(f"{cfg.name} engine, warm: tokens equal {same},"
                             f" captures {after['captures']}, launches "
                             f"{ops.launch_counts()}")

    # (d)-(f): the trace once more, the logits kept; after the first tick
    # that runs the decode step, and the first that runs the busiest bucket,
    # that step again against the eager step on a clone of the caches
    bucket = max(used, key=lambda b: (used[b], b))
    with keep_logits(eng) as logits:
        kept, checks = run_checked(eng, reqs, ("decode", bucket))
    check_engine_done(eng, reqs, kept, f"{cfg.name} engine, logits kept")
    for key in ("decode", bucket):
        (pe, le), (pg, lg) = checks[key]
        n = 1 if key != "decode" else sc.n_slots
        tok_eq = bool(torch.equal(pe[:n], pg[:n]))
        err = (le.float() - lg.float()).abs().max().item()
        print(f"  {key if key == 'decode' else f'prefill bucket {key}'}: "
              f"graph replay against the eager step on a clone: next tokens "
              f"equal {tok_eq}, logits max abs difference {err:.3e} "
              f"(tolerance {LOGITS_ATOL})")
        if not (tok_eq and err <= LOGITS_ATOL):
            raise AssertionError(f"{cfg.name} engine: {key} replay against "
                                 f"eager: tokens {tok_eq}, logits {err}")
    finite = all(bool(torch.isfinite(lg).all())
                 for u in kept for lg in logits[u])
    if not finite:
        raise AssertionError(f"{cfg.name} engine: non-finite logits")
    errs, agree, top = first_token_gaps(torch, eng, logits, kept, reqs,
                                        params, cfg, plan)
    print(f"  first-token logits against the fixed-batch forward (ring "
          f"caches) of the same prompt padded to its bucket: max abs "
          f"difference {max(errs):.3e} over {len(errs)} requests, max "
          f"|logit| {top:.3f} (tolerance {first_token_atol}); greedy tokens "
          f"agree {agree:.3f}; all logits finite: {finite}")
    if not max(errs) <= first_token_atol:
        raise AssertionError(f"{cfg.name} engine: first-token logits "
                             f"{max(errs)} from the fixed-batch forward")

    # decode-only ticks: 8 requests fill the slots; once all are live, time
    # ENGINE_TIMED_TICKS ticks, the decode step's replay against its eager
    # function on the same inputs, and profile ENGINE_PROFILED_TICKS ticks
    full = [eng.submit(p, sc.max_new_tokens) for p, _ in reqs[:sc.n_slots]]
    while eng.prefilling or eng.waiting:
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ENGINE_TIMED_TICKS):
        eng.step()
    tick_ms = (time.perf_counter() - t0) * 1e3 / ENGINE_TIMED_TICKS
    step = eng.steps["decode"]

    def timed(fn, n=20):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    with torch.no_grad():
        graph_ms = timed(step)
        eager_ms = timed(lambda: step.fn(step.caches))
        graph_ms2 = timed(step)
    print(f"  decode tick, {sc.n_slots} live slots: {tick_ms:.3f} ms a tick "
          f"(graph replay, {ENGINE_TIMED_TICKS} ticks); the decode step "
          f"alone: graph replay {graph_ms:.3f} / {graph_ms2:.3f} ms, eager "
          f"{eager_ms:.3f} ms; the fixed-batch eager decode step (batch "
          f"{sc.batch_size}, warm) {fixed_step_ms:.3f} ms")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ENGINE_PROFILED_TICKS):
            eng.step()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us, _ = profile_summary(prof, wall_us, ENGINE_PROFILED_TICKS,
                                 "tick", top=8)
    busy_ms = busy_us / 1e3 / ENGINE_PROFILED_TICKS
    print(f"  device busy {busy_ms:.3f} ms a tick against the unprofiled "
          f"tick's {tick_ms:.3f} ms: idle share {1 - busy_ms / tick_ms:.3f}")
    eng.run()
    check_engine_done(eng, [(None, sc.max_new_tokens)] * len(full), full,
                      f"{cfg.name} engine, decode ticks")
    final = eng.compile_counts()
    print(f"  after {len(eng.requests)} requests on one engine: captures "
          f"{final['captures']}, replays {final['replays']}")
    if final["captures"] != counts["captures"]:
        raise AssertionError(f"{cfg.name} engine: captures grew "
                             f"{final['captures']}")


def check_tokens_and_logits(want_tok, want_lg, got_tok, got_lg, atol: float,
                            what: str, upto=None):
    """Two greedy runs fed their own tokens: (B, n) tokens and (n, B, V)
    logits of each step.  Every row's tokens equal or, where they first
    part, a near tie: that step's logits within ``atol`` and the top-2
    margin under ``2 * atol``; up to where a row parts, logits within
    ``atol``.  ``upto[b]`` (default n) compares row ``b``'s first steps
    only.  Returns ``(rows equal, largest logits difference)``."""
    import numpy as np
    n_same, worst = 0, 0.0
    for b in range(want_tok.shape[0]):
        n = want_tok.shape[1] if upto is None else upto[b]
        if n == 0:
            continue
        ta, tb = list(want_tok[b][:n]), list(got_tok[b][:n])
        j = next((i for i, (x, y) in enumerate(zip(ta, tb)) if x != y),
                 len(ta) - 1)
        errs = [float(np.abs(want_lg[i, b] - got_lg[i, b]).max())
                for i in range(j + 1)]
        worst = max(worst, max(errs))
        if ta == tb:
            n_same += 1
            continue
        top2 = np.sort(want_lg[j, b])[-2:]
        margin = float(top2[1] - top2[0])
        print(f"  {what}: row {b} parts at token {j}: logits max abs "
              f"difference {errs[j]:.3e}, top-2 margin {margin:.3e}")
        if not (errs[j] <= atol and margin < 2 * atol):
            raise AssertionError(f"{what}, row {b}, token {j}: error "
                                 f"{errs[j]}, margin {margin}")
    if not worst <= atol:
        raise AssertionError(f"{what}: logits {worst} apart (tolerance "
                             f"{atol})")
    return n_same, worst


def phase_engine_card_vs_cpu(torch, ops, arch, moe_options=None):
    """A reduced config through the engine on the CPU (eager, plain
    versions) and on the card (graphs, kernels), same weights and trace:
    every request's tokens equal, or, where they first part, that tick's
    logits within LOGITS_ATOL and its top-2 margin under 2 * LOGITS_ATOL."""
    from repro_torch.common.config import ServeConfig
    from repro_torch.configs import get_reduced, with_options
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Engine
    from repro_torch.sharding.plan import single_device_plan
    cfg = with_options(get_reduced(arch), **(moe_options or {}))
    plan = single_device_plan()
    params = T.init_model(cfg, plan, seed=0, device="cpu")
    se = SMALL_ENGINE
    sc = ServeConfig(prompt_len=se["prompt_len"],
                     max_new_tokens=se["new_tokens"], n_slots=se["n_slots"],
                     page_size=se["page_size"])
    reqs = engine_requests(cfg, se["requests"], se["prompt_len"],
                           se["new_tokens"])
    engines, logits = {}, {}
    for dev in ("cpu", "cuda"):
        ops.reset_launch_counts()
        eng = engines[dev] = Engine(_to(params, dev), cfg, plan, serve=sc)
        with keep_logits(eng) as logits[dev]:
            for p, nt in reqs:
                eng.submit(p, nt)
            eng.run()
        print(f"  {dev}: {eng.ticks} ticks, compile counts "
              f"{eng.compile_counts()}, launches counted "
              f"{ {k: v for k, v in ops.launch_counts().items() if v} }")
    a, b = engines["cpu"], engines["cuda"]
    if a.ticks != b.ticks:
        raise AssertionError(f"{arch} engine: {a.ticks} ticks on the CPU, "
                             f"{b.ticks} on the card")
    n_same, worst = check_request_tokens(
        a.finished, _np_logits(logits["cpu"]), b.finished,
        _np_logits(logits["cuda"]), LOGITS_ATOL, f"{arch} engine")
    print(f"  {arch} {moe_options or ''}: {n_same} of {len(a.finished)} "
          f"requests' tokens equal; largest logits difference up to where a "
          f"request parts {worst:.3e}")


@contextlib.contextmanager
def record_engine_moe(eng):
    """While open, each MoE layer call of ``eng``'s steps appends ``(y,
    owners)`` to the yielded list: the call's output rows on the host (over
    a mesh the rank's share of the call's tokens, ``comm.split_tokens``)
    and, for each of the call's tokens in order, ``(uid, the index of the
    token its tick generates)``, or None for a dead slot or a prefill
    chunk's padding.  It wraps ``transformer.moe_layer`` and the engine's
    ticks."""
    from repro_torch.models import transformer as T
    calls, owners = [], []
    orig = T.moe_layer
    saved = {k: eng.__dict__.get(k) for k in ("_prefill_tick",
                                              "_decode_tick")}
    prefill_tick, decode_tick = eng._prefill_tick, eng._decode_tick

    def moe_layer(*a, **kw):
        y, stats = orig(*a, **kw)
        calls.append((y.float().cpu().numpy(), list(owners)))
        return y, stats

    def prefill():
        if eng.prefilling:
            req, _, start = eng.prefilling[0]
            n = min(len(req.prompt) - start, eng.buckets[-1])
            bucket = next(b for b in eng.buckets if b >= n)
            owners[:] = [(req.uid, 0)] * n + [None] * (bucket - n)
        prefill_tick()

    def decode():
        owners[:] = [(r.uid, len(r.generated)) if eng._live[i] else None
                     for i, r in enumerate(eng.slot_req)]
        decode_tick()

    T.moe_layer = moe_layer
    eng._prefill_tick, eng._decode_tick = prefill, decode
    try:
        yield calls
    finally:
        T.moe_layer = orig
        for k, v in saved.items():
            if v is None:
                del eng.__dict__[k]
            else:
                setattr(eng, k, v)


def engine_route_parts(one_calls, mesh_calls):
    """Where the mesh engine's tokens took other experts than one rank's
    (ROUTE_REL, as :func:`routing_parts`): ``one_calls`` from
    :func:`record_engine_moe` on one rank, ``mesh_calls`` the same from a
    data rank's model ranks, in model order (their shares put back in
    token order).  Returns ``({uid: the index of the first token whose
    tick's route parted, or the request's length}, parted token-layers,
    all)``."""
    import numpy as np
    if any(len(c) != len(one_calls) for c in mesh_calls):
        raise AssertionError(f"MoE calls: {len(one_calls)} on one rank, "
                             f"{[len(c) for c in mesh_calls]} on the mesh")
    upto, parted, total = {}, 0, 0
    for i, (want, owners) in enumerate(one_calls):
        got = np.concatenate([c[i][0] for c in mesh_calls])[:len(owners)]
        rel = (np.abs(got - want).max(1)
               / np.maximum(np.abs(want).max(1), 1e-30))
        for o, r in zip(owners, rel):
            if o is None:
                continue
            u, j = o
            upto.setdefault(u, 1 << 30)
            total += 1
            if r > ROUTE_REL:
                parted += 1
                upto[u] = min(upto[u], j)
    return upto, parted, total


def _np_logits(kept):
    """:func:`keep_logits`' ``{uid: [logits tensor, ...]}`` as numpy."""
    return {u: [x.float().numpy() for x in v] for u, v in kept.items()}


def check_request_tokens(want_tok, want_lg, got_tok, got_lg, atol: float,
                         what: str, upto=None):
    """Two engine runs of one trace: ``{uid: tokens}`` and ``{uid: [(V,)
    logits of each token]}`` (numpy) each.  Every request's tokens equal
    or, where they first part, a near tie: that token's logits within
    ``atol`` and the first run's top-2 margin under ``2 * atol``; up to
    where a request parts (each run was fed the same tokens until then),
    logits within ``atol``.  ``upto[uid]`` (default all) compares a
    request's first tokens only.  Returns ``(requests equal, largest
    logits difference)``."""
    import numpy as np
    n_same, worst = 0, 0.0
    for u in sorted(want_tok):
        if len(want_tok[u]) != len(got_tok[u]):
            raise AssertionError(f"{what}: request {u} gave "
                                 f"{len(got_tok[u])} tokens, expected "
                                 f"{len(want_tok[u])}")
        n = len(want_tok[u]) if upto is None else upto.get(u, len(
            want_tok[u]))
        if n == 0:
            continue
        ta, tb = list(want_tok[u][:n]), list(got_tok[u][:n])
        j = next((i for i, (x, y) in enumerate(zip(ta, tb)) if x != y),
                 len(ta) - 1)
        errs = [float(np.abs(want_lg[u][i] - got_lg[u][i]).max())
                for i in range(j + 1)]
        worst = max(worst, max(errs))
        if ta == tb:
            n_same += 1
            continue
        top2 = np.sort(want_lg[u][j])[-2:]
        margin = float(top2[1] - top2[0])
        print(f"  {what}: request {u} parts at token {j}: logits max abs "
              f"difference {errs[j]:.3e}, top-2 margin {margin:.3e}")
        if not (errs[j] <= atol and margin < 2 * atol):
            raise AssertionError(f"{what}, request {u}, token {j}: error "
                                 f"{errs[j]}, margin {margin}")
    if not worst <= atol:
        raise AssertionError(f"{what}: logits {worst} apart (tolerance "
                             f"{atol})")
    return n_same, worst


def phase_engine_qwen3(torch, ops, fixed_step_ms):
    """Phase 13: qwen3-moe through the engine at full width, 4 layers, grid
    (16, 8), under sort then dropless on one set of weights."""
    from repro_torch.configs import with_options
    from repro_torch.launch.serve import serve_config
    from repro_torch.models import transformer as T
    from repro_torch.sharding.plan import single_device_plan
    cfg = serve_config(SERVE["arch"], reduced=False,
                       num_layers=SERVE["num_layers"],
                       moe_grid=SERVE["moe_grid"])
    plan = single_device_plan()
    params = T.init_model(cfg, plan, seed=0, device="cuda")
    for name, c, per in (("sort", cfg, SORT_PER_FORWARD),
                         ("dropless", with_options(cfg, **DROPLESS),
                          DROPLESS_PER_FORWARD)):
        print(f"  -- {name}")
        phase_engine(torch, ops, params, c, plan, per, fixed_step_ms)
    del params
    gc.collect()
    torch.cuda.empty_cache()


def phase_engine_qwen15(torch, ops):
    """Phase 14: qwen1.5-0.5b through the engine at full width and depth
    (no kernel of the port runs: every count stays 0), beside its own
    fixed-batch eager decode step (batch 8, prompt 128, 32 new tokens,
    warm); then the first-token comparison of phase 13's (e) again with
    fp32 compute."""
    import numpy as np
    from repro_torch.common.config import ServeConfig
    from repro_torch.data.pipeline import synthetic_tokens
    from repro_torch.launch.serve import generate, serve_config
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Engine
    from repro_torch.sharding.plan import single_device_plan
    sc = ServeConfig()
    cfg = serve_config("qwen1.5-0.5b", reduced=False)
    plan = single_device_plan()
    params = T.init_model(cfg, plan, seed=0, device="cuda")
    prompts = torch.as_tensor(synthetic_tokens(
        np.random.default_rng(0), sc.batch_size, sc.prompt_len,
        cfg.vocab_size), device="cuda")
    for _ in range(2):
        r = generate(params, prompts, cfg, plan,
                     new_tokens=sc.max_new_tokens)
    fixed_ms = r.decode_s / r.decode_steps * 1e3
    print(f"  fixed-batch generate, warm: prefill {r.prefill_s * 1e3:.2f} ms;"
          f" decode {fixed_ms:.3f} ms a step")
    phase_engine(torch, ops, params, cfg, plan, ZERO_LAUNCHES, fixed_ms,
                 first_token_atol=QWEN15_FIRST_TOKEN_ATOL)
    # the same first-token comparison with fp32 compute and weights (the
    # same draws, not rounded to bf16; the caches stay bf16 on both paths),
    # one new token a request
    del params
    cfg32 = cfg.replace(dtype="float32")
    params = T.init_model(cfg32, plan, seed=0, device="cuda")
    reqs = engine_requests(cfg, ENGINE_REQUESTS, sc.prompt_len,
                           sc.max_new_tokens)
    eng = Engine(params, cfg32, plan, serve=sc)
    with keep_logits(eng) as logits:
        uids = [eng.submit(p, 1) for p, _ in reqs]
        eng.run()
    errs, agree, top = first_token_gaps(torch, eng, logits, uids, reqs,
                                        params, cfg32, plan)
    print(f"  fp32 compute: first-token logits against the fixed-batch "
          f"forward: max abs difference {max(errs):.3e} over {len(errs)} "
          f"requests, max |logit| {top:.3f} (tolerance "
          f"{FP32_FIRST_TOKEN_ATOL}); greedy tokens agree {agree:.3f}")
    if not max(errs) <= FP32_FIRST_TOKEN_ATOL:
        raise AssertionError(f"qwen1.5 engine, fp32: first-token logits "
                             f"{max(errs)} from the fixed-batch forward")
    del params, eng
    gc.collect()
    torch.cuda.empty_cache()


# phase 16: the serve of phase 3 over a (data 2, model 2) mesh: 4 ranks, one
# process each, sharing the one card under gloo (NCCL refuses two ranks on
# one device), so every collective crosses the host
MESH_SHAPE = (2, 2)
MESH_BACKEND = "gloo"
MESH_DEVICES = ["cuda:0"] * 4
# per forward on a rank: sort as phase 3; dropless compacts each rank's
# hop-2 arrivals before its expert FFN (one more gather and combine a layer)
MESH_PER_FORWARD = {
    "sort": SORT_PER_FORWARD,
    "dropless": {**ZERO_LAUNCHES, "dispatch_gather": 12, "combine_gather": 12,
                 "grouped_ffn_ragged": 4}}
# a capacity factor at which sort drops nothing by construction (full
# qwen3, grid (16, 8), r = h = 1): hop 1 keeps every token if cap1 >= t
# (cf >= n / top_g = 4), hop 2 every arrival if cap2 >= P * cap1 (a group
# gets at most its node's P * cap1 rows once each: cf >= (m h) / k_local =
# 4)
NO_DROP_CF = 4.0
# (name, backend, capacity factor, whether tokens can drop: sort at factor
# 2 drops, and the two sides drop other tokens, so it is run, timed and its
# drop_frac printed, and held to nothing)
MESH_RUNS = [("dropless", "dropless", 2.0, False),
             ("sort cf 4", "sort", NO_DROP_CF, False),
             ("sort cf 2", "sort", 2.0, True)]
# Routing is discrete.  The ranks sum in other orders than one rank (the
# GEMMs over half the heads, the output projection's two halves, the
# expert tiles), so a token whose router has two candidates closer than
# that noise goes to other experts on one side.  A token-layer whose MoE
# output differs by more than ROUTE_REL of its largest value between the
# two runs took other experts (a parted route reads 0.4-1.0; an unparted
# one 1e-4 in fp32, 1e-2 in bf16, on an H100); its row's later
# logits carry the other experts' outputs, and in bf16 every row parts so
# at prefill (6-17 of 1,024 tokens a layer; logits then 0.02-0.04 apart
# and up to 0.8 at a parted decode token).  So: in fp32 on the plain path
# each row is held as phase 15 holds the card to the CPU (tokens equal or
# a near tie where they first part, logits within LOGITS_ATOL) up to the
# step where its route first parts, at most ROUTE_PARTED_SHARE of the
# token-layers may part and at least half the rows must keep their route
# to the end (a wrong expert or a lost segment parts far more); the bf16
# kernel path is held as the JAX package holds its own bf16 mesh serve
# (tests/distributed/_decode_equiv.py): prefill logits within 5% of the
# largest
ROUTE_REL = 0.1
ROUTE_PARTED_SHARE = 0.01
BF16_PREFILL_REL = 0.05


def mesh_cfg(cfg, backend: str, cf: float, dtype: str = None):
    import dataclasses
    from repro_torch.configs import with_options
    cfg = with_options(cfg, dispatch_backend=backend)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    return cfg if dtype is None else cfg.replace(dtype=dtype)


def record_drops(T):
    """Wrap ``T.forward`` to keep each forward's summed ``drop_frac`` (a
    device scalar: no host read while a run is timed).  Returns the list
    and a function that undoes the wrapping."""
    seen = []
    orig = T.forward

    def forward(*a, **kw):
        out = orig(*a, **kw)
        seen.append(out[2].drop_frac)
        return out

    T.forward = forward

    def undo():
        T.forward = orig
    return seen, undo


def record_moe_outputs(T):
    """Wrap ``T.moe_layer`` to keep each call's output on the host, in call
    order (layer by layer, forward by forward).  Returns the list and a
    function that undoes the wrapping."""
    seen = []
    orig = T.moe_layer

    def moe_layer(*a, **kw):
        y, stats = orig(*a, **kw)
        seen.append(y.float().cpu().numpy())
        return y, stats

    T.moe_layer = moe_layer

    def undo():
        T.moe_layer = orig
    return seen, undo


def global_moe(results, batch, prompt_len, layers):
    """The ranks' MoE outputs of each call (``record_moe_outputs``, a
    fixed-batch ``generate``) put back in global token order: a rank holds
    its dp slice's rows, split over tp as ``comm.split_tokens`` cuts them."""
    import numpy as np
    tp = 1 + max(r["tp_index"] for r in results)
    b_loc = batch // (1 + max(r["dp_index"] for r in results))
    out = []
    for i in range(len(results[0]["moe"])):
        t = prompt_len if i < layers else 1
        got = np.zeros((batch * t, results[0]["moe"][i].shape[-1]),
                       results[0]["moe"][i].dtype)
        per = b_loc * t // tp
        f = np.arange(per)
        for r in results:
            g = r["tp_index"] * per + f
            got[(r["dp_index"] * b_loc + g // t) * t + g % t] = r["moe"][i]
        out.append(got)
    return out


def routing_parts(one_moe, results, batch, prompt_len, layers):
    """Where the mesh's tokens took other experts than one rank's
    (``one_moe``, each call's outputs in global token order): per row the
    first step with a token-layer more than ROUTE_REL apart.  Returns
    ``(first parting step per row, parted token-layers, all)``."""
    import numpy as np
    steps = len(one_moe) // layers
    first = [steps] * batch
    parted = total = 0
    for i, (want, got) in enumerate(zip(one_moe, global_moe(
            results, batch, prompt_len, layers))):
        t = prompt_len if i < layers else 1
        rel = (np.abs(got - want).max(1)
               / np.maximum(np.abs(want).max(1), 1e-30))
        far = rel > ROUTE_REL
        parted += int(far.sum())
        total += far.size
        for b in np.nonzero(far.reshape(batch, t).any(1))[0]:
            first[b] = min(first[b], i // layers)
    return first, parted, total


def drop_summary(seen) -> tuple:
    """(prefill drop_frac, mean decode drop_frac) of one generate()."""
    vals = [float(v) for v in seen]
    return vals[0], sum(vals[1:]) / max(len(vals) - 1, 1)


def _mesh_rank_init(rank, serve_kw, dtype):
    """A phase-16 rank: the mesh (once), the rank's slice of phase 3's
    weights in ``dtype`` compute (replacing any earlier ones) and its
    prompts."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import serve_config, serve_prompts
    from repro_torch.models.transformer import init_model
    from repro_torch.sharding.plan import plan_from_mesh
    st = rank.state
    if "mesh" not in st:
        st["mesh"] = make_mesh(MESH_SHAPE, ("data", "model"),
                               device=rank.device)
    if "plan" not in st:                # phase 17's ranks have a mesh
        st["plan"] = plan_from_mesh(st["mesh"])
    st.pop("params", None)
    if rank.device.type == "cuda":
        torch.cuda.empty_cache()
    cfg = serve_config(serve_kw["arch"], reduced=serve_kw["reduced"],
                       num_layers=serve_kw["num_layers"],
                       moe_grid=serve_kw["moe_grid"]).replace(dtype=dtype)
    t0 = time.perf_counter()
    params = init_model(cfg, st["plan"], seed=0, device=rank.device,
                        mesh=st["mesh"])
    prompts = serve_prompts(cfg, serve_kw["batch"], serve_kw["prompt_len"],
                            0, rank.device, st["mesh"], st["plan"])
    if rank.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0
    st.update(cfg=cfg, params=params, prompts=prompts)
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    return {"init_s": init_s, "param_bytes": nbytes,
            "coords": st["mesh"].coords, "prompts": tuple(prompts.shape)}


def _mesh_rank_run(rank, backend, cf, new_tokens, keep, timed, use_kernel):
    """One generate() on the rank's slice; the launch counts set to 0 just
    before and read just after.  ``keep`` keeps the logits and each MoE
    layer's outputs (host reads: not a timed run)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as T
    st = rank.state
    st["mesh"].wire.reset(timed=timed)
    seen, undo = record_drops(T)
    moe, undo_moe = record_moe_outputs(T) if keep else ([], lambda: None)
    ops.reset_launch_counts()
    try:
        res = generate(st["params"], st["prompts"],
                       mesh_cfg(st["cfg"], backend, cf), st["plan"],
                       new_tokens=new_tokens, keep_logits=keep,
                       use_kernel=use_kernel)
    finally:
        undo()
        undo_moe()
    launches = ops.launch_counts()
    return {"tokens": res.tokens, "logits": res.logits, "moe": moe,
            "prefill_s": res.prefill_s, "decode_s": res.decode_s,
            "steps": res.decode_steps, "launches": launches,
            "finite": res.logits_finite, "wire": res.wire,
            "drops": drop_summary(seen),
            "dp_index": st["mesh"].index("data"),
            "tp_index": st["mesh"].index("model")}


def wire_lines(wire: dict, forwards: int, what: str):
    """The wire log of one phase, per forward: rows and bytes this rank
    sent to its peers, calls, and time inside comm (host-staged gloo).
    Returns the seconds inside comm."""
    hops = {"data": "hop 1 (inter, data)", "model": "hop 2 (intra, model)"}
    for key, e in sorted(wire.items()):
        op, axes, dtype = key.split(" ")
        tag = hops.get(axes, axes) if "all_to_all" in op else axes
        print(f"    {what} {op} {tag} {dtype}: {e['calls'] / forwards:g} "
              f"calls, {e['rows'] / forwards:,.0f} rows, "
              f"{e['bytes'] / forwards / 2**20:.3f} MiB sent a forward"
              + (f", {e['s'] / forwards * 1e3:.3f} ms" if e["s"] else ""))
    return sum(e["s"] for e in wire.values())


def one_rank_runs(torch, serve_kw, sc, dtype, use_kernel, names):
    """The one-rank serve of phase 16's weights and prompts in ``dtype``
    compute, in this process: for each config in ``names``, a run that
    keeps its logits, and (on the kernel path) a warm one."""
    from repro_torch.launch.serve import generate, serve_config, serve_prompts
    from repro_torch.models import transformer as T
    from repro_torch.models.transformer import init_model
    from repro_torch.sharding.plan import single_device_plan
    cfg = serve_config(serve_kw["arch"], reduced=serve_kw["reduced"],
                       num_layers=serve_kw["num_layers"],
                       moe_grid=serve_kw["moe_grid"]).replace(dtype=dtype)
    dev = torch.device(serve_kw["device"])
    plan = single_device_plan()
    params = init_model(cfg, plan, seed=0, device=dev)
    prompts = serve_prompts(cfg, sc.batch_size, sc.prompt_len, 0, dev)
    out = {}
    for name, backend, cf, _ in MESH_RUNS:
        if name not in names:
            continue
        c = mesh_cfg(cfg, backend, cf)
        seen, undo = record_drops(T)
        moe, undo_moe = record_moe_outputs(T)
        try:
            r = generate(params, prompts, c, plan,
                         new_tokens=sc.max_new_tokens, keep_logits=True,
                         use_kernel=use_kernel)
        finally:
            undo()
            undo_moe()
        warm = (generate(params, prompts, c, plan,
                         new_tokens=sc.max_new_tokens) if use_kernel else None)
        out[name] = (r, drop_summary(seen), warm, moe)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_mesh_serve(torch, ops, fixed_step_ms, devices=MESH_DEVICES,
                     reduced=False):
    """Phase 3's serve over MESH_SHAPE: 4 ranks on the one card under
    gloo, against the one-rank serve of the same weights and prompts in
    this process.  (``devices=["cpu"] * 4, reduced=True`` rehearses it on
    the CPU with the reduced config.)"""
    from repro_torch.common.config import ServeConfig
    from repro_torch.launch.mesh import RankPool
    sc = ServeConfig()
    kw = dict(arch=SERVE["arch"], reduced=reduced,
              num_layers=None if reduced else SERVE["num_layers"],
              moe_grid=None if reduced else SERVE["moe_grid"],
              batch=sc.batch_size, prompt_len=sc.prompt_len)
    held = [name for name, _, _, can_drop in MESH_RUNS if not can_drop]
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  {len(devices)} ranks, one process each, on {devices} under "
          f"{MESH_BACKEND}: the collectives cross the host (gloo's "
          f"transport), not NVLink; mesh "
          f"{dict(zip(('data', 'model'), MESH_SHAPE))}")
    one_kw = dict(kw, device=devices[0])
    one = one_rank_runs(torch, one_kw, sc, "bfloat16", True,
                        [n for n, *_ in MESH_RUNS])
    one32 = one_rank_runs(torch, one_kw, sc, "float32", False, held)
    t0 = time.perf_counter()
    with RankPool(len(devices), backend=MESH_BACKEND, devices=devices,
                  timeout_s=900) as pool:
        inits = pool.run(_mesh_rank_init, kw, "bfloat16")
        print(f"  ranks up and weights drawn and cut in "
              f"{time.perf_counter() - t0:.1f} s (slowest rank's draw "
              f"{max(i['init_s'] for i in inits):.1f} s); each rank holds "
              f"{inits[0]['param_bytes'] / 2**30:.2f} GiB of parameters and "
              f"prompts {inits[0]['prompts']}")
        for name, backend, cf, can_drop in MESH_RUNS:
            runs = [pool.run(_mesh_rank_run, backend, cf, sc.max_new_tokens,
                             keep, timed, True)
                    for keep, timed in ((True, False), (False, False),
                                        (False, True))]
            check_mesh_run(name, runs, one[name], sc,
                           None if reduced else MESH_PER_FORWARD[backend],
                           held=not can_drop)
        pool.run(_mesh_rank_init, kw, "float32")
        for name, backend, cf, _ in MESH_RUNS:
            if name in held:
                got = pool.run(_mesh_rank_run, backend, cf,
                               sc.max_new_tokens, True, False, False)
                check_mesh_fp32(name, got, one32[name], sc)
    print(f"  one rank, phase 3's warm decode step (same call): "
          f"{fixed_step_ms:.2f} ms")


def check_mesh_run(name, runs, one, sc, per_forward, held):
    """Phase 16's checks and readings of one config's three runs on the
    kernel path (checked, warm, comm timed) against the one-rank run
    ``one``; each rank's launches must be ``per_forward`` a forward (None:
    not checked, the CPU rehearsal).  A ``held`` config drops nothing on
    either side, and its prefill logits must lie within BF16_PREFILL_REL
    of one rank's."""
    import numpy as np
    from repro_torch.launch.serve import gather_logits, gather_rows
    first, warm, timed = runs
    one_r, one_drops, one_warm, one_moe = one
    steps = first[0]["steps"]
    for r, out in enumerate(first):
        if not out["finite"]:
            raise AssertionError(f"mesh {name}: rank {r} non-finite logits")
        want = {k: v * (steps + 1) for k, v in (per_forward or {}).items()}
        if per_forward is not None and out["launches"] != want:
            raise AssertionError(f"mesh {name}: rank {r} launches "
                                 f"{out['launches']}, expected {want}")
    tokens, logits = gather_rows(first), gather_logits(first)
    if tokens.shape != (sc.batch_size, sc.max_new_tokens):
        raise AssertionError(f"mesh {name}: tokens {tokens.shape}")
    drops = [out["drops"] for out in first]
    print(f"  {name}: launches a rank {first[0]['launches']} over "
          f"{steps + 1} forwards; drop_frac (summed over layers and hops; "
          f"prefill, decode mean) on the ranks "
          f"{[tuple(round(x, 4) for x in d) for d in drops]}, one rank "
          f"{tuple(round(x, 4) for x in one_drops)}")
    if held and (any(max(d) != 0.0 for d in drops)
                 or max(one_drops) != 0.0):
        raise AssertionError(f"mesh {name}: a token dropped")
    parts = [next((i for i in range(tokens.shape[1])
                   if tokens[b, i] != one_r.tokens[b, i]), tokens.shape[1])
             for b in range(tokens.shape[0])]
    pre = float(np.abs(logits[0] - one_r.logits[0]).max())
    rel = pre / float(np.abs(one_r.logits[0]).max())
    route, n_parted, n_all = routing_parts(one_moe, first, sc.batch_size,
                                           sc.prompt_len,
                                           len(one_moe) // (steps + 1))
    print(f"  {name}, bf16 against one rank: tokens equal "
          f"{float((tokens == one_r.tokens).mean()):.3f} of "
          f"{tokens.size}; each row's first parting token {parts}, first "
          f"step its route parts {route} ({n_parted} of {n_all} "
          f"token-layers took other experts); prefill "
          f"logits {pre:.3e} apart, {rel:.4f} of the largest"
          + (f" (bound {BF16_PREFILL_REL})" if held else
             " (not held: each side drops its own tokens)"))
    if held and not rel <= BF16_PREFILL_REL:
        raise AssertionError(f"mesh {name}: prefill logits {rel} of the "
                             f"largest apart")
    pf = max(o["prefill_s"] for o in warm) * 1e3
    dc = max(o["decode_s"] for o in warm) / steps * 1e3
    print(f"  {name}, warm, slowest rank: prefill {pf:.2f} ms, decode "
          f"{dc:.2f} ms a step ({steps * sc.batch_size / dc * 1e3:.1f} "
          f"tokens/s); one rank, warm: prefill "
          f"{one_warm.prefill_s * 1e3:.2f} ms, decode "
          f"{one_warm.decode_s / steps * 1e3:.2f} ms a step")
    w = timed[0]["wire"]
    s_pf = wire_lines(w["prefill"], 1, "prefill")
    s_dc = wire_lines(w["decode"], steps, "decode")
    tpf = max(o["prefill_s"] for o in timed) * 1e3
    tdc = max(o["decode_s"] for o in timed) / steps * 1e3
    print(f"  {name}, rank 0, time inside comm (gloo through the host, the "
          f"card synchronized around each call): prefill "
          f"{s_pf * 1e3:.2f} of {tpf:.2f} ms, decode "
          f"{s_dc / steps * 1e3:.2f} of {tdc:.2f} ms a step")


def check_mesh_fp32(name, got, one, sc):
    """The mesh's fp32 plain-path run against one rank's: each row held as
    phase 15 holds the card to the CPU up to the step where its route
    first parts; few parted routes (ROUTE_REL)."""
    from repro_torch.launch.serve import gather_logits, gather_rows
    one_r, one_drops, _, one_moe = one
    drops = [out["drops"] for out in got]
    if (not all(o["finite"] for o in got) or any(max(d) for d in drops)
            or max(one_drops)):
        raise AssertionError(f"mesh {name} fp32: non-finite logits or a "
                             f"drop: {drops}, one rank {one_drops}")
    steps = got[0]["steps"] + 1
    route, n_parted, n_all = routing_parts(one_moe, got, sc.batch_size,
                                           sc.prompt_len,
                                           len(one_moe) // steps)
    kept = sum(r == steps for r in route)
    print(f"  {name}, fp32 (plain path): the first step each row's route "
          f"parts {route}; {n_parted} of {n_all} token-layers took other "
          f"experts (bound {ROUTE_PARTED_SHARE}); {kept} of "
          f"{len(route)} rows keep their route to the end")
    if n_parted > ROUTE_PARTED_SHARE * n_all or 2 * kept < len(route):
        raise AssertionError(f"mesh {name} fp32: routes part too often "
                             f"({n_parted} of {n_all}; {kept} rows kept)")
    n_same, worst = check_tokens_and_logits(
        one_r.tokens, one_r.logits, gather_rows(got), gather_logits(got),
        LOGITS_ATOL, f"mesh {name} fp32", upto=route)
    print(f"  {name}, fp32 (plain path) against one rank, each row up to "
          f"where its route parts: {n_same} rows' tokens equal; largest "
          f"logits difference {worst:.3e} (tolerance {LOGITS_ATOL})")


# phase 17: the MLM training path over phase 16's mesh (4 gloo ranks
# sharing the card).  Full width; the depth cut 12 -> 6 (3 MoE layers): a
# rank then holds ~0.48 B fp32 parameters (a quarter of the experts, half
# of the dense weights) and their gradients and LAMB moments, and the
# one-rank run of the same weights (~1.9 B) runs before the ranks start
MESH_TRAIN = dict(arch="smile-3.7b", reduced=False, num_layers=6, batch=16,
                  seq=128, optimizer="lamb", moe_grid=(16, 8),
                  moe_options={"router_impl": "fused", "sort_impl": "radix"})
# smile: one warm-up step, 3 timed, then one with each collective timed
# (the card synchronized around it); switch: 2 steps, the second timed so
MESH_TRAIN_TIMED = 3
MESH_SWITCH_STEPS = 2
# a rank's routing wrapper calls a step: 3 MoE layers x the hops (SMILE 2,
# Switch 1) x (the forward, the remat recompute)
MESH_TRAIN_CALLS = {"smile-3.7b": 12, "switch-3.7b": 6}
# the phase-2 shapes (ROUTER_SHAPES, SORT_SHAPES) that hold each arch's
# routing calls on a mesh rank
MESH_TRAIN_HELD = {"smile-3.7b": ("mesh train hop-1", "mesh train hop-2"),
                   "switch-3.7b": ("mesh switch flat",)}
# tests/distributed/_train_equiv.py's bounds: step 1 against one rank
MESH_TRAIN_LOSS_ATOL = 2e-2
MESH_TRAIN_GNORM_REL = 6e-2


class RoutingShapes:
    """Stands in for ``repro_torch.kernels.ops`` in the MoE modules and
    records the shape of each routing call before passing it on."""

    def __init__(self, ops):
        self.ops, self.seen = ops, set()

    def __getattr__(self, name):
        return getattr(self.ops, name)

    def router_fused(self, x, w, k, **kw):
        self.seen.add(("router_fused", x.shape[0], w.shape[1], k))
        return self.ops.router_fused(x, w, k, **kw)

    def group_sort(self, keys, num_keys, **kw):
        self.seen.add(("group_sort", keys.shape[0], num_keys))
        return self.ops.group_sort(keys, num_keys, **kw)


def _mesh_train_rank(rank, kw, steps):
    """A phase-17 rank: the mesh (once), then ``train(mesh=...)``, every
    launch count set to 0 just before and read just after, the routing
    calls' shapes recorded; the last step times its collectives (the card
    synchronized around each one)."""
    import torch
    from repro_torch.core import dispatch, moe
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import train
    from repro_torch.optim import leaf_groups
    st = rank.state
    if "mesh" not in st:
        st["mesh"] = make_mesh(MESH_SHAPE, ("data", "model"),
                               device=rank.device)
    cuda = rank.device.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    wire = st["mesh"].wire

    def on_step(step):
        wire.timed = step == steps - 1

    shapes = RoutingShapes(ops)
    moe.kops = dispatch.kops = shapes
    ops.reset_launch_counts()
    try:
        params, hist = train(steps=steps, log_every=1, mesh=st["mesh"],
                             on_step=on_step, **kw)
    finally:
        moe.kops = dispatch.kops = ops
        wire.timed = False
    launches = ops.launch_counts()
    n = sum(p.numel() for g in leaf_groups(params) for p in g.pieces)
    del params
    gc.collect()
    peak = torch.cuda.max_memory_allocated() if cuda else None
    if cuda:
        torch.cuda.empty_cache()
    return {"history": hist, "launches": launches, "peak": peak,
            "params": n, "shapes": sorted(shapes.seen),
            "coords": st["mesh"].coords}


def train_wire_lines(wire: dict, what: str):
    """A step's collectives on one rank, by op, axes and direction (the
    backward's under ``<op>.grad``, the gradient sync's under
    ``psum.sync``, LAMB's and the clip's norms under ``psum.norm``): calls,
    rows and bytes sent, time inside comm, and the time inside comm by
    direction.  Returns {(hop axes, direction): bytes} of the All2Alls'
    payload."""
    names = {"grad": "backward", "sync": "gradient sync", "norm": "norms",
             "params": "parameter gather", "sentinel": "sentinel verdict"}
    hops, inside = {}, {}
    for key, e in sorted(wire.items()):
        op, axes, dtype = key.split(" ")
        base, _, tail = op.partition(".")
        way = names.get(tail, "forward")
        print(f"    {what} {base} over {axes} {dtype} {way}: "
              f"{e['calls']:g} calls, {e['rows']:,.0f} rows, "
              f"{e['bytes'] / 2**20:.3f} MiB sent, {e['s'] * 1e3:.3f} ms")
        inside[way] = inside.get(way, 0.0) + e["s"]
        if base == "all_to_all" or base == "ragged_all_to_all":
            if dtype != "int32":
                hops[(axes, way)] = hops.get((axes, way), 0) + e["bytes"]
    print(f"    {what} inside comm {sum(inside.values()) * 1e3:.1f} ms: "
          + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in inside.items()))
    return hops


def phase_mesh_train(torch, ops, devices=MESH_DEVICES, reduced=False,
                     after=None):
    """smile-3.7b's MLM training (MESH_TRAIN) over MESH_SHAPE: 4 ranks
    under gloo, after the one-rank ``train()`` of the same weights and
    batches in this process (then freed); then switch-3.7b, the same cut.
    ``after(pool, runs)``, where given, runs on the same ranks before they
    stop.  (``devices=["cpu"] * 4, reduced=True`` rehearses it on the
    CPU.)"""
    from repro_torch.launch.mesh import RankPool
    from repro_torch.launch.train import train
    kw = dict(MESH_TRAIN, reduced=reduced)
    if reduced:
        kw.update(num_layers=None, moe_grid=None)
    cuda = torch.device(devices[0]).type == "cuda"
    tokens = kw["batch"] * kw["seq"]
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, one = train(steps=1, log_every=1, device=devices[0], **kw)
    del params
    gc.collect()
    one_peak = torch.cuda.max_memory_allocated() if cuda else None
    if cuda:
        torch.cuda.empty_cache()
    print(f"  one rank ({devices[0]}): step 1 loss {one[0]['loss']:.5f} "
          f"grad norm {one[0]['grad_norm']:.5f}, {one[0]['step_ms']:.1f} ms "
          f"(cold); run {time.perf_counter() - t0:.1f} s"
          + (f", peak {one_peak / 2**30:.2f} GiB" if cuda else ""))
    print(f"  {len(devices)} ranks, one process each, on {devices} under "
          f"{MESH_BACKEND}: the collectives cross the host (gloo's "
          f"transport), not NVLink; mesh "
          f"{dict(zip(('data', 'model'), MESH_SHAPE))}; global batch "
          f"{kw['batch']} x {kw['seq']}")
    steps = 1 + MESH_TRAIN_TIMED + 1
    t0 = time.perf_counter()
    with RankPool(len(devices), backend=MESH_BACKEND, devices=devices,
                  timeout_s=900) as pool:
        runs = {"smile-3.7b": pool.run(_mesh_train_rank, kw, steps),
                "switch-3.7b": pool.run(_mesh_train_rank,
                                        dict(kw, arch="switch-3.7b"),
                                        MESH_SWITCH_STEPS)}
        print(f"  both mesh runs, the ranks' start included: "
              f"{time.perf_counter() - t0:.1f} s")
        check_mesh_train(runs, one, kw, tokens, cuda, reduced)
        if after is not None:
            after(pool, runs)


def check_mesh_train(runs, one, kw, tokens, cuda, reduced):
    """Phase 17's checks and prints over both archs' runs (``one``: the
    one-rank run's history)."""
    hops = {}
    for arch, out in runs.items():
        hist = [r["history"] for r in out]
        for r, h in enumerate(hist):
            if not all(math.isfinite(e[k]) for e in h
                       for k in ("loss", "grad_norm")):
                raise AssertionError(f"mesh train {arch}: rank {r} "
                                     f"non-finite loss or grad norm")
            if [e["loss"] for e in h] != [e["loss"] for e in hist[0]]:
                raise AssertionError(f"mesh train {arch}: rank {r}'s loss "
                                     f"is not rank 0's")
        for h in hist[0]:
            ms = max(x[h["step"] - 1]["step_ms"] for x in hist)
            print(f"  {arch} step {h['step']}: loss {h['loss']:.5f} ce "
                  f"{h['ce']:.5f} lb {h['lb']:.5f} drop_frac "
                  f"{h['drop_frac']:.4f} grad norm {h['grad_norm']:.5f}; "
                  f"slowest rank {ms:.1f} ms")
        calls = MESH_TRAIN_CALLS[arch] * len(hist[0])
        want = {k: (calls if cuda and k in ("router_fused", "group_sort")
                    else 0) for k in out[0]["launches"]}
        for r, o in enumerate(out):
            if o["launches"] != want:
                raise AssertionError(f"mesh train {arch}: rank {r} launches "
                                     f"{o['launches']}, expected {want}")
        print(f"  {arch}: routing kernel launches a step on each rank: "
              f"router_fused {want['router_fused'] / len(hist[0]):g}, "
              f"group_sort {want['group_sort'] / len(hist[0]):g}; routing "
              f"calls' shapes on rank 0 {out[0]['shapes']}")
        print(f"  {arch}: parameters a rank {out[0]['params'] / 1e9:.3f} B; "
              f"peak memory by rank "
              + (", ".join(f"{o['peak'] / 2**30:.2f} GiB" for o in out)
                 if cuda else "not measured (CPU)"))
        last = hist[0][-1]
        hops[arch] = train_wire_lines(last["wire"], f"{arch} rank 0, step "
                                      f"{last['step']} ({last['step_ms']:.1f}"
                                      f" ms):")
    smile = [r["history"] for r in runs["smile-3.7b"]]
    timed = [max(h[i]["step_ms"] for h in smile)
             for i in range(1, 1 + MESH_TRAIN_TIMED)]
    mean = sum(timed) / len(timed)
    print(f"  smile-3.7b over the mesh, slowest rank, timed steps "
          f"{timed}: mean {mean:.1f} ms a step, {tokens / mean * 1e3:,.0f} "
          f"tokens/s (gloo through the host, 4 processes on one card)")
    print(f"  the All2Alls' bytes a step on rank 0 by hop and direction: "
          + "; ".join(f"{arch} {k[0]} {k[1]} {v / 2**20:.3f} MiB"
                      for arch, h in hops.items()
                      for k, v in sorted(h.items())))
    first = smile[0][0]
    dl = abs(first["loss"] - one[0]["loss"])
    dg = abs(first["grad_norm"] - one[0]["grad_norm"]) / max(
        one[0]["grad_norm"], 1e-6)
    print(f"  step 1 against one rank: loss {dl:.3e} apart (bound "
          f"{MESH_TRAIN_LOSS_ATOL}), grad norm {dg:.3e} relative (bound "
          f"{MESH_TRAIN_GNORM_REL})")
    if not (dl <= MESH_TRAIN_LOSS_ATOL and dg <= MESH_TRAIN_GNORM_REL):
        raise AssertionError("mesh train: step 1 parts from one rank")
    if reduced:
        return
    for arch, names in MESH_TRAIN_HELD.items():
        held = {("router_fused", t, E, k) for name, t, E, k, *_ in
                ROUTER_SHAPES if name in names} | {
                ("group_sort", A, K) for name, A, K, _ in SORT_SHAPES
                if name in names}
        got = {tuple(x) for x in runs[arch][0]["shapes"]}
        if got != held:
            raise AssertionError(f"mesh train {arch}: routing shapes {got}, "
                                 f"phase 2 holds {held}")


# phase 18, the robust runtime.  (a) On phase 17's ranks, its config,
# weights and batches under ZeRO-1 LAMB with the sentinel: the same 4
# steps (one warm-up, 3 timed), one with each collective timed (the card
# synchronized around it, as phase 17's fifth), then one step with a NaN
# in one element of POISON_RANK's slice of the last MoE layer's experts
# (w1: every slot of that expert goes through it, after every routing
# decision of the forward).  (b) On one rank: smile-3.7b at full width with 2 of 12 layers
# (a dense and a MoE layer, the paper's pair), batch 16 x 128 (phase 2's
# "train hop-1/2" routing shapes), the sentinel on: 4 steps twice, then
# halted at step 2 with a snapshot, and resumed
ROBUST_STEPS = 1 + MESH_TRAIN_TIMED
POISON_RANK = 3
ROBUST_ONE = dict(arch="smile-3.7b", reduced=False, num_layers=2, batch=16,
                  seq=128, optimizer="lamb", moe_grid=(16, 8), steps=4,
                  log_every=1, sentinel=True,
                  moe_options={"router_impl": "fused", "sort_impl": "radix"})
# a step's routing calls on one rank at 2 layers: one MoE layer x 2 hops x
# (the forward, the remat recompute)
ROBUST_ONE_CALLS = 4
CKPT_SMOKE_DIR = ROOT / ".ckpt_smoke"


def tensor_digests(torch, tensors) -> list:
    """A digest of each fp32 tensor's bits, computed on its device: the sum
    of its int32 words and their sum weighted by position (int64, wrapping),
    a chunk at a time; one host read for all of them."""
    from repro_torch.optim.optimizers import _chunks
    out = []
    for t in tensors:
        acc = torch.zeros(2, dtype=torch.int64, device=t.device)
        off = 0
        for c in _chunks(t.detach()):
            w = c.view(torch.int32).to(torch.int64)
            pos = torch.arange(off + 1, off + 1 + w.numel(), device=t.device,
                               dtype=torch.int64) * 2654435761
            acc += torch.stack([w.sum(), (w * pos).sum()])
            off += w.numel()
        out.append(acc)
    return torch.stack(out).cpu().tolist()


def _robust_mesh_rank(rank, kw, steps, horizon, poison_rank):
    """A phase-18 rank: phase 17's mesh, weights and batches, ZeRO-1 LAMB
    and the sentinel through ``build_train_step``, ``steps`` steps on the
    schedule of phase 17's run (``horizon`` steps), every launch count set
    to 0 just before and read just after; one more with its collectives
    timed; then the poisoned step, the parameters' and the optimizer
    state's digests taken before and after it."""
    import torch
    from repro_torch.common.config import TrainConfig
    from repro_torch.core import dispatch, moe
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train_config
    from repro_torch.models.transformer import init_model
    from repro_torch.optim import leaf_groups, make_optimizer, make_schedule
    from repro_torch.sharding.plan import plan_from_mesh
    from repro_torch.train.sentinel import FIELDS, init_sentinel_state
    from repro_torch.train.step import build_train_step, zero1_state
    from repro_torch.weights import state_leaves
    mesh = rank.state["mesh"]
    dev = mesh.device
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    cfg = train_config(kw["arch"], reduced=kw["reduced"],
                       moe_options=kw["moe_options"], moe_grid=kw["moe_grid"],
                       num_layers=kw["num_layers"])
    plan = plan_from_mesh(mesh)
    lr = 3e-4                                  # train()'s default
    tcfg = TrainConfig(global_batch_size=kw["batch"], seq_len=kw["seq"],
                       steps=horizon, optimizer=kw["optimizer"], lr=lr,
                       warmup_steps=max(horizon // 10, 1), sentinel=True)
    params = init_model(cfg, plan, seed=0, device=dev, compute_cast=False,
                        mesh=mesh)
    state = zero1_state(params, cfg, plan)
    sent = init_sentinel_state(dev)
    pipe = DataPipeline(cfg, kw["batch"], kw["seq"], seed=0)
    b = next(pipe)
    step = build_train_step(cfg, tcfg, plan, make_optimizer(kw["optimizer"]),
                            make_schedule("cosine", lr, tcfg.warmup_steps,
                                          horizon),
                            params, b, mesh=mesh, zero1=True, sentinel=True)
    shapes = RoutingShapes(ops)
    moe.kops = dispatch.kops = shapes
    hist = []

    def one(i, b):
        nonlocal params, state, sent
        mesh.wire.reset()
        sync()
        t0 = time.perf_counter()
        params, state, m, sent = step(params, state, b, i + 1, sent)
        m = {k: float(v) for k, v in m.items()}
        sync()
        hist.append({"step": i + 1, **m,
                     "step_ms": (time.perf_counter() - t0) * 1e3,
                     "wire": mesh.wire.summary()})

    ops.reset_launch_counts()
    try:
        for i in range(steps):
            one(i, b if i == 0 else next(pipe))
    finally:
        moe.kops = dispatch.kops = ops
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    mesh.wire.timed = True
    try:
        one(steps, next(pipe))
    finally:
        mesh.wire.timed = False
    if mesh.rank == poison_rank:
        w1 = [g for g in leaf_groups(params)
              if g.name.endswith(".experts.w1")][-1]
        with torch.no_grad():
            w1.pieces[-1].view(-1)[0] = float("nan")
    tensors = [t for leaf in state_leaves(params, state)
               for t in leaf.tensors]
    before, clock = tensor_digests(torch, tensors), state.step
    params, state, m, sent = step(params, state, next(pipe), steps + 2, sent)
    after = tensor_digests(torch, tensors)
    pipe.close()
    out = {"history": hist, "launches": launches, "peak": peak,
           "shapes": sorted(shapes.seen), "skip": float(m["skip"]),
           "loss": float(m["loss"]), "unchanged": before == after,
           "tensors": len(tensors), "clock": (clock, state.step),
           "sentinel": {k: float(getattr(sent, k)) for k in FIELDS}}
    del params, state, tensors
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def phase_robust_mesh(torch, ops, pool, p17, reduced=False):
    """Phase 18 (a) on phase 17's ranks (``pool``; ``p17``: phase 17's
    smile-3.7b results by rank)."""
    kw = dict(MESH_TRAIN, reduced=reduced)
    if reduced:
        kw.update(num_layers=None, moe_grid=None)
    cuda = p17[0]["peak"] is not None
    t0 = time.perf_counter()
    out = pool.run(_robust_mesh_rank, kw, ROBUST_STEPS,
                   1 + MESH_TRAIN_TIMED + 1, POISON_RANK)
    hist = [o["history"] for o in out]
    ref = [r["history"] for r in p17]
    for r, h in enumerate(hist):
        if [(e["loss"], e["grad_norm"], e["skip"]) for e in h] != [
                (e["loss"], e["grad_norm"], e["skip"]) for e in hist[0]]:
            raise AssertionError(f"robust mesh: rank {r}'s metrics are not "
                                 f"rank 0's")
    for e, f in zip(hist[0][:ROBUST_STEPS], ref[0]):
        print(f"  ZeRO-1 + sentinel step {e['step']}: loss {e['loss']:.5f} "
              f"(phase 17 {f['loss']:.5f}) grad norm {e['grad_norm']:.5f} "
              f"({f['grad_norm']:.5f}) skip {e['skip']:g}; slowest rank "
              f"{max(h[e['step'] - 1]['step_ms'] for h in hist):.1f} ms")
    dg = abs(hist[0][0]["grad_norm"] - ref[0][0]["grad_norm"]) / max(
        ref[0][0]["grad_norm"], 1e-6)
    dl = max(abs(e["loss"] - f["loss"]) for e, f in
             zip(hist[0][1:], ref[0][1:ROBUST_STEPS]))
    print(f"  against phase 17: step 1 grad norm {dg:.3e} relative (bound "
          f"{MESH_TRAIN_GNORM_REL}); steps 2-{ROBUST_STEPS} loss {dl:.3e} "
          f"apart at most (bound {MESH_TRAIN_LOSS_ATOL})")
    if not (dg <= MESH_TRAIN_GNORM_REL and dl <= MESH_TRAIN_LOSS_ATOL):
        raise AssertionError("robust mesh: ZeRO-1 parts from phase 17")
    if any(e["skip"] for e in hist[0]):
        raise AssertionError("robust mesh: a healthy step was skipped")
    tokens = kw["batch"] * kw["seq"]
    ms = [max(h[i]["step_ms"] for h in hist) for i in range(1, ROBUST_STEPS)]
    ms17 = [max(h[i]["step_ms"] for h in ref) for i in range(1, ROBUST_STEPS)]
    mean, mean17 = sum(ms) / len(ms), sum(ms17) / len(ms17)
    print(f"  slowest rank, timed steps {[round(x, 1) for x in ms]}: mean "
          f"{mean:.1f} ms a step, {tokens / mean * 1e3:,.0f} tokens/s; phase "
          f"17 {mean17:.1f} ms, {tokens / mean17 * 1e3:,.0f} tokens/s (gloo "
          f"through the host, 4 processes on one card)")
    if cuda:
        print(f"  peak memory by rank: "
              + ", ".join(f"{o['peak'] / 2**30:.2f} GiB" for o in out)
              + "; phase 17: "
              + ", ".join(f"{r['peak'] / 2**30:.2f} GiB" for r in p17))
    last = hist[0][-1]
    train_wire_lines(last["wire"], f"rank 0, step {last['step']} "
                     f"({last['step_ms']:.1f} ms; phase 17's "
                     f"{ref[0][-1]['step_ms']:.1f}):")
    last = last["wire"]
    zero = sum(e["bytes"] for k, e in last.items()
               if k.split(" ")[0] in ("psum_scatter.sync", "all_gather.params")
               and k.split(" ")[1] == "data")
    plain = sum(e["bytes"] for k, e in ref[0][-1]["wire"].items()
                if k.split(" ")[0] == "psum.sync" and k.split(" ")[1] == "data")
    print(f"  the gradient sync over data a step: ZeRO-1's psum_scatter and "
          f"all_gather {zero / 2**20:.3f} MiB, phase 17's psum "
          f"{plain / 2**20:.3f} MiB")
    calls = MESH_TRAIN_CALLS[kw["arch"]] * ROBUST_STEPS
    want = {k: (calls if cuda and k in ("router_fused", "group_sort") else 0)
            for k in out[0]["launches"]}
    for r, o in enumerate(out):
        if o["launches"] != want:
            raise AssertionError(f"robust mesh: rank {r} launches "
                                 f"{o['launches']}, expected {want}")
    if not reduced:
        held = {("router_fused", t, E, k) for name, t, E, k, *_ in
                ROUTER_SHAPES if name in MESH_TRAIN_HELD[kw["arch"]]} | {
                ("group_sort", A, K) for name, A, K, _ in SORT_SHAPES
                if name in MESH_TRAIN_HELD[kw["arch"]]}
        got = {tuple(x) for o in out for x in o["shapes"]}
        if not got <= held:
            raise AssertionError(f"robust mesh: routing shapes {got}, phase "
                                 f"2 holds {held}")
    print(f"  poisoned step (a NaN in rank {POISON_RANK}'s slice of the last "
          f"MoE layer's experts): loss {out[0]['loss']}, skip by rank "
          f"{[o['skip'] for o in out]}; {out[0]['tensors']} tensors a rank "
          f"bit-unchanged: {[o['unchanged'] for o in out]}; ZeRO-1 step "
          f"clock {out[0]['clock']}; sentinel {out[0]['sentinel']}")
    for r, o in enumerate(out):
        s = o["sentinel"]
        if not (o["skip"] == 1.0 and o["unchanged"]
                and o["clock"] == (ROBUST_STEPS + 1, ROBUST_STEPS + 1)
                and s["nonfinite"] == 1.0 and s["skipped"] == 1.0
                and s["steps"] == ROBUST_STEPS + 2):
            raise AssertionError(f"robust mesh: rank {r} did not skip the "
                                 f"poisoned step cleanly: {o['skip']}, "
                                 f"{o['unchanged']}, {o['clock']}, {s}")
    print(f"  part (a) {time.perf_counter() - t0:.1f} s")


def _same_bits(torch, a, b) -> bool:
    return len(a) == len(b) and all(
        torch.equal(x.view(torch.int32), y.view(torch.int32))
        for x, y in zip(a, b))


def phase_robust_one_rank(torch, ops, device="cuda", reduced=False):
    """Phase 18 (b): ``train()`` on one rank (ROBUST_ONE), every launch
    count set to 0 just before the four runs and read just after: 4 steps
    twice (bit-identical), then halted at step 2 with a snapshot
    (``ckpt_every=2, ckpt_keep=1``) and resumed, bit-identical to the
    first run; the snapshots are deleted afterwards.  (``device="cpu",
    reduced=True`` rehearses it on the CPU.)"""
    import shutil
    from repro_torch.core import dispatch, moe
    from repro_torch.launch.train import train
    from repro_torch.optim import leaf_groups
    kw = dict(ROBUST_ONE, reduced=reduced, device=device)
    if reduced:
        kw.update(num_layers=None, moe_grid=None)
    cuda = torch.device(device).type == "cuda"
    leaves = lambda p: [t.detach() for g in leaf_groups(p) for t in g.pieces]
    d = str(CKPT_SMOKE_DIR)
    shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    shapes = RoutingShapes(ops)
    moe.kops = dispatch.kops = shapes
    ops.reset_launch_counts()
    try:
        p, ha = train(**kw)
        first = [t.clone() for t in leaves(p)]
        n = sum(t.numel() for t in first)
        del p
        p, hb = train(**kw)
        twice = _same_bits(torch, first, leaves(p))
        del p
        _, hc = train(**kw, ckpt_dir=d, ckpt_every=2, ckpt_keep=1,
                      halt_after=2)
        snaps = sorted(os.listdir(d))
        p, hr = train(**kw, ckpt_dir=d, resume=True)
        resumed = _same_bits(torch, first, leaves(p))
        del p, first
    finally:
        moe.kops = dispatch.kops = ops
        shutil.rmtree(d, ignore_errors=True)
    launches = ops.launch_counts()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    steps = [e for e in ha if "step" in e]
    ms = [e["step_ms"] for e in steps[1:]]
    print(f"  {n / 1e9:.3f} B fp32 parameters; 4 steps: loss "
          f"{[round(e['loss'], 5) for e in steps]}, steps 2-4 "
          f"{[round(x, 1) for x in ms]} ms")
    save = hc[-2]["checkpoints"]["saves"][0]
    got = hr[-2]["checkpoints"]["restored"]
    print(f"  snapshot at step {save['step']} ({snaps}): {save['bytes']:,} "
          f"bytes ({save['bytes'] / 2**30:.2f} GiB, stored npz); save "
          f"{save['save_s']:.2f} s, sha256 {save['sha256_s']:.2f} s; "
          f"restore from step {got['step']}: sha256 {got['sha256_s']:.2f} s, "
          f"load {got['load_s']:.2f} s")
    print(f"  two uninterrupted runs bit-identical: {twice}; halted at step "
          f"2 and resumed, bit-identical to the uninterrupted run: {resumed}")
    if not (twice and resumed):
        raise AssertionError("robust one rank: a run is not bit-identical")
    if snaps != ["ckpt_00000002.npz", "manifest.json"] or got["step"] != 2:
        raise AssertionError(f"robust one rank: snapshots {snaps}, "
                             f"restored {got}")
    if [e["step"] for e in hr if "step" in e] != [3, 4]:
        raise AssertionError("robust one rank: the resumed run did not "
                             "take steps 3 and 4")
    calls = ROBUST_ONE_CALLS * (4 + 4 + 2 + 2)
    want = {k: (calls if cuda and k in ("router_fused", "group_sort") else 0)
            for k in launches}
    if launches != want:
        raise AssertionError(f"robust one rank: launches {launches}, "
                             f"expected {want}")
    if not reduced:
        names = ("train hop-1", "train hop-2")
        held = {("router_fused", t, E, k) for name, t, E, k, *_ in
                ROUTER_SHAPES if name in names} | {
                ("group_sort", A, K) for name, A, K, _ in SORT_SHAPES
                if name in names}
        if shapes.seen != held:
            raise AssertionError(f"robust one rank: routing shapes "
                                 f"{shapes.seen}, phase 2 holds {held}")
    print(f"  part (b) {time.perf_counter() - t0:.1f} s")


# phase 19, fault containment: tests/distributed/_faults.py's matrix on
# phase 17's ranks at full width, on the kernel path (bf16): qwen3-moe's
# MoE layer (phase 16's weights and slice, 256 tokens a rank as at its
# prefill) and switch-3.7b's (512 tokens a rank as phase 17's); the wire's
# cost on phase 16's dropless serve; a faulted ZeRO-1 + sentinel step
FAULT_LAYERS = {"qwen3-moe-30b-a3b": dict(tokens=256),
                "switch-3.7b": dict(tokens=512, num_layers=2)}
# per layer call on a rank: the dropless hops' gathers (SMILE: two hops and
# the compaction of hop 2's arrivals; Switch: one hop and its compaction)
# and one ragged FFN
FAULT_LAYER_LAUNCHES = {
    "qwen3-moe-30b-a3b": {**ZERO_LAUNCHES, "dispatch_gather": 3,
                          "combine_gather": 3, "grouped_ffn_ragged": 1},
    "switch-3.7b": {**ZERO_LAUNCHES, "dispatch_gather": 2,
                    "combine_gather": 2, "grouped_ffn_ragged": 1}}
WIRE_POLICIES = ("off", "detect", "quarantine")
WIRE_SERVE_TOKENS = 8
# phase 17's smile-3.7b cut to one dense and one MoE layer, dropless
FAULT_TRAIN = dict(MESH_TRAIN, num_layers=2, moe_options={
    **MESH_TRAIN["moe_options"], "dispatch_backend": "dropless"})


def fault_cells(levels) -> dict:
    """name -> MoE options: _faults.py's matrix for a layer whose ragged
    hops are ``levels``."""
    out = {"healthy": {}, "inert": {"fault_plan": "counts@0:7"},
           "counts": {"fault_plan": "counts"},
           "nanrows": {"fault_plan": "nanrows"},
           "skew": {"fault_plan": "skew"}}
    for lvl in levels:
        out[f"dropseg:{lvl}"] = {"fault_plan": f"dropseg:{lvl}"}
    for pol in ("detect", "quarantine"):
        out[f"healthy-{pol}"] = {"wire_integrity": pol}
    for kind in ("nanrows", "bitflip", "inflate", "dupseg"):
        for lvl in levels:
            out[f"quarantine-{kind}:{lvl}"] = {
                "wire_integrity": "quarantine", "fault_plan": f"{kind}:{lvl}"}
    out["quarantine-counts"] = {"wire_integrity": "quarantine",
                                "fault_plan": "counts"}
    out["detect-bitflip:0"] = {"wire_integrity": "detect",
                               "fault_plan": "bitflip:0"}
    for kind in ("inflate", "dupseg"):
        out[f"{kind}:0"] = {"fault_plan": f"{kind}:0"}
    return out


def check_fault_cell(name, r, y0, hops, n_dev):
    """_faults.py's assertions for one cell: ``r`` holds the cell's global
    output ``y`` and statistics (numpy), ``y0`` the healthy plain run's
    output, ``hops`` {level: (P, groups a rank)} of the ragged hops and
    ``n_dev`` the ranks; the expectations come from the port's site
    selectors.  Raises AssertionError."""
    import numpy as np
    from repro_torch.common import faultinject as FI
    y, df, hdf, ev, wf = (r["y"], float(r["drop_frac"]), r["hop_drop_frac"],
                          r["fault_events"], r["wire_faults"])
    finite = bool(np.isfinite(y).all())

    def need(ok, *what):
        if not ok:
            raise AssertionError(f"fault cell {name}: {what}")

    def counts_events():
        fp = FI.parse_fault_plan("counts")
        want = np.zeros_like(ev)
        for lvl, (Pn, nl) in hops.items():
            want[lvl] = n_dev * FI.expected_count_events(fp, lvl, Pn, nl)
        return want

    def one_source(lvl, victim):
        wev = np.zeros_like(ev)
        wev[lvl] = n_dev
        wwf = np.zeros_like(wf)
        wwf[lvl, victim] = n_dev
        need(np.array_equal(ev, wev), "events", ev, wev)
        need(np.array_equal(wf, wwf), "wire faults", np.nonzero(wf), victim)

    def drop_of(lvl):
        Pn = hops[lvl][0]
        need(hdf[lvl] == np.float32(1.0 / Pn), "drop", hdf, Pn)
        need(not np.delete(hdf, lvl).any(), "other hops' drops", hdf)

    if name == "healthy":
        need(df == 0.0 and not ev.any() and not wf.any() and finite,
             df, ev, finite)
    elif name in ("inert", "healthy-detect", "healthy-quarantine"):
        need(np.array_equal(y.view(np.uint8), y0.view(np.uint8)),
             "not bit-equal to the plain path")
        need(df == 0.0 and not ev.any() and not wf.any(), df, ev)
    elif name in ("counts", "quarantine-counts"):
        need(np.array_equal(ev, counts_events()), "events", ev,
             counts_events())
        need(df > 0.0 and finite and not wf.any(), df, finite)
    elif name.startswith("dropseg:"):
        need(not ev.any() and finite, ev, finite)
        drop_of(int(name.split(":")[1]))
    elif name == "nanrows":
        need(bool(np.isnan(y).any()), "no NaN reached the output")
        need(not ev.any() and df == 0.0, ev, df)
    elif name == "skew":
        need(df == 0.0 and not ev.any() and finite, df, ev, finite)
        for lvl in hops:
            need(r["hop_max_load"][lvl] == 1.0
                 and r["hop_load_entropy"][lvl] < 0.05,
                 "watchdog", r["hop_max_load"], r["hop_load_entropy"])
    elif name.startswith("quarantine-"):
        kind, lvl = name[len("quarantine-"):].split(":")
        lvl = int(lvl)
        Pn, nl = hops[lvl]
        one_source(lvl, FI.wire_fault_victim(
            FI.parse_fault_plan(f"{kind}:{lvl}"), lvl, Pn, nl))
        drop_of(lvl)
        need(finite, "non-finite output")
    elif name == "detect-bitflip:0":
        Pn, nl = hops[0]
        one_source(0, FI.wire_fault_victim(FI.parse_fault_plan("bitflip:0"),
                                           0, Pn, nl))
        need(df == 0.0 and not hdf.any() and finite, df, hdf, finite)
        need(not np.array_equal(y, y0), "the flipped payload left no trace")
    elif name in ("inflate:0", "dupseg:0"):
        need(not ev.any() and not wf.any() and finite, ev, finite)
        need(name == "dupseg:0" or df == 0.0, df)
    else:
        raise AssertionError(f"no check for fault cell {name}")


def _first_moe(params):
    """The MoE parameters of the first block that has them."""
    for st in params["stages"]:
        for blocks in st.values():
            for b in blocks:
                if "moe" in b:
                    return b["moe"]
    raise ValueError("no MoE block")


def _fault_layer_rank(rank, arch, reduced, cells, seed):
    """A phase-19 rank: ``arch``'s MoE layer at full width (the first MoE
    block of ``init_model(seed=0)``'s slice, bf16) on random local tokens,
    once for each cell on the kernel path; each cell's launch counts set
    to 0 just before and read just after; the ragged hops' (P, groups a
    rank) recorded."""
    import torch
    from repro_torch.core import pipeline as PL
    from repro_torch.core.moe import moe_layer
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train_config
    from repro_torch.models.transformer import init_model
    from repro_torch.sharding.plan import plan_from_mesh
    st = rank.state
    mesh = st["mesh"]
    plan = plan_from_mesh(mesh)
    kw = FAULT_LAYERS[arch]
    cfg = train_config(arch, reduced=reduced,
                       num_layers=None if reduced else kw.get("num_layers"),
                       moe_grid=None if reduced else (16, 8),
                       moe_options={"dispatch_backend": "dropless"})
    if arch == SERVE["arch"]:
        params = _first_moe(st["params"])        # phase 16's weights
    else:
        params = _first_moe(init_model(cfg, plan, seed=0, device=rank.device,
                                       mesh=mesh))
    gen = torch.Generator(device=rank.device).manual_seed(seed + rank.rank)
    t = 16 if reduced else kw["tokens"]
    x = torch.randn((t, cfg.d_model), generator=gen,
                    device=rank.device).to(torch.bfloat16)
    hops = {}
    orig = PL._ragged_forward

    def record(rows, starts, seg_lens, spec, block, fp=None, level=0):
        hops[level] = (spec.n_ranks, spec.groups_per_rank)
        return orig(rows, starts, seg_lens, spec, block, fp=fp, level=level)

    PL._ragged_forward = record
    out = {}
    try:
        for name, opts in cells.items():
            c = cfg.moe.with_options(**opts)
            ops.reset_launch_counts()
            with torch.inference_mode():
                y, stt = moe_layer(params, x, c, plan, act=cfg.act,
                                   use_kernel=True)
            out[name] = {"y": y.float().cpu().numpy(),
                         "launches": ops.launch_counts(),
                         **{k: getattr(stt, k).cpu().numpy() for k in (
                             "drop_frac", "hop_drop_frac", "fault_events",
                             "hop_max_load", "hop_load_entropy",
                             "wire_faults")}}
    finally:
        PL._ragged_forward = orig
    return {"cells": out, "hops": hops}


def _wire_serve_rank(rank, policy, new_tokens, keep, timed=False):
    """Phase 16's dropless serve on the rank's slice under the wire
    ``policy`` (``timed``: the time inside each collective taken, the card
    synchronized around it); the launch counts set to 0 just before and
    read just after."""
    from repro_torch.configs import with_options
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    st = rank.state
    st["mesh"].wire.reset(timed=timed)
    cfg = with_options(st["cfg"], dispatch_backend="dropless",
                       wire_integrity=policy)
    ops.reset_launch_counts()
    res = generate(st["params"], st["prompts"], cfg, st["plan"],
                   new_tokens=new_tokens, keep_logits=keep, use_kernel=True)
    return {"tokens": res.tokens, "logits": res.logits,
            "prefill_s": res.prefill_s, "decode_s": res.decode_s,
            "steps": res.decode_steps, "wire": res.wire,
            "launches": ops.launch_counts(), "finite": res.logits_finite}


def _fault_train_rank(rank, kw):
    """Phase 19 (c): FAULT_TRAIN under ZeRO-1 and the sentinel on the
    rank: one step with the wire quarantining a bit flip at hop 0, then a
    ``nanrows`` step with the wire off, its parameters' and state's
    digests taken before and after; the MoE statistics of each step's
    first forward kept."""
    import torch
    from repro_torch.common.config import TrainConfig
    from repro_torch.configs import with_options
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train_config
    from repro_torch.models import transformer as T
    from repro_torch.models.transformer import init_model
    from repro_torch.optim import make_optimizer, make_schedule
    from repro_torch.sharding.plan import plan_from_mesh
    from repro_torch.train.sentinel import init_sentinel_state
    from repro_torch.train.step import build_train_step, zero1_state
    from repro_torch.weights import state_leaves
    mesh = rank.state["mesh"]
    dev = mesh.device
    cfg = train_config(kw["arch"], reduced=kw["reduced"],
                       moe_options=kw["moe_options"], moe_grid=kw["moe_grid"],
                       num_layers=kw["num_layers"])
    plan = plan_from_mesh(mesh)
    tcfg = TrainConfig(global_batch_size=kw["batch"], seq_len=kw["seq"],
                       steps=4, optimizer=kw["optimizer"], lr=3e-4,
                       warmup_steps=1, sentinel=True)
    params = init_model(cfg, plan, seed=0, device=dev, compute_cast=False,
                        mesh=mesh)
    state = zero1_state(params, cfg, plan)
    sent = init_sentinel_state(dev)
    pipe = DataPipeline(cfg, kw["batch"], kw["seq"], seed=0)
    b = next(pipe)
    opt = make_optimizer(kw["optimizer"])
    sched = make_schedule("cosine", 3e-4, 1, 4)
    seen = []
    orig = T.forward

    def forward(*a, **k):
        out = orig(*a, **k)
        seen.append(out[2])
        return out

    runs = []
    T.forward = forward
    ops.reset_launch_counts()
    try:
        for i, opts in enumerate(({"wire_integrity": "quarantine",
                                   "fault_plan": "bitflip:0"},
                                  {"fault_plan": "nanrows"})):
            c = with_options(cfg, **opts)
            step = build_train_step(c, tcfg, plan, opt, sched, params, b,
                                    mesh=mesh, zero1=True, sentinel=True)
            tensors = [t for leaf in state_leaves(params, state)
                       for t in leaf.tensors]
            before, clock = tensor_digests(torch, tensors), state.step
            seen.clear()
            params, state, m, sent = step(params, state, b, i + 1, sent)
            after = tensor_digests(torch, tensors)
            st = seen[0]
            runs.append({"skip": float(m["skip"]), "loss": float(m["loss"]),
                         "fault_events": st.fault_events.cpu().numpy(),
                         "wire_faults": st.wire_faults.cpu().numpy(),
                         "metric_events": float(m["fault_events"]),
                         "unchanged": before == after,
                         "clock": (clock, state.step)})
            b = next(pipe)
    finally:
        T.forward = orig
    pipe.close()
    launches = ops.launch_counts()
    del params, state
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"runs": runs, "launches": launches}


def check_fault_train(out, n_dev):
    """Phase 19 (c)'s checks over the ranks' ``_fault_train_rank``
    results: the quarantined bit flip's step continues on every rank with
    a finite loss and its wire faults at (hop 0, one source) only, ``n_dev
    x`` the MoE layers, in the step's metrics too (a remat recompute
    counts nothing more); the ``nanrows`` step is skipped with every
    tensor and the step clock bit-unchanged.  Returns ``(MoE layers,
    flagged source)``."""
    import numpy as np
    q, n = [o["runs"][0] for o in out], [o["runs"][1] for o in out]
    for r, (a, b) in enumerate(zip(q, n)):
        if not (a["skip"] == 0.0 and math.isfinite(a["loss"])):
            raise AssertionError(f"faulted training: rank {r} did not "
                                 f"continue past the quarantined bit flip: "
                                 f"{a}")
        if not (b["skip"] == 1.0 and b["unchanged"]
                and b["clock"][0] == b["clock"][1]):
            raise AssertionError(f"faulted training: rank {r} did not skip "
                                 f"the nanrows step cleanly: {b}")
        if out[r]["launches"] != out[0]["launches"]:
            raise AssertionError("faulted training: the ranks' launches "
                                 "differ")
    wf = q[0]["wire_faults"]
    layers = int(round(float(wf.sum()) / n_dev))
    hop0 = np.nonzero(wf[0])[0].tolist()
    if not (layers >= 1 and len(hop0) == 1 and not wf[1:].any()
            and wf[0, hop0[0]] == n_dev * layers
            and all(a["metric_events"] == n_dev * layers for a in q)):
        raise AssertionError(f"faulted training: wire faults {wf}, events "
                             f"{[a['metric_events'] for a in q]}")
    return layers, hop0[0]


def phase_fault_containment(torch, ops, pool, cuda=True, reduced=False):
    """Phase 19 on phase 17's ranks (``pool``): (a) the fault matrix of
    two MoE layers at full width, (b) the wire's cost on phase 16's
    dropless serve, (c) containment in a ZeRO-1 + sentinel training step.
    (``cuda=False, reduced=True`` on CPU ranks rehearses it.)"""
    import numpy as np
    from repro_torch.common import faultinject as FI
    from repro_torch.sharding import comm
    n_dev = MESH_SHAPE[0] * MESH_SHAPE[1]
    t0 = time.perf_counter()
    if cuda:
        # the parity fold and its length and tag terms wrap int32 on the card
        # as on the CPU: a hop-2 slab's words, bf16 and fp32
        g = torch.Generator().manual_seed(0)
        lens = torch.randint(0, 900, (64,), generator=g, dtype=torch.int32)
        bounds = torch.cat([torch.zeros(1, dtype=torch.int32),
                            torch.cumsum(lens + 7, 0).to(torch.int32)])
        tags = torch.arange(64, dtype=torch.int32) * 3001
        for dt in (torch.bfloat16, torch.float32):
            rows = (torch.randn((int(bounds[-1]), 2048), generator=g)
                    * 1e4).to(dt)
            a = comm.segment_parity_words(rows.cuda(), bounds.cuda(),
                                          lens.cuda(), tags.cuda()).cpu()
            b = comm.segment_parity_words(rows, bounds, lens, tags)
            if not torch.equal(a, b):
                raise AssertionError(f"parity words on the card part from "
                                     f"the CPU's ({dt})")
        print(f"  parity words of 64 segments x 2048 lanes (bf16, fp32; "
              f"tags to 189,063, terms wrapping int32): the card's equal "
              f"the CPU's")
        # a nanrows plan hands the routers NaN rows: the fused router's ids
        # must be lax.top_k's (NaN first, lowest index), never past E
        from repro_torch.kernels import ref
        x = torch.randn((512, 768), generator=g).to(torch.bfloat16)
        x[::37] = float("nan")
        w = torch.randn((768, 16), generator=g) / 28.0
        for k in (1, 2):
            got = ops.router_fused(x.cuda(), w.cuda(), k)[1].cpu()
            want = ref.router_fused_ref(x, w, k)[1]
            if not (torch.equal(got, want) and int(got.max()) < 16):
                raise AssertionError(f"router_fused on NaN rows, k {k}: ids "
                                     f"part from the plain version's")
        print(f"  router_fused on 512 rows, 14 of them NaN, k 1 and 2: ids "
              f"equal the plain version's (NaN first, lowest index)")
    serve_kw = dict(arch=SERVE["arch"], reduced=reduced,
                    num_layers=None if reduced else SERVE["num_layers"],
                    moe_grid=None if reduced else SERVE["moe_grid"],
                    batch=8, prompt_len=128)
    pool.run(_mesh_rank_init, serve_kw, "bfloat16")

    # ---- (a) the matrix -----------------------------------------------------
    for arch in FAULT_LAYERS:
        levels = (0, 1) if arch == SERVE["arch"] else (0,)
        cells = fault_cells(levels)
        t1 = time.perf_counter()
        got = pool.run(_fault_layer_rank, arch, reduced, cells, 1)
        hops = got[0]["hops"]
        if sorted(hops) != list(levels) or any(g["hops"] != hops
                                               for g in got):
            raise AssertionError(f"faults {arch}: ragged hops {hops}")
        res = {}
        for name in cells:
            rs = [g["cells"][name] for g in got]
            for r, x in enumerate(rs):
                for k in ("drop_frac", "hop_drop_frac", "fault_events",
                          "wire_faults"):
                    if not np.array_equal(x[k], rs[0][k]):
                        raise AssertionError(f"faults {arch} {name}: rank "
                                             f"{r}'s {k} is not rank 0's")
                want = (FAULT_LAYER_LAUNCHES[arch] if cuda
                        else dict.fromkeys(x["launches"], 0))
                if x["launches"] != want:
                    raise AssertionError(f"faults {arch} {name}: rank {r} "
                                         f"launches {x['launches']}, "
                                         f"expected {want}")
            res[name] = {**rs[0], "y": np.concatenate([x["y"] for x in rs])}
        y0 = res["healthy"]["y"]
        for name, r in res.items():
            check_fault_cell(name, r, y0, hops, n_dev)
        victims = {f"{k}:{lvl}": FI.wire_fault_victim(
            FI.parse_fault_plan(f"{k}:{lvl}"), lvl, *hops[lvl])
            for k in ("nanrows", "bitflip", "inflate", "dupseg")
            for lvl in levels}
        print(f"  (a) {arch}'s MoE layer, {len(cells)} cells, ragged hops "
              f"(P, groups a rank) {hops}: every cell held "
              f"({time.perf_counter() - t1:.1f} s); counts events "
              f"{res['counts']['fault_events'].tolist()} drop "
              f"{float(res['counts']['drop_frac']):.4f}; quarantined "
              f"sources {victims}; detect bitflip:0 flagged "
              f"{np.argwhere(res['detect-bitflip:0']['wire_faults']).tolist()}"
              f"; launches a call {got[0]['cells']['healthy']['launches']}")

    # ---- (b) the wire's cost on the dropless serve --------------------------
    t1 = time.perf_counter()
    keep = {p: pool.run(_wire_serve_rank, p, WIRE_SERVE_TOKENS, True)
            for p in WIRE_POLICIES}
    for p in WIRE_POLICIES[1:]:
        for r, (a, b) in enumerate(zip(keep["off"], keep[p])):
            same = (np.array_equal(a["tokens"], b["tokens"])
                    and np.array_equal(a["logits"].view(np.uint8),
                                       b["logits"].view(np.uint8)))
            if not (same and b["finite"]):
                raise AssertionError(f"wire serve {p}: rank {r}'s tokens or "
                                     f"logits are not the plain path's")
            if b["launches"] != a["launches"]:
                raise AssertionError(f"wire serve {p}: rank {r} launches "
                                     f"{b['launches']}, off "
                                     f"{a['launches']}")
    # warm, in turns (off, detect, quarantine, then back), each collective
    # timed; a policy's times are the better of its two runs
    timed = {p: [] for p in WIRE_POLICIES}
    for p in WIRE_POLICIES + WIRE_POLICIES[::-1]:
        timed[p].append(pool.run(_wire_serve_rank, p, WIRE_SERVE_TOKENS,
                                 False, True))
    print(f"  (b) phase 16's dropless serve, {WIRE_SERVE_TOKENS} new tokens: "
          f"tokens and logits under detect and quarantine bit-equal to off "
          f"on every rank ({time.perf_counter() - t1:.1f} s)")
    for p in WIRE_POLICIES:
        pre = [max(x["prefill_s"] for x in w) * 1e3 for w in timed[p]]
        dec = [max(x["decode_s"] / max(x["steps"], 1) for x in w) * 1e3
               for w in timed[p]]
        print(f"  {p}, warm, the collectives timed, slowest rank (two runs "
              f"in turns): prefill {pre[0]:.2f}, {pre[1]:.2f} ms, decode "
              f"{dec[0]:.2f}, {dec[1]:.2f} ms a step")
        x = min(timed[p], key=lambda w: max(y["decode_s"] for y in w))[0]
        for phase in ("prefill", "decode"):
            n = 1 if phase == "prefill" else max(x["steps"], 1)
            inside = wire_lines(x["wire"][phase], n, f"{p} {phase}")
            total = (x["prefill_s"] if phase == "prefill"
                     else x["decode_s"] / n)
            print(f"    {p} {phase}, rank 0 (the faster run): inside comm "
                  f"{inside / n * 1e3:.2f} of {total * 1e3:.2f} ms")

    # ---- (c) containment in training ----------------------------------------
    t1 = time.perf_counter()
    kw = dict(FAULT_TRAIN, reduced=reduced)
    if reduced:
        kw.update(num_layers=None, moe_grid=None)
    out = pool.run(_fault_train_rank, kw)
    layers, victim = check_fault_train(out, n_dev)
    q, n = [o["runs"][0] for o in out], [o["runs"][1] for o in out]
    wf = q[0]["wire_faults"]
    print(f"  (c) {kw['arch']} ({kw['num_layers']} layers, dropless) under "
          f"ZeRO-1 and the sentinel: quarantined bitflip:0 step loss "
          f"{q[0]['loss']:.5f}, skip {[a['skip'] for a in q]}, wire faults "
          f"at (hop 0, source {victim}) {wf[0, victim]:g} = {n_dev} ranks x "
          f"{layers} MoE layer(s); nanrows step loss {n[0]['loss']}, skip "
          f"{[b['skip'] for b in n]}, every tensor and the step clock "
          f"bit-unchanged {[b['unchanged'] for b in n]}; launches a rank "
          f"{out[0]['launches']} ({time.perf_counter() - t1:.1f} s)")
    print(f"  phase 19 {time.perf_counter() - t0:.1f} s")


# phase 20: the rest of serving over phase 16's mesh (4 gloo ranks sharing
# the card): (a) the continuous-batching engine, (b) the sequence-sharded
# ring KV cache, (c) rwkv6 over tensor parallelism
# phase 13's trace cut to its first 8 requests: each tick crosses the host
# through gloo (~0.4 s at full width), two runs a config
MESH_ENGINE_REQUESTS = 8
# (name, arch, backend, capacity factor): sort runs at NO_DROP_CF, where no
# token can drop (at the config's 2.0 the two sides drop other tokens)
MESH_ENGINE_RUNS = [("qwen3 dropless", "qwen3", "dropless", 2.0),
                    ("qwen3 sort cf 4", "qwen3", "sort", NO_DROP_CF),
                    ("qwen1.5", "qwen1.5", None, None)]
# the kernels whose first call at each shape a mesh rank keeps, to hold it
# against its plain version after the run
MESH_HELD_KERNELS = ("dispatch_gather", "combine_gather", "grouped_ffn",
                     "grouped_ffn_ragged", "rwkv6_scan")
RWKV_MESH_SERVE = dict(batch=8, prompt_len=128, new_tokens=8)
# (b)'s serve: phase 16's (ServeConfig's batch, prompt and new tokens: a
# ring cache of 160 slots, 80 a model rank when sequence-sharded)
SEQ_SERVE = dict(batch=8, prompt_len=128, new_tokens=32)
RWKV_MESH_FORWARD = (4, 2048)
# rwkv6 over tp against one rank.  fp32 is held to phase 4's LOGITS_ATOL:
# the ranks' GEMMs sum in other orders, and each layer's group norm (eps
# 1e-3) amplifies last-ulp differences up to ~32x; over 24 layers on an
# H100 the serve read 1.21e-3 (2.5e-4 of the largest logit), where the
# reduced config on the CPU reads 1e-6.  bf16 is run and printed, not held:
# each rank rounds its partial product of the time mix's output projection
# to bf16 before the psum, as the reference does, and one rank rounds the
# whole product once; at 24 layers that one rounding moves the logits by
# more than their spread (the reduced config at 24 layers on the CPU: 0.64
# at prefill of a largest logit 1.25, and one rank rounding two halves'
# products so gives the mesh's logits exactly)
# the kept positions of the cache-less forward's logits: every 128th and
# the last
RWKV_KEPT_EVERY = 128


def p20_cfg(arch: str, reduced: bool):
    from repro_torch.launch.serve import serve_config
    if arch == "qwen3":
        return serve_config(SERVE["arch"], reduced=reduced,
                            num_layers=None if reduced else SERVE["num_layers"],
                            moe_grid=None if reduced else SERVE["moe_grid"])
    return serve_config({"qwen1.5": "qwen1.5-0.5b",
                         "rwkv6": "rwkv6-1.6b"}[arch], reduced=reduced)


def p20_run_cfg(cfg, backend, cf, dtype):
    return (cfg.replace(dtype=dtype) if backend is None
            else mesh_cfg(cfg, backend, cf, dtype))


@contextlib.contextmanager
def capture_kernel_inputs(ops, tag, names=MESH_HELD_KERNELS,
                          by_ref_bytes=None):
    """While open, the first call of each wrapper in ``names`` at each
    input shape keeps a clone of its inputs, under ``(name, tag(),
    shapes)`` in the yielded dict (the wrappers still launch and count as
    they do).  A tensor of more than ``by_ref_bytes`` is kept by
    reference, not cloned: the expert weights, which serving never
    writes."""
    import torch
    got, orig = {}, {n: getattr(ops, n) for n in names}

    def keep(x):
        if not torch.is_tensor(x):
            return x
        big = (by_ref_bytes is not None
               and x.numel() * x.element_size() > by_ref_bytes)
        return x if big else x.clone()

    def wrap(name, fn):
        def call(*a, **kw):
            shapes = tuple(tuple(x.shape) for x in a if torch.is_tensor(x))
            key = (name, tag(), shapes)
            if key not in got:
                got[key] = ([keep(x) for x in a], dict(kw))
            # the wrapper counts its launch on its module-level name
            setattr(ops, name, fn)
            try:
                return fn(*a, **kw)
            finally:
                setattr(ops, name, call)
        return call

    for n, fn in orig.items():
        setattr(ops, n, wrap(n, fn))
    try:
        yield got
    finally:
        for n, fn in orig.items():
            setattr(ops, n, fn)


def hold_kernel(torch, ops, ref, name, args, kw, label, flush, plain=None):
    """The kernel ``name`` on inputs a path gave it, against its plain
    version on the same inputs (phase 2's tolerances), timed (the gathers
    cold), with its bound and library time: ``(row, line)``
    (:func:`make_row`).  ``plain`` replaces the plain version (the same
    function computed in pieces)."""
    fn = getattr(ops, name)
    plain = plain or getattr(ref, f"{name}_ref")
    pkw = {k: v for k, v in kw.items() if k != "block"}
    got, want = fn(*args, **kw), plain(*args, **pkw)
    torch.cuda.synchronize()
    library = cold = None
    if name == "dispatch_gather":
        x, src = args
        if not torch.equal(got, want):
            raise AssertionError(f"{name} {label}: not bit-exact")
        used = torch.unique(src[src >= 0]).numel()
        d, R = x.shape[1], src.shape[0]
        b = bound(used * d * 2 + R * 4 + R * d * 2, 0, FP32_FLOPS)
        cold = flush
    elif name == "combine_gather":
        rows, src, scale = args
        wf = want.float()
        ulp = torch.where(wf == 0, torch.full_like(wf, 1e-30),
                          wf.abs() * 2.0 ** -7)
        if not bool(((got.float() - wf).abs() <= ulp).all()):
            raise AssertionError(f"{name} {label}: more than 1 bf16 ulp")
        used = torch.unique(src[src >= 0]).numel()
        valid = int((src >= 0).sum())
        t, k = src.shape
        d = rows.shape[1]
        b = bound(used * d * 2 + t * k * 8 + t * d * 2, 2.0 * valid * d,
                  FP32_FLOPS)
        cold = flush
    elif name in ("grouped_ffn", "grouped_ffn_ragged"):
        diff = (got.float() - want.float()).abs()
        if not bool((diff <= FFN_ATOL + FFN_RTOL * want.float().abs()).all()):
            raise AssertionError(f"{name} {label}: outside rtol {FFN_RTOL} "
                                 f"/ atol {FFN_ATOL}")
        if name == "grouped_ffn":
            x, w1, w3, w2 = args
            G, T, d = x.shape
            f = w1.shape[-1]
            b = bound((2 * G * T * d + 3 * G * d * f) * 2, 6.0 * G * T * d * f,
                      BF16_TC_FLOPS)

            def bmm():
                return torch.bmm(ref.activation(torch.bmm(x, w1), kw["act"])
                                 * torch.bmm(x, w3), w2)
            library = time_ms(bmm)
        else:
            rows, starts, w1, w3, w2 = args
            n_real = int((rows != 0).any(1).sum())
            d, f = w1.shape[1], w1.shape[2]
            seg = starts[1:] - starts[:-1]
            experts = int((seg > 0).sum())
            b = bound((experts * 3 * d * f + 2 * n_real * d) * 2,
                      6.0 * d * f * n_real, BF16_TC_FLOPS)
    else:                                   # rwkv6_scan
        (y, s), (wy, ws) = got, want
        tol = RWKV_RTOL * wy.abs() + RWKV_ATOL_REL * wy.abs().max()
        if not bool(((y - wy).abs() <= tol).all()) or not torch.equal(s, ws):
            raise AssertionError(f"{name} {label}: y outside its tolerance "
                                 f"or s_last not bit-exact")
        B, T, nh, hd = y.shape
        b = bound(4.0 * (5 * B * T * nh * hd + nh * hd + 2 * B * nh * hd * hd),
                  B * nh * T * (5.0 * hd * hd + 5.0 * hd), FP32_FLOPS)
        got, want = (torch.cat([y.flatten(), s.flatten()]),
                     torch.cat([wy.flatten(), ws.flatten()]))
    ms = time_ms(lambda: fn(*args, **kw), flush=cold)
    plain_ms = time_ms(lambda: plain(*args, **pkw), flush=cold,
                       iters=2 if name == "rwkv6_scan" else 20,
                       warmup=1 if name == "rwkv6_scan" else 3)
    return make_row(name, label, got, want, ms, plain_ms, b, library)


def hold_captured(torch, ops, ref, captured, keep, plains=None):
    """:func:`hold_kernel` on each captured call whose tag is in ``keep``
    (a tag -> label prefix dict); ``plains`` (name -> function) replaces
    a kernel's plain version."""
    flush = L2Flush(torch)
    out = []
    for (name, tag, shapes), (args, kw) in sorted(
            captured.items(), key=lambda kv: (kv[0][0], str(kv[0][1]),
                                              kv[0][2])):
        if tag in keep:
            label = f"{keep[tag]} " + " ".join(
                "x".join(map(str, s)) for s in shapes[:2])
            out.append(hold_kernel(torch, ops, ref, name, args, kw, label,
                                   flush, (plains or {}).get(name)))
    return out


def _p20_state(rank):
    """The rank's mesh (phase 16's layout) and plan, made once."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding.plan import plan_from_mesh
    st = rank.state
    if "mesh" not in st:
        st["mesh"] = make_mesh(MESH_SHAPE, ("data", "model"),
                               device=rank.device)
        st["plan"] = plan_from_mesh(st["mesh"])
    return st


def _p20_draw(rank, arch, reduced):
    """The rank's slice of ``arch``'s weights (seed 0, as one device draws
    them): the fp32 masters and the served bf16 form, replacing any
    earlier ones."""
    import torch
    from repro_torch.models.transformer import cast_for_compute, init_model
    st = _p20_state(rank)
    st.pop("p20", None)
    gc.collect()
    if rank.device.type == "cuda":
        torch.cuda.empty_cache()
    cfg = p20_cfg(arch, reduced)
    t0 = time.perf_counter()
    masters = init_model(cfg, st["plan"], seed=0, device=rank.device,
                         compute_cast=False, mesh=st["mesh"])
    if rank.device.type == "cuda":
        torch.cuda.synchronize()
    st["p20"] = {"cfg": cfg, "float32": masters,
                 "bfloat16": cast_for_compute(masters, cfg)}
    return {"init_s": time.perf_counter() - t0, "param_bytes": sum(
        t.numel() * t.element_size() for t in _leaves(masters))}


def request_stats(eng, wall_s) -> dict:
    """Tokens/s, tick ms, TTFT and TPOT (mean, p50, p90) of an engine's
    finished requests, run in ``wall_s``."""
    import numpy as np
    reqs = list(eng.requests.values())
    ttft = [r.t_first - r.t_submit for r in reqs]
    gaps = np.concatenate([np.diff(r.t_tokens) for r in reqs])
    n_tok = sum(len(r.generated) for r in reqs)
    return {"wall_s": wall_s, "ticks": eng.ticks, "tokens": n_tok,
            "ttft": (np.mean(ttft), _pct(ttft, 50), _pct(ttft, 90)),
            "tpot": (gaps.mean(), _pct(gaps, 50), _pct(gaps, 90))}


def _p20_engine(rank, sc, backend, cf, dtype, reqs, keep, capture):
    """One engine run on the rank's slice: ``dtype`` bf16 runs the kernel
    path, fp32 the plain one.  The launch counts are set to 0 just before
    and read just after; the wire is timed on a ``keep`` run.  ``keep``
    (data rank 0 only) keeps every token's logits (its vocabulary slice)
    and, on an fp32 run, each MoE call's outputs; ``capture`` keeps each
    kernel's first call at each shape on rank 0 and holds them after the
    run (the decode step's and the largest prefill bucket's)."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.serve.engine import Engine
    st = _p20_state(rank)
    p, mesh = st["p20"], st["mesh"]
    cfg = p20_run_cfg(p["cfg"], backend, cf, dtype)
    mine = keep and mesh.index("data") == 0
    eng = Engine(p[dtype], cfg, st["plan"], serve=sc, mesh=mesh,
                 use_kernel=dtype == "bfloat16")
    key = [None]
    step_of = eng._step

    def step(k):
        key[0] = k
        return step_of(k)

    eng._step = step
    mesh.wire.reset(timed=keep)
    cap = capture and rank.rank == 0 and rank.device.type == "cuda"
    with contextlib.ExitStack() as stack:
        kept = stack.enter_context(keep_logits(eng)) if mine else {}
        moe = (stack.enter_context(record_engine_moe(eng))
               if mine and dtype == "float32" else [])
        caught = (stack.enter_context(capture_kernel_inputs(
            ops, lambda: key[0])) if cap else {})
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        for prompt, nt in reqs:
            eng.submit(prompt, nt)
        eng.run()
        if rank.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
    out = {"tokens": dict(eng.finished), "launches": launches,
           "forwards": sum(s.calls for s in eng.steps.values()),
           "counts": eng.compile_counts(), "metrics": eng.metrics(),
           "wire": mesh.wire.summary(), "stats": request_stats(eng, wall),
           "logits": {u: v[:1] if dtype == "bfloat16" else v
                      for u, v in _np_logits(kept).items()}, "moe": moe,
           "dp_index": mesh.index("data"), "tp_index": mesh.index("model"),
           "rows": []}
    if cap:
        buckets = [k for k in eng.steps if k != "decode"]
        out["rows"] = hold_captured(torch, ops, ref, caught, {
            "decode": "mesh engine decode",
            max(buckets): f"mesh engine prefill {max(buckets)}"})
    return out


def _p20_seq(rank, seq, dtype, new_tokens, keep):
    """Phase 16's dropless serve on the rank's qwen3 slice, with or
    without ``kv_seq_shard`` (its KV projections all-gathered over
    ``model`` once: the sequence-sharded cache keeps every KV head), bf16
    on the kernel path, fp32 on the plain one; the launch counts set to 0
    just before and read just after."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate, serve_prompts
    from repro_torch.models import transformer as T
    from repro_torch.sharding import specs as S
    st = _p20_state(rank)
    p, mesh, plan = st["p20"], st["mesh"], st["plan"]
    base = mesh_cfg(p["cfg"], "dropless", 2.0, dtype)
    params = p[dtype]
    if seq:
        if ("seq", dtype) not in p:
            rule = S.param_spec_rules(base, plan)

            def gather(block):
                attn = dict(block["attn"])
                for n in ("wk", "wv", "bk", "bv"):
                    if n in attn:
                        attn[n] = S.gather_leaf(attn[n], rule(
                            ("attn", n), attn[n].ndim), mesh)
                return {**block, "attn": attn}
            p["seq", dtype] = {**params, "stages": tuple(
                {k: [gather(b) for b in blocks] for k, blocks in st_.items()}
                for st_ in params["stages"])}
        params = p["seq", dtype]
    cfg = base.replace(kv_seq_shard=seq)
    sc_batch, sc_len = SEQ_SERVE["batch"], SEQ_SERVE["prompt_len"]
    prompts = serve_prompts(cfg, sc_batch, sc_len, 0, rank.device, mesh, plan)
    moe, undo = record_moe_outputs(T) if keep else ([], lambda: None)
    ops.reset_launch_counts()
    try:
        res = generate(params, prompts, cfg, plan, new_tokens=new_tokens,
                       keep_logits=keep, use_kernel=dtype == "bfloat16")
    finally:
        undo()
    return {"tokens": res.tokens, "logits": res.logits, "moe": moe,
            "launches": ops.launch_counts(), "steps": res.decode_steps,
            "prefill_s": res.prefill_s, "decode_s": res.decode_s,
            "finite": res.logits_finite, "dp_index": mesh.index("data"),
            "tp_index": mesh.index("model")}


def rwkv_forward_tokens(cfg, shape):
    import numpy as np
    return np.random.default_rng(7).integers(
        0, cfg.vocab_size, shape).astype(np.int64)


def rwkv_kept_positions(T):
    return sorted(set(range(0, T, RWKV_KEPT_EVERY)) | {T - 1})


def _p20_rwkv(rank, serve_kw, fwd_shape, dtype):
    """rwkv6 on the rank's slice (its heads of every time mix) in
    ``dtype``: the fixed-batch serve (logits kept), then the cache-less
    kernel forward with its launch counts set to 0 just before and read
    just after (the logits at :func:`rwkv_kept_positions`); on an fp32
    run rank 0 holds the WKV6 kernel at its first call's inputs."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.serve import generate, serve_prompts
    from repro_torch.models.transformer import forward
    from repro_torch.sharding import specs as S
    st = _p20_state(rank)
    p, mesh, plan = st["p20"], st["mesh"], st["plan"]
    cfg, params = p["cfg"].replace(dtype=dtype), p[dtype]
    prompts = serve_prompts(cfg, serve_kw["batch"], serve_kw["prompt_len"],
                            0, rank.device, mesh, plan)
    res = generate(params, prompts, cfg, plan,
                   new_tokens=serve_kw["new_tokens"], keep_logits=True)
    toks = torch.as_tensor(rwkv_forward_tokens(cfg, fwd_shape))
    toks = S.shard_params(toks, S.batch_specs(toks, plan), mesh).to(
        rank.device)
    cap = (rank.rank == 0 and rank.device.type == "cuda"
           and dtype == "float32")
    with contextlib.ExitStack() as stack:
        caught = (stack.enter_context(capture_kernel_inputs(
            ops, lambda: "forward")) if cap else {})
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            _, logits, _, _ = forward(
                params, toks, cfg, plan, use_kernel=True,
                positions=torch.arange(toks.shape[1], device=rank.device))
        if rank.device.type == "cuda":
            torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        launches = ops.launch_counts()
    pos = rwkv_kept_positions(toks.shape[1])
    out = {"tokens": res.tokens, "logits": res.logits,
           "serve_s": (res.prefill_s, res.decode_s / res.decode_steps),
           "fwd_logits": logits[:, pos].float().cpu().numpy()[None],
           "fwd_s": fwd_s, "launches": launches,
           "finite": res.logits_finite and bool(torch.isfinite(logits).all()),
           "dp_index": mesh.index("data"), "tp_index": mesh.index("model"),
           "rows": []}
    if cap:
        out["rows"] = hold_captured(torch, ops, ref, caught,
                                    {"forward": "mesh rank"})
    return out


def p20_one_rank(torch, dev, reduced, sc, n_req):
    """Phase 20's one-rank runs, in this process before the ranks start:
    for each engine config the bf16 kernel-path engine (graphs; each
    request's first-token logits kept) and the fp32 plain-path engine
    (eager, so that each MoE call runs and is recorded every tick; every
    token's logits kept); rwkv6's fixed-batch serve and cache-less kernel
    forward."""
    from repro_torch.launch.serve import generate, serve_prompts
    from repro_torch.models.transformer import (cast_for_compute, forward,
                                                init_model)
    from repro_torch.serve.engine import Engine
    from repro_torch.sharding.plan import single_device_plan
    plan = single_device_plan()
    one, reqs = {}, {}
    for arch in ("qwen3", "qwen1.5"):
        cfg = p20_cfg(arch, reduced)
        reqs[arch] = engine_requests(cfg, n_req, sc.prompt_len,
                                     sc.max_new_tokens)
        masters = init_model(cfg, plan, seed=0, device=dev,
                             compute_cast=False)
        weights = {"float32": masters,
                   "bfloat16": cast_for_compute(masters, cfg)}
        for name, a, backend, cf in MESH_ENGINE_RUNS:
            if a != arch:
                continue
            for dtype in ("bfloat16", "float32"):
                eng = Engine(weights[dtype], p20_run_cfg(cfg, backend, cf,
                                                         dtype), plan,
                             serve=sc, use_kernel=dtype == "bfloat16")
                if dtype == "float32":
                    eng._graphed, eng._pool = False, None
                with contextlib.ExitStack() as stack:
                    kept = stack.enter_context(keep_logits(eng))
                    moe = (stack.enter_context(record_engine_moe(eng))
                           if dtype == "float32" else [])
                    for p, nt in reqs[arch]:
                        eng.submit(p, nt)
                    eng.run()
                lg = _np_logits(kept)
                if dtype == "bfloat16":
                    lg = {u: v[:1] for u, v in lg.items()}
                one[name, dtype] = {"tokens": dict(eng.finished),
                                    "logits": lg, "moe": moe,
                                    "metrics": eng.metrics()}
                del eng
        del masters, weights
        gc.collect()
        torch.cuda.empty_cache()
    cfg = p20_cfg("rwkv6", reduced)
    masters = init_model(cfg, plan, seed=0, device=dev, compute_cast=False)
    weights = {"float32": masters, "bfloat16": cast_for_compute(masters, cfg)}
    kw = RWKV_MESH_SERVE
    shape = (4, 64) if reduced else RWKV_MESH_FORWARD
    for dtype, params in weights.items():
        c = cfg.replace(dtype=dtype)
        res = generate(params, serve_prompts(c, kw["batch"],
                                             kw["prompt_len"], 0, dev), c,
                       plan, new_tokens=kw["new_tokens"], keep_logits=True)
        toks = torch.as_tensor(rwkv_forward_tokens(c, shape), device=dev)
        with torch.no_grad():
            t0 = time.perf_counter()
            _, lg, _, _ = forward(params, toks, c, plan, use_kernel=True,
                                  positions=torch.arange(shape[1],
                                                         device=dev))
            if dev.type == "cuda":
                torch.cuda.synchronize()
            fwd_s = time.perf_counter() - t0
        one["rwkv6", dtype] = {"res": res, "fwd_s": fwd_s, "fwd_logits": lg[
            :, rwkv_kept_positions(shape[1])].float().cpu().numpy()}
        del lg
    del masters, weights
    gc.collect()
    torch.cuda.empty_cache()
    return one, reqs


def print_wire_ops(wire: dict, n: int, what: str) -> float:
    """The wire log of a run by op (calls, MiB sent, ms inside ``comm``),
    each a tick over ``n`` ticks; returns the seconds inside ``comm``."""
    for key, e in sorted(wire.items(), key=lambda kv: -kv[1]["s"]):
        print(f"    {what} {key}: {e['calls'] / n:g} calls, "
              f"{e['bytes'] / n / 2**20:.3f} MiB, {e['s'] / n * 1e3:.3f} ms "
              f"a tick")
    return sum(e["s"] for e in wire.values())


def check_mesh_engine(name, checked, fp32, one_bf, one_fp, per_forward,
                      sc):
    """Phase 20 (a)'s checks and readings of one config's two mesh runs
    (bf16 on the kernel path, the wire timed; fp32 on the plain path)
    against the one-rank runs."""
    import numpy as np
    for runs in (checked, fp32):
        if any(o["tokens"] != runs[0]["tokens"] for o in runs):
            raise AssertionError(f"mesh engine {name}: the ranks' tokens "
                                 f"differ")
    r0 = checked[0]
    counts = r0["counts"]
    if "captures" in counts and (counts["captures"]["decode"] or any(
            counts["captures"]["prefill"].values())):
        raise AssertionError(f"mesh engine {name}: captures {counts}")
    for r, out in enumerate(checked):
        want = {k: v * out["forwards"] for k, v in (per_forward or {}).items()}
        if per_forward is not None and out["launches"] != want:
            raise AssertionError(f"mesh engine {name}: rank {r} launches "
                                 f"{out['launches']}, expected {want}")
    drops = [o["metrics"]["moe_drop_frac_mean"] for o in checked + fp32]
    if max(drops) or one_bf["metrics"]["moe_drop_frac_mean"]:
        raise AssertionError(f"mesh engine {name}: a token dropped: {drops}")
    print(f"  {name}: {r0['forwards']} forwards a rank (eager), compile "
          f"counts {counts}; launches a rank "
          f"{ {k: v for k, v in r0['launches'].items() if v} }; every "
          f"rank's tokens equal in both runs; moe fault events "
          f"{r0['metrics']['moe_fault_events']:g}")
    # bf16, the kernel path: each request's first-token logits (its
    # prefill) as phase 16 holds its bf16 prefill
    first = {u: np.concatenate([o["logits"][u][0] for o in sorted(
        (o for o in checked if o["dp_index"] == 0),
        key=lambda o: o["tp_index"])]) for u in r0["tokens"]}
    top = max(float(np.abs(v[0]).max()) for v in one_bf["logits"].values())
    gap = max(float(np.abs(first[u] - one_bf["logits"][u][0]).max())
              for u in first)
    same = sum(r0["tokens"][u] == one_bf["tokens"][u] for u in first)
    agree = np.mean([a == b for u in first for a, b in zip(
        r0["tokens"][u], one_bf["tokens"][u])])
    print(f"  {name}, bf16 against one rank: {same} of {len(first)} "
          f"requests' tokens equal ({agree:.3f} of the tokens); first-token "
          f"logits {gap:.3e} apart, {gap / top:.4f} of the largest (bound "
          f"{BF16_PREFILL_REL})")
    if not gap <= BF16_PREFILL_REL * top:
        raise AssertionError(f"mesh engine {name}: first-token logits "
                             f"{gap / top} of the largest apart")
    # fp32, the plain path: each request up to where its route parts
    pieces = sorted((o for o in fp32 if o["dp_index"] == 0),
                    key=lambda o: o["tp_index"])
    lg = {u: [np.concatenate([o["logits"][u][i] for o in pieces])
              for i in range(len(pieces[0]["logits"][u]))]
          for u in pieces[0]["logits"]}
    upto, parted, total = (engine_route_parts(one_fp["moe"],
                                              [o["moe"] for o in pieces])
                           if one_fp["moe"] else (None, 0, 0))
    n_same, worst = check_request_tokens(
        one_fp["tokens"], one_fp["logits"], fp32[0]["tokens"], lg,
        LOGITS_ATOL, f"mesh engine {name} fp32", upto=upto)
    kept = (len(lg) if upto is None else
            sum(upto[u] >= len(one_fp["tokens"][u]) for u in lg))
    print(f"  {name}, fp32 (plain path) against one rank: {parted} of "
          f"{total} token-layers took other experts (bound "
          f"{ROUTE_PARTED_SHARE}); {kept} of {len(lg)} requests keep their "
          f"route to the end; {n_same} requests' tokens equal up to where "
          f"their route parts; largest logits difference {worst:.3e} "
          f"(tolerance {LOGITS_ATOL})")
    if parted > ROUTE_PARTED_SHARE * total or 2 * kept < len(lg):
        raise AssertionError(f"mesh engine {name} fp32: routes part too "
                             f"often ({parted} of {total}; {kept} kept)")
    # the slowest rank's bf16 run, and rank 0's wire in it
    s = max((o["stats"] for o in checked), key=lambda x: x["wall_s"])
    ttft, tpot = s["ttft"], s["tpot"]
    print(f"  {name}, bf16 (the card synchronized around each collective), "
          f"slowest rank: {s['ticks']} ticks in "
          f"{s['wall_s'] * 1e3:.1f} ms ({s['wall_s'] / s['ticks'] * 1e3:.2f}"
          f" ms a tick; {s['tokens'] / s['wall_s']:.1f} tokens/s); TTFT mean "
          f"{ttft[0] * 1e3:.2f} ms, p50 {ttft[1] * 1e3:.2f}, p90 "
          f"{ttft[2] * 1e3:.2f}; TPOT mean {tpot[0] * 1e3:.2f} ms, p50 "
          f"{tpot[1] * 1e3:.2f}, p90 {tpot[2] * 1e3:.2f}")
    c = r0["stats"]
    inside = print_wire_ops(r0["wire"], c["ticks"], f"{name} rank 0")
    print(f"  {name}, rank 0: {c['wall_s'] / c['ticks'] * 1e3:.2f} ms a "
          f"tick, {inside / c['ticks'] * 1e3:.2f} of it inside comm")


def check_seq_shard(runs, per_forward, sc):
    """Phase 20 (b): phase 16's dropless serve with the sequence-sharded
    ring cache against the same serve without it, on the same ranks and
    weights, each row held up to where its route parts (phase 16's
    ``check_tokens_and_logits``: tokens equal or a near tie, logits within
    LOGITS_ATOL): fp32 on the plain path, where few routes may part and
    at least half the rows must keep theirs to the end, as phase 16's fp32
    check; bf16 on the kernel path, where the sharded cache's KV
    projection and merged partials round K/V and the attention output to
    bf16 elsewhere than the head-sharded cache does, and a near-tied
    router's token takes other experts at prefill in some rows (its
    prefill logits then lie far apart: printed, not held)."""
    import numpy as np
    from repro_torch.launch.serve import gather_logits, gather_rows
    B, S = SEQ_SERVE["batch"], SEQ_SERVE["prompt_len"]
    for (dtype, seq), got in runs.items():
        if not all(o["finite"] for o in got):
            raise AssertionError(f"seq-shard {dtype} {seq}: non-finite")
        want = {k: v * (got[0]["steps"] + 1)
                for k, v in (per_forward or {}).items()}
        if (dtype == "bfloat16" and per_forward is not None
                and any(o["launches"] != want for o in got)):
            raise AssertionError(f"seq-shard {seq}: launches "
                                 f"{[o['launches'] for o in got]}, "
                                 f"expected {want}")
    base, seq = runs["float32", False], runs["float32", True]
    layers = len(base[0]["moe"]) // (base[0]["steps"] + 1)
    route, parted, total = routing_parts(global_moe(base, B, S, layers), seq,
                                         B, S, layers)
    kept = sum(r == base[0]["steps"] + 1 for r in route)
    n_same, worst = check_tokens_and_logits(
        gather_rows(base), gather_logits(base), gather_rows(seq),
        gather_logits(seq), LOGITS_ATOL, "seq-shard fp32", upto=route)
    equal = int((gather_rows(base) == gather_rows(seq)).all(1).sum())
    print(f"  (b) fp32 (plain path), sequence-sharded against not: {equal} "
          f"of {B} rows' tokens equal; each row's route parts at step "
          f"{route} ({parted} of {total} token-layers; bound "
          f"{ROUTE_PARTED_SHARE}); up to there {n_same} rows equal, logits "
          f"{worst:.3e} apart (tolerance {LOGITS_ATOL})")
    if parted > ROUTE_PARTED_SHARE * total or 2 * kept < B:
        raise AssertionError(f"seq-shard fp32: routes part too often")
    b16, s16 = runs["bfloat16", False], runs["bfloat16", True]
    route, parted, total = routing_parts(global_moe(b16, B, S, layers), s16,
                                         B, S, layers)
    n_same, worst = check_tokens_and_logits(
        gather_rows(b16), gather_logits(b16), gather_rows(s16),
        gather_logits(s16), LOGITS_ATOL, "seq-shard bf16", upto=route)
    lb, ls = gather_logits(b16), gather_logits(s16)
    rel = float(np.abs(ls[0] - lb[0]).max() / np.abs(lb[0]).max())
    agree = float((gather_rows(b16) == gather_rows(s16)).mean())
    print(f"  (b) bf16 (kernel path): tokens equal {agree:.3f}; each row's "
          f"route parts at step {route} ({parted} of {total} token-layers); "
          f"up to there {n_same} rows equal, logits {worst:.3e} apart "
          f"(tolerance {LOGITS_ATOL}); prefill logits {rel:.4f} of the "
          f"largest apart; launches a rank "
          f"{ {k: v for k, v in s16[0]['launches'].items() if v} }")
    for (dtype, sq), got in runs.items():
        pf = max(o["prefill_s"] for o in got) * 1e3
        dc = max(o["decode_s"] / o["steps"] for o in got) * 1e3
        print(f"    {dtype} {'sequence-sharded' if sq else 'head-sharded'}"
              f" cache, slowest rank: prefill {pf:.2f} ms, decode {dc:.2f} "
              f"ms a step")


def check_rwkv_mesh(out, one, cuda, layers, dtype):
    """Phase 20 (c): rwkv6 over (2, 2) against one rank in ``dtype``:
    finite logits and the WKV6 kernel launched once a layer on every rank
    in the cache-less forward, nothing else; in fp32 the serve's tokens
    equal or a near tie where a row first parts, its logits and the
    forward's kept logits within LOGITS_ATOL; in bf16 the same readings
    printed, not held (see above)."""
    import numpy as np
    from repro_torch.launch.serve import gather_logits, gather_rows
    res = one["res"]
    if not all(o["finite"] for o in out):
        raise AssertionError("rwkv6 mesh: non-finite logits")
    want = {k: 0 for k in out[0]["launches"]}
    if cuda:
        want["rwkv6_scan"] = layers
        if any(o["launches"] != want for o in out):
            raise AssertionError(f"rwkv6 mesh: launches "
                                 f"{[o['launches'] for o in out]}")
    fw = gather_logits([{**o, "logits": o["fwd_logits"]} for o in out])[0]
    fw_err = float(np.abs(fw - one["fwd_logits"]).max())
    held = dtype == "float32"
    if held:
        n_same, worst = check_tokens_and_logits(
            res.tokens, res.logits, gather_rows(out), gather_logits(out),
            LOGITS_ATOL, f"rwkv6 mesh serve {dtype}")
    else:
        n_same = int((gather_rows(out) == res.tokens).all(1).sum())
        worst = float(np.abs(gather_logits(out)[0] - res.logits[0]).max())
    pf = max(o["serve_s"][0] for o in out) * 1e3
    dc = max(o["serve_s"][1] for o in out) * 1e3
    fs = max(o["fwd_s"] for o in out)
    what = (f"tolerance {LOGITS_ATOL}" if held else
            f"not held; largest |logit| {np.abs(res.logits).max():.3f}")
    print(f"  (c) rwkv6 {dtype} serve against one rank: {n_same} of "
          f"{res.tokens.shape[0]} rows' tokens equal, "
          f"{'logits' if held else 'prefill logits'} {worst:.3e} apart "
          f"({what}); slowest rank prefill {pf:.2f} ms, decode {dc:.2f} ms "
          f"a step (one rank {res.prefill_s * 1e3:.2f}, "
          f"{res.decode_s / res.decode_steps * 1e3:.2f})")
    print(f"  (c) rwkv6 {dtype} cache-less kernel forward: kept logits "
          f"{fw_err:.3e} apart ({what}); launches a rank "
          f"{ {k: v for k, v in out[0]['launches'].items() if v} }; slowest "
          f"rank {fs * 1e3:.1f} ms, one rank {one['fwd_s'] * 1e3:.1f} ms")
    if held and not fw_err <= LOGITS_ATOL:
        raise AssertionError(f"rwkv6 mesh forward {dtype}: logits {fw_err} "
                             f"apart")


def phase_mesh_finish(torch, ops, devices=MESH_DEVICES, reduced=False):
    """Phase 20 over phase 16's mesh: (a) the engine, (b) the
    sequence-sharded ring cache, (c) rwkv6 over tp.  Returns the kernel
    rows held at the mesh ranks' shapes.  (``devices=["cpu"] * 4,
    reduced=True`` rehearses it on the CPU with the reduced configs: no
    kernel then launches, and none is held.)"""
    from repro_torch.common.config import ServeConfig
    from repro_torch.launch.mesh import RankPool
    cuda = torch.device(devices[0]).type == "cuda"
    dev = torch.device(devices[0])
    if reduced:
        se = SMALL_ENGINE
        sc = ServeConfig(prompt_len=se["prompt_len"],
                         max_new_tokens=se["new_tokens"],
                         n_slots=se["n_slots"], page_size=se["page_size"])
        n_req = 6
    else:
        sc, n_req = ServeConfig(), MESH_ENGINE_REQUESTS
    t0 = time.perf_counter()
    one, reqs = p20_one_rank(torch, dev, reduced, sc, n_req)
    print(f"  one rank, this process: the engine runs (bf16 graphs, fp32 "
          f"eager) and rwkv6's serve and forward in "
          f"{time.perf_counter() - t0:.1f} s")
    rows = []
    with RankPool(len(devices), backend=MESH_BACKEND, devices=devices,
                  timeout_s=900) as pool:
        for arch in ("qwen3", "qwen1.5"):
            t1 = time.perf_counter()
            inits = pool.run(_p20_draw, arch, reduced)
            print(f"  {arch}: weights drawn and cut in "
                  f"{time.perf_counter() - t1:.1f} s, "
                  f"{inits[0]['param_bytes'] / 2**30:.2f} GiB of fp32 "
                  f"parameters a rank")
            for name, a, backend, cf in MESH_ENGINE_RUNS:
                if a != arch:
                    continue
                t1 = time.perf_counter()
                per = (MESH_PER_FORWARD[backend] if backend else
                       ZERO_LAUNCHES) if cuda and not reduced else None
                checked = pool.run(_p20_engine, sc, backend, cf, "bfloat16",
                                   reqs[arch], True, True)
                fp32 = pool.run(_p20_engine, sc, backend, cf, "float32",
                                reqs[arch], True, False)
                check_mesh_engine(name, checked, fp32,
                                  one[name, "bfloat16"], one[name, "float32"],
                                  per, sc)
                rows += checked[0]["rows"]
                print(f"  (a) {name}: {time.perf_counter() - t1:.1f} s")
            if arch == "qwen3":
                t1 = time.perf_counter()
                runs = {(d, s): pool.run(_p20_seq, s, d,
                                         SEQ_SERVE["new_tokens"], True)
                        for d in ("float32", "bfloat16")
                        for s in (False, True)}
                check_seq_shard(runs, MESH_PER_FORWARD["dropless"]
                                if cuda and not reduced else None, sc)
                print(f"  (b) {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        pool.run(_p20_draw, "rwkv6", reduced)
        for dtype in ("float32", "bfloat16"):
            out = pool.run(_p20_rwkv, RWKV_MESH_SERVE,
                           (4, 64) if reduced else RWKV_MESH_FORWARD, dtype)
            check_rwkv_mesh(out, one["rwkv6", dtype], cuda,
                            p20_cfg("rwkv6", reduced).num_layers, dtype)
            rows += out[0]["rows"]
        print(f"  (c) {time.perf_counter() - t1:.1f} s")
    for _, line in rows:
        print(line)
    return [r for r, _ in rows]


# phase 21: the remaining transformer architectures.  deepseek-v3 at full
# width (d 7,168, 128 MLA heads, q rank 1,536, kv rank 512, 256 experts of
# 2,048 plus one shared, top-8 over top_g 4, vocab 129,280) cut to 4 of 61
# layers (its three dense layers and one MoE layer: 15.8 B parameters, the
# MoE layer 11.5 B of them), on DeepSeek-V3's published expert grouping
# (n_group 8, topk_group 4: grid (8, 32); grid (0, 0) cannot route on one
# device).  The serving form draws every block's weights in bf16 as it goes
# (the fp32 draw of the whole model, 63 GB, would not fit beside its cast)
DSV3 = dict(arch="deepseek-v3-671b", num_layers=4, moe_grid=(8, 32))
ARCH_SERVE = dict(batch=8, prompt_len=128, new_tokens=8)
# one MoE layer a forward: dispatch and combine at both SMILE hops, the
# grouped FFN at hop 2
DSV3_PER_FORWARD = {**ZERO_LAUNCHES, "dispatch_gather": 2, "grouped_ffn": 1,
                    "combine_gather": 2}
DSV3_HELD = ("dispatch_gather", "combine_gather", "grouped_ffn")
# the plain grouped FFN widens every weight to fp32: 256 experts' 22.5 GB
# of bf16 would take 45 GB, so it runs 32 experts at a time
FFN_PLAIN_EXPERTS = 32
# training: one dense MLA layer of 61 with the MTP head (3.12 B fp32
# parameters, ~50 GB with gradients and LAMB moments; a MoE layer's 11.5 B
# and their state do not fit one card), batch 4 x 128
DSV3_TRAIN = dict(arch="deepseek-v3-671b", reduced=False, num_layers=1,
                  batch=4, seq=128, optimizer="lamb", moe_grid=(8, 32),
                  moe_options={"router_impl": "fused", "sort_impl": "radix"})
# musicgen-large at full width and depth; phi-3-vision at full width, its
# training cut to 16 of 32 layers (its 3.8 B fp32 parameters with their
# gradients and moments, 61 GB, leave too little room at full depth)
MUSIC_ARCH, PHI3_ARCH = "musicgen-large", "phi-3-vision-4.2b"
MUSIC_FORWARD = dict(arch=MUSIC_ARCH, num_layers=None, moe_grid=None,
                     batch=2, seq=2048)
PHI3_FORWARD = dict(arch=PHI3_ARCH, num_layers=None, moe_grid=None, batch=2,
                    seq=1024)
MUSIC_TRAIN = dict(arch=MUSIC_ARCH, reduced=False, batch=4, seq=128,
                   optimizer="lamb")
PHI3_TRAIN = dict(arch=PHI3_ARCH, reduced=False, num_layers=16, batch=2,
                  seq=1024, optimizer="lamb")
ARCH_TRAIN_STEPS = 3                      # one warm-up, two timed
# a flash launch a layer of a cache-less forward (musicgen 48, phi-3 32)
MUSIC_FLASH = {**ZERO_LAUNCHES, "flash_attention": 48}
PHI3_FLASH = {**ZERO_LAUNCHES, "flash_attention": 32}
ARCHS_21 = ("deepseek-v3-671b", MUSIC_ARCH, PHI3_ARCH)


def chunked_ffn_plain(torch, ref, experts: int):
    """``ref.grouped_ffn_ref`` over ``experts`` groups at a time (the same
    function: each group's product is its own)."""
    def plain(x, w1, w3, w2, *, act):
        return torch.cat([ref.grouped_ffn_ref(
            x[g:g + experts], w1[g:g + experts],
            None if w3 is None else w3[g:g + experts], w2[g:g + experts],
            act=act) for g in range(0, x.shape[0], experts)])
    return plain


def phase_arch_serve(torch, ops, card, arch, per_forward, num_layers=None,
                     moe_grid=None, held=(), serve_kw=ARCH_SERVE):
    """``serve`` of ``arch`` at full width (``serve_kw``), every launch count
    set to 0 just before and read just after: each phase's launches its
    path's per forward, finite logits, then the same weights and prompts
    warm through ``generate``.  The first call of each kernel in ``held``
    at each shape keeps its inputs (the weights by reference).  Returns
    ``(result, captured)``."""
    from repro_torch.launch.serve import generate, serve
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with capture_kernel_inputs(ops, lambda: arch, held,
                               by_ref_bytes=1 << 30) as captured:
        ops.reset_launch_counts()
        res = serve(arch, reduced=False, seed=0, device="cuda",
                    num_layers=num_layers, moe_grid=moe_grid, **serve_kw)
        launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    cfg, steps = res.inputs.cfg, res.decode_steps
    n_params = sum(t.numel() for t in _leaves(res.inputs.params))
    print(f"  {arch} ({card}): {cfg.num_layers} layers, {n_params / 1e9:.3f}"
          f" B parameters; first call: prefill {res.prefill_s * 1e3:.2f} ms "
          f"({res.batch} x {serve_kw['prompt_len']}), decode "
          f"{res.decode_s / steps * 1e3:.2f} ms a step; launches "
          f"{launches}; max_memory_allocated {peak / 2**30:.2f} GiB")
    if not res.logits_finite:
        raise AssertionError(f"{arch} serve: non-finite logits")
    for phase, n in (("prefill", 1), ("decode", steps)):
        want = {k: v * n for k, v in per_forward.items()}
        if res.launches[phase] != want:
            raise AssertionError(f"{arch} serve {phase}: launches "
                                 f"{res.launches[phase]}, expected {want}")
    K = cfg.num_codebooks
    want = ((res.batch, K, serve_kw["new_tokens"]) if K > 1
            else (res.batch, serve_kw["new_tokens"]))
    if res.tokens.shape != want:
        raise AssertionError(f"{arch} serve: tokens {res.tokens.shape}")
    inp = res.inputs
    warm = generate(inp.params, inp.prompts, inp.cfg, inp.plan,
                    new_tokens=serve_kw["new_tokens"])
    print(f"  {arch} warm ({card}): prefill {warm.prefill_s * 1e3:.2f} ms; "
          f"decode {warm.decode_s / steps * 1e3:.2f} ms a step "
          f"({steps * warm.batch / warm.decode_s:.1f} tokens/s); tokens "
          f"equal to the first call: "
          f"{bool((warm.tokens == res.tokens).all())}")
    return res, captured


def phase_arch_train(torch, ops, card, kw, steps=ARCH_TRAIN_STEPS):
    """``train()`` at full width (``kw``), every launch count set to 0
    just before and read just after (0 throughout: the dense layers run
    no kernel, and training runs the plain expert path): one warm-up step
    and the rest timed; the loss, its parts and the peak memory."""
    from repro_torch.launch.train import train
    from repro_torch.optim import leaf_groups
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    params, hist = train(steps=steps, log_every=1, device="cuda", **kw)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for g in leaf_groups(params) for p in g.pieces)
    del params
    tokens = kw["batch"] * kw["seq"]
    for h in hist:
        print(f"  {kw['arch']} ({card}) step {h['step']}"
              f"{' (warm-up)' if h['step'] == 1 else ''}: "
              f"{h['step_ms']:.2f} ms ({tokens / h['step_ms'] * 1e3:,.0f} "
              f"tokens/s)  loss {h['loss']:.4f} ce {h['ce']:.4f} mtp "
              f"{h['mtp']:.4f} lb {h['lb']:.5f} grad norm "
              f"{h['grad_norm']:.4f}")
        if not all(math.isfinite(h[k]) for k in ("loss", "grad_norm")):
            raise AssertionError(f"{kw['arch']} train step {h['step']}: "
                                 f"non-finite loss or grad norm")
    timed = [h["step_ms"] for h in hist[1:]]
    print(f"  {kw['arch']} ({card}): {n_params / 1e9:.3f} B parameters, "
          f"{kw.get('num_layers') or 'all'} layers, batch {kw['batch']} x "
          f"{kw['seq']}; timed steps mean {sum(timed) / len(timed):.2f} ms; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB; launches "
          f"{launches}")
    if any(launches.values()):
        raise AssertionError(f"{kw['arch']} train: launches {launches}")
    gc.collect()
    torch.cuda.empty_cache()
    return hist


def phase_arch_card_vs_cpu_fp32(torch, card, arch):
    """A reduced config in fp32 on the plain path (the kernels take bf16),
    prefill and 3 decode steps on the CPU and on the card from the same
    weights, each fed its own tokens: the card gives the CPU's tokens
    (every codebook's), and its logits lie within phase 16's tolerance up
    to where a row parts (``check_tokens_and_logits``)."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch.serve import generate, serve_prompts
    from repro_torch.models import transformer as T
    from repro_torch.sharding.plan import single_device_plan
    cfg = get_reduced(arch).replace(dtype="float32")
    plan = single_device_plan()
    params = T.init_model(cfg, plan, seed=0, device="cpu")
    runs = {}
    for dev in ("cpu", "cuda"):
        runs[dev] = generate(_to(params, dev),
                             serve_prompts(cfg, 2, 16, 0, dev), cfg, plan,
                             new_tokens=4, keep_logits=True, use_kernel=False)
    a, b = runs["cpu"], runs["cuda"]
    K = cfg.num_codebooks

    def rows(r):
        # every codebook's stream a row: (B*K, n) tokens, (n, B*K, V)
        if K == 1:
            return r.tokens, r.logits
        n = r.tokens.shape[-1]
        return (r.tokens.reshape(-1, n),
                r.logits.reshape(n, -1, r.logits.shape[-1]))

    n_same, worst = check_tokens_and_logits(*rows(a), *rows(b), LOGITS_ATOL,
                                            f"{arch} fp32 card against CPU")
    print(f"  {arch} fp32 ({card}), plain path: {n_same} of "
          f"{rows(a)[0].shape[0]} rows' tokens equal; largest logits "
          f"difference {worst:.3e} (tolerance {LOGITS_ATOL})")
    if n_same != rows(a)[0].shape[0]:
        raise AssertionError(f"{arch} fp32: the card parts from the CPU's "
                             f"tokens")


def phase_archs(torch, ops, ref, card):
    """Phase 21 (see the module docstring); returns the kernel rows held
    at deepseek-v3's shapes."""
    from repro_torch.configs import get_config
    cfg = get_config(DSV3["arch"])
    print(f"  deepseek-v3 param_count {cfg.param_count() / 1e9:.2f} B at 61 "
          f"layers (the reference's count, whose MTP term counts a MoE "
          f"layer)")
    t0 = time.perf_counter()
    res, captured = phase_arch_serve(torch, ops, card, DSV3["arch"],
                                     DSV3_PER_FORWARD,
                                     num_layers=DSV3["num_layers"],
                                     moe_grid=DSV3["moe_grid"],
                                     held=DSV3_HELD)
    print(f"  (a) deepseek-v3 serve: {time.perf_counter() - t0:.1f} s; "
          f"holding each kernel's first call at each shape ({card})")
    rows = []
    for row, line in hold_captured(
            torch, ops, ref, captured, {DSV3["arch"]: "dsv3"},
            {"grouped_ffn": chunked_ffn_plain(torch, ref,
                                              FFN_PLAIN_EXPERTS)}):
        print(line)
        rows.append(row)
    del res, captured
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    phase_arch_train(torch, ops, card, DSV3_TRAIN)
    phase_train_card_vs_cpu(torch, DSV3["arch"], steps=1)
    print(f"  (b) deepseek-v3 training: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    phase_arch_serve(torch, ops, card, MUSIC_ARCH, ZERO_LAUNCHES)
    phase_scoring_forward(torch, ops, MUSIC_FORWARD, MUSIC_FLASH,
                          shares=("flash_attn",))
    phase_arch_train(torch, ops, card, MUSIC_TRAIN)
    print(f"  (c) musicgen-large: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    phase_arch_serve(torch, ops, card, PHI3_ARCH, ZERO_LAUNCHES)
    phase_scoring_forward(torch, ops, PHI3_FORWARD, PHI3_FLASH,
                          shares=("flash_attn",),
                          images=get_config(PHI3_ARCH).vision_tokens)
    phase_arch_train(torch, ops, card, PHI3_TRAIN)
    print(f"  (d) phi-3-vision: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    for arch in ARCHS_21:
        phase_card_vs_cpu(torch, ops, arch=arch)
        phase_arch_card_vs_cpu_fp32(torch, card, arch)
    print(f"  (e) card against CPU: {time.perf_counter() - t0:.1f} s")
    return rows


# phase 22: zamba2-2.7b at full width and depth (54 Mamba2 layers in 9
# groups of 6, each followed by the shared attention block).  Its path
# launches no kernel, as the reference's: the Mamba2 blocks call none, and
# the shared block runs with use_kernel=False whatever the caller asks
ZAMBA = "zamba2-2.7b"
ZAMBA_SERVE = dict(batch=8, prompt_len=128, new_tokens=16)   # one chunk
ZAMBA_FORWARD = dict(arch=ZAMBA, num_layers=None, moe_grid=None, batch=2,
                     seq=2048)                               # 16 chunks
ZAMBA_TRAIN = dict(arch=ZAMBA, reduced=False, batch=2, seq=1024,
                   optimizer="lamb")


@contextlib.contextmanager
def first_intra_chunk_inputs():
    """Keeps the inputs of the first call of ``mamba2.ssd_intra_chunk`` in
    the block (layer 0's, in a forward): ``(xh, dt, loga, Bc, Cc)``."""
    from repro_torch.models import mamba2 as M2
    plain, kept = M2.ssd_intra_chunk, []

    def spy(*args):
        if not kept:
            kept.extend(a.detach().contiguous() for a in args)
        return plain(*args)

    M2.ssd_intra_chunk = spy
    try:
        yield kept
    finally:
        M2.ssd_intra_chunk = plain


def phase_zamba2(torch, ops, card, rows):
    """Phase 22 (see the module docstring); adds the ``ssd_chunk`` row on
    the path's tensors to ``rows``."""
    from repro_torch.configs import get_config
    from repro_torch.models import mamba2 as M2
    t0 = time.perf_counter()
    res, _ = phase_arch_serve(torch, ops, card, ZAMBA, ZERO_LAUNCHES,
                              serve_kw=ZAMBA_SERVE)
    built = sum(t.numel() for t in _leaves(res.inputs.params))
    print(f"  zamba2 param_count {get_config(ZAMBA).param_count() / 1e9:.3f} "
          f"B (the reference's count, which counts the x/z projections "
          f"twice) against {built / 1e9:.3f} B built")
    del res
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  (a) serve: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    with first_intra_chunk_inputs() as kept:
        phase_scoring_forward(torch, ops, ZAMBA_FORWARD, ZERO_LAUNCHES,
                              shares=())
    print(f"  (b) cache-less forward: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    hold_ssd(torch, ops, rows, "zamba2 path", kept, M2.ssd_intra_chunk,
             "layer 0's tensors of (b)")
    del kept
    print(f"  (c) ssd_chunk on the path's tensors: "
          f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    phase_arch_train(torch, ops, card, ZAMBA_TRAIN)
    print(f"  (d) training: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    phase_card_vs_cpu(torch, ops, arch=ZAMBA, held=False)
    phase_arch_card_vs_cpu_fp32(torch, card, ZAMBA)
    phase_train_card_vs_cpu(torch, ZAMBA, steps=1, dtype="float32")
    print(f"  (e) card against CPU: {time.perf_counter() - t0:.1f} s")


# =============================================================================
# Phase 23: the tooling (kernel pass, dry run against measured peaks, the
# production sweep's headline)
# =============================================================================

TOOLING_BUDGET_S = 90
# phase 3's serve and phase 5's training step, for the dry run on one device
DRYRUN_PHASE3 = dict(arch="qwen3-moe-30b-a3b", tokens=128, batch=8,
                     cache_len=160, num_layers=4, moe_grid=(16, 8))
DRYRUN_PHASE5 = dict(arch="smile-3.7b", seq=128, batch=16, moe_grid=(16, 8))
HEADLINE = [(a, r) for a in ("qwen3-moe-30b-a3b", "deepseek-v3-671b")
            for r in ("smile", "switch")]
HEADLINE_MICRO_STEPS = 2
DRYRUN_CHILD = """
import json
from repro_torch.common.config import InputShape
from repro_torch.launch import dryrun as D
from repro_torch.launch.serve import serve_config
from repro_torch.launch.train import train_config
s, t = {s}, {t}
out = {{}}
for gc_every in (D.CA.GC_EVERY, 0):
    r = D.run_step(s["arch"], "prefill_32k", mesh_shape=(),
                   cache_len=s["cache_len"], collect_every=gc_every,
                   cfg=serve_config(s["arch"], reduced=False,
                                    num_layers=s["num_layers"],
                                    moe_grid=s["moe_grid"]),
                   shape=InputShape("phase3", s["tokens"], s["batch"],
                                    "prefill"))
    out["serve", gc_every] = r
    r = D.run_step(t["arch"], "train_4k", mesh_shape=(), micro_batch=0,
                   collect_every=gc_every,
                   cfg=train_config(t["arch"], reduced=False,
                                    moe_grid=t["moe_grid"]),
                   shape=InputShape("phase5", t["seq"], t["batch"], "train"))
    out["train", gc_every] = r
print(json.dumps([[k[0], k[1], {{n: r[n] for n in ("argument_bytes",
                   "temp_bytes", "step_s")}}] for k, r in out.items()]))
"""


def start_dryruns(out_dir: str):
    """Phase 23 (b) and (c)'s dry runs, each a process of its own, all
    started at once: ``{name: Popen}``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {"peaks": subprocess.Popen(
        [sys.executable, "-c", DRYRUN_CHILD.format(s=repr(DRYRUN_PHASE3),
                                                   t=repr(DRYRUN_PHASE5))],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)}
    for arch, router in HEADLINE:
        procs[f"{arch}/{router}"] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", "train_4k", "--router", router, "--tag",
             router, "--micro-steps", str(HEADLINE_MICRO_STEPS), "--out",
             out_dir], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    return procs


def finish_dryruns(procs, timeout_s: float = 600.0):
    """Each process's stdout; raises with its stderr where it failed."""
    outs = {}
    for name, p in procs.items():
        try:
            out, err = p.communicate(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            raise AssertionError(f"dry run {name} outlasted {timeout_s} s")
        if p.returncode != 0:
            raise AssertionError(f"dry run {name} failed:\n{err[-3000:]}")
        outs[name] = out
    return outs


def phase_kernel_lint():
    """Phase 23 (a): the kernel pass over this run's build and the
    launches phase 2 recorded."""
    import re
    from repro_torch.analysis import kernel_lint as K
    from repro_torch.kernels import _build
    logs = dict(_build.build_log)
    if set(logs) != set(_build.SIGNATURES):     # a library built earlier
        logs = K.ptxas_logs()
    entries = K.ptxas_entries(logs)
    names = K.demangle([e.function for e in entries])
    matched = K.match_launches(entries, LAUNCHES_SEEN, names)
    for e in entries:
        short = names.get(e.function, e.function).replace(
            "void ", "").replace("(anonymous namespace)::", "")
        short = re.sub(r"\(.*", "", short)
        line = (f"  [{e.source}] {short}: {e.registers} registers, spill "
                f"stores {e.spill_stores} B, loads {e.spill_loads} B, "
                f"static smem {e.static_smem} B")
        ls = matched.get(e.function, [])
        if ls:
            regs = max(ls, key=lambda l: l.registers * l.threads)
            big = max(ls, key=lambda l: l.smem)
            line += (f"; {len(ls)} launch configurations, threads "
                     f"{sorted({l.threads for l in ls})}: at most "
                     f"{regs.registers} x {regs.threads} = "
                     f"{regs.registers * regs.threads} registers (of "
                     f"{K.SM90_REGS_PER_SM}), {big.smem} B of shared memory "
                     f"= static {e.static_smem} + dynamic "
                     f"{big.smem - e.static_smem} (of {K.SM90_SMEM_OPTIN}; "
                     f"grid {list(big.grid)})")
        print(line)
    seen = {e.source for e in entries if e.function in matched}
    if set(_build.SIGNATURES) - seen:
        print(f"  no launch recorded for "
              f"{sorted(set(_build.SIGNATURES) - seen)}")
    findings = (K.check_ptxas(entries, names)
                + K.check_launches([l for ls in matched.values()
                                    for l in ls])
                + K.check_float_atomics(K.cuda_sources()))
    print(f"  {len(entries)} kernel functions of {len(logs)} sources, "
          f"{sum(map(len, matched.values()))} launch configurations; "
          f"{len(findings)} finding(s):")
    for f in findings:
        print(f"    {f.format()}")
    bad = [f for f in findings if f.rule in ("smem-budget", "register-limit",
                                             "float-atomic")]
    if bad:
        raise AssertionError(f"kernel pass: {[f.format() for f in bad]}")


def phase_tooling(torch):
    """Phase 23: (a) the kernel pass, (b) the dry run's peaks against
    phases 3 and 5's, (c) the production sweep's headline; the dry runs
    run in their own processes while (a) runs here."""
    import shutil
    import tempfile
    from repro_torch.launch.dryrun import H100_HBM_BYTES
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"  card memory (get_device_properties): {total} B "
          f"({total / 2**30:.2f} GiB); the dry run's default "
          f"{H100_HBM_BYTES} B")
    out_dir = tempfile.mkdtemp(prefix="dryrun_")
    try:
        procs = start_dryruns(out_dir)
        print("  (a) the kernel pass")
        phase_kernel_lint()
        report_dryruns(finish_dryruns(procs), out_dir)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def report_dryruns(outs, out_dir: str) -> None:
    """Print phase 23 (b) and (c) from the dry runs' output and files."""
    print("  (b) the dry run on the meta device against the measured "
          "peaks (torch.cuda.max_memory_allocated)")
    runs = json.loads(outs["peaks"].strip().splitlines()[-1])
    for what, gc_every, r in runs:
        phase = 3 if what == "serve" else 5
        pred = r["argument_bytes"] + r["temp_bytes"]
        got = MEASURED_PEAKS.get(what)
        line = (f"    phase {phase} ({what}), "
                f"{f'cycles collected every {gc_every} ops' if gc_every else 'Python collects the cycles'}: "
                f"predicted peak {pred / 2**30:.2f} GiB (argument_bytes "
                f"{r['argument_bytes'] / 2**30:.2f} + temp_bytes "
                f"{r['temp_bytes'] / 2**30:.2f}), dry run "
                f"{r['step_s']:.1f} s")
        if got:
            line += (f"; measured {got / 2**30:.2f} GiB, predicted / "
                     f"measured {pred / got:.3f}")
        print(line)
    print(f"  (c) train_4k on the 16 x 16 mesh (256 ranks, 8 a node), "
          f"rank 0, {HEADLINE_MICRO_STEPS} of 16 micro-batches run: "
          f"All2All bytes a rank sends to peers on its node / off it")
    for arch, router in HEADLINE:
        res = json.load(open(os.path.join(
            out_dir, f"{arch}__train_4k__single__{router}.json")))
        c = res["collectives"]
        near = c["intra_node_peer_bytes"]["all-to-all"]
        far = c["inter_node_peer_bytes"]["all-to-all"]
        groups = sorted(k for k in res["collectives_by_group"]
                        if k.startswith("all-to-all"))
        print(f"    {arch} {router}: on the node {near / 2**30:.3f} "
              f"GiB, off it {far / 2**30:.3f} GiB (buffers "
              f"{c['bytes_per_op']['all-to-all'] / 2**30:.3f} GiB, "
              f"{c['calls_per_op']['all-to-all']:g} calls, groups "
              f"{groups}); peak "
              f"{res['memory']['peak_bytes'] / 2**30:.2f} GiB, fits "
              f"{res['fits']}; dry run {res['step_s']:.1f} s")


class PhaseClock:
    """Prints each phase's heading, and its wall time when the next one
    starts (or at :meth:`stop`)."""

    def __init__(self):
        self.t0 = None

    def start(self, heading: str) -> None:
        self.stop()
        print(f"== {heading}")
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self.t0 is not None:
            print(f"  phase wall time {time.perf_counter() - self.t0:.1f} s")
        self.t0 = None


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build, ops, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    clock = PhaseClock()

    clock.start("phase 1: card and build")
    card = card_line()
    print(f"  card: {card}")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.load_all()
    print(f"  kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "Used", "spill",
                                       "wgmma", "arning")):
                print(f"  [{name}] {line.strip()}")

    clock.start(f"phase 2: kernels against their plain versions ({card}); "
                f"tolerances: dispatch_gather bit-exact, combine_gather 1 "
                f"bf16 ulp, grouped_ffn rtol {FFN_RTOL} + atol {FFN_ATOL}")
    rows = phase_kernels(torch, ops, ref)
    print(f"  training shapes: router_fused and group_sort; tolerances: "
          f"router logits/probs rtol {ROUTER_RTOL} + atol {ROUTER_ATOL} "
          f"(TF32 off in the plain version), ids/ranks/starts exact; "
          f"group_sort bit-exact")
    phase_routing_kernels(torch, ops, ref, rows)
    phase_sort_crossover(torch, ops, ref)
    phase_launch_floor(torch, ops)
    print(f"  dropless hop-2 shapes: grouped_ffn_ragged; tolerance rtol "
          f"{FFN_RTOL} + atol {FFN_ATOL}, tail tiles exact zeros")
    phase_ragged_ffn(torch, ops, ref, rows)
    print(f"  cache-less forward shapes: flash_attention (one bf16 ulp + "
          f"{FLASH_ROW_ATOL} of the row's RMS), rwkv6_scan (rtol {RWKV_RTOL} + atol "
          f"{RWKV_ATOL_REL} of the largest value), ssd_chunk (rtol "
          f"{SSD_RTOL} + atol {SSD_ATOL_REL} of the largest value)")
    phase_scoring_kernels(torch, ops, ref, rows)

    clock.start(f"phase 3: serve qwen3-moe-30b-a3b, full width, 4 of 48 "
                f"layers ({card})")
    launches, first = phase_serve(torch, ops)
    fixed_step_ms = phase_warm(torch, first)
    del first

    clock.start("phase 4: card against CPU, reduced qwen3-moe-30b-a3b")
    phase_card_vs_cpu(torch, ops)

    clock.start(f"phase 5: train smile-3.7b, full width and depth, grid "
                f"(16, 8), LAMB ({card})")
    train_launches, _, _ = phase_train(torch, ops)
    launches.update({k: train_launches[k]
                     for k in ("router_fused", "group_sort")})

    clock.start("phase 6: card against CPU, training reduced smile-3.7b")
    phase_train_card_vs_cpu(torch)

    clock.start(f"phase 7: serve qwen3-moe-30b-a3b dropless, full width, 4 "
                f"of 48 layers ({card})")
    dropless_launches = phase_serve_dropless(torch, ops)
    launches["grouped_ffn_ragged"] = dropless_launches["grouped_ffn_ragged"]

    clock.start("phase 8: card against CPU, reduced qwen3-moe-30b-a3b "
                "dropless")
    phase_card_vs_cpu(torch, ops, DROPLESS)

    clock.start(f"phase 9: qwen3-moe-30b-a3b cache-less kernel forward, full "
                f"width, 4 of 48 layers, batch 2 x 4096 ({card})")
    score = phase_scoring_forward(torch, ops, SCORE_QWEN, QWEN_SCORE_LAUNCHES,
                                  shares=("flash_attn", "grouped_gemm_sm90"))
    launches["flash_attention"] = score["flash_attention"]

    clock.start("phase 10: card against CPU, reduced qwen3-moe-30b-a3b "
                "cache-less kernel forward")
    phase_scoring_card_vs_cpu(torch, ops, "qwen3-moe-30b-a3b")

    clock.start(f"phase 11: rwkv6-1.6b, full width and depth: cache-less "
                f"kernel forward, batch 4 x 4096; serve, batch 8, prompt "
                f"128, 32 new tokens ({card})")
    score = phase_scoring_forward(torch, ops, SCORE_RWKV, RWKV_SCORE_LAUNCHES,
                                  shares=("rwkv6_scan",))
    launches["rwkv6_scan"] = score["rwkv6_scan"]
    # no path of the port (or of the JAX package) calls the SSD kernel: the
    # phases assert its count 0, and the line reports this forward's
    launches["ssd_chunk"] = score["ssd_chunk"]
    phase_rwkv_serve(torch, ops)

    clock.start("phase 12: card against CPU, reduced rwkv6-1.6b: cache-less "
                "kernel forward (fp32 and bf16), cached steps (fp32)")
    for dtype in ("float32", "bfloat16"):
        phase_scoring_card_vs_cpu(torch, ops, "rwkv6-1.6b", dtype)
    phase_rwkv_serve_card_vs_cpu(torch, ops)

    clock.start(f"phase 13: engine, qwen3-moe-30b-a3b, full width, 4 of 48 "
                f"layers, grid (16, 8), sort then dropless on the same "
                f"weights, {ENGINE_REQUESTS} ragged requests ({card})")
    phase_engine_qwen3(torch, ops, fixed_step_ms)

    clock.start(f"phase 14: engine, qwen1.5-0.5b, full width and depth, "
                f"{ENGINE_REQUESTS} ragged requests ({card})")
    phase_engine_qwen15(torch, ops)

    clock.start("phase 15: engine, card against CPU, reduced qwen3-moe-30b-a3b"
                " (sort, dropless) and qwen1.5-0.5b")
    for arch, opts in (("qwen3-moe-30b-a3b", None),
                       ("qwen3-moe-30b-a3b", DROPLESS), ("qwen1.5-0.5b", None)):
        phase_engine_card_vs_cpu(torch, ops, arch, opts)

    clock.start(f"phase 16: serve qwen3-moe-30b-a3b over a (data 2, model 2) "
                f"mesh of 4 ranks sharing the card under gloo, full width, 4 "
                f"of 48 layers ({card})")
    phase_mesh_serve(torch, ops, fixed_step_ms)

    clock.start(f"phase 17: train smile-3.7b (then switch-3.7b) over a (data "
                f"2, model 2) mesh of 4 ranks sharing the card under gloo, "
                f"full width, 6 of 12 layers ({card})")

    def robust_mesh(pool, runs):
        clock.start(f"phase 18: the robust runtime ({card}). (a) ZeRO-1 LAMB "
                    f"and the sentinel on phase 17's ranks (gloo through the "
                    f"host), its config, weights and batches, then a "
                    f"poisoned step")
        phase_robust_mesh(torch, ops, pool, runs["smile-3.7b"])
        clock.start(f"phase 19: fault containment on phase 17's ranks "
                    f"({card}). (a) _faults.py's matrix on qwen3-moe's and "
                    f"switch-3.7b's MoE layers at full width; (b) the "
                    f"checksummed wire's cost on phase 16's dropless serve; "
                    f"(c) a quarantined bit flip and a nanrows step under "
                    f"ZeRO-1 and the sentinel")
        phase_fault_containment(torch, ops, pool)

    phase_mesh_train(torch, ops, after=robust_mesh)
    clock.start(f"phase 18 (b): one rank: smile-3.7b, full width, 2 of 12 "
                f"layers, the sentinel on; two runs, then a halted run's "
                f"snapshot and its resume ({card})")
    phase_robust_one_rank(torch, ops)

    clock.start(f"phase 20: the rest of serving over phase 16's mesh (4 "
                f"ranks sharing the card under gloo): (a) the engine, "
                f"qwen3-moe-30b-a3b (4 of 48 layers; dropless, sort) and "
                f"qwen1.5-0.5b, full width; (b) the sequence-sharded ring "
                f"cache; (c) rwkv6-1.6b over tensor parallelism ({card})")
    for r in phase_mesh_finish(torch, ops):
        rows.setdefault(r["name"], []).append(r)

    clock.start(f"phase 21: the remaining transformer architectures "
                f"({card}): (a) deepseek-v3 serve, full width, 4 of 61 "
                f"layers, grid (8, 32); (b) its training, 1 of 61 layers and "
                f"the MTP head; (c) musicgen-large and (d) phi-3-vision, full "
                f"width; (e) the reduced configs card against CPU")
    for r in phase_archs(torch, ops, ref, card):
        rows.setdefault(r["name"], []).append(r)

    clock.start(f"phase 22: zamba2-2.7b, full width and depth ({card}): (a) "
                f"serve, batch 8, prompt 128, 16 new tokens; (b) the "
                f"cache-less forward, 2 x 2048; (c) ssd_chunk on layer 0's "
                f"tensors of (b); (d) training, 2 x 1024, LAMB; (e) the "
                f"reduced config card against CPU")
    phase_zamba2(torch, ops, card, rows)

    clock.start(f"phase 23: the tooling ({card}): (a) the kernel pass over "
                f"this run's build; (b) the dry run on the meta device "
                f"against phases 3 and 5's peaks; (c) qwen3-moe and "
                f"deepseek-v3 train_4k on the 16 x 16 mesh, SMILE and "
                f"Switch")
    t23 = time.perf_counter()
    phase_tooling(torch)
    t23 = time.perf_counter() - t23
    if t23 > TOOLING_BUDGET_S:
        print(f"  phase 23 took {t23:.1f} s, past its "
              f"{TOOLING_BUDGET_S} s budget")
    clock.stop()

    main_shape = {"dispatch_gather": "prefill hop-2",
                  "combine_gather": "prefill hop-2",
                  "grouped_ffn": "prefill",
                  "router_fused": "train hop-1",
                  "group_sort": "train hop-2",
                  "grouped_ffn_ragged": "prefill hop-2",
                  "flash_attention": "qwen3 path",
                  "rwkv6_scan": "rwkv6 path",
                  "ssd_chunk": "zamba2 path"}
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        r = next(x for x in rows[name] if x["shape"] == main_shape[name])
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(x["max_abs_err"] for x in rows[name]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    print(f"  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
