"""Configuration dataclasses for the PyTorch port.

A copy of ``repro.common.config`` (the JAX package's module), kept here so
the port never imports the JAX package.  Every architecture in
``repro_torch.configs`` instantiates a :class:`ModelConfig`.  The option
registries and their help strings are kept verbatim: the tests hold this
copy equal to the reference field by field and default by default.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


# =============================================================================
# MoE options registry — the single source of truth for every runtime-
# tunable dispatch/routing knob.  ``MoEConfig.with_options`` validates
# against it, and both launchers derive their flags from it
# (``launch/train.py`` CLI flags, ``launch/dryrun.py`` ``--opt`` tokens), so
# a new knob added here is automatically reachable from every entry point —
# it cannot silently miss a launcher.
# =============================================================================

@dataclass(frozen=True)
class MoEOption:
    """One tunable knob of :class:`MoEConfig` (also reused as the generic
    option-registry record for :data:`TRAIN_OPTIONS`).

    ``kind``: ``"choice"`` (string enum), ``"bool"``, ``"float"``
    (optional float, None = off), ``"int"`` (non-negative integer), or
    ``"str"`` (optional free-form string, None = off).  ``dryrun_opts``
    maps ``dryrun --opt`` tokens to the value they set (e.g.
    ``("padded_a2a", False)``); the CLI flag name for ``train.py`` is
    derived from ``field``.  ``requires`` lists (field, value)
    prerequisites the option is meaningless without — a dryrun token
    implies them (so ``--opt recv_bound`` alone works), and
    ``MoEConfig.with_options`` enforces them on the resulting config.
    """
    field: str
    kind: str
    choices: Tuple[str, ...] = ()
    help: str = ""
    dryrun_opts: Tuple[Tuple[str, Any], ...] = ()
    requires: Tuple[Tuple[str, Any], ...] = ()

    @property
    def flag(self) -> str:
        return "--" + self.field.replace("_", "-")


MOE_OPTIONS: Tuple[MoEOption, ...] = (
    MoEOption("dispatch_backend", "choice", ("sort", "dense", "dropless"),
              help="local dispatch/combine math: sort (argsort + fused "
                   "gathers, the fast path), dense (one-hot/cumsum oracle), "
                   "dropless (capacity-free tile-aligned ragged layout)",
              dryrun_opts=(("dropless", "dropless"),)),
    MoEOption("ragged_a2a", "bool",
              help="dropless only: exact-segment ragged All2All hops (on) "
                   "vs capacity-padded hops + on-arrival re-compaction (off)",
              dryrun_opts=(("padded_a2a", False),)),
    MoEOption("sort_impl", "choice", ("argsort", "radix"),
              help="group sort under every dispatch hop: argsort = XLA "
                   "stable sort, radix = one-pass Pallas counting sort "
                   "(TPU fast path; bit-identical)",
              dryrun_opts=(("radix_sort", "radix"),)),
    MoEOption("router_impl", "choice", ("unfused", "fused"),
              help="routing-stage implementation for every hop's router: "
                   "unfused = separate fp32 GEMM + softmax + lax.top_k XLA "
                   "ops, fused = the single-pass Pallas routing megakernel "
                   "(repro.kernels.router_fused: GEMM, softmax, top-k, "
                   "histogram and dispatch positions in one VMEM pass; "
                   "bit-compatible loss inputs, interpret-validated "
                   "off-TPU)",
              dryrun_opts=(("fused_router", "fused"),)),
    MoEOption("recv_bound_factor", "float",
              help="ragged hops only: bound each receive slab at ~factor x "
                   "expected arrivals instead of the worst-case P x R rows "
                   "(clamp-drops under extreme skew, reported in drop_frac; "
                   "None/off = unbounded, bit-identical zero-drop)",
              dryrun_opts=(("recv_bound", 2.0),),
              requires=(("dispatch_backend", "dropless"),
                        ("ragged_a2a", True))),
    MoEOption("tight_level2_capacity", "bool",
              help="SMILE: size level-2 capacity from expected valid "
                   "arrivals instead of the padded level-1 buffer",
              dryrun_opts=(("tightcap", True),)),
    MoEOption("fault_plan", "str",
              help="deterministic fault injection 'kind[@seed][:hop]' with "
                   "kind in counts|nanrows|dropseg|skew|bitflip|inflate|"
                   "dupseg (see repro.common.faultinject); count/wire "
                   "faults are inert on padded/local hops; 'off'/None = no "
                   "injection (the bit-identical production path)",
              dryrun_opts=(("fault_counts", "counts"),
                           ("fault_nanrows", "nanrows"),
                           ("fault_dropseg", "dropseg"),
                           ("fault_skew", "skew"),
                           ("fault_bitflip", "bitflip"),
                           ("fault_inflate", "inflate"),
                           ("fault_dupseg", "dupseg"))),
    MoEOption("wire_integrity", "choice", ("off", "detect", "quarantine"),
              help="per-segment payload checksums on every ragged exchange "
                   "(parity rows riding the slab, both directions): off = "
                   "production wire (bit-identical), detect = verify + "
                   "account wire_faults but pass payloads through (A/B), "
                   "quarantine = additionally zero-fill and drop flagged "
                   "segments with exact per-(hop, src rank) accounting",
              dryrun_opts=(("wire_detect", "detect"),
                           ("wire_quarantine", "quarantine")),
              requires=(("dispatch_backend", "dropless"),
                        ("ragged_a2a", True))),
)

MOE_OPTION_FIELDS = {o.field: o for o in MOE_OPTIONS}

# =============================================================================
# Train-loop options registry — same record type, same derivation contract:
# ``launch/train.py`` generates one CLI flag per entry and ``launch/dryrun``
# maps the dryrun tokens, so checkpoint/resume/sentinel knobs stay in sync
# across both launchers exactly like the MoE dispatch knobs do.  Fields that
# exist on :class:`TrainConfig` (``sentinel``, ``ckpt_every``, ``ckpt_keep``,
# ``ckpt_dir``) configure it; ``resume`` is a launcher action (auto-pickup of
# the latest valid checkpoint in ``--ckpt-dir``).
# =============================================================================

TRAIN_OPTIONS: Tuple[MoEOption, ...] = (
    MoEOption("sentinel", "bool",
              help="step sentinel: per-step non-finite / loss-spike verdict "
                   "inside jit with a lax.cond-guarded optimizer apply that "
                   "skips bad updates, plus the router-collapse watchdog "
                   "(see repro.train.sentinel)",
              dryrun_opts=(("sentinel", True),)),
    MoEOption("resume", "bool",
              help="resume from the newest valid checkpoint in --ckpt-dir "
                   "(digest-verified; falls back to older snapshots on "
                   "corruption)"),
    MoEOption("ckpt_every", "int",
              help="save a rotating checkpoint every N steps (0 = off)"),
    MoEOption("ckpt_keep", "int",
              help="checkpoints kept in the keep-last-K rotation"),
    MoEOption("ckpt_dir", "str",
              help="run directory for the rotating checkpoints + checksummed "
                   "manifest"),
)

TRAIN_OPTION_FIELDS = {o.field: o for o in TRAIN_OPTIONS}
TRAIN_DRYRUN_OPTS = {tok: {o.field: val}
                     for o in TRAIN_OPTIONS for tok, val in o.dryrun_opts}
# dryrun --opt token -> {field: value} with the option's prerequisites
# merged in (so e.g. "recv_bound" alone implies dropless + ragged hops, the
# way the old hand-written "dropless" token implied ragged_a2a); tokens not
# in this map are dryrun-local (rsc, kvseq, zero1, ...).  Callers apply
# tokens in sorted order for determinism.
MOE_DRYRUN_OPTS = {tok: {**dict(o.requires), o.field: val}
                   for o in MOE_OPTIONS for tok, val in o.dryrun_opts}

# =============================================================================
# Serving options registry — same record type and derivation contract:
# ``launch/serve.py`` generates one CLI flag per entry, and
# ``analysis/repo_lint.check_config_registry`` enforces the two-way mapping
# against :class:`ServeConfig` (every registry field exists on the config;
# every non-structural config field has a registry entry).  These are the
# continuous-batching engine knobs (``repro.serve.engine``): page-pool
# geometry, slot count, prefill bucketing, and the admission policy.
# =============================================================================

SERVE_OPTIONS: Tuple[MoEOption, ...] = (
    MoEOption("page_size", "int",
              help="paged KV cache: tokens per page (pool granularity; small "
                   "pages waste less tail space but grow the page table)"),
    MoEOption("pool_pages", "int",
              help="paged KV cache: total pages preallocated per layer "
                   "(0 = derive n_slots * ceil(cache_len / page_size), i.e. "
                   "every slot can hold a full-length sequence)"),
    MoEOption("n_slots", "int",
              help="continuous batching: sequences in flight per decode tick "
                   "(the fused batched decode step is compiled once at this "
                   "batch)"),
    MoEOption("prefill_buckets", "str",
              help="comma-separated prefill chunk lengths, each compiled "
                   "once (empty = derive doubling sizes up to cache_len); "
                   "long prompts prefill chunk-by-chunk across ticks so they "
                   "never stall the decode tick"),
    MoEOption("admit_policy", "choice", ("fcfs", "sjf"),
              help="admission order for waiting requests: fcfs = arrival "
                   "order (starvation-free), sjf = shortest prompt first "
                   "(lower mean TTFT, can starve long prompts)"),
)

SERVE_OPTION_FIELDS = {o.field: o for o in SERVE_OPTIONS}


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-Experts block configuration."""

    num_experts: int = 0                # routed experts (0 = dense layer)
    top_k: int = 1
    top_g: int = 1                      # bi-level: nodes per token (k_local = top_k/top_g)
    renorm_gates: bool = False          # renormalize selected gates to sum 1
    d_ff_expert: int = 0                # expert FFN hidden size
    num_shared_experts: int = 0         # always-on shared experts (deepseek-v3)
    capacity_factor: float = 2.0        # paper uses 2.0
    router: str = "switch"              # "switch" (one-hop) | "smile" (bi-level)
    lb_alpha: float = 0.005             # inter-node LB loss coefficient (Eq. 4)
    lb_beta: float = 0.005              # intra-node LB loss coefficient (Eq. 4)
    router_z_coef: float = 0.0          # optional z-loss on router logits
    every_n_layers: int = 1             # MoE layer every n-th layer (paper: 2)
    first_dense_layers: int = 0         # leading dense layers (deepseek-v3: 3)
    # Bi-level grid (n_inter x n_intra expert slots). 0 -> derive from mesh.
    grid: Tuple[int, int] = (0, 0)
    # beyond-paper: size level-2 capacity from EXPECTED valid arrivals rather
    # than the padded level-1 buffer (fixes capacity compounding; see
    # EXPERIMENTS.md §Perf-2). False reproduces the paper-faithful baseline.
    tight_level2_capacity: bool = False
    # local dispatch/combine math (repro.core.dispatch): "sort" (argsort +
    # fused gathers, the fast path; see EXPERIMENTS.md §Perf-1), "dense"
    # (one-hot/cumsum oracle), or "dropless" (capacity-free expert compute
    # over tile-aligned ragged segments — zero padding into the FFN and zero
    # token drops wherever the expert grid is local; capacity buffers remain
    # only on fixed-shape All2All hops.  See EXPERIMENTS.md §Perf-3).
    dispatch_backend: str = "sort"
    # "dropless" on a meshed expert grid: move exact ragged token segments
    # over every dispatch hop (repro.sharding.comm.ragged_all_to_all) instead
    # of capacity-padded All2All buffers — zero-pad AND zero-drop end-to-end.
    # False restores the fixed-shape capacity hop + on-arrival re-compaction
    # (the pre-ragged behavior, kept for A/B).  Ignored by the capacity
    # backends ("sort"/"dense"), which always ship capacity buffers.
    ragged_a2a: bool = True
    # group-sort implementation under every dispatch hop (sort backend's
    # position assignment, dropless sender layout, ragged receiver
    # re-compaction): "argsort" = XLA's generic O(A log A) sort (packed
    # single-operand lax.sort; the default — fastest on this CPU
    # container), "radix" = the one-pass O(A) Pallas counting sort over the
    # small group-id domain (repro.kernels.radix_sort — the TPU fast path;
    # interpret-validated off-TPU).  Bit-identical outputs either way; see
    # EXPERIMENTS.md §Perf-5 and tests/test_dispatch_conformance.py.
    sort_impl: str = "argsort"
    # routing-stage implementation, consumed where RouteDecision is built
    # (core/moe.py router_topk, shared by switch's flat hop and both SMILE
    # levels): "unfused" = separate fp32 GEMM + softmax + lax.top_k XLA ops
    # (the default — fastest on this CPU container), "fused" = the
    # single-pass Pallas routing megakernel (repro.kernels.router_fused —
    # GEMM, softmax, top-k, histogram and dispatch positions in one VMEM
    # pass, no logits round trip to HBM; the TPU fast path, interpret-
    # validated off-TPU).  Loss inputs (router probs/logits) stay
    # bit-compatible; see EXPERIMENTS.md §Perf-7 and
    # tests/test_dispatch_conformance.py.
    router_impl: str = "unfused"
    # ragged hops only: bound each hop's receive slab at ~factor x expected
    # arrivals (tile-aligned) instead of the zero-drop worst case of
    # n_ranks x R rows.  Arrivals beyond the bound are clamp-dropped (the
    # reverse hop echoes the clamped counts so senders know exactly which
    # rows returned) and reported in drop_frac; the post-hop FFN/router
    # bound shrinks ~n_ranks/factor-fold.  None = unbounded (bit-identical
    # zero-drop, the default).  Applies to every ragged hop — switch's flat
    # hop and both SMILE levels — through the shared HopSpec
    # (repro.core.pipeline).  Truncating hops stay on the native
    # lax.ragged_all_to_all where available: both sides pre-clamp their
    # paired sizes from the replicated count matrix
    # (comm.clamped_segment_counts), matching the emulations' prefix
    # truncation exactly.
    recv_bound_factor: Optional[float] = None
    # deterministic fault injection: "kind[@seed][:hop]" parsed by
    # repro.common.faultinject (counts | nanrows | dropseg | skew).  None =
    # no injection — the executor's fault hooks vanish and the layer is
    # bit-identical to the pre-harness pipeline (pinned by the golden
    # matrix).  Count-grid sanitization + fault_events accounting stay
    # active either way; only the *injection* is gated on this.
    fault_plan: Optional[str] = None
    # wire-integrity policy for every ragged exchange (repro.core.pipeline /
    # repro.sharding.comm checksummed_ragged_all_to_all): "off" traces the
    # exact production wire; "detect" appends per-segment parity rows,
    # verifies on arrival (both directions) and accounts
    # MoEStats.fault_events / wire_faults but passes payloads through;
    # "quarantine" additionally zero-fills flagged segments and drops their
    # assignments with exact per-(hop, src rank) accounting.  Requires the
    # dropless backend with ragged hops (nothing else puts segments on a
    # wire); single-rank hops are untouched (no wire to guard).
    wire_integrity: str = "off"

    def with_options(self, **kw) -> "MoEConfig":
        """Rebuild with runtime dispatch options swapped, validated against
        :data:`MOE_OPTIONS` — the single entry point every launcher and the
        deprecated ``configs.with_dispatch_backend`` shim route through.

        Only registered option fields are accepted; choice values are
        checked, and cross-option constraints (``recv_bound_factor``
        requires the dropless backend with ragged hops) are enforced on the
        *resulting* config so partial updates can't silently configure a
        knob onto a path that ignores it.
        """
        for key, val in kw.items():
            opt = MOE_OPTION_FIELDS.get(key)
            if opt is None:
                raise ValueError(
                    f"unknown MoE option {key!r}; registered options: "
                    f"{sorted(MOE_OPTION_FIELDS)}")
            if opt.kind == "choice" and val not in opt.choices:
                raise ValueError(f"{key}={val!r}: expected one of "
                                 f"{opt.choices}")
            if opt.kind == "bool" and not isinstance(val, bool):
                raise ValueError(f"{key}={val!r}: expected a bool")
            if opt.kind == "float" and val is not None:
                # bool is an int subclass: True would silently mean 1.0
                if (isinstance(val, bool)
                        or not isinstance(val, (int, float)) or val <= 0):
                    raise ValueError(f"{key}={val!r}: expected a positive "
                                     f"number or None")
            if opt.kind == "str" and val is not None:
                if not isinstance(val, str):
                    raise ValueError(f"{key}={val!r}: expected a string or "
                                     f"None")
                if key == "fault_plan":
                    # fail at config time, not silently mid-run (parse_
                    # fault_plan raises ValueError on malformed specs)
                    from repro_torch.common.faultinject import (
                        parse_fault_plan)
                    parse_fault_plan(val)
        cfg = dataclasses.replace(self, **kw)
        # registry-declared prerequisites, checked on the RESULT so partial
        # updates can't configure a knob onto a path that ignores it (an
        # option counts as active unless its value is the knob's inert
        # default: None, False, or the "off" choice)
        for opt in MOE_OPTIONS:
            if not opt.requires or getattr(cfg, opt.field) in (None, False,
                                                               "off"):
                continue
            for req_field, req_val in opt.requires:
                if getattr(cfg, req_field) != req_val:
                    raise ValueError(
                        f"{opt.field}={getattr(cfg, opt.field)!r} requires "
                        f"{req_field}={req_val!r}; got "
                        f"{getattr(cfg, req_field)!r}")
        return cfg


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block configuration."""

    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128                    # SSD chunk length


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV6 ("Finch") block configuration."""

    head_dim: int = 64
    decay_lora: int = 64                # rank of data-dependent decay LoRA
    mix_lora: int = 32                  # rank of token-shift mix LoRA


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    arch_type: str = "dense"            # dense|moe|hybrid|ssm|vlm|audio|mlm
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 32000
    head_dim: int = 0                   # 0 -> d_model // num_heads
    max_seq_len: int = 131072

    # --- attention flavour -------------------------------------------------
    attention: str = "full"             # full|sliding|mla|none
    causal: bool = True                 # False -> bidirectional (BERT/MLM)
    window: int = 8192                  # sliding-window size
    rope_theta: float = 10000.0
    use_rope: bool = True
    qkv_bias: bool = False              # qwen1.5 uses QKV bias
    norm: str = "rmsnorm"               # rmsnorm|layernorm
    act: str = "silu"                   # silu|gelu
    glu: bool = True                    # gated FFN (llama-style); False -> plain MLP
    tie_embeddings: bool = False
    # MLA (deepseek-v3) dims
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # --- block pattern ------------------------------------------------------
    # hybrid (zamba2): `ssm_layers_per_attn` mamba2 layers then 1 shared attn
    ssm_layers_per_attn: int = 6

    # --- sub-configs ---------------------------------------------------------
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None

    # --- multimodal stubs ----------------------------------------------------
    num_codebooks: int = 1              # musicgen: 4
    vision_tokens: int = 0              # phi-3-vision: image patch token budget
    vision_embed_dim: int = 0           # CLIP output dim before projector

    # --- extras ----------------------------------------------------------------
    mtp_depth: int = 0                  # deepseek-v3 multi-token prediction depth
    dtype: str = "bfloat16"             # compute dtype
    param_dtype: str = "float32"
    remat: bool = True                  # activation checkpointing over layer scan
    scan_layers: bool = True
    # beyond-paper knobs (see EXPERIMENTS.md §Perf):
    remat_save_collectives: bool = False  # don't re-psum during remat replay
    kv_seq_shard: bool = False            # decode: shard KV cache seq over tp
    # citation for the assigned config
    source: str = ""

    # ---------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def is_attention_free(self) -> bool:
        return self.attention == "none"

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-FLOPs accounting)."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        hd = self.resolved_head_dim
        total = V * d                                     # embeddings
        if not self.tie_embeddings:
            total += V * d                                # lm head
        for i in range(L):
            total += self._layer_params(i)
        if self.mtp_depth:
            total += self.mtp_depth * (self._layer_params(L - 1) + 2 * d * d)
        return total

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        if self.attention == "mla":
            qr, kvr = self.q_lora_rank, self.kv_lora_rank
            qk = self.qk_nope_head_dim + self.qk_rope_head_dim
            return (d * qr + qr * self.num_heads * qk
                    + d * (kvr + self.qk_rope_head_dim)
                    + kvr * self.num_heads * (self.qk_nope_head_dim + self.v_head_dim)
                    + self.num_heads * self.v_head_dim * d)
        q = d * self.num_heads * hd
        kv = 2 * d * self.num_kv_heads * hd
        o = self.num_heads * hd * d
        return q + kv + o

    def _ffn_params(self, d_ff: int) -> int:
        mult = 3 if self.glu else 2
        return mult * self.d_model * d_ff

    def _layer_params(self, i: int) -> int:
        d = self.d_model
        if self.arch_type == "ssm" and self.rwkv is not None:
            # rwkv6: time-mix ~ 4*d*d + decay/mix LoRAs, channel-mix 3*d*d
            r = self.rwkv
            tm = 4 * d * d + d * r.decay_lora * 2 + 5 * d * r.mix_lora * 2 + d * d
            cm = self.d_ff * d * 2 + d * d
            return tm + cm + 2 * d
        if self.arch_type == "hybrid" and self.ssm is not None:
            s = self.ssm
            d_in = s.expand * d
            nheads = d_in // s.head_dim
            mamba = (d * (2 * d_in + 2 * s.d_state * 0 + 0)
                     + d * (2 * d_in + 2 * s.d_state + nheads)  # in_proj (x,z,B,C,dt)
                     + d_in * d)                                 # out_proj
            per_group = self.ssm_layers_per_attn
            # shared attention amortized across groups
            shared = (self._attn_params() + self._ffn_params(self.d_ff)) / max(
                1, self.num_layers // per_group) / per_group
            return int(mamba + shared + 2 * d)
        ffn = self._ffn_params(self.d_ff)
        if self.moe is not None and self.moe.num_experts:
            is_moe = (i >= self.moe.first_dense_layers
                      and (i - self.moe.first_dense_layers) % self.moe.every_n_layers == 0)
            if is_moe:
                e_ffn = self._ffn_params(self.moe.d_ff_expert)
                ffn = (self.moe.num_experts + self.moe.num_shared_experts) * e_ffn
                ffn += self.moe.num_experts * self.d_model  # router
        return self._attn_params() + ffn + 2 * self.d_model

    def active_param_count(self) -> int:
        """Activated params per token (MoE: only top-k + shared experts)."""
        if self.moe is None or not self.moe.num_experts:
            return self.param_count()
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        total = V * d + (0 if self.tie_embeddings else V * d)
        for i in range(L):
            ffn = self._ffn_params(self.d_ff)
            is_moe = (i >= self.moe.first_dense_layers
                      and (i - self.moe.first_dense_layers) % self.moe.every_n_layers == 0)
            if is_moe:
                e_ffn = self._ffn_params(self.moe.d_ff_expert)
                ffn = (self.moe.top_k + self.moe.num_shared_experts) * e_ffn
                ffn += self.moe.num_experts * d
            total += self._attn_params() + ffn + 2 * d
        return total


@dataclass(frozen=True)
class TrainConfig:
    global_batch_size: int = 256
    micro_batch_size: int = 0           # 0 -> no gradient accumulation
    seq_len: int = 4096
    steps: int = 100
    optimizer: str = "lamb"             # lamb|adamw
    lr: float = 3e-4
    warmup_steps: int = 100
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    eps: float = 1e-6
    b1: float = 0.9
    b2: float = 0.999
    schedule: str = "cosine"            # cosine|linear|constant
    mlm_mask_prob: float = 0.15         # for MLM archs
    seed: int = 0
    log_every: int = 10
    ckpt_every: int = 0
    ckpt_keep: int = 3                  # keep-last-K checkpoint rotation
    ckpt_dir: str = ""
    # step sentinel (repro.train.sentinel): skip non-finite / loss-spike
    # optimizer updates inside jit; False keeps the pre-sentinel step path
    # verbatim (bit-identical)
    sentinel: bool = False


@dataclass(frozen=True)
class ServeConfig:
    batch_size: int = 8
    prompt_len: int = 128
    max_new_tokens: int = 32
    cache_len: int = 0                  # 0 -> prompt_len + max_new_tokens
    temperature: float = 0.0            # 0 -> greedy
    # continuous-batching engine knobs (SERVE_OPTIONS registry; see
    # repro.serve.engine and repro.serve.kvcache)
    page_size: int = 16                 # tokens per KV page
    pool_pages: int = 0                 # 0 -> n_slots * ceil(cache_len/page)
    n_slots: int = 8                    # fused decode batch (compiled once)
    prefill_buckets: str = ""           # csv chunk lens; "" -> doubling
    admit_policy: str = "fcfs"          # fcfs | sjf

    def resolved_cache_len(self) -> int:
        return self.cache_len or (self.prompt_len + self.max_new_tokens)

    def resolved_pool_pages(self) -> int:
        import math as _m
        per_seq = _m.ceil(self.resolved_cache_len() / self.page_size)
        return self.pool_pages or self.n_slots * per_seq


# The four assigned input shapes -------------------------------------------------
@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
