"""Model building blocks: the port of ``repro.models.layers``.

Conventions kept from the JAX package so tests compare like with like:
activations ``(B, T, d)``, attention heads ``(B, T, H, hd)``, projection
weights ``(d, H, hd)`` / ``(H, hd, d)``.  Collectives go through
:mod:`repro_torch.sharding.comm` (the identity on one device).

Under tensor parallelism (``plan.tp > 1``) every leaf is the rank's slice
(``sharding.specs``): the embedding, the LM head and the logits hold the
rank's part of the vocabulary, attention its query heads (and its KV heads
where they divide over ``tp``), dense FFNs their ``d_ff`` columns; code
reads dims off the tensors, never off the config, and a psum over ``tp``
adds the parts.

Dtypes follow the reference, with one difference of form: the reference
casts matmul weights to the activation dtype at every use, and here the
caller casts them once at load
(:func:`repro_torch.models.transformer.cast_for_compute`, same bits), so the
projections and FFNs use them as given.  Norms and the LM head compute in
fp32.

The cache-less (with the flash kernel behind ``use_kernel``), ring-buffer
cache (its sequence cut over tp under ``kv_seq_shard``) and paged cache
(the serving engine) attention paths are ported, and deepseek-v3's latent
attention (:func:`mla_forward`: the naive path and the absorbed decode over
a latent ring cache; like the reference it never takes the flash kernel).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.sharding import comm
from repro_torch.sharding.plan import MeshPlan


def _norm_init(d: int, kind: str, device=None) -> Dict:
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def apply_norm(p: Dict, x: torch.Tensor, kind: str,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:
        var = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * p["scale"]
    return y.to(x.dtype)


def dense_init(shape, *, generator: torch.Generator, scale=None,
               device=None, dtype=torch.float32) -> torch.Tensor:
    """A normal draw in fp32 times ``scale`` (1/sqrt(fan-in) by default),
    stored in ``dtype``: the same bits as casting the fp32 leaf afterwards,
    without holding both (the draw is scaled in place)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    w = torch.randn(shape, generator=generator, device=device)
    return w.mul_(scale).to(dtype)


# =============================================================================
# Rotary position embedding
# =============================================================================

def rope_frequencies(dim: int, theta: float, device=None) -> torch.Tensor:
    # theta stays a Python scalar: a tensor made from it on the card would be
    # a blocking host-to-device copy in every attention call
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., T, H, hd); positions: (T,) shared or (B, T) per-row
    absolute positions.  The rotation runs in fp32."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)                # (hd/2,)
    ang = positions.float()[..., :, None] * freqs                # (..., T, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if positions.dim() == 1:
        cos, sin = cos[None], sin[None]
    cos = cos[..., :, None, :]                    # (B|1, T, 1, hd/2)
    sin = sin[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# =============================================================================
# Embedding + LM head
# =============================================================================

def init_embedding(cfg: ModelConfig, plan: MeshPlan, *,
                   generator: torch.Generator, device=None) -> Dict:
    return {"table": dense_init((cfg.vocab_size, cfg.d_model),
                                generator=generator, scale=0.02,
                                device=device)}


def embed_tokens(p: Dict, ids: torch.Tensor, plan: MeshPlan,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """Vocab-parallel table lookup, then a cast to ``dtype`` (the
    reference's order).  Under tp the table holds this rank's rows of the
    vocabulary: an id outside them reads zeros, and the psum over tp adds
    the one rank's row."""
    table = p["table"]
    if plan.tp > 1:
        v_loc = table.shape[0]
        local = ids.long() - comm.axis_index(plan.tp_axis) * v_loc
        hit = (local >= 0) & (local < v_loc)
        emb = table[local.clamp(0, v_loc - 1)] * hit[..., None].to(
            table.dtype)
    else:
        emb = table[ids.long()]
    return comm.psum(emb, plan.tp_axis).to(dtype)


def output_logits(p: Dict, x: torch.Tensor, plan: MeshPlan) -> torch.Tensor:
    """Logits (..., V_loc), this rank's part of the vocabulary; fp32."""
    w = p["table"] if "table" in p else p["w"]                # tied or separate
    return x.float() @ w.float().t()


def vocab_parallel_xent(logits: torch.Tensor, labels: torch.Tensor,
                        plan: MeshPlan) -> torch.Tensor:
    """Cross-entropy over vocab-sharded fp32 logits (..., V_loc) against
    global vocab ids (...,); returns the per-position loss.  Max, sum of
    exponentials and the label's logit are each reduced over tp; the max
    shift is kept out of autograd, and a label outside this rank's
    vocabulary (or ``IGNORE = -1``) is never used as an index (it is
    clamped, and its pick is zeroed; the caller masks an ignored loss)."""
    v = logits.shape[-1]
    m = comm.pmax(logits.detach().amax(-1), plan.tp_axis)
    lse = torch.log(comm.psum(torch.exp(logits - m[..., None]).sum(-1),
                              plan.tp_axis)) + m
    local = labels - comm.axis_index(plan.tp_axis) * v
    hit = (local >= 0) & (local < v)
    picked = logits.gather(-1, local.clamp(0, v - 1).long()[..., None])[..., 0]
    return lse - comm.psum(picked * hit.to(logits.dtype), plan.tp_axis)


# =============================================================================
# Dense FFN
# =============================================================================

def init_ffn(cfg: ModelConfig, d_ff: Optional[int] = None, *,
             generator: torch.Generator, device=None,
             dtype=torch.float32) -> Dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    kw = dict(generator=generator, device=device, dtype=dtype)
    p = {"w1": dense_init((d, f), **kw), "w2": dense_init((f, d), **kw)}
    if cfg.glu:
        p["w3"] = dense_init((d, f), **kw)
    return p


def row_parallel(h: torch.Tensor, w: torch.Tensor,
                 plan: MeshPlan) -> torch.Tensor:
    """``h @ w`` with the contracted dim cut over tp (an output
    projection): each rank's partial product in the activation dtype,
    psum'd over tp in that dtype, as the reference rounds and sums it
    (``repro/models/layers.py:153, 340``), forward and backward (the
    cotangent's psum runs in the same dtype).  The plain product on one
    rank."""
    return comm.psum(h @ w, plan.tp_axis)


def ffn_forward(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                plan: MeshPlan) -> torch.Tensor:
    h = ref.activation(x @ p["w1"], cfg.act)
    if "w3" in p:
        h = h * (x @ p["w3"])
    return comm.name_saved(row_parallel(h, p["w2"], plan))


# =============================================================================
# Streaming-softmax attention core, plain torch
# =============================================================================

def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                      causal: bool, window: int = 0, chunk: int = 1024,
                      use_kernel: bool = False, return_partial: bool = False):
    """O(T*chunk)-memory attention in fp32.

    q: (B, Tq, H, hd); k/v: (B, Tk, KV, hd) with KV | H (GQA).  ``q_pos``
    (Tq,), ``k_pos`` (Tk,) absolute positions; cache slots with a negative
    position are masked out.  Keys are streamed in chunks of ``chunk`` with
    a running max and sum; the reference pads the last chunk with masked
    keys, which add exact zeros, so the port does not pad.

    ``return_partial`` returns the softmax partials ``(m, l, acc)`` (B,
    Tq, KV, g) fp32 twice and (B, Tq, KV, g, dv) fp32 in place of the
    output, for :func:`merge_attention_partials` to merge across ranks
    that each hold a slice of the keys.

    ``use_kernel`` with causal, unwindowed, ``Tq == Tk`` attention takes
    the flash kernel (:func:`repro_torch.kernels.ops.flash_attention`), as
    the reference's gate does; like the reference, that branch ignores the
    positions and assumes ``0..T-1`` (the cache-less forward).
    """
    if use_kernel and causal and window == 0 and q.shape[1] == k.shape[1]:
        return kops.flash_attention(q, k, v)
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = H // KV
    scale = 1.0 / math.sqrt(hd)
    qf = (q * scale).float().reshape(B, Tq, KV, g, hd)
    m = torch.full((B, Tq, KV, g), -1e30, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Tq, KV, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Tq, KV, g, dv), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, Tk, chunk):
        kb = k[:, c0:c0 + chunk].float()
        vb = v[:, c0:c0 + chunk].float()
        pb = k_pos[c0:c0 + chunk]
        s = torch.einsum("btkgh,bckh->btkgc", qf, kb)
        mask = (pb >= 0)[None, None, None, None, :]
        dq = q_pos[:, None] - pb[None, :]                       # (Tq, c)
        if causal:
            mask = mask & (dq >= 0)[None, :, None, None, :]
        if window:
            mask = mask & (dq < window)[None, :, None, None, :]
        s = torch.where(mask, s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("btkgc,bckh->btkgh", p, vb)
        m = m_new
    if return_partial:
        return m, l, acc
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Tq, H, dv).to(q.dtype)


def merge_attention_partials(m: torch.Tensor, l: torch.Tensor,
                             acc: torch.Tensor, axes, out_shape,
                             dtype) -> torch.Tensor:
    """Flash-decoding merge of the softmax partials of
    :func:`chunked_attention` (``return_partial=True``) over ``axes``, each
    rank holding a slice of the keys: the pmax of the running maxima, then
    the psum of each rank's sum and accumulator rescaled to it.  Returns
    the output reshaped to ``out_shape`` in ``dtype``."""
    m_g = comm.pmax(m, axes)
    corr = torch.exp(m - m_g)
    l_g = comm.psum(l * corr, axes)
    acc_g = comm.psum(acc * corr[..., None], axes)
    out = acc_g / torch.clamp(l_g, min=1e-30)[..., None]
    return out.reshape(out_shape).to(dtype)


# =============================================================================
# GQA attention with ring-buffer KV cache
# =============================================================================

def init_attention(cfg: ModelConfig, *, generator: torch.Generator,
                   device=None, dtype=torch.float32) -> Dict:
    """GQA projections, drawn fp32 and stored in ``dtype``."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    kw = dict(generator=generator, device=device, dtype=dtype)
    p = {
        "wq": dense_init((d, H, hd), **kw),
        "wk": dense_init((d, KV, hd), **kw),
        "wv": dense_init((d, KV, hd), **kw),
        "wo": dense_init((H, hd, d), scale=1.0 / math.sqrt(H * hd), **kw),
    }
    if cfg.qkv_bias:
        for name, heads in (("bq", H), ("bk", KV), ("bv", KV)):
            p[name] = torch.zeros((heads, hd), dtype=torch.float32,
                                  device=device)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("btd,dhk->bthk") as one matmul over the flattened heads."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(
        x.shape[0], x.shape[1], h, k)


def _kv_slice_for_my_heads(kv: torch.Tensor, h_loc: int, cfg: ModelConfig,
                           plan: MeshPlan) -> torch.Tensor:
    """Where the KV heads do not divide over tp (they stay replicated),
    the ones backing this rank's ``h_loc`` query heads."""
    H, KV = cfg.num_heads, cfg.num_kv_heads
    need = max(1, (h_loc * KV) // H)
    if kv.shape[2] == need:
        return kv
    start = (comm.axis_index(plan.tp_axis) * h_loc * KV) // H
    return kv[:, :, start:start + need]


def attention_forward(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                      plan: MeshPlan, *, positions: torch.Tensor,
                      cache: Optional[Dict] = None, window: int = 0,
                      use_kernel: bool = False
                      ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, T, d) -> (B, T, d).  With ``cache``, writes this step's K/V
    into the ring buffer at ``positions % W`` and attends over the cache;
    otherwise attends over x.

    A paged cache (``pool_k``/``pool_v`` and a page ``table``, see
    :func:`paged_attention`) takes per-row ``positions`` (B, T).

    Under ``cfg.kv_seq_shard`` with tp > 1 the ring cache is cut along its
    sequence over tp (:func:`seq_sharded_attention`).

    The ring-cache and paged writes update the cache tensors in place (the
    JAX package returns new arrays and donates the old ones); the returned
    cache is the same dict.
    """
    B, T, _ = x.shape
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    h_loc = q.shape[2]
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        out = chunked_attention(q, _kv_slice_for_my_heads(k, h_loc, cfg, plan),
                                _kv_slice_for_my_heads(v, h_loc, cfg, plan),
                                positions, positions, causal=cfg.causal,
                                window=window, use_kernel=use_kernel)
        new_cache = None
    elif "pool_k" in cache:
        out, new_cache = paged_attention(q, k, v, cache, positions, cfg,
                                         plan, window=window)
    elif cfg.kv_seq_shard and plan.tp > 1:
        out = seq_sharded_attention(q, k, v, cache, positions, cfg, plan,
                                    window=window)
        new_cache = cache
    else:
        W = cache["k"].shape[1]
        slot = (positions % W).long()                            # (T,)
        cache["k"][:, slot] = k.to(cache["k"].dtype)
        cache["v"][:, slot] = v.to(cache["v"].dtype)
        cache["pos"][slot] = positions.to(cache["pos"].dtype)
        out = chunked_attention(
            q, _kv_slice_for_my_heads(cache["k"], h_loc, cfg, plan),
            _kv_slice_for_my_heads(cache["v"], h_loc, cfg, plan), positions,
            cache["pos"], causal=cfg.causal, window=window)
        new_cache = cache
    H, hd, d = p["wo"].shape
    y = row_parallel(out.reshape(B, T, H * hd), p["wo"].reshape(H * hd, d),
                     plan)
    return comm.name_saved(y), new_cache


def seq_sharded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          cache: Dict, positions: torch.Tensor,
                          cfg: ModelConfig, plan: MeshPlan, *,
                          window: int = 0) -> torch.Tensor:
    """Attention over a ring cache whose sequence dim is cut over tp
    (flash decoding; the reference's ``kv_seq_shard`` branch).

    Each rank owns ``Wl = W / tp`` consecutive ring slots, ``cache["k"]``/
    ``["v"]`` (B, Wl, KV, hd) with every KV head (the KV projections are
    replicated) and ``cache["pos"]`` (Wl,).  Position ``s`` goes to ring
    slot ``s % W``, which this rank writes only where it falls in its
    slice (the reference's ``mode="drop"``, masked explicitly).  The
    queries, cut by head over tp, are all-gathered; each rank attends over
    its slice with every head, the partials are merged over tp, and the
    rank keeps its own heads.  q: (B, T, h_loc, hd); k/v: (B, T, KV, hd);
    ``positions`` (T,).  Returns (B, T, h_loc, hd); the cache is updated in
    place."""
    Wl = cache["k"].shape[1]
    i = comm.axis_index(plan.tp_axis)
    slot = (positions % (Wl * plan.tp) - i * Wl).long()         # (T,)
    mine = (slot >= 0) & (slot < Wl)
    for name, new in (("k", k), ("v", v)):
        # the ring's slot dim first, so a slot is one row of the write
        _masked_rows_write(cache[name].transpose(0, 1), slot, mine,
                           new.transpose(0, 1).to(cache[name].dtype))
    _masked_rows_write(cache["pos"], slot, mine,
                       positions.to(cache["pos"].dtype))
    h_loc = q.shape[2]
    q_full = comm.all_gather(q, plan.tp_axis, axis=2)         # (B, T, H, hd)
    m, l, acc = chunked_attention(q_full, cache["k"], cache["v"], positions,
                                  cache["pos"], causal=cfg.causal,
                                  window=window, return_partial=True)
    out = merge_attention_partials(
        m, l, acc, plan.tp_axis,
        (q.shape[0], q.shape[1], q_full.shape[2], cache["v"].shape[-1]),
        q.dtype)
    return out[:, :, i * h_loc:(i + 1) * h_loc]


def init_attention_cache(cfg: ModelConfig, batch: int, length: int,
                         plan: MeshPlan, dtype=torch.bfloat16,
                         device=None) -> Dict:
    """Ring-buffer cache sized ``length``; ``pos`` -1 marks empty slots.
    ``batch`` is this rank's; under tp the cache holds this rank's KV heads
    where they divide over tp, all of them where they do not, and under
    ``kv_seq_shard`` all of them over ``length / tp`` slots (the rank's
    slice of the global cache, ``sharding.specs.cache_specs``)."""
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    tp = max(plan.tp, 1)
    if cfg.kv_seq_shard and tp > 1:
        if length % tp:
            raise ValueError(f"a sequence-sharded cache of {length} slots "
                             f"does not split over {tp} ranks")
        length //= tp
    elif KV % tp == 0:
        KV //= tp
    return {
        "k": torch.zeros((batch, length, KV, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, length, KV, hd), dtype=dtype, device=device),
        "pos": torch.full((length,), -1, dtype=torch.int32, device=device),
    }


# =============================================================================
# Paged KV cache: page-pool scatter write + page-table gather read
# =============================================================================

def init_paged_kv_cache(cfg: ModelConfig, pool_pages: int, page_size: int,
                        dtype=torch.bfloat16, device=None,
                        kv_heads: Optional[int] = None) -> Dict:
    """One layer's page pool, ``(pool_pages, page_size, KV, hd)``, with no
    batch dim: sequences own pages through the page ``table`` that the
    serving engine adds to the cache dict (``serve.kvcache.inject_tables``).
    ``kv_heads`` (default all of them) is a rank's count over a mesh."""
    KV, hd = kv_heads or cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (pool_pages, page_size, KV, hd)
    return {"pool_k": torch.zeros(shape, dtype=dtype, device=device),
            "pool_v": torch.zeros(shape, dtype=dtype, device=device)}


def _masked_rows_write(pool: torch.Tensor, idx: torch.Tensor,
                       ok: torch.Tensor, val: torch.Tensor) -> None:
    """``pool[idx[i]] = val[i]`` for the rows where ``ok``, in place, and no
    write for the others (the reference's ``mode="drop"``), without reading
    ``ok`` on the host.  Each dropped row is sent to the first kept row's
    slot with that row's value, so the duplicate writes agree; with no row
    kept, to slot 0 with slot 0's own value."""
    # index_select, not idx[first]: a 0-dim index tensor is read on the host
    first = ok.to(torch.int32).argmax().reshape(1)
    any_ok = ok.any()
    tgt = torch.where(any_ok, idx.index_select(0, first), 0)
    fill = torch.where(any_ok, val.index_select(0, first)[0], pool[0])
    idx = torch.where(ok, idx, tgt)
    val = torch.where(ok.reshape((-1,) + (1,) * (val.dim() - 1)), val, fill)
    pool.index_put_((idx,), val)


def paged_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    cache: Dict, positions: torch.Tensor, cfg: ModelConfig,
                    plan: MeshPlan, *, window: int = 0
                    ) -> Tuple[torch.Tensor, Dict]:
    """Paged-KV attention step: write this tick's K/V into the page pool,
    gather each sequence's view through its page-table row, and attend with
    a direct fp32 softmax over the view.

    q/k/v: (B, T, h, hd) fresh (rope-applied) projections; ``positions``
    (B, T) per-row absolute positions, **-1 marks a dead row**: its write is
    dropped and its output is finite garbage the caller ignores.  cache:
    ``pool_k``/``pool_v`` (P, page, KV, hd) plus ``table`` (B, max_pages)
    int32 of sequence-ordered page ids; an entry ``>= P`` (the engine's
    sentinel ``P``) or ``< 0`` is unmapped.

    Rows whose position is dead, lies past the table, or maps to an
    unmapped entry are not written (the reference sends them to page ``P``
    with ``mode="drop"``; here they are masked explicitly).  The pools are
    updated in place.  Index ``s`` of a row's gathered view is sequence
    position ``s``, so the one mask ``s <= q_pos`` gives causality and hides
    what an earlier owner left in a reused page.
    """
    if not cfg.causal:
        raise ValueError("the paged attention path is causal-only")
    pool_k, pool_v, table = cache["pool_k"], cache["pool_v"], cache["table"]
    P, page = pool_k.shape[0], pool_k.shape[1]
    B, T, H, hd = q.shape
    mp = table.shape[1]
    KVs = k.shape[2]

    # ---- write: token (b, t) at position s -> (table[b, s // page],
    # s % page), flattened to one row index of the (P * page) pool rows
    ps = positions.clamp(min=0).long()
    slot = ps // page
    pidx = table.long().gather(1, slot.clamp(max=mp - 1))
    ok = (positions >= 0) & (slot < mp) & (pidx >= 0) & (pidx < P)
    row = (pidx * page + ps % page).reshape(-1)
    ok = ok.reshape(-1)
    for pool, new in ((pool_k, k), (pool_v, v)):
        _masked_rows_write(pool.view(P * page, KVs, hd), row, ok,
                           new.reshape(B * T, KVs, hd).to(pool.dtype))

    # ---- gather read: (B, mp, page, KV, hd) -> per-sequence (B, Lk) views;
    # where the KV heads do not divide over tp, the ones this rank's query
    # heads read
    tbl = table.long().clamp(0, P - 1)
    Lk = mp * page
    k_view = _kv_slice_for_my_heads(pool_k[tbl].reshape(B, Lk, KVs, hd), H,
                                    cfg, plan).float()
    v_view = _kv_slice_for_my_heads(pool_v[tbl].reshape(B, Lk, KVs, hd), H,
                                    cfg, plan).float()
    KV = k_view.shape[2]

    # ---- direct fp32 softmax over the view
    g = H // KV
    scale = 1.0 / math.sqrt(hd)
    qf = (q * scale).float().reshape(B, T, KV, g, hd)
    s = torch.einsum("btkgh,bskh->btkgs", qf, k_view)
    sidx = torch.arange(Lk, device=q.device)
    qp = positions[:, :, None, None, None]
    mask = sidx <= qp
    if window:
        mask = mask & ((qp - sidx) < window)
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    out = torch.einsum("btkgs,bskh->btkgh", e, v_view)
    out = out / torch.clamp(e.sum(-1), min=1e-30)[..., None]
    return out.reshape(B, T, H, hd).to(q.dtype), cache


# =============================================================================
# MLA: multi-head latent attention (deepseek-v3)
# =============================================================================

def init_mla(cfg: ModelConfig, *, generator: torch.Generator, device=None,
             dtype=torch.float32) -> Dict:
    """The low-rank query and KV projections and the per-head up
    projections: ``wq_a`` (d, qr), ``wq_b`` (qr, H, nope+rope), ``wkv_a``
    (d, kvr+rope), ``wk_b`` (kvr, H, nope), ``wv_b`` (kvr, H, vhd), ``wo``
    (H, vhd, d)."""
    d, H = cfg.d_model, cfg.num_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    vhd = cfg.v_head_dim
    kw = dict(generator=generator, device=device, dtype=dtype)
    return {
        "wq_a": dense_init((d, qr), **kw),
        "wq_b": dense_init((qr, H, nope + rope), **kw),
        "wkv_a": dense_init((d, kvr + rope), **kw),
        "wk_b": dense_init((kvr, H, nope), **kw),
        "wv_b": dense_init((kvr, H, vhd), **kw),
        "wo": dense_init((H, vhd, d), scale=1.0 / math.sqrt(H * vhd), **kw),
    }


def init_mla_cache(cfg: ModelConfig, batch: int, length: int,
                   plan: MeshPlan, dtype=torch.bfloat16,
                   device=None) -> Dict:
    """The latent ring cache: ``ckv`` (B, W, kvr) and ``kpe`` (B, W, rope),
    bf16 whatever the compute dtype (the reference's ``init_caches``
    passes no dtype), and ``pos`` (W,), -1 marking empty slots.  Every
    rank holds all of it for its rows: the latent has no heads."""
    return {
        "ckv": torch.zeros((batch, length, cfg.kv_lora_rank), dtype=dtype,
                           device=device),
        "kpe": torch.zeros((batch, length, cfg.qk_rope_head_dim),
                           dtype=dtype, device=device),
        "pos": torch.full((length,), -1, dtype=torch.int32, device=device),
    }


def _scale_in(dtype: torch.dtype, scale: float) -> float:
    """``scale`` rounded to ``dtype``: JAX multiplies an array by a Python
    float in the array's dtype, so a bf16 score is scaled by the bf16
    value of the scale (PyTorch would keep it in fp32)."""
    return float(torch.tensor(scale, dtype=dtype))


def mla_forward(p: Dict, x: torch.Tensor, cfg: ModelConfig, plan: MeshPlan,
                *, positions: torch.Tensor, cache: Optional[Dict] = None,
                window: int = 0) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Latent attention (``repro.models.layers.mla_forward``): x (B, T, d)
    -> (B, T, d).  The cache holds only the latent ``ckv`` and the shared
    rope key ``kpe`` of each token, written at ``positions % W`` in place.

    A cached single-token step takes the absorbed path: ``wk_b`` is folded
    into the query and ``wv_b`` into the output, so the scores run over the
    latent directly; they are scaled in the compute dtype, then softmaxed
    in fp32 over the slots at ``0 <= pos <= positions[-1]``.  Otherwise
    (a prompt, or no cache) the naive path rebuilds each head's keys and
    values from the latent and runs :func:`chunked_attention` (keys of
    nope+rope, values of vhd).  Under tp each rank holds its heads of
    ``wq_b``, ``wk_b``, ``wv_b`` and ``wo``, and the output is summed over
    tp.  A bf16 cache read in fp32 compute is widened, as JAX promotes
    it."""
    B, T, _ = x.shape
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    kvr = cfg.kv_lora_rank
    q = _proj(x @ p["wq_a"], p["wq_b"])                     # (B, T, h, n+r)
    q_nope = q[..., :nope]
    q_rope = apply_rope(q[..., nope:], positions, cfg.rope_theta)
    kv = x @ p["wkv_a"]
    ckv = kv[..., :kvr]
    k_pe = apply_rope(kv[..., None, kvr:], positions, cfg.rope_theta)[:, :, 0]
    if cache is not None:
        slot = (positions % cache["ckv"].shape[1]).long()
        cache["ckv"][:, slot] = ckv.to(cache["ckv"].dtype)
        cache["kpe"][:, slot] = k_pe.to(cache["kpe"].dtype)
        cache["pos"][slot] = positions.to(cache["pos"].dtype)
        ckv_all, kpe_all, cpos = cache["ckv"], cache["kpe"], cache["pos"]
    else:
        ckv_all, kpe_all, cpos = ckv, k_pe, positions
    dt = torch.promote_types(x.dtype, ckv_all.dtype)
    wk_b, wv_b = p["wk_b"], p["wv_b"]
    if cache is not None and T == 1:
        q_lat = torch.einsum("bthk,rhk->bthr", q_nope, wk_b)   # (B, 1, h, r)
        s = (torch.einsum("bthr,bsr->bths", q_lat.to(dt), ckv_all.to(dt))
             + torch.einsum("bthk,bsk->bths", q_rope.to(dt),
                            kpe_all.to(dt)))
        s = (s * _scale_in(s.dtype, 1.0 / math.sqrt(nope + rope))).float()
        last = positions[-1]
        mask = (cpos >= 0) & (cpos <= last)
        if window:
            mask = mask & ((last - cpos) < window)
        s = torch.where(mask, s, torch.full_like(s, -1e30))
        a = torch.softmax(s, dim=-1)
        o_lat = torch.einsum("bths,bsr->bthr", a, ckv_all.float())
        out = torch.einsum("bthr,rhk->bthk", o_lat.to(x.dtype), wv_b)
    else:
        lat = ckv_all.to(dt)
        k_nope = torch.einsum("btr,rhk->bthk", lat, wk_b.to(dt))
        v = torch.einsum("btr,rhk->bthk", lat, wv_b.to(dt))
        k = torch.cat([k_nope, kpe_all.to(dt)[:, :, None, :].expand(
            -1, -1, k_nope.shape[2], -1)], dim=-1)
        out = chunked_attention(torch.cat([q_nope, q_rope], dim=-1), k, v,
                                positions, cpos, causal=cfg.causal,
                                window=window)
    H, vhd, d = p["wo"].shape
    y = row_parallel(out.reshape(B, T, H * vhd).to(x.dtype),
                     p["wo"].reshape(H * vhd, d), plan)
    return comm.name_saved(y), cache
