"""Model building blocks: the port of ``repro.models.layers``.

Conventions kept from the JAX package so tests compare like with like:
activations ``(B, T, d)``, attention heads ``(B, T, H, hd)``, projection
weights ``(d, H, hd)`` / ``(H, hd, d)``.  Collectives go through
:mod:`repro_torch.sharding.comm` (the identity on one device).

Dtypes follow the reference, with one difference of form: the reference
casts matmul weights to the activation dtype at every use, and here the
caller casts them once at load
(:func:`repro_torch.models.transformer.cast_for_compute`, same bits), so the
projections and FFNs use them as given.  Norms and the LM head compute in
fp32.

This slice ports the cache-less and ring-buffer-cache attention paths; the
paged cache (the serving engine), the sequence-sharded cache and MLA raise.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.common.config import ModelConfig
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
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    w = torch.randn(shape, generator=generator, device=device)
    return (w * scale).to(dtype)


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
    """Table lookup, then a cast to ``dtype`` (the reference's order)."""
    emb = p["table"][ids.long()]
    return comm.psum(emb, plan.tp_axis).to(dtype)


def output_logits(p: Dict, x: torch.Tensor, plan: MeshPlan) -> torch.Tensor:
    """Logits (..., V); fp32."""
    w = p["table"] if "table" in p else p["w"]                # tied or separate
    return x.float() @ w.float().t()


# =============================================================================
# Dense FFN
# =============================================================================

def init_ffn(cfg: ModelConfig, d_ff: Optional[int] = None, *,
             generator: torch.Generator, device=None) -> Dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = {"w1": dense_init((d, f), generator=generator, device=device),
         "w2": dense_init((f, d), generator=generator, device=device)}
    if cfg.glu:
        p["w3"] = dense_init((d, f), generator=generator, device=device)
    return p


def ffn_forward(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                plan: MeshPlan) -> torch.Tensor:
    h = ref.activation(x @ p["w1"], cfg.act)
    if "w3" in p:
        h = h * (x @ p["w3"])
    y = h @ p["w2"]
    return comm.name_saved(comm.psum(y, plan.tp_axis))


# =============================================================================
# Streaming-softmax attention core, plain torch
# =============================================================================

def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                      causal: bool, window: int = 0, chunk: int = 1024,
                      use_kernel: bool = False) -> torch.Tensor:
    """O(T*chunk)-memory attention in fp32.

    q: (B, Tq, H, hd); k/v: (B, Tk, KV, hd) with KV | H (GQA).  ``q_pos``
    (Tq,), ``k_pos`` (Tk,) absolute positions; cache slots with a negative
    position are masked out.  Keys are streamed in chunks of ``chunk`` with
    a running max and sum; the reference pads the last chunk with masked
    keys, which add exact zeros, so the port does not pad.

    The flash kernel (``use_kernel`` with causal, unwindowed, ``Tq == Tk``
    attention) is not ported yet; no path of this slice reaches it.
    """
    if use_kernel and causal and window == 0 and q.shape[1] == k.shape[1]:
        raise NotImplementedError(
            "the flash attention kernel is not ported yet; call "
            "chunked_attention with use_kernel=False")
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
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Tq, H, dv).to(q.dtype)


# =============================================================================
# GQA attention with ring-buffer KV cache
# =============================================================================

def init_attention(cfg: ModelConfig, *, generator: torch.Generator,
                   device=None) -> Dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    kw = dict(generator=generator, device=device)
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


def attention_forward(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                      plan: MeshPlan, *, positions: torch.Tensor,
                      cache: Optional[Dict] = None, window: int = 0,
                      use_kernel: bool = False
                      ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, T, d) -> (B, T, d).  With ``cache``, writes this step's K/V
    into the ring buffer at ``positions % W`` and attends over the cache;
    otherwise attends over x.

    The ring-cache write updates the cache tensors in place (the JAX
    package returns new arrays and donates the old ones); the returned
    cache is the same dict.
    """
    if cache is not None and "pool_k" in cache:
        raise NotImplementedError("the paged KV cache (serving engine) is "
                                  "not ported yet")
    if cache is not None and cfg.kv_seq_shard and plan.tp > 1:
        raise NotImplementedError("the sequence-sharded KV cache needs "
                                  "tensor parallelism, not ported yet")
    B, T, _ = x.shape
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        out = chunked_attention(q, k, v, positions, positions,
                                causal=cfg.causal, window=window,
                                use_kernel=use_kernel)
        new_cache = None
    else:
        W = cache["k"].shape[1]
        slot = (positions % W).long()                            # (T,)
        cache["k"][:, slot] = k.to(cache["k"].dtype)
        cache["v"][:, slot] = v.to(cache["v"].dtype)
        cache["pos"][slot] = positions.to(cache["pos"].dtype)
        out = chunked_attention(q, cache["k"], cache["v"], positions,
                                cache["pos"], causal=cfg.causal,
                                window=window)
        new_cache = cache
    H, hd, d = p["wo"].shape
    y = out.reshape(B, T, H * hd) @ p["wo"].reshape(H * hd, d)
    return comm.name_saved(comm.psum(y, plan.tp_axis)), new_cache


def init_attention_cache(cfg: ModelConfig, batch: int, length: int,
                         plan: MeshPlan, dtype=torch.bfloat16,
                         device=None) -> Dict:
    """Ring-buffer cache sized ``length``; ``pos`` -1 marks empty slots."""
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, length, KV, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, length, KV, hd), dtype=dtype, device=device),
        "pos": torch.full((length,), -1, dtype=torch.int32, device=device),
    }
