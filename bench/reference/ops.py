"""The plain reference's layers: float32 PyTorch, no kernels, no cache,
no batching tricks, and nothing of the program.

Pre-norm pieces as the port's models compute them: LayerNorm or RMSNorm
(eps 1e-5), GQA attention over the whole sequence (rotary positions where
``use_rope``; bidirectional where the config is not causal), a dense FFN
(GELU in its tanh form, or SiLU-gated).  ``bench/reference/<family>.py``
assembles them into a model, ``bench/reference/routers/<router>.py`` adds
a MoE layer.

``quant="fp8"`` is the control: every matmul that the program computes in
bf16 takes its operands rounded to fp8 (e4m3, a scale per tensor, a
straight-through gradient), the next precision below the configured one;
``quant="fp8kv"`` also rounds the keys and values attention reads (the
program's bf16 KV cache) to fp8.  TF32 is off while the reference runs
(:func:`fp32_exact`).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


@contextlib.contextmanager
def fp32_exact():
    """float32 matmuls in float32, not TF32, inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 at a per-tensor scale, gradient passed
    straight through."""
    s = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (t.detach() / s).to(torch.float8_e4m3fn).float() * s
    return t + (q - t.detach())


def mm(a: torch.Tensor, w: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    a, w = a.float(), w.float()
    if quant in ("fp8", "fp8kv"):
        a, w = fp8(a), fp8(w)
    return a @ w


def act(h: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(h)
    return F.gelu(h, approximate="tanh")


def norm(p: Dict, x: torch.Tensor, kind: str, eps: float = 1e-5):
    if kind == "layernorm":
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * p["scale"]


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, T, H, hd), pos (T,): the rotate-half form, fp32."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=x.device) / hd))
    ang = pos.float()[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(p: Dict, x: torch.Tensor, m: Dict, quant) -> torch.Tensor:
    """x (B, T, d) -> (B, T, d), over the whole sequence (causal where the
    config is), one KV head's query group at a time."""
    B, T, d = x.shape
    H, KV = m["num_heads"], m["num_kv_heads"]
    hd = m.get("head_dim") or d // H
    q = mm(x, p["wq"].reshape(d, H * hd), quant).reshape(B, T, H, hd)
    k = mm(x, p["wk"].reshape(d, KV * hd), quant).reshape(B, T, KV, hd)
    v = mm(x, p["wv"].reshape(d, KV * hd), quant).reshape(B, T, KV, hd)
    if m.get("use_rope", True):
        pos = torch.arange(T, device=x.device)
        theta = m.get("rope_theta", 10000.0)
        q, k = rope(q, pos, theta), rope(k, pos, theta)
    if quant == "fp8kv":
        k, v = fp8(k), fp8(v)
    g = H // KV
    outs = []
    for j in range(KV):
        qj = q[:, :, j * g:(j + 1) * g].transpose(1, 2)      # (B, g, T, hd)
        kj = k[:, :, j].unsqueeze(1)                          # (B, 1, T, hd)
        vj = v[:, :, j].unsqueeze(1)
        s = (qj @ kj.transpose(-1, -2)) / math.sqrt(hd)
        if m.get("causal", True):
            mask = torch.ones(T, T, dtype=torch.bool,
                              device=x.device).tril()
            s = s.masked_fill(~mask, float("-inf"))
        outs.append((torch.softmax(s, dim=-1) @ vj).transpose(1, 2))
    o = torch.cat(outs, dim=2).reshape(B, T, H * hd)
    return mm(o, p["wo"].reshape(H * hd, d), quant)


def dense_ffn(p: Dict, x: torch.Tensor, m: Dict, quant) -> torch.Tensor:
    h = act(mm(x, p["w1"], quant), m["act"])
    if "w3" in p:
        h = h * mm(x, p["w3"], quant)
    return mm(h, p["w2"], quant)
