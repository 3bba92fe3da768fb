"""Mamba2 (SSD, the state-space dual) block: the port of
``repro.models.mamba2``, used by zamba2's hybrid stage.

A single group: the B/C state projections are shared by every head and
computed replicated.  Under tensor parallelism (``sharding.specs``) a rank
holds its heads: the columns of ``wx``, ``wz`` and ``wdt``, the rows of
``conv_x`` and ``wo``, its entries of ``A_log``, ``D``, ``dt_bias`` and
the gated norm's scale; the gated norm's mean square is psum'd over tp and
the output projection is row-parallel.

The projections and the convolutions run in the activation dtype (their
weights cast once at load, or inside the remat region in training:
:func:`repro_torch.models.transformer.cast_block`, the names in
:data:`CAST`); the SSD runs in fp32 from fp32 ``A_log``, ``D`` and
``dt_bias``.  A prompt (or a cache-less call) takes the chunked SSD: the
intra-chunk terms (:func:`ssd_intra_chunk`, the computation of the
``ssd_chunk`` kernel, which the reference's model does not call and
neither does the port's) and a recurrence over the chunks; a cached
single-token call takes the O(1) step.  Both leave the same cache
(:func:`init_mamba2_cache`), so a prefill hands off to decode.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.models.layers import dense_init, row_parallel
from repro_torch.sharding import comm
from repro_torch.sharding.plan import MeshPlan

# the matmul and convolution weights, used in the activation dtype (the
# reference casts each at its use)
CAST = ("wx", "wz", "wB", "wC", "wdt", "wo", "conv_x", "conv_B", "conv_C")


def init_mamba2(cfg: ModelConfig, *, generator: torch.Generator,
                device=None, dtype=torch.float32) -> Dict:
    """The block's 13 leaves; those in :data:`CAST` stored in ``dtype``,
    the rest fp32 (``A_log`` and ``dt_bias`` zeros, ``D`` and the gated
    norm's scale ones)."""
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    nh = d_in // s.head_dim
    kw = dict(generator=generator, device=device, dtype=dtype)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "wx": dense_init((d, d_in), **kw),
        "wz": dense_init((d, d_in), **kw),
        "wB": dense_init((d, s.d_state), **kw),
        "wC": dense_init((d, s.d_state), **kw),
        "wdt": dense_init((d, nh), **kw),
        "conv_x": dense_init((d_in, s.d_conv), scale=0.5, **kw),
        "conv_B": dense_init((s.d_state, s.d_conv), scale=0.5, **kw),
        "conv_C": dense_init((s.d_state, s.d_conv), scale=0.5, **kw),
        "A_log": torch.zeros((nh,), **f32),
        "D": torch.ones((nh,), **f32),
        "dt_bias": torch.zeros((nh,), **f32),
        "norm": {"scale": torch.ones((d_in,), **f32)},
        "wo": dense_init((d_in, d), **kw),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv.  x: (B, T, C); w: (C, W).  Returns ``(y,
    new_state)``, the state the trailing W-1 inputs, in the dtype of the
    state's and x's concatenation (JAX's promotion: a bf16 state before
    fp32 inputs comes back fp32)."""
    B, T, C = x.shape
    W = w.shape[1]
    if state is None:
        state = x.new_zeros((B, W - 1, C))
    dt = torch.promote_types(state.dtype, x.dtype)
    xp = torch.cat([state.to(dt), x.to(dt)], dim=1)          # (B, T+W-1, C)
    y = sum(xp[:, j:j + T] * w[:, j].to(x.dtype) for j in range(W))
    return y, xp[:, -(W - 1):]


def ssd_intra_chunk(xh: torch.Tensor, dt: torch.Tensor, loga: torch.Tensor,
                    Bc: torch.Tensor, Cc: torch.Tensor):
    """The chunked SSD's intra-chunk terms, fp32 (``ssd_chunk``'s
    signature and outputs).  xh: (B, nc, Q, nh, hd); dt/loga: (B, nc, Q,
    nh); Bc/Cc: (B, nc, Q, ds).  Returns ``(y_intra (B, nc, Q, nh, hd), sB
    (B, nc, nh, hd, ds), a_chunk (B, nc, nh))``:
    ``y_intra[i] = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j``, each
    chunk's state from its own steps and its total decay.  The exponent is
    set to -inf above the diagonal before ``exp`` (a product masked after
    it would be ``inf * 0`` there)."""
    Q = xh.shape[2]
    cs = torch.cumsum(loga, dim=2)                               # (B,nc,Q,nh)
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)             # (B,nc,Q,Q)
    decay = cs[:, :, :, None, :] - cs[:, :, None, :, :]          # (B,nc,i,j,nh)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=xh.device).tril()
    decay = torch.where(mask[None, None, :, :, None], decay,
                        torch.full_like(decay, -math.inf))
    w_ij = torch.exp(decay) * scores[..., None]
    y_intra = torch.einsum("bcijh,bcjh,bcjhp->bcihp", w_ij, dt, xh)
    tail = cs[:, :, -1:, :] - cs                                 # decay to end
    sB = torch.einsum("bcjh,bcjh,bcjhp,bcjn->bchpn", torch.exp(tail), dt, xh,
                      Bc)
    return y_intra, sB, torch.exp(cs[:, :, -1, :])


def mamba2_forward(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                   plan: MeshPlan, *, cache: Optional[Dict] = None
                   ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, T, d) -> (B, T, d) in x's dtype; the rank's heads over tp.
    With ``cache`` the SSM and conv states start from it and the new ones
    are written into it (its entries replaced: a conv state takes the
    dtype of :func:`_causal_conv`'s result).  ``T`` must be a multiple of
    ``min(chunk, T)`` unless it is a cached single-token step."""
    s = cfg.ssm
    B, T, _ = x.shape
    hd, ds = s.head_dim, s.d_state
    xs, z = x @ p["wx"], x @ p["wz"]                    # (B, T, d_in_loc)
    Bp, Cp = x @ p["wB"], x @ p["wC"]                   # replicated
    dt = x @ p["wdt"]                                   # (B, T, nh_loc)

    conv_state = cache or {}
    xs, st_x = _causal_conv(xs, p["conv_x"], conv_state.get("conv_x"))
    Bp, st_B = _causal_conv(Bp, p["conv_B"], conv_state.get("conv_B"))
    Cp, st_C = _causal_conv(Cp, p["conv_C"], conv_state.get("conv_C"))
    xs, Bp, Cp = F.silu(xs), F.silu(Bp), F.silu(Cp)

    nh = dt.shape[-1]
    xh = xs.reshape(B, T, nh, hd).float()
    dt = F.softplus(dt.float() + p["dt_bias"])                   # (B, T, nh)
    loga = dt * -torch.exp(p["A_log"])                           # <= 0
    Bf, Cf = Bp.float(), Cp.float()
    ssm0 = (cache["ssm"].float() if cache is not None
            else x.new_zeros((B, nh, hd, ds), dtype=torch.float32))

    if T == 1 and cache is not None:
        # the O(1) decode step
        a = torch.exp(loga[:, 0])                                # (B, nh)
        dx = dt[:, 0, :, None] * xh[:, 0]                        # (B, nh, hd)
        ssm = (a[..., None, None] * ssm0
               + dx[..., None] * Bf[:, 0, None, None, :])
        y = torch.einsum("bhpn,bn->bhp", ssm, Cf[:, 0])
        y = (y + p["D"][None, :, None] * xh[:, 0]).reshape(B, 1, nh * hd)
    else:
        Q = min(s.chunk, T)
        if T % Q:
            raise ValueError(f"T={T} must be divisible by ssd chunk {Q}")
        nc = T // Q
        xq = xh.reshape(B, nc, Q, nh, hd)
        lq = loga.reshape(B, nc, Q, nh)
        Cq = Cf.reshape(B, nc, Q, ds)
        y_intra, sB, a_chunk = ssd_intra_chunk(
            xq, dt.reshape(B, nc, Q, nh), lq, Bf.reshape(B, nc, Q, ds), Cq)
        # the inter-chunk recurrence, keeping the state before each chunk
        h, h_prev = ssm0, []
        for c in range(nc):
            h_prev.append(h)
            h = a_chunk[:, c, :, None, None] * h + sB[:, c]
        y_inter = torch.einsum("bcin,bchpn,bcih->bcihp", Cq,
                               torch.stack(h_prev, 1),
                               torch.exp(torch.cumsum(lq, dim=2)))
        y = y_intra + y_inter + p["D"][None, None, None, :, None] * xq
        y = y.reshape(B, T, nh * hd)
        ssm = h

    # gated RMSNorm over the whole d_inner: the feature dim is cut over tp,
    # so the sum of squares is psum'd over it
    y = y.to(x.dtype) * F.silu(z)
    yf = y.float()
    ss = comm.psum((yf * yf).sum(-1, keepdim=True), plan.tp_axis)
    denom = yf.shape[-1] * max(plan.tp, 1)
    y = (yf * torch.rsqrt(ss / denom + 1e-5)
         * p["norm"]["scale"]).to(x.dtype)
    out = comm.name_saved(row_parallel(y, p["wo"], plan))

    if cache is not None:
        cache.update(ssm=ssm.float(), conv_x=st_x, conv_B=st_B, conv_C=st_C)
    return out, cache


def init_mamba2_cache(cfg: ModelConfig, batch: int, plan: MeshPlan,
                      dtype=torch.bfloat16, device=None) -> Dict:
    """One block's decode cache: the SSM state ``ssm`` (B, nh, hd, ds) in
    fp32 and the conv states (B, d_conv - 1, C) in ``dtype``, bf16
    whatever the compute dtype (the reference's default).  ``batch`` is
    this rank's; under tp the state holds its heads and ``conv_x`` its
    ``d_inner`` slice (``sharding.specs.cache_specs``)."""
    s = cfg.ssm
    tp = max(plan.tp, 1)
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    W = s.d_conv - 1
    return {
        "ssm": torch.zeros((batch, nh // tp, s.head_dim, s.d_state),
                           dtype=torch.float32, device=device),
        "conv_x": torch.zeros((batch, W, d_in // tp), dtype=dtype,
                              device=device),
        "conv_B": torch.zeros((batch, W, s.d_state), dtype=dtype,
                              device=device),
        "conv_C": torch.zeros((batch, W, s.d_state), dtype=dtype,
                              device=device),
    }
