"""RWKV6 ("Finch") block: the port of ``repro.models.rwkv6``.

Attention-free, with a data-dependent decay.  Time-mix: a per-head state
``S (hd, hd)`` with ``S_t[i, j] = w_t[i] S_{t-1}[i, j] + k_t[i] v_t[j]`` and
readout ``y_t[j] = sum_i r_t[i] (S_{t-1}[i, j] + u[i] k_t[i] v_t[j])``,
where ``w_t = exp(-exp(w0 + lora_w(x)))``.  Channel-mix is the squared-ReLU
RWKV FFN.

Both mixes compute in fp32 from fp32 weights, whatever the activation dtype
(the reference casts ``x`` up and uses its weights as they are); only the
time-mix output projection ``wo`` is used in the activation dtype, which
:func:`repro_torch.models.transformer.cast_block` casts once at load.

The recurrence runs two ways, as in the reference:

* cache-less with ``use_kernel`` (the scoring forward): the WKV6 kernel,
  :func:`repro_torch.kernels.ops.rwkv6_scan`;
* otherwise (training, prefill and decode with a cache): the plain
  recurrence, :func:`repro_torch.kernels.ref.rwkv6_scan_ref`, which is the
  reference's ``lax.scan`` step for step.  Serving never launches the
  kernel.

A cache (:func:`init_rwkv_cache`) holds the WKV state and the last token's
features of each mix; the forwards update it in place and return it.

Under tensor parallelism (``sharding.specs``) a rank holds its heads of
the time mix (the r/k/v/g projections, the decay's ``w0`` and
``decay_b``, the bonus ``u``, the group norm and the rows of ``wo``) and
its ``d_ff`` columns of the channel mix; the token-shift mixes and both
LoRAs' first factors are replicated.  Each mix's output is the psum of the
ranks' partial products over tp, and the WKV state holds the rank's heads.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.models.layers import _proj, dense_init
from repro_torch.sharding import comm
from repro_torch.sharding import specs as S
from repro_torch.sharding.plan import MeshPlan

MIXES = ("r", "k", "v", "w", "g")

# The group norm's eps over each head's outputs.  Larger than a LayerNorm's
# 1e-5 on purpose (the reference's choice, EXPERIMENTS.md §Num-1): early in
# a sequence ``y`` is near rank one across hd and its variance ~0, and
# eps=1e-5 would amplify last-ulp differences by up to ~316x.
GN_EPS = 1e-3


def init_rwkv_tmix(cfg: ModelConfig, *, generator: torch.Generator,
                   device=None) -> Dict:
    d = cfg.d_model
    r = cfg.rwkv
    nh, hd = d // r.head_dim, r.head_dim
    kw = dict(generator=generator, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "mu": torch.full((5, d), 0.5, **f32),          # static shift mixes
        "mix_a": dense_init((d, 5 * r.mix_lora), scale=0.01, **kw),
        "mix_b": dense_init((5, r.mix_lora, d), scale=0.01, **kw),
        "wr": dense_init((d, nh, hd), **kw),
        "wk": dense_init((d, nh, hd), **kw),
        "wv": dense_init((d, nh, hd), **kw),
        "wg": dense_init((d, nh, hd), **kw),
        "w0": torch.full((nh, hd), -1.0, **f32),
        "decay_a": dense_init((d, r.decay_lora), scale=0.01, **kw),
        "decay_b": dense_init((r.decay_lora, nh, hd), scale=0.01, **kw),
        "u": torch.zeros((nh, hd), **f32),             # bonus ("time_faaaa")
        "ln_x": {"scale": torch.ones((nh, hd), **f32),
                 "bias": torch.zeros((nh, hd), **f32)},
        "wo": dense_init((nh, hd, d), **kw),
    }


def _token_shift(x: torch.Tensor,
                 x_prev: Optional[torch.Tensor]) -> torch.Tensor:
    """The previous token's features: zeros (or the cache's last token) at
    position 0."""
    if x_prev is None:
        x_prev = torch.zeros_like(x[:, :1])
    return torch.cat([x_prev, x[:, :-1]], dim=1)


def rwkv_tmix_forward(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                      plan: MeshPlan, *, cache: Optional[Dict] = None,
                      use_kernel: bool = False
                      ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, T, d) -> (B, T, d) in x's dtype.  With ``cache``, starts from
    its state and writes the new state and last token into it."""
    B, T, d = x.shape
    r = cfg.rwkv
    xf = x.float()
    prev = _token_shift(xf, None if cache is None else cache["x_prev_t"])
    dx = prev - xf
    # data-dependent interpolation between x and x_prev, one mix per use
    lora = torch.tanh((xf @ p["mix_a"]).reshape(B, T, 5, r.mix_lora))
    mixes = p["mu"] + torch.einsum("btml,mld->btmd", lora, p["mix_b"])
    xs = xf[:, :, None, :] + dx[:, :, None, :] * mixes      # (B, T, 5, d)
    xr, xk, xv, xw, xg = xs.unbind(2)

    rv = _proj(xr, p["wr"])                                  # (B, T, nh, hd)
    kv = _proj(xk, p["wk"])
    vv = _proj(xv, p["wv"])
    gv = F.silu(_proj(xg, p["wg"]))
    dec = p["w0"] + _proj(torch.tanh(xw @ p["decay_a"]), p["decay_b"])
    w = torch.exp(-torch.exp(dec))                           # in (0, 1)

    nh, hd = rv.shape[2], rv.shape[3]
    s0 = (cache["wkv"].float() if cache is not None
          else torch.zeros((B, nh, hd, hd), dtype=torch.float32,
                           device=x.device))
    scan = (kops.rwkv6_scan if use_kernel and cache is None
            else ref.rwkv6_scan_ref)
    y, s_last = scan(rv, kv, vv, w, p["u"], s0)

    # per-head group norm, then the gate and the output projection
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) ** 2).mean(-1, keepdim=True)
    y = ((y - mu) * torch.rsqrt(var + GN_EPS) * p["ln_x"]["scale"]
         + p["ln_x"]["bias"])
    y = (y * gv).to(x.dtype)
    out = y.reshape(B, T, nh * hd) @ p["wo"].reshape(nh * hd, d)
    out = comm.name_saved(comm.psum(out, plan.tp_axis))

    if cache is not None:
        cache["wkv"].copy_(s_last)
        cache["x_prev_t"].copy_(xf[:, -1:])
    return out, cache


def init_rwkv_cmix(cfg: ModelConfig, *, generator: torch.Generator,
                   device=None) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    kw = dict(generator=generator, device=device)
    return {
        "mu_k": torch.full((d,), 0.5, dtype=torch.float32, device=device),
        "mu_r": torch.full((d,), 0.5, dtype=torch.float32, device=device),
        "wk": dense_init((d, f), **kw),
        "wv": dense_init((f, d), **kw),
        "wr": dense_init((d, d), **kw),
    }


def rwkv_cmix_forward(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                      plan: MeshPlan, *, cache: Optional[Dict] = None
                      ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Squared-ReLU channel mix in fp32; x's dtype out."""
    xf = x.float()
    prev = _token_shift(xf, None if cache is None else cache["x_prev_c"])
    dx = prev - xf
    xk = xf + dx * p["mu_k"]
    xr = xf + dx * p["mu_r"]
    k = torch.square(torch.relu(xk @ p["wk"]))               # (B, T, f)
    kv = comm.name_saved(comm.psum(k @ p["wv"], plan.tp_axis))
    rr = torch.sigmoid(xr @ p["wr"])
    out = (rr * kv).to(x.dtype)
    if cache is not None:
        cache["x_prev_c"].copy_(xf[:, -1:])
    return out, cache


def init_rwkv_cache(cfg: ModelConfig, batch: int, plan: MeshPlan, *,
                    device=None) -> Dict:
    """One block's decode cache: the WKV state and each mix's last token,
    fp32.  ``batch`` is this rank's; under tp the state holds this rank's
    heads (``sharding.specs.cache_specs``)."""
    d = cfg.d_model
    hd = cfg.rwkv.head_dim
    nh = d // hd
    if S.rwkv_heads_divide(cfg, plan):
        nh //= max(plan.tp, 1)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "wkv": torch.zeros((batch, nh, hd, hd), **f32),
        "x_prev_t": torch.zeros((batch, 1, d), **f32),
        "x_prev_c": torch.zeros((batch, 1, d), **f32),
    }
