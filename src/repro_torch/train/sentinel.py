"""The step sentinel: the port of ``repro.train.sentinel``.

Each step gets a health verdict before the optimizer sees it:

* **Non-finite** — any NaN or Inf in the loss or the reduced gradients
  (after the gradient psums and the clip, or ZeRO-1's owned chunks).
  Ranks hold different gradient slices, so the flag is psum'd over every
  mesh axis: every rank reaches the same verdict.
* **Loss spike** — after ``WARMUP_STEPS`` accepted steps, a loss above
  ``SPIKE_FACTOR`` times the EMA of accepted losses (the loss is
  replicated, so every rank judges it alike).
* **Router alarm** — a layer's load fraction above ``MAX_LOAD_THRESH`` or
  its normalized load entropy below ``ENTROPY_THRESH``: counted, never a
  reason to skip.

A bad step is skipped, not zeroed: :func:`gated_update` calls the
optimizer's update only on a good step, so on a bad one the parameters
and the optimizer state (ZeRO-1's chunks and step clock too) stay
bit-unchanged.  The JAX package picks a branch with ``lax.cond`` inside
the jitted step; the port's updates run in place, so it reads the
verdict on the host, once a step (the one sync the sentinel adds), and
does not call the update.  The verdict is the same on every rank, so the
ranks skip the optimizer's collectives together.

:class:`SentinelState` holds 7 fp32 scalars on the device and lands in
checkpoints under the reference's ``x/`` keys.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

import torch

from repro_torch.common import meta
from repro_torch.optim.optimizers import _chunks
from repro_torch.sharding import comm

EMA_DECAY = 0.99          # loss EMA decay per accepted step
SPIKE_FACTOR = 10.0       # loss > factor * EMA  ->  spike verdict
WARMUP_STEPS = 10         # accepted steps before the spike detector arms
MAX_LOAD_THRESH = 0.9     # f-vector max above this -> router alarm
ENTROPY_THRESH = 0.05     # normalized load entropy below this -> router alarm


@dataclasses.dataclass
class SentinelState:
    """The sentinel's carry: 0-dim fp32 tensors."""
    loss_ema: torch.Tensor       # EMA of accepted-step losses
    ema_steps: torch.Tensor      # accepted steps absorbed by the EMA
    steps: torch.Tensor          # total steps judged
    skipped: torch.Tensor        # steps whose update was skipped
    nonfinite: torch.Tensor      # non-finite verdicts
    spikes: torch.Tensor         # loss-spike verdicts
    router_alarms: torch.Tensor  # router-collapse watchdog alarms


FIELDS = tuple(f.name for f in dataclasses.fields(SentinelState))


def init_sentinel_state(device="cpu") -> SentinelState:
    return SentinelState(*(torch.zeros((), dtype=torch.float32,
                                       device=device) for _ in FIELDS))


def _nonfinite(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """True if any floating tensor holds a NaN or Inf (a chunk at a time:
    no temporary of a full stacked leaf)."""
    bad = None
    for t in tensors:
        if not t.is_floating_point():
            continue
        for c in _chunks(t.detach()):
            b = ~torch.isfinite(c).all()
            bad = b if bad is None else bad | b
    return bad


@torch.no_grad()
def step_verdict(loss: torch.Tensor, grads: Iterable[torch.Tensor],
                 sent: SentinelState, axes):
    """Judge one step: ``(ok, nonfinite, spike)``, 0-dim bool tensors,
    the same on every rank (the non-finite flag is psum'd over ``axes``,
    every mesh axis; the loss is replicated).  No host read."""
    bad = ~torch.isfinite(loss)
    more = _nonfinite(grads)
    if more is not None:
        bad = bad | more
    nonfinite = comm.psum(bad.float(), axes, label="psum.sentinel") > 0
    armed = sent.ema_steps >= WARMUP_STEPS
    spike = armed & torch.isfinite(loss) & (loss > SPIKE_FACTOR
                                            * sent.loss_ema)
    return ~(nonfinite | spike), nonfinite, spike


def router_alarm(max_load: torch.Tensor,
                 load_entropy: torch.Tensor) -> torch.Tensor:
    """The watchdog's verdict from the layer-worst ``MoEStats`` fields."""
    return (max_load > MAX_LOAD_THRESH) | (load_entropy < ENTROPY_THRESH)


@torch.no_grad()
def update_sentinel(sent: SentinelState, loss: torch.Tensor,
                    ok: torch.Tensor, nonfinite: torch.Tensor,
                    spike: torch.Tensor, alarm: torch.Tensor
                    ) -> SentinelState:
    """Fold one verdict into the carry.  The EMA moves only on accepted
    steps (a spike must not raise its own baseline); the first accepted
    steps seed it with the running mean rather than decaying from 0."""
    f = lambda b: b.to(torch.float32)
    n = sent.ema_steps
    seed_w = 1.0 / torch.clamp(n + 1.0, min=1.0)
    w = torch.clamp(seed_w, min=1.0 - EMA_DECAY)      # seed phase, then EMA
    loss = loss.to(torch.float32)
    ema = torch.where(ok, (1.0 - w) * sent.loss_ema + w * loss,
                      sent.loss_ema)
    return SentinelState(
        loss_ema=ema,
        ema_steps=n + f(ok),
        steps=sent.steps + 1.0,
        skipped=sent.skipped + f(~ok),
        nonfinite=sent.nonfinite + f(nonfinite),
        spikes=sent.spikes + f(spike),
        router_alarms=sent.router_alarms + f(alarm))


def gated_update(ok: torch.Tensor, update_fn, grads, opt_state, params):
    """``update_fn(grads, opt_state, params) -> (params, opt_state)`` where
    ``ok``, else ``(params, opt_state)`` as they are.  ``ok`` must be the
    same on every rank (:func:`step_verdict`): the update runs
    collectives.  Reads ``ok`` on the host (on the meta device the apply
    path: :func:`repro_torch.common.meta.verdict`)."""
    if meta.verdict(ok):
        return update_fn(grads, opt_state, params)
    return params, opt_state
