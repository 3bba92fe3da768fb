"""The benchmark's one traffic generator, driven by the mix files.

Every seed gets the same work.  Lengths are the quantiles of the mix's
clipped lognormal at ``n`` evenly spaced points, prompts paired with
outputs by a fixed shuffle; arrival gaps of an open loop come from the
mix's ``arrivals`` process (``bench/traffic/<arrivals>.py``: its
``gaps(mix, rate, n)``, e.g. the exponential's quantiles in
``poisson.py``), in a fixed shuffled order.  The seed draws the token
ids (and permutes a closed loop's blocks), so two seeds differ in
content, never in the amount of work, and a run's spread is the
system's.

The mix's ``driver`` runs it (``bench/core/<driver>_driver.py``):

* ``kind: open`` (``serve``): arrivals in three phases, each its own
  quantile set in its own fixed order: the ramp before the window, the
  window, and the tail that keeps the load on while the window's requests
  drain.
* ``kind: closed`` (``serve``): a queue of requests in blocks of
  ``clients``, each block the same quantile set in a new order.
* ``train``: the synthetic MLM stream below, a copy of the port's
  ``data/pipeline.py`` stream (Zipf unigrams with repeated n-grams, BERT's
  80/10/10 masking), deterministic in ``(seed, step)``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist
from typing import Dict, List

import numpy as np

from bench.core import plugins

MASK_ID = 4
IGNORE = -1
FIRST_ID = 8          # ids below are the specials of the stream


def _rng(seed: int, *tag: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, *tag]))


def lengths(dist: Dict, n: int) -> np.ndarray:
    """``n`` quantiles of the lognormal with ``median`` and ``sigma``,
    clipped to ``[min, max]``, ascending (int64)."""
    nd = NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    x = np.exp(math.log(dist["median"]) + dist["sigma"] * z)
    return np.clip(np.rint(x), dist["min"], dist["max"]).astype(np.int64)


@dataclass
class Req:
    due: float              # seconds after the loop starts (open loop)
    prompt: np.ndarray      # int32 token ids
    max_new: int
    phase: str              # ramp | window | tail (open), queue (closed)


def _pairs(mix: Dict, n: int) -> np.ndarray:
    """(n, 2) prompt and output lengths: quantile sets paired by a fixed
    shuffle (the same for every seed)."""
    p = lengths(mix["prompt"], n)
    o = lengths(mix["output"], n)
    return np.stack([p, o[_rng(0, n).permutation(n)]], axis=1)


def _prompts(rng: np.random.Generator, lens, vocab: int) -> List[np.ndarray]:
    return [rng.integers(FIRST_ID, vocab, size=int(s)).astype(np.int32)
            for s in lens]


def open_loop(mix: Dict, rate: float, seed: int, vocab: int,
              phases: Dict[str, float]) -> List[Req]:
    """The open loop's requests, in order of their due times.  ``phases``
    maps ramp, window and tail to their seconds.  The schedule (which
    lengths arrive after which gaps) is the same for every seed: a tail
    over a few dozen requests under queueing moves with the order as much
    as with the system; the seed draws the token ids."""
    out: List[Req] = []
    t = 0.0
    for tag, (phase, dur) in enumerate(phases.items()):
        n = max(1, int(round(rate * dur)))
        order = _rng(0, 1, tag)
        pairs = _pairs(mix, n)[order.permutation(n)]
        g = plugins.arrivals(mix).gaps(mix, rate, n)[order.permutation(n)]
        prompts = _prompts(_rng(seed, 1, tag), pairs[:, 0], vocab)
        start = t
        for i in range(n):
            t += g[i]
            out.append(Req(t, prompts[i], int(pairs[i, 1]), phase))
        # the phase's gaps span its length on average; the next phase
        # starts at its nominal time whatever this one's sum came to
        t = start + dur
    return out


def closed_queue(mix: Dict, clients: int, blocks: int, seed: int,
                 vocab: int) -> List[Req]:
    """``blocks`` blocks of ``clients`` requests for a closed loop."""
    out: List[Req] = []
    base = _pairs(mix, clients)
    for b in range(blocks):
        rng = _rng(seed, 2, b)
        pairs = base[rng.permutation(clients)]
        prompts = _prompts(rng, pairs[:, 0], vocab)
        out += [Req(0.0, p, int(o), "queue")
                for p, o in zip(prompts, pairs[:, 1])]
    return out


# -----------------------------------------------------------------------------
# The MLM stream (a copy of the port's data/pipeline.py synthetic stream)
# -----------------------------------------------------------------------------

def synthetic_tokens(rng: np.random.Generator, batch: int, seq: int,
                     vocab: int, *, ngram: int = 8) -> np.ndarray:
    """Zipf unigrams with ~half the positions repeats of the n-gram before."""
    zipf = rng.zipf(1.3, size=(batch, seq)).astype(np.int64)
    toks = (zipf % (vocab - FIRST_ID)) + FIRST_ID
    ngram = min(ngram, max(seq // 4, 1))
    n_rep = seq // (2 * ngram)
    if n_rep and seq - ngram > ngram:
        for b in range(batch):
            for s in rng.integers(ngram, seq - ngram, size=n_rep):
                toks[b, s:s + ngram] = toks[b, s - ngram:s]
    return toks.astype(np.int32)


def mlm_mask(rng: np.random.Generator, tokens: np.ndarray, vocab: int,
             prob: float):
    """``prob`` of the positions are targets: 80% [MASK], 10% a random
    id, 10% kept; labels hold the original there and ``IGNORE`` elsewhere."""
    mask = rng.random(tokens.shape) < prob
    labels = np.where(mask, tokens, IGNORE).astype(np.int32)
    r = rng.random(tokens.shape)
    out = tokens.copy()
    out[mask & (r < 0.8)] = MASK_ID
    rand = mask & (r >= 0.8) & (r < 0.9)
    out[rand] = rng.integers(FIRST_ID, vocab, size=int(rand.sum()))
    return out.astype(np.int32), labels


def mlm_batch(mix: Dict, vocab: int, mask_prob: float, seed: int,
              step: int) -> Dict[str, np.ndarray]:
    """Step ``step``'s batch of the stream seeded ``seed``."""
    rng = _rng(seed, 3, step)
    toks = synthetic_tokens(rng, mix["batch"], mix["seq"], vocab,
                            ngram=mix.get("ngram", 8))
    tokens, labels = mlm_mask(rng, toks, vocab, mask_prob)
    return {"tokens": tokens, "labels": labels}
