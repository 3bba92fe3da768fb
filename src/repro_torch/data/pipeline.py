"""Synthetic token data: the part of ``repro.data.pipeline`` the serving
path needs, copied (pure numpy) so the port never imports the JAX package.
Zipf-distributed unigrams mixed with short repeated n-grams, deterministic
in the numpy generator handed in."""
from __future__ import annotations

import numpy as np


def synthetic_tokens(rng: np.random.Generator, batch: int, seq: int,
                     vocab: int, *, ngram: int = 8) -> np.ndarray:
    """Zipf unigrams + repeated n-grams (learnable local structure)."""
    zipf = rng.zipf(1.3, size=(batch, seq)).astype(np.int64)
    toks = (zipf % (vocab - 8)) + 8           # reserve low ids for specials
    # overwrite ~50% of positions with repeats of the previous n-gram
    ngram = min(ngram, max(seq // 4, 1))
    n_rep = seq // (2 * ngram)
    if n_rep and seq - ngram > ngram:
        for b in range(batch):
            starts = rng.integers(ngram, seq - ngram, size=n_rep)
            for s in starts:
                toks[b, s:s + ngram] = toks[b, s - ngram:s]
    return toks.astype(np.int32)
