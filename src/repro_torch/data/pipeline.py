"""Data pipeline: the port of ``repro.data.pipeline``, copied (pure numpy)
so the port never imports the JAX package.

A deterministic synthetic corpus — Zipf-distributed unigrams mixed with
short repeated n-grams, a learnable stand-in for C4 — and task-specific
batching.  The stream is deterministic in (seed, step) and prefetched by a
background thread.  Every batch is equal, array for array, to the JAX
package's.

Batch layouts:
  causal LM  : tokens (B, S)      labels = tokens shifted left, last = -1
  MLM (paper): tokens (B, S) with [MASK]=4 swaps; labels = original at masked
               positions, -1 elsewhere (15%, 80/10/10 — BERT recipe)
  musicgen   : tokens (B, K, S) with the delay pattern; labels shifted left
  phi-3-vision: causal LM + image patch embeddings and positions
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np

from repro_torch.common.config import ModelConfig

MASK_ID = 4
IGNORE = -1


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


def mlm_mask(rng: np.random.Generator, tokens: np.ndarray, vocab: int,
             prob: float = 0.15):
    """BERT-style masking: 15% positions; 80% [MASK] / 10% random / 10% keep."""
    mask = rng.random(tokens.shape) < prob
    labels = np.where(mask, tokens, IGNORE).astype(np.int32)
    r = rng.random(tokens.shape)
    corrupted = tokens.copy()
    corrupted[mask & (r < 0.8)] = MASK_ID
    rand_sel = mask & (r >= 0.8) & (r < 0.9)
    corrupted[rand_sel] = rng.integers(8, vocab, size=int(rand_sel.sum()))
    return corrupted.astype(np.int32), labels


def _delay_pattern(tokens: np.ndarray) -> np.ndarray:
    """MusicGen delay interleave: codebook k is shifted right by k steps."""
    B, K, S = tokens.shape
    out = np.zeros_like(tokens)
    for k in range(K):
        out[:, k, k:] = tokens[:, k, :S - k]
    return out


def make_batch(cfg: ModelConfig, batch: int, seq: int, seed: int,
               step: int, mlm_prob: float = 0.15) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    if cfg.num_codebooks > 1:
        toks = np.stack([synthetic_tokens(rng, batch, seq, cfg.vocab_size)
                         for _ in range(cfg.num_codebooks)], axis=1)
        toks = _delay_pattern(toks)
        labels = np.full_like(toks, IGNORE)
        labels[..., :-1] = toks[..., 1:]
        return {"tokens": toks, "labels": labels}
    toks = synthetic_tokens(rng, batch, seq, cfg.vocab_size)
    if not cfg.causal:                      # MLM (the paper's task)
        corrupted, labels = mlm_mask(rng, toks, cfg.vocab_size, mlm_prob)
        return {"tokens": corrupted, "labels": labels}
    labels = np.full_like(toks, IGNORE)
    labels[:, :-1] = toks[:, 1:]
    out = {"tokens": toks, "labels": labels}
    if cfg.vision_tokens:
        P = cfg.vision_tokens
        out["image_embeds"] = rng.standard_normal(
            (batch, P, cfg.vision_embed_dim)).astype(np.float32)
        out["image_pos"] = np.tile(np.arange(1, P + 1, dtype=np.int32),
                                   (batch, 1))
        out["labels"][:, :P + 1] = IGNORE   # don't train on image positions
    return out


class DataPipeline:
    """Background-prefetching batch iterator (deterministic in seed+step)."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                 mlm_prob: float = 0.15, prefetch: int = 2):
        self.cfg, self.batch, self.seq = cfg, batch, seq
        self.seed, self.mlm_prob = seed, mlm_prob
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = 0
        while not self._stop.is_set():
            b = make_batch(self.cfg, self.batch, self.seq, self.seed, step,
                           self.mlm_prob)
            try:
                self._q.put(b, timeout=1.0)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        return self._q.get()

    def close(self):
        self._stop.set()
