"""Paged KV cache: fixed-size pages in a preallocated pool, and page tables.
The port of ``repro.serve.kvcache``.

The device side is one pool ``{"pool_k", "pool_v"}`` of ``(pool_pages,
page_size, KV, hd)`` per attention block (``models.layers.
init_paged_kv_cache``, read and written by ``models.layers.
paged_attention``).  Sequences own pages only through a ``(rows,
max_pages)`` int32 page **table**, so evicting a sequence is a host-side
list operation: no cache copy and no zeroing (the ``s <= q_pos`` read mask
hides whatever an earlier owner left in a reused page).

The host side is :class:`PageAllocator`: a LIFO free list (freed pages are
reused first) with reservation-based admission: a request is admitted only
if ``ceil((prompt + max_new) / page_size)`` pages are free, so an admitted
sequence never runs out of pages mid-flight.

The caches hold the pools only.  :func:`inject_tables` gives a step the
same pools with a page table beside each (the tree
``models.transformer.forward`` reads); the serving engine builds that tree
over its static table buffers, which it rewrites in place between ticks.
:func:`strip_tables` takes the tables off again; :func:`clone_caches`
copies the pools (a check's scratch state).
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.common.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.sharding import specs as S
from repro_torch.sharding.plan import MeshPlan


def pages_needed(n_tokens: int, page_size: int) -> int:
    return max(1, math.ceil(n_tokens / page_size))


class PageAllocator:
    """Host-side page bookkeeping for one shared pool."""

    def __init__(self, pool_pages: int, page_size: int):
        assert pool_pages > 0 and page_size > 0
        self.pool_pages = pool_pages
        self.page_size = page_size
        self._free: List[int] = list(range(pool_pages - 1, -1, -1))

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def occupancy(self) -> float:
        return 1.0 - len(self._free) / self.pool_pages

    def can_fit(self, n_tokens: int) -> bool:
        return pages_needed(n_tokens, self.page_size) <= len(self._free)

    def alloc(self, n_tokens: int) -> Optional[List[int]]:
        """Reserve pages for ``n_tokens``; None if the pool can't fit them."""
        n = pages_needed(n_tokens, self.page_size)
        if n > len(self._free):
            return None
        pages, self._free = self._free[-n:], self._free[:-n]
        return pages[::-1]          # LIFO: most recently freed page first

    def free(self, pages: List[int]) -> None:
        for pg in pages:
            assert 0 <= pg < self.pool_pages
        assert not set(pages) & set(self._free), "double free"
        self._free.extend(pages)


# =============================================================================
# Device cache tree (per-stage lists of per-block pools, as
# transformer.init_caches)
# =============================================================================

def init_paged_caches(cfg0: ModelConfig, pool_pages: int, page_size: int,
                      plan: MeshPlan, *, device="cuda", mesh=None) -> Tuple:
    """Per-stage lists of per-block page pools.  Attention stages only:
    recurrent-state stages (rwkv, mamba) are gated out by the engine.

    With ``mesh`` (and its plan) each pool is the rank's slice under
    ``sharding.specs.cache_specs(..., batch=1)``, allocated at that shape:
    the KV heads cut over tp where they divide, every page on every rank
    (the pool has no batch dim, so it is replicated over dp)."""
    device = resolve_device(device)
    cfg = T._model_cfg(cfg0, plan)
    T._check_supported(cfg)
    kv = cfg.num_kv_heads
    if mesh is not None:
        full = L.init_paged_kv_cache(cfg, pool_pages, page_size,
                                     device="meta")
        spec = S.cache_specs(full, cfg, plan, 1)["pool_k"]
        kv = S.local_shape(tuple(full["pool_k"].shape), spec, mesh)[2]

    def pools(n):
        return [L.init_paged_kv_cache(cfg, pool_pages, page_size,
                                      device=device, kv_heads=kv)
                for _ in range(n)]

    out = []
    for st in T.build_stages(cfg):
        if st.kind not in ("dense", "moe", "pair"):
            raise ValueError(f"the paged KV cache takes attention stages "
                             f"only, got {st.kind!r}")
        if st.kind == "pair":
            out.append({"dense": pools(st.repeats), "moe": pools(st.repeats)})
        else:
            out.append(pools(st.repeats))
    return tuple(out)


def _map_blocks(caches: Tuple, fn) -> Tuple:
    return tuple({k: [fn(c) for c in v] for k, v in st.items()}
                 if isinstance(st, dict) else [fn(c) for c in st]
                 for st in caches)


def inject_tables(caches: Tuple, table: torch.Tensor) -> Tuple:
    """The same pools, each block's dict with ``table`` (rows, max_pages)
    beside them: the tree a paged forward reads."""
    return _map_blocks(caches, lambda c: {**c, "table": table})


def strip_tables(caches: Tuple) -> Tuple:
    return _map_blocks(caches, lambda c: {k: v for k, v in c.items()
                                          if k != "table"})


def clone_caches(caches: Tuple) -> Tuple:
    return _map_blocks(caches, lambda c: {k: v.clone() for k, v in c.items()})
