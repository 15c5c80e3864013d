"""Paged KV cache: fixed-size pages plus per-sequence block tables
(counterpart of turboinfer_tpu/engine/paged_cache.py).

The device holds one pool of [page_size]-token pages per layer and kv
head; each sequence maps its positions to pages through a row of the
block table, so cache memory follows the tokens in use, not batch x
max_seq. The allocator and the prefix pool are host Python with the JAX
package's page-id order, so both packages hand out the same pages for
the same operations. append_token and gather_sequence are the plain
reference ops; the serving path writes pages in the model's paged
forward and reads them with the paged attention kernel.

Layout: pages [L, P, Hkv, page, D]; block_table [B, max_pages] int32
(-1 = unassigned); lengths [B] int32. Pools hold the model dtype, bf16,
int8 with per-(token, head) f32 scale pages [L, P, Hkv, page] (pages
carry their scales, so prefix-shared pages share them too), or fp8 as
uint8 e4m3 bits.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from turboinfer_tpu_torch.config import ModelConfig
from turboinfer_tpu_torch.models.common import (COMPRESSED_KV, decode_kv,
                                                encode_kv_scaled)
from turboinfer_tpu_torch.utils.device import resolve_device


class PagedKVCache(NamedTuple):
    k_pages: torch.Tensor        # [L, P, Hkv, page, D]
    v_pages: torch.Tensor
    block_table: torch.Tensor    # [B, max_pages] int32
    lengths: torch.Tensor        # [B] int32
    # int8 pools only: f32 [L, P, Hkv, page] (value = code * scale)
    k_scale_pages: Optional[torch.Tensor] = None
    v_scale_pages: Optional[torch.Tensor] = None

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[3]


def init_paged_cache(config: ModelConfig, batch_size: int, num_pages: int,
                     page_size: int = 64, max_seq: Optional[int] = None,
                     dtype=None, device="cuda") -> PagedKVCache:
    dev = resolve_device(device)
    dtype = dtype or config.dtype
    if dtype not in (torch.float32, torch.bfloat16, torch.float16,
                     *COMPRESSED_KV):
        raise ValueError(f"paged KV pool dtype {dtype} is not a cache "
                         "storage dtype (see models/common.resolve_kv_dtype)")
    T = max_seq or config.max_seq_len
    max_pages = -(-T // page_size)
    shape = (config.num_layers, num_pages, config.kv_heads, page_size,
             config.head_dim_)
    ks = vs = None
    if dtype == torch.int8:
        ks = torch.zeros(shape[:-1], dtype=torch.float32, device=dev)
        vs = torch.zeros(shape[:-1], dtype=torch.float32, device=dev)
    return PagedKVCache(
        k_pages=torch.zeros(shape, dtype=dtype, device=dev),
        v_pages=torch.zeros(shape, dtype=dtype, device=dev),
        block_table=torch.full((batch_size, max_pages), -1,
                               dtype=torch.int32, device=dev),
        lengths=torch.zeros((batch_size,), dtype=torch.int32, device=dev),
        k_scale_pages=ks, v_scale_pages=vs)


class PageAllocator:
    """Host-side free-list allocator for page ids."""

    def __init__(self, num_pages: int):
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self.num_pages = num_pages

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int = 1) -> List[int]:
        if n > len(self._free):
            raise RuntimeError(
                f"KV page pool exhausted: need {n}, have {len(self._free)}")
        return [self._free.pop() for _ in range(n)]

    def release(self, pages) -> None:
        for p in pages:
            if p >= 0:
                self._free.append(int(p))


class PrefixPagePool:
    """Content-addressed page pool: automatic prefix caching.

    Wraps PageAllocator with refcounts, so concurrent sequences with a
    common prompt prefix share the pages holding it, and with an
    evictable LRU of content-keyed pages whose refcount dropped to zero,
    so a later request with the same prefix reuses their K/V. A page's
    key is the whole token prefix up to the page's end (K/V at position
    t depends on every token <= t). Pages never move: eviction drops the
    key of the oldest zero-ref page only when the free list runs dry.
    """

    def __init__(self, num_pages: int):
        self._alloc = PageAllocator(num_pages)
        self.num_pages = num_pages
        self._by_key: dict = {}            # key -> page id
        self._key_of: dict = {}            # page id -> key
        self._refs: dict = {}              # page id -> refcount (> 0 only)
        self._evictable: dict = {}         # page id -> None (ordered = LRU)
        self.hits = 0
        self.misses = 0

    @property
    def available(self) -> int:
        """Pages obtainable right now (free + evictable cached)."""
        return self._alloc.free_pages + len(self._evictable)

    def lookup(self, key: bytes) -> Optional[int]:
        """A shared page holding `key`'s content (refcount + 1), or None."""
        pid = self._by_key.get(key)
        if pid is None:
            self.misses += 1
            return None
        self.hits += 1
        self._evictable.pop(pid, None)
        self._refs[pid] = self._refs.get(pid, 0) + 1
        return pid

    def acquire(self, key: Optional[bytes] = None) -> int:
        """A fresh page (evicting the coldest cached page if the free list
        is empty), registered under `key` when one is given."""
        if self._alloc.free_pages == 0 and self._evictable:
            cold = next(iter(self._evictable))
            del self._evictable[cold]
            old_key = self._key_of.pop(cold, None)
            if old_key is not None:
                del self._by_key[old_key]
            self._alloc.release([cold])
        pid = self._alloc.alloc(1)[0]
        self._refs[pid] = 1
        if key is not None:
            old = self._by_key.get(key)
            if old is not None:
                self._key_of.pop(old, None)
            self._by_key[key] = pid
            self._key_of[pid] = key
        return pid

    def release(self, pages) -> None:
        """Drop one reference per page: zero-ref keyed pages become
        evictable (content kept), unkeyed ones return to the free list."""
        for p in pages:
            p = int(p)
            if p < 0:
                continue
            n = self._refs.get(p, 0) - 1
            if n > 0:
                self._refs[p] = n
                continue
            self._refs.pop(p, None)
            if p in self._key_of:
                self._evictable[p] = None
            else:
                self._alloc.release([p])

    @property
    def live_pages(self) -> int:
        return len(self._refs)


def prefix_page_keys(tokens, page_size: int) -> List[bytes]:
    """Content keys of each FULL page of `tokens` (a partial tail page is
    never shared: decode appends into it)."""
    arr = np.asarray(tokens, np.int32)
    return [arr[: (i + 1) * page_size].tobytes()
            for i in range(len(tokens) // page_size)]


# -- plain reference ops ----------------------------------------------------

def append_token(cache: PagedKVCache, layer_k: torch.Tensor,
                 layer_v: torch.Tensor) -> PagedKVCache:
    """Append ONE token's k/v [L, B, Hkv, D] for every layer and sequence
    at position lengths[b], IN PLACE (JAX returns new pools), encoded to
    the pool's storage (int8 codes with their scales, fp8 bits). A
    sequence whose destination page is unassigned (-1, or past the
    table) writes nothing: a negative torch index would wrap onto page
    P-1 and corrupt another sequence."""
    page = cache.page_size
    pos = cache.lengths.long()
    rows = torch.arange(pos.shape[0], device=pos.device)
    pidx = pos // page
    n = cache.block_table.shape[1]
    pid = cache.block_table.long().gather(1, pidx.clamp(max=n - 1)[:, None])[:, 0]
    live = (pid >= 0) & (pidx < n)
    pid, off = pid[live], (pos % page)[live]
    # indices split by a slice put their dim first: values [N, L, Hkv, D]
    for new, pages, scales in ((layer_k, cache.k_pages, cache.k_scale_pages),
                               (layer_v, cache.v_pages, cache.v_scale_pages)):
        code, s = encode_kv_scaled(new[:, rows[live]].transpose(0, 1),
                                   pages.dtype)
        pages[:, pid, :, off] = code
        if s is not None:
            scales[:, pid, :, off] = s
    return cache._replace(lengths=cache.lengths + 1)


def gather_sequence(cache: PagedKVCache, max_seq: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Contiguous [L, B, Hkv, max_seq, D] k/v from the pages (reference
    path; the kernel reads pages in place). An int8 pool comes back
    dequantized to f32, its scales consumed, as in the JAX package; fp8
    pools stay bits."""
    L, P, Hkv, page, D = cache.k_pages.shape
    n = max_seq // page
    t = cache.block_table[:, :n].long().clamp(0, P - 1)       # [B, n]
    B = t.shape[0]

    def gather(pages, scales):
        g = pages[:, t]                                # [L, B, n, Hkv, page, D]
        if scales is not None:
            g = decode_kv(g, torch.float32, scales[:, t])
        return g.permute(0, 1, 3, 2, 4, 5).reshape(L, B, Hkv, n * page, D)
    return (gather(cache.k_pages, cache.k_scale_pages),
            gather(cache.v_pages, cache.v_scale_pages))
