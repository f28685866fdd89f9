"""Paged KV cache memory management (serving tier, DESIGN.md §10).

A copy of ``repro/serve/kv_cache.py`` (numpy only), kept so that the port
imports nothing of the JAX package.

The device side is a pool of fixed-size token pages per layer
(``models/transformer.init_paged_cache``); this module is the HOST side:
a free-list block allocator and the per-slot block tables that map each
sequence's logical pages to physical ones.

Design points (vLLM-style):
  * Physical page 0 is RESERVED as the trash page.  Idle/padded lanes in
    a batched step write their (garbage) KV there, so no live table ever
    references it and admission never has to zero the cache — recycling
    a block is a free-list push, not a ``tree.map`` over the pool.
  * Allocation is all-or-nothing: a request either gets every page it
    asked for or none, so a failed admission/growth leaves no partial
    state to unwind.
  * The free list is LIFO — recently released pages are re-used first
    (warm in cache, and keeps the allocated set compact).
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

TRASH_PAGE = 0


class BlockAllocator:
    """Free-list allocator over physical pages 1..num_pages-1 (page 0 is
    the reserved trash page and is never handed out)."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is reserved)")
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._allocated: set = set()

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_allocated(self) -> int:
        return len(self._allocated)

    def blocks_for(self, num_tokens: int) -> int:
        return max(0, math.ceil(num_tokens / self.page_size))

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop n pages off the free list — all-or-nothing: returns None
        (and allocates nothing) if fewer than n are free."""
        if n > len(self._free):
            return None
        got = [self._free.pop() for _ in range(n)]
        self._allocated.update(got)
        return got

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if p not in self._allocated:
                raise ValueError(f"double-free or foreign page {p}")
            self._allocated.remove(p)
            self._free.append(p)

    def utilization(self) -> float:
        usable = self.num_pages - 1
        return self.num_allocated / usable if usable else 0.0

    def check(self) -> None:
        """Invariant: free ∪ allocated partitions pages 1..num_pages-1."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("duplicate pages on the free list")
        if free & self._allocated:
            raise AssertionError("page both free and allocated")
        if free | self._allocated != set(range(1, self.num_pages)):
            raise AssertionError("page leak: free+allocated != all pages")
        if TRASH_PAGE in free or TRASH_PAGE in self._allocated:
            raise AssertionError("trash page 0 entered circulation")


class PagedKVCache:
    """Per-slot block tables over a :class:`BlockAllocator`.

    ``tables`` is the (num_slots, pages_per_seq) int32 array handed to the
    model's paged attention each step; unallocated entries stay at the
    trash page.  ``owned[slot]`` tracks the slot's physical pages in
    logical order so release/growth are O(pages)."""

    def __init__(self, num_slots: int, pages_per_seq: int,
                 allocator: BlockAllocator):
        self.allocator = allocator
        self.pages_per_seq = pages_per_seq
        self.tables = np.full((num_slots, pages_per_seq), TRASH_PAGE,
                              np.int32)
        self.owned: List[List[int]] = [[] for _ in range(num_slots)]

    def admit(self, slot: int, num_tokens: int) -> bool:
        """Allocate pages covering ``num_tokens`` for an empty slot."""
        assert not self.owned[slot], "admit into a non-empty slot"
        need = self.allocator.blocks_for(num_tokens)
        got = self.allocator.alloc(need)
        if got is None:
            return False
        self.owned[slot] = got
        self.tables[slot, :len(got)] = got
        return True

    def ensure(self, slot: int, num_tokens: int) -> bool:
        """Grow the slot to cover ``num_tokens`` total tokens (no-op when
        already covered).  All-or-nothing; False ⇒ caller must evict."""
        need = self.allocator.blocks_for(num_tokens) - len(self.owned[slot])
        if need <= 0:
            return True
        got = self.allocator.alloc(need)
        if got is None:
            return False
        start = len(self.owned[slot])
        self.owned[slot].extend(got)
        self.tables[slot, start:start + len(got)] = got
        return True

    def release(self, slot: int) -> None:
        """Return the slot's pages to the free list; its table row points
        back at the trash page (no cache zeroing — stale page contents
        are unreachable once no table references them)."""
        if self.owned[slot]:
            self.allocator.free(self.owned[slot])
            self.owned[slot] = []
        self.tables[slot, :] = TRASH_PAGE

    def utilization(self) -> float:
        return self.allocator.utilization()
