"""Paged KV cache: a shared physical page pool + host-side page allocator
(port of paligemma_tpu/runtime/paged_cache.py, one device).

* ``PageAllocator``: host bookkeeping (free set, per-owner page lists); no
  device work.
* ``PagedKVCache``: the device pool ``(L, n_pages, page_size, n_kv, d)`` and
  the ``(max_slots, max_pages)`` page table, kept on the host as numpy and
  mirrored to the device lazily, only after an allocation changed it.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.config import GemmaConfig


class PageAllocator:
    """Contiguity-preferring free-list page allocator, pages in
    [first, n_pages).

    ``first=1`` reserves physical page 0 as a never-allocated garbage page:
    inactive slot rows keep page-table entries of 0, so their discarded
    lockstep writes and reads land there, never in a live request's pages.

    Policy: first extend the owner's tail run (decode growth stays
    physically consecutive with the prompt), then first-fit a consecutive
    run of ``n``, then hand out whatever is free."""

    def __init__(self, n_pages: int, first: int = 0):
        self.n_pages = n_pages
        self._free = set(range(first, n_pages))
        self._owned: Dict[int, List[int]] = {}  # owner id -> page list

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_of(self, owner: int) -> List[int]:
        return self._owned.get(owner, [])

    def _take(self, owner: int, pages: List[int]) -> List[int]:
        self._free.difference_update(pages)
        self._owned.setdefault(owner, []).extend(pages)
        return pages

    def alloc(self, owner: int, n: int) -> Optional[List[int]]:
        """Append ``n`` pages to ``owner``; None (and no change) if the pool
        cannot cover it: the caller defers admission or preempts."""
        if n > len(self._free):
            return None
        if n == 0:
            return []
        owned = self._owned.get(owner)
        if owned:  # grow: continue the owner's tail run if the next pages are free
            tail = owned[-1]
            run = list(range(tail + 1, tail + 1 + n))
            if run[-1] < self.n_pages and self._free.issuperset(run):
                return self._take(owner, run)
        free_sorted = sorted(self._free)
        run_start, run_len = free_sorted[0], 1
        for prev, cur in zip(free_sorted, free_sorted[1:]):
            run_len = run_len + 1 if cur == prev + 1 else 1
            if run_len == 1:
                run_start = cur
            if run_len >= n:
                return self._take(owner, list(range(run_start, run_start + n)))
        if n == 1:  # the loop above never sees a 1-run of the first page
            return self._take(owner, free_sorted[:1])
        return self._take(owner, free_sorted[:n])  # fragmented pool

    def free(self, owner: int) -> None:
        self._free.update(self._owned.pop(owner, []))

    def transfer(self, frm: int, to: int, n: int) -> List[int]:
        """Move ownership of ``frm``'s first ``n`` pages to ``to`` (no device
        work; the physical ids are unchanged)."""
        owned = self._owned.get(frm, [])
        if len(owned) < n:
            raise ValueError(f"transfer: owner {frm} holds {len(owned)} pages, not {n}")
        moved, self._owned[frm] = owned[:n], owned[n:]
        if not self._owned[frm]:
            del self._owned[frm]
        self._owned.setdefault(to, []).extend(moved)
        return moved


class PagedKVCache:
    """Device page pool + page-table mirror for a fixed slot count.

    ``max_pages_per_slot`` is the page table's width (a request's longest
    length in pages). One device: the JAX package's data-parallel split of
    slots and pool into shards is not ported."""

    def __init__(
        self,
        cfg: GemmaConfig,
        n_pages: int,
        page_size: int,
        max_slots: int,
        max_pages_per_slot: int,
        dtype: torch.dtype = torch.bfloat16,
        *,
        device="cuda",
    ):
        if page_size % 16:
            raise ValueError(f"page_size {page_size} must be a multiple of 16")
        self.cfg = cfg
        self.page_size = page_size
        self.n_pages = n_pages
        self.max_slots = max_slots
        self.max_pages_per_slot = max_pages_per_slot
        self.device = torch.device(device)
        shape = (cfg.num_hidden_layers, n_pages, page_size, cfg.num_key_value_heads,
                 cfg.head_dim)
        self.pool = {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                     "v": torch.zeros(shape, dtype=dtype, device=self.device)}
        self.alloc = PageAllocator(n_pages, first=1)  # page 0: the garbage page
        # host page table; rows point at the garbage page until assigned
        self._table_np = np.zeros((max_slots, max_pages_per_slot), np.int32)
        self._table_dev: Optional[torch.Tensor] = None  # uploaded lazily
        # prefix-cache support: leading table entries a slot borrows from a
        # shared read-only prefix (owned by a cache entry, not the slot)
        self._borrowed: Dict[int, int] = {}

    def free_pages(self) -> int:
        return self.alloc.free_pages

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def grow_to(self, slot: int, n_tokens: int) -> bool:
        """Ensure ``slot`` owns pages covering ``n_tokens``; False (no
        change) if the pool or the table width cannot cover it."""
        need = self.pages_for(n_tokens)
        if need > self.max_pages_per_slot:
            return False
        borrowed = self._borrowed.get(slot, 0)
        have = borrowed + len(self.alloc.pages_of(slot))
        if need <= have:
            return True
        got = self.alloc.alloc(slot, need - have)
        if got is None:
            return False
        self._table_np[slot, have:need] = got
        self._table_dev = None
        return True

    def set_borrowed(self, slot: int, pages: List[int]) -> None:
        """Point the leading table entries of ``slot`` at shared read-only
        pages it does not own (a prefix-cache hit); before any grow_to."""
        if self.alloc.pages_of(slot):
            raise ValueError(f"set_borrowed: slot {slot} already owns pages")
        self._table_np[slot, : len(pages)] = pages
        self._borrowed[slot] = len(pages)
        self._table_dev = None

    def lend_prefix(self, slot: int, owner: int, n: int) -> List[int]:
        """Move ownership of ``slot``'s first ``n`` pages to ``owner`` (a
        prefix-cache entry) and keep them in the slot's table as borrowed:
        the slot reads them on, ``owner`` frees them. Returns the pages."""
        if self._borrowed.get(slot, 0):
            raise ValueError(f"lend_prefix: slot {slot} already borrows pages")
        if not n:
            return []
        pages = self.alloc.transfer(slot, owner, n)
        self._borrowed[slot] = n
        return pages

    def release(self, slot: int) -> None:
        """Free the slot's pages and point its table row back at the garbage
        page (borrowed prefix pages stay with their owner)."""
        self.alloc.free(slot)
        self._borrowed.pop(slot, None)
        self._table_np[slot, :] = 0
        self._table_dev = None

    @property
    def page_table(self) -> torch.Tensor:
        """Device page table, re-uploaded only after allocation changes.
        The upload is a copy from pinned memory on the current stream, so it
        never waits for decode work already queued there."""
        if self._table_dev is None:
            host = torch.from_numpy(self._table_np.copy())
            if self.device.type == "cuda":
                host = host.pin_memory()
            self._table_dev = host.to(self.device, non_blocking=True)
        return self._table_dev

    def slot_pages(self, slot: int) -> List[int]:
        return self.alloc.pages_of(slot)
