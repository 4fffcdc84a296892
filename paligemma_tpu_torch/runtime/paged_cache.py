"""Paged KV cache: a shared physical page pool + host-side page allocator
(port of paligemma_tpu/runtime/paged_cache.py).

* ``PageAllocator``: host bookkeeping (free set, per-owner page lists); no
  device work.
* ``PagedKVCache``: the device pool ``(L, n_pages, page_size, n_kv, d)`` and
  the ``(max_slots, max_pages)`` page table, kept on the host as numpy and
  mirrored to the device lazily, only after an allocation changed it.
  ``n_shards`` > 1 splits slots and pool into data-parallel shards, whose
  bookkeeping every rank keeps whole; the device holds one shard's chunk.
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
    length in pages).

    ``n_shards`` > 1 partitions both the slots and the pool into equal
    data-parallel shards, as the JAX cache does: slot ``s`` belongs to
    shard ``s // slots_per_shard``, its pages come from that shard's own
    allocator, and every page-table entry is a shard-local id in
    ``[0, pages_per_shard)``; each shard keeps its local page 0 as its
    garbage page. The host bookkeeping covers every shard (each rank of a
    data axis schedules all of them alike); the device pool
    ``(L, pages_per_shard, ...)`` and the device page table (the rows of
    the shard's slots) are those of shard ``shard``, the process's own."""

    def __init__(
        self,
        cfg: GemmaConfig,
        n_pages: int,
        page_size: int,
        max_slots: int,
        max_pages_per_slot: int,
        dtype: torch.dtype = torch.bfloat16,
        n_shards: int = 1,
        *,
        device="cuda",
        shard: int = 0,
    ):
        if page_size % 16:
            raise ValueError(f"page_size {page_size} must be a multiple of 16")
        if n_pages % n_shards or max_slots % n_shards:
            raise ValueError(f"n_pages {n_pages} and max_slots {max_slots} must split over "
                             f"{n_shards} shards")
        if not 0 <= shard < n_shards:
            raise ValueError(f"shard {shard} of {n_shards}")
        self.cfg = cfg
        self.page_size = page_size
        self.n_pages = n_pages
        self.max_slots = max_slots
        self.max_pages_per_slot = max_pages_per_slot
        self.n_shards = n_shards
        self.shard = shard
        self.slots_per_shard = max_slots // n_shards
        self.pages_per_shard = n_pages // n_shards
        self.device = torch.device(device)
        shape = (cfg.num_hidden_layers, self.pages_per_shard, page_size,
                 cfg.num_key_value_heads, cfg.head_dim)
        self.pool = {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                     "v": torch.zeros(shape, dtype=dtype, device=self.device)}
        # local page 0 of every shard: its garbage page
        self._allocs = [PageAllocator(self.pages_per_shard, first=1) for _ in range(n_shards)]
        # host page table of local ids; rows point at the garbage page until assigned
        self._table_np = np.zeros((max_slots, max_pages_per_slot), np.int32)
        self._table_dev: Optional[torch.Tensor] = None  # uploaded lazily
        # prefix-cache support: leading table entries a slot borrows from a
        # shared read-only prefix (owned by a cache entry, not the slot)
        self._borrowed: Dict[int, int] = {}

    @property
    def alloc(self) -> PageAllocator:
        """The single allocator (unsharded pools only)."""
        assert self.n_shards == 1
        return self._allocs[0]

    def shard_of(self, slot: int) -> int:
        return slot // self.slots_per_shard

    def allocator(self, slot: int) -> PageAllocator:
        """The allocator of ``slot``'s shard."""
        return self._allocs[self.shard_of(slot)]

    def free_pages(self, shard: int = 0) -> int:
        return self._allocs[shard].free_pages

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def grow_to(self, slot: int, n_tokens: int) -> bool:
        """Ensure ``slot`` owns pages covering ``n_tokens``, from its shard;
        False (no change) if that shard's pool or the table width cannot
        cover it."""
        need = self.pages_for(n_tokens)
        if need > self.max_pages_per_slot:
            return False
        alloc = self.allocator(slot)
        have = self._borrowed.get(slot, 0) + len(alloc.pages_of(slot))
        if need <= have:
            return True
        got = alloc.alloc(slot, need - have)
        if got is None:
            return False
        self._table_np[slot, have:need] = got
        self._table_dev = None
        return True

    def set_borrowed(self, slot: int, pages: List[int]) -> None:
        """Point the leading table entries of ``slot`` at shared read-only
        pages it does not own (a prefix-cache hit); before any grow_to."""
        if self.allocator(slot).pages_of(slot):
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
        pages = self.allocator(slot).transfer(slot, owner, n)
        self._borrowed[slot] = n
        return pages

    def release(self, slot: int) -> None:
        """Free the slot's pages and point its table row back at the garbage
        page (borrowed prefix pages stay with their owner)."""
        self.allocator(slot).free(slot)
        self._borrowed.pop(slot, None)
        self._table_np[slot, :] = 0
        self._table_dev = None

    @property
    def page_table(self) -> torch.Tensor:
        """Device page table of this shard's slots, re-uploaded only after
        allocation changes. The upload is a copy from pinned memory on the
        current stream, so it never waits for decode work already queued
        there."""
        if self._table_dev is None:
            lo = self.shard * self.slots_per_shard
            host = torch.from_numpy(self._table_np[lo:lo + self.slots_per_shard].copy())
            if self.device.type == "cuda":
                host = host.pin_memory()
            self._table_dev = host.to(self.device, non_blocking=True)
        return self._table_dev

    def slot_pages(self, slot: int) -> List[int]:
        """Shard-local page ids owned by ``slot``."""
        return self.allocator(slot).pages_of(slot)
