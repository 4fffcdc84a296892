"""Paged continuous-batching engine (port of
paligemma_tpu/runtime/serving_paged.py): the slot-pool scheduler
of runtime/serving over a shared KV page pool instead of a
``max_slots x max_seq_len`` reservation.

* KV lives in fixed-size pages of one pool ``(L, n_pages, page_size, n_kv,
  d)``; a request holds ``ceil(len / page_size)`` pages and grows a page at
  a time while decoding, so memory follows live tokens.
* Admission is FIFO until slots or pages run out (no skip-ahead).
* Preemption: when the pool cannot cover the next window, the youngest
  request is evicted, its pages freed, and it re-enters the queue front as
  a recompute request (prompt + tokens so far, the original prompt as its
  bidirectional prefix).

``paged_kernel`` selects the decode tick on the kernel path
(``fused_decode``, the default on a CUDA device): "fused" (and "staged",
which maps onto it) runs kernels/decode_layer_paged, with the argmax head
kernel for greedy windows; "one" | "multi" | "batched" | "runs" run the page
walk with the paged attention kernel per layer; "xla" the page walk on
plain torch ops. ``fused_decode=False`` runs every tick on the plain page
walk ("xla"). A tree, config or page size the chosen kernels cannot take
raises.

Under a tensor-parallel ``mesh`` the pool holds the rank's KV heads (one KV
head: replicated over the model axis) and the kernel path's
tick is ``paged_kernel="fused_tp"``: kernels/decode_layer_paged_tp, then
the gathered logits of the vocab-sharded int8 head, for greedy and sampled
windows alike (a greedy spec verify takes the vocab-shard argmax head);
``fused_decode=False`` runs the plain sharded page walk. A LoRA bank (each
rank's shard, applied inside the "fused_tp" chain), grammars, the prefix
cache and ``spec_decode`` (the "fused_tp" chain at B s rows, or the plain
sharded verify) work under it as on one card: page allocation, prefix
entries and preemption are host bookkeeping that every rank repeats alike.
Where the chain's gate refuses the layout (more than one KV head), the
default ``fused_decode`` takes the plain sharded page walk, as in the
dense engine.

``lora_bank``: multi-LoRA serving as in the dense engine. The "fused" tick
(and "staged", which maps onto it) applies each row's adapter inside the
chain; the page walks take the bank through the torch projections. A
preempted request keeps its adapter when it is seated again.

``grammars``: constrained decoding as in the dense engine; a window with a
constrained row seated never takes the argmax head ("fused" runs the chain
with the int8 logits head, then masks), and a preempted constrained row
resumes in the DFA state its emitted tokens reach.

``prefix_cache``: exact-match prefix reuse (the dense engine's keys) by
page sharing. When a prompt prefills, its full prefix pages move to a
refcounted cache entry (no copy) and its partial tail page is copied once;
a later identical request is seated with no prefill: it borrows the
entry's read-only pages (``PagedKVCache.set_borrowed``; decode never
writes them: its positions start past the prompt) and takes a private copy
of the tail page. Entries no row holds are evicted LRU-first at
``prefix_cache_entries`` and, under pool pressure, before admission fails
or a live request is preempted.

``spec_decode``: speculative windows as in the dense engine, over the pool
(models/paligemma.decode_verify_paged: position j of row r's block is
written through the table at ``write_pos + j``, a block may cross a page,
and it attends ``[0, write_pos + j]``). The kernel path runs the decode
chain at ``max_slots * (spec_draft_k + 1)`` rows
(kernels/decode_layer_paged.layers_decode_fused_paged), so a speculating
engine takes ``paged_kernel`` "fused" (or "staged") or
``fused_decode=False``; a page walk raises. Each window reserves pages for
its worst case, ``ticks * (spec_draft_k + 1) + spec_draft_k`` positions
past what was dispatched. A preempted row is recomputed from its prompt and
emitted tokens. The verify writes start past the prompt, so they land in
the row's own pages, never in a prefix-cache entry's borrowed ones.

A ``mesh`` with a data axis (``data`` > 1; pure DP or DP x TP) splits the
slots and the pool into shards, as the JAX engine does: each data shard
owns ``max_slots/data`` slots and ``n_pages/data`` pages with its own
allocator and garbage page, page-table entries are shard-local ids,
admission pins each request to the shard whose budget covers it (the most
free pages wins; a prefix hit goes to its entry's shard), preemption stays
on the shard and prefix entries are shard-local. The port is SPMD, one
process per rank: every rank runs this same host scheduler over all slots
(all shards' allocators, the whole page table, admission, preemption, the
prefix entries), while its device holds only its own shard: its pool
chunk, the state rows of its own slots (``_row``) and, under DP x TP, its
slices of the weights. A rank prefills the rows of its own slots (on the
card through the flash kernel) and its ticks run the one-card kernels on
them (pure DP) or the TP chain (DP x TP, ``kernels/decode_layer_paged_tp``
at the rank's slots). Only what the host reads back crosses the data
group: a window's tokens (and a spec window's counts), gathered in
``_absorb``. So every host decision reads the same values on every rank.
Sampled rows draw the whole slot batch's noise and keep their own rows,
so a seed samples what one card samples.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.config import PaliGemmaConfig
from ..kernels import decode_head as _dh
from ..kernels import decode_layer as _dl
from ..kernels import decode_layer_paged as _dlp
from ..kernels import decode_layer_paged_tp as _ptp
from ..kernels import paged_attention as _pa
from ..models import paligemma
from .paged_cache import PagedKVCache
from .serving import Request, ServingEngine

PAGED_KERNELS = ("fused", "staged", "one", "multi", "batched", "runs", "xla")


class PagedServingEngine(ServingEngine):
    def __init__(
        self,
        params: Dict[str, Any],
        config: PaliGemmaConfig,
        max_slots: int = 16,
        max_seq_len: int = 1024,
        page_size: int = 64,
        n_pages: Optional[int] = None,
        cache_dtype: Optional[torch.dtype] = None,
        use_flash: Optional[bool] = None,
        decode_params: Optional[Dict[str, Any]] = None,
        sync_every: int = 8,
        mesh=None,
        paged_kernel: str = "fused",
        prefix_cache: bool = False,
        prefix_cache_entries: int = 8,
        spec_decode: bool = False,
        spec_draft_k: int = 8,
        spec_match_n: int = 2,
        pipeline: Optional[bool] = None,
        lora_bank: Optional[Dict[str, Any]] = None,
        grammars: Optional[Dict[str, Any]] = None,
        int8_act_prefill: bool = False,
        *,
        fused_decode: Optional[bool] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """The JAX engine's parameters in its order; ``fused_decode`` and
        ``generator`` are keyword-only. ``n_pages``: physical
        pool size, page 0 being the garbage page (default: half the dense
        engine's reservation). ``max_seq_len`` bounds one request's length
        (the page table's width) and reserves nothing. ``mesh``: tensor
        parallel; ``lora_bank``, ``grammars``, ``prefix_cache``,
        ``spec_decode``, a data axis: module docstring;
        ``int8_act_prefill``: W8A8 prefill waves (runtime/serving
        ``ServingEngine``)."""
        if max_seq_len % page_size:
            raise ValueError(f"max_seq_len {max_seq_len} must be a multiple of page_size "
                             f"{page_size}")
        if paged_kernel not in PAGED_KERNELS:
            raise ValueError(f"paged_kernel {paged_kernel!r} not in {PAGED_KERNELS}")
        self.dp = 1 if mesh is None else mesh.data
        if n_pages is None:
            n_pages = max(max_slots * max_seq_len // page_size // 2, 8)
            n_pages = -(-n_pages // self.dp) * self.dp
        if max_slots % self.dp or n_pages % self.dp:
            raise ValueError(f"max_slots {max_slots} and n_pages {n_pages} must split over the "
                             f"data axis ({self.dp} shards)")
        self.page_size = page_size
        self.n_pages = n_pages
        self.paged_kernel = paged_kernel
        self._admission_order: List[int] = []  # slot ids, oldest first
        self._planned: Dict[int, int] = {}  # request_id -> the slot _admit pinned it to
        self.preemptions = 0  # recompute evictions so far
        # prefix cache: key -> entry (owner id, full pages, tail page,
        # prompt length, logits row, refs); slot -> the key it borrows
        self._pcache: "OrderedDict[bytes, Dict[str, Any]]" = OrderedDict()
        self._slot_borrow: Dict[int, bytes] = {}
        self._next_entry_owner = -2  # entries own pages under negative ids
        super().__init__(
            params, config, max_slots=max_slots, max_seq_len=max_seq_len,
            cache_dtype=cache_dtype, use_flash=use_flash, decode_params=decode_params,
            sync_every=sync_every, mesh=mesh, fused_decode=fused_decode, pipeline=pipeline,
            spec_decode=spec_decode, spec_draft_k=spec_draft_k, spec_match_n=spec_match_n,
            lora_bank=lora_bank, grammars=grammars,
            prefix_cache=prefix_cache, prefix_cache_entries=prefix_cache_entries,
            int8_act_prefill=int8_act_prefill, generator=generator,
        )
        # page-aligned prefill buckets: a short prompt takes exactly its pages
        self._bucket_gran = max(page_size, 16)

    def _setup_fused(self, fused: bool) -> bool:
        """Decide the tick once: the plain page walk without ``fused``;
        else the kernels ``paged_kernel`` names, which raise on what they
        cannot take."""
        if not fused:
            self.paged_kernel = "xla"
            if self.mesh is not None:
                self._shard_decode(False)
            return False
        tc = self.config.text_config
        layers = self.decode_params["lm"]["layers"]
        if self.mesh is not None:
            if not self._tp_chain_fits():
                raise ValueError(
                    "the paged engine under a mesh needs what "
                    "kernels/decode_layer_paged_tp.supported accepts at the rank's slot rows; "
                    "pass fused_decode=False for the plain sharded page walk")
            self._shard_decode(True)
            self.paged_kernel = "fused_tp"
            return True
        if self.paged_kernel == "staged":
            self.paged_kernel = "fused"  # the TPU's staging hybrid: one chain here
        if self.spec_decode and self.paged_kernel != "fused":
            raise ValueError(
                f"spec_decode with paged_kernel={self.paged_kernel!r}: the verify runs the "
                "decode chain ('fused') or the plain path (fused_decode=False); a page walk "
                "has no verify")
        if self.paged_kernel == "fused":
            if not _dlp.supported(tc, layers, self._chain_rows(), page_size=self.page_size):
                raise ValueError(
                    "paged_kernel='fused' on the kernel path needs one KV head, the int8 "
                    "decode tree of runtime.quantize.quantize_lm_for_serving and a page size "
                    "that kernels/decode_layer_paged.supported accepts; pass decode_params="
                    "that tree, a page-walk paged_kernel, or fused_decode=False")
            dp = dict(self.decode_params)
            dp["lm"] = dict(dp["lm"])
            dp["lm"]["layers"] = _dl.repack_layers(layers)
            if "head_q" in dp["lm"]:
                dp["lm"]["head_q"] = _dh.repack_head(dp["lm"]["head_q"])
            self.decode_params = dp
        elif self.paged_kernel != "xla" and not _pa.supported(self.page_size, tc.head_dim):
            raise ValueError(f"paged_kernel={self.paged_kernel!r}: the paged attention kernel "
                             f"cannot take page_size {self.page_size} / head_dim {tc.head_dim}")
        return True

    def _tp_chain_fits(self) -> bool:
        return _ptp.supported(self.config.text_config, self.mesh,
                              self.decode_params["lm"]["layers"], self._n_rows,
                              page_size=self.page_size)

    def _chain_tick(self) -> bool:
        return self.paged_kernel in ("fused", "fused_tp")

    def _check_mesh(self, mesh) -> None:
        """A data axis splits slots and pool (``__init__`` checks that they
        divide)."""

    # -- backend hooks --------------------------------------------------
    def _init_cache(self):
        """Page pool instead of the dense max_slots x max_seq_len block
        (this rank's shard of it under a data axis)."""
        self.paged = PagedKVCache(
            self._kv_cfg, n_pages=self.n_pages, page_size=self.page_size,
            max_slots=self.max_slots, max_pages_per_slot=self.max_seq_len // self.page_size,
            dtype=self.cache_dtype, n_shards=self.dp, device=self.device,
            shard=0 if self.dp_mesh is None else self.dp_mesh.data_index,
        )
        return self.paged.pool

    def _zero_state(self) -> Dict[str, torch.Tensor]:
        # no validity bitmap: paged rows are [0, write_pos] by construction
        state = super()._zero_state()
        del state["valid"]
        return state

    def _admit(self, free_slots: list) -> List[Request]:
        """FIFO admission bounded by free slots and free pages, per data
        shard, each request with one decode page of headroom: a request is
        pinned to the shard whose slots and pages cover it (the most free
        pages wins; a prefix hit goes to its entry's shard when that one
        can take it; ``_take_slot`` seats the pin). Stops at the first
        request no shard can take (no skip-ahead, so long prompts are not
        starved)."""
        take: List[Request] = []
        shards = range(self.paged.n_shards)
        free_by_shard: Dict[int, List[int]] = {sh: [] for sh in shards}
        for slot in free_slots:
            free_by_shard[self.paged.shard_of(slot)].append(slot)
        budget = {sh: self.paged.free_pages(sh) for sh in shards}
        for req in self.pending:
            if len(take) == len(free_slots):
                break
            need = self.paged.pages_for(self._bucket_of(req)) + 1
            cands = [sh for sh in shards if free_by_shard[sh] and budget[sh] >= need]
            if not cands and self._pcache and self._evict_pcache():
                budget = {sh: self.paged.free_pages(sh) for sh in shards}
                for r in take:  # what this round already took
                    budget[self.paged.shard_of(self._planned[r.request_id])] -= (
                        self.paged.pages_for(self._bucket_of(r)) + 1)
                cands = [sh for sh in shards if free_by_shard[sh] and budget[sh] >= need]
            if not cands:
                break
            sh = max(cands, key=lambda x: budget[x])
            key = self._pcache_key(req)
            entry = self._pcache.get(key) if key is not None else None
            if entry is not None and entry["shard"] in cands:
                sh = entry["shard"]
            budget[sh] -= need
            self._planned[req.request_id] = free_by_shard[sh].pop(0)
            take.append(req)
        del self.pending[: len(take)]
        return take

    def _take_slot(self, free: list, req: Request) -> int:
        slot = self._planned.pop(req.request_id)
        free.remove(slot)
        return slot

    def _insert_chunk(self, seated, bucket, cache1, mask, last_logits) -> None:
        """Each row's KV lands in its slot's pages (the tables differ per
        row, so the seat is per row); prefill row r is the r-th row of
        ``seated`` in this rank's slots."""
        r = 0
        for slot, req in seated:
            mine = self._row(slot) is not None
            self._insert_row(slot, req, r if mine else None, bucket, cache1, last_logits)
            r += mine

    def _insert_row(self, slot: int, req: Request, row: Optional[int], bucket: int, cache1,
                    last_logits) -> None:
        """Grow the slot's pages to the bucket, copy prefill row ``row``
        into them (one copy per K/V slab, all layers) and seat its state;
        ``row`` None (a slot of another data shard): the bookkeeping only."""
        if not self.paged.grow_to(slot, bucket):
            raise RuntimeError("admission reserved the pages; grow_to must succeed")
        logits = None
        if row is not None:
            n_chunks = bucket // self.page_size
            pages = self._upload(np.asarray(self.paged.slot_pages(slot)[:n_chunks], np.int64))
            for n in ("k", "v"):
                rows = cache1[n][:, row].reshape(cache1[n].shape[0], n_chunks, self.page_size,
                                                 *cache1[n].shape[3:])
                self.cache[n][:, pages] = rows.to(self.cache_dtype)
            logits = last_logits[row]
            self._seat_state(slot, req, len(req.input_ids), logits)
        self._admission_order.append(slot)
        key = self._pcache_key(req)
        if key is not None and key not in self._pcache:
            self._register_prefix(slot, req, key, logits)

    # -- prefix cache (exact match; module docstring) --------------------
    def _copy_page(self, src: int, dst: int) -> None:
        """Duplicate one physical page (all layers, K and V)."""
        for n in ("k", "v"):
            self.cache[n][:, dst] = self.cache[n][:, src]

    def _insert_cached(self, slot: int, req: Request) -> bool:
        """Seat a hit with no prefill: borrow the entry's full pages, copy
        its tail page into a page of the slot's own (decode writes there),
        resume from the stored logits. False on a miss, for a slot of
        another shard than the entry's (page ids are shard-local), or when
        the pool has no page for the tail (the request then prefills)."""
        key = self._pcache_key(req)
        entry = self._pcache.get(key) if key is not None else None
        if entry is None or entry["shard"] != self.paged.shard_of(slot):
            return False
        self.paged.set_borrowed(slot, entry["full_pages"])
        if entry["tail_page"] is not None:
            if not self.paged.grow_to(slot, entry["prompt_len"]):
                self.paged.release(slot)  # clears the borrowed row
                return False
            if self._row(slot) is not None:
                self._copy_page(entry["tail_page"], self.paged.slot_pages(slot)[0])
        self._seat_state(slot, req, entry["prompt_len"], entry["logits"])
        entry["refs"] += 1
        self._pcache.move_to_end(key)
        self._slot_borrow[slot] = key
        self._admission_order.append(slot)
        self.cache_hits += 1
        return True

    def _register_prefix(self, slot: int, req: Request, key: bytes, logits) -> None:
        """Adopt a freshly prefilled slot's prefix: its full pages move to a
        new entry (no copy) and the slot borrows them back; its partial tail
        page is copied into a page of the entry's (the slot keeps writing
        its own). Best effort: skipped when no page is free for the tail.
        The entry lives in the slot's shard; the device copy and the logits
        (None here) are the owning rank's."""
        ps = self.page_size
        prompt_len = len(req.input_ids)
        n_full = prompt_len // ps
        shard = self.paged.shard_of(slot)
        alloc = self.paged.allocator(slot)
        owner = self._next_entry_owner
        tail_page = None
        if prompt_len % ps:
            got = alloc.alloc(owner, 1)
            if got is None:
                return
            tail_page = got[0]
            if self._row(slot) is not None:
                self._copy_page(alloc.pages_of(slot)[n_full], tail_page)
        self._next_entry_owner -= 1
        full_pages = self.paged.lend_prefix(slot, owner, n_full)
        self._pcache[key] = dict(owner=owner, full_pages=full_pages, tail_page=tail_page,
                                 prompt_len=prompt_len, shard=shard, refs=1,
                                 logits=None if logits is None else logits.clone())
        self._slot_borrow[slot] = key
        # capacity: drop the least recently used entries no row holds
        while len(self._pcache) > self.prefix_cache_entries:
            victim = next((k for k, e in self._pcache.items() if e["refs"] <= 0), None)
            if victim is None:
                break
            self._free_entry(victim)

    def _free_entry(self, key: bytes) -> None:
        entry = self._pcache.pop(key)
        self.paged._allocs[entry["shard"]].free(entry["owner"])

    def _evict_pcache(self) -> int:
        """Free every entry no row holds (LRU first); returns the pages
        recovered. Called under pool pressure before live work waits or is
        preempted."""
        freed = 0
        for k in list(self._pcache):
            e = self._pcache[k]
            if e["refs"] <= 0:
                freed += len(e["full_pages"]) + (e["tail_page"] is not None)
                self._free_entry(k)
        return freed

    def _release_slot(self, slot: int) -> None:
        key = self._slot_borrow.pop(slot, None)
        if key is not None and key in self._pcache:
            self._pcache[key]["refs"] -= 1
        self.paged.release(slot)
        if slot in self._admission_order:
            self._admission_order.remove(slot)

    def _before_window(self, ticks: int) -> None:
        """Grow every active slot's pages to cover this window, oldest first;
        preempt the youngest request whenever the pool is short. Growth
        covers dispatched positions (an in-flight window writes its KV
        before its tokens are read back)."""
        for slot in list(self._admission_order):
            req = self.slots[slot]
            if req is None:
                continue
            need = len(req.input_ids) + self._dispatched[req.request_id] + ticks
            while not self.paged.grow_to(slot, min(need, self.max_seq_len)):
                # cheapest relief first: entries no row holds
                if self._pcache and self._evict_pcache():
                    continue
                # pages come from the slot's own shard: only a neighbour
                # there frees any
                if self._preempt_youngest(slot, self.paged.shard_of(slot)) is None:
                    raise RuntimeError(
                        f"page pool too small for a single request of {need} tokens "
                        f"(pool={self.n_pages} pages x {self.page_size}"
                        + (f" over {self.dp} data shards)" if self.dp > 1 else ")"))

    def _preempt_youngest(self, exclude: int, shard: int) -> Optional[int]:
        """Evict the most recently admitted request of ``shard`` (except
        ``exclude``): free its pages and put it back at the queue front as
        a recompute request (prompt + tokens so far; the remaining
        budget)."""
        for slot in reversed(self._admission_order):
            if (slot == exclude or self.slots[slot] is None
                    or self.paged.shard_of(slot) != shard):
                continue
            req = self.slots[slot]
            gen = self._generated.pop(req.request_id, 0)
            self._dispatched.pop(req.request_id, None)
            req.epoch += 1  # in-flight windows carry tokens past ``gen``
            if req.prefix_len is None:
                # the original prompt stays the bidirectional prefix; the
                # regenerated suffix is re-encoded causally
                req.prefix_len = len(req.input_ids)
            emitted = req.tokens[len(req.tokens) - gen:] if gen else []
            req.input_ids = np.concatenate([np.asarray(req.input_ids, np.int32),
                                            np.asarray(emitted, np.int32)])
            req.max_new_tokens = max(req.max_new_tokens - gen, 1)
            self.slots[slot] = None
            self._release_slot(slot)
            self._sched_cache = None  # slot composition changed
            self.pending.insert(0, req)
            self.preemptions += 1
            return slot
        return None

    def _pages_bucket(self, ticks: int) -> int:
        """Smallest power-of-two count of logical pages covering every
        active slot through this window: reads follow live tokens."""
        need = max((self.paged.pages_for(len(r.input_ids) + self._dispatched[r.request_id]
                                         + ticks) for r in self.slots if r is not None),
                   default=1)
        b = 1
        while b < need:
            b *= 2
        return min(b, self.max_seq_len // self.page_size)

    def _kernel_for_bucket(self, pages_bucket: int) -> str:
        """The TPU engine drops to the page walk when a window's K/V ring
        would not fit its VMEM budget. The port's chain keeps no ring (each
        layer reads the pages straight from the pool), so every bucket runs
        the chosen kernel."""
        return self.paged_kernel

    def _tick_paged(self, active, temps, top_ps, do_samples, with_sampling, pages_bucket,
                    kernel, table):
        """One lockstep paged step; returns the (max_slots,) token consumed."""
        st = self.state
        kw = dict(write_pos=st["write_pos"], position_ids=st["pos_ids"],
                  pages_bucket=pages_bucket, **self._tick_lora())
        if kernel == "fused" and self._head_argmax_tick(with_sampling):
            # greedy fast path: the argmax head kernel returns the ids and
            # the stored logits go stale (greedy selection never reads them)
            token = st["next_tok"]
            next_tok, _ = paligemma.decode_step_greedy_paged(
                self.decode_params, self.config, token, self.cache, table, **kw)
            self._advance(active, next_tok)
            return token
        token = self._select(temps, top_ps, do_samples, with_sampling)
        self._advance_dfa(active, token)
        new_logits, _ = paligemma.decode_step_paged(
            self.decode_params, self.config, token, self.cache, table, paged_kernel=kernel,
            mesh=self.mesh, **kw)
        self._advance(active, None, new_logits)
        return token

    def _run_window(self, ticks, lefts, temps, top_ps, do_samples, with_sampling):
        # the JAX engine's _decode_window_paged: the base window loop over
        # _tick_paged. The page table is fixed through a window:
        # _before_window grew every row's pages up front
        table = self.paged.page_table
        pages_bucket = self._pages_bucket(ticks)
        kernel = self._kernel_for_bucket(pages_bucket)
        return self._decode_window(lefts, ticks, lambda active: self._tick_paged(
            active, temps, top_ps, do_samples, with_sampling, pages_bucket, kernel, table))

    # -- speculative windows (module docstring) --------------------------
    def _verify(self, tokens_in, greedy: bool, kv_arg):
        st = self.state
        return paligemma.decode_verify_paged(
            self.decode_params, self.config, tokens_in, self.cache, self.paged.page_table,
            st["write_pos"], st["pos_ids"], pages_bucket=kv_arg,
            fused_layer=self._chain_tick(), greedy_head=greedy, mesh=self.mesh)[0]

    def _spec_window_arg(self, ticks: int) -> int:
        """The logical pages a spec window attends: ``_dispatched`` already
        assumes every cycle accepts every draft; plus the last cycle's
        ``spec_draft_k`` slots past its tokens."""
        return self._pages_bucket(ticks * (self.spec_draft_k + 1) + self.spec_draft_k)

    def _spec_greedy(self) -> bool:
        return self._chain_tick() and self._head_argmax_tick(False)
