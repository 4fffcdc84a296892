"""Continuous-batching serving engine (port of
paligemma_tpu/runtime/serving.py).

A fixed pool of ``max_slots`` sequence slots over one preallocated KV cache;
every tick decodes one token for every active slot in lockstep (per-row
cache and RoPE positions):

* ``submit`` queues a request (ids + pixels + sampling settings);
* free slots are filled by prefills grouped by prompt-length bucket and
  split into power-of-two chunks, whose KV rows are copied into the slots;
* a window of ``sync_every`` ticks is enqueued on the device with no host
  synchronization inside; its tokens are read back once (``_absorb``);
* rows retire on EOS or budget and their slots are reused at once.

With ``pipeline`` (the default on a CUDA device), window N+1 is enqueued
before window N's tokens are read back: the tokens of each window are
copied to pinned host memory behind an event right after its last tick,
so the read-back waits for that window only.

``fused_decode`` and ``use_flash`` default to True on a CUDA device: greedy
ticks then run the decode kernel chain with the argmax head kernel, sampled
ticks the chain with the int8 GEMV head, and prefill the flash kernel. A
decode tree or config the kernels cannot take raises.

``mesh`` (core/mesh.make_mesh, one process per rank): tensor parallel over
the model axis, as the JAX engine's pure-TP serving (this engine refuses a
data axis, as the JAX one does: slots are the batch; the paged engine
takes one, runtime/serving_paged),
with every feature below. Every rank builds the engine from the whole
params (it keeps its slices, core/mesh.shard_params; k and v by KV heads),
holds the KV cache of its KV heads (one KV head: the whole replicated
cache) and must be given the same requests in the same order (and the
same cancels between the same rounds): the scheduler is host bookkeeping
over tokens that every rank reads back identically (gathered logits and
the cross-rank argmax), and each rank's ``generator`` draws the same
numbers from the same seed. So admission,
preemption, prefix-cache hits and evictions (keys hashed from the inputs
alone), spec accept counts and DFA states are the same on every rank; a
rank that seated another row would deadlock at the next collective. On
the kernel path the greedy tick runs the TP chain of kernels/decode_layer_tp
with the vocab-shard argmax combined across ranks, the sampled tick (and
a tick with a constrained row seated) the same chain with the gathered
int8-head logits, masked and selected on every rank alike. The engine
decides once, from the layout, as JAX's does: where the TP chain's gate
refuses the tree or config (more than one KV head, no int8 tree), the
default ``fused_decode`` takes the plain sharded tick (the torch-op TP
step) and ``fused_decode`` after construction says so; an explicit
``fused_decode=True`` it refuses raises.

``lora_bank`` ({name: adapter tree}, train/lora.init_lora's layout):
multi-LoRA serving. A request names its adapter (``Request.lora``; None =
the base model) and every prefill and tick applies each row's adapter,
row 0 of the stacked bank (train/lora.stack_lora_bank) being the zero
adapter of the base model. The per-slot bank index lives on the device
(``state["adapter"]``, set when a row is seated). Prefill and the plain
tick take the bank through the torch projections (models/gemma
``_lora_delta``); the kernel ticks take its kernel operands
(kernels/decode_layer.repack_lora_bank_fused) and apply each row's adapter
inside the decode chain. Under a ``mesh`` each rank keeps its shard of the
stacked bank (core/mesh.shard_lora) and packs it at its own widths; the TP
chain applies it (kernels/decode_layer_tp, K1 on o and down).

``grammars`` ({name: processing/grammar.TokenDFA}): constrained decoding.
A request names its grammar (``Request.grammar``; None = unconstrained) and
every selection is masked by ``table[gid, dstate] >= 0``, the row's
grammar id and live DFA state, both on the device (``state["gid"]``,
``state["dstate"]``); the DFA advances by each consumed token on active
rows. The table is one ``(G + 1, S_max, vocab)`` int16 tensor on the
device, row 0 unconstrained (every token allowed, the state stays 0), so a
mixed batch takes no branch. Stored logits stay unmasked; the pending
greedy token is chosen under the mask. A window with a constrained row
seated never takes the argmax head: on the kernel path its ticks run the
decode chain with the int8 logits head (the sampled tick), then mask and
take the argmax; greedy windows with no constrained row take the argmax
head. A preempted constrained row is seated again in the DFA state its
emitted tokens reach (``_seat_dstates``), not the start state.

``prefix_cache``: exact-match prefix KV reuse. PaliGemma's prefix is
bidirectional (image + prompt), so KV is reusable only for byte-identical
``(input_ids, pixel_values)`` (and the same adapter). After a prefill each
new prompt's KV row pair and last-logits row are kept (LRU, at most
``prefix_cache_entries``); a later identical request is seated from them
with no prefill (``cache_hits``), and identical requests admitted in one
wave share one prefill.

``spec_decode``: speculative continuous batching, greedy only (a sampled
request raises at ``submit``). Every window is ``ticks`` verify cycles:
per row the n-gram proposer (ops/ngram) drafts ``spec_draft_k`` tokens from
the row's history on the device (``state["hist"]``: the prompt, the
emitted tokens and the pending token, at their cache positions), one
forward verifies [pending token, drafts] (models/paligemma.decode_verify,
per-row positions; on the kernel path the decode chain at
``max_slots * (spec_draft_k + 1)`` rows), and the row emits the accepted
prefix of its inputs, 1 to ``spec_draft_k + 1`` tokens, the model's token
after it becoming the pending one. Only emitted slots become valid. Rows
retire on a budget counted down on the device (``state["left"]``): the
host learns the accepted counts only at read-back. Grammar rows step their
DFA through the block and mask each position's argmax with the state after
its prefix, so a disallowed draft is rejected exactly there. A verify
writes ``spec_draft_k`` slots past the last emitted token, so ``submit``
caps each budget to leave them room. Tokens equal the non-speculative
greedy engine's. ``spec_corrupt_frac``: a benchmark's acceptance dial
(engine.generate_spec's ``corrupt_frac``; drawn from ``generator``).

``int8_act_prefill`` (single-copy serving from the int8 tree): every
prefill wave runs its LM projections W8A8 (kernels/quant.matmul_any), with
a LoRA bank, grammars, the prefix cache and ``spec_decode`` alike.

Not ported: ``warmup`` (XLA compiles). Speculation with a ``lora_bank``
raises ``ValueError``, as in the JAX engine (its verify forward takes no
adapters).
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import mesh as mesh_lib
from ..core.config import PaliGemmaConfig
from ..kernels import decode_head as _dh
from ..kernels import decode_layer as _dl
from ..kernels import decode_layer_tp as _tp
from ..models import gemma, paligemma
from ..ops import sampling
from ..ops.ngram import propose_ngram
from .engine import check_cache_dtype
from ..train.lora import stack_lora_bank


@dataclasses.dataclass
class Request:
    request_id: int
    input_ids: np.ndarray  # (S,) int32
    pixel_values: np.ndarray  # (C, H, W)
    max_new_tokens: int = 100
    temperature: float = 0.8
    top_p: float = 0.9
    do_sample: bool = False
    eos_token_id: int = 1
    lora: Optional[str] = None  # the engine's lora_bank adapter to decode with (None: base)
    grammar: Optional[str] = None  # the engine's grammars entry to decode under (None: free)
    # host-side callback with each accepted token id, as the scheduler absorbs it
    on_token: Optional[Any] = None
    # engine-stamped wall-clock marks (time.perf_counter seconds): submit ->
    # seated (prefill done) -> first token absorbed -> finished. TTFT here
    # includes queueing and the read-back lag of a window.
    t_submit: Optional[float] = None
    t_seated: Optional[float] = None
    t_first_token: Optional[float] = None
    t_finished: Optional[float] = None
    # filled by the engine
    tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # engine-managed: bidirectional-prefix length for recompute prefills (set
    # on preemption to the original prompt length; None = the whole prompt)
    prefix_len: Optional[int] = None
    # engine-managed: bumped on preemption or cancel so that windows
    # dispatched before it are discarded, not counted twice
    epoch: int = 0
    # engine-managed: the prefix-cache key of the prompt as submitted
    # (computed once, on first use)
    cache_key: Optional[bytes] = None
    # engine-managed: the slot the request was last seated in (its data
    # shard's, under a data axis)
    slot: Optional[int] = None

    def metrics(self) -> Dict[str, Any]:
        """Latency/throughput summary ({} until finished)."""
        if self.t_finished is None or self.t_submit is None:
            return {}
        decode_s = self.t_finished - self.t_first_token
        return {
            "queue_ms": round((self.t_seated - self.t_submit) * 1e3, 1),
            "ttft_ms": round((self.t_first_token - self.t_submit) * 1e3, 1),
            "total_ms": round((self.t_finished - self.t_submit) * 1e3, 1),
            "decode_tokens_per_sec": (
                round((len(self.tokens) - 1) / decode_s, 1)
                if decode_s > 0 and len(self.tokens) > 1 else None
            ),
        }


@dataclasses.dataclass
class _Window:
    """One dispatched decode window whose tokens are not read back yet."""
    tokens: torch.Tensor  # (ticks, max_slots) int32, on the host once ``ready``
    ticks: int
    snapshot: List[Optional[tuple]]  # (request, epoch at dispatch) per slot
    ready: Optional[torch.cuda.Event] = None  # the host copy landed (CUDA)
    # speculative windows: tokens is (ticks, max_slots, draft_k + 1) and
    # cycle t of a slot emitted its first counts[t, slot] entries
    counts: Optional[torch.Tensor] = None


def _read_back(*tensors):
    """Start copying a window's device tensors to pinned host memory,
    behind this window only: (host tensors, the event that marks them
    landed). CPU tensors come back as they are, with no event."""
    if not tensors[0].is_cuda:
        return tensors, None
    host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors)
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()
    return host, ready


class ServingEngine:
    def __init__(
        self,
        params: Dict[str, Any],
        config: PaliGemmaConfig,
        max_slots: int = 8,
        max_seq_len: int = 1024,
        cache_dtype: Optional[torch.dtype] = None,
        use_flash: Optional[bool] = None,
        decode_params: Optional[Dict[str, Any]] = None,
        sync_every: int = 8,
        mesh=None,
        fused_decode: Optional[bool] = None,
        pipeline: Optional[bool] = None,
        spec_decode: bool = False,
        spec_draft_k: int = 8,
        spec_match_n: int = 2,
        spec_corrupt_frac: float = 0.0,
        lora_bank: Optional[Dict[str, Any]] = None,
        grammars: Optional[Dict[str, Any]] = None,
        prefix_cache: bool = False,
        prefix_cache_entries: int = 8,
        int8_act_prefill: bool = False,
        *,
        generator: Optional[torch.Generator] = None,
    ):
        """The JAX engine's parameters in its order; ``generator`` is
        keyword-only.

        ``decode_params``: optional second weight set (the int8 tree of
        runtime.quantize) for the lockstep decode while ``params`` serves the
        prefills. The device is the one the params live on; the KV cache
        takes the embedding table's dtype unless ``cache_dtype`` is given.

        ``sync_every``: decode ticks per host read-back; EOS detection lags
        by up to that many tokens (the overshoot is discarded).
        ``lora_bank``: {name: adapter tree} for multi-LoRA serving;
        ``grammars``: {name: TokenDFA} for constrained decoding;
        ``prefix_cache`` / ``prefix_cache_entries``: exact-match prefix KV
        reuse; ``spec_decode``, ``spec_draft_k``, ``spec_match_n``,
        ``spec_corrupt_frac``: speculative decoding (module docstring).
        ``int8_act_prefill``: every prefill wave runs its LM projections
        W8A8 (runtime/engine ``PaliGemmaEngine``), for ``params`` that are
        the int8 tree (single-copy serving).
        ``generator``: the draws of sampled requests and of
        ``spec_corrupt_frac`` (default: seed 0 on the device)."""
        if spec_decode and lora_bank:
            raise ValueError("spec_decode + lora_bank is unimplemented (the verify forward "
                             "takes no adapters)")
        if mesh is not None:
            self._check_mesh(mesh)
        self.config = config
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len
        # the model axis the weights shard over; the data axis the slots
        # split over (runtime/serving_paged): this rank's device state holds
        # slot rows [_row0, _row0 + _n_rows)
        self.mesh, self.dp_mesh = mesh_lib.split_axes(mesh)
        tc = config.text_config
        self._kv_heads = tc.num_key_value_heads
        # the KV cache's config: the rank's KV heads under a mesh
        self._kv_cfg = (tc if self.mesh is None
                        else mesh_lib.local_text_config(tc, self.mesh.model))
        d = 1 if self.dp_mesh is None else self.dp_mesh.data
        self._n_rows = max_slots // d
        self._row0 = 0 if self.dp_mesh is None else self.dp_mesh.data_index * self._n_rows
        self.int8_act_prefill = bool(int8_act_prefill)
        self.spec_decode = bool(spec_decode)
        self.spec_draft_k = spec_draft_k
        self.spec_match_n = spec_match_n
        self.spec_corrupt_frac = float(spec_corrupt_frac)
        # whole trees: _setup_fused shards (or repacks) the decode tree
        self.decode_params = decode_params if decode_params is not None else params
        self.params = (params if self.mesh is None else
                       mesh_lib.shard_params(params, self.mesh, kv_heads=self._kv_heads))
        self.device = params["lm"]["embed"].device
        self.cache_dtype = cache_dtype or params["lm"]["embed"].dtype
        check_cache_dtype(self.device, params, self.cache_dtype, type(self).__name__)
        on_cuda = self.device.type == "cuda"
        self.use_flash = on_cuda if use_flash is None else use_flash
        self.pipeline = on_cuda if pipeline is None else pipeline
        self.generator = generator if generator is not None else (
            torch.Generator(device=self.device).manual_seed(0))
        # multi-LoRA: adapter name -> bank row (0: the base model)
        self.lora_bank = None
        self._lora_index: Dict[Optional[str], int] = {None: 0}
        if lora_bank:
            names = list(lora_bank)
            bank = stack_lora_bank([lora_bank[n] for n in names])
            bank = {"layers": {t: {k: v.to(self.device) for k, v in p.items()}
                               for t, p in bank["layers"].items()}}
            # under a mesh: this rank's slices (prefill, the plain tick and the pack)
            self.lora_bank = (bank if self.mesh is None else
                              mesh_lib.shard_lora(bank, self.mesh, kv_heads=self._kv_heads))
            self._lora_index.update({n: i + 1 for i, n in enumerate(names)})
        # constrained decoding: grammar name -> table row (0: unconstrained)
        self.grammar_table: Optional[torch.Tensor] = None
        self._grammar_index: Dict[Optional[str], int] = {None: 0}
        self._grammars = dict(grammars or {})
        if grammars:
            self.grammar_table = self._grammar_table(self._grammars, config.vocab_size)
        # exact-match prefix cache (the paged engine keeps its entries in pages)
        self.prefix_cache = prefix_cache
        self.prefix_cache_entries = prefix_cache_entries
        self.cache_hits = 0  # prefills skipped
        self._dense_pcache: "OrderedDict[bytes, Dict[str, Any]]" = OrderedDict()
        fused = on_cuda if fused_decode is None else fused_decode
        if fused and fused_decode is None and self.mesh is not None:
            fused = self._tp_chain_fits()  # the layout decides (module docstring)
        self.fused_decode = self._setup_fused(fused)
        self._lora_fused_pack = None
        if self.lora_bank is not None and self._chain_tick():
            # the kernel ticks' operands: each row's adapter inside the chain
            # (under a mesh at the rank's widths)
            tc = config.text_config
            if self.mesh is not None:
                tc = mesh_lib.local_text_config(tc, self.mesh.model)
            self._lora_fused_pack = _dl.repack_lora_bank_fused(
                self.lora_bank["layers"], n_heads=tc.num_attention_heads,
                head_dim=tc.head_dim, hidden=tc.hidden_size,
                intermediate=tc.intermediate_size)

        self._rows = torch.arange(self._n_rows, device=self.device)
        self.cache = self._init_cache()
        self.state = self._zero_state()
        self.slots: List[Optional[Request]] = [None] * max_slots
        self.pending: List[Request] = []
        self._generated: Dict[int, int] = {}  # absorbed (read-back) tokens
        self._dispatched: Dict[int, int] = {}  # dispatched, incl. in flight
        self.prefill_calls = 0  # batched prefill dispatches
        self.sync_every = max(1, sync_every)
        self._sched_cache = None  # (slot fingerprint, device sampling arrays)
        # prefill prompt-length bucket granularity (the paged engine uses its
        # page size so that buckets stay page-aligned)
        self._bucket_gran = 64

    def _grammar_table(self, grammars: Dict[str, Any], vocab: int) -> torch.Tensor:
        """The ``(G + 1, S_max, vocab)`` int16 table on the device: row 0
        unconstrained (all zeros), then each grammar padded with rejecting
        states."""
        s_max = max(g.num_states for g in grammars.values())
        tables = [np.zeros((s_max, vocab), np.int16)]
        for i, (name, g) in enumerate(grammars.items()):
            if g.table.shape[1] != vocab:
                raise ValueError(f"grammar {name!r} compiled for vocab {g.table.shape[1]}, "
                                 f"model has {vocab}")
            t = np.full((s_max, vocab), -1, np.int16)
            t[: g.num_states] = g.table
            tables.append(t)
            self._grammar_index[name] = i + 1
        return torch.from_numpy(np.stack(tables)).to(self.device)

    def _tp_chain_fits(self) -> bool:
        """Under a mesh: whether the TP kernel chain takes this tree and
        config at the rank's slot rows (hook: the paged engine's chain)."""
        return _tp.supported(self.config.text_config, self.mesh,
                             self.decode_params["lm"]["layers"], self._n_rows)

    def _shard_decode(self, fused: bool) -> None:
        """Under a mesh: this rank's decode tree, the tensor-parallel kernels'
        (kernels/decode_layer_tp.repack_for_tp, which raises on a tree they
        cannot take) or the plain sharded one."""
        if fused:
            if not self._tp_chain_fits():
                raise ValueError(
                    "fused_decode under a mesh needs what kernels/decode_layer_tp.supported "
                    "accepts at the rank's slot rows (the int8 decode tree, one KV head, heads / "
                    "vocab / MLP width divisible by the model axis); pass fused_decode=False "
                    "for the plain sharded path")
            self.decode_params = {"lm": _tp.repack_for_tp(self.decode_params["lm"],
                                                          self.config.text_config, self.mesh)}
        else:
            self.decode_params = mesh_lib.shard_params(self.decode_params, self.mesh,
                                                       kv_heads=self._kv_heads)

    def _setup_fused(self, fused: bool) -> bool:
        """Decide the kernel decode path once: the dense kernel chain needs
        what kernels/decode_layer.supported accepts at ``max_slots`` rows; a
        tree or config it cannot take raises, it never falls back."""
        if self.mesh is not None:
            self._shard_decode(fused)
            return fused
        if not fused:
            return False
        layers = self.decode_params["lm"]["layers"]
        if not _dl.supported(self.config.text_config, layers, self._chain_rows()):
            raise ValueError(
                "fused_decode (the default on a CUDA device) needs one KV head and the "
                "int8 decode tree of runtime.quantize.quantize_lm_for_serving; pass "
                "decode_params=that tree, or fused_decode=False for the plain path")
        dp = dict(self.decode_params)
        dp["lm"] = dict(dp["lm"])
        dp["lm"]["layers"] = _dl.repack_layers(layers)
        if "head_q" in dp["lm"]:
            dp["lm"]["head_q"] = _dh.repack_head(dp["lm"]["head_q"])
        self.decode_params = dp
        return True

    def _chain_rows(self) -> int:
        """Rows the decode chain takes at once: this rank's slots, times
        the verify block under speculation."""
        return self._n_rows * ((self.spec_draft_k + 1) if self.spec_decode else 1)

    def _chain_tick(self) -> bool:
        """Whether the ticks run the decode kernel chain (which takes a
        bank's kernel operands; hook: the paged engine's page walks do not)."""
        return self.fused_decode

    def _init_cache(self):
        """Allocate the KV backend (hook: the paged engine allocates pages)."""
        return gemma.init_kv_cache(self._kv_cfg, self.max_slots,
                                   self.max_seq_len, self.cache_dtype, device=self.device)

    def _kv_bucket(self, highest_write_pos: int) -> Optional[int]:
        """Smallest power-of-two cache window (>= 512) covering the position;
        None = the full cache."""
        b = 512
        while b < highest_write_pos + 1:
            b *= 2
        return b if b < self.max_seq_len else None

    def _zero_state(self) -> Dict[str, torch.Tensor]:
        n, dev = self._n_rows, self.device
        state = {
            "next_tok": torch.zeros((n,), dtype=torch.int32, device=dev),
            "valid": torch.zeros((n, self.max_seq_len), dtype=torch.bool, device=dev),
            "write_pos": torch.zeros((n,), dtype=torch.int32, device=dev),
            "pos_ids": torch.ones((n,), dtype=torch.int32, device=dev),
            "logits": torch.zeros((n, self.config.vocab_size), dtype=torch.float32, device=dev),
            # per-slot multi-LoRA bank row (0 = the base model)
            "adapter": torch.zeros((n,), dtype=torch.int32, device=dev),
            # per-slot grammar id (0 = unconstrained) and live DFA state
            "gid": torch.zeros((n,), dtype=torch.int32, device=dev),
            "dstate": torch.zeros((n,), dtype=torch.int32, device=dev),
        }
        if self.spec_decode:
            # each row's token history at its cache positions (the last
            # column takes the writes of positions not kept) and its budget
            # left, counted down on the device
            state["hist"] = torch.zeros((n, self.max_seq_len + 1), dtype=torch.int64, device=dev)
            state["left"] = torch.zeros((n,), dtype=torch.int32, device=dev)
        return state

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> device without waiting for queued device work (a
        copy from pinned memory on a CUDA device; ``torch.tensor(...,
        device=...)`` would wait for the card to drain)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        """Queue a request. An over-long prompt raises here, so that one bad
        request cannot stop the scheduler for everyone else."""
        budget = self.max_seq_len - 1  # at least one decode slot must remain
        if len(req.input_ids) > budget:
            raise ValueError(
                f"request {req.request_id}: prompt of {len(req.input_ids)} tokens exceeds the "
                f"per-slot budget ({budget} = max_seq_len {self.max_seq_len} - 1 decode slot)")
        if req.lora not in self._lora_index:
            known = sorted(k for k in self._lora_index if k is not None)
            raise ValueError(
                f"request {req.request_id}: unknown LoRA adapter {req.lora!r} (engine has "
                f"{known or 'no adapters'}; pass lora_bank={{name: adapter_tree}} at "
                "construction)")
        if req.grammar is not None:
            if req.grammar not in self._grammar_index:
                known = sorted(k for k in self._grammar_index if k is not None)
                raise ValueError(
                    f"request {req.request_id}: unknown grammar {req.grammar!r} (engine has "
                    f"{known or 'no grammars'}; pass grammars={{name: TokenDFA}} at "
                    "construction)")
            g_eos = self._grammars[req.grammar].eos_token_id
            if req.eos_token_id != g_eos:
                raise ValueError(
                    f"request {req.request_id}: grammar {req.grammar!r} was compiled with "
                    f"eos_token_id {g_eos} but the request stops on {req.eos_token_id}: a "
                    "completed match could never retire the row")
        # prompt + generated never writes past max_seq_len
        req.max_new_tokens = min(req.max_new_tokens, self.max_seq_len - len(req.input_ids))
        if self.spec_decode:
            if req.do_sample:
                raise ValueError(
                    f"request {req.request_id}: spec_decode serving is greedy-only (acceptance "
                    "compares drafts with the model's argmax); submit with do_sample=False or "
                    "use an engine without spec_decode")
            # a verify writes spec_draft_k slots past the last emitted token
            req.max_new_tokens = min(req.max_new_tokens,
                                     self.max_seq_len - len(req.input_ids) - self.spec_draft_k)
            if req.max_new_tokens < 1:
                raise ValueError(
                    f"request {req.request_id}: prompt of {len(req.input_ids)} tokens leaves no "
                    f"room under spec_decode (spec_draft_k={self.spec_draft_k} slots past the "
                    f"last token must fit in max_seq_len {self.max_seq_len})")
        req.t_submit = time.perf_counter()
        self.pending.append(req)

    def cancel(self, request_id: int) -> bool:
        """Cancel a queued or seated request; False for an unknown or finished
        one. A seated request's slot frees at once, and the epoch bump makes
        an already-dispatched window discard its tokens. ``req.tokens``
        keeps what was accepted before."""
        for i, req in enumerate(self.pending):
            if req.request_id == request_id:
                del self.pending[i]
                req.done = True
                return True
        for slot, req in enumerate(self.slots):
            if req is not None and req.request_id == request_id:
                req.done = True
                req.epoch += 1
                self.slots[slot] = None
                self._release_slot(slot)
                return True
        return False

    def _bucket_of(self, req: Request) -> int:
        g = self._bucket_gran
        return min(((len(req.input_ids) + g - 1) // g) * g, self.max_seq_len)

    def _admit(self, free_slots: list) -> List[Request]:
        """Pending requests to admit this round, FIFO (hook: the paged engine
        caps admission by free pages too); removes them from ``pending``."""
        take = self.pending[: len(free_slots)]
        del self.pending[: len(take)]
        return take

    def _take_slot(self, free: list, req: Request) -> int:
        """Pop the slot ``req`` will occupy from ``free`` (hook: the
        data-parallel paged engine pins each admitted request to the shard
        whose page budget covered it in ``_admit``)."""
        return free.pop(0)

    def _check_mesh(self, mesh) -> None:
        """Mesh-contract hook: this engine is pure TP, as the JAX one is
        (the paged engine takes a data axis: it splits slots and pool)."""
        if mesh.data != 1:
            raise ValueError("serving mesh must be pure TP (data=1); slots are the batch "
                             "(the paged engine, runtime/serving_paged, takes a data axis)")

    def _row(self, slot: int) -> Optional[int]:
        """``slot``'s row in this rank's device state; None for a slot of
        another data shard."""
        r = slot - self._row0
        return r if 0 <= r < self._n_rows else None

    def _my_rows(self, t):
        """This rank's slot rows of a (max_slots, ...) array."""
        return t[self._row0:self._row0 + self._n_rows]

    def _insert_chunk(self, seated, bucket: int, cache1, mask, last_logits) -> None:
        """Seat one prefill chunk: row r goes to slot ``seated[r][0]`` (hook:
        the paged engine writes pages instead; the prefill rows are those of
        this rank's slots, ``None`` when it has none)."""
        slots = self._upload(np.asarray([slot for slot, _ in seated], np.int64))
        for n in ("k", "v"):
            self.cache[n][:, slots, :bucket] = cache1[n].to(self.cache_dtype)
        st = self.state
        st["valid"][slots] = False
        st["valid"][slots, :bucket] = mask.bool()
        st["write_pos"][slots] = self._upload(np.asarray([len(r.input_ids) for _, r in seated],
                                                         np.int32))
        st["pos_ids"][slots] = mask.sum(dim=-1).to(torch.int32) + 1
        st["logits"][slots] = last_logits
        reqs = [req for _, req in seated]
        st["next_tok"][slots] = self._first_tokens(slots, reqs, last_logits)
        self._seat_spec(slots, reqs)
        if self.lora_bank is not None:
            st["adapter"][slots] = self._adapter_ids(reqs)
        if self.prefix_cache:
            for r, (_, req) in enumerate(seated):
                self._register_dense(req, {n: cache1[n][:, r:r + 1] for n in ("k", "v")},
                                     last_logits[r])

    def _first_tokens(self, slots, reqs: List[Request], logits: torch.Tensor) -> torch.Tensor:
        """The pending token of freshly seated rows (``logits``: (n, vocab)):
        the argmax, under the seating DFA state (``_seat_dstates``) for
        constrained rows, whose grammar id and DFA state are set here. Stored
        logits stay unmasked."""
        if self.grammar_table is None:
            return logits.argmax(dim=-1).to(torch.int32)
        gids = self._upload(np.asarray([self._grammar_index[r.grammar] for r in reqs], np.int32))
        dstates = self._upload(self._seat_dstates(reqs))
        st = self.state
        st["gid"][slots] = gids
        st["dstate"][slots] = dstates
        return self._masked_argmax(logits, gids, dstates)

    def _seat_spec(self, slots: torch.Tensor, reqs: List[Request]) -> None:
        """Speculation's state of freshly seated rows: the history (the ids
        the row was prefilled with, then its pending token at their end)
        and the budget left."""
        if not self.spec_decode:
            return
        st = self.state
        hist = np.zeros((len(reqs), self.max_seq_len + 1), np.int64)
        lens = np.zeros((len(reqs),), np.int64)
        for i, r in enumerate(reqs):
            lens[i] = len(r.input_ids)
            hist[i, :lens[i]] = r.input_ids
        st["hist"][slots] = self._upload(hist)
        st["hist"][slots, self._upload(lens)] = st["next_tok"][slots].long()
        st["left"][slots] = self._upload(np.asarray([r.max_new_tokens for r in reqs], np.int32))

    def _seat_dstates(self, reqs: List[Request]) -> np.ndarray:
        """Each row's DFA state at seating: the start state, or, for a
        recompute request (a preempted row seated again), the state its
        grammar reaches over the tokens it already emitted (its ids past the
        prefix), walked on the host table."""
        out = np.zeros((len(reqs),), np.int32)
        for i, r in enumerate(reqs):
            if r.grammar is None or r.prefix_len is None:
                continue
            table, s = self._grammars[r.grammar].table, 0
            for t in r.input_ids[r.prefix_len:]:
                s = int(table[s, t])
                if s < 0:
                    raise RuntimeError(f"request {r.request_id}: its emitted tokens leave "
                                       f"grammar {r.grammar!r}")
            out[i] = s
        return out

    def _masked_argmax(self, logits, gids, dstates) -> torch.Tensor:
        """Argmax over the tokens each row's grammar allows in its state."""
        allowed = self.grammar_table[gids, dstates] >= 0
        return torch.where(allowed, logits, -torch.inf).argmax(dim=-1).to(torch.int32)

    def _register_dense(self, req: Request, kv: Dict[str, torch.Tensor], logits) -> None:
        """Keep a freshly prefilled prompt's KV rows ((L, 1, bucket, ...))
        and last-logits row as a prefix-cache entry (LRU at capacity)."""
        key = self._pcache_key(req)
        if key is None or key in self._dense_pcache:
            return
        self._dense_pcache[key] = dict(k=kv["k"].clone(), v=kv["v"].clone(),
                                       logits=logits.clone(), prompt_len=len(req.input_ids))
        while len(self._dense_pcache) > self.prefix_cache_entries:
            self._dense_pcache.popitem(last=False)

    def _pcache_key(self, req: Request) -> Optional[bytes]:
        """Exact-match prefix-cache key, or None when uncacheable: the bytes
        of the ids and pixels (the bidirectional prefix rules out partial
        reuse) and the adapter name (the prefix KV is computed through the
        adapter). Recompute requests (a preempted prompt + its regenerated
        tokens) are not cacheable."""
        if not self.prefix_cache or req.prefix_len is not None:
            return None
        if req.cache_key is None:
            h = hashlib.sha1()
            h.update(np.asarray(req.input_ids, np.int32).tobytes())
            h.update(np.ascontiguousarray(np.asarray(req.pixel_values, np.float32)).tobytes())
            if req.lora is not None:
                h.update(req.lora.encode())
            req.cache_key = h.digest()
        return req.cache_key

    def _insert_cached(self, slot: int, req: Request) -> bool:
        """Seat ``req`` in ``slot`` from its prefix-cache entry, with no
        prefill: copy the entry's KV rows into the slot and rebuild its
        state from the stored logits (hook: the paged engine borrows
        pages). False on a miss."""
        key = self._pcache_key(req)
        entry = self._dense_pcache.get(key) if key is not None else None
        if entry is None:
            return False
        n = entry["k"].shape[2]
        for name in ("k", "v"):
            self.cache[name][:, slot:slot + 1, :n] = entry[name]
        self._seat_state(slot, req, entry["prompt_len"], entry["logits"])
        st = self.state
        st["valid"][slot] = False
        st["valid"][slot, :entry["prompt_len"]] = True
        self._dense_pcache.move_to_end(key)
        self.cache_hits += 1
        return True

    def _seat_state(self, slot: int, req: Request, prompt_len: int, logits) -> None:
        """One seated row's state from its prompt's last-logits row
        ((vocab,), a prefill's or a cache entry's): the prompt is dense in
        [0, prompt_len). Nothing for a slot of another data shard."""
        row = self._row(slot)
        if row is None:
            return
        st = self.state
        st["write_pos"][row] = prompt_len
        st["pos_ids"][row] = prompt_len + 1
        st["logits"][row] = logits
        st["next_tok"][row:row + 1] = self._first_tokens(slice(row, row + 1), [req],
                                                         logits[None])
        if self.spec_decode:
            self._seat_spec(self._upload(np.asarray([row], np.int64)), [req])
        if self.lora_bank is not None:
            st["adapter"][row:row + 1] = self._adapter_ids([req])

    def _release_slot(self, slot: int) -> None:
        """Called when a request retires (hook: the paged engine frees pages)."""

    def _adapter_ids(self, reqs: List[Request]) -> torch.Tensor:
        """(n,) int32 bank rows of ``reqs`` on the device."""
        return self._upload(np.asarray([self._lora_index[r.lora] for r in reqs], np.int32))

    def _lora_arg(self) -> Optional[Dict[str, Any]]:
        """The bank of the decode ticks, with its kernel operands when the
        ticks run the kernels."""
        if self.lora_bank is None or self._lora_fused_pack is None:
            return self.lora_bank
        return {**self.lora_bank, "__fused_pack__": self._lora_fused_pack}

    def _fill_slots(self) -> None:
        free = [i for i in range(self.max_slots) if self.slots[i] is None]
        if not free or not self.pending:
            return
        take = self._admit(free)
        assigned = [(self._take_slot(free, req), req) for req in take]
        while assigned:
            # cache hits seat at once; a duplicate of a request about to
            # prefill in this wave (the same key) waits one pass and seats
            # from the entry its leader registers
            need_prefill, deferred, leaders = [], [], set()
            for slot, req in assigned:
                if self._insert_cached(slot, req):
                    self._seated(slot, req)
                    continue
                key = self._pcache_key(req)
                if key is not None and key in leaders:
                    deferred.append((slot, req))
                    continue
                if key is not None:
                    leaders.add(key)
                need_prefill.append((slot, req))
            self._prefill_wave(need_prefill)
            # a follower whose leader registered nothing prefills next pass
            assigned = deferred

    def _seated(self, slot: int, req: Request) -> None:
        self.slots[slot] = req
        req.slot = slot
        req.t_seated = time.perf_counter()
        self._generated[req.request_id] = 0
        self._dispatched[req.request_id] = 0

    def _prefill_wave(self, need_prefill: list) -> None:
        """Group by prompt-length bucket, then split each group into exact
        power-of-two chunks (16 + 4 + 1 for 21): one prefill per chunk, of
        the chunk's rows in this rank's slots (a data shard prefills its
        own rows; ``prefill_calls`` counts the chunks)."""
        groups: Dict[int, list] = {}
        for slot, req in need_prefill:
            groups.setdefault(self._bucket_of(req), []).append((slot, req))
        chunks = []
        for bucket, seated in groups.items():
            while seated:
                take = 1 << (len(seated).bit_length() - 1)  # largest pow2 <=
                chunks.append((bucket, seated[:take]))
                seated = seated[take:]
        for bucket, seated in chunks:
            mine = [(slot, req) for slot, req in seated if self._row(slot) is not None]
            cache1 = mask = logits = None
            if mine:
                cache1, mask, logits = self._prefill_rows(bucket, mine)
            self.prefill_calls += 1
            self._insert_chunk(seated, bucket, cache1, mask, logits)
            for slot, req in seated:
                self._seated(slot, req)

    def _prefill_rows(self, bucket: int, seated: list):
        """One prefill of ``seated``'s prompts at ``bucket``: (the
        bucket-long KV cache, the mask, the (n, vocab) last logits)."""
        n = len(seated)
        ids_np = np.zeros((n, bucket), np.int32)
        mask_np = np.zeros((n, bucket), np.int32)
        pfx_np = np.zeros((n,), np.int32)
        pix_np = np.zeros((n,) + tuple(seated[0][1].pixel_values.shape), np.float32)
        for r, (_, req) in enumerate(seated):
            s = len(req.input_ids)
            ids_np[r, :s] = req.input_ids
            mask_np[r, :s] = 1
            pfx_np[r] = s if req.prefix_len is None else req.prefix_len
            pix_np[r] = req.pixel_values
        mask = self._upload(mask_np)
        # the prefill writes exactly [0, bucket): a bucket-long cache
        cache1 = gemma.init_kv_cache(self._kv_cfg, n, bucket, self.cache_dtype,
                                     device=self.device)
        lora_kw = {}
        if self.lora_bank is not None:
            lora_kw = dict(lora=self.lora_bank,
                           adapter_ids=self._adapter_ids([req for _, req in seated]))
        logits, cache1 = paligemma.prefill(
            self.params, self.config, self._upload(pix_np), self._upload(ids_np).long(),
            mask, cache1, use_flash=self.use_flash, last_only=True,
            prefix_lens=self._upload(pfx_np), mesh=self.mesh, **lora_kw,
            int8_act=self.int8_act_prefill,
        )
        return cache1, mask, logits[:, 0]

    @property
    def has_work(self) -> bool:
        return bool(self.pending) or any(r is not None for r in self.slots)

    def _before_window(self, ticks: int) -> None:
        """Hook run before each decode window, after admission: the paged
        engine grows page allocations here (and may preempt)."""

    def _select(self, temps, top_ps, do_samples, with_sampling: bool) -> torch.Tensor:
        """The token each row consumes this tick: the carried greedy token,
        or a top-p draw from the row's stored logits for sampled rows."""
        st = self.state
        greedy_tok = st["next_tok"]
        if not with_sampling:
            return greedy_tok
        logits = st["logits"]
        if self.grammar_table is not None:
            # sampled rows draw under their live DFA state's mask
            allowed = self.grammar_table[st["gid"], st["dstate"]] >= 0
            logits = torch.where(allowed, logits, -torch.inf)
        noise = None
        if self.dp_mesh is not None:
            # the whole slot batch's draws, as one card draws them; this
            # rank keeps its rows
            noise = self._my_rows(sampling.gumbel_noise((self.max_slots, logits.shape[-1]),
                                                        self.generator, logits.device))
        sampled = sampling.sample_top_p(self.generator, logits, temps, top_ps, noise=noise)
        return torch.where(do_samples, sampled, greedy_tok)

    def _advance_dfa(self, active, token) -> None:
        """Each active row's DFA steps by the token it consumes; inactive
        rows hold their state."""
        if self.grammar_table is None:
            return
        st = self.state
        nxt = self.grammar_table[st["gid"], st["dstate"], token.long()].to(torch.int32)
        st["dstate"] = torch.where(active, nxt, st["dstate"])

    def _advance(self, active, next_tok, new_logits=None) -> None:
        """Per-row state after a tick: active rows step their positions and
        take the new pending token (and logits, when the tick made them).

        A row whose request filled the cache to ``max_seq_len`` keeps
        writing on every later tick until its slot is seated again (its
        output is discarded). Its write position is clamped to the row's
        last slot, so that those writes stay in the row: an active row never
        reaches the clamp (``submit`` caps its budget)."""
        st = self.state
        inc = active.to(torch.int32)
        st["write_pos"] = (st["write_pos"] + inc).clamp_(max=self.max_seq_len - 1)
        st["pos_ids"] = st["pos_ids"] + inc
        if new_logits is not None:
            st["logits"] = torch.where(active[:, None], new_logits, st["logits"])
            if self.grammar_table is None:
                next_tok = new_logits.argmax(dim=-1).to(torch.int32)
            else:  # chosen under the state the DFA just stepped to
                next_tok = self._masked_argmax(new_logits, st["gid"], st["dstate"])
        st["next_tok"] = torch.where(active, next_tok, st["next_tok"])

    def _tick(self, active, temps, top_ps, do_samples, with_sampling, kv_bucket):
        """One lockstep decode step; returns the (max_slots,) token consumed."""
        token = self._select(temps, top_ps, do_samples, with_sampling)
        self._advance_dfa(active, token)
        st = self.state
        st["valid"][self._rows, st["write_pos"].long()] = active
        kw = dict(cache_pos=st["write_pos"], kv_valid=st["valid"],
                  position_ids=st["pos_ids"], kv_bucket=kv_bucket, **self._tick_lora())
        if self._head_argmax_tick(with_sampling):
            # greedy tick: the argmax head kernel returns the ids; the
            # (slots, vocab) logits row is never written (stored logits go
            # stale, and greedy selection never reads them)
            next_tok, _ = paligemma.decode_step_greedy(
                self.decode_params, self.config, token, self.cache, mesh=self.mesh, **kw)
            self._advance(active, next_tok)
        else:
            new_logits, _ = paligemma.decode_step(
                self.decode_params, self.config, token, self.cache,
                fused_layer=self.fused_decode, mesh=self.mesh, **kw)
            self._advance(active, None, new_logits)
        return token

    def _head_argmax_tick(self, with_sampling: bool) -> bool:
        """Whether a tick takes the argmax head kernel: greedy windows on the
        kernel path with no constrained row seated (a grammar needs the
        logits to mask; the host knows each seated row's grammar)."""
        return (not with_sampling and self.fused_decode
                and not any(r is not None and r.grammar is not None for r in self.slots))

    def _tick_lora(self) -> Dict[str, Any]:
        """The bank and each slot's bank row for a tick ({} without a bank)."""
        if self.lora_bank is None:
            return {}
        return dict(lora=self._lora_arg(), adapter_ids=self.state["adapter"])

    def _decode_window(self, lefts, ticks: int, tick) -> torch.Tensor:
        """``ticks`` lockstep steps enqueued with no host synchronization;
        ``tick(active)`` runs one and returns the tokens consumed. ``lefts``:
        each row's remaining dispatch budget; a row goes inactive when it
        runs out (its positions stop, the tokens it still emits are
        discarded at absorb). Returns the (ticks, max_slots) tokens."""
        tokens = []
        for _ in range(ticks):
            tokens.append(tick(lefts > 0))
            lefts = (lefts - 1).clamp(min=0)
        return torch.stack(tokens)

    def _run_window(self, ticks: int, lefts, temps, top_ps, do_samples,
                    with_sampling: bool) -> torch.Tensor:
        """One decode window (hook: the paged engine walks its pool). The
        attended window covers every active row's positions through this
        window, from host bookkeeping (prompt + tokens dispatched so far)."""
        kv_bucket = self._kv_bucket(max(
            (len(r.input_ids) + self._dispatched[r.request_id] for r in self.slots
             if r is not None), default=0) + ticks)
        return self._decode_window(lefts, ticks, lambda active: self._tick(
            active, temps, top_ps, do_samples, with_sampling, kv_bucket))

    # -- speculative windows (module docstring) --------------------------
    def _verify(self, tokens_in, greedy: bool, kv_arg):
        """The verify forward of a spec cycle over the slots' (B, s) inputs:
        (B, s) ids with ``greedy`` (the argmax head), else (B, s, vocab)
        logits (hook: the paged engine verifies over its pool)."""
        st = self.state
        return paligemma.decode_verify(
            self.decode_params, self.config, tokens_in, self.cache, st["write_pos"],
            st["valid"], st["pos_ids"], kv_bucket=kv_arg, fused_layer=self.fused_decode,
            greedy_head=greedy, mesh=self.mesh)[0]

    def _spec_cycle(self, greedy: bool, kv_arg):
        """One verify cycle of every row on the device: drafts, verify,
        acceptance, state. Returns ((B, k + 1) inputs, zero past each row's
        count; (B,) count emitted)."""
        st = self.state
        kd = self.spec_draft_k
        left, wp = st["left"], st["write_pos"]
        active = left > 0
        draft = propose_ngram(st["hist"], wp + 1, self.spec_match_n, kd)  # (B, k)
        if self.spec_corrupt_frac > 0.0:
            # the whole slot batch's draws; this rank keeps its rows
            u = self._my_rows(torch.rand((self.max_slots, kd), generator=self.generator,
                                         device=draft.device))
            draft = torch.where(u < self.spec_corrupt_frac,
                                (draft + 1) % self.config.text_config.vocab_size, draft)
        tokens_in = torch.cat([st["next_tok"].long()[:, None], draft], dim=1)  # (B, k + 1)
        out = self._verify(tokens_in, greedy, kv_arg)
        dstates = None
        if self.grammar_table is not None:
            # s_{i+1}: the state after tokens_in[:, :i+1], from the live state
            # (the one before the pending token); position i's argmax is
            # masked by s_{i+1}. A -1 (left the grammar) is clamped for the
            # gather: acceptance stops before such a position matters
            gid, cur, states = st["gid"], st["dstate"], []
            for i in range(kd + 1):
                cur = self.grammar_table[gid, cur.clamp(min=0), tokens_in[:, i]].to(torch.int32)
                states.append(cur)
            dstates = torch.stack(states, dim=1)  # (B, k + 1)
            if not greedy:  # a greedy verify has no constrained row seated
                allowed = self.grammar_table[gid[:, None], dstates.clamp(min=0)] >= 0
                out = torch.where(allowed, out, -torch.inf)
        g = (out if greedy else out.argmax(dim=-1)).long()  # (B, k + 1)
        n_acc = torch.cumprod((draft == g[:, :kd]).long(), dim=1).sum(dim=1)
        n_keep = torch.where(active, torch.minimum(n_acc + 1, left.long()),
                             torch.zeros_like(n_acc))
        j = torch.arange(kd + 1, device=g.device)[None]
        if "valid" in st:  # only the emitted slots become attendable
            sidx = torch.arange(self.max_seq_len, device=g.device)[None]
            st["valid"] |= (sidx >= wp[:, None]) & (sidx < (wp + n_keep)[:, None])
        last = (n_keep - 1).clamp(min=0)[:, None]
        nxt = torch.where(active, g.gather(1, last)[:, 0], st["next_tok"].long())
        # history: the kept drafts at wp + 1 .., then the new pending token
        dump = self.max_seq_len
        tgt_d = torch.where((j[:, :kd] < (n_keep - 1)[:, None]) & active[:, None],
                            wp.long()[:, None] + 1 + j[:, :kd], dump)
        st["hist"].scatter_(1, tgt_d, draft)
        tgt_n = torch.where(active, wp.long() + n_keep, dump)
        st["hist"].scatter_(1, tgt_n[:, None], nxt[:, None])
        st["next_tok"] = nxt.to(torch.int32)
        st["write_pos"] = wp + n_keep.to(torch.int32)
        st["pos_ids"] = st["pos_ids"] + n_keep.to(st["pos_ids"].dtype)
        st["left"] = left - n_keep.to(torch.int32)
        if dstates is not None:
            kept_state = dstates.gather(1, last)[:, 0]
            st["dstate"] = torch.where(n_keep > 0, kept_state, st["dstate"])
        return torch.where(j < n_keep[:, None], tokens_in, torch.zeros_like(tokens_in)), n_keep

    def _spec_window_arg(self, ticks: int):
        """The attended window of a spec window (hook: pages for the paged
        engine): every cycle may emit ``spec_draft_k + 1`` tokens and
        writes ``spec_draft_k`` past them, plus under pipelining one window
        the host has not read back yet."""
        per_window = ticks * (self.spec_draft_k + 1)
        lag = per_window if self.pipeline else 0
        return self._kv_bucket(max(
            (len(r.input_ids) + self._generated[r.request_id] for r in self.slots
             if r is not None), default=0) + per_window + lag + self.spec_draft_k)

    def _spec_greedy(self) -> bool:
        """Whether the verify takes the argmax head: the kernel path with no
        constrained row seated (hook: the paged engine's chain)."""
        return self._head_argmax_tick(False)

    def _run_spec_window(self, ticks: int):
        """``ticks`` verify cycles enqueued with no host synchronization;
        returns ((ticks, B, k + 1) tokens, (ticks, B) counts)."""
        kv_arg = self._spec_window_arg(ticks)
        greedy = self._spec_greedy()
        outs = [self._spec_cycle(greedy, kv_arg) for _ in range(ticks)]
        return (torch.stack([o for o, _ in outs]).to(torch.int32),
                torch.stack([c for _, c in outs]).to(torch.int32))

    def _dispatch_spec(self) -> Optional[_Window]:
        """``_dispatch`` under speculation: the budgets live on the device
        (``state["left"]``, set at seating), so the host sizes windows from
        the counts it has read back; under pipelining they lag one window,
        and a row whose device budget ran out emits nothing until its
        window is absorbed. Page growth and the attended window assume
        every cycle accepts every draft."""
        def _lefts():
            return [r.max_new_tokens - self._generated[r.request_id] if r is not None else 0
                    for r in self.slots]

        maxleft = max(_lefts(), default=0)
        if maxleft <= 0:
            return None
        ticks = self.sync_every if maxleft >= self.sync_every else 1
        per_window = ticks * (self.spec_draft_k + 1)
        self._before_window(per_window + self.spec_draft_k)  # may preempt slots (paged)
        lefts = _lefts()
        if not any(l > 0 for l in lefts):
            return None
        (tokens, counts), ready = _read_back(*self._run_spec_window(ticks))
        snapshot: List[Optional[tuple]] = []
        for slot, req in enumerate(self.slots):
            if req is not None and lefts[slot] > 0:
                self._dispatched[req.request_id] = min(
                    req.max_new_tokens, self._dispatched[req.request_id] + per_window)
                snapshot.append((req, req.epoch))
            else:
                snapshot.append(None)
        return _Window(tokens, ticks, snapshot, ready, counts)

    def _dispatch(self) -> Optional[_Window]:
        """Fill free slots, size one decode window from dispatched budgets
        and enqueue it. Returns the window (None when no slot can decode);
        ``ticks`` is ``sync_every``, or 1 for tail windows."""
        self._fill_slots()
        if self.spec_decode:
            return self._dispatch_spec()

        def _lefts():
            return [r.max_new_tokens - self._dispatched[r.request_id] if r is not None else 0
                    for r in self.slots]

        maxleft = max(_lefts(), default=0)
        if maxleft <= 0:
            return None
        ticks = self.sync_every if maxleft >= self.sync_every else 1
        self._before_window(ticks)  # may preempt slots (paged)
        lefts = _lefts()  # again: preemption changes the slot set
        if not any(l > 0 for l in lefts):
            return None
        # per-request sampling arrays, re-uploaded only when the slot
        # composition changes
        fingerprint = tuple(r.request_id if r else None for r in self.slots)
        if self._sched_cache is None or self._sched_cache[0] != fingerprint:
            temps = np.asarray([r.temperature if r else 1.0 for r in self.slots], np.float32)
            top_ps = np.asarray([r.top_p if r else 1.0 for r in self.slots], np.float32)
            do_s = np.asarray([bool(r.do_sample) if r else False for r in self.slots])
            self._sched_cache = (fingerprint, tuple(self._upload(self._my_rows(a))
                                                    for a in (temps, top_ps, do_s)))
        temps_t, top_t, do_t = self._sched_cache[1]
        with_sampling = any(r is not None and r.do_sample for r in self.slots)
        charges = [min(ticks, max(l, 0)) for l in lefts]
        tokens = self._run_window(ticks, self._upload(self._my_rows(np.asarray(charges, np.int32))),
                                  temps_t, top_t, do_t, with_sampling)
        (tokens,), ready = _read_back(tokens)
        snapshot: List[Optional[tuple]] = []
        for slot, req in enumerate(self.slots):
            if req is not None and charges[slot] > 0:
                self._dispatched[req.request_id] += charges[slot]
                snapshot.append((req, req.epoch))
            else:
                snapshot.append(None)
        return _Window(tokens, ticks, snapshot, ready)

    def _absorb(self, window: _Window) -> List[Request]:
        """Read one window's tokens back (the only host synchronization) and
        retire finished requests. Tokens of requests that retired, were
        cancelled or were preempted after dispatch are discarded. Under a
        data axis the shards' tokens (and counts) are gathered here, in one
        collective each: every rank then decides on all slots alike."""
        if window.ready is not None:
            window.ready.synchronize()
        tokens, counts = window.tokens, window.counts
        if self.dp_mesh is not None:  # (ticks, slots, ...): the shards' slots in order
            tokens, counts = (None if t is None else mesh_lib.gather_data(t, self.dp_mesh, dim=1)
                              for t in (tokens, counts))
        token_np = tokens.numpy()
        counts_np = None if counts is None else counts.numpy()
        finished: List[Request] = []
        for slot, snap in enumerate(window.snapshot):
            if snap is None:
                continue
            req, epoch = snap
            if req.done or req.epoch != epoch or self.slots[slot] is not req:
                continue  # retired/preempted since dispatch
            now = time.perf_counter()
            if counts_np is None:
                toks = [int(token_np[t, slot]) for t in range(window.ticks)]
            else:  # cycle t emitted the first counts[t, slot] of its inputs
                toks = [int(token_np[t, slot, i]) for t in range(window.ticks)
                        for i in range(int(counts_np[t, slot]))]
            for tok in toks:
                req.tokens.append(tok)
                if req.t_first_token is None:
                    req.t_first_token = now
                if req.on_token is not None:
                    req.on_token(tok)
                self._generated[req.request_id] += 1
                out_of_budget = (
                    self._generated[req.request_id] >= req.max_new_tokens
                    or len(req.input_ids) + self._generated[req.request_id] >= self.max_seq_len
                )
                if tok == req.eos_token_id or out_of_budget:
                    req.done = True
                    req.t_finished = now
                    finished.append(req)
                    self.slots[slot] = None
                    self._release_slot(slot)
                    break  # overshoot tokens within the window are discarded
        return finished

    def step(self) -> List[Request]:
        """One scheduler round, unpipelined: fill slots, decode one window,
        read it back, retire finished requests. Returns the finished ones."""
        window = self._dispatch()
        return self._absorb(window) if window is not None else []

    def advance(self, inflight: Optional[_Window] = None, pipeline: Optional[bool] = None
                ) -> Tuple[List[Request], Optional[_Window]]:
        """One scheduler round of a caller's loop: returns the requests it
        finished and the window left in flight, to pass to the next call
        (run ``while engine.has_work or inflight is not None``). With
        ``pipeline`` (default: the engine's), window N+1 is enqueued before
        window N is read back; each request's tokens are the same, only
        retirement and admission shift by one window. Without it no window
        is left in flight."""
        if not (self.pipeline if pipeline is None else pipeline):
            return (self.step() if self.has_work else []), None
        window = self._dispatch() if self.has_work else None
        if inflight is not None:
            return self._absorb(inflight), window
        if window is None and self.has_work:
            # nothing dispatchable and nothing in flight (the head of the
            # queue cannot be admitted yet): one stepwise round
            return self.step(), None
        return [], window

    def run_to_completion(self, pipeline: Optional[bool] = None) -> List[Request]:
        """Drain the queue (``advance`` until nothing is left)."""
        done: List[Request] = []
        inflight: Optional[_Window] = None
        while self.has_work or inflight is not None:
            finished, inflight = self.advance(inflight, pipeline)
            done.extend(finished)
        return done
