"""Inference engine (port of paligemma_tpu/runtime/engine.py).

* ``prefill``: vision encode + merge + decoder over the prompt, writing the
  preallocated KV cache at [0, S); with ``int8_act_prefill`` from the int8
  tree, its LM projections W8A8 (single-copy serving).
* ``decode_step``: one token; the cache and the validity bitmap of the
  state are updated in place (the reference donates them to the jit).
* ``decode_chunk``: ``n_steps`` steps with token selection and per-row EOS
  masking on the device; the greedy fast path carries the (B,) token
  between steps instead of (B, vocab) logits.
* ``generate``: the reference-compatible loop, at ``sync_every=1`` (host
  EOS check per token) or ``> 1`` (one check per chunk).
* ``generate_spec``: greedy generation with n-gram speculative decoding
  (B = 1): per cycle the proposer (ops/ngram) drafts ``draft_k`` tokens
  from the history on the device, one verify forward
  (models/paligemma.decode_verify) scores them, and the longest prefix
  that matches the model's own argmax is kept, plus the model's token
  after it. Cycles run in windows of ``sync_every`` with no host read
  inside; the tokens equal ``generate``'s.

``use_flash`` and ``fused_layer`` default to True on a CUDA device: prefill
attention then runs the flash kernel and decode the hand-written decode
kernels. False keeps the plain torch path. A decode tree or config the
kernels cannot take raises when ``fused_layer`` is on; it never falls back.
``fused_mlp`` (one card, off by default, as in the JAX engine) keeps the
plain layers but runs each layer's decode MLP through kernels/decode_mlp.

``mesh`` (core/mesh.make_mesh; one process per rank): tensor parallel over
the model axis. The engine takes the whole params on every rank and keeps
this rank's slices (core/mesh.shard_params; k and v by KV heads, the KV
cache at the rank's KV heads). Prefill runs the plain sharded models;
``fused_layer`` (or ``fused_mlp``) asks for the tensor-parallel kernels
(kernels/decode_layer_tp) on the ``repack_for_tp`` tree, the greedy chunks
through its vocab-sharded argmax head, sampled chunks through the gathered
int8-head logits. The engine decides once, from the layout, as JAX's
engine does: where ``decode_layer_tp.supported`` refuses the tree or
config (more than one KV head, no int8 tree or head) the default takes the
plain sharded decode (the torch-op TP step), and ``fused_layer`` after
construction says which path was taken; an explicit ``fused_layer=True``
or ``fused_mlp=True`` it refuses raises. Every rank returns the same
tokens: the same seed gives each rank's sampling generator the same draws
over the same gathered logits. ``generate_spec`` under a mesh verifies through the same chain at
``draft_k + 1`` rows (or the plain sharded forward), and every rank accepts
the same drafts.

A ``mesh`` with a data axis (``data`` > 1, with or without a model axis):
each rank prefills and decodes its own ``B/data`` rows of ``generate``'s
batch (``B % data`` raises ``ValueError``, as JAX's ``device_put`` on
``P("data")`` does), under pure DP on one card's kernels. The values the
loop reads back (each chunk's tokens, the EOS flags) are gathered over the
data group where it reads them (core/mesh.gather_data), so every rank
stops at the same step and returns the whole batch. Sampled rows: every
rank draws the whole batch's noise from the generator and keeps its own
rows, so a seed samples the one-card tokens. ``prefill``, ``decode_step``
and ``decode_chunk`` take the rank's rows as they are given.
``generate_spec`` is B == 1 and raises under a data axis.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..core import mesh as mesh_lib
from ..core.config import PaliGemmaConfig
from ..kernels import decode_head as _dh
from ..kernels import decode_layer as _dl
from ..kernels import decode_layer_tp as _tp
from ..kernels import decode_mlp as _dm
from ..models import gemma, paligemma
from ..ops import sampling
from ..ops.ngram import propose_ngram


# (activations, KV cache) dtype pairs the card's decode kernels take: the
# uniform pairs and the two mixed ones (the kernels' mixed forms)
CARD_CACHE_PAIRS = ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
                    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16))


def check_cache_dtype(device: torch.device, params: Dict[str, Any],
                      cache_dtype: torch.dtype, what: str) -> None:
    """On the card the decode kernels read and write the KV cache in bf16 or
    fp32 beside bf16 or fp32 activations (the embedding table's dtype): the
    four pairs of ``CARD_CACHE_PAIRS``, a cache of the other dtype through
    the kernels' mixed forms. Any other pair raises here, at construction,
    not at the first kernel. (Prefill attends over the fresh k / v in the
    activation dtype, so only the decode kernels read the cache.)"""
    act = params["lm"]["embed"].dtype
    if device.type == "cuda" and (act, cache_dtype) not in CARD_CACHE_PAIRS:
        pairs = ", ".join(f"({a}, {c})" for a, c in CARD_CACHE_PAIRS)
        raise ValueError(f"{what}: a {cache_dtype} KV cache beside {act} activations on the "
                         f"card: the kernels take the (activations, cache) pairs {pairs}")


class KVState(NamedTuple):
    """Decode state; ``cache`` and ``valid`` are updated in place."""

    cache: Dict[str, torch.Tensor]
    valid: torch.Tensor  # (B, max_seq) bool: attendable cache slots
    write_pos: int  # next cache write index (lockstep rows)
    pos_ids: torch.Tensor  # (B,) int32 RoPE position of the next token


class PaliGemmaEngine:
    def __init__(
        self,
        params: Dict[str, Any],
        config: PaliGemmaConfig,
        max_seq_len: int = 1024,
        cache_dtype: Optional[torch.dtype] = None,
        eos_token_id: int = 1,
        use_flash: Optional[bool] = None,
        mesh=None,
        decode_params: Optional[Dict[str, Any]] = None,
        *,
        fused_mlp: Optional[bool] = None,
        fused_layer: Optional[bool] = None,
        int8_act_prefill: bool = False,
    ):
        """The JAX engine's parameters in its order, up to its
        ``decode_scan_block`` (a TPU workaround the port does not take);
        the rest are keyword-only.

        ``decode_params``: optional second weight set used only for
        decode (e.g. the int8 tree of runtime.quantize) while ``params``
        serves the prefill. The device is the one the params live on; the
        KV cache takes ``cache_dtype``, by default the embedding table's
        (on the card bf16 or fp32 under bf16 or fp32 activations:
        :func:`check_cache_dtype`).

        ``int8_act_prefill``: when ``params`` itself is the int8 tree
        (single-copy serving: ``params`` and ``decode_params`` the same
        tree, no bf16 copy of the LM held), every prefill runs its LM
        projections of at least 256 rows as W8A8, each row of activations
        quantized to int8 (kernels/w8a8 on the card); the head and smaller
        calls stay weight-only (kernels/quant.matmul_any)."""
        self.int8_act_prefill = bool(int8_act_prefill)
        self.config = config
        self.max_seq_len = max_seq_len
        self.eos_token_id = eos_token_id
        self.device = params["lm"]["embed"].device
        self.cache_dtype = cache_dtype or params["lm"]["embed"].dtype
        check_cache_dtype(self.device, params, self.cache_dtype, "PaliGemmaEngine")
        on_cuda = self.device.type == "cuda"
        self.use_flash = on_cuda if use_flash is None else use_flash
        self.fused_layer = on_cuda if fused_layer is None else fused_layer
        self.fused_mlp = bool(fused_mlp)
        # the model axis the weights shard over; the data axis the batch
        # splits over
        self.mesh, self.dp_mesh = mesh_lib.split_axes(mesh)
        mesh = self.mesh
        full_decode = decode_params if decode_params is not None else params
        tc = config.text_config
        kv_heads = tc.num_key_value_heads
        self.params = (params if mesh is None
                       else mesh_lib.shard_params(params, mesh, kv_heads=kv_heads))
        # the KV cache's config: the rank's KV heads under a mesh
        self._kv_cfg = tc if mesh is None else mesh_lib.local_text_config(tc, mesh.model)
        if mesh is not None:
            # either flag asks for the tensor-parallel kernels; the layout
            # decides (module docstring)
            chain = (_tp.supported(tc, mesh, full_decode["lm"]["layers"], batch=1)
                     and "head_q" in full_decode["lm"])
            if (fused_layer or fused_mlp) and not chain:
                raise ValueError(
                    "fused_layer / fused_mlp under a mesh need what kernels/decode_layer_tp."
                    "supported accepts (the int8 decode tree with its head, one KV head, "
                    "heads / vocab / MLP width divisible by the model axis); leave them unset "
                    "for the plain sharded decode")
            self.fused_layer = (self.fused_layer or self.fused_mlp) and chain
            self.fused_mlp = False
            if self.fused_layer:
                self.decode_params = {"lm": _tp.repack_for_tp(full_decode["lm"],
                                                              config.text_config, mesh)}
            else:
                self.decode_params = (self.params if decode_params is None else
                                      mesh_lib.shard_params(decode_params, mesh,
                                                            kv_heads=kv_heads))
            self._greedy_head_fused = self.fused_layer
            return
        self.decode_params = full_decode

        layers = self.decode_params["lm"]["layers"]
        if self.fused_mlp and not self.fused_layer:
            if not _dm.supported(layers["mlp"]):
                raise ValueError("fused_mlp needs the int8 decode tree of "
                                 "runtime.quantize.quantize_lm_for_serving")
            dp = dict(self.decode_params)
            dp["lm"] = dict(dp["lm"])
            dp["lm"]["layers"] = dict(layers, mlp=_dm.repack(layers["mlp"]))
            self.decode_params = dp
        # decided here, once; batch 1 here, gemma.forward checks the real batch
        if self.fused_layer and not _dl.supported(config.text_config, layers, batch=1):
            raise ValueError(
                "fused_layer (the default on a CUDA device) needs one KV head and "
                "the int8 decode tree of runtime.quantize.quantize_lm_for_serving; "
                "pass decode_params=that tree, or fused_layer=False for the plain path")
        if self.fused_layer:
            dp = dict(self.decode_params)
            dp["lm"] = dict(dp["lm"])
            dp["lm"]["layers"] = _dl.repack_layers(layers)
            if "head_q" in dp["lm"]:
                dp["lm"]["head_q"] = _dh.repack_head(dp["lm"]["head_q"])
            self.decode_params = dp
        self._greedy_head_fused = (
            self.fused_layer and "w8_blk" in self.decode_params["lm"].get("head_q", {})
        )

    # ------------------------------------------------------------------
    def init_state_cache(self, batch: int) -> Dict[str, torch.Tensor]:
        return gemma.init_kv_cache(
            self._kv_cfg, batch, self.max_seq_len, self.cache_dtype, device=self.device,
        )

    def _noise(self, generator, logits: torch.Tensor) -> Optional[torch.Tensor]:
        """Under a data axis: the whole batch's Gumbel draws (one card's),
        this rank's rows of them; None otherwise (the sampler draws)."""
        if self.dp_mesh is None:
            return None
        b, v = logits.shape
        d = self.dp_mesh.data
        rows = mesh_lib.data_rows(b * d, self.dp_mesh, "sampling")
        return sampling.gumbel_noise((b * d, v), generator, logits.device)[rows]

    def _as_tensor(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               device=self.device, dtype=dtype)

    def prefill(self, pixel_values, input_ids, attention_mask):
        """Prefill the cache; returns ((B, vocab) fp32 logits of each row's
        last valid token, KVState)."""
        pixel_values = self._as_tensor(pixel_values)
        input_ids = self._as_tensor(input_ids, torch.int64)
        attention_mask = self._as_tensor(attention_mask, torch.int32)
        b, s = input_ids.shape
        cache = self.init_state_cache(b)
        logits, cache = paligemma.prefill(
            self.params, self.config, pixel_values, input_ids, attention_mask,
            cache, use_flash=self.use_flash, last_only=True, mesh=self.mesh,
            int8_act=self.int8_act_prefill,
        )
        valid = torch.zeros((b, self.max_seq_len), dtype=torch.bool, device=self.device)
        valid[:, :s] = attention_mask.bool()
        n_valid = attention_mask.sum(dim=-1).to(torch.int32)
        state = KVState(cache=cache, valid=valid, write_pos=s,
                        pos_ids=n_valid + 1)  # positions are 1-indexed
        return logits[:, 0], state

    def decode_step(self, token: torch.Tensor, state: KVState):
        """One decode step from ``token`` (B,); returns ((B, vocab) fp32
        logits, KVState). ``state``'s cache and bitmap are updated in place."""
        state.valid[:, state.write_pos] = True
        logits, cache = paligemma.decode_step(
            self.decode_params, self.config, self._as_tensor(token, torch.int64),
            state.cache, cache_pos=state.write_pos, kv_valid=state.valid,
            position_ids=state.pos_ids, fused_layer=self.fused_layer, mesh=self.mesh,
            fused_mlp=self.fused_mlp,
        )
        return logits, KVState(cache, state.valid, state.write_pos + 1, state.pos_ids + 1)

    def kv_bucket_for(self, highest_write_pos: int) -> Optional[int]:
        """Smallest power-of-two cache window (>= 512) covering the given
        write position; None when only the full cache fits."""
        b = 512
        while b < highest_write_pos + 1:
            b *= 2
        return b if b < self.max_seq_len else None

    def decode_chunk(
        self,
        logits: torch.Tensor,  # (B, vocab) logits, or (B,) carried token
        state: KVState,
        n_steps: int,
        temperature: float = 0.8,
        top_p: float = 0.9,
        do_sample: bool = False,
        generator: Optional[torch.Generator] = None,
        eos_token_id: Optional[int] = None,
        done: Optional[torch.Tensor] = None,
        kv_bucket: Optional[int] = None,
    ):
        """``n_steps`` decode steps with no host synchronization. Returns
        ``(logits or token, state, tokens (B, n_steps), done)``; post-EOS
        slots hold EOS. ``kv_bucket`` must cover write_pos + n_steps
        (:meth:`kv_bucket_for`); None attends the full cache."""
        eos = self.eos_token_id if eos_token_id is None else eos_token_id
        b = logits.shape[0]
        if done is None:
            done = torch.zeros((b,), dtype=torch.bool, device=self.device)
        tokens = []
        if not do_sample and self._greedy_head_fused:
            # greedy fast path: the head kernel returns the token id, so the
            # (B,) token is carried instead of logits
            token = sampling.greedy(logits) if logits.dim() == 2 else logits
            for _ in range(n_steps):
                token = torch.where(done, torch.full_like(token, eos), token)
                done = done | (token == eos)
                tokens.append(token)
                state.valid[:, state.write_pos] = True
                token, cache = paligemma.decode_step_greedy(
                    self.decode_params, self.config, token, state.cache,
                    cache_pos=state.write_pos, kv_valid=state.valid,
                    position_ids=state.pos_ids, kv_bucket=kv_bucket, mesh=self.mesh,
                )
                state = KVState(cache, state.valid, state.write_pos + 1, state.pos_ids + 1)
            return token, state, torch.stack(tokens, dim=1), done

        if logits.dim() == 1:
            raise ValueError("decode_chunk: the sampled path needs (B, vocab) logits")
        for _ in range(n_steps):
            noise = self._noise(generator, logits) if do_sample else None
            token = sampling.sample(generator, logits, temperature, top_p, do_sample,
                                    noise=noise)
            token = torch.where(done, torch.full_like(token, eos), token)
            done = done | (token == eos)
            tokens.append(token)
            state.valid[:, state.write_pos] = True
            logits, cache = paligemma.decode_step(
                self.decode_params, self.config, token, state.cache,
                cache_pos=state.write_pos, kv_valid=state.valid,
                position_ids=state.pos_ids, kv_bucket=kv_bucket,
                fused_layer=self.fused_layer, mesh=self.mesh, fused_mlp=self.fused_mlp,
            )
            state = KVState(cache, state.valid, state.write_pos + 1, state.pos_ids + 1)
        return logits, state, torch.stack(tokens, dim=1), done

    # ------------------------------------------------------------------
    def generate(
        self,
        pixel_values,
        input_ids,
        attention_mask,
        max_new_tokens: int = 100,
        temperature: float = 0.8,
        top_p: float = 0.9,
        do_sample: bool = False,
        generator: Optional[torch.Generator] = None,
        eos_token_id: Optional[int] = None,
        on_token=None,
        sync_every: int = 1,
    ) -> np.ndarray:
        """Reference-compatible generation loop. Returns (B, <=max_new_tokens)
        int32; rows stop after EOS (post-EOS slots hold EOS). ``on_token(step,
        tokens)`` is called per step. ``sync_every > 1`` runs that many steps
        per :meth:`decode_chunk` and checks EOS once per chunk, with the same
        tokens. Under a data axis each rank runs its rows and returns the
        whole batch (module docstring)."""
        eos = self.eos_token_id if eos_token_id is None else eos_token_id
        n_prompt = input_ids.shape[1]
        rows = mesh_lib.data_rows(input_ids.shape[0], self.dp_mesh, "generate")
        if n_prompt + max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"prompt ({n_prompt}) + max_new_tokens ({max_new_tokens}) exceeds "
                f"max_seq_len ({self.max_seq_len}); raise max_seq_len or lower "
                "max_new_tokens"
            )
        if do_sample and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        logits, state = self.prefill(pixel_values[rows], input_ids[rows], attention_mask[rows])
        b = logits.shape[0]

        if sync_every > 1:
            done = torch.zeros((b,), dtype=torch.bool, device=self.device)
            chunks = []
            emitted = 0
            while emitted < max_new_tokens:
                n = min(sync_every, max_new_tokens - emitted)
                logits, state, tokens, done = self.decode_chunk(
                    logits, state, n, temperature, top_p, do_sample,
                    generator=generator, eos_token_id=eos, done=done,
                    kv_bucket=self.kv_bucket_for(n_prompt + emitted + n),
                )
                tokens = mesh_lib.gather_data(tokens, self.dp_mesh)
                tokens_np = tokens.cpu().numpy().astype(np.int32)
                chunks.append(tokens_np)
                if on_token is not None:
                    for j in range(tokens_np.shape[1]):
                        on_token(emitted + j, tokens_np[:, j])
                emitted += n
                if bool(mesh_lib.gather_data(done, self.dp_mesh).all()):
                    break
            return np.concatenate(chunks, axis=1)

        done = np.zeros((input_ids.shape[0],), bool)
        out = []
        for step in range(max_new_tokens):
            noise = self._noise(generator, logits) if do_sample else None
            token = sampling.sample(generator, logits, temperature, top_p, do_sample, noise=noise)
            token = mesh_lib.gather_data(token, self.dp_mesh)
            token_np = np.where(done, eos, token.cpu().numpy()).astype(np.int32)
            out.append(token_np)
            if on_token is not None:
                on_token(step, token_np)
            done |= token_np == eos
            if done.all():
                break
            logits, state = self.decode_step(torch.from_numpy(token_np[rows]), state)
        return np.stack(out, axis=1)

    # ------------------------------------------------------------------
    def generate_spec(
        self,
        pixel_values,
        input_ids,
        attention_mask,
        max_new_tokens: int = 100,
        eos_token_id: Optional[int] = None,
        draft_k: int = 8,
        match_n: int = 2,
        corrupt_frac: float = 0.0,
        *,
        sync_every: int = 8,
        generator: Optional[torch.Generator] = None,
    ) -> np.ndarray:
        """Greedy generation with n-gram speculative decoding; B == 1.
        Returns (1, n) int32 with n <= ``max_new_tokens``, the tokens of
        ``generate(do_sample=False)`` up to and including the first EOS.

        Per cycle: ``draft_k`` drafts from the history (ops/ngram,
        ``match_n``-gram lookup), one verify forward of [last token,
        drafts] (models/paligemma.decode_verify: the decode kernels at
        ``draft_k + 1`` rows on the kernel path), then the longest draft
        prefix equal to the model's argmax is emitted with the model's
        token after it. Only the emitted positions become valid. The
        cycles of a window of ``sync_every`` run with no host read (the
        history, counts and flags stay on the device); a cycle after EOS or
        the budget changes nothing, and the host checks once per window.
        ``spec_cycles`` keeps the number of cycles that emitted.

        ``corrupt_frac`` is a benchmark's acceptance dial: each draft is
        replaced by ``(draft + 1) % vocab`` with that probability, drawn
        from ``generator`` (on the device; default seed 0). The tokens do
        not change: a rejected draft falls back to the model's own token."""
        b, prompt_len = input_ids.shape
        if b != 1:
            raise ValueError("generate_spec is single-request (B == 1): rows accept different "
                             "draft counts; use generate / decode_chunk for batches")
        if prompt_len + max_new_tokens + draft_k > self.max_seq_len:
            raise ValueError(
                f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) + draft_k "
                f"({draft_k}) exceeds max_seq_len ({self.max_seq_len}); speculative decode "
                "writes up to draft_k positions past the last accepted token")
        if self.dp_mesh is not None:
            raise ValueError(f"generate_spec is single-request (B == 1), which cannot split over "
                             f"a data axis of {self.dp_mesh.data}")
        if self.fused_mlp:
            raise ValueError("generate_spec runs the decode kernels (fused_layer) or the plain "
                             "path, not fused_mlp")
        st = self.spec_start(pixel_values, input_ids, attention_mask, max_new_tokens,
                             eos_token_id, draft_k, match_n, corrupt_frac, generator=generator)
        while not self.spec_window(st, sync_every):
            pass
        n = int(st["n_out"][0])
        self.spec_cycles = int(st["cycles"][0])
        return st["out"][:n].cpu().numpy().astype(np.int32)[None]

    def spec_start(self, pixel_values, input_ids, attention_mask, max_new_tokens: int,
                   eos_token_id: Optional[int], draft_k: int, match_n: int,
                   corrupt_frac: float = 0.0, *,
                   generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """Prefill and the device state of :meth:`generate_spec`'s cycles
        (its guards are the caller's)."""
        dev = self.device
        if corrupt_frac > 0.0 and generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        eos = self.eos_token_id if eos_token_id is None else eos_token_id
        prompt_len = input_ids.shape[1]
        logits, state = self.prefill(pixel_values, input_ids, attention_mask)
        # the history's last column takes the writes of positions not kept
        hist = torch.zeros((1, self.max_seq_len + 1), dtype=torch.int64, device=dev)
        hist[:, :prompt_len] = self._as_tensor(input_ids, torch.int64)
        token0 = logits.float().argmax(dim=-1)  # (1,)
        hist[:, prompt_len] = token0
        out = torch.full((max_new_tokens + 1,), eos, dtype=torch.int64, device=dev)
        out[0] = token0[0]
        return dict(
            k=draft_k, match_n=match_n, corrupt_frac=corrupt_frac, generator=generator, eos=eos,
            max_new=max_new_tokens, kv_bucket=self.kv_bucket_for(prompt_len + max_new_tokens
                                                                 + draft_k),
            hist=hist, hist_len=torch.full((1,), prompt_len + 1, dtype=torch.int64, device=dev),
            out=out, n_out=torch.ones((1,), dtype=torch.int64, device=dev), done=token0 == eos,
            last_tok=token0, cycles=torch.zeros((1,), dtype=torch.int64, device=dev),
            valid=state.valid, cache=state.cache, pos_ids=state.pos_ids,
            wp=torch.full((1,), state.write_pos, dtype=torch.int32, device=dev))

    def spec_window(self, st: Dict[str, Any], cycles: int) -> bool:
        """``cycles`` speculative cycles on ``st`` (:meth:`spec_start`),
        enqueued with no host read; then one read: True when the row is
        done (EOS or the budget)."""
        self._spec_cycles(st, max(1, cycles))
        return bool((st["done"] | (st["n_out"] >= st["max_new"])).all())

    def _spec_cycles(self, st: Dict[str, Any], cycles: int) -> None:
        """The cycles of :meth:`spec_window`, on the device only."""
        dev = self.device
        k, eos, max_new = st["k"], st["eos"], st["max_new"]
        vocab = self.config.text_config.vocab_size
        j = torch.arange(k + 1, device=dev)[None]  # (1, k + 1)
        sidx = torch.arange(self.max_seq_len, device=dev)[None]
        dump_out, dump_hist = max_new, self.max_seq_len
        greedy_ids = self.fused_layer
        for _ in range(cycles):
            active = ~st["done"] & (st["n_out"] < max_new)  # (1,)
            draft = propose_ngram(st["hist"], st["hist_len"], st["match_n"], k)  # (1, k)
            if st["corrupt_frac"] > 0.0:
                u = torch.rand((1, k), generator=st["generator"], device=dev)
                draft = torch.where(u < st["corrupt_frac"], (draft + 1) % vocab, draft)
            tokens_in = torch.cat([st["last_tok"][:, None], draft], dim=1)
            g, st["cache"] = paligemma.decode_verify(
                self.decode_params, self.config, tokens_in, st["cache"], st["wp"], st["valid"],
                st["pos_ids"], kv_bucket=st["kv_bucket"], fused_layer=self.fused_layer,
                greedy_head=greedy_ids, mesh=self.mesh)
            if not greedy_ids:
                g = g.argmax(dim=-1)
            g = g.long()  # (1, k + 1): the model's token after each input
            n_acc = torch.cumprod((draft == g[:, :k]).long(), dim=1).sum(dim=1)  # (1,)
            draft_pad = torch.cat([draft, torch.zeros_like(draft[:, :1])], dim=1)
            cand = torch.where(j < n_acc[:, None], draft_pad, g.gather(1, n_acc[:, None]))
            n_emit = torch.minimum(n_acc + 1, max_new - st["n_out"])
            is_eos = (cand == eos) & (j < n_emit[:, None])
            any_eos = is_eos.any(dim=1)
            n_keep = torch.where(any_eos, is_eos.long().argmax(dim=1) + 1, n_emit)
            n_keep = torch.where(active, n_keep, torch.zeros_like(n_keep))
            kept = j < n_keep[:, None]
            wp, hist_len, n_out = st["wp"], st["hist_len"], st["n_out"]
            st["out"].scatter_(0, torch.where(kept, n_out[:, None] + j, dump_out)[0], cand[0])
            st["hist"].scatter_(1, torch.where(kept, hist_len[:, None] + j, dump_hist), cand)
            st["hist_len"] = hist_len + n_keep
            # only the emitted slots become attendable
            st["valid"] |= (sidx >= wp[:, None]) & (sidx < (wp + n_keep)[:, None])
            st["wp"] = wp + n_keep.to(torch.int32)
            st["pos_ids"] = st["pos_ids"] + n_keep.to(st["pos_ids"].dtype)
            last = cand.gather(1, (n_keep - 1).clamp(min=0)[:, None])[:, 0]
            st["last_tok"] = torch.where(n_keep > 0, last, st["last_tok"])
            st["n_out"] = n_out + n_keep
            st["done"] = st["done"] | (any_eos & active)
            st["cycles"] = st["cycles"] + active.long()
