"""PaliGemma composition (port of paligemma_tpu/models/paligemma.py).

SigLIP tower -> bias-free linear projector -> projected image features,
scaled by projection_dim**-0.5, placed at the <image> token slots of the
embedded prompt -> Gemma decoder. The vision tower runs once, at prefill;
``forward_train`` is the supervised forward of training (no cache).

``lora`` / ``adapter_ids``: un-merged adapters, or a multi-LoRA bank
(train/lora.stack_lora_bank) with each batch row's bank index
(``lora_with_ids``); a bank carrying ``"__fused_pack__"``
(kernels/decode_layer.repack_lora_bank_fused) keeps the kernel decode ticks.

``decode_verify`` / ``decode_verify_paged``: the verify forward of
speculative decoding (s tokens a row in one forward), plain or through the
decode kernels at B s rows.

``mesh`` (core/mesh): tensor parallel, the params being this rank's slices
(core/mesh.shard_params, or for the kernel decode steps
kernels/decode_layer_tp.repack_for_tp). Every rank gets the same logits
and tokens.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .. import convert
from ..core.config import PaliGemmaConfig
from . import gemma, siglip

Params = Dict[str, Any]


def init_params(generator: torch.Generator, cfg: PaliGemmaConfig,
                dtype: torch.dtype = torch.float32) -> Params:
    """Random weights of the whole model (``convert.init_params``), made on
    the generator's device."""
    return convert.init_params(cfg, generator, generator.device, dtype)


def project_image_features(params: Params, image_features: torch.Tensor) -> torch.Tensor:
    """Linear projection to the text embedding space (bias when present)."""
    out = image_features @ params["projector"]["kernel"]
    if "bias" in params["projector"]:
        out = out + params["projector"]["bias"]
    return out


def merge_embeddings(
    cfg: PaliGemmaConfig,
    input_ids: torch.Tensor,  # (B, S)
    text_embeds: torch.Tensor,  # (B, S, H)
    image_embeds: torch.Tensor,  # (B, N_img, H)
) -> torch.Tensor:
    """Text slots keep their embedding; the n-th <image> slot of a row gets
    the row's n-th image feature times projection_dim**-0.5; pads are 0."""
    is_pad = input_ids == cfg.pad_token_id
    is_image = input_ids == cfg.image_token_index
    scaled_img = (image_embeds * cfg.projection_dim**-0.5).to(text_embeds.dtype)
    img_slot = torch.cumsum(is_image.to(torch.int32), dim=-1) - 1
    img_slot = img_slot.clamp(0, scaled_img.shape[1] - 1).long()
    idx = img_slot[:, :, None].expand(-1, -1, scaled_img.shape[-1])
    gathered = torch.gather(scaled_img, 1, idx)
    merged = torch.where(is_image[:, :, None], gathered, text_embeds)
    return torch.where(is_pad[:, :, None], torch.zeros_like(merged), merged)


def prefill_position_ids(attention_mask: torch.Tensor) -> torch.Tensor:
    """Positions = cumsum over the validity mask, pads forced to 1 (1-indexed)."""
    pos = torch.cumsum(attention_mask.to(torch.int32), dim=-1)
    return torch.where(attention_mask == 0, torch.ones_like(pos), pos)


def _vision_attn_mode(cfg: PaliGemmaConfig, use_flash: bool) -> str:
    """Vision attention path, as the reference picks it: the plain
    materialized attention unless flash is on and either head_dim fills
    128 lanes or the tower has >= 2048 patches (896 px)."""
    if not use_flash:
        return "xla"
    if cfg.vision_config.head_dim % 128 == 0 or cfg.vision_config.num_patches >= 2048:
        return "flash"
    return "xla"


def lora_with_ids(lora: Optional[Params], adapter_ids: Optional[torch.Tensor],
                  n_layers: int) -> Optional[Params]:
    """Attach per-row adapter ids to a multi-LoRA bank: ``adapter_ids`` (B,)
    picks each batch row's adapter (0 = the zero adapter of the base
    model), broadcast to (L, B) under ``lora["layers"]["__ids__"]`` so that
    every layer's slice carries them (gemma._lora_delta). With
    ``adapter_ids`` None the tree passes through untouched."""
    if lora is None or adapter_ids is None:
        return lora
    layers = dict(lora["layers"])
    layers["__ids__"] = adapter_ids[None, :].expand(n_layers, adapter_ids.shape[0])
    return {**lora, "layers": layers}  # keeps extras, e.g. "__fused_pack__"


def prefill(
    params: Params,
    cfg: PaliGemmaConfig,
    pixel_values: torch.Tensor,  # (B, C, H, W)
    input_ids: torch.Tensor,  # (B, S)
    attention_mask: torch.Tensor,  # (B, S) 1 = real token
    kv_cache: gemma.KVCache,
    use_flash: bool = False,
    last_only: bool = False,
    mesh=None,
    prefix_lens: Optional[torch.Tensor] = None,  # (B,) int
    lora: Optional[Params] = None,  # adapter tree or multi-LoRA bank
    adapter_ids: Optional[torch.Tensor] = None,  # (B,) rows into the bank
    int8_act: bool = False,  # W8A8 LM projections (int8 weights only)
) -> Tuple[torch.Tensor, gemma.KVCache]:
    """Vision encode + merge + decoder prefill. Returns (logits, cache);
    ``last_only`` projects each row's last valid token only ((B, 1, vocab)).
    ``int8_act``: the LM's int8 projections at prefill rows run W8A8
    (models/gemma ``forward``).

    ``prefix_lens``: bidirectional-prefix length per row; None = the whole
    prompt (PaliGemma's prefix-LM). A recompute prefill (a preempted serving
    request re-entering as prompt + tokens so far, runtime/serving_paged)
    passes the original prompt length: the regenerated suffix was produced
    causally and is re-encoded causally."""
    dtype = params["lm"]["embed"].dtype
    image_features = siglip.encode(
        params["vision"], cfg.vision_config, pixel_values.to(dtype),
        attn=_vision_attn_mode(cfg, use_flash), mesh=mesh,
    )
    image_embeds = project_image_features(params, image_features)
    text_embeds = gemma.embed_tokens(params["lm"], input_ids, mesh)
    merged = merge_embeddings(cfg, input_ids, text_embeds, image_embeds)

    position_ids = prefill_position_ids(attention_mask)
    max_seq = kv_cache["k"].shape[2]
    b, s = input_ids.shape
    n_valid = attention_mask.sum(dim=-1).to(torch.int32)
    kv_valid = torch.zeros((b, max_seq), dtype=torch.bool, device=input_ids.device)
    kv_valid[:, :s] = attention_mask.bool()
    flash_lens = None
    if use_flash:
        pfx = n_valid if prefix_lens is None else prefix_lens.to(n_valid.device, torch.int32)
        flash_lens = (pfx, n_valid)
    elif prefix_lens is not None:
        # pairwise prefix-LM mask: query i sees key j iff j is a real token
        # and (j < prefix or j <= i); prompt rows sit densely at [0, s)
        i = torch.arange(s, device=input_ids.device)[None, :, None]
        j = torch.arange(max_seq, device=input_ids.device)[None, None, :]
        pfx = prefix_lens.to(input_ids.device).long()[:, None, None]
        kv_valid = (j < n_valid.long()[:, None, None]) & ((j < pfx) | (j <= i))
    logits_idx = (n_valid - 1).clamp(min=0) if last_only else None
    return gemma.forward(
        params["lm"], cfg.text_config, merged, position_ids, kv_cache,
        cache_pos=0, kv_valid=kv_valid, flash_lens=flash_lens,
        logits_idx=logits_idx, mesh=mesh,
        lora=lora_with_ids(lora, adapter_ids, cfg.text_config.num_hidden_layers),
        int8_act=int8_act,
    )


def decode_step(
    params: Params,
    cfg: PaliGemmaConfig,
    token: torch.Tensor,  # (B,) last sampled token
    kv_cache: gemma.KVCache,
    cache_pos: gemma.CachePos,  # index this token is written at, or (B,) per row
    kv_valid: torch.Tensor,  # (B, max_seq) bool incl. this token's slot
    position_ids: torch.Tensor,  # (B,) RoPE position of this token
    kv_bucket: Optional[int] = None,
    *,
    fused_mlp: bool = False,
    fused_layer: bool = False,
    lora: Optional[Params] = None,  # adapter tree or multi-LoRA bank
    adapter_ids: Optional[torch.Tensor] = None,  # (B,) rows into the bank
    mesh=None,
) -> Tuple[torch.Tensor, gemma.KVCache]:
    """Single-token decode. Returns ((B, vocab) fp32 logits, cache).
    ``fused_mlp`` (one card, plain layers): each layer's MLP through
    kernels/decode_mlp."""
    embeds = gemma.embed_tokens(params["lm"], token, mesh)[:, None, :]
    logits, kv_cache = gemma.forward(
        params["lm"], cfg.text_config, embeds, position_ids[:, None], kv_cache,
        cache_pos=cache_pos, kv_valid=kv_valid, kv_bucket=kv_bucket,
        fused_layer=fused_layer, mesh=mesh, fused_mlp=fused_mlp,
        lora=lora_with_ids(lora, adapter_ids, cfg.text_config.num_hidden_layers),
    )
    return logits[:, 0, :], kv_cache


def decode_step_greedy(
    params: Params,
    cfg: PaliGemmaConfig,
    token: torch.Tensor,
    kv_cache: gemma.KVCache,
    cache_pos: gemma.CachePos,
    kv_valid: torch.Tensor,
    position_ids: torch.Tensor,
    kv_bucket: Optional[int] = None,
    fused_layer: bool = True,
    lora: Optional[Params] = None,  # multi-LoRA bank (+ "__fused_pack__")
    adapter_ids: Optional[torch.Tensor] = None,  # (B,) rows into the bank
    *,
    mesh=None,
) -> Tuple[torch.Tensor, gemma.KVCache]:
    """Greedy single-token decode: (next token (B,) int32, cache). With the
    kernels on, the int8 head streams through the argmax kernel and the
    logits row is never written; a bank carrying its kernel operands keeps
    that tick, each row's adapter applied inside the chain. Under a mesh
    with the kernels on, the tensor-parallel chain (kernels/decode_layer_tp)
    and the vocab-shard argmax combined across ranks: the JAX
    ``decode_step_greedy_tp``."""
    embeds = gemma.embed_tokens(params["lm"], token, mesh)[:, None, :]
    return gemma.forward(
        params["lm"], cfg.text_config, embeds, position_ids[:, None], kv_cache,
        cache_pos=cache_pos, kv_valid=kv_valid, kv_bucket=kv_bucket,
        fused_layer=fused_layer, greedy_head=True, mesh=mesh,
        lora=lora_with_ids(lora, adapter_ids, cfg.text_config.num_hidden_layers),
    )


def decode_step_paged(
    params: Params,
    cfg: PaliGemmaConfig,
    token: torch.Tensor,  # (B,) last sampled token
    pool: gemma.KVCache,  # page pool (L, n_pages, page_size, n_kv, d), in place
    page_table: torch.Tensor,  # (B, P_max) int32
    write_pos: torch.Tensor,  # (B,) int32 logical position of this token
    position_ids: torch.Tensor,  # (B,) RoPE position of this token
    pages_bucket: Optional[int] = None,  # logical pages attended (host-managed)
    paged_kernel: str = "multi",
    lora: Optional[Params] = None,  # adapter tree or multi-LoRA bank
    adapter_ids: Optional[torch.Tensor] = None,  # (B,) rows into the bank
    *,
    mesh=None,
) -> Tuple[torch.Tensor, gemma.KVCache]:
    """Single-token decode over the paged pool. Returns ((B, vocab) fp32
    logits, pool). ``paged_kernel``: "fused" (or "staged", the TPU's staging
    hybrid, which maps onto it here) runs kernels/decode_layer_paged and
    needs the int8 tree; "one" | "multi" | "batched" | "runs" run the page
    walk with the paged attention kernel; "xla" runs the page walk on plain
    torch ops only. Under a mesh: "fused_tp" runs
    kernels/decode_layer_paged_tp and gathers the vocab-sharded int8 head's
    logits (the JAX ``decode_step_paged_tp``); "xla" the plain sharded page
    walk.

    ``lora`` on the page walks rides the torch projections; the "fused"
    chain takes a bank only with its kernel operands (``"__fused_pack__"``)
    and applies each row's adapter inside the chain."""
    if mesh is not None and paged_kernel not in ("fused_tp", "xla"):
        raise ValueError(f"paged_kernel {paged_kernel!r} under a mesh: 'fused_tp' or 'xla'")
    embeds = gemma.embed_tokens(params["lm"], token, mesh)[:, None, :]
    n_layers = cfg.text_config.num_hidden_layers
    if paged_kernel in ("fused", "staged", "fused_tp"):
        pack, ids = gemma.fused_lora_operands(lora_with_ids(lora, adapter_ids, n_layers))
        logits, pool = gemma.forward_paged_decode_fused(
            params["lm"], cfg.text_config, embeds, position_ids[:, None], pool, page_table,
            write_pos, pages_bucket=pages_bucket or page_table.shape[1], lora_pack=pack,
            adapter_ids=ids, mesh=mesh,
        )
    else:
        logits, pool = gemma.forward_paged_decode(
            params["lm"], cfg.text_config, embeds, position_ids[:, None], pool, page_table,
            write_pos, use_kernel=paged_kernel != "xla", pages_bucket=pages_bucket,
            paged_kernel="multi" if paged_kernel == "xla" else paged_kernel, mesh=mesh,
            lora=lora_with_ids(lora, adapter_ids, n_layers),
        )
    return logits[:, 0, :], pool


def decode_step_greedy_paged(
    params: Params,
    cfg: PaliGemmaConfig,
    token: torch.Tensor,
    pool: gemma.KVCache,
    page_table: torch.Tensor,
    write_pos: torch.Tensor,
    position_ids: torch.Tensor,
    pages_bucket: Optional[int] = None,
    lora: Optional[Params] = None,  # bank carrying "__fused_pack__"
    adapter_ids: Optional[torch.Tensor] = None,  # (B,) rows into the bank
    *,
    mesh=None,
) -> Tuple[torch.Tensor, gemma.KVCache]:
    """Greedy paged step through kernels/decode_layer_paged and the argmax
    head kernel: (next token (B,) int32, pool); the (B, vocab) logits row is
    never written. Same tokens as ``argmax(decode_step_paged(..., "fused"))``.
    Under a mesh kernels/decode_layer_paged_tp and the vocab-shard argmax
    combined across ranks (``argmax(decode_step_paged(..., "fused_tp"))``)."""
    embeds = gemma.embed_tokens(params["lm"], token, mesh)[:, None, :]
    pack, ids = gemma.fused_lora_operands(
        lora_with_ids(lora, adapter_ids, cfg.text_config.num_hidden_layers))
    return gemma.forward_paged_decode_fused(
        params["lm"], cfg.text_config, embeds, position_ids[:, None], pool, page_table,
        write_pos, pages_bucket=pages_bucket or page_table.shape[1], lora_pack=pack,
        adapter_ids=ids, greedy_head=True, mesh=mesh,
    )


def verify_mask(kv_valid: torch.Tensor, cache_pos: gemma.CachePos, s: int) -> torch.Tensor:
    """The verify block's pairwise mask (B, s, max_seq): query i sees the
    slots valid before the block and the block's own slots
    ``[cache_pos, cache_pos + i]`` (``cache_pos`` a scalar or (B,))."""
    dev = kv_valid.device
    idx = torch.arange(kv_valid.shape[-1], device=dev)[None, None, :]
    start = (cache_pos.to(dev).long()[:, None, None] if torch.is_tensor(cache_pos)
             else cache_pos)
    off = idx - start  # the slot's index within the block
    in_block = (off >= 0) & (off <= torch.arange(s, device=dev)[None, :, None])
    return kv_valid[:, None, :] | in_block


def _verify_positions(cache_pos: gemma.CachePos, b: int, s: int, limit: int,
                      device) -> torch.Tensor:
    """(B s,) int32 write positions of the kernel verify's rows:
    ``cache_pos[r] + j``, clamped to ``limit - 1`` (a row that is done keeps
    verifying in place until it is seated again; its writes stay inside its
    own cache row or pages)."""
    start = torch.as_tensor(cache_pos, dtype=torch.int32, device=device).reshape(-1).expand(b)
    j = torch.arange(s, dtype=torch.int32, device=device)
    return (start[:, None] + j[None]).clamp_(max=limit - 1).reshape(-1)


def _verify_out(out: torch.Tensor, b: int, s: int, greedy_head: bool) -> torch.Tensor:
    """The kernel decode head's B s rows as (B, s) ids or (B, s, vocab)
    logits."""
    return out.reshape(b, s) if greedy_head else out.reshape(b, s, -1)


def decode_verify(
    params: Params,
    cfg: PaliGemmaConfig,
    tokens: torch.Tensor,  # (B, s): the last accepted token + s - 1 drafts
    kv_cache: gemma.KVCache,  # written in place
    cache_pos: gemma.CachePos,  # scalar or (B,): where tokens[:, 0] is written
    kv_valid: torch.Tensor,  # (B, max_seq) bool: slots valid BEFORE this block
    position_ids: torch.Tensor,  # (B,) RoPE position of tokens[:, 0]
    kv_bucket: Optional[int] = None,
    *,
    fused_layer: bool = False,
    greedy_head: bool = False,
    mesh=None,
) -> Tuple[torch.Tensor, gemma.KVCache]:
    """Speculative verify: the s tokens of each row through the decoder in
    one forward (one weight stream). Causal inside the block, full over the
    slots valid before it (:func:`verify_mask`). The K/V of all s positions
    is written; the caller marks only the accepted prefix valid, and the
    next block starts at the first rejected slot and overwrites the rest.

    Returns ((B, s, vocab) fp32 logits, cache): ``argmax(logits[:, i])`` is
    the model's token after ``tokens[:, i]``. ``fused_layer``: the decode
    kernels at B s rows, one row per block position (models/gemma.forward
    with ``rows_per_cache`` = s), and with ``greedy_head`` the (B, s) argmax
    ids from the head kernel instead of logits (the plain path takes the
    argmax of its logits). ``mesh``: tensor parallel, as ``decode_step``
    (the kernel path: kernels/decode_layer_tp at B s rows and the
    vocab-shard argmax head combined across ranks)."""
    b, s = tokens.shape
    embeds = gemma.embed_tokens(params["lm"], tokens, mesh)
    pos = position_ids.to(tokens.device)[:, None] + torch.arange(s, device=tokens.device)[None]
    vis = verify_mask(kv_valid, cache_pos, s)
    if fused_layer:
        out, kv_cache = gemma.forward(
            params["lm"], cfg.text_config, embeds.reshape(b * s, 1, -1), pos.reshape(b * s, 1),
            kv_cache, cache_pos=_verify_positions(cache_pos, b, s, kv_cache["k"].shape[2],
                                                tokens.device),
            kv_valid=vis.reshape(b * s, -1), kv_bucket=kv_bucket, fused_layer=True,
            greedy_head=greedy_head, rows_per_cache=s, mesh=mesh)
        return _verify_out(out, b, s, greedy_head), kv_cache
    logits, kv_cache = gemma.forward(
        params["lm"], cfg.text_config, embeds, pos, kv_cache, cache_pos=cache_pos,
        kv_valid=vis, kv_bucket=kv_bucket, mesh=mesh)
    if greedy_head:
        return logits.argmax(dim=-1).to(torch.int32), kv_cache
    return logits, kv_cache


def decode_verify_paged(
    params: Params,
    cfg: PaliGemmaConfig,
    tokens: torch.Tensor,  # (B, s): the last accepted token + s - 1 drafts
    pool: gemma.KVCache,  # page pool, written in place
    page_table: torch.Tensor,  # (B, P_max) int32
    write_pos: torch.Tensor,  # (B,) int: where tokens[:, 0] is written
    position_ids: torch.Tensor,  # (B,) RoPE position of tokens[:, 0]
    pages_bucket: Optional[int] = None,
    *,
    fused_layer: bool = False,
    greedy_head: bool = False,
    mesh=None,
) -> Tuple[torch.Tensor, gemma.KVCache]:
    """Speculative verify over the page pool (models/gemma
    ``forward_paged_verify``: per-query causal bounds instead of the dense
    pairwise mask). Returns ((B, s, vocab) fp32 logits, pool). The pages
    covering ``write_pos + s - 1`` must be reserved by the caller.
    ``fused_layer`` / ``greedy_head``: as in :func:`decode_verify`: the
    paged kernel decode at B s rows (models/gemma.forward_paged_decode_fused),
    each row's table repeated s times and position j attending
    ``[0, write_pos + j]``. ``mesh``: tensor parallel (the kernel path:
    kernels/decode_layer_paged_tp at B s rows)."""
    b, s = tokens.shape
    embeds = gemma.embed_tokens(params["lm"], tokens, mesh)
    pos = position_ids.to(tokens.device)[:, None] + torch.arange(s, device=tokens.device)[None]
    if fused_layer:
        table = page_table.to(torch.int32).repeat_interleave(s, dim=0)
        out, pool = gemma.forward_paged_decode_fused(
            params["lm"], cfg.text_config, embeds.reshape(b * s, 1, -1), pos.reshape(b * s, 1),
            pool, table,
            _verify_positions(write_pos, b, s, table.shape[1] * pool["k"].shape[2], tokens.device),
            pages_bucket or page_table.shape[1], greedy_head=greedy_head, mesh=mesh)
        return _verify_out(out, b, s, greedy_head), pool
    logits, pool = gemma.forward_paged_verify(
        params["lm"], cfg.text_config, embeds, pos, pool, page_table, write_pos,
        pages_bucket=pages_bucket, mesh=mesh)
    if greedy_head:
        return logits.argmax(dim=-1).to(torch.int32), pool
    return logits, pool


def train_attention_mask(
    attention_mask: torch.Tensor,  # (B, S) 1 = real token
    token_type_ids: torch.Tensor,  # (B, S) 0 = prefix (image + prompt), 1 = suffix
) -> torch.Tensor:
    """PaliGemma's training mask: bidirectional over the prefix, causal over
    the suffix, real keys only. (B, S, S) bool."""
    valid_k = attention_mask.bool()[:, None, :]
    is_prefix_k = (token_type_ids == 0)[:, None, :]
    s = attention_mask.shape[1]
    pos = torch.arange(s, device=attention_mask.device)
    causal = pos[None, :, None] >= pos[None, None, :]  # q >= k
    return valid_k & (is_prefix_k | causal)


def _needs_grad(*trees) -> bool:
    def leaves(t):
        if isinstance(t, dict):
            for v in t.values():
                yield from leaves(v)
        elif torch.is_tensor(t):
            yield t
    return any(t.requires_grad for tree in trees for t in leaves(tree))


def forward_train(
    params: Params,
    cfg: PaliGemmaConfig,
    pixel_values: torch.Tensor,  # (B, C, H, W)
    input_ids: torch.Tensor,  # (B, S)
    attention_mask: torch.Tensor,  # (B, S)
    token_type_ids: torch.Tensor,  # (B, S) 0 = prefix, 1 = suffix
    lora: Optional[Dict[str, Any]] = None,
    remat: bool = True,
    use_flash: bool = False,
    *,
    mesh=None,
    fsdp=None,
) -> torch.Tensor:
    """Supervised forward (no KV cache): fp32 logits (B, S, vocab).

    The vision tower keeps plain attention at head_dim 72 (as the reference
    does in training); when neither it nor the projector requires grad it
    runs without building an autograd graph. The flash path assumes the
    prefix (image + prompt) is contiguous at the start of each row, as
    processor-built batches are: prefix_lens = real prefix tokens, kv_lens =
    real tokens.

    ``mesh``: tensor parallel, the params and adapters this rank's slices
    (core/mesh.shard_params, shard_lora): the tower and the decoder run
    sharded (models/gemma ``forward_train``), the embedding looked up in
    its vocab shard; every rank of the model axis gets the whole logits.
    ``fsdp`` (core/mesh.Fsdp): the leaves are data shards, gathered where
    they are used (the decoder's layer by layer)."""
    if fsdp is not None:
        params = {**fsdp.full({k: v for k, v in params.items() if k != "lm"}),
                  "lm": {**fsdp.full({k: v for k, v in params["lm"].items() if k != "layers"}),
                         "layers": params["lm"]["layers"]}}
    dtype = params["lm"]["embed"].dtype
    vision_attn = "flash" if use_flash and cfg.vision_config.head_dim % 128 == 0 else "xla"
    with torch.set_grad_enabled(torch.is_grad_enabled()
                                and _needs_grad(params["vision"], params["projector"])):
        image_features = siglip.encode(params["vision"], cfg.vision_config,
                                       pixel_values.to(dtype), attn=vision_attn, mesh=mesh)
        image_embeds = project_image_features(params, image_features)
    text_embeds = gemma.embed_tokens(params["lm"], input_ids, mesh)
    merged = merge_embeddings(cfg, input_ids, text_embeds, image_embeds)
    position_ids = prefill_position_ids(attention_mask)
    if use_flash:
        real = attention_mask == 1
        prefix_lens = ((token_type_ids == 0) & real).sum(dim=-1).to(torch.int32)
        kv_lens = attention_mask.sum(dim=-1).to(torch.int32)
        return gemma.forward_train(params["lm"], cfg.text_config, merged, position_ids, None,
                                   lora=lora, remat=remat, flash_lens=(prefix_lens, kv_lens),
                                   mesh=mesh, fsdp=fsdp)
    pairwise = train_attention_mask(attention_mask, token_type_ids)
    return gemma.forward_train(params["lm"], cfg.text_config, merged, position_ids, pairwise,
                               lora=lora, remat=remat, mesh=mesh, fsdp=fsdp)
