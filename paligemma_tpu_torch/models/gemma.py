"""Gemma decoder with a preallocated KV cache (port of
paligemma_tpu/models/gemma.py).

Token embeddings scaled by sqrt(hidden) (the normalizer rounded to the
activation dtype, as the reference does), pre-norm blocks of GQA attention
with half-split RoPE and a GeGLU MLP, final RMSNorm, tied bias-free head.

The KV cache is a dict of (L, B, max_seq, n_kv, head_dim) tensors. Where the
reference donates the cache to a jitted step, this port writes the new rows
into the same tensors in place and returns the same dict.

Two decode paths, as in the reference:
* plain: a loop over layers of torch ops (``_decoder_block``);
* ``fused_layer``: kernels/decode_layer.layers_decode_fused (all layers as
  hand-written kernels), then the final norm kernel and either the int8
  GEMV head (logits) or kernels/decode_head (greedy ids).
Prefill attention takes the flash kernel when ``flash_lens`` is given.
Decode rows may sit at different cache positions (``cache_pos`` a (B,)
tensor: continuous batching).

Adapters run un-merged (``_lora_delta``): a LoRA tree, or a multi-LoRA
bank with per-row ids in prefill and the plain decode paths, or, on the
kernel decode paths, the bank's kernel operands (kernels/decode_layer
``lora_pack``). Training (``forward_train``) runs the blocks without a
cache, with un-merged LoRA adapters, the flash kernel's forward and
backward when ``flash_lens`` is given, and ``torch.utils.checkpoint`` per
layer with ``remat``; under a mesh with the collectives' gradients of
core/mesh, and under FSDP each layer's weights gathered where it runs.

Over a paged KV pool (runtime/paged_cache, (L, n_pages, page_size, n_kv, d)):
* ``forward_paged_decode``: the page walk, torch projections and one paged
  attention per layer (kernels/paged_attention, or its plain version);
* ``forward_paged_decode_fused``: kernels/decode_layer_paged, then the same
  head as the fused dense path.

Speculative verify (s tokens a row in one forward, models/paligemma
``decode_verify``): the plain path is ``forward`` with a pairwise mask and
per-row block writes, or over the pool ``forward_paged_verify``; the kernel
path is the fused decode at B s rows (``forward`` with ``rows_per_cache``
= s, or ``forward_paged_decode_fused`` with each row's table repeated).

Under a tensor-parallel ``mesh`` (core/mesh) the params are this rank's
slices (core/mesh.shard_params): the plain paths compute with the rank's
share of heads and MLP width, sum the o and down partials across ranks in
fp32 before the cast, or under W8A8 their int32 sums (``_row_parallel``),
look the embedding up in its vocab shard (``embed_tokens``) and gather the
head's vocab shards (``lm_head``); ``fused_layer`` decode runs
kernels/decode_layer_tp and the fused paged decode
kernels/decode_layer_paged_tp. A LoRA tree or bank under a mesh is this
rank's shard (core/mesh.shard_lora): a row-parallel target's partial delta
is summed beside the projection's partial (``_row_parallel``), and the
kernel chains take the pack of the shard. The one-card ``fused_mlp`` decode
runs each layer's MLP through kernels/decode_mlp.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from .. import convert
from ..core import mesh as mesh_lib
from ..core.config import GemmaConfig
from ..kernels import decode_layer, decode_layer_paged, decode_layer_paged_tp
from ..kernels import decode_layer_tp
from ..kernels import paged_attention as paged_attn
from ..kernels.decode_elementwise import rms_norm as rms_norm_kernel
from ..kernels.decode_head import head_argmax_fused
from ..kernels.decode_mlp import mlp_decode_fused
from ..kernels.flash_attention import flash_attention, flash_attention_sharded
from ..kernels.int8_gemv import int8_gemv, int8_gemv_f32
from ..kernels.quant import int8_matmul_card, matmul_any, w8a8_rows
from ..kernels.w8a8 import scale_sums, w8a8_gemm, w8a8_quant_rows
from ..ops import attention
from ..ops.activations import gelu_tanh
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope, rope_cos_sin
from .siglip import layer_params

Params = Dict[str, Any]
KVCache = Dict[str, torch.Tensor]  # {"k": (L,B,S,n_kv,d), "v": (L,B,S,n_kv,d)}
CachePos = Union[int, torch.Tensor]  # one write offset, or (B,) int per row


def init_params(generator: torch.Generator, cfg: GemmaConfig,
                dtype: torch.dtype = torch.float32) -> Params:
    """Random decoder weights (``convert.init_lm_params``), made on the
    generator's device."""
    return convert.init_lm_params(cfg, generator, generator.device, dtype)


def init_kv_cache(
    cfg: GemmaConfig, batch: int, max_seq: int, dtype: torch.dtype, *,
    device: torch.device,
) -> KVCache:
    shape = (cfg.num_hidden_layers, batch, max_seq, cfg.num_key_value_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def embed_tokens(params: Params, ids: torch.Tensor, mesh=None) -> torch.Tensor:
    """Embedding rows of ``ids``; under a mesh from the vocab-sharded table
    (core/mesh.vocab_parallel_embed)."""
    if mesh is None:
        return params["embed"][ids.long()]
    return mesh_lib.vocab_parallel_embed(params["embed"], ids, mesh)


def _embed_scale(cfg: GemmaConfig, dtype: torch.dtype) -> float:
    """sqrt(hidden) rounded to the activation dtype, as the reference rounds
    its normalizer. A Python number: a device tensor made from a Python
    value is a host-to-device copy that waits for the card, once per step."""
    return float(torch.tensor(cfg.hidden_size**0.5, dtype=dtype))


def _lora_delta(y: torch.Tensor, lora_lp: Optional[Params], name: str, cast: bool = True):
    """``y @ A @ B * (alpha / r)`` for projection ``name`` of one layer's
    adapters, or None. Computed in the adapter dtype (fp32 adapters over a
    bf16 base), returned in the activation dtype (``cast=False``: in the
    adapter dtype, a row-parallel rank's partial before its sum).

    A multi-LoRA bank slice (``a`` (N+1, in, r), train/lora.stack_lora_bank)
    gives every batch row its own adapter, picked by the (B,) ids under
    ``lora_lp["__ids__"]`` (models/paligemma.lora_with_ids; id 0 is the
    zero adapter of the base model): through the concat basis when the bank
    has it, ``(y @ a_cat) * block_mask @ b_cat`` with alpha folded into
    b_cat, else by gathering each row's a, b and scale."""
    if lora_lp is None or name not in lora_lp:
        return None
    a, b = lora_lp[name]["a"], lora_lp[name]["b"]
    scale = lora_lp[name]["alpha"] / a.shape[-1]
    if a.dim() == 3:
        ids = lora_lp["__ids__"].long()
        if "a_cat" in lora_lp[name]:
            a_cat, b_cat = lora_lp[name]["a_cat"], lora_lp[name]["b_cat"]
            col_ad = torch.arange(a_cat.shape[-1], device=a_cat.device) // a.shape[-1]
            mask = (col_ad[None] == ids[:, None]).to(a_cat.dtype)
            z = (y.to(a_cat.dtype) @ a_cat) * mask[:, None, :]
            delta = z @ b_cat
        else:
            s_rows = scale[ids].to(a.dtype)
            delta = torch.einsum("bsi,bir->bsr", y.to(a.dtype), a[ids])
            delta = torch.einsum("bsr,bro->bso", delta, b[ids]) * s_rows[:, None, None]
    else:
        delta = ((y.to(a.dtype) @ a) @ b) * scale.to(a.dtype)
    return delta.to(y.dtype) if cast else delta


def _plus_lora(base: torch.Tensor, y: torch.Tensor, lora_lp: Optional[Params], name: str):
    delta = _lora_delta(y, lora_lp, name)
    return base if delta is None else base + delta


def _attn_proj(cfg: GemmaConfig, y: torch.Tensor, lp: Params,
               lora_lp: Optional[Params] = None, int8_act: bool = False):
    """q/k/v projections (+ LoRA), fused ``qkv`` serving layout or separate
    weights; ``int8_act``: W8A8 at prefill rows (quant.matmul_any)."""
    b, s, _ = y.shape
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    if "qkv" in lp["attn"]:
        qkv = matmul_any(y, lp["attn"]["qkv"], int8_act)
        nq = nh * hd
        q, k, v = qkv[..., :nq], qkv[..., nq : nq + nkv * hd], qkv[..., nq + nkv * hd :]
    else:
        q = matmul_any(y, lp["attn"]["q"], int8_act)
        k = matmul_any(y, lp["attn"]["k"], int8_act)
        v = matmul_any(y, lp["attn"]["v"], int8_act)
    q, k, v = (_plus_lora(t, y, lora_lp, n) for t, n in ((q, "q"), (k, "k"), (v, "v")))
    return (q.reshape(b, s, nh, hd), k.reshape(b, s, nkv, hd),
            v.reshape(b, s, nkv, hd))


def _row_parallel(y: torch.Tensor, w, mesh, int8_act: bool = False,
                  lora_lp: Optional[Params] = None, name: str = "") -> torch.Tensor:
    """A row-parallel projection (o, down), plus target ``name``'s adapter
    delta with ``lora_lp``. Under a mesh each rank's fp32 partial (int8: dot
    then scale; dense: the bf16 product) is summed across ranks and cast
    once, so one rank gives ``matmul_any``'s bits; the rank's partial delta
    (its K rows of y against its rows of A, core/mesh.shard_lora) rides the
    same all-reduce beside it and is cast and added after the base, as on
    one card. With ``int8_act`` an int8 product at prefill rows is W8A8
    (:func:`_w8a8_row_parallel`), and one below the gate on the card takes
    the fp32-partial GEMV (no fp32 copy of the weight)."""
    if mesh is None:
        return _plus_lora(matmul_any(y, w, int8_act), y, lora_lp, name)
    delta = _lora_delta(y, lora_lp, name, cast=False)
    if isinstance(w, dict) and "w8" in w:
        if int8_act and w8a8_rows(y):
            base = _w8a8_row_parallel(y, w, mesh)
            if delta is None:
                return base
            return base + mesh_lib.psum(delta.float(), mesh).to(y.dtype)
        if int8_act and y.is_cuda:
            k = y.shape[-1]
            part = int8_gemv_f32(y.reshape(-1, k).contiguous(), w["w8"], w["s"])
            part = part.reshape(*y.shape[:-1], -1)
        else:
            part = (y.float() @ w["w8"].float()) * w["s"]
    else:
        part = matmul_any(y, w).float()
    if delta is None:
        return mesh_lib.psum(part, mesh).to(y.dtype)
    n = part.shape[-1]
    both = mesh_lib.psum(torch.cat([part, delta.float()], dim=-1), mesh)
    return both[..., :n].to(y.dtype) + both[..., n:].to(y.dtype)


def _w8a8_row_parallel(y: torch.Tensor, w: Params, mesh) -> torch.Tensor:
    """W8A8 of a row-parallel projection whose input ``y`` is this rank's K
    shard: each row's amax over the whole K (the max across ranks, as the
    reference's sharded program takes it), this shard quantized with it, the
    int32 partial sums added across ranks (exact), then scaled and cast
    once. So m ranks give the bits of one."""
    k = y.shape[-1]
    y2 = y.reshape(-1, k).contiguous()
    amax = mesh_lib.pmax(y2.abs().amax(dim=-1).float(), mesh)
    x8, a_s = w8a8_quant_rows(y2, amax)
    acc = mesh_lib.psum(w8a8_gemm(x8, w["w8"], a_s, w["s"], out_dtype=torch.int32), mesh)
    return scale_sums(acc, a_s, w["s"], y.dtype).reshape(*y.shape[:-1], -1)


def _mlp(y: torch.Tensor, lp: Params, lora_lp: Optional[Params] = None,
         mesh=None, int8_act: bool = False) -> torch.Tensor:
    """GeGLU MLP (+ LoRA), fused ``gateup`` or separate weights."""
    if "gateup" in lp["mlp"]:
        gu = matmul_any(y, lp["mlp"]["gateup"], int8_act)
        inter = gu.shape[-1] // 2
        gate, up = gu[..., :inter], gu[..., inter:]
    else:
        gate = matmul_any(y, lp["mlp"]["gate"], int8_act)
        up = matmul_any(y, lp["mlp"]["up"], int8_act)
    h = gelu_tanh(_plus_lora(gate, y, lora_lp, "gate")) * _plus_lora(up, y, lora_lp, "up")
    return _row_parallel(h, lp["mlp"]["down"], mesh, int8_act, lora_lp, "down")


def _decoder_block(
    cfg: GemmaConfig,
    x: torch.Tensor,  # (B, S, H)
    lp: Params,
    cos: torch.Tensor,
    sin: torch.Tensor,
    kv_cache: Optional[KVCache],  # None: training, attend over this block's k/v
    layer_idx: int,
    cache_pos: CachePos,
    mask: Optional[torch.Tensor],  # (B, 1, S, W) additive (plain attention)
    flash_lens: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    kv_bucket: Optional[int] = None,
    lora_lp: Optional[Params] = None,
    mesh=None,
    mlp_full: Optional[Params] = None,  # stacked int8 MLP: kernels/decode_mlp at layer_idx
    int8_act: bool = False,  # W8A8 projections at prefill rows
) -> torch.Tensor:
    """One pre-norm decoder block; writes its K/V rows into the cache, if
    there is one. ``cfg`` is the rank's local config under a mesh."""
    b, s, _ = x.shape
    nh, hd = cfg.num_attention_heads, cfg.head_dim

    residual = x
    y = mesh_lib.copy_to_model(rms_norm(x, lp["input_norm"], cfg.rms_norm_eps), mesh)
    q, k, v = _attn_proj(cfg, y, lp, lora_lp, int8_act)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if kv_cache is not None:
        k_all, v_all = kv_cache["k"], kv_cache["v"]
        # in-place cache write (the reference donates the cache instead)
        if torch.is_tensor(cache_pos):  # per-row positions: each row's s-token block
            rows = torch.arange(b, device=x.device)[:, None]
            # a finished row's block may reach past the cache end: clamped, it
            # stays inside the row (such a row is never read again)
            at = (cache_pos.long()[:, None] + torch.arange(s, device=x.device)[None]).clamp_(
                max=k_all.shape[2] - 1)
            k_all[layer_idx, rows, at] = k.to(k_all.dtype)
            v_all[layer_idx, rows, at] = v.to(v_all.dtype)
        else:
            k_all[layer_idx, :, cache_pos : cache_pos + s] = k.to(k_all.dtype)
            v_all[layer_idx, :, cache_pos : cache_pos + s] = v.to(v_all.dtype)

    if flash_lens is not None:
        # prefill and training: the fresh k/v are the whole sequence
        prefix_lens, seq_lens = flash_lens
        args = (q.contiguous(), k.contiguous(), v.contiguous(), prefix_lens, seq_lens)
        a = (flash_attention(*args, scale=hd**-0.5) if mesh is None
             else flash_attention_sharded(*args, mesh, scale=hd**-0.5))
    elif kv_cache is None:
        a = attention.gqa(q, k, v, mask, scale=hd**-0.5)
    else:
        window = min(kv_bucket or k_all.shape[2], k_all.shape[2])
        k_att = k_all[layer_idx, :, :window].to(q.dtype)
        v_att = v_all[layer_idx, :, :window].to(q.dtype)
        a = attention.gqa(q, k_att, v_att, mask, scale=hd**-0.5)
    a = a.reshape(b, s, nh * hd)
    x = residual + _row_parallel(a, lp["attn"]["o"], mesh, int8_act, lora_lp, "o")

    residual = x
    if mlp_full is not None:  # the post-attention norm in the gate/up GEMV's prologue
        return residual + mlp_decode_fused(x, mlp_full, layer_idx,
                                           norm=(lp["post_norm"], cfg.rms_norm_eps))
    y = mesh_lib.copy_to_model(rms_norm(x, lp["post_norm"], cfg.rms_norm_eps), mesh)
    return residual + _mlp(y, lp, lora_lp, mesh, int8_act)


def lm_head(params: Params, x: torch.Tensor, *, mesh=None, int8_act: bool = False
            ) -> torch.Tensor:
    """Tied bias-free LM head; the int8 copy ("head_q") when present. Under
    a mesh the rank's vocab shard, gathered (fp32 logits). ``int8_act`` (the
    head of a W8A8 prefill): the int8 head stays weight-only, as the
    reference's, and on the card takes the int8 GEMV tile
    (quant.int8_matmul_card), never a dequantized copy of the head. In
    training under a mesh the gathered logits hand each rank the gradient
    of its vocab shard, and ``x`` the sum of the shards' (core/mesh)."""
    x = mesh_lib.copy_to_model(x, mesh)
    if "head_q" in params:
        hq = params["head_q"]
        logits = int8_matmul_card(x, hq["w8"], hq["s"]) if int8_act else matmul_any(x, hq)
    else:
        logits = x @ params["embed"].T.to(x.dtype)
    return logits if mesh is None else mesh_lib.gather_vocab(logits, mesh)


def decode_head(params: Params, h: torch.Tensor, greedy_head: bool, mesh=None):
    """Head of the kernel decode paths on the final-normed (B, K) rows:
    greedy ids from the argmax kernel (the (B, vocab) logits row is never
    written; under a mesh each rank's shard, combined across ranks), or fp32
    logits (B, 1, vocab) from the int8 GEMV head (under a mesh each rank's
    vocab shard, gathered)."""
    head_q = params.get("head_q", {})
    if greedy_head and "w8_blk" in head_q:
        if mesh is not None:
            return decode_layer_tp.head_argmax_tp(h, head_q, mesh)
        return head_argmax_fused(h, head_q)
    if "w8" in head_q:
        logits = int8_gemv(h, head_q["w8"], head_q["s"])
        if mesh is not None:
            logits = mesh_lib.gather_vocab(logits, mesh)
    else:
        logits = lm_head(params, h, mesh=mesh)
    logits = logits.float()[:, None, :]
    if greedy_head:
        return logits[:, -1].argmax(dim=-1).to(torch.int32)
    return logits


def _fused_decode(
    params: Params, cfg: GemmaConfig, x: torch.Tensor, cos, sin,
    kv_cache: KVCache, cache_pos: CachePos, kv_valid: torch.Tensor,
    kv_bucket: Optional[int], greedy_head: bool, mesh=None,
    lora_pack: Optional[Params] = None, adapter_ids: Optional[torch.Tensor] = None,
    rows_per_cache: int = 1,
):
    """Single-token decode through the hand-written kernels; under a mesh
    the tensor-parallel chain (kernels/decode_layer_tp) of this rank's
    decode_layer_tp.repack_for_tp tree. ``lora_pack`` / ``adapter_ids``:
    each row's adapter inside the chain; ``rows_per_cache``: rows per
    cache row (both kernels/decode_layer)."""
    b = x.shape[0]
    if mesh is None and not decode_layer.supported(cfg, params["layers"], b):
        raise ValueError(
            "fused_layer: the decode kernels need the int8 serving tree of "
            "runtime.quantize and a config/batch that decode_layer.supported "
            "accepts; pass fused_layer=False for the plain path")
    n_layers, n_rows, max_seq = kv_cache["k"].shape[:3]
    hd = cfg.head_dim
    k_flat = kv_cache["k"].view(n_layers, n_rows, max_seq, hd)  # n_kv == 1
    v_flat = kv_cache["v"].view(n_layers, n_rows, max_seq, hd)
    window = min(kv_bucket or max_seq, max_seq)
    if torch.is_tensor(cache_pos):
        pos = cache_pos.to(device=x.device, dtype=torch.int32)
    else:
        pos = torch.full((b,), cache_pos, dtype=torch.int32, device=x.device)
    valid = kv_valid[:, :window].contiguous()  # one copy for all layers
    # the layer chain writes the fresh K/V rows of every layer into the
    # cache in place (kernels/decode_layer), so k_new/v_new need no write here
    if mesh is not None:
        h = decode_layer_tp.layers_decode_tp(
            x, params["layers"], k_flat, v_flat, pos, valid, cos[:, 0], sin[:, 0], hd,
            cfg.rms_norm_eps, mesh, lora_pack=lora_pack, adapter_ids=adapter_ids,
            rows_per_cache=rows_per_cache)
    else:
        h, _, _ = decode_layer.layers_decode_fused(
            x, params["layers"], k_flat, v_flat, pos, valid,
            cos[:, 0], sin[:, 0], window, cfg.num_attention_heads, hd,
            cfg.rms_norm_eps, lora_pack=lora_pack, adapter_ids=adapter_ids,
            rows_per_cache=rows_per_cache,
        )
    h = rms_norm_kernel(h.reshape(b, -1), params["final_norm"], cfg.rms_norm_eps)
    return decode_head(params, h, greedy_head, mesh), kv_cache


def _layer_lora(lora: Optional[Params], i: int) -> Optional[Params]:
    """Layer ``i``'s slice of an adapter tree or bank (its ids included)."""
    return None if lora is None else layer_params(lora["layers"], i)


def fused_lora_operands(lora: Optional[Params]):
    """(lora_pack, adapter_ids) of the kernel decode chains: a bank with its
    kernel operands and per-row ids (models/paligemma.lora_with_ids), or
    (None, None) without adapters."""
    if lora is None:
        return None, None
    if "__fused_pack__" not in lora or "__ids__" not in lora.get("layers", {}):
        raise ValueError(
            "the kernel decode paths take LoRA only as a multi-LoRA bank with per-row ids "
            "and its kernel operands (lora['__fused_pack__'] = kernels/decode_layer."
            "repack_lora_bank_fused); use a plain decode path otherwise")
    return lora["__fused_pack__"], lora["layers"]["__ids__"][0]


def forward(
    params: Params,
    cfg: GemmaConfig,
    input_embeds: torch.Tensor,  # (B, S, H), image embeds already merged
    position_ids: torch.Tensor,  # (B, S) int
    kv_cache: KVCache,
    cache_pos: CachePos,  # write offset into the cache, or (B,) per row (S == 1)
    kv_valid: torch.Tensor,  # (B, max_seq) bool: attendable slots AFTER write,
    # or pairwise (B, S, max_seq) (recompute prefills, plain path)
    *,
    flash_lens: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    logits_idx: Optional[torch.Tensor] = None,  # (B,) positions to project
    mesh=None,  # tensor parallel: params are this rank's slices
    kv_bucket: Optional[int] = None,  # attend-window (decode)
    fused_mlp: bool = False,  # one-card decode: each layer's MLP via kernels/decode_mlp
    fused_layer: bool = False,  # decode (S == 1) through the kernels, or raise
    greedy_head: bool = False,  # return argmax token ids, not logits
    lora: Optional[Params] = None,  # un-merged adapters or a per-row bank
    int8_act: bool = False,  # W8A8 int8-weight projections at prefill rows
    rows_per_cache: int = 1,  # fused_layer: rows sharing a cache row (a verify's s)
) -> Tuple[torch.Tensor, KVCache]:
    """Run the decoder stack. Returns (fp32 logits (B, S', vocab) or (B,)
    int32 ids with ``greedy_head``, the cache updated in place). ``cfg`` is
    the whole model's config, also under a mesh.

    ``lora``: adapters applied un-merged in every layer, or a multi-LoRA
    bank with per-row ids (models/paligemma.lora_with_ids). The kernel
    decode (``fused_layer``) takes a bank only with its kernel operands
    (``lora["__fused_pack__"]``, kernels/decode_layer.repack_lora_bank_fused)
    and raises otherwise; under a mesh the adapters are this rank's shard
    (core/mesh.shard_lora) and the pack is built from it.
    ``rows_per_cache`` = s (kernel decode only): the B rows are the s
    positions of B / s verify blocks, rows ``[c s, (c + 1) s)`` writing
    into and attending cache row c (kernels/decode_layer, or under a mesh
    kernels/decode_layer_tp). ``int8_act``
    (a prefill from the int8 tree): every int8 projection of at least 256
    rows is W8A8 (kernels/quant.matmul_any); the head stays weight-only
    (``lm_head``)."""
    if rows_per_cache != 1 and not (fused_layer and input_embeds.shape[1] == 1):
        raise ValueError("rows_per_cache: the kernel decode (fused_layer) only")
    dtype = input_embeds.dtype
    x = input_embeds * _embed_scale(cfg, dtype)
    cos, sin = rope_cos_sin(position_ids, cfg.head_dim, cfg.rope_theta, dtype)
    b, s = input_embeds.shape[:2]
    if kv_bucket is not None:
        kv_bucket = min(kv_bucket, kv_valid.shape[-1])

    if fused_layer and s == 1:
        pack, ids = fused_lora_operands(lora)
        return _fused_decode(params, cfg, x, cos, sin, kv_cache, cache_pos,
                             kv_valid, kv_bucket, greedy_head, mesh, pack, ids, rows_per_cache)
    lcfg = cfg if mesh is None else mesh_lib.local_text_config(cfg, mesh.model)
    mlp_full = (params["layers"]["mlp"] if fused_mlp and s == 1 and mesh is None
                and lora is None else None)

    mask = None
    if flash_lens is None:
        kv_vis = kv_valid[..., :kv_bucket] if kv_bucket is not None else kv_valid
        if kv_vis.dim() == 2:
            kv_vis = kv_vis[:, None, :].expand(b, s, kv_vis.shape[-1])
        mask = attention.make_additive_mask(kv_vis)

    n_layers = kv_cache["k"].shape[0]
    for i in range(n_layers):
        x = _decoder_block(
            lcfg, x, layer_params(params["layers"], i), cos, sin, kv_cache, i,
            cache_pos, mask, flash_lens=flash_lens, kv_bucket=kv_bucket,
            lora_lp=_layer_lora(lora, i), mesh=mesh, mlp_full=mlp_full, int8_act=int8_act,
        )
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    if logits_idx is not None:
        # project only the requested positions (each row's last valid token)
        x = x[torch.arange(b, device=x.device), logits_idx.long()][:, None]
    logits = lm_head(params, x, mesh=mesh, int8_act=int8_act).float()
    if greedy_head:
        return logits[:, -1].argmax(dim=-1).to(torch.int32), kv_cache
    return logits, kv_cache


def forward_paged_decode(
    params: Params,
    cfg: GemmaConfig,
    input_embeds: torch.Tensor,  # (B, 1, H) one token per row
    position_ids: torch.Tensor,  # (B, 1) int RoPE positions
    pool: KVCache,  # {"k","v"}: (L, n_pages, page_size, n_kv, d), updated in place
    page_table: torch.Tensor,  # (B, P_max) int32 physical page per logical page
    write_pos: torch.Tensor,  # (B,) int32 logical position this token lands at
    use_kernel: bool = True,
    pages_bucket: Optional[int] = None,  # logical pages attended (covers every row)
    paged_kernel: str = "multi",  # "one"|"multi"|"batched"|"runs": one kernel here
    lora: Optional[Params] = None,  # un-merged adapters or a per-row bank
    *,
    mesh=None,  # tensor parallel: params are this rank's slices, the pool replicated
) -> Tuple[torch.Tensor, KVCache]:
    """Single-token decode over the paged pool, the page walk: per layer,
    write this token's K/V into page ``table[r, pos // ps]`` at slot
    ``pos % ps``, then attend over the row's logical pages ``[0, pos]`` with
    kernels/paged_attention reading the layer-stacked pool by offset
    (``use_kernel=False``: its plain version). Returns (fp32 logits
    (B, 1, vocab), the pool). ``lora`` rides the torch projections, as in
    ``forward`` (under a mesh, this rank's shard of it)."""
    b = input_embeds.shape[0]
    hd = cfg.head_dim
    ps = pool["k"].shape[2]
    lcfg = cfg if mesh is None else mesh_lib.local_text_config(cfg, mesh.model)
    dtype = input_embeds.dtype
    x = input_embeds * _embed_scale(cfg, dtype)
    cos, sin = rope_cos_sin(position_ids, hd, cfg.rope_theta, dtype)
    write_pos = write_pos.to(torch.int32)
    kv_len = write_pos + 1
    rows = torch.arange(b, device=x.device)
    wp = write_pos.long()
    page_of = page_table.long()[rows, wp // ps]  # (B,) physical page of this token
    off_of = wp % ps
    table = page_table.to(torch.int32)
    if pages_bucket is not None:
        table = table[:, : min(pages_bucket, table.shape[1])]
    attend = paged_attn.VARIANTS[paged_kernel] if use_kernel else (
        paged_attn.reference_paged_decode_attention)
    for i in range(pool["k"].shape[0]):
        lp = layer_params(params["layers"], i)
        lora_lp = _layer_lora(lora, i)
        residual = x
        y = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps)
        q, k, v = _attn_proj(lcfg, y, lp, lora_lp)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        pool["k"][i, page_of, off_of] = k[:, 0].to(pool["k"].dtype)
        pool["v"][i, page_of, off_of] = v[:, 0].to(pool["v"].dtype)
        a = attend(q[:, 0].contiguous(), pool["k"], pool["v"], table, kv_len,
                   hd**-0.5, layer_idx=i)
        a = a.reshape(b, 1, -1)
        x = residual + _row_parallel(a, lp["attn"]["o"], mesh, lora_lp=lora_lp, name="o")
        residual = x
        y = rms_norm(x, lp["post_norm"], cfg.rms_norm_eps)
        x = residual + _mlp(y, lp, lora_lp, mesh=mesh)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return lm_head(params, x, mesh=mesh).float(), pool


def forward_paged_decode_fused(
    params: Params,
    cfg: GemmaConfig,
    input_embeds: torch.Tensor,  # (B, 1, H)
    position_ids: torch.Tensor,  # (B, 1) int
    pool: KVCache,  # page pool (L, n_pages, page_size, 1, d), updated in place
    page_table: torch.Tensor,  # (B, P_max) int32
    write_pos: torch.Tensor,  # (B,) int32
    pages_bucket: int,
    lora_pack: Optional[Params] = None,  # kernels/decode_layer.repack_lora_bank_fused
    adapter_ids: Optional[torch.Tensor] = None,  # (B,) int32 bank rows
    greedy_head: bool = False,  # return argmax token ids, not logits
    *,
    mesh=None,  # tensor parallel: this rank's repack_for_tp tree, the pool replicated
) -> Tuple[torch.Tensor, KVCache]:
    """Paged decode through kernels/decode_layer_paged, then the final norm
    kernel and the head of the fused dense path (argmax kernel with
    ``greedy_head`` and a blocked head, else int8 GEMV logits). Needs the
    int8 serving tree (kernels/decode_layer.repack_layers); raises on a
    tree, config or batch the kernels cannot take. Under a mesh the
    tensor-parallel chain (kernels/decode_layer_paged_tp) of this rank's
    decode_layer_tp.repack_for_tp tree, its head shards combined across
    ranks. ``lora_pack`` / ``adapter_ids``: each row's adapter inside the
    chain (under a mesh, the pack of this rank's shard of the bank)."""
    b = input_embeds.shape[0]
    n_layers, n_pages, ps = pool["k"].shape[:3]
    if mesh is None and not decode_layer_paged.supported(cfg, params["layers"], b, page_size=ps):
        raise ValueError(
            "paged fused decode: the kernels need the int8 serving tree of "
            "runtime.quantize, one KV head and a page size that "
            "decode_layer_paged.supported accepts; use the page walk instead")
    hd = cfg.head_dim
    dtype = input_embeds.dtype
    x = input_embeds * _embed_scale(cfg, dtype)
    cos, sin = rope_cos_sin(position_ids, hd, cfg.rope_theta, dtype)
    k_flat = pool["k"].view(n_layers, n_pages, ps, hd)  # n_kv == 1
    v_flat = pool["v"].view(n_layers, n_pages, ps, hd)
    if mesh is not None:
        h = decode_layer_paged_tp.layers_decode_paged_tp(
            x, params["layers"], k_flat, v_flat, page_table, write_pos, cos[:, 0], sin[:, 0],
            pages_bucket, hd, cfg.rms_norm_eps, mesh, lora_pack=lora_pack,
            adapter_ids=adapter_ids)
    else:
        h, _, _ = decode_layer_paged.layers_decode_fused_paged(
            x, params["layers"], k_flat, v_flat, page_table, write_pos,
            cos[:, 0], sin[:, 0], cfg.num_attention_heads, hd, cfg.rms_norm_eps,
            pages_bucket=pages_bucket, lora_pack=lora_pack, adapter_ids=adapter_ids,
        )
    h = rms_norm_kernel(h.reshape(b, -1), params["final_norm"], cfg.rms_norm_eps)
    return decode_head(params, h, greedy_head, mesh), pool


def forward_paged_verify(
    params: Params,
    cfg: GemmaConfig,
    input_embeds: torch.Tensor,  # (B, s, H): s = the seed token + s - 1 drafts
    position_ids: torch.Tensor,  # (B, s) int RoPE positions
    pool: KVCache,  # {"k","v"}: (L, n_pages, page_size, n_kv, d), updated in place
    page_table: torch.Tensor,  # (B, P_max) int32
    write_pos: torch.Tensor,  # (B,) int: logical position of each row's first token
    pages_bucket: Optional[int] = None,
    *,
    mesh=None,  # tensor parallel: params are this rank's slices, the pool replicated
) -> Tuple[torch.Tensor, KVCache]:
    """Speculative verify over the pool, plain torch ops: per layer token j
    of row r writes its K/V into page ``table[r, (wp + j) // ps]`` (a block
    may cross a page; positions past the table's width are dropped), then
    query j attends the row's logical positions ``[0, wp + j]``. Returns
    ((B, s, vocab) fp32 logits, the pool). Under a mesh the plain sharded
    layers (as ``forward_paged_decode``)."""
    b, s = input_embeds.shape[:2]
    lcfg = cfg if mesh is None else mesh_lib.local_text_config(cfg, mesh.model)
    nkv, hd = cfg.num_key_value_heads, cfg.head_dim
    ps = pool["k"].shape[2]
    dev = input_embeds.device
    x = input_embeds * _embed_scale(cfg, input_embeds.dtype)
    cos, sin = rope_cos_sin(position_ids, hd, cfg.rope_theta, x.dtype)
    table_all = page_table.long()
    n_slots = table_all.shape[1] * ps
    tokpos = write_pos.to(dev).long()[:, None] + torch.arange(s, device=dev)[None]  # (B, s)
    keep = tokpos < n_slots
    at = tokpos.clamp(max=n_slots - 1)
    slot = torch.gather(table_all, 1, at // ps) * ps + at % ps  # (B, s) pool slot
    slot_w = slot[keep]
    table = table_all
    if pages_bucket is not None:
        table = table[:, : min(pages_bucket, table.shape[1])]
    w = table.shape[1] * ps
    vis = torch.arange(w, device=dev)[None, None, :] <= tokpos[:, :, None]  # (B, s, W)
    mask = attention.make_additive_mask(vis)
    for i in range(pool["k"].shape[0]):
        lp = layer_params(params["layers"], i)
        residual = x
        y = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps)
        q, k, v = _attn_proj(lcfg, y, lp)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        for name, t in (("k", k), ("v", v)):
            flat = pool[name][i].view(-1, nkv, hd)
            flat[slot_w] = t[keep].to(flat.dtype)
        k_g = pool["k"][i][table].reshape(b, w, nkv, hd)
        v_g = pool["v"][i][table].reshape(b, w, nkv, hd)
        a = attention.gqa(q, k_g.to(q.dtype), v_g.to(q.dtype), mask, scale=hd**-0.5)
        a = a.reshape(b, s, -1)
        x = residual + _row_parallel(a, lp["attn"]["o"], mesh)
        residual = x
        y = rms_norm(x, lp["post_norm"], cfg.rms_norm_eps)
        x = residual + _mlp(y, lp, mesh=mesh)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return lm_head(params, x, mesh=mesh).float(), pool


def forward_train(
    params: Params,
    cfg: GemmaConfig,
    input_embeds: torch.Tensor,  # (B, S, H)
    position_ids: torch.Tensor,  # (B, S)
    pairwise_valid: Optional[torch.Tensor],  # (B, S, S) bool: q row may attend k col
    lora: Optional[Params] = None,
    remat: bool = True,
    flash_lens: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    mesh=None,
    *,
    fsdp: Optional[mesh_lib.Fsdp] = None,
) -> torch.Tensor:
    """No-cache forward for training (prefix-LM: bidirectional prefix,
    causal suffix, from ``pairwise_valid`` or, on the flash path, from
    ``flash_lens`` = (prefix_lens, kv_lens)). Returns fp32 logits
    (B, S, vocab). ``remat`` recomputes each block in the backward pass
    (``torch.utils.checkpoint``, non-reentrant) instead of keeping its
    activations.

    ``mesh``: tensor parallel (params and adapters this rank's slices): the
    rank computes with its heads and MLP columns (``local_text_config``),
    attention through ``flash_attention_sharded`` on the flash path, and
    the logits are gathered by vocab; the recompute of a block issues the
    block's collectives again, in the same order on every rank. ``fsdp``:
    the layers' leaves are data shards (core/mesh.Fsdp), each layer
    gathered where it runs, and again in its recompute."""
    dtype = input_embeds.dtype
    lcfg = cfg if mesh is None else mesh_lib.local_text_config(cfg, mesh.model)
    x = input_embeds * _embed_scale(cfg, dtype)
    cos, sin = rope_cos_sin(position_ids, cfg.head_dim, cfg.rope_theta, dtype)
    mask = None if flash_lens is not None else attention.make_additive_mask(pairwise_valid)

    def block(h, i, lora_lp):
        lp = (layer_params(params["layers"], i) if fsdp is None
              else fsdp.layer(params["layers"], i))
        return _decoder_block(lcfg, h, lp, cos, sin, None, 0, 0, mask,
                              flash_lens=flash_lens, lora_lp=lora_lp, mesh=mesh)

    for i in range(cfg.num_hidden_layers):
        lora_lp = None if lora is None else layer_params(lora["layers"], i)
        if remat:
            x = checkpoint(block, x, i, lora_lp, use_reentrant=False)
        else:
            x = block(x, i, lora_lp)
    top = params if fsdp is None else fsdp.full({k: v for k, v in params.items()
                                                 if k != "layers"})
    x = rms_norm(x, top["final_norm"], cfg.rms_norm_eps)
    return lm_head(top, x, mesh=mesh).float()
