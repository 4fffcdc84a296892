"""Tensor-parallel decode: one layer's attention half on one rank (port of
paligemma_tpu/kernels/decode_layer_tp.py ``attn_decode_tp``, B7), the
layer loop with the all-reduces between the halves, and the vocab-sharded
greedy head.

One decode layer splits at its two reduction points (Megatron):

    [attn_decode_tp: norm -> local-q + replicated-kv int8 proj -> RoPE ->
     MQA over the window -> o-proj partial in fp32]  --psum-->  residual ->
    norm -> [decode_mlp.mlp_decode_fused: local gate/up -> GeGLU -> down
     partial in fp32]  --psum-->  residual

The TPU runs the attention half as one Pallas kernel per layer; here it is
the chain of the port's own kernels that the one-card layer runs
(kernels/decode_layer), on this rank's slice:

    int8_gemv_rope_kv over [q_r | k | v] (the input norm in its prologue,
    RoPE over Hl = H/m heads and the fresh K/V rows in its epilogue) ->
    decode_attention over Hl heads -> int8_gemv_f32 o-rows (the
    fp32-partial epilogue)

and the MLP half is decode_mlp.mlp_decode_fused with the post-attention
norm in the gate/up GEMV's prologue: six launches a layer, as on one card.

The JAX kernel reads the window before the cache write and mixes the fresh
token in arithmetically (its posmask); this chain writes the fresh K/V into
the cache first and then attends, which is the same function. Gemma has one
KV head, so every rank computes the same k/v from the replicated kv
projection and writes its own identical cache.

Numerics (decode_layer_tp.py:24-27): the partials leave the kernels in fp32
with the scale applied, are summed across ranks, and only then cast and
added to the residual. On one rank that is the one-card chain's bits
(kernels/decode_layer.layers_decode_fused): its epilogue casts the same
fp32 sum and adds it to the same residual.

With a multi-LoRA bank (``lora_pack`` of this rank's shard of the bank:
core/mesh.shard_lora, then decode_layer.repack_lora_bank_fused at the
rank's widths, and ``adapter_ids``) each row's adapter applies inside the
chain, as on one card: the qkv and gate/up shrinks (lora_shrink, over the
whole replicated x) feed the expands of the qkv and gate/up GEMVs, which
write the rank's q / gate / up columns' deltas and the whole k / v delta
(k and v keep their adapters whole). The o and down shrinks read the
rank's K rows of x against the rank's rows of A: a partial basis z_r, and
K1 (int8_gemv_f32_lora) writes z_r @ B beside the base partial, so one
all-reduce sums both ((sum_r z_r) @ B = sum_r (z_r @ B)) and
:func:`add_partial` adds them as the one-card residual epilogue with the
expand does: one rank gives that chain's bits. Each rank rounds its z_r to
bf16, so at m > 1 the delta's rounding differs from one card's.

``rows_per_cache`` = s (the speculative verify at B s rows, as in
kernels/decode_layer): rows ``[c s, (c + 1) s)`` write into and attend
dense cache row c, through the same one-page-per-row table.

Token selection (decode_layer_tp.py:533-540): each rank runs the argmax
head kernel on its vocab shard (padded to the tile by
decode_head.repack_head, so padding never wins) and offsets its id by
``rank * V/m``; an all-gather of (logit, id) picks the first maximum, so a
tie goes to the lowest shard, which holds the lowest global id.

The JAX step ``decode_step_greedy_tp`` is here models/paligemma.
decode_step_greedy with ``mesh`` and ``fused_layer``: models/gemma.forward
runs :func:`layers_decode_tp`, the final norm and :func:`head_argmax_tp`
for greedy rows, or gathers the vocab-sharded int8 head's logits for
sampled ones. The plain version of the whole step is the model's plain
sharded decode (models/gemma.forward with ``mesh`` and
``fused_layer=False``).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from ..core import mesh as mesh_lib
from .decode_attention import MAX_BATCH, MAX_HEADS, decode_attention, decode_attention_reference
from .decode_head import head_argmax_fused, repack_head
from .decode_layer import fused_gemvs_fit, int8_leaves, repack_layers
from .decode_mlp import mlp_decode_fused, pick_block
from .int8_gemv import (int8_gemv_f32, int8_gemv_reference, int8_gemv_rope_kv,
                        int8_gemv_rope_kv_reference)
from .lora import lora_shrink, lora_shrink_reference


def supported(cfg, mesh, layers: Dict, batch: int) -> bool:
    """The JAX gate (decode_layer_tp.supported) with the port's kernel
    limits: a mesh, one KV head, heads, vocab and the MLP width divisible
    by the model axis, at most MAX_HEADS local heads, head_dim a multiple
    of 32 up to 256 (the RoPE epilogue's pairs, the attention kernel's
    depth), the int8 serving tree (``layers`` is the whole, unsharded one)
    with each rank's qkv and gateup shards as the fused GEMVs take them
    (decode_layer.fused_gemvs_fit) and a batch the attention kernel's grid
    takes."""
    if mesh is None:
        return False
    m = mesh.model
    hl, hd = cfg.num_attention_heads // m, cfg.head_dim
    down = layers.get("mlp", {}).get("down")
    inter = down["w8"].shape[-2] if isinstance(down, dict) and "w8" in down else None
    leaves = int8_leaves(layers)
    return (
        1 <= batch <= MAX_BATCH
        and cfg.num_key_value_heads == 1
        and cfg.num_attention_heads % m == 0
        and hl <= MAX_HEADS
        and cfg.vocab_size % m == 0
        and hd % 32 == 0
        and hd <= 256
        and leaves is not None
        and inter is not None
        and inter % m == 0
        and pick_block(inter // m) is not None
        # one rank's shards: [q_r | k | v] and [gate_r | up_r]
        and fused_gemvs_fit(leaves[0].shape[-2], (hl + 2) * hd, 2 * inter // m, hl, hd)
    )


def repack_for_tp(lm: Dict, cfg, mesh) -> Dict:
    """The whole int8 serving LM tree -> this rank's decode tree: the
    layers' fused matrices split at their boundaries and sharded
    (``qkv`` -> [q_r | k | v], ``gateup`` -> [gate_r | up_r], o and down by
    rows; core/mesh.shard_params), the embedding and the int8 head by vocab,
    the head padded to the kernel's tile (decode_head.repack_head). Norms
    stay whole. Raises on a tree or config :func:`supported` refuses."""
    if not supported(cfg, mesh, lm["layers"], batch=1) or "head_q" not in lm:
        raise ValueError("repack_for_tp: the tensor-parallel kernels need one KV head, the int8 "
                         "decode tree of runtime.quantize.quantize_lm_for_serving (with its "
                         "head) and heads, vocab and MLP width divisible by the model axis")
    local = mesh_lib.shard_params(lm, mesh)
    local["layers"] = repack_layers(local["layers"])
    local["head_q"] = repack_head(local["head_q"])
    return local


def _expand(plain: bool, x, pack, name: str, ids, l: int, bounds=(), norm=None):
    """The LoRA expand operand ``(z, b, bounds)`` of target group ``name``
    ("qkv", "o", "gu", "down") of layer ``l`` (None without a pack): the
    shrink of x (of its RMSNorm with ``norm``) against this rank's A."""
    if pack is None:
        return None
    shrink = lora_shrink_reference if plain else lora_shrink
    z = shrink(x, pack[name + "_a"][l], ids, pack["rank"], pack["o_b"].shape[1], norm=norm)
    return z, pack[name + "_b"][l], bounds


def attn_chain(plain: bool, x, layers, layer_idx, head_dim, eps, rope, dst, attend,
               lora=None):
    """The attention half on this rank for either cache layout:
    int8_gemv_rope_kv over [q_r | k | v] (the input norm, RoPE over the Hl
    local heads, the fresh K/V rows into ``dst = (k_dst, v_dst,
    page_table or None)`` in place) -> ``attend(q)`` (attention over the
    window) -> int8_gemv_f32 o rows. ``rope = (cos, sin, pos)``. ``plain``:
    the kernels' plain versions. ``lora = (pack, adapter_ids)``: each row's
    adapter (module docstring). Returns (partial (B, K) fp32, or (B, 2K)
    [base | delta] with ``lora``, k_new, v_new)."""
    qkv_fn, gemv_f32 = _PLAIN if plain else _KERNELS
    pack, ids = lora if lora is not None else (None, None)
    b = x.shape[0]
    attn = layers["attn"]
    hl = attn["qkv"]["w8"].shape[-1] // head_dim - 2  # local query heads
    k_dst, v_dst, table = dst
    k_new = torch.empty((b, head_dim), dtype=k_dst.dtype, device=x.device)
    v_new = torch.empty_like(k_new)
    norm = (layers["input_norm"][layer_idx], eps)
    nq = hl * head_dim
    q, _, _ = qkv_fn(x, attn["qkv"]["w8"][layer_idx], attn["qkv"]["s"][layer_idx], *rope, hl,
                     k_dst, v_dst, k_new, v_new, norm=norm, page_table=table,
                     lora=_expand(plain, x, pack, "qkv", ids, layer_idx, (nq, nq + head_dim),
                                  norm))
    a = attend(q).reshape(b, -1)
    part = gemv_f32(a, attn["o"]["w8"][layer_idx], attn["o"]["s"][layer_idx],
                    lora=_expand(plain, a, pack, "o", ids, layer_idx))
    return part, k_new, v_new


_KERNELS = (int8_gemv_rope_kv, int8_gemv_f32)
_PLAIN = (int8_gemv_rope_kv_reference, functools.partial(int8_gemv_reference, out_fp32=True))


def _lora_arg(lora_pack, adapter_ids):
    if (lora_pack is None) != (adapter_ids is None):
        raise ValueError("the TP chain: lora_pack and adapter_ids go together")
    return None if lora_pack is None else (lora_pack, adapter_ids.to(torch.int32).contiguous())


def _dense_chain(plain, x, layers, k_cache, v_cache, layer_idx, valid, cache_pos, cos, sin,
                 head_dim, eps, lora_pack=None, adapter_ids=None, rows_per_cache=1):
    attend = decode_attention_reference if plain else decode_attention
    k_l, v_l = k_cache[layer_idx], v_cache[layer_idx]
    b = x.shape[0]
    if rows_per_cache < 1 or b != k_l.shape[0] * rows_per_cache:
        raise ValueError(f"attn_decode_tp: {b} rows != {k_l.shape[0]} cache rows x "
                         f"rows_per_cache {rows_per_cache}")
    # rows_per_cache > 1: the cache as a pool of one page per cache row
    table = None if rows_per_cache == 1 else (
        torch.arange(b, dtype=torch.int32, device=x.device) // rows_per_cache)[:, None]
    return attn_chain(plain, x, layers, layer_idx, head_dim, eps,
                      (cos, sin, cache_pos.to(torch.int32)), (k_l, v_l, table),
                      lambda q: attend(q, k_l, v_l, valid, head_dim**-0.5,
                                       rows_per_cache=rows_per_cache),
                      _lora_arg(lora_pack, adapter_ids))


def attn_decode_tp_reference(x, layers, k_cache, v_cache, layer_idx, valid, cache_pos, cos,
                             sin, head_dim, eps, *, lora_pack=None, adapter_ids=None,
                             rows_per_cache=1):
    """Plain version of :func:`attn_decode_tp` (writes the cache rows in place)."""
    return _dense_chain(True, x, layers, k_cache, v_cache, layer_idx, valid, cache_pos, cos,
                        sin, head_dim, eps, lora_pack, adapter_ids, rows_per_cache)


def attn_decode_tp(
    x: torch.Tensor,  # (B, K) raw hidden state (pre-norm)
    layers: Dict,  # this rank's stacked decode tree (repack_for_tp()["layers"])
    k_cache: torch.Tensor,  # (L, B, S, D) replicated cache, fresh rows written in place
    v_cache: torch.Tensor,
    layer_idx: int,
    *,
    valid: torch.Tensor,  # (B, W) bool attendable slots, this token's included
    cache_pos: torch.Tensor,  # (B,) int32 write position per row
    cos: torch.Tensor,  # (B, D)
    sin: torch.Tensor,
    head_dim: int,
    eps: float,
    lora_pack: Optional[Dict] = None,  # this rank's repack_lora_bank_fused pack
    adapter_ids: Optional[torch.Tensor] = None,  # (B,) int32 bank rows
    rows_per_cache: int = 1,  # rows sharing a cache row (a verify block's s)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decoder layer's attention half on this rank. Returns (o-proj
    partial (B, K) fp32, or (B, 2K) [base | delta] with ``lora_pack``,
    k_new (B, D), v_new (B, D)). ``rows_per_cache``: module docstring."""
    kw = dict(lora_pack=lora_pack, adapter_ids=adapter_ids, rows_per_cache=rows_per_cache)
    if not x.is_cuda:
        return attn_decode_tp_reference(x, layers, k_cache, v_cache, layer_idx, valid,
                                        cache_pos, cos, sin, head_dim, eps, **kw)
    out = _dense_chain(False, x, layers, k_cache, v_cache, layer_idx, valid, cache_pos, cos,
                       sin, head_dim, eps, **kw)
    attn_decode_tp.launches += 1
    return out


attn_decode_tp.launches = 0


def add_partial(h: torch.Tensor, part: torch.Tensor, mesh) -> torch.Tensor:
    """The residual plus a row-parallel projection's partials summed across
    ranks: ``h + cast(sum part)``, or for a (B, 2K) [base | delta] partial
    (K1) ``(h + cast(sum base)) + cast(sum delta)``, the one-card residual
    epilogue's order with the expand. One all-reduce either way."""
    part = mesh_lib.psum(part, mesh)
    k = h.shape[-1]
    if part.shape[-1] == k:
        return h + part.to(h.dtype)
    return (h + part[:, :k].to(h.dtype)) + part[:, k:].to(h.dtype)


def run_layers(h: torch.Tensor, layers: Dict, n_layers: int, eps: float, mesh,
               attn_half, lora_pack: Optional[Dict] = None,
               adapter_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """All layers on this rank for (B, K) rows: ``attn_half(h, l)`` gives
    layer l's fp32 o partial, the MLP half (decode_mlp, the post-attention
    norm in its gate/up GEMV, each row's adapter with ``lora_pack``) its
    fp32 down partial; each is summed across ranks, cast, added to the
    residual (:func:`add_partial`)."""
    for l in range(n_layers):
        h = add_partial(h, attn_half(h, l), mesh)
        pm = mlp_decode_fused(h, layers["mlp"], l, out_dtype=torch.float32,
                              norm=(layers["post_norm"][l], eps), lora_pack=lora_pack,
                              adapter_ids=adapter_ids)
        h = add_partial(h, pm, mesh)
    return h


def layers_decode_tp(
    x: torch.Tensor,  # (B, 1, K)
    layers: Dict,  # this rank's stacked decode tree
    k_cache: torch.Tensor,  # (L, B, S, D), fresh rows written in place
    v_cache: torch.Tensor,
    cache_pos: torch.Tensor,  # (B,) int32
    valid: torch.Tensor,  # (B, W) bool, this token's slot included
    cos: torch.Tensor,  # (B, D)
    sin: torch.Tensor,
    head_dim: int,
    eps: float,
    mesh,
    *,
    lora_pack: Optional[Dict] = None,  # this rank's repack_lora_bank_fused pack
    adapter_ids: Optional[torch.Tensor] = None,  # (B,) int32 bank rows
    rows_per_cache: int = 1,  # rows sharing a cache row (a verify block's s)
) -> torch.Tensor:
    """All L layers for B lockstep rows on this rank; (B, 1, K) hidden.
    ``lora_pack`` / ``adapter_ids`` and ``rows_per_cache``: module
    docstring."""
    b, _, k = x.shape
    cos = cos.to(x.dtype).contiguous()
    sin = sin.to(x.dtype).contiguous()

    def attn_half(h, l):
        return attn_decode_tp(h, layers, k_cache, v_cache, l, valid=valid, cache_pos=cache_pos,
                              cos=cos, sin=sin, head_dim=head_dim, eps=eps, lora_pack=lora_pack,
                              adapter_ids=adapter_ids, rows_per_cache=rows_per_cache)[0]

    return run_layers(x.reshape(b, k), layers, k_cache.shape[0], eps, mesh, attn_half,
                      lora_pack, adapter_ids).reshape(b, 1, k)


def pick_first_max(maxes: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(m, B) per-shard winning logits and global ids -> (B,) ids of the
    first maximum over shards (ties: the lowest shard, the lowest id)."""
    win = maxes.argmax(dim=0)
    return ids.gather(0, win[None])[0]


def head_argmax_tp(y: torch.Tensor, head_blk: Dict, mesh) -> torch.Tensor:
    """Greedy ids (B,) int32 from this rank's vocab shard of the int8 head
    (decode_head.repack_head of the shard) and the other ranks'."""
    ids, mx = head_argmax_fused(y, head_blk, return_max=True)
    ids = ids + mesh.rank * head_blk["s"].shape[0]
    return pick_first_max(mesh_lib.all_gather(mx, mesh), mesh_lib.all_gather(ids, mesh))
