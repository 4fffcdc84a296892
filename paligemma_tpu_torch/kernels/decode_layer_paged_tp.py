"""Tensor-parallel paged decode: one layer's attention half on one rank with
the window read through the page table (port of
paligemma_tpu/kernels/decode_layer_paged_tp.py ``attn_decode_paged_tp``,
B8), and the layer loop.

This is kernels/decode_layer_tp's attention half with the two cache steps
of kernels/decode_layer_paged:

    int8_gemv_rope_kv over [q_r | k | v] with the page table (the input
    norm, RoPE over Hl = H/m heads, the fresh K/V rows into their slots) ->
    paged_decode_attention over Hl heads (csrc/paged_attention.cu) ->
    int8_gemv_f32 o-rows

The page pool (L, n_pages, ps, D) is replicated: Gemma has one KV head, so
every rank computes the same K/V from the replicated kv projection and
writes the same slots of its own pool (decode_layer_paged_tp.py:13-18).
The fresh row lands in slot ``table[r, pos // ps] * ps + pos % ps`` before
the attention reads pages [0, pos] through the table; the JAX kernel mixes
it in arithmetically instead, which is the same function.

``lora_pack`` / ``adapter_ids``: each row's adapter of a multi-LoRA bank
inside the chain, as in kernels/decode_layer_tp (K1 on o and down). The
speculative verify at B s rows needs nothing more: each row's table
repeated s times (models/paligemma ``decode_verify_paged``).

The JAX step ``decode_step_paged_tp`` is here models/paligemma.
decode_step_paged with ``paged_kernel="fused_tp"`` and ``mesh``:
models/gemma.forward_paged_decode_fused runs :func:`layers_decode_paged_tp`
and the final norm, then gathers the vocab-sharded int8 head's logits
(the paged engine's state carries per-slot logits for sampling).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import decode_layer_tp
from .paged_attention import paged_decode_attention, reference_paged_decode_attention
from .paged_attention import supported as attention_supported


def supported(cfg, mesh, layers: Dict, batch: int, *, page_size: int) -> bool:
    """The dense TP gate (decode_layer_tp.supported) plus a page size the
    paged kernels take."""
    return (decode_layer_tp.supported(cfg, mesh, layers, batch)
            and attention_supported(page_size, cfg.head_dim))


def _paged_chain(plain, x, layers, k_pool, v_pool, layer_idx, page_table, write_pos, cos, sin,
                 pages_bucket, head_dim, eps, lora_pack=None, adapter_ids=None):
    attend = reference_paged_decode_attention if plain else paged_decode_attention
    table = page_table.to(torch.int32)
    pos = write_pos.to(torch.int32)
    pb = min(pages_bucket or table.shape[1], table.shape[1])
    return decode_layer_tp.attn_chain(
        plain, x, layers, layer_idx, head_dim, eps, (cos, sin, pos),
        (k_pool[layer_idx], v_pool[layer_idx], table),
        lambda q: attend(q, k_pool[:, :, :, None], v_pool[:, :, :, None], table[:, :pb],
                         pos + 1, head_dim**-0.5, layer_idx=layer_idx),
        decode_layer_tp._lora_arg(lora_pack, adapter_ids))


def attn_decode_paged_tp_reference(x, layers, k_pool, v_pool, layer_idx, page_table, write_pos,
                                   cos, sin, pages_bucket, head_dim, eps, *, lora_pack=None,
                                   adapter_ids=None):
    """Plain version of :func:`attn_decode_paged_tp` (writes the pool slots in place)."""
    return _paged_chain(True, x, layers, k_pool, v_pool, layer_idx, page_table, write_pos, cos,
                        sin, pages_bucket, head_dim, eps, lora_pack, adapter_ids)


def attn_decode_paged_tp(
    x: torch.Tensor,  # (B, K) raw hidden state (pre-norm)
    layers: Dict,  # this rank's stacked decode tree (decode_layer_tp.repack_for_tp)
    k_pool: torch.Tensor,  # (L, n_pages, ps, D) replicated pool, written in place
    v_pool: torch.Tensor,
    layer_idx: int,
    *,
    page_table: torch.Tensor,  # (B, P_max) int32, the whole table
    write_pos: torch.Tensor,  # (B,) int32 logical position of this token
    cos: torch.Tensor,  # (B, D)
    sin: torch.Tensor,
    pages_bucket: Optional[int],  # logical pages attended (covers every row's pos)
    head_dim: int,
    eps: float,
    lora_pack: Optional[Dict] = None,  # this rank's repack_lora_bank_fused pack
    adapter_ids: Optional[torch.Tensor] = None,  # (B,) int32 bank rows
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decoder layer's attention half on this rank over the page pool.
    Returns (o-proj partial (B, K) fp32, or (B, 2K) [base | delta] with
    ``lora_pack`` (kernels/decode_layer_tp), k_new (B, D), v_new (B, D))."""
    kw = dict(lora_pack=lora_pack, adapter_ids=adapter_ids)
    if not x.is_cuda:
        return attn_decode_paged_tp_reference(x, layers, k_pool, v_pool, layer_idx, page_table,
                                              write_pos, cos, sin, pages_bucket, head_dim, eps,
                                              **kw)
    out = _paged_chain(False, x, layers, k_pool, v_pool, layer_idx, page_table, write_pos, cos,
                       sin, pages_bucket, head_dim, eps, **kw)
    attn_decode_paged_tp.launches += 1
    return out


attn_decode_paged_tp.launches = 0


def layers_decode_paged_tp(
    x: torch.Tensor,  # (B, 1, K)
    layers: Dict,  # this rank's stacked decode tree
    k_pool: torch.Tensor,  # (L, n_pages, ps, D)
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # (B, P_max) int32
    write_pos: torch.Tensor,  # (B,) int32
    cos: torch.Tensor,  # (B, D)
    sin: torch.Tensor,
    pages_bucket: Optional[int],
    head_dim: int,
    eps: float,
    mesh,
    *,
    lora_pack: Optional[Dict] = None,  # this rank's repack_lora_bank_fused pack
    adapter_ids: Optional[torch.Tensor] = None,  # (B,) int32 bank rows
) -> torch.Tensor:
    """All L layers for B lockstep rows on this rank; (B, 1, K) hidden.
    Every ``write_pos`` lies below the table's width times the page size
    (the engines clamp stale positions). ``lora_pack`` / ``adapter_ids``:
    each row's adapter inside the chain (kernels/decode_layer_tp)."""
    b, _, k = x.shape
    cos = cos.to(x.dtype).contiguous()
    sin = sin.to(x.dtype).contiguous()
    write_pos = write_pos.to(torch.int32)

    def attn_half(h, l):
        return attn_decode_paged_tp(h, layers, k_pool, v_pool, l, page_table=page_table,
                                    write_pos=write_pos, cos=cos, sin=sin,
                                    pages_bucket=pages_bucket, head_dim=head_dim, eps=eps,
                                    lora_pack=lora_pack, adapter_ids=adapter_ids)[0]

    return decode_layer_tp.run_layers(x.reshape(b, k), layers, k_pool.shape[0], eps, mesh,
                                      attn_half, lora_pack, adapter_ids).reshape(b, 1, k)
