"""All decoder layers of one decode step over a paged KV pool (port of
paligemma_tpu/kernels/decode_layer_paged.py ``layers_decode_fused_paged``).

The TPU runs all L layers in one Pallas kernel that DMAs each row's window
out of the page pool (one copy per physically consecutive run, per-page
copies otherwise). Here each layer is the chain of kernels/decode_layer with
the two cache steps swapped for their paged forms, six launches a layer:

    int8_gemv_rope_kv with the page table (input norm, q|k|v, RoPE, the
    fresh K/V rows into their slots) -> paged_decode_attention (split +
    combine) -> int8_gemv o + residual -> int8_gemv gateup + GeGLU
    (post-attention norm in the prologue) -> int8_gemv down + residual

The qkv GEMV's epilogue puts each row's fresh K/V in its slot
``table[r, pos // ps] * ps + pos % ps`` (computed on the device), and the
paged attention kernel reads the row's pages ``[0, pos]`` through the table
by pointer offset into the layer-stacked pool. The contract is the TPU
function's, ``(h (B,1,K), k_new (L,B,D), v_new (L,B,D))``; in this port the
chain also writes the fresh rows into the pool in place (the TPU kernel
leaves that to its caller), because the attention kernel reads the fresh
token from the pool. The pool has no per-layer copy and the chain keeps no
window ring, so there is no window-size budget (the TPU's VMEM cap).

``lora_pack`` / ``adapter_ids``: the in-kernel multi-LoRA operands of the
TPU kernel (the same pack, kernels/decode_layer.repack_lora_bank_fused),
applied as in the dense chain: four ``lora_shrink`` per layer, each
expand in the epilogue of its projection's GEMV.

The verify forward of speculative decoding over the pool (the TPU
package's is plain XLA, models/gemma.py ``forward_paged_verify``) is this
chain at B s rows (models/paligemma ``decode_verify_paged``): row r's table
repeated s times, position j of its block written at ``write_pos[r] + j``
(a block may cross a page) and attended with the length
``write_pos[r] + j + 1``, the TPU function's per-query causal bound.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import decode_layer
from .decode_layer import lora_gemv
from .int8_gemv import int8_gemv_rope_kv
from .paged_attention import paged_decode_attention
from .paged_attention import supported as attention_supported


def supported(cfg, layers: Dict, batch: int, *, page_size: int) -> bool:
    """The dense chain's limits (kernels/decode_layer.supported: one KV head,
    the int8 serving tree, the fused GEMVs' shapes) plus a page size the
    paged kernels take. The page table's own checks (int32, one row per
    batch row, unit column stride) are the qkv GEMV's, at its call."""
    return (decode_layer.supported(cfg, layers, batch)
            and attention_supported(page_size, cfg.head_dim))


def layers_decode_fused_paged(
    x: torch.Tensor,  # (B, 1, K)
    layers: Dict,  # stacked int8 serving tree (decode_layer.repack_layers)
    k_pool: torch.Tensor,  # (L, n_pages, ps, D) MQA pool, fresh rows written in place
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # (B, P_max) int32, the full table
    write_pos: torch.Tensor,  # (B,) int32 logical position of this token
    cos: torch.Tensor,  # (B, D)
    sin: torch.Tensor,
    n_heads: int,
    head_dim: int,
    eps: float,
    *,
    pages_bucket: Optional[int] = None,  # logical pages attended (covers every pos)
    lora_pack: Optional[Dict] = None,  # decode_layer.repack_lora_bank_fused() output
    adapter_ids: Optional[torch.Tensor] = None,  # (B,) int32 bank rows
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All L layers for B lockstep rows. Returns (hidden (B,1,K),
    k_new (L,B,D), v_new (L,B,D)).

    Unlike the TPU function, ``page_table`` is the whole table and the
    attended bucket is ``pages_bucket``: the fresh row's slot is looked up in
    the whole table, so a retired row (table all 0, stale position) writes
    into the garbage page. Every ``write_pos`` must lie below the table's
    width times the page size (the serving engines clamp stale positions to
    ``max_seq_len - 1``)."""
    if (lora_pack is None) != (adapter_ids is None):
        raise ValueError("layers_decode_fused_paged: lora_pack and adapter_ids go together")
    b, _, k = x.shape
    n_layers, _, ps, _ = k_pool.shape
    pb = min(pages_bucket or page_table.shape[1], page_table.shape[1])
    attn, mlp = layers["attn"], layers["mlp"]
    scale = head_dim**-0.5
    cos = cos.to(x.dtype).contiguous()
    sin = sin.to(x.dtype).contiguous()
    write_pos = write_pos.to(torch.int32)
    kv_len = write_pos + 1  # the row's pages [0, pos], this token included
    table = page_table.to(torch.int32)
    window = table[:, :pb]
    k_pool5, v_pool5 = k_pool[:, :, :, None], v_pool[:, :, :, None]  # Hkv = 1
    k_new = torch.empty((n_layers, b, head_dim), dtype=k_pool.dtype, device=x.device)
    v_new = torch.empty_like(k_new)
    h = x.reshape(b, k)
    ids = None if adapter_ids is None else adapter_ids.to(torch.int32).contiguous()
    nq = n_heads * head_dim
    inter = mlp["gateup"]["w8"].shape[-1] // 2
    for l in range(n_layers):
        # writes this layer's fresh K/V rows into their pool slots (in place)
        q, _, _ = lora_gemv(h, attn["qkv"], l, lora_pack, "qkv", ids, (nq, nq + head_dim),
                            gemv=int8_gemv_rope_kv, norm=(layers["input_norm"][l], eps),
                            cos=cos, sin=sin, pos=write_pos, n_heads=n_heads, k_dst=k_pool[l],
                            v_dst=v_pool[l], k_new=k_new[l], v_new=v_new[l], page_table=table)
        a = paged_decode_attention(q, k_pool5, v_pool5, window, kv_len, scale, layer_idx=l)
        h = lora_gemv(a.reshape(b, -1), attn["o"], l, lora_pack, "o", ids, residual=h)
        t = lora_gemv(h, mlp["gateup"], l, lora_pack, "gu", ids, (inter,), geglu=True,
                      norm=(layers["post_norm"][l], eps))
        h = lora_gemv(t, mlp["down"], l, lora_pack, "down", ids, residual=h)
    return h.reshape(b, 1, k), k_new, v_new
