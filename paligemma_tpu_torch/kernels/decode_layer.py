"""All decoder layers of one decode step (port of
paligemma_tpu/kernels/decode_layer.py ``layers_decode_fused``).

The TPU runs all L layers in one Pallas kernel so that its weight DMAs never
drain between layers. On Hopper a launch is cheap, so each layer runs as a
short chain of hand-written kernels, each with its plain version beside it:

    rms_norm (Triton) -> int8_gemv qkv -> rope_kv_write (Triton) ->
    decode_attention -> int8_gemv o + residual -> rms_norm ->
    int8_gemv gateup + GeGLU -> int8_gemv down + residual

The contract is the TPU function's: ``(h (B,1,K), k_new (L,B,D),
v_new (L,B,D))``. In this port ``rope_kv_write`` also writes each layer's
fresh K/V rows into the cache in place (the TPU kernel leaves that to the
caller), because the attention kernel reads the fresh token from the cache.

Without the TPU kernel's merged-head and in-kernel LoRA operands: the greedy
head runs as kernels/decode_head right after this function.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .decode_attention import MAX_BATCH, MAX_HEADS, decode_attention
from .decode_elementwise import rms_norm, rope_kv_write
from .int8_gemv import int8_gemv


def supported(cfg, layers: Dict, batch: int) -> bool:
    """Shapes and trees the kernel chain takes (the engine checks this once
    and raises when the kernel path was asked for and this is False).

    The limits are the CUDA kernels' own: one KV head, at most MAX_HEADS
    query heads, head_dim a multiple of 8 up to 256 with a power-of-two
    half (RoPE), the int8 serving tree, and a batch that fits the grid's y
    dimension (decode_attention runs one block row per batch row)."""
    half = cfg.head_dim // 2
    qkv = layers.get("attn", {}).get("qkv")
    return (
        1 <= batch <= MAX_BATCH
        and cfg.num_key_value_heads == 1
        and cfg.num_attention_heads <= MAX_HEADS
        and cfg.head_dim % 8 == 0
        and cfg.head_dim <= 256
        and half & (half - 1) == 0
        and isinstance(qkv, dict)
        and "w8" in qkv
        and isinstance(layers.get("mlp", {}).get("gateup"), dict)
    )


def repack_layers(layers: Dict) -> Dict:
    """Stacked int8 serving tree -> the tree :func:`layers_decode_fused`
    reads, which is the same tree: the GEMV reads the (in, out) int8 weights
    and the (N,) fp32 scales of runtime.quantize as they are. A leaf the
    kernels cannot read raises here, not at the first decode step."""
    for group, names in (("attn", ("qkv", "o")), ("mlp", ("gateup", "down"))):
        for name in names:
            leaf = layers[group][name]
            if not (leaf["w8"].dtype == torch.int8 and leaf["w8"].is_contiguous()
                    and leaf["s"].dtype == torch.float32 and leaf["s"].is_contiguous()):
                raise ValueError(f"repack_layers: {group}.{name} must be contiguous "
                                 "int8 w8 with contiguous fp32 s")
    return layers


def layers_decode_fused(
    x: torch.Tensor,  # (B, 1, K)
    layers: Dict,  # stacked int8 serving tree (repack_layers)
    k_cache: torch.Tensor,  # (L, B, S, D), fresh rows written in place
    v_cache: torch.Tensor,  # (L, B, S, D)
    cache_pos: torch.Tensor,  # (B,) int32 per-row write positions
    kv_valid_window: torch.Tensor,  # (B, W) bool, incl. this token's slot
    cos: torch.Tensor,  # (B, D)
    sin: torch.Tensor,
    window: int,
    n_heads: int,
    head_dim: int,
    eps: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All L layers for B lockstep rows. Returns (hidden (B,1,K),
    k_new (L,B,D), v_new (L,B,D))."""
    b, _, k = x.shape
    n_layers = k_cache.shape[0]
    window = min(window, k_cache.shape[2])
    if kv_valid_window.shape != (b, window):
        raise ValueError(f"kv_valid_window {tuple(kv_valid_window.shape)} != {(b, window)}")
    attn, mlp = layers["attn"], layers["mlp"]
    scale = head_dim**-0.5
    cos = cos.to(x.dtype).contiguous()
    sin = sin.to(x.dtype).contiguous()
    k_new = torch.empty((n_layers, b, head_dim), dtype=k_cache.dtype, device=x.device)
    v_new = torch.empty_like(k_new)
    h = x.reshape(b, k)
    for l in range(n_layers):
        y = rms_norm(h, layers["input_norm"][l], eps)
        qkv = int8_gemv(y, attn["qkv"]["w8"][l], attn["qkv"]["s"][l])
        # writes this layer's fresh K/V rows into the cache (in place)
        q, _, _ = rope_kv_write(qkv, cos, sin, cache_pos, n_heads, k_cache[l],
                                v_cache[l], k_new[l], v_new[l])
        a = decode_attention(q, k_cache[l], v_cache[l], kv_valid_window, scale)
        h = int8_gemv(a, attn["o"]["w8"][l], attn["o"]["s"][l], residual=h)
        y2 = rms_norm(h, layers["post_norm"][l], eps)
        t = int8_gemv(y2, mlp["gateup"]["w8"][l], mlp["gateup"]["s"][l], geglu=True)
        h = int8_gemv(t, mlp["down"]["w8"][l], mlp["down"]["s"][l], residual=h)
    return h.reshape(b, 1, k), k_new, v_new
