"""Single-token MQA attention over a KV-cache window (the attention piece of
paligemma_tpu/kernels/decode_layer.py ``_kernel_all``); the kernel is
``csrc/decode_attention.cu``.

One query token per row, Hq query heads sharing the single KV head, cache
slots ``[0, W)`` of one layer with a (B, W) validity mask, fp32 softmax. The
fresh token's K/V must already be in the cache (kernels/decode_elementwise
``rope_kv_write`` puts it there) and its slot marked valid.
"""

from __future__ import annotations

import torch

from . import _build

KEYS_PER_SPLIT = 32  # csrc/decode_attention.cu DA_KT
MAX_HEADS = 8  # DA_HMAX
MAX_BATCH = 65535  # one block row per batch row: the grid's y limit


def decode_attention_reference(
    q: torch.Tensor,  # (B, H, D)
    k_cache: torch.Tensor,  # (B, S, D) one layer
    v_cache: torch.Tensor,  # (B, S, D)
    valid: torch.Tensor,  # (B, W) bool
    scale: float,
) -> torch.Tensor:
    """Plain version: (B, H*D) in q's dtype; a row with no valid slot gives 0."""
    b, h, d = q.shape
    w = valid.shape[1]
    s = torch.einsum("bhd,bwd->bhw", q.float(), k_cache[:, :w].float()) * scale
    s = s.masked_fill(~valid[:, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    den = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(den > 0, den, torch.ones_like(den))
    out = torch.einsum("bhw,bwd->bhd", p, v_cache[:, :w].float())
    return out.reshape(b, h * d).to(q.dtype)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    valid: torch.Tensor,
    scale: float,
) -> torch.Tensor:
    """Attention of one token per row over the window; (B, H*D) out."""
    if not q.is_cuda:
        return decode_attention_reference(q, k_cache, v_cache, valid, scale)
    b, h, d = q.shape
    s_len = k_cache.shape[1]
    w = valid.shape[1]
    dev = q.device
    if q.dtype != torch.bfloat16 or not q.is_contiguous():
        raise ValueError("decode_attention: q must be contiguous bf16 (B, H, D)")
    for name, c in (("k_cache", k_cache), ("v_cache", v_cache)):
        if (c.dtype != torch.bfloat16 or c.shape != (b, s_len, d)
                or not c.is_contiguous() or c.device != dev or c.data_ptr() % 16):
            raise ValueError(f"decode_attention: {name} must be contiguous 16-byte aligned bf16 (B, S, D)")
    if (valid.dtype != torch.bool or valid.shape != (b, w) or not valid.is_contiguous()
            or valid.device != dev or w > s_len):
        raise ValueError("decode_attention: valid must be contiguous bool (B, W) with W <= S")
    if h > MAX_HEADS or d % 8 or d > 256 or b > MAX_BATCH:
        raise ValueError(f"decode_attention: H {h} <= {MAX_HEADS}, D {d} multiple of 8 <= 256, "
                         f"B {b} <= {MAX_BATCH}")
    nsplit = -(-w // KEYS_PER_SPLIT)
    part_m = torch.empty((b, nsplit, h), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_o = torch.empty((b, nsplit, h, d), dtype=torch.float32, device=dev)
    out = torch.empty((b, h * d), dtype=torch.bfloat16, device=dev)
    lib = _build.library()
    err = lib.pg_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), valid.data_ptr(),
        part_m.data_ptr(), part_l.data_ptr(), part_o.data_ptr(), out.data_ptr(),
        b, h, d, w, s_len * d, nsplit, float(scale), _build.stream_ptr(dev),
    )
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
