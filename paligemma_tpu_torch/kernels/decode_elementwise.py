"""Triton kernels for the one-pass pieces of a decode layer: Gemma RMSNorm
and the fused RoPE + KV-cache write. They replace the norm, RoPE and
cache-row steps of paligemma_tpu/kernels/decode_layer.py ``_kernel_all``
(and the final norm before kernels/decode_head), and the fresh-token page
write that paligemma_tpu/kernels/decode_layer_paged.py ``_kernel_paged``
leaves to its caller: ``rope_kv_write_paged`` is the same kernel with the
destination row looked up in a page table on the device.

Both are bound by moving a few KB per row: one load and one store of each
element, no reuse, so there is no shared-memory schedule to control and
Triton's block model is enough. The kernels live in ``_triton_decode``,
which imports ``triton``; the launching functions import it on a CUDA
tensor's first launch (``triton`` is absent where the CPU tests run), and
each kernel is compiled on its first launch.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.norms import rms_norm as rms_norm_reference
from ..ops.rope import rotate_half


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Gemma RMSNorm of (B, K) rows: fp32, ``x * rsqrt(mean(x^2)+eps) * (1+w)``."""
    if not x.is_cuda:
        return rms_norm_reference(x, weight, eps)
    if x.dim() != 2 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError("rms_norm: x must be contiguous bf16 (B, K)")
    b, k = x.shape
    if weight.shape != (k,) or not weight.is_contiguous() or weight.device != x.device:
        raise ValueError(f"rms_norm: weight must be contiguous ({k},) on {x.device}")
    from . import _triton_decode

    out = torch.empty_like(x)
    _triton_decode.rms_norm_kernel[(b,)](
        x, weight, out, k, float(eps), BLOCK=1 << (k - 1).bit_length(), num_warps=8,
    )
    rms_norm.launches += 1
    return out


rms_norm.launches = 0


def _rope(qkv, cos, sin, n_heads):
    """Plain RoPE of the fused row: (q (B, H, D), k (B, D), v (B, D))."""
    b = qkv.shape[0]
    d = cos.shape[-1]
    x = qkv.float().reshape(b, n_heads + 2, d)
    rot = x * cos.float()[:, None] + rotate_half(x) * sin.float()[:, None]
    return (rot[:, :n_heads].to(qkv.dtype), rot[:, n_heads].to(qkv.dtype),
            qkv[:, (n_heads + 1) * d:])


def rope_kv_write_reference(qkv, cos, sin, pos, n_heads, k_cache, v_cache, k_new, v_new):
    """Plain version of :func:`rope_kv_write` (writes the cache rows in place)."""
    q, k, v = _rope(qkv, cos, sin, n_heads)
    rows = torch.arange(qkv.shape[0], device=qkv.device)
    p = pos.to(qkv.device).long()
    k_cache[rows, p] = k.to(k_cache.dtype)
    v_cache[rows, p] = v.to(v_cache.dtype)
    k_new.copy_(k)
    v_new.copy_(v)
    return q, k_new, v_new


def rope_kv_write_paged_reference(qkv, cos, sin, pos, n_heads, k_pool, v_pool, page_table,
                                  k_new, v_new):
    """Plain version of :func:`rope_kv_write_paged` (writes the pool slots in place)."""
    q, k, v = _rope(qkv, cos, sin, n_heads)
    ps = k_pool.shape[1]
    rows = torch.arange(qkv.shape[0], device=qkv.device)
    p = pos.to(qkv.device).long()
    slot = page_table.long()[rows, p // ps] * ps + p % ps
    k_pool.view(-1, k_pool.shape[-1])[slot] = k.to(k_pool.dtype)
    v_pool.view(-1, v_pool.shape[-1])[slot] = v.to(v_pool.dtype)
    k_new.copy_(k)
    v_new.copy_(v)
    return q, k_new, v_new


def _check_rope(name, qkv, cos, sin, pos, n_heads, k_new, v_new):
    b = qkv.shape[0]
    d = cos.shape[-1]
    half = d // 2
    dev = qkv.device
    if qkv.dtype != torch.bfloat16 or not qkv.is_contiguous() or qkv.shape != (b, (n_heads + 2) * d):
        raise ValueError(f"{name}: qkv must be contiguous bf16 (B, (H+2)*D)")
    if half & (half - 1):
        raise ValueError(f"{name}: head_dim/2 = {half} must be a power of two")
    for arg, t in (("cos", cos), ("sin", sin)):
        if t.shape != (b, d) or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name}: {arg} must be contiguous (B, D)")
    if pos.shape != (b,) or pos.dtype != torch.int32 or pos.device != dev:
        raise ValueError(f"{name}: pos must be (B,) int32")
    if not (k_new.is_contiguous() and v_new.is_contiguous() and k_new.shape == (b, d)):
        raise ValueError(f"{name}: k_new/v_new must be contiguous (B, D)")


def rope_kv_write(
    qkv: torch.Tensor,  # (B, (H + 2) * D) fused q|k|v of one layer
    cos: torch.Tensor,  # (B, D)
    sin: torch.Tensor,  # (B, D)
    pos: torch.Tensor,  # (B,) int32 cache row of this token per batch row
    n_heads: int,
    k_cache: torch.Tensor,  # (B, S, D) one layer, written in place
    v_cache: torch.Tensor,
    k_new: torch.Tensor,  # (B, D) out: the fresh key row
    v_new: torch.Tensor,  # (B, D) out: the fresh value row
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Split q|k|v, apply half-split RoPE to q and k, and write k and v into
    this layer's cache at ``pos`` and into ``k_new`` / ``v_new`` (in place).
    Returns (q (B, H, D), k_new, v_new)."""
    if not qkv.is_cuda:
        return rope_kv_write_reference(qkv, cos, sin, pos, n_heads, k_cache,
                                       v_cache, k_new, v_new)
    _check_rope("rope_kv_write", qkv, cos, sin, pos, n_heads, k_new, v_new)
    b, d = cos.shape
    for name, c in (("k_cache", k_cache), ("v_cache", v_cache)):
        if c.dim() != 3 or c.shape[0] != b or c.shape[2] != d or not c.is_contiguous():
            raise ValueError(f"rope_kv_write: {name} must be contiguous (B, S, D)")
    from . import _triton_decode

    q = torch.empty((b, n_heads, d), dtype=qkv.dtype, device=qkv.device)
    _triton_decode.rope_kv_write_kernel[(b, n_heads + 2)](
        qkv, cos, sin, pos, q, k_cache, v_cache, k_new, v_new, pos,
        qkv.shape[1], k_cache.shape[1] * d, 0, H=n_heads, D=d, HALF=d // 2,
        PAGED=False, PS=1, num_warps=4,
    )
    rope_kv_write.launches += 1
    return q, k_new, v_new


rope_kv_write.launches = 0


def rope_kv_write_paged(
    qkv: torch.Tensor,  # (B, (H + 2) * D) fused q|k|v of one layer
    cos: torch.Tensor,  # (B, D)
    sin: torch.Tensor,  # (B, D)
    pos: torch.Tensor,  # (B,) int32 logical position of this token per row
    n_heads: int,
    k_pool: torch.Tensor,  # (n_pages, ps, D) one layer's pool, written in place
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # (B, P) int32 covering every row's pos // ps
    k_new: torch.Tensor,  # (B, D) out: the fresh key row
    v_new: torch.Tensor,  # (B, D) out: the fresh value row
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`rope_kv_write` into a page pool: row r's K and V land in slot
    ``page_table[r, pos // ps] * ps + pos % ps`` (a row whose table is all 0
    writes into the garbage page 0). Returns (q (B, H, D), k_new, v_new)."""
    if not qkv.is_cuda:
        return rope_kv_write_paged_reference(qkv, cos, sin, pos, n_heads, k_pool, v_pool,
                                             page_table, k_new, v_new)
    _check_rope("rope_kv_write_paged", qkv, cos, sin, pos, n_heads, k_new, v_new)
    b, d = cos.shape
    for name, c in (("k_pool", k_pool), ("v_pool", v_pool)):
        if c.dim() != 3 or c.shape[2] != d or not c.is_contiguous() or c.shape != k_pool.shape:
            raise ValueError(f"rope_kv_write_paged: {name} must be contiguous (n_pages, ps, D)")
    if (page_table.dtype != torch.int32 or page_table.dim() != 2 or page_table.shape[0] != b
            or page_table.stride(1) != 1 or page_table.device != qkv.device):
        raise ValueError("rope_kv_write_paged: page_table must be (B, P) int32 with unit "
                         "column stride")
    from . import _triton_decode

    q = torch.empty((b, n_heads, d), dtype=qkv.dtype, device=qkv.device)
    _triton_decode.rope_kv_write_kernel[(b, n_heads + 2)](
        qkv, cos, sin, pos, q, k_pool, v_pool, k_new, v_new, page_table,
        qkv.shape[1], 0, page_table.stride(0), H=n_heads, D=d, HALF=d // 2,
        PAGED=True, PS=k_pool.shape[1], num_warps=4,
    )
    rope_kv_write_paged.launches += 1
    return q, k_new, v_new


rope_kv_write_paged.launches = 0
