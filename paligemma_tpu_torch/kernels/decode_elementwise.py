"""The final Gemma RMSNorm of the kernel decode paths (Triton), and the
plain RoPE + KV-cache write that the qkv GEMV's epilogue replaced.

``rms_norm`` is the norm before the head (models/gemma's kernel decode,
after the layer chain): the one norm of a decode step that is not a GEMV's
prologue (the layers' input and post-attention norms run in the prologue of
the GEMV that reads them, kernels/int8_gemv ``norm=``). It replaces the
final rmsnorm of paligemma_tpu/kernels/decode_layer.py ``_kernel_all``'s
merged head (``yh = rmsnorm(x, fnorm_ref)``). It is bound by moving a few KB per row: one load and one store of
each element, no reuse, so Triton's block model is enough. The kernel lives
in ``_triton_decode``, which imports ``triton``; the launching function
imports it on a CUDA tensor's first launch (``triton`` is absent where the
CPU tests run), and the kernel is compiled on its first launch. The kernel
loads in any dtype and stores in the output's: fp32 rows (``--dtype
float32``) launch it as they are, counted apart on :func:`rms_norm_fp32`.

``rope_kv_write_reference`` and ``rope_kv_write_paged_reference`` are the
plain RoPE + cache write of the TPU kernels' decode layer (the half-split
rotation of q and k, the fresh K/V rows at ``pos``: a dense row, or the
slot a page table names): the plain version of kernels/int8_gemv
``int8_gemv_rope_kv``'s epilogue, and the tests' oracle.
"""

from __future__ import annotations

import torch

from ..ops.norms import rms_norm as rms_norm_reference
from ..ops.rope import rotate_half


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Gemma RMSNorm of (B, K) rows: fp32, ``x * rsqrt(mean(x^2)+eps) * (1+w)``."""
    if not x.is_cuda:
        return rms_norm_reference(x, weight, eps)
    if x.dim() != 2 or x.dtype not in (torch.bfloat16, torch.float32) or not x.is_contiguous():
        raise ValueError("rms_norm: x must be contiguous bf16 or fp32 (B, K)")
    b, k = x.shape
    if weight.shape != (k,) or not weight.is_contiguous() or weight.device != x.device:
        raise ValueError(f"rms_norm: weight must be contiguous ({k},) on {x.device}")
    fp32 = x.dtype == torch.float32
    from . import _triton_decode

    out = torch.empty_like(x)
    _triton_decode.rms_norm_kernel[(b,)](
        x, weight, out, k, float(eps), BLOCK=1 << (k - 1).bit_length(), num_warps=8,
    )
    (rms_norm_fp32 if fp32 else rms_norm).launches += 1
    return out


rms_norm.launches = 0


def rms_norm_fp32(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """:func:`rms_norm` of fp32 rows (fp32 out); the count of its launches
    (which :func:`rms_norm` makes for fp32 x)."""
    if x.dtype != torch.float32:
        raise ValueError(f"rms_norm_fp32: fp32 x, got {x.dtype}")
    return rms_norm(x, weight, eps)


rms_norm_fp32.launches = 0


def _rope(qkv, cos, sin, n_heads):
    """Plain RoPE of the fused row: (q (B, H, D), k (B, D), v (B, D))."""
    b = qkv.shape[0]
    d = cos.shape[-1]
    x = qkv.float().reshape(b, n_heads + 2, d)
    rot = x * cos.float()[:, None] + rotate_half(x) * sin.float()[:, None]
    return (rot[:, :n_heads].to(qkv.dtype), rot[:, n_heads].to(qkv.dtype),
            qkv[:, (n_heads + 1) * d:])


def rope_kv_write_reference(qkv, cos, sin, pos, n_heads, k_cache, v_cache, k_new, v_new):
    """Split the fused (B, (H+2)*D) q|k|v, apply half-split RoPE to q and k,
    and write k and v into row ``pos`` of the (B, S, D) cache and into
    ``k_new`` / ``v_new`` (in place). Returns (q (B, H, D), k_new, v_new)."""
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
    """:func:`rope_kv_write_reference` into a (n_pages, ps, D) page pool:
    row r's K and V land in slot ``page_table[r, pos // ps] * ps + pos %
    ps`` (a row whose table is all 0 writes into the garbage page 0)."""
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
