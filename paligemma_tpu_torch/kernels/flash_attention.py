"""Prefix-LM flash attention, forward (port of
paligemma_tpu/kernels/flash_attention.py).

Mask rule: key ``j`` is visible to the query at absolute position ``i`` iff

    j < kv_len[b]  AND  (j < prefix_len[b]  OR  j <= i)

with ``i = query index + q_offset``. Prefill passes ``prefix_len == kv_len``
(bidirectional over valid tokens). A row with no visible key gives 0.

``flash_attention`` launches ``csrc/flash_attention.cu`` for CUDA tensors
and runs :func:`reference_attention` for CPU tensors. The backward pass of
the TPU kernel (training) is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

NEG_INF = -1e30


def reference_attention(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Skv, Hkv, D)
    v: torch.Tensor,  # (B, Skv, Hkv, D)
    prefix_len: torch.Tensor,  # (B,) int
    kv_len: torch.Tensor,  # (B,) int
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Plain version: fp32 scores and softmax over the visible keys."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    if scale is None:
        scale = d**-0.5
    dev = q.device
    row = torch.arange(sq, device=dev)[None, :, None] + q_offset
    col = torch.arange(skv, device=dev)[None, None, :]
    kvl = kv_len.to(dev).long()[:, None, None]
    pfx = prefix_len.to(dev).long()[:, None, None]
    allowed = (col < kvl) & ((col < pfx) | (col <= row))  # (B, Sq, Skv)
    qg = q.reshape(b, sq, hkv, g, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    s = s.masked_fill(~allowed[:, None, None], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    den = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(den > 0, den, torch.ones_like(den))  # no key -> 0
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    prefix_len: torch.Tensor,
    kv_len: torch.Tensor,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Blockwise prefix-LM attention; (B, Sq, Hq, D) out."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not q.is_cuda:
        return reference_attention(q, k, v, prefix_len, kv_len, scale, q_offset)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be contiguous bf16 on {q.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte aligned")
    if k.shape != (b, skv, hkv, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: k/v shape {tuple(k.shape)} vs q {tuple(q.shape)}")
    if d % 8 or d > 256 or hq % hkv:
        raise ValueError(f"flash_attention: head_dim {d} (multiple of 8, <= 256), Hq {hq}, Hkv {hkv}")
    lens = []
    for name, t in (("prefix_len", prefix_len), ("kv_len", kv_len)):
        if t.shape != (b,) or t.dtype != torch.int32 or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be (B,) int32 on {q.device}")
        lens.append(t.contiguous())
    out = torch.empty_like(q)
    lib = _build.library()
    err = lib.pg_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens[0].data_ptr(), lens[1].data_ptr(),
        out.data_ptr(), b, sq, skv, hq, hkv, d, float(scale), int(q_offset),
        _build.stream_ptr(q.device),
    )
    _build.check(err, "flash_attention_fwd")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
