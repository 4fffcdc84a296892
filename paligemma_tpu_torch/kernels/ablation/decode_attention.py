"""Length-aware single-token decode attention over a dense KV cache (port of
paligemma_tpu/kernels/ablation/decode_attention.py); the kernel is
``csrc/seg_attention.cu``.

One query token per row, GQA over a ``(B, S_max, Hkv, D)`` cache. The
visible keys are three scalars per row, no (B, S_max) mask:

    visible(j) = j < seg0_end  OR  seg1_start <= j < kv_len

``seg0_end == seg1_start`` gives the contiguous ``[0, kv_len)``; a
right-padded row has its prompt ``[0, n_valid)``, a pad hole and the decode
window ``[prompt_len, kv_len)``. The kernel skips every 32-key tile that
holds no visible key (past ``kv_len`` or inside the hole) without reading
it. A row with no visible key gives zeros (the TPU kernel gives the mean of
the values it read there; callers never ask for such a row).

fp32 q and an fp32 cache take the fp32 form (counted apart on
:func:`decode_attention_fp32`): ``csrc/attention_split.cuh``'s fp32 split
pass over the same visible-key policy (fp32 tiles, scores and p.v on the
CUDA cores, p not rounded) and the combine writing fp32.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from ..decode_attention import MAX_BATCH, MAX_HEADS, SplitPlan


def supported(s_max: int, head_dim: int) -> bool:
    """Cache lengths and head sizes the kernel takes: any cache length, a
    head_dim that is a multiple of 8 up to 256."""
    return s_max > 0 and head_dim % 8 == 0 and 0 < head_dim <= 256


def split_plan(q: torch.Tensor, k_cache: torch.Tensor) -> SplitPlan:
    """The plan of a call: the cache's length is the window."""
    b, hq, d = q.shape
    s_max, hkv = k_cache.shape[1], k_cache.shape[2]
    return SplitPlan(rows=b * hkv, groups=hq // hkv, head_dim=d, window=s_max)


def reference_decode_attention(q, k_cache, v_cache, seg0_end, seg1_start, kv_len, scale=None):
    """Plain version: fp32 scores and softmax over the visible keys;
    (B, Hq, D) in q's dtype, zeros for a row with no visible key."""
    b, hq, d = q.shape
    s_max, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    if scale is None:
        scale = d**-0.5
    col = torch.arange(s_max, device=q.device)[None]
    s0, s1, kl = (t.to(q.device).long()[:, None] for t in (seg0_end, seg1_start, kv_len))
    ok = (col < s0) | ((col >= s1) & (col < kl))  # (B, S)
    s = torch.einsum("bhgd,bshd->bhgs", q.reshape(b, hkv, g, d).float(), k_cache.float()) * scale
    s = s.masked_fill(~ok[:, None, None], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    den = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(den > 0, den, torch.ones_like(den))
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    return out.reshape(b, hq, d).to(q.dtype)


def decode_attention(
    q: torch.Tensor,  # (B, Hq, D) — one query token per row
    k_cache: torch.Tensor,  # (B, S_max, Hkv, D)
    v_cache: torch.Tensor,  # (B, S_max, Hkv, D)
    seg0_end: torch.Tensor,  # (B,) int
    seg1_start: torch.Tensor,  # (B,) int
    kv_len: torch.Tensor,  # (B,) int (= write_pos + 1: includes this token)
    scale: Optional[float] = None,
    block_k: Optional[int] = None,
) -> torch.Tensor:
    """Length-aware decode attention; (B, Hq, D) out. ``block_k`` is checked
    (it must divide S_max) for parity with the TPU kernel's key block; the
    Hopper kernel's tile is 32 keys whatever it is."""
    b, hq, d = q.shape
    s_max, hkv = k_cache.shape[1], k_cache.shape[2]
    if block_k is not None and s_max % block_k:
        raise ValueError(f"decode_attention: block_k {block_k} must divide S_max {s_max}")
    if not q.is_cuda:
        return reference_decode_attention(q, k_cache, v_cache, seg0_end, seg1_start, kv_len,
                                          scale)
    dev = q.device
    if scale is None:
        scale = d**-0.5
    if q.dtype not in (torch.bfloat16, torch.float32) or not q.is_contiguous():
        raise ValueError("decode_attention: q must be contiguous bf16 or fp32 (B, Hq, D)")
    fp32 = q.dtype == torch.float32
    for name, c in (("k_cache", k_cache), ("v_cache", v_cache)):
        if (c.dtype != q.dtype or c.shape != (b, s_max, hkv, d) or not c.is_contiguous()
                or c.device != dev or c.data_ptr() % 16):
            raise ValueError(f"decode_attention: {name} must be contiguous 16-byte aligned "
                             f"{q.dtype} (B, S_max, Hkv, D) with q's B and D: q's dtype")
    segs = []
    for name, t in (("seg0_end", seg0_end), ("seg1_start", seg1_start), ("kv_len", kv_len)):
        if t.shape != (b,) or t.device != dev:
            raise ValueError(f"decode_attention: {name} must be (B,) on q's device")
        segs.append(t.to(torch.int32).contiguous())
    if hq % hkv or hq // hkv > MAX_HEADS or not supported(s_max, d) or b * hkv > MAX_BATCH:
        raise ValueError(f"decode_attention: Hq {hq} a multiple of Hkv {hkv} with at most "
                         f"{MAX_HEADS} per KV head, head_dim {d} a multiple of 8 <= 256, "
                         f"B*Hkv <= {MAX_BATCH}")
    plan = split_plan(q, k_cache)
    part_m, part_l, part_o = plan.scratch(dev)
    out = torch.empty((b, hq, d), dtype=q.dtype, device=dev)
    lib = _build.library()
    err = (lib.pg_seg_attention_fp32 if fp32 else lib.pg_seg_attention)(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), *(t.data_ptr() for t in segs),
        part_m.data_ptr(), part_l.data_ptr(), part_o.data_ptr(), out.data_ptr(), b, hq, hkv, d,
        s_max, plan.nsplit, float(scale), _build.stream_ptr(dev))
    _build.check(err, "decode_attention_fp32" if fp32 else "decode_attention")
    (decode_attention_fp32 if fp32 else decode_attention).launches += 1
    return out


decode_attention.launches = 0


def decode_attention_fp32(q, k_cache, v_cache, seg0_end, seg1_start, kv_len, scale=None,
                          block_k=None):
    """:func:`decode_attention` of fp32 q and cache on the fp32 split pass;
    the count of its launches (which :func:`decode_attention` makes for fp32
    q)."""
    if q.dtype != torch.float32:
        raise ValueError(f"decode_attention_fp32: fp32 q and cache, got {q.dtype}")
    return decode_attention(q, k_cache, v_cache, seg0_end, seg1_start, kv_len, scale, block_k)


decode_attention_fp32.launches = 0
