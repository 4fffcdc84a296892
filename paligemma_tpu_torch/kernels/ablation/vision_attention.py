"""Vision-tower MHA (port of
paligemma_tpu/kernels/ablation/vision_attention.py); the kernel is
``csrc/vision_attention.cu``.

Non-causal, unmasked attention over all S patches (256 at 224 px, 1024 at
448 px, 4096 at 896 px, head_dim 72 for So400m), with the TPU kernel's
arithmetic:

    s = q k^T * scale (fp32),  p = exp(s - rowmax),  o = (p.astype(v) v) / rowsum(p)

The plain version is that one-shot softmax. The kernel streams K and V with
an online softmax (a running max and sum per row), so it holds no row of
scores whole and takes any S the TPU kernel takes (a multiple of 128).
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _build

MAX_HEAD_DIM = 128  # VA_DMAX
MAX_GRID_YZ = 65535
TARGET_BLOCKS = 132  # one block per SM of an H100


def warps_per_block(b: int, s: int, h: int) -> int:
    """16-row query groups per block: the most (up to 4, which share each
    staged K/V tile) that still give every SM a block."""
    for w in (4, 2):
        if (s // (16 * w)) * h * b >= TARGET_BLOCKS:
            return w
    return 1


def vision_attention_reference(q, k, v, scale: float) -> torch.Tensor:
    """Plain version: the TPU kernel's one-shot softmax, (B, S, H, D) in
    q's dtype."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float()) / l
    return o.transpose(1, 2).to(q.dtype)


def vision_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, H, D)
    v: torch.Tensor,  # (B, S, H, D)
    scale: Optional[float] = None,
    head_block: Optional[int] = None,
) -> torch.Tensor:
    """Non-causal, unmasked MHA over all S positions (vision-tower shape).

    ``head_block`` is checked (it must divide H) for parity with the TPU
    kernel, whose grid step took that many heads; it does not change the
    Hopper launch (one block per 16, 32 or 64 query rows and head). S must
    be a multiple of 128, as on the TPU: the tower never pads its
    patches."""
    b, s, h, d = q.shape
    if scale is None:
        scale = d**-0.5
    if head_block is None:
        head_block = min(h, 4)
    if h % head_block:
        raise ValueError(f"vision_attention: head_block {head_block} must divide H {h}")
    if s % 128:
        raise NotImplementedError(f"vision_attention requires S % 128 == 0 (got {s})")
    if not q.is_cuda:
        return vision_attention_reference(q, k, v, scale)
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.dtype != torch.bfloat16 or t.shape != q.shape or not t.is_contiguous()
                or t.device != dev or t.data_ptr() % 16):
            raise ValueError(f"vision_attention: {name} must be contiguous 16-byte aligned "
                             "bf16 (B, S, H, D) on q's device")
    if d % 8 or d > MAX_HEAD_DIM or h > MAX_GRID_YZ or b > MAX_GRID_YZ:
        raise ValueError(f"vision_attention: head_dim {d} must be a multiple of 8 <= "
                         f"{MAX_HEAD_DIM}, H and B <= {MAX_GRID_YZ}")
    out = torch.empty_like(q)
    err = _build.library().pg_vision_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, d,
        warps_per_block(b, s, h), float(scale), _build.stream_ptr(dev))
    _build.check(err, "vision_attention")
    vision_attention.launches += 1
    return out


vision_attention.launches = 0
