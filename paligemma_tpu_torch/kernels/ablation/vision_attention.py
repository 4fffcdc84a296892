"""One-shot softmax MHA for the SigLIP vision tower (port of
paligemma_tpu/kernels/ablation/vision_attention.py); the kernel is
``csrc/vision_attention.cu``.

Non-causal, unmasked attention over all S patches (256 at 224 px, 1024 at
448 px, head_dim 72 for So400m), with the TPU kernel's arithmetic:

    s = q k^T * scale (fp32),  p = exp(s - rowmax),  o = (p.astype(v) v) / rowsum(p)

The kernel keeps 16 query rows' fp32 score rows in shared memory, so S is
bounded by its 227 KB (S = 2048 fits, S = 4096 raises ``ValueError``).
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _build

ROWS_PER_BLOCK = 16  # csrc/vision_attention.cu VA_BQ
MAX_HEAD_DIM = 128  # VA_DMAX
# the kernel's static shared memory: Q and K/V tiles of VA_LD = 136 bf16 per
# row, and the 16 row sums
_STATIC_SMEM = 2 * (ROWS_PER_BLOCK + 64) * (MAX_HEAD_DIM + 8) + 4 * ROWS_PER_BLOCK
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on an H100
MAX_GRID_YZ = 65535


def _smem_bytes(s: int, d: int) -> int:
    """Shared memory of one block at (S, D): scores, partial outputs, tiles."""
    return _STATIC_SMEM + 4 * (ROWS_PER_BLOCK * (s + 4) + 4 * ROWS_PER_BLOCK * d)


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
    Hopper launch (one block per 16 query rows and head). S must be a
    multiple of 128, as on the TPU: the tower never pads its patches."""
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
    if _smem_bytes(s, d) > SMEM_LIMIT:
        raise ValueError(f"vision_attention: S {s} at head_dim {d} needs {_smem_bytes(s, d)} "
                         f"bytes of shared memory per block, above the {SMEM_LIMIT} an H100 "
                         "block may use (the 16 score rows are held whole)")
    out = torch.empty_like(q)
    err = _build.library().pg_vision_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, d, float(scale),
        _build.stream_ptr(dev))
    _build.check(err, "vision_attention")
    vision_attention.launches += 1
    return out


vision_attention.launches = 0
