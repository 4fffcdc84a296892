"""Vision-tower MHA (port of
paligemma_tpu/kernels/ablation/vision_attention.py); the kernel is
``csrc/vision_attention.cu``.

Non-causal, unmasked attention over all S patches (256 at 224 px, 1024 at
448 px, 4096 at 896 px, head_dim 72 for So400m), with the TPU kernel's
arithmetic:

    s = q k^T * scale (fp32),  p = exp(s - rowmax),  o = (p.astype(v) v) / rowsum(p)

The plain version is that one-shot softmax. The kernel streams K and V in
128-key tiles with an online softmax (a running max and sum per row) on
wgmma tensor-core products fed by TMA, so it holds no row of scores whole
and takes any S the TPU kernel takes (a multiple of 128).

fp32 q, k and v take the fp32 form (counted apart on
:func:`vision_attention_fp32`): the fp32 flash forward
(``csrc/flash_attention.cu`` ``flash_fwd_f32_kernel``, entry point
``pg_vision_attention_fp32``) with every key visible and no lse, which is
this function at fp32 with p unrounded (the TPU kernel's cast of p to v's
dtype is the identity there). The wrapper's rules are the bf16 kernel's.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _build

MAX_HEAD_DIM = 128  # the deepest instantiation of csrc/vision_attention.cu
MAX_GRID_YZ = 65535
TARGET_BLOCKS = 132  # one block per SM of an H100
MAX_ROWS = 2**31 - 1  # B * S: TMA's row coordinate is a 32-bit int


def rows_per_block(b: int, s: int, h: int) -> int:
    """Query rows per block: 128 (two consumer warpgroups sharing each K/V
    tile) unless that leaves most SMs idle, else 64 (one). On an H100 at
    S1024 H16 D72, 128 blocks of 128 rows took 19 us against 34 for 256
    blocks of 64 (tools/attention_times.py)."""
    return 128 if (s // 128) * h * b >= TARGET_BLOCKS // 2 else 64


def launch_plan(b: int, s: int, h: int, d: int) -> int:
    """The kernel's rows per block for a (B, S, H, D) call; raises
    ValueError for a shape the kernel does not take."""
    if (d % 8 or not 0 < d <= MAX_HEAD_DIM or h > MAX_GRID_YZ or b > MAX_GRID_YZ
            or b * s > MAX_ROWS):
        raise ValueError(f"vision_attention: head_dim {d} must be a multiple of 8 <= "
                         f"{MAX_HEAD_DIM}, H and B <= {MAX_GRID_YZ}, B * S <= {MAX_ROWS}")
    return rows_per_block(b, s, h)


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
    Hopper launch (one block per 64 or 128 query rows and head). S must
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
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"vision_attention: bf16 or fp32 q, k and v, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.dtype != q.dtype or t.shape != q.shape or not t.is_contiguous()
                or t.device != dev or t.data_ptr() % 16):
            raise ValueError(f"vision_attention: {name} must be contiguous 16-byte aligned "
                             f"{q.dtype} (B, S, H, D) on q's device: q's dtype")
    rows = launch_plan(b, s, h, d)
    out = torch.empty_like(q)
    lib = _build.library()
    if q.dtype == torch.float32:
        err = lib.pg_vision_attention_fp32(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                           out.data_ptr(), b, s, h, d, float(scale),
                                           _build.stream_ptr(dev))
        _build.check(err, "vision_attention_fp32")
        vision_attention_fp32.launches += 1
        return out
    err = lib.pg_vision_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, d, rows,
        float(scale), _build.stream_ptr(dev))
    _build.check(err, "vision_attention")
    vision_attention.launches += 1
    return out


vision_attention.launches = 0


def vision_attention_fp32(q, k, v, scale: Optional[float] = None,
                          head_block: Optional[int] = None) -> torch.Tensor:
    """:func:`vision_attention` of fp32 q, k and v; the count of its fp32
    form's launches (which :func:`vision_attention` makes for fp32 q)."""
    if q.dtype != torch.float32:
        raise ValueError(f"vision_attention_fp32: fp32 q, k and v, got {q.dtype}")
    return vision_attention(q, k, v, scale, head_block)


vision_attention_fp32.launches = 0
