"""Int4 weight-only quantization with an unpack-in-kernel matmul (port of
paligemma_tpu/kernels/ablation/quant4.py); the kernels are
``csrc/int4_matmul.cu``, one launch a call as ``_wq_gemm.WqPlan`` plans it:
at decode rows (M <= 16) the int8 GEMV's tensor-core tile in its int4 form,
K split over a cluster as :class:`~..gemv_plan.GemvPlan` plans the (K/2, N)
stored rows; above that the wgmma + TMA tile of ``csrc/wq_wgmma.cuh``.

Packing ("K-halves"): weights (K, N) become (K/2, N) int8 where

    low  nibble of packed[k, n] = q[k, n]           (k in [0, K/2))
    high nibble of packed[k, n] = q[k + K/2, n]

both signed (-8..7), so ``x @ w = x[:, :K/2] @ low + x[:, K/2:] @ high``
with both halves in their original column order. Symmetric per-output-
channel scales in fp32, as in the int8 path.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import _wq_gemm


def quantize_int4(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(..., K, N) -> {"w4p": (..., K/2, N) int8 packed, "s": (..., N) fp32}."""
    k = w.shape[-2]
    if k % 2:
        raise ValueError("quantize_int4: K must be even for nibble packing")
    wf = w.float()
    scale = wf.abs().amax(dim=-2, keepdim=True).clamp(min=1e-8) / 7.0
    q = torch.round(wf / scale).clamp(-8, 7).to(torch.int32)
    low, high = q[..., : k // 2, :], q[..., k // 2 :, :]
    packed = ((low & 0xF) | (high << 4)).to(torch.int8)
    return {"w4p": packed.contiguous(), "s": scale[..., 0, :].contiguous()}


def _unpack(w4p: torch.Tensor) -> torch.Tensor:
    """(..., K/2, N) packed -> (..., K, N) int32 values, sign-extended."""
    p = w4p.to(torch.int32)
    low = (p << 28) >> 28
    high = (p << 24) >> 28
    return torch.cat([low, high], dim=-2)


def dequantize_int4(q: Dict[str, torch.Tensor], dtype=torch.float32) -> torch.Tensor:
    return (_unpack(q["w4p"]).float() * q["s"][..., None, :]).to(dtype)


def int4_matmul_reference(x: torch.Tensor, w4p: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Plain version: both halves' fp32 products, summed, scaled; x's dtype."""
    k2 = w4p.shape[0]
    full = _unpack(w4p).float()
    xf = x.float()
    acc = xf[..., :k2] @ full[:k2] + xf[..., k2:] @ full[k2:]
    return (acc * s.float()).to(x.dtype)


def int4_matmul(
    x: torch.Tensor,  # (..., K)
    w4p: torch.Tensor,  # (K/2, N) int8 packed
    s: torch.Tensor,  # (N,) fp32
    block_m: int = 256,
    block_n: int = 2048,
    block_k2: int = 1024,
) -> torch.Tensor:
    """``x @ dequant_int4(w4p, s)`` with in-kernel nibble unpacking. The
    ``block_*`` arguments are accepted for parity with the TPU kernel's
    block sizes; the Hopper tiles are fixed by the plan."""
    k2, n = w4p.shape
    *lead, k = x.shape
    if k != 2 * k2:
        raise ValueError(f"int4_matmul: x's K {k} must be twice the packed rows {k2}")
    if not x.is_cuda:
        return int4_matmul_reference(x, w4p, s)
    x2 = x.reshape(-1, k).contiguous()
    s = s.to(torch.float32).contiguous()
    out = _wq_gemm.launch("int4_matmul", _wq_gemm.WqPlan.make(x2.shape[0], k, n, "int4"),
                          x2, w4p, s)
    int4_matmul.launches += 1
    return out.reshape(*lead, n)


int4_matmul.launches = 0
