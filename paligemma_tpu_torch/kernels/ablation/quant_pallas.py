"""Int8 dequant-in-kernel matmuls (port of
paligemma_tpu/kernels/ablation/quant_pallas.py); the kernel is
``csrc/int8_matmul.cu``, one kernel for both weight layouts.

``x @ dequant(w8, s)`` for int8 weights stored (K, N) (``int8_matmul``) or
N-major (N, K) (``int8_matmul_nmajor``), with a per-column fp32 scale
applied once after the K sweep; the output takes x's dtype. Each call is one
launch, planned by ``_wq_gemm.WqPlan`` from (M, K, N, layout): above 16 rows
of x the wgmma + TMA tile of ``csrc/wq_wgmma.cuh``; at decode rows the int8
GEMV's tile for (K, N) weights (the decode GEMV's function on the same
bytes) and wq_wgmma.cuh's swapped tile for (N, K) ones. The two
``_diffable`` functions are ``torch.autograd.Function``s for a frozen
quantized base: ``dx = (g * s) @ w8^T`` in fp32 (plain torch, as the JAX
backward is XLA outside Pallas), no gradient for the weights.

The production path does not use these: ``kernels/quant.matmul_any`` stays
on its torch op. The ``block_*`` arguments are accepted for parity with the
TPU kernels' block sizes; the Hopper tiles are fixed by the plan.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..quant import quantize_int8
from . import _wq_gemm


def int8_matmul_reference(x: torch.Tensor, w8: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Plain version: fp32 product of x and the int8 values, scaled; x's dtype."""
    return ((x.float() @ w8.float()) * s.float()).to(x.dtype)


def int8_matmul_nmajor_reference(x: torch.Tensor, w8t: torch.Tensor,
                                 s: torch.Tensor) -> torch.Tensor:
    return ((x.float() @ w8t.float().T) * s.float()).to(x.dtype)


def _launch(name, x, w, s, k, n, layout):
    *lead, kx = x.shape
    if kx != k:
        raise ValueError(f"{name}: x's K {kx} differs from the weights' {k}")
    x2 = x.reshape(-1, k).contiguous()
    s = s.to(torch.float32).contiguous()
    plan = _wq_gemm.WqPlan.make(x2.shape[0], k, n, layout)
    return _wq_gemm.launch(name, plan, x2, w, s).reshape(*lead, n)


def int8_matmul(
    x: torch.Tensor,  # (..., K)
    w8: torch.Tensor,  # (K, N) int8
    s: torch.Tensor,  # (N,) fp32
    block_m: int = 256,
    block_n: int = 2048,
    block_k: int = 2048,
) -> torch.Tensor:
    """``x @ dequant(w8, s)`` with in-kernel dequantization."""
    if not x.is_cuda:
        return int8_matmul_reference(x, w8, s)
    k, n = w8.shape
    out = _launch("int8_matmul", x, w8, s, k, n, "kn")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0


def quantize_int8_nmajor(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Quantize (..., K, N) weights stored N-major: {"w8t": (..., N, K) int8,
    "s": (..., N) fp32}."""
    q = quantize_int8(w)
    return {"w8t": q["w8"].transpose(-1, -2).contiguous(), "s": q["s"]}


def int8_matmul_nmajor(
    x: torch.Tensor,  # (..., K)
    w8t: torch.Tensor,  # (N, K) int8
    s: torch.Tensor,  # (N,) fp32
    block_m: int = 256,
    block_n: int = 2048,
    block_k: int = 2048,
) -> torch.Tensor:
    """``x @ dequant(w8t, s).T``: N-major int8 weights, each output column's
    K values contiguous."""
    if not x.is_cuda:
        return int8_matmul_nmajor_reference(x, w8t, s)
    n, k = w8t.shape
    out = _launch("int8_matmul_nmajor", x, w8t, s, k, n, "nk")
    int8_matmul_nmajor.launches += 1
    return out


int8_matmul_nmajor.launches = 0


class _Int8Matmul(torch.autograd.Function):
    """int8_matmul with dx = (g * s) @ w8^T; the weights are frozen."""

    @staticmethod
    def forward(ctx, x, w8, s):
        ctx.save_for_backward(w8, s)
        return int8_matmul(x, w8, s)

    @staticmethod
    def backward(ctx, g):
        w8, s = ctx.saved_tensors
        dx = (g.float() * s) @ w8.float().T
        return dx.to(g.dtype), None, None


class _Int8MatmulNmajor(torch.autograd.Function):
    """int8_matmul_nmajor with dx = (g * s) @ w8t; the weights are frozen."""

    @staticmethod
    def forward(ctx, x, w8t, s):
        ctx.save_for_backward(w8t, s)
        return int8_matmul_nmajor(x, w8t, s)

    @staticmethod
    def backward(ctx, g):
        w8t, s = ctx.saved_tensors
        dx = (g.float() * s) @ w8t.float()
        return dx.to(g.dtype), None, None


def _int8_matmul_diffable(x, w8, s):
    return _Int8Matmul.apply(x, w8, s)


def _int8_matmul_nmajor_diffable(x, w8t, s):
    return _Int8MatmulNmajor.apply(x, w8t, s)
