"""int8 weight-only GEMV for decode, with fused epilogues.

The weight streams of the TPU kernel paligemma_tpu/kernels/decode_layer.py
``_kernel_all`` (qkv, o-proj + residual, gate/up + GeGLU, down + residual)
and the int8 LM head of the logits path (models/gemma.lm_head) run through
``int8_gemv``; ``csrc/int8_gemv.cu`` is the kernel.

    out = cast(x @ w8 (fp32) * s)                      plain
    out = residual + cast(x @ w8 * s)                  residual=...
    out = cast(gelu_tanh(g) * u), [g | u] = x @ w8 * s geglu=True (N = 2I)
    out = x @ w8 (fp32) * s, kept in fp32               int8_gemv_f32

``int8_gemv_f32`` is the fp32-partial epilogue of the tensor-parallel decode
(the o-proj partial of paligemma_tpu/kernels/decode_layer_tp.py
``_attn_kernel`` and the down-proj partial of paligemma_tpu/kernels/
decode_mlp.py ``_kernel``): each rank's partial is summed across ranks in
fp32 and cast once, after the sum. It is a wrapper of its own so that its
launches are counted apart from the bf16 epilogues'.

The GeGLU epilogue works on the fp32 gate and up values, as the TPU kernel
does (its XLA path rounds both to the activation dtype first).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.activations import gelu_tanh
from . import _build

TILE_N = 128  # output columns per block (csrc/common.cuh GV_TILE_N)
KC_MAX = 512  # max K rows per split (GV_KC_MAX)
TARGET_BLOCKS = 264  # ~2 blocks per SM on the H100's 132 SMs


def gemv_k_chunk(k: int, n: int) -> int:
    """K rows per split block. Shared with the LM-head argmax kernel, which
    must sum the same splits in the same order to match bit for bit."""
    col_blocks = -(-n // TILE_N)
    nsplit = max(-(-TARGET_BLOCKS // col_blocks), -(-k // KC_MAX))
    nsplit = min(nsplit, max(1, k // 8))
    chunk = -(-k // nsplit)
    return -(-chunk // 8) * 8


def int8_gemv_reference(
    x: torch.Tensor,  # (B, K)
    w8: torch.Tensor,  # (K, N) int8
    s: torch.Tensor,  # (N,) fp32
    residual: Optional[torch.Tensor] = None,  # (B, N)
    geglu: bool = False,
    out_fp32: bool = False,
) -> torch.Tensor:
    """Plain version of :func:`int8_gemv` (and, with ``out_fp32``, of
    :func:`int8_gemv_f32`)."""
    v = (x.float() @ w8.float()) * s.float()
    if out_fp32:
        return v
    if geglu:
        inter = v.shape[-1] // 2
        return (gelu_tanh(v[:, :inter]) * v[:, inter:]).to(x.dtype)
    out = v.to(x.dtype)
    if residual is not None:
        out = residual + out
    return out


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"int8_gemv: {msg}")


def _launch(x, w8, s, residual, mode: int) -> torch.Tensor:
    """Both kernels of one GEMV (K-split partials, then the epilogue of
    ``mode``: 0 plain, 1 + residual, 2 GeGLU, 3 fp32 out)."""
    b, k = x.shape
    n = w8.shape[-1]
    dev = x.device
    _check(x.dtype == torch.bfloat16 and x.is_contiguous(), "x must be contiguous bf16")
    _check(w8.dtype == torch.int8 and w8.shape == (k, n) and w8.is_contiguous(),
           f"w8 must be contiguous int8 ({k}, N), got {tuple(w8.shape)} {w8.dtype}")
    _check(w8.device == dev and s.device == dev, "all operands on one device")
    _check(n % 4 == 0 and w8.data_ptr() % 4 == 0, "N % 4 == 0 and 4-byte aligned w8")
    _check(s.dtype == torch.float32 and s.shape == (n,) and s.is_contiguous(),
           "s must be contiguous fp32 (N,)")
    if mode == 2:
        _check(n % 2 == 0, "geglu takes an even N")
    if mode == 1:
        _check(residual.dtype == torch.bfloat16 and residual.shape == (b, n)
               and residual.is_contiguous() and residual.device == dev,
               "residual must be contiguous bf16 (B, N)")
    chunk = gemv_k_chunk(k, n)
    nsplit = -(-k // chunk)
    part = torch.empty((nsplit, b, n), dtype=torch.float32, device=dev)
    out = torch.empty((b, n // 2 if mode == 2 else n),
                      dtype=torch.float32 if mode == 3 else torch.bfloat16, device=dev)
    lib = _build.library()
    stream = _build.stream_ptr(dev)
    _build.check(lib.pg_int8_gemv_partial(
        x.data_ptr(), w8.data_ptr(), part.data_ptr(), b, k, n, chunk, stream,
    ), "int8_gemv partial")
    _build.check(lib.pg_int8_gemv_epilogue(
        part.data_ptr(), nsplit, b, n, s.data_ptr(),
        residual.data_ptr() if mode == 1 else None, out.data_ptr(), mode, stream,
    ), "int8_gemv epilogue")
    return out


def int8_gemv(
    x: torch.Tensor,
    w8: torch.Tensor,
    s: torch.Tensor,
    residual: Optional[torch.Tensor] = None,
    geglu: bool = False,
) -> torch.Tensor:
    """``x (B, K)`` times an int8 ``(K, N)`` weight with per-column scales."""
    if not x.is_cuda:
        return int8_gemv_reference(x, w8, s, residual, geglu)
    _check(not (geglu and residual is not None), "geglu takes no residual")
    out = _launch(x, w8, s, residual, 2 if geglu else (1 if residual is not None else 0))
    int8_gemv.launches += 1
    return out


int8_gemv.launches = 0


def int8_gemv_f32(x: torch.Tensor, w8: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The fp32 partial ``x (B, K) @ w8 * s`` of one tensor-parallel rank:
    (B, N) fp32, no cast and no residual."""
    if not x.is_cuda:
        return int8_gemv_reference(x, w8, s, out_fp32=True)
    out = _launch(x, w8, s, None, 3)
    int8_gemv_f32.launches += 1
    return out


int8_gemv_f32.launches = 0
