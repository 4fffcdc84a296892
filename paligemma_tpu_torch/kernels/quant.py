"""Int8 weight-only quantization (port of the int8 part of
paligemma_tpu/kernels/quant.py).

Layout: weights (K, N) int8, scales (N,) fp32; per-output-channel symmetric
quantization, ``w ~= w8 * s[None, :]``. ``matmul_any`` is plain torch math,
as the reference left it to XLA; the decode-time int8 products run in the
hand-written GEMV (kernels/int8_gemv.py).
"""

from __future__ import annotations

from typing import Dict

import torch


def _quantize_int8_one(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    wf = w.float()
    absmax = wf.abs().amax(dim=-2, keepdim=True)  # (..., 1, N)
    scale = absmax.clamp(min=1e-8) / 127.0
    # contiguous: a transposed input (the tied head) would otherwise keep
    # its strides, and the GEMV kernels read row-major (K, N)
    w8 = torch.round(wf / scale).clamp(-127, 127).to(torch.int8).contiguous()
    return {"w8": w8, "s": scale[..., 0, :].contiguous()}


def quantize_int8(
    w: torch.Tensor, chunk_elems: int = 64 * 1024 * 1024
) -> Dict[str, torch.Tensor]:
    """(..., K, N) weights -> {"w8": int8, "s": fp32 per-N-channel scales}.

    Tensors above ``chunk_elems`` elements go in pieces so the fp32
    temporary stays bounded: stacked (L, K, N) one layer at a time, 2-D
    matrices in output-column blocks (per-channel scales make both exact).
    """
    big = w.numel() > chunk_elems
    if w.dim() == 3 and big:
        outs = [_quantize_int8_one(w[i]) for i in range(w.shape[0])]
        return {
            "w8": torch.stack([o["w8"] for o in outs]),
            "s": torch.stack([o["s"] for o in outs]),
        }
    if w.dim() == 2 and big:
        n = w.shape[1]
        step = max(128, (chunk_elems // max(w.shape[0], 1)) // 128 * 128)
        outs = [_quantize_int8_one(w[:, i : i + step]) for i in range(0, n, step)]
        return {
            "w8": torch.cat([o["w8"] for o in outs], dim=1),
            "s": torch.cat([o["s"] for o in outs], dim=0),
        }
    return _quantize_int8_one(w)


def dequantize(q: Dict[str, torch.Tensor], dtype=torch.float32) -> torch.Tensor:
    return (q["w8"].float() * q["s"][..., None, :]).to(dtype)


def _int8_matmul(x: torch.Tensor, w8: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``x @ dequant(w8, s)``: an fp32 dot (int8 and bf16 are exact in
    fp32), then the fp32 scale, then the activation dtype, as the
    reference's dot with ``preferred_element_type=float32`` does."""
    return ((x.float() @ w8.float()) * s).to(x.dtype)


def matmul_any(x: torch.Tensor, w) -> torch.Tensor:
    """Dispatch: int8 ``{"w8", "s"}`` leaf or dense ``x @ w``."""
    if isinstance(w, dict) and "w8" in w:
        return _int8_matmul(x, w["w8"], w["s"])
    return x @ w
