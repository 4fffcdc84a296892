"""Int8 weight-only and W8A8 matmuls, and blockwise 4-bit quantization
(port of paligemma_tpu/kernels/quant.py).

int8 layout: weights (K, N) int8, scales (N,) fp32; per-output-channel
symmetric quantization, ``w ~= w8 * s[None, :]``. 4-bit layout (the
training-side QLoRA base, NF4 or symmetric int4) for (..., K, N) weights:

* ``"w4"``: (..., K/2, N) uint8, byte i holds rows ``2i | (2i+1) << 4``;
* ``"s4"``: (..., K/group, N) fp32 absmax per block of ``group`` rows;
* ``"grid"``: (16,) fp32 codebook, or (L, 16) when stacked over layers.

``matmul_any`` dispatches as the reference's does. Weight-only int8 and
4-bit products are plain torch math, as the reference left them to XLA
(the decode-time int8 products run in the hand-written GEMV,
kernels/int8_gemv.py). With ``int8_act`` (a W8A8 prefill, the single-copy
serving of runtime/engine ``int8_act_prefill``) an int8 product of at least
``W8A8_MIN_ROWS`` rows quantizes each row of x to int8 and takes an exact
int32 dot: on the card kernels/w8a8 (K1 + K2), on the CPU
:func:`_w8a8_matmul`; below the gate it stays weight-only, on the card
through the int8 GEMV tile, so no fp32 copy of the weight is made.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from . import w8a8
from .int8_gemv import int8_gemv

# rows of x at least, in x.shape[:-1], for a W8A8 product under int8_act
# (the reference's gate: decode-sized calls keep the weight-only path)
W8A8_MIN_ROWS = 256


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


def _w8a8_matmul(x: torch.Tensor, w8: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """W8A8, the plain version of the reference's ``_xla_w8a8_matmul``:
    ``a_s = max(amax_row |x|, 1e-8) / 127``, ``x8 = clip(round(x / a_s),
    -127, 127)`` (round half to even), the exact integer dot, then
    ``(float32(dot) * a_s) * s`` cast to x's dtype."""
    k = x.shape[-1]
    x8, a_s = w8a8.quant_rows_reference(x.reshape(-1, k))
    out = w8a8.gemm_reference(x8, w8, a_s, s, out_dtype=x.dtype)
    return out.reshape(*x.shape[:-1], w8.shape[-1])


def int8_matmul_card(x: torch.Tensor, w8: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``x (..., K) @ dequant(w8, s)``, weight-only, with no dequantized copy
    of the weight: on the card the int8 GEMV tile (kernels/int8_gemv, any
    row count, one launch); on the CPU :func:`_int8_matmul`."""
    if not x.is_cuda:
        return _int8_matmul(x, w8, s)
    k = x.shape[-1]
    out = int8_gemv(x.reshape(-1, k).contiguous(), w8, s)
    return out.reshape(*x.shape[:-1], w8.shape[-1])


def w8a8_rows(x: torch.Tensor) -> bool:
    """Whether an int8 product over x takes W8A8 under ``int8_act``: at
    least ``W8A8_MIN_ROWS`` rows in ``x.shape[:-1]``, the reference's gate."""
    return math.prod(x.shape[:-1]) >= W8A8_MIN_ROWS


def matmul_any(x: torch.Tensor, w, int8_act: bool = False) -> torch.Tensor:
    """Dispatch: int8 ``{"w8", "s"}``, 4-bit ``{"w4", "s4", "grid"}`` or
    dense ``x @ w``. Differentiable in ``x`` (quantized bases are frozen).

    ``int8_act`` (W8A8 prefill): an int8 product of at least
    ``W8A8_MIN_ROWS`` rows quantizes x's rows to int8 (kernels/w8a8 on the
    card, :func:`_w8a8_matmul` on the CPU); a smaller one stays weight-only
    (:func:`int8_matmul_card`), as in the reference, where decode-sized
    calls keep the convert path."""
    if isinstance(w, dict) and "w8" in w:
        if int8_act:
            if not w8a8_rows(x):
                return int8_matmul_card(x, w["w8"], w["s"])
            if x.is_cuda:
                return w8a8.w8a8_matmul(x, w["w8"], w["s"])
            return _w8a8_matmul(x, w["w8"], w["s"])
        return _int8_matmul(x, w["w8"], w["s"])
    if isinstance(w, dict) and "w4" in w:
        return x @ dequantize_4bit(w, x.dtype)
    return x @ w


# QLoRA NF4 grid (Dettmers et al. 2023; bitsandbytes' "nf4" codebook)
NF4_GRID = (
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
)
# symmetric int4: [-7..7]/7 padded to 16 entries (index 15 duplicates +1.0;
# the nearest-midpoint search never emits it)
INT4_GRID = tuple(i / 7.0 for i in range(-7, 8)) + (1.0,)


def _quantize_4bit_one(w: torch.Tensor, grid: torch.Tensor, group: int):
    wf = w.float()
    k, n = wf.shape[-2], wf.shape[-1]
    lead = tuple(wf.shape[:-2])
    g = wf.reshape(lead + (k // group, group, n))
    scale = g.abs().amax(dim=-2).clamp(min=1e-8)  # (..., K/g, N)
    x = g / scale[..., None, :]
    mids = (grid[1:] + grid[:-1]) / 2.0
    idx = torch.searchsorted(mids, x.contiguous()).to(torch.uint8).reshape(lead + (k, n))
    packed = idx[..., 0::2, :] | (idx[..., 1::2, :] << 4)
    return {"w4": packed.contiguous(), "s4": scale, "grid": grid}


def quantize_4bit(
    w: torch.Tensor, kind: str = "nf4", group: int = 64,
    chunk_elems: int = 64 * 1024 * 1024,
) -> Dict[str, torch.Tensor]:
    """(..., K, N) weights -> blockwise 4-bit dict (layout above). ``kind``:
    "nf4" or "int4". Stacked (L, K, N) tensors above ``chunk_elems``
    elements go one layer at a time (bounded fp32 temporaries)."""
    grids = {"nf4": NF4_GRID, "int4": INT4_GRID}
    if kind not in grids:
        raise ValueError(f"unknown 4-bit kind {kind!r} (nf4|int4)")
    grid = torch.tensor(grids[kind], dtype=torch.float32, device=w.device)
    if w.shape[-2] % group or w.shape[-2] % 2:
        raise ValueError(f"K={w.shape[-2]} must divide group={group} and be even")
    if w.dim() == 3 and w.numel() > chunk_elems:
        outs = [_quantize_4bit_one(w[i], grid, group) for i in range(w.shape[0])]
        return {"w4": torch.stack([o["w4"] for o in outs]),
                "s4": torch.stack([o["s4"] for o in outs]), "grid": grid}
    return _quantize_4bit_one(w, grid, group)


def dequantize_4bit(q: Dict[str, torch.Tensor], dtype=torch.float32) -> torch.Tensor:
    packed, scale, grid = q["w4"], q["s4"], q["grid"]
    grid = grid.reshape(-1, 16)[0]  # a stacked (L, 16) grid repeats one codebook
    lead = tuple(packed.shape[:-2])
    k, n = 2 * packed.shape[-2], packed.shape[-1]
    group = k // scale.shape[-2]
    idx = torch.stack([packed & 0xF, packed >> 4], dim=-2).reshape(lead + (k, n))
    vals = grid[idx.long()].reshape(lead + (k // group, group, n))
    return (vals * scale[..., None, :].float()).reshape(lead + (k, n)).to(dtype)
