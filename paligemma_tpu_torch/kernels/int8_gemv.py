"""int8 weight-only GEMV for decode, with fused epilogues.

The weight streams of the TPU kernel paligemma_tpu/kernels/decode_layer.py
``_kernel_all`` (qkv, o-proj + residual, gate/up + GeGLU, down + residual)
and the int8 LM head of the logits path (models/gemma.lm_head) run through
``int8_gemv``; ``csrc/int8_gemv.cu`` is the kernel: one launch per GEMV,
the product on the tensor cores, K split over a thread-block cluster as
:class:`~.gemv_plan.GemvPlan` says, the epilogue in the same launch.

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

``lora=(z, b, bounds)`` adds each row's LoRA delta in the epilogue (the
expand of the TPU kernel's in-kernel multi-LoRA, decode_layer.py
``_kernel_all`` with ``lora=True``): ``z (B, nz)`` is the row's masked
adapter basis from kernels/lora, ``b (G, N)`` the alpha-folded adapter rows
(fp32 or bf16, cast to the activation dtype), and ``bounds`` the output
columns where the next target's G-wide block of ``z`` starts ((q | k | v):
``(nq, nq + hd)``; (gate | up): ``(I,)``; o and down: ``()``). The delta
is cast and added after the residual (plain and residual modes) or added
in fp32 to the gate and up values before the GeGLU, as the TPU kernel adds
it, by the same launch (``pg_int8_gemv_lora``: each rank adds its columns'
deltas after the cluster's sum).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..ops.activations import gelu_tanh
from . import _build
from .gemv_plan import TILE_N, GemvPlan  # noqa: F401  (TILE_N: the head's padding)

LoraExpand = Tuple[torch.Tensor, torch.Tensor, Sequence[int]]  # (z, b, bounds)


def lora_expand_reference(z: torch.Tensor, b: torch.Tensor, bounds: Sequence[int],
                          dtype: torch.dtype) -> torch.Tensor:
    """(B, N) fp32 LoRA delta: the columns of target t, between its bounds,
    take z's t-th G-wide block times b cast to ``dtype``."""
    g = b.shape[0]
    edges = [0, *bounds, b.shape[1]]
    bq = b.to(dtype).float()
    return torch.cat([z[:, t * g:(t + 1) * g].float() @ bq[:, lo:hi]
                      for t, (lo, hi) in enumerate(zip(edges[:-1], edges[1:]))], dim=-1)


def int8_gemv_reference(
    x: torch.Tensor,  # (B, K)
    w8: torch.Tensor,  # (K, N) int8
    s: torch.Tensor,  # (N,) fp32
    residual: Optional[torch.Tensor] = None,  # (B, N)
    geglu: bool = False,
    out_fp32: bool = False,
    lora: Optional[LoraExpand] = None,
) -> torch.Tensor:
    """Plain version of :func:`int8_gemv` (and, with ``out_fp32``, of
    :func:`int8_gemv_f32`)."""
    v = (x.float() @ w8.float()) * s.float()
    if out_fp32:
        return v
    delta = None if lora is None else lora_expand_reference(*lora, x.dtype)
    if geglu:
        inter = v.shape[-1] // 2
        g, u = v[:, :inter], v[:, inter:]
        if delta is not None:
            g, u = g + delta[:, :inter], u + delta[:, inter:]
        return (gelu_tanh(g) * u).to(x.dtype)
    out = v.to(x.dtype)
    if residual is not None:
        out = residual + out
    if delta is not None:
        out = out + delta.to(x.dtype)
    return out


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"int8_gemv: {msg}")


def _check_lora(lora: LoraExpand, b: int, n: int, dev) -> Tuple[int, int, int]:
    """Validates the expand operands; returns (G, seg1, seg2)."""
    z, lb, bounds = lora
    g = lb.shape[0] if lb.dim() == 2 else 0
    _check(lb.dim() == 2 and lb.shape[1] == n and lb.is_contiguous() and lb.device == dev
           and lb.dtype in (torch.float32, torch.bfloat16) and g % 8 == 0
           and lb.data_ptr() % 4 == 0,
           f"lora b must be contiguous 4-byte aligned fp32 or bf16 (G, {n}) with G a multiple "
           f"of 8, got {tuple(lb.shape)} {lb.dtype}")
    _check(len(bounds) <= 2 and list(bounds) == sorted(bounds) and all(0 < c < n for c in bounds),
           f"lora bounds {tuple(bounds)} must be at most two sorted columns inside (0, {n})")
    _check(z.dtype == torch.bfloat16 and z.shape == (b, g * (len(bounds) + 1))
           and z.is_contiguous() and z.device == dev and z.data_ptr() % 16 == 0,
           f"lora z must be contiguous 16-byte aligned bf16 ({b}, {g * (len(bounds) + 1)})")
    segs = list(bounds) + [n] * (2 - len(bounds))
    return g, segs[0], segs[1]


def _launch(x, w8, s, residual, mode: int, lora: Optional[LoraExpand] = None) -> torch.Tensor:
    """One GEMV launch of ``mode`` (0 plain, 1 + residual, 2 GeGLU, 3 fp32
    out); with ``lora`` (modes 0-2) its epilogue adds the expand."""
    b, k = x.shape
    n = w8.shape[-1]
    dev = x.device
    _check(b > 0, "x has no rows")
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
    if lora is not None:
        g, seg1, seg2 = _check_lora(lora, b, n, dev)
    plan = GemvPlan.make(k, n)
    out = torch.empty((b, n // 2 if mode == 2 else n),
                      dtype=torch.float32 if mode == 3 else torch.bfloat16, device=dev)
    lib = _build.library()
    stream = _build.stream_ptr(dev)
    args = (x.data_ptr(), w8.data_ptr(), s.data_ptr(),
            residual.data_ptr() if mode == 1 else None, out.data_ptr(), b, k, n, mode,
            plan.cluster, plan.warps, plan.k_per_cta)
    if lora is None:
        _build.check(lib.pg_int8_gemv(*args, stream), "int8_gemv")
        return out
    z, lb, _ = lora
    _build.check(lib.pg_int8_gemv_lora(
        *args, z.data_ptr(), lb.data_ptr(), int(lb.dtype == torch.float32), g, z.shape[1], seg1,
        seg2, stream), "int8_gemv LoRA")
    return out


def int8_gemv(
    x: torch.Tensor,
    w8: torch.Tensor,
    s: torch.Tensor,
    residual: Optional[torch.Tensor] = None,
    geglu: bool = False,
    lora: Optional[LoraExpand] = None,
) -> torch.Tensor:
    """``x (B, K)`` times an int8 ``(K, N)`` weight with per-column scales
    (``lora``: plus each row's adapter delta, module docstring)."""
    if not x.is_cuda:
        return int8_gemv_reference(x, w8, s, residual, geglu, lora=lora)
    _check(not (geglu and residual is not None), "geglu takes no residual")
    out = _launch(x, w8, s, residual, 2 if geglu else (1 if residual is not None else 0), lora)
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
