"""Fused int8 LM head + argmax for greedy decode (port of
paligemma_tpu/kernels/decode_head.py); the kernel is ``csrc/decode_head.cu``.

``argmax(round_to_act_dtype(y @ w8 * s))`` over the vocab without writing
the logits: ties go to the first index, padded columns (``>= n_valid``)
never win, and the winning logit comes back beside the id. The kernel
computes each logit with the same GEMV tile as kernels/int8_gemv.py
(``csrc/gemv_tile.cuh``) over the :class:`~.gemv_plan.GemvPlan` of the
unpadded vocab, so its token equals ``argmax`` of the logits path's int8
head bit for bit.

fp32 y (``--dtype float32``) takes the kernel's fp32 form (the tile's
three-term split, logits not rounded), counted apart on
:func:`head_argmax_fp32`: its ids equal the argmax of the fp32 logits path's
GEMV (kernels/int8_gemv ``int8_gemv_fp32``) bit for bit.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import _build
from .gemv_plan import TILE_N, GemvPlan


def repack_head(head_q: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """{"w8": (K, V), "s": (V,)} -> the kernel's layout: the vocab padded
    with zero columns to a multiple of the 128-column tile ("w8_blk",
    "s_blk"). The original leaves stay for the logits path and as the true
    vocab width (``s.shape[0]``); with no padding they share storage."""
    w8, s = head_q["w8"], head_q["s"]
    v = w8.shape[1]
    v_pad = -(-v // TILE_N) * TILE_N
    w8_blk = w8.contiguous()
    s_blk = s.float().contiguous()
    if v_pad != v:
        w8_blk = torch.nn.functional.pad(w8_blk, (0, v_pad - v))
        s_blk = torch.nn.functional.pad(s_blk, (0, v_pad - v))
    return {"w8_blk": w8_blk, "s_blk": s_blk, "w8": w8, "s": s}


def reference_head_argmax(
    y: torch.Tensor, head_q: Dict[str, torch.Tensor], *, return_max: bool = False
):
    """Plain greedy head over the unpadded {"w8", "s"}: logits rounded to the
    activation dtype, then the first maximal index (models/gemma.lm_head +
    ops/sampling.greedy), and with ``return_max`` the winning logit."""
    y2 = y.reshape(-1, y.shape[-1])
    logits = ((y2.float() @ head_q["w8"].float()) * head_q["s"].float()).to(y.dtype)
    mx, ids = logits.float().max(dim=-1)  # first maximal index
    ids = ids.to(torch.int32)
    return (ids, mx) if return_max else ids


_workspaces: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _workspace(dev: torch.device, stream: int, b: int) -> torch.Tensor:
    """The kernel's B row keys and its counter (int64 each), zero: every
    call leaves them so. One per (device, stream), so that calls on two
    streams never share one; it grows with B."""
    ws = _workspaces.get((dev, stream))
    if ws is None or ws.numel() < b + 1:
        ws = _workspaces[(dev, stream)] = torch.zeros(b + 1, dtype=torch.int64, device=dev)
    return ws


def head_argmax_fused(
    y: torch.Tensor,  # (B, 1, K) or (B, K) final-norm output
    head_blk: Dict[str, torch.Tensor],  # repack_head() output
    *,
    return_max: bool = False,
):
    """Greedy token ids (B,) int32; with ``return_max`` also the winning
    logits (B,) fp32."""
    if not y.is_cuda:
        return reference_head_argmax(y, head_blk, return_max=return_max)
    k = y.shape[-1]
    y2 = y.reshape(-1, k)
    b = y2.shape[0]
    w8, s = head_blk["w8_blk"], head_blk["s_blk"]
    n = w8.shape[1]
    n_valid = head_blk["s"].shape[0]
    dev = y2.device
    if y2.dtype not in (torch.bfloat16, torch.float32) or not y2.is_contiguous():
        raise ValueError("head_argmax_fused: y must be contiguous bf16 or fp32")
    fp32 = y2.dtype == torch.float32
    if (w8.dtype != torch.int8 or w8.shape[0] != k or not w8.is_contiguous()
            or n % TILE_N or w8.device != dev or w8.data_ptr() % 4):
        raise ValueError("head_argmax_fused: w8_blk must be contiguous int8 (K, V_pad) from repack_head")
    if s.dtype != torch.float32 or s.shape != (n,) or not s.is_contiguous():
        raise ValueError("head_argmax_fused: s_blk must be contiguous fp32 (V_pad,)")
    # the K split of the logits path's int8_gemv over the unpadded head
    plan = GemvPlan.make(k, n_valid)
    stream = _build.stream_ptr(dev)
    ws = _workspace(dev, stream, b)
    ids = torch.empty((b,), dtype=torch.int32, device=dev)
    mx = torch.empty((b,), dtype=torch.float32, device=dev)
    lib = _build.library()
    err = (lib.pg_head_argmax_fp32 if fp32 else lib.pg_head_argmax)(
        y2.data_ptr(), w8.data_ptr(), s.data_ptr(), ws.data_ptr(), ids.data_ptr(), mx.data_ptr(),
        b, k, n, n_valid, plan.cluster, plan.warps, plan.k_per_cta, stream,
    )
    if err != 0:
        _workspaces.pop((dev, stream), None)  # a failed launch may leave it dirty
    _build.check(err, "head_argmax_fp32" if fp32 else "head_argmax")
    (head_argmax_fp32 if fp32 else head_argmax_fused).launches += 1
    return (ids, mx) if return_max else ids


head_argmax_fused.launches = 0


def head_argmax_fp32(y: torch.Tensor, head_blk: Dict[str, torch.Tensor], *,
                     return_max: bool = False):
    """:func:`head_argmax_fused` of fp32 y, on the kernel's fp32 form; the
    count of its launches (which :func:`head_argmax_fused` makes for fp32
    y)."""
    if y.dtype != torch.float32:
        raise ValueError(f"head_argmax_fp32: fp32 y, got {y.dtype}")
    return head_argmax_fused(y, head_blk, return_max=return_max)


head_argmax_fp32.launches = 0
