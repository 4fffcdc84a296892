"""Plain attention (port of paligemma_tpu/ops/attention.py).

Matmuls run in fp32 on upcast bf16 inputs, which is what JAX's
``preferred_element_type=float32`` einsum computes; softmax is fp32. GQA
reshapes queries to (B, S, n_kv, group, d) and contracts against the raw KV
heads, so repeated KV heads are never materialized.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.3819763e38  # minimum bf16-representable; used for masking


def mha(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, H, D)
    v: torch.Tensor,  # (B, Sk, H, D)
    mask: Optional[torch.Tensor] = None,  # (B, 1|H, Sq, Sk) additive
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain multi-head attention (SigLIP tower; non-causal)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits + mask.float()
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def gqa(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, D)
    mask: Optional[torch.Tensor] = None,  # (B, 1, Sq, Sk) additive
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Grouped-query attention with native head grouping (no repeat_kv)."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    if scale is None:
        scale = d**-0.5
    qg = q.reshape(b, sq, hkv, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    if mask is not None:
        logits = logits + mask.float()[:, :, None, :, :]
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum(
        "bhgqk,bkhd->bqhgd", weights.to(v.dtype).float(), v.float()
    )
    return out.reshape(b, sq, hq, d).to(v.dtype)


def make_additive_mask(
    valid: torch.Tensor, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """(B, Sq, Sk) bool "may attend" -> (B, 1, Sq, Sk) additive mask."""
    zero = torch.zeros((), dtype=torch.float32, device=valid.device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=valid.device)
    return torch.where(valid[:, None, :, :], zero, neg).to(dtype)
