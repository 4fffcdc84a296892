"""Rotary position embeddings (port of paligemma_tpu/ops/rope.py).

HF "half-split" rotation: ``rotate_half(x) = concat(-x[d/2:], x[:d/2])``.
Positions are 1-indexed (models/paligemma.prefill_position_ids); the tables
are computed once per step in fp32 and cast to the activation dtype.
"""

from __future__ import annotations

import torch


def rope_cos_sin(
    position_ids: torch.Tensor,  # (B, S) int
    head_dim: int,
    theta: float = 10000.0,
    dtype: torch.dtype = torch.float32,
):
    """cos/sin tables of shape (B, S, head_dim), ``concat(freqs, freqs)``."""
    exponent = (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=position_ids.device)
        / head_dim
    )
    inv_freq = 1.0 / (theta**exponent)  # (d/2,)
    freqs = position_ids.float()[..., None] * inv_freq  # (B, S, d/2)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(
    x: torch.Tensor,  # (B, S, H, d)
    cos: torch.Tensor,  # (B, S, d)
    sin: torch.Tensor,  # (B, S, d)
) -> torch.Tensor:
    """Rotate q or k: ``x*cos + rotate_half(x)*sin``."""
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    return x * cos + rotate_half(x) * sin
