"""Normalization ops (port of paligemma_tpu/ops/norms.py).

Gemma RMSNorm: fp32 compute, ``x * rsqrt(mean(x^2) + eps) * (1 + w)`` with
zero-initialized weight, cast back to the input dtype.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Gemma RMSNorm: fp32 ``x * rsqrt(mean(x^2)+eps) * (1+w)``."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + weight.float())
    return out.to(x.dtype)


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """Standard LayerNorm in fp32 (SigLIP towers)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return out.to(x.dtype)
