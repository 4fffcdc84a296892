"""Activations (port of paligemma_tpu/ops/activations.py)."""

from __future__ import annotations

import math

import torch

_GELU_C = float(torch.tensor(math.sqrt(2.0 / math.pi), dtype=torch.float32))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """GELU with the tanh approximation, computed in fp32."""
    xf = x.float()
    out = 0.5 * xf * (1.0 + torch.tanh(_GELU_C * (xf + 0.044715 * xf**3)))
    return out.to(x.dtype)
