"""Activations and the gated MLP (port of paligemma_tpu/ops/activations.py).

Both towers use tanh-approximated GELU. The Gemma MLP is GeGLU:
``down(gelu_tanh(gate(x)) * up(x))``.
"""

from __future__ import annotations

import math

import torch

_GELU_C = float(torch.tensor(math.sqrt(2.0 / math.pi), dtype=torch.float32))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """GELU with the tanh approximation, computed in fp32."""
    xf = x.float()
    out = 0.5 * xf * (1.0 + torch.tanh(_GELU_C * (xf + 0.044715 * xf**3)))
    return out.to(x.dtype)


def geglu(x: torch.Tensor, gate_w: torch.Tensor, up_w: torch.Tensor,
          down_w: torch.Tensor) -> torch.Tensor:
    """Gemma GeGLU MLP; weights (in, out), so ``x @ w``."""
    return (gelu_tanh(x @ gate_w) * (x @ up_w)) @ down_w
