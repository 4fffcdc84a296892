"""Training losses (port of paligemma_tpu/train/losses.py).

Causal-LM cross entropy with ``ignore_index=-100`` (HF label convention):
logits[:, t] predict labels[:, t+1], mean over the non-ignored targets.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

IGNORE_INDEX = -100


def causal_lm_loss(
    logits: torch.Tensor,  # (B, S, V)
    labels: torch.Tensor,  # (B, S) int; ignore_index entries contribute 0
    ignore_index: int = IGNORE_INDEX,
) -> torch.Tensor:
    """Next-token cross entropy in fp32, summed over the valid targets and
    divided by their count (at least 1, so an all-ignored batch gives 0)."""
    shift_logits = logits[:, :-1].float()
    shift_labels = labels[:, 1:].long()
    valid = shift_labels != ignore_index
    total = F.cross_entropy(shift_logits.reshape(-1, shift_logits.shape[-1]),
                            shift_labels.reshape(-1), ignore_index=ignore_index,
                            reduction="sum")
    return total / valid.sum().clamp(min=1)
