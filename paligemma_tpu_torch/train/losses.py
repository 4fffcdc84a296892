"""Training losses (port of paligemma_tpu/train/losses.py).

Causal-LM cross entropy with ``ignore_index=-100`` (HF label convention):
logits[:, t] predict labels[:, t+1], mean over the non-ignored targets.

Over a data axis (``mesh`` with ``data > 1``) each rank holds its rows of
the global batch: it divides its token-loss sum by the global count of
targets (summed over the data group), so the ranks' losses add up to the
global mean, as JAX's loss over the sharded batch, and their gradients
are summed, not averaged (train/trainer).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..core import mesh as mesh_lib

IGNORE_INDEX = -100


def causal_lm_loss(
    logits: torch.Tensor,  # (B, S, V)
    labels: torch.Tensor,  # (B, S) int; ignore_index entries contribute 0
    ignore_index: int = IGNORE_INDEX,
    *,
    mesh: Optional[mesh_lib.Mesh] = None,
) -> torch.Tensor:
    """Next-token cross entropy in fp32, summed over the valid targets and
    divided by their count (at least 1, so an all-ignored batch gives 0).
    Under ``mesh`` the count is the whole batch's, over the data axis."""
    shift_logits = logits[:, :-1].float()
    shift_labels = labels[:, 1:].long()
    valid = shift_labels != ignore_index
    total = F.cross_entropy(shift_logits.reshape(-1, shift_logits.shape[-1]),
                            shift_labels.reshape(-1), ignore_index=ignore_index,
                            reduction="sum")
    count = mesh_lib.data_sum(valid.sum(), mesh)
    return total / count.clamp(min=1)
