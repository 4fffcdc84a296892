"""Token sampling (port of paligemma_tpu/ops/sampling.py).

greedy: ``argmax`` with ties to the first index. sampled: softmax at a
temperature, top-p with the shift-by-one cumulative mask, renormalize, then
a Gumbel-max draw over the kept log-probabilities. The Gumbel noise comes
from an explicit ``torch.Generator``, or is passed in as ``noise`` so a test
can feed both frameworks the same draws (torch cannot reproduce JAX's PRNG).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

PerRow = Union[float, torch.Tensor]  # one value, or (B,) per row


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Argmax next token. ``logits``: (B, vocab) -> (B,) int32.

    ``torch.argmax`` returns the first maximal index, like ``jnp.argmax``."""
    return logits.float().argmax(dim=-1).to(torch.int32)


def _per_row(x: PerRow, ref: torch.Tensor) -> PerRow:
    """A (B,) value as a (B, 1) fp32 column beside ``ref`` (B, vocab)."""
    if torch.is_tensor(x):
        return x.to(device=ref.device, dtype=torch.float32).reshape(-1, 1)
    return x


def top_p_mask_probs(probs_sorted: torch.Tensor, p: PerRow) -> torch.Tensor:
    """Zero out tokens outside the top-p nucleus (descending-sorted probs);
    keeps the first token whose inclusion crosses ``p`` (a float, or (B,)
    per row)."""
    cumsum = probs_sorted.cumsum(dim=-1)
    mask = (cumsum - probs_sorted) > _per_row(p, probs_sorted)
    return torch.where(mask, torch.zeros_like(probs_sorted), probs_sorted)


def gumbel_noise(
    shape, generator: Optional[torch.Generator], device: torch.device
) -> torch.Tensor:
    """Standard Gumbel draws ``-log(-log(u))`` from ``generator``."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp(min=tiny)))


def sample_top_p(
    generator: Optional[torch.Generator],
    logits: torch.Tensor,  # (B, vocab)
    temperature: PerRow,
    top_p: PerRow,
    *,
    noise: Optional[torch.Tensor] = None,  # (B, vocab) Gumbel draws
) -> torch.Tensor:
    """Temperature + top-p sample. Returns (B,) int32 token ids.
    ``temperature`` and ``top_p`` are floats, or (B,) tensors applied per row
    (the serving tick's per-request settings)."""
    probs = torch.softmax(logits.float() / _per_row(temperature, logits), dim=-1)
    # stable descending sort: equal probabilities keep index order, like
    # jnp.argsort(-probs)
    probs_sorted, sort_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    kept = top_p_mask_probs(probs_sorted, top_p)
    kept = kept / kept.sum(dim=-1, keepdim=True)
    log_kept = torch.log(torch.where(kept > 0, kept, torch.full_like(kept, 1e-38)))
    log_kept = torch.where(kept > 0, log_kept, torch.full_like(kept, -float("inf")))
    if noise is None:
        noise = gumbel_noise(kept.shape, generator, kept.device)
    choice = (log_kept + noise).argmax(dim=-1)  # index into sorted order
    return sort_idx.gather(-1, choice[:, None])[:, 0].to(torch.int32)


def sample(
    generator: Optional[torch.Generator],
    logits: torch.Tensor,
    temperature: PerRow = 0.8,
    top_p: PerRow = 0.9,
    do_sample: bool = False,
    *,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dispatch matching the reference CLI defaults."""
    if do_sample:
        return sample_top_p(generator, logits, temperature, top_p, noise=noise)
    return greedy(logits)
