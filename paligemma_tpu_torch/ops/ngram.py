"""n-gram draft proposal for speculative decoding (prompt lookup; port of
paligemma_tpu/ops/ngram.py).

The proposer suggests the tokens that followed the most recent earlier
occurrence of the row's trailing ``match_n``-gram. It runs on the
caller's device with static shapes and no host read, so that a window of
speculative cycles (runtime/engine ``generate_spec``, the serving engines'
spec windows) is enqueued without waiting for the card: shifted compares,
a masked max and a gather, microseconds beside a verify forward.
"""

from __future__ import annotations

import torch


def propose_ngram(
    history: torch.Tensor,  # (B, S) int token history buffer
    hist_len: torch.Tensor,  # (B,) int: tokens valid in [0, hist_len)
    match_n: int,  # n-gram length to match
    draft_k: int,  # tokens to propose
) -> torch.Tensor:
    """``draft_k`` proposed tokens per row, (B, draft_k) in history's dtype.

    The match is the most recent start ``p < hist_len - match_n`` with
    ``history[p : p + match_n]`` equal to the trailing ``match_n`` tokens.
    Continuation reads wrap by the match period ``q = hist_len - match_n -
    p``: index ``p + match_n + (i % q)``, so that a recent match (a short
    repetition loop) extrapolates its period instead of reading past the
    written history. A row with no match repeats its last token. Every
    gather reads below ``hist_len`` (clamped at 0)."""
    b, s = history.shape
    m, k = match_n, draft_k
    dev = history.device
    hist_len = hist_len.to(device=dev, dtype=torch.long)
    pos = torch.arange(s - m + 1, device=dev)  # candidate gram starts
    tail_idx = (hist_len[:, None] - m + torch.arange(m, device=dev)[None]).clamp(min=0)
    suffix = torch.gather(history, 1, tail_idx)
    match = torch.ones((b, s - m + 1), dtype=torch.bool, device=dev)
    for i in range(m):
        match &= history[:, i:s - m + 1 + i] == suffix[:, i:i + 1]
    # only grams that end before the suffix starts (no self-match)
    match &= pos[None, :] < (hist_len - m)[:, None]
    found = match.any(dim=1)
    p = torch.where(match, pos[None, :], torch.full_like(pos[None, :], -1)).amax(dim=1)
    q = (hist_len - m - p).clamp(min=1)
    i = torch.arange(k, device=dev)[None]
    cont_idx = (p[:, None] + m + i % q[:, None]).clamp(0, s - 1)
    draft = torch.gather(history, 1, cont_idx)
    last = torch.gather(history, 1, (hist_len - 1).clamp(min=0)[:, None])
    return torch.where(found[:, None], draft, last)
