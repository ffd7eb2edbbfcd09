"""Sequence pooling over the user click history.

Pad steps (id == pad_id) are zeroed out of the sum and the divisor is the
clamped-at-1 count of real steps (the reference's model_fibinet.py:165-174).
"""

from __future__ import annotations

import torch


def masked_mean(
    seq_emb: torch.Tensor, seq_ids: torch.Tensor, pad_id: int = 0
) -> torch.Tensor:
    """seq_emb (B, S, E), seq_ids (B, S) -> (B, E), in seq_emb's dtype."""
    mask = (seq_ids != pad_id).to(seq_emb.dtype)  # (B, S)
    total = (seq_emb * mask[..., None]).sum(-2)
    count = mask.sum(-1, keepdim=True).clamp(min=1.0)
    return total / count


def masked_sum(
    seq_emb: torch.Tensor, seq_ids: torch.Tensor, pad_id: int = 0
) -> torch.Tensor:
    """seq_emb (B, S, E), seq_ids (B, S) -> (B, E), in seq_emb's dtype: the
    sum of masked_mean without the divisor."""
    mask = (seq_ids != pad_id).to(seq_emb.dtype)  # (B, S)
    return (seq_emb * mask[..., None]).sum(-2)


def masked_mean_t(
    seq_emb: torch.Tensor, seq_ids: torch.Tensor, pad_id: int = 0
) -> torch.Tensor:
    """Transposed-layout masked mean: seq_emb (S, B, E), seq_ids (S, B) ->
    (B, E), in seq_emb's dtype. The (S, B) layout is the one the trunk
    gathers in: the reduction runs over the leading axis."""
    mask = (seq_ids != pad_id).to(seq_emb.dtype)  # (S, B)
    total = (seq_emb * mask[..., None]).sum(0)
    count = mask.sum(0)[:, None].clamp(min=1.0)
    return total / count
