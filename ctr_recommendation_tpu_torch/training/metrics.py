"""Evaluation metrics, computed on the tensors' device (the JAX package's
training/metrics.py:27-102, 187-196).

* ``auc``: exact tie-aware Mann-Whitney rank AUC, weighted by a 0/1 mask,
  0.5 when only one class is present. Ranks and their sums are float64, so
  the value is exact to fp32 at any split size.
* ``binned_auc_update`` / ``binned_auc_finalize``: streaming histogram AUC.
* ``logloss``: weighted clipped binary cross-entropy, clip 1e-7 (the fp32-safe
  analogue of sklearn's 1e-15).

Group AUC is not ported yet.
"""

from __future__ import annotations

import torch


def auc(
    labels: torch.Tensor, scores: torch.Tensor, weight: torch.Tensor | None = None
) -> torch.Tensor:
    """Exact ROC AUC with average ranks for ties (weights must be 0/1)."""
    labels = labels.double()
    scores = scores.float()
    n = labels.shape[0]
    weight = torch.ones_like(labels) if weight is None else weight.double()
    # masked-out entries take the lowest ranks and zero weight
    s = torch.where(weight > 0, scores, torch.finfo(torch.float32).min)
    order = torch.argsort(s, stable=True)
    sorted_s = s[order]
    new_group = torch.ones(n, dtype=torch.long, device=s.device)
    new_group[1:] = (sorted_s[1:] != sorted_s[:-1]).long()
    group = torch.cumsum(new_group, 0) - 1
    pos = torch.arange(1, n + 1, dtype=torch.float64, device=s.device)
    group_sum = torch.zeros(n, dtype=torch.float64, device=s.device).index_add_(0, group, pos)
    group_cnt = torch.zeros(n, dtype=torch.float64, device=s.device).index_add_(
        0, group, torch.ones_like(pos)
    )
    ranks = torch.empty_like(pos)
    ranks[order] = (group_sum / group_cnt.clamp(min=1.0))[group]
    w_pos = weight * labels
    w_neg = weight * (1.0 - labels)
    n_pos, n_neg = w_pos.sum(), w_neg.sum()
    # masked entries rank lowest: shift the positives' ranks down past them
    n_masked = (1.0 - weight).sum()
    u = (w_pos * (ranks - n_masked)).sum() - n_pos * (n_pos + 1.0) / 2.0
    denom = n_pos * n_neg
    return torch.where(denom > 0, u / denom.clamp(min=1.0), 0.5).float()


def binned_auc_update(
    hist_pos: torch.Tensor,
    hist_neg: torch.Tensor,
    labels: torch.Tensor,
    probs: torch.Tensor,
    weight: torch.Tensor | None = None,
    *,
    num_bins: int = 8192,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Accumulate score histograms for streaming AUC (probs in [0, 1])."""
    labels = labels.float()
    weight = torch.ones_like(labels) if weight is None else weight.float()
    bins = (probs.float() * num_bins).to(torch.int32).clamp(0, num_bins - 1).long()
    hist_pos = hist_pos.index_add(0, bins, weight * labels)
    hist_neg = hist_neg.index_add(0, bins, weight * (1.0 - labels))
    return hist_pos, hist_neg


def binned_auc_finalize(hist_pos: torch.Tensor, hist_neg: torch.Tensor) -> torch.Tensor:
    """AUC from score histograms (ties within a bin count one half)."""
    n_pos, n_neg = hist_pos.sum(), hist_neg.sum()
    cum_neg_below = torch.cumsum(hist_neg, 0) - hist_neg
    u = (hist_pos * (cum_neg_below + 0.5 * hist_neg)).sum()
    denom = n_pos * n_neg
    return torch.where(denom > 0, u / denom.clamp(min=1.0), 0.5)


def logloss(
    labels: torch.Tensor, probs: torch.Tensor, weight: torch.Tensor | None = None
) -> torch.Tensor:
    labels = labels.float()
    p = probs.float().clamp(1e-7, 1.0 - 1e-7)
    ll = -(labels * torch.log(p) + (1.0 - labels) * torch.log(1.0 - p))
    if weight is None:
        return ll.mean()
    w = weight.float()
    return (ll * w).sum() / w.sum().clamp(min=1.0)
