"""Evaluation metrics, computed on the tensors' device (the JAX package's
training/metrics.py:27-196).

* ``auc``: exact tie-aware Mann-Whitney rank AUC, weighted by a 0/1 mask,
  0.5 when only one class is present. Ranks and their sums are float64, so
  the value is exact to fp32 at any split size.
* ``binned_auc_update`` / ``binned_auc_finalize``: streaming histogram AUC.
* ``logloss``: weighted clipped binary cross-entropy, clip 1e-7 (the fp32-safe
  analogue of sklearn's 1e-15).
* ``group_auc_device`` / ``group_auc``: impression-weighted mean of the
  per-group tie-aware AUC over the groups that hold both classes.
"""

from __future__ import annotations

import numpy as np
import torch

from ctr_recommendation_tpu_torch.utils.device import resolve_device


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


def group_auc_device(
    labels: torch.Tensor, scores: torch.Tensor, group_codes: torch.Tensor
) -> torch.Tensor:
    """Group AUC on the tensors' device, with segment ops and no loop over
    groups. ``group_codes`` are int codes (any values; ``group_auc``
    factorizes arbitrary keys). Returns 0.5 when no group has both classes.

    A lexsort (stable argsort by score, then stable argsort by group) puts
    each group's rows together, scores ascending. A row's 1-based rank in its
    group is its position less the group's first position; equal scores in a
    group take the mean of their run's first and last rank; each group's
    Mann-Whitney U then reduces with ``index_add_``. Ranks and sums are
    float64, as in ``auc``."""
    n = labels.shape[0]
    dev = labels.device
    if n == 0:
        return torch.tensor(0.5, device=dev)
    f64 = torch.float64
    o1 = torch.argsort(scores.float(), stable=True)
    o2 = torch.argsort(group_codes[o1], stable=True)
    order = o1[o2]
    g = group_codes[order]
    lab = labels[order].to(f64)
    s = scores.float()[order]

    pos = torch.arange(n, dtype=f64, device=dev)
    grp_start = torch.ones(n, dtype=torch.bool, device=dev)
    grp_start[1:] = g[1:] != g[:-1]
    seg = torch.cumsum(grp_start.long(), 0) - 1  # dense group segment a row
    seg_first = torch.full((n,), float(n), dtype=f64, device=dev).scatter_reduce(
        0, seg, pos, "amin")
    rank = pos - seg_first[seg] + 1.0  # 1-based within the group

    run_start = grp_start.clone()
    run_start[1:] |= s[1:] != s[:-1]
    run = torch.cumsum(run_start.long(), 0) - 1  # equal-score runs in a group
    run_lo = torch.full((n,), float(n + 1), dtype=f64, device=dev).scatter_reduce(
        0, run, rank, "amin")
    run_hi = torch.zeros(n, dtype=f64, device=dev).scatter_reduce(0, run, rank, "amax")
    avg_rank = 0.5 * (run_lo + run_hi)[run]  # ties averaged

    n_tot = torch.zeros(n, dtype=f64, device=dev).index_add_(0, seg, torch.ones_like(lab))
    n_pos = torch.zeros(n, dtype=f64, device=dev).index_add_(0, seg, lab)
    n_neg = n_tot - n_pos
    u = torch.zeros(n, dtype=f64, device=dev).index_add_(0, seg, avg_rank * lab)
    u = u - n_pos * (n_pos + 1.0) / 2.0
    valid = (n_pos > 0) & (n_neg > 0)
    auc_g = torch.where(valid, u / (n_pos * n_neg).clamp(min=1.0), 0.0)
    num = torch.where(valid, n_tot * auc_g, 0.0).sum()
    den = torch.where(valid, n_tot, 0.0).sum()
    return torch.where(den > 0, num / den.clamp(min=1.0), 0.5).float()


def group_auc(labels, scores, groups, *, device: str | torch.device = "cuda") -> float:
    """Group AUC over arbitrary group keys: the keys are factorized on the
    host (``np.unique``'s inverse), the rest runs on ``device`` through
    ``group_auc_device``."""
    groups = np.asarray(groups)
    if groups.size == 0:
        return 0.5
    dev = resolve_device(device)
    _, codes = np.unique(groups, return_inverse=True)
    return float(group_auc_device(
        torch.as_tensor(np.asarray(labels, np.float32).ravel(), device=dev),
        torch.as_tensor(np.asarray(scores, np.float32).ravel(), device=dev),
        torch.as_tensor(codes.ravel().astype(np.int64), device=dev),
    ))


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
