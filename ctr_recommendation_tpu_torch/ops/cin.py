"""Compressed Interaction Network (xDeepFM), the JAX package's ``ops/cin.py``.

Layer k forms all interactions between the previous feature maps
X^{k-1} (B, H_{k-1}, E) and the base fields X^0 (B, F, E) along the
embedding axis and compresses them with a learned (H_k, H_{k-1}, F) filter:

    X^k[b, h, e] = sum_{i, j} W^k[h, i, j] * X^{k-1}[b, i, e] * X^0[b, j, e]

Each layer's maps are summed over E, and the concatenated sums (B, sum_k H_k)
feed the logit Linear. The last layer's maps are only ever summed over E, so
they are never built: with P[b, i, f] = sum_e X^{k-1}[b, i, e] X^0[b, f, e],

    sum_e X^k[b, h, e] = sum_{i, f} W^k[h, i, f] P[b, i, f].
"""

from __future__ import annotations

from typing import Sequence

import torch

from ctr_recommendation_tpu_torch.ops.initializers import linear_apply, linear_init


def init(gen: torch.Generator, num_fields: int, layer_units: Sequence[int]) -> dict:
    """Filters Glorot-uniform over their (H_{k-1} * F) fan-in; the logit
    head ``out`` starts at zero, so the model starts as its DNN alone."""
    params: dict = {"filters": []}
    h_prev = num_fields
    for h in layer_units:
        bound = (6.0 / (h_prev * num_fields + h)) ** 0.5
        params["filters"].append(
            torch.empty(h, h_prev, num_fields).uniform_(-bound, bound, generator=gen))
        h_prev = h
    params["out"] = {k: torch.zeros_like(v)
                     for k, v in linear_init(gen, sum(layer_units), 1).items()}
    return params


def apply(params: dict, x0: torch.Tensor) -> torch.Tensor:
    """x0 (B, F, E) -> the CIN logit (B, 1) in x0's dtype.

    A layer before the last: first the products X^{k-1}[b, i, e] X^0[b, j, e]
    (B, H_{k-1}, F, E), rounded to x0's dtype, then one product with the
    filter over the H_{k-1} * F pairs, in x0's dtype. The last layer: first
    P = X^{k-1} X^0^T (B, H_{k-1}, F), then P's rows times the filter over
    the same pairs, both in fp32, cast back to x0's dtype."""
    b, f, e = x0.shape
    x_prev = x0
    pooled = []
    filters = params["filters"]
    for k, w in enumerate(filters):
        h = w.shape[0]
        if k == len(filters) - 1:
            p = torch.bmm(x_prev.float(), x0.float().transpose(1, 2))  # (B, H_prev, F)
            pooled.append((p.reshape(b, -1) @ w.reshape(h, -1).t()).to(x0.dtype))
        else:
            z = (x_prev[:, :, None, :] * x0[:, None, :, :]).reshape(b, -1, e)
            x_prev = torch.matmul(w.reshape(h, -1).to(x0.dtype), z)  # (B, H, E)
            pooled.append(x_prev.sum(-1))
    return linear_apply(params["out"], torch.cat(pooled, dim=-1))
