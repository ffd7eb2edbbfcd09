"""SENet field-wise excitation (FiBiNET).

squeeze = mean over the embedding axis, excitation = Linear(F -> max(1, F//r))
+ ReLU + Linear(-> F) + Sigmoid, reweight = per-field scalar scale (the
reference's model_fibinet.py:5-35, biases kept).
"""

from __future__ import annotations

import torch

from ctr_recommendation_tpu_torch.ops.initializers import linear_apply, linear_init


def init(
    gen: torch.Generator, num_fields: int, reduction: int = 2, use_bias: bool = True
) -> dict:
    reduced = max(1, num_fields // reduction)
    return {
        "fc1": linear_init(gen, num_fields, reduced, use_bias=use_bias),
        "fc2": linear_init(gen, reduced, num_fields, use_bias=use_bias),
    }


def field_weights(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x (B, F, E) -> the per-field scales (B, F), in x's dtype."""
    z = x.mean(-1)  # squeeze
    a = torch.relu(linear_apply(params["fc1"], z))
    return torch.sigmoid(linear_apply(params["fc2"], a))


def apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B, F, E) -> reweighted (B, F, E)."""
    return x * field_weights(params, x)[..., None]
