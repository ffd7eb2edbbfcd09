"""CrossNet v2 (DCNv2), the JAX package's ``ops/crossnet.py``:

    x_{l+1} = x_0 * (W_l x_l + b_l) + x_l

over the flattened field stack x_0 (B, F*E).
"""

from __future__ import annotations

import torch

from ctr_recommendation_tpu_torch.ops.initializers import linear_apply, linear_init


def init(gen: torch.Generator, dim: int, num_layers: int = 3) -> dict:
    return {"layers": [linear_init(gen, dim, dim) for _ in range(num_layers)]}


def apply(params: dict, x0: torch.Tensor) -> torch.Tensor:
    """x0 (B, D) -> crossed features (B, D) in x0's dtype."""
    x = x0
    for layer in params["layers"]:
        x = x0 * linear_apply(layer, x) + x
    return x
