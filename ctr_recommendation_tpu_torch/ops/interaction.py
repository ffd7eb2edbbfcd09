"""FiBiNET interaction block: SENet + bilinear + concat, with kernel dispatch.

``senet_bilinear_concat`` produces the DNN-tower input
``[SENet(X).flat | Bilinear(SENet(X)).flat]`` of width (F + F(F-1)/2) * E.
The reference path runs the ops one by one in x's dtype and differentiates
by plain autograd; the kernel path (ops/cuda/interaction.py) computes the
block in one pass with an fp32 output and differentiates through the
hand-written backward kernel (``FusedInteraction``), in train and eval.
"""

from __future__ import annotations

import torch

from ctr_recommendation_tpu_torch.ops import bilinear as bilinear_ops
from ctr_recommendation_tpu_torch.ops import senet as senet_ops


def senet_bilinear_concat_reference(
    senet_params: dict,
    bilinear_params: dict,
    x: torch.Tensor,
    *,
    bilinear_type: str = "all",
) -> torch.Tensor:
    """Plain reference. x (B, F, E) -> (B, (F + F(F-1)/2) * E) in x's dtype."""
    b = x.shape[0]
    s = senet_ops.apply(senet_params, x)
    p = bilinear_ops.apply(bilinear_params, s, bilinear_type)
    return torch.cat([s.reshape(b, -1), p.reshape(b, -1)], dim=-1)


def senet_bilinear_concat(
    senet_params: dict,
    bilinear_params: dict,
    x: torch.Tensor,
    *,
    bilinear_type: str = "all",
    use_kernel: bool = False,
) -> torch.Tensor:
    if use_kernel:
        from ctr_recommendation_tpu_torch.ops.cuda.interaction import (
            fused_senet_bilinear_concat,
        )

        return fused_senet_bilinear_concat(
            senet_params, bilinear_params, x, bilinear_type=bilinear_type
        )
    return senet_bilinear_concat_reference(
        senet_params, bilinear_params, x, bilinear_type=bilinear_type
    )
