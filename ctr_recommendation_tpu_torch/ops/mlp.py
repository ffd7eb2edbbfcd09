"""DNN tower: Linear -> BatchNorm -> ReLU stacks + final logit, eval mode.

BatchNorm follows torch semantics (eps 1e-5) with frozen running stats; the
train-mode masked BatchNorm belongs to the training slice. ``fold_batch_norm``
turns the eval tower into plain affine layers, which the fused scoring
kernel consumes.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ctr_recommendation_tpu_torch.ops.initializers import linear_apply, linear_init

BN_EPS = 1e-5


def init(
    gen: torch.Generator,
    in_dim: int,
    hidden_units: Sequence[int],
    out_dim: int | None = 1,
    batch_norm: bool = True,
) -> tuple[dict, dict]:
    """Returns (params, state); state holds the BatchNorm running stats."""
    params: dict = {"layers": []}
    state: dict = {"layers": []}
    dims = [in_dim, *hidden_units]
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        layer = {"linear": linear_init(gen, d_in, d_out)}
        st = {}
        if batch_norm:
            layer["bn_scale"] = torch.ones(d_out)
            layer["bn_bias"] = torch.zeros(d_out)
            st = {"bn_mean": torch.zeros(d_out), "bn_var": torch.ones(d_out)}
        params["layers"].append(layer)
        state["layers"].append(st)
    if out_dim is not None:
        params["out"] = linear_init(gen, dims[-1], out_dim)
    return params, state


def _batch_norm_eval(layer, st, h):
    inv = torch.rsqrt(st["bn_var"].to(h.dtype) + BN_EPS)
    h = (h - st["bn_mean"].to(h.dtype)) * inv
    return h * layer["bn_scale"].to(h.dtype) + layer["bn_bias"].to(h.dtype)


def apply(params: dict, state: dict, x: torch.Tensor) -> torch.Tensor:
    """Eval forward: x (B, in_dim) -> logits (B, out_dim), in x's dtype."""
    h = x
    for layer, st in zip(params["layers"], state["layers"]):
        h = linear_apply(layer["linear"], h)
        if "bn_scale" in layer:
            h = _batch_norm_eval(layer, st, h)
        h = torch.relu(h)
    return linear_apply(params["out"], h) if "out" in params else h


def fold_batch_norm(params: dict, state: dict) -> dict:
    """Fold frozen BatchNorm stats into the preceding Linear for inference.

    y = gamma * (xW + b - mean) / sqrt(var + eps) + beta
      = x (W * g) + ((b - mean) * g + beta),  g = gamma / sqrt(var + eps)
    """
    folded = {"layers": []}
    if "out" in params:
        folded["out"] = params["out"]
    for layer, st in zip(params["layers"], state["layers"]):
        lin = dict(layer["linear"])
        if "bn_scale" in layer:
            g = layer["bn_scale"] / torch.sqrt(st["bn_var"] + BN_EPS)
            lin["w"] = lin["w"] * g[None, :]
            lin["b"] = (lin.get("b", 0.0) - st["bn_mean"]) * g + layer["bn_bias"]
        folded["layers"].append({"linear": lin})
    return folded
