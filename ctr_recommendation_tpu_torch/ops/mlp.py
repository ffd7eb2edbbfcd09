"""DNN tower: Linear -> BatchNorm -> ReLU -> Dropout stacks + final logit.

BatchNorm follows torch semantics (momentum 0.1, eps 1e-5, biased variance
for normalization, unbiased for the running stat). In train mode its
statistics are fp32 even in a bf16 tower and leave out zero-weight rows
(``nn.BatchNorm1d`` cannot mask); dropout draws from an explicit generator.
``fold_batch_norm`` turns the eval tower into plain affine layers, which the
fused scoring kernel consumes.

Within a data-parallel step (``parallel/data_parallel.py``: ``current()`` is
a rank's slice of the global batch) the train-mode statistics run over the
global batch, all-reduced and differentiable, and dropout keeps the rank's
rows of the global batch's mask: each rank computes its rows of what one
process computes over the whole batch.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ctr_recommendation_tpu_torch.ops.cuda import tower
from ctr_recommendation_tpu_torch.ops.initializers import linear_apply, linear_init
from ctr_recommendation_tpu_torch.parallel import data_parallel

BN_MOMENTUM = 0.1
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


def _stats(h32, weight):
    """(mean, biased var, unbiased var) in h32's dtype over the batch's weighted
    rows (every row without ``weight``; zero-weight rows left out): the
    weighted sums, then the squared deviations from their mean (two passes).
    Within a data-parallel step each pass's sums are all-reduced, so the
    statistics run over the global batch, as one process computes them."""
    s = data_parallel.current()

    def total(t):
        return t if s is None else data_parallel.all_reduce_sum(t, s.group)

    w = torch.ones_like(h32[:, :1]) if weight is None else weight.to(h32.dtype)[:, None]
    sums = total(torch.cat([(h32 * w).sum(0), w.sum().reshape(1)]))
    n_eff = torch.clamp(sums[-1], min=1.0)
    mean = sums[:-1] / n_eff
    var = total((w * (h32 - mean) ** 2).sum(0)) / n_eff
    return mean, var, var * (n_eff / torch.clamp(n_eff - 1.0, min=1.0))


def _batch_norm(layer, st, h, train: bool, weight=None):
    if train:
        # statistics in fp32 at least (stable even when the tower runs bf16)
        mean, var, unbiased = _stats(h.to(torch.promote_types(h.dtype, torch.float32)), weight)
        new_st = {
            "bn_mean": (1 - BN_MOMENTUM) * st["bn_mean"] + BN_MOMENTUM * mean.detach(),
            "bn_var": (1 - BN_MOMENTUM) * st["bn_var"] + BN_MOMENTUM * unbiased.detach(),
        }
    else:
        mean, var = st["bn_mean"], st["bn_var"]
        new_st = st
    inv = torch.rsqrt(var.to(h.dtype) + BN_EPS)
    h = (h - mean.to(h.dtype)) * inv
    return h * layer["bn_scale"].to(h.dtype) + layer["bn_bias"].to(h.dtype), new_st


def _uniforms(h: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """The dropout's uniforms for h, one an element from ``generator``; in a
    data-parallel step the draw covers the global batch and h takes its
    slice's rows of it."""
    s = data_parallel.current()
    if s is None:
        return torch.rand(h.shape, generator=generator, device=h.device)
    if h.shape[0] != s.rows:
        raise ValueError(f"dropout on {h.shape[0]} rows in a step of {s.rows} a rank")
    return torch.rand((s.global_rows, *h.shape[1:]), generator=generator,
                      device=h.device)[s.row0 : s.row0 + s.rows]


def dropout(h: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout: each element kept with probability 1 - rate (one
    uniform draw from ``generator`` an element, ``_uniforms``) and divided
    by it."""
    keep = 1.0 - rate
    return torch.where(_uniforms(h, generator) < keep, h / keep, 0.0)


def on_kernels(x: torch.Tensor, train: bool) -> bool:
    """Whether ``apply`` runs x's layers on the tower kernels
    (``ops/cuda/tower.py``): train mode on a card, in bf16 or fp32."""
    return train and x.is_cuda and x.dtype in (torch.bfloat16, torch.float32)


def _kernel_layer(layer, st, x, dropout_rate, generator, weight):
    """One train-mode layer on the tower kernels: the GEMM on cuBLAS, then
    the bias, BatchNorm (with a ``bn_scale``), ReLU and dropout on
    ``tower.TowerLayer``, the same function as the composition in
    ``apply``, with fp32 inside."""
    lin = layer["linear"]
    y = x @ lin["w"].to(x.dtype)
    u = _uniforms(y, generator) if dropout_rate > 0.0 else None
    s = data_parallel.current()
    bn = "bn_scale" in layer
    out, running = tower.TowerLayer.apply(
        y, lin.get("b"), layer.get("bn_scale"), layer.get("bn_bias"), u,
        None if weight is None else weight.float(), st.get("bn_mean"), st.get("bn_var"),
        1.0 - dropout_rate, None if s is None else s.group)
    return out, ({"bn_mean": running[0], "bn_var": running[1]} if bn else st)


def apply(
    params: dict,
    state: dict,
    x: torch.Tensor,
    *,
    train: bool = False,
    dropout_rate: float = 0.0,
    generator: torch.Generator | None = None,
    weight: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict]:
    """x (B, in_dim) -> (logits (B, out_dim) in x's dtype, new_state).

    ``weight``: optional (B,) 0/1 row mask; zero-weight rows are left out of
    the train-mode BatchNorm statistics. Dropout (train mode) draws its masks
    from ``generator``, which must live on x's device. In train mode on a
    card (``on_kernels``) each hidden layer after its GEMM runs on the tower
    kernels, both ways, with fp32 inside; elsewhere on the composition
    below."""
    if train and dropout_rate > 0.0 and generator is None and params["layers"]:
        raise ValueError("dropout needs a generator in train mode")
    h = x
    new_layers = []
    for layer, st in zip(params["layers"], state["layers"]):
        if on_kernels(h, train):
            h, st = _kernel_layer(layer, st, h, dropout_rate, generator, weight)
            new_layers.append(st)
            continue
        h = linear_apply(layer["linear"], h)
        if "bn_scale" in layer:
            h, st = _batch_norm(layer, st, h, train, weight)
        h = torch.relu(h)
        if train and dropout_rate > 0.0:
            h = dropout(h, dropout_rate, generator)
        new_layers.append(st)
    out = linear_apply(params["out"], h) if "out" in params else h
    return out, {"layers": new_layers}


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
