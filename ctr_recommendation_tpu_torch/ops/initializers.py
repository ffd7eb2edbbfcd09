"""Parameter initializers matching the reference's torch defaults.

Parameters are plain dicts of tensors in the JAX package's layout: a Linear
weight is stored (fan_in, fan_out), already transposed for ``x @ w``, so
weights move between the two packages without reshaping. Every draw takes
an explicit ``torch.Generator`` (CPU); callers move the result to their
device.
"""

from __future__ import annotations

import math

import torch


def embedding_init(
    gen: torch.Generator, vocab_size: int, dim: int, pad_id: int | None = None,
    std: float = 1.0,
) -> torch.Tensor:
    """torch nn.Embedding default: N(0, std); pad row zeroed."""
    table = std * torch.randn(vocab_size, dim, generator=gen)
    if pad_id is not None:
        table[pad_id] = 0.0
    return table


def xavier_normal(gen: torch.Generator, shape: tuple[int, ...]) -> torch.Tensor:
    """torch nn.init.xavier_normal_ for a 2-D (or stacked 3-D) weight."""
    fan_in, fan_out = shape[-2], shape[-1]
    std = math.sqrt(2.0 / (fan_in + fan_out))
    return std * torch.randn(*shape, generator=gen)


def _uniform(gen, shape, bound):
    return (torch.rand(*shape, generator=gen) * 2.0 - 1.0) * bound


def linear_init(
    gen: torch.Generator, fan_in: int, fan_out: int, use_bias: bool = True
) -> dict[str, torch.Tensor]:
    """torch nn.Linear default init, weight stored (fan_in, fan_out), values
    U(-1/sqrt(fan_in), +1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    params = {"w": _uniform(gen, (fan_in, fan_out), bound)}
    if use_bias:
        params["b"] = _uniform(gen, (fan_out,), bound)
    return params


def linear_apply(params: dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Matmul in the ACTIVATION's dtype: fp32 weights are cast to x.dtype."""
    y = x @ params["w"].to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    return y
