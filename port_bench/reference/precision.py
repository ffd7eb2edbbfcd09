"""The control's precision: the reference computed, where the configuration
computes in bf16, in fp8 (e4m3) with one scale a tensor (its largest
magnitude onto fp8's largest finite value, 448), as fp8 training scales
its tensors; the gradient flowing back through each such point is rounded
the same way. ``bf16`` rounds the same points to bf16: the configuration's
own precision, a witness of what bf16 alone does to the compared numbers."""

from __future__ import annotations

import torch

FP8_MAX = 448.0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


class _Fp8Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _fp8(t)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


class _Bf16Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _bf16(t)

    @staticmethod
    def backward(ctx, g):
        return _bf16(g)


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to scaled fp8, and its gradient likewise."""
    if not t.is_floating_point():
        return t
    return _Fp8Round.apply(t)


def bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16, and its gradient likewise."""
    if not t.is_floating_point():
        return t
    return _Bf16Round.apply(t)
