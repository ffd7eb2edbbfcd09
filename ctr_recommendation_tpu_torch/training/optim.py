"""Optimizers + LR schedules, matching the JAX package's optax chain.

The logged reference run used torch.optim.Adam(lr, weight_decay=1e-5), an
L2 added to the gradient (not decoupled AdamW), a OneCycle schedule stepped
per batch with max_lr = 10 * lr, and global-norm clipping at 10. The JAX
package builds that from optax (its training/optim.py:20-95); this module is
its own code for the same arithmetic, with no optax:

* ``make_schedule`` reproduces optax's ``constant_schedule``,
  ``warmup_cosine_decay_schedule`` and ``cosine_onecycle_schedule`` (with
  the JAX package's T >= 4 clamp). It is not ``OneCycleLR``, whose peak and
  final values differ from optax's by up to 42%.
* ``make_optimizer`` returns an ``Optimizer`` whose ``update`` runs, in
  place on dense tensors: clip by global norm (optax's formula, no epsilon),
  then for "adam" L2 then Adam, for "adamw" Adam then decoupled decay, for
  "adagrad" the root-sum-of-squares scaling (accumulator 0, eps 1e-10) then
  decoupled decay; then the step ``-lr(k) * u`` with k counting updates
  from 0.

With sparse tables (``table_optimizer != "dense"``) the embedding tables
leave this chain for ``training/sparse.py``'s ``TableOptimizer``: the
trainer hands the chain only the other leaves, and the chain's clip is
omitted because the train step clips the dense and the row gradients
jointly.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from ctr_recommendation_tpu_torch.config.schema import TrainConfig

Schedule = Callable[[int], float]

def _cosine_onecycle(transition_steps, peak_value, pct_start, div_factor, final_div_factor):
    """optax.cosine_onecycle_schedule: cosine interpolation between the
    cumulative values at boundaries 0, int(pct_start T) and T."""
    bounds = [0, int(pct_start * transition_steps), int(transition_steps)]
    values = [peak_value / div_factor]
    for scale in (div_factor, 1.0 / (div_factor * final_div_factor)):
        values.append(values[-1] * scale)

    def schedule(count: int) -> float:
        if count >= bounds[-1]:
            return values[-1]
        for lo, hi, start, end in zip(bounds[:-1], bounds[1:], values[:-1], values[1:]):
            if lo <= count < hi:
                pct = (count - lo) / (hi - lo)
                return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)
        return 0.0  # count < 0

    return schedule


def _warmup_cosine(init_value, peak_value, warmup_steps, decay_steps, end_value):
    """optax.warmup_cosine_decay_schedule (exponent 1)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cos_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * c / cos_steps))
        return peak_value * ((1 - alpha) * cosine + alpha)

    return schedule


def make_schedule(cfg: TrainConfig, total_steps: int) -> Schedule:
    if cfg.lr_schedule == "constant":
        return lambda count: cfg.learning_rate
    if cfg.lr_schedule == "cosine":
        total = max(total_steps, 4)
        return _warmup_cosine(
            init_value=cfg.learning_rate / cfg.onecycle_div_factor,
            peak_value=cfg.learning_rate,
            warmup_steps=max(1, int(cfg.onecycle_pct_start * total)),
            decay_steps=total,
            end_value=cfg.learning_rate / cfg.onecycle_final_div_factor,
        )
    if cfg.lr_schedule == "onecycle":
        # T <= 3 makes one of optax's intervals zero-width (every lr NaN):
        # clamp so both phases are non-empty, as the JAX package does
        return _cosine_onecycle(
            transition_steps=max(total_steps, 4),
            peak_value=cfg.learning_rate * cfg.onecycle_peak_factor,
            pct_start=cfg.onecycle_pct_start,
            div_factor=cfg.onecycle_div_factor,
            final_div_factor=cfg.onecycle_final_div_factor,
        )
    raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")


class Optimizer:
    """Dense chain over a flat list of parameter tensors, updated in place.

    State is a dict of plain values and tensor lists (so ``torch.save`` keeps
    it): ``count`` (updates done) and, per kind, ``mu``/``nu`` (Adam moments)
    or ``sum_of_squares`` (Adagrad)."""

    B1, B2, ADAM_EPS, RSS_EPS = 0.9, 0.999, 1e-8, 1e-10

    def __init__(self, kind: str, schedule: Schedule, clip_norm: float, weight_decay: float):
        if kind not in ("adam", "adamw", "adagrad"):
            raise ValueError(f"unknown optimizer {kind!r}")
        self.kind = kind
        self.schedule = schedule
        self.clip_norm = clip_norm
        self.weight_decay = weight_decay

    def init(self, params: list[torch.Tensor]) -> dict:
        zeros = lambda: [torch.zeros_like(p) for p in params]  # noqa: E731
        if self.kind == "adagrad":
            return {"count": 0, "sum_of_squares": zeros()}
        return {"count": 0, "mu": zeros(), "nu": zeros()}

    @torch.no_grad()
    def update(self, grads: list[torch.Tensor], state: dict, params: list[torch.Tensor],
               global_norm=None) -> None:
        """One step: ``params`` and ``state`` change in place; ``grads`` are
        consumed (scaled in place). ``global_norm(grads)`` replaces the
        clip's norm over ``grads`` (a trainer whose ``grads`` hold table
        shards sums their squares over the shards)."""
        lr = self.schedule(state["count"])
        if self.clip_norm and self.clip_norm > 0:
            norm = (torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
                    if global_norm is None else global_norm(grads))
            scale = torch.where(norm < self.clip_norm, 1.0, self.clip_norm / norm)
            torch._foreach_mul_(grads, scale)
        wd = self.weight_decay
        state["count"] += 1
        if self.kind == "adagrad":
            ss = state["sum_of_squares"]
            torch._foreach_addcmul_(ss, grads, grads)
            inv = torch._foreach_add(ss, self.RSS_EPS)
            torch._foreach_rsqrt_(inv)
            u = [torch.where(s > 0, i * g, 0.0) for s, i, g in zip(ss, inv, grads)]
        else:
            if self.kind == "adam" and wd:
                torch._foreach_add_(grads, params, alpha=wd)  # L2 into the gradient
            mu, nu = state["mu"], state["nu"]
            torch._foreach_mul_(mu, self.B1)
            torch._foreach_add_(mu, grads, alpha=1 - self.B1)
            torch._foreach_mul_(nu, self.B2)
            torch._foreach_addcmul_(nu, grads, grads, value=1 - self.B2)
            k = state["count"]
            denom = torch._foreach_div(nu, 1 - self.B2**k)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.ADAM_EPS)
            u = torch._foreach_div(mu, 1 - self.B1**k)
            torch._foreach_div_(u, denom)
        if self.kind in ("adamw", "adagrad") and wd:
            torch._foreach_add_(u, params, alpha=wd)  # decoupled decay
        torch._foreach_add_(params, u, alpha=-lr)


def make_optimizer(
    cfg: TrainConfig, total_steps: int, *, sparse_tables: bool = False
) -> tuple[Optimizer, Schedule]:
    """The dense chain of the JAX package's ``make_optimizer`` and its lr
    schedule. ``sparse_tables``: the chain runs without its clip (the step
    clips dense and row gradients jointly) and is given no table leaves, so
    it allocates no state for them."""
    schedule = make_schedule(cfg, total_steps)
    clip = 0.0 if sparse_tables else cfg.grad_clip_norm
    return Optimizer(cfg.optimizer, schedule, clip, cfg.weight_decay), schedule
