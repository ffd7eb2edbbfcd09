"""The reference's training steps: the recipe of the reference's logged run
(train_fibinet.py:78-119), written out plainly.

Each step: the batch's mean binary cross-entropy on logits, the gradient of
every parameter (the tables included: dense tables), clipped by the global
norm (scale clip / norm where the norm reaches the clip), then L2 added to
the gradient (weight decay times the parameter), then Adam (b1 0.9, b2
0.999, eps 1e-8, bias-corrected), the step scaled by the learning rate of a
one-cycle schedule (cosine from peak / div up to the peak over the first
pct of the steps, then cosine down to peak / (div * final_div)) at the
count of updates already made.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from reference import model
from reference.philox import step_seed

B1, B2, EPS = 0.9, 0.999, 1e-8


def onecycle_lr(count: int, train: dict, total_steps: int) -> float:
    t = max(total_steps, 4)
    peak = train["learning_rate"] * train["onecycle_peak_factor"]
    div, final_div = train["onecycle_div_factor"], train["onecycle_final_div_factor"]
    bounds = [0, int(train["onecycle_pct_start"] * t), t]
    values = [peak / div]
    for scale in (div, 1.0 / (div * final_div)):
        values.append(values[-1] * scale)
    if count >= bounds[-1]:
        return values[-1]
    for lo, hi, start, end in zip(bounds[:-1], bounds[1:], values[:-1], values[1:]):
        if lo <= count < hi:
            pct = (count - lo) / (hi - lo)
            return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)
    return 0.0


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy(v) for v in tree]
    return tree.detach().clone()


def steps(params: dict, state: dict, batches: list[dict], item_emb: torch.Tensor, sizes: dict,
          train: dict, *, total_steps: int, rnd: Callable = model.identity,
          loss_rows: int | None = None) -> dict:
    """Run ``len(batches)`` steps from (params, state) (copied, not
    changed). Returns the losses, the first step's gradients as the
    optimizer takes them (after the clip and L2) and raw, and each leaf's
    change over the steps, all by leaf path. ``loss_rows`` takes the loss
    over a batch's first rows only (a planted fault: half of the batch left
    out)."""
    w = _copy(params)
    leaves = dict(_leaves(w))
    for t in leaves.values():
        t.requires_grad_(True)
    p0 = {k: t.detach().clone() for k, t in leaves.items()}
    mu = {k: torch.zeros_like(t) for k, t in leaves.items()}
    nu = {k: torch.zeros_like(t) for k, t in leaves.items()}
    device = item_emb.device
    gen = torch.Generator(device=device)
    out = {"losses": []}
    for k, batch in enumerate(batches):
        gen.manual_seed(step_seed(train["seed"], k))
        z = model.logits(w, state, batch, item_emb, sizes, train=True, gen=gen, rnd=rnd)
        y = batch["label"]
        loss = model.bce(z[:loss_rows], y[:loss_rows]) if loss_rows else model.bce(z, y)
        names = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[n] for n in names], allow_unused=True)
        grads = {n: (g if g is not None else torch.zeros_like(leaves[n])).detach()
                 for n, g in zip(names, grads)}
        out["losses"].append(float(loss.detach()))
        with torch.no_grad():
            norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads.values()]))
            clip = train["grad_clip_norm"]
            scale = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
            if k == 0:
                out["raw_grad1"] = {n: g.clone() for n, g in grads.items()}
            lr = onecycle_lr(k, train, total_steps)
            for n in names:
                g = grads[n] * scale + train["weight_decay"] * leaves[n]
                if k == 0:
                    out.setdefault("grad1", {})[n] = g.clone()
                mu[n].mul_(B1).add_(g, alpha=1 - B1)
                nu[n].mul_(B2).addcmul_(g, g, value=1 - B2)
                denom = (nu[n] / (1 - B2 ** (k + 1))).sqrt_().add_(EPS)
                leaves[n].sub_(lr * (mu[n] / (1 - B1 ** (k + 1))) / denom)
    out["delta"] = {n: (leaves[n].detach() - p0[n]) for n in leaves}
    return out
