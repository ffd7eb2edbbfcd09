"""The numbers ``correct`` is decided by, each against its limit
(``port_bench/limits/<cell>.json``, set from readings of sound runs of the
program and of a control, as ``PERF.md`` records).

Training: each compared step's loss, the first step's gradient as the
optimizer took it and each leaf's change over the compared steps, the
latter two by the worst leaf: the gap between the program's norm of a leaf
and the reference's, over the larger of the reference's norm of that leaf
and of the median leaf; and the median leaf's relative difference of the
first gradient. Leaves whose reference gradient is under a thousandth of
the median leaf's (round-off alone makes their gradient and moves them
under Adam, as a bias before BatchNorm) are left out. A cell compares the
numbers its limits file names. Scoring: the widest gap between a served
probability and the reference's.
"""

from __future__ import annotations

import math

import torch

NEGLIGIBLE_GRAD = 1e-3  # of the median leaf's reference gradient norm


def _norms(tree: dict) -> dict[str, float]:
    names = list(tree)
    vals = torch.stack([tree[n].detach().float().norm() for n in names]).tolist()
    return dict(zip(names, vals))


def _median(values) -> float:
    v = sorted(values)
    n = len(v)
    return 0.5 * (v[(n - 1) // 2] + v[n // 2])


def worst_leaf_gap(prog: dict[str, float], ref: dict[str, float],
                   leaves=None) -> tuple[float, str]:
    """(max over leaves of |prog - ref| / max(ref, median ref), the leaf)."""
    leaves = list(ref) if leaves is None else list(leaves)
    med = _median(ref[n] for n in ref)
    worst, at = 0.0, ""
    for n in leaves:
        g = abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
        if not math.isfinite(g):
            return math.inf, n
        if g > worst:
            worst, at = g, n
    return worst, at


def train_readings(prog: dict, ref: dict, *, leaves: bool = False) -> dict:
    """The numbers of a training cell. ``prog`` and ``ref``: the compared
    steps' losses, and by leaf path the first gradient as the optimizer
    took it (``grad1``) and the change over the steps (``delta``), as
    tensors; ``ref`` also the raw first gradient. The worst leaf's gap of
    norms (``grad_gap``, ``change_gap``), and the median leaf's norm of the
    first gradient's difference over the reference's norm (``grad_diff``),
    which separates bf16 from its control where bf16 alone moves the worst
    leaf's norm as far as the control does. ``leaves`` adds each leaf's
    norms."""
    if set(prog["grad1"]) != set(ref["grad1"]):
        raise RuntimeError("the program's leaves and the reference's differ: "
                           f"{sorted(set(prog['grad1']) ^ set(ref['grad1']))}")
    losses = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"])]
    raw = _norms(ref["raw_grad1"])
    med_raw = _median(raw.values())
    moved = [n for n in raw if raw[n] >= NEGLIGIBLE_GRAD * med_raw]
    out = {"loss_gap": max(losses) if all(map(math.isfinite, prog["losses"])) else math.inf}
    table = {}
    for key, name in (("grad1", "grad"), ("delta", "change")):
        p, r = _norms(prog[key]), _norms(ref[key])
        d = _norms({n: prog[key][n].float() - ref[key][n].float() for n in moved})
        out[f"{name}_gap"], table[name] = worst_leaf_gap(p, r, moved)
        if name == "grad":
            out["grad_diff"] = _median(d[n] / max(r[n], 1e-30) for n in moved)
        if leaves:
            for n in moved:
                table.setdefault("leaves", {}).setdefault(n, {})[name] = (p[n], r[n], d[n])
    table["left_out"] = sorted(set(raw) - set(moved))
    out["_worst"] = table
    return out


def prob_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The widest gap between served probabilities and the reference's."""
    if got.shape != want.shape:
        return math.inf
    d = (got.float() - want.float()).abs().max()
    return float(d) if bool(torch.isfinite(got).all()) else math.inf


def checks(readings: dict, limits: dict) -> dict:
    """{name: {"value": reading, "limit": limit}} for each limited number."""
    return {k: {"value": readings[k], "limit": limits[k]} for k in limits if k in readings}


def passed(checked: dict) -> bool:
    return bool(checked) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checked.values())
