"""Checkpoints: full train-state resume points + the best-metric export.

The port's own format (no orbax):

* resume points ``<dir>/ckpt_<epoch>.pt``, one ``torch.save`` of step,
  params, model state and the optimizer states (the dense chain's and, with
  sparse tables, the table optimizer's), written to a temp file and
  renamed; the newest ``max_to_keep`` are kept;
* the best export ``<dir>/best/export.npz`` in ``tools/jax_bridge.save``'s
  layout (params + model state, what the predict CLI and ``Predictor``
  read), beside ``best/metric.json`` with the monitored metric and step.
  Each file is written to a temp name and swapped in with an atomic rename,
  so a crash mid-save never loses the previous best.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any

import torch

from ctr_recommendation_tpu_torch.tools import jax_bridge
from ctr_recommendation_tpu_torch.utils.tree import tree_map

_CKPT = re.compile(r"^ckpt_(\d+)\.pt$")


def _detached_cpu(tree):
    return tree_map(lambda t: t.detach().cpu() if isinstance(t, torch.Tensor) else t, tree)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._best_dir = os.path.join(self.directory, "best")

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def steps(self) -> list[int]:
        found = (_CKPT.match(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, step: int, state) -> None:
        """A resume point for epoch ``step`` holding the whole TrainState."""
        payload = {
            "step": state.step,
            "params": _detached_cpu(state.params),
            "model_state": _detached_cpu(state.model_state),
            "opt_state": _detached_cpu(state.opt_state),
            "table_opt_state": _detached_cpu(state.table_opt_state),
        }
        path = self._path(step)
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)
        for old in self.steps()[: -self.max_to_keep] if self.max_to_keep > 0 else []:
            os.remove(self._path(old))

    def wait(self) -> None:
        """Return at once: ``save`` writes synchronously, so no save is ever
        in flight (the JAX manager's may be asynchronous)."""

    def close(self) -> None:
        """Release nothing: the manager holds no thread or open file between
        calls. Kept so that callers written for the JAX manager run as they
        are."""

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None) -> dict[str, Any]:
        """{step, params, model_state, opt_state, table_opt_state} on the
        CPU."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self._path(step), map_location="cpu", weights_only=True)

    @property
    def best_export_path(self) -> str:
        return os.path.join(self._best_dir, "export.npz")

    def save_best(self, params, model_state, metric: float, step: int) -> None:
        os.makedirs(self._best_dir, exist_ok=True)
        tmp = os.path.join(self._best_dir, "export.tmp.npz")
        jax_bridge.save(tmp, params, model_state)
        os.replace(tmp, self.best_export_path)
        meta = os.path.join(self._best_dir, "metric.json")
        with open(meta + ".tmp", "w") as f:
            json.dump({"metric": float(metric), "step": int(step)}, f)
        os.replace(meta + ".tmp", meta)

    def best_metric(self) -> float | None:
        """Monitored metric of the current best export (None if none)."""
        try:
            with open(os.path.join(self._best_dir, "metric.json")) as f:
                return float(json.load(f)["metric"])
        except (OSError, ValueError, KeyError):
            return None

    def restore_best(self) -> tuple[dict, dict]:
        """(params, model_state) of the best export as numpy trees."""
        if not os.path.exists(self.best_export_path):
            raise FileNotFoundError(f"no best export at {self.best_export_path}")
        return jax_bridge.load(self.best_export_path)
