"""TrainState: step + params + mutable model state + optimizer states."""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class TrainState:
    step: int  # optimizer updates done
    params: Any  # nested dicts/lists of fp32 tensors (the JAX layout)
    model_state: Any  # BatchNorm running stats
    opt_state: dict  # Optimizer.init's dict, tensor lists in the dense chain's leaf order
    # TableOptimizer.init's dict (training/sparse.py), {} with dense tables
    table_opt_state: dict = dataclasses.field(default_factory=dict)
