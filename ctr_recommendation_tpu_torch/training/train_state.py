"""TrainState: step + params + mutable model state + optimizer state."""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class TrainState:
    step: int  # optimizer updates done
    params: Any  # nested dicts/lists of fp32 tensors (the JAX layout)
    model_state: Any  # BatchNorm running stats
    opt_state: dict  # Optimizer.init's dict, tensor lists in param-leaf order
