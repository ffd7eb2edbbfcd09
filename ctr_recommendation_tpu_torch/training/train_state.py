"""TrainState: step + params + mutable model state + optimizer states."""

from __future__ import annotations

import dataclasses
from typing import Any

from ctr_recommendation_tpu_torch.utils.tree import tree_leaves


@dataclasses.dataclass
class TrainState:
    step: int  # optimizer updates done
    params: Any  # nested dicts/lists of fp32 tensors (the JAX layout)
    model_state: Any  # BatchNorm running stats
    opt_state: dict  # Optimizer.init's dict, tensor lists in the dense chain's leaf order
    # TableOptimizer.init's dict (training/sparse.py), {} with dense tables
    table_opt_state: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def create(cls, params, model_state, tx, table_opt_state=()) -> "TrainState":
        """Step 0, ``tx.init`` (an ``optim.Optimizer``) over the leaves of
        ``params`` in the trainer's order, and ``table_opt_state`` ({} when
        empty, the tables then riding the dense chain)."""
        return cls(0, params, model_state, tx.init(tree_leaves(params)),
                   dict(table_opt_state) if table_opt_state else {})
