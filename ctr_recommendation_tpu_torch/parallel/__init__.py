"""Multi-process training on ``torch.distributed``: the JAX package's
``parallel/`` (its data-parallel half; ROADMAP.md queue 1 item 2 holds the
row-sharded half)."""

from ctr_recommendation_tpu_torch.parallel.mesh import make_mesh, single_device_mesh
from ctr_recommendation_tpu_torch.parallel.sharding import (
    batch_sharding,
    batch_specs,
    param_specs,
    tree_shardings,
)

__all__ = [
    "batch_sharding",
    "batch_specs",
    "make_mesh",
    "param_specs",
    "single_device_mesh",
    "tree_shardings",
]
