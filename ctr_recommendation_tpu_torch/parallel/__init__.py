"""Multi-process training on ``torch.distributed``: the JAX package's
``parallel/``, data-parallel (``data_parallel.py``) and with row-sharded
embedding tables (``embedding.py``)."""

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
