"""Multi-process runtime glue: the JAX package's ``parallel/distributed.py``
on ``torch.distributed``.

Every rank runs the same program, one process a rank and one device a rank
(``cuda:{LOCAL_RANK}``, or the CPU). ``initialize()`` joins the process
group; ``make_mesh`` lays the ranks out as (data, model); each rank loads a
disjoint shard of the split (``TableData.shard``) and keeps only its own
rows: there is no global array. ``host_local_to_global`` places a rank's
numpy batch on its device and names the rank's first row of the global
batch, which the step's dropout keys need (``parallel/data_parallel.py``).

Launch with ``torchrun --nproc_per_node N -m ctr_recommendation_tpu_torch.cli.train
...``: torchrun sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``
and ``MASTER_PORT``, which ``initialize()`` reads.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

# seconds a collective may wait for the other ranks before it fails: a dead
# rank fails the others instead of hanging them
DEFAULT_TIMEOUT_S = 600.0
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def default_backend(device: str | torch.device | None = None) -> str:
    """``nccl`` for one rank a card (on CUDA), ``gloo`` on the CPU. Ranks
    that share one card must ask for ``gloo``: NCCL refuses two ranks on one
    device."""
    if device is None:
        return "nccl" if torch.cuda.is_available() else "gloo"
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *,
               backend: str | None = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Idempotent ``torch.distributed.init_process_group``. Returns True when
    the process group is (now) initialized.

    ``coordinator_address`` ("host:port", rank 0's), ``num_processes`` and
    ``process_id`` ask for a group explicitly: a failure raises. With none
    of them the launcher's environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``, as torchrun sets them) is read; a
    plain single process has none of it and this is a clean no-op (False).
    ``backend`` defaults to ``default_backend()``; ``timeout_s`` bounds
    every collective's wait."""
    if dist.is_initialized():
        return True
    explicit = (coordinator_address, num_processes, process_id)
    if any(a is not None for a in explicit):
        if any(a is None for a in explicit):
            raise ValueError("initialize needs coordinator_address, num_processes and "
                             f"process_id together, got {explicit}")
        init = dict(init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                    rank=process_id)
    elif all(k in os.environ for k in _LAUNCHER_ENV):
        init = dict(init_method="env://")
    else:
        return False  # no cluster environment: one process
    dist.init_process_group(backend or default_backend(),
                            timeout=datetime.timedelta(seconds=timeout_s), **init)
    return True


def host_id() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def host_count() -> int:
    """The number of ranks (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank_device(device: str | torch.device = "cuda") -> torch.device:
    """The rank's device: ``cuda:{LOCAL_RANK}`` for "cuda" (the rank's
    index on its machine, 0 without the variable), else as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def host_local_to_global(batch: dict[str, np.ndarray], mesh, data_axis: str = "data",
                         batch_dim: int = 0) -> tuple[dict[str, torch.Tensor], int]:
    """A rank's numpy batch (its local rows) -> (the columns on the mesh's
    device, the rank's first global row ``data rank * local rows``).

    The logical global batch is the concatenation of the ranks' batches in
    data-rank order; every rank holds as many rows. ``batch_dim`` names the
    row axis: 0 for plain batches, 1 for the (K, rows, ...) chunks of
    ``Trainer.put_chunk``."""
    rows = next(iter(batch.values())).shape[batch_dim]
    cols = {k: torch.as_tensor(np.ascontiguousarray(v)).to(mesh.device)
            for k, v in batch.items()}
    return cols, mesh.rank(data_axis) * rows
