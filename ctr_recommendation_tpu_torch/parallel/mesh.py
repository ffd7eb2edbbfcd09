"""The ranks' layout: the JAX package's ``parallel/mesh.py`` on
``torch.distributed``.

One layout, two axes over dp x mp ranks, world rank d mp + m at (d, m):
``data`` shards the batch (data-parallel training, one global step over the
ranks' rows), ``model`` shards the embedding tables' rows
(``parallel/embedding.py``). The ranks of one model group (one d) hold the
same batch rows and a shard each; the ranks of one data group (one m) hold
the same shard and rows of their own. A ``Mesh`` names this process's
device and, over a process group, holds the ``DeviceMesh`` whose per-axis
groups the collectives run on.
"""

from __future__ import annotations

import dataclasses

import torch

from ctr_recommendation_tpu_torch.config.schema import MeshConfig
from ctr_recommendation_tpu_torch.parallel import distributed


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape``: ranks per axis name; ``device``: this rank's device;
    ``device_mesh``: the ``DeviceMesh`` over the process group (None for one
    process)."""

    shape: dict[str, int]
    axis_names: tuple[str, str]
    device: torch.device
    device_mesh: object | None = None

    def group(self, axis: str):
        """The process group of ``axis`` (None for one process)."""
        return None if self.device_mesh is None else self.device_mesh.get_group(axis)

    def rank(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return 0 if self.device_mesh is None else self.device_mesh.get_local_rank(axis)

    @property
    def data_rank(self) -> int:
        return self.rank(self.axis_names[0])

    @property
    def model_rank(self) -> int:
        return self.rank(self.axis_names[1])

    @property
    def writes(self) -> bool:
        """Whether this rank writes files (checkpoints, metrics): world rank
        0 alone. Model ranks of data rank 0 share its data rank, not this
        role."""
        return self.device_mesh is None or self.device_mesh.get_rank() == 0


def make_mesh(cfg: MeshConfig | None = None, world: int | None = None,
              device: str | torch.device = "cuda") -> Mesh:
    """The (dp, mp) layout over ``world`` ranks (default the process group's
    size): ``data_parallel`` -1 takes all remaining ranks; ``dp * mp`` must
    cover the world. One rank without a process group is
    ``single_device_mesh``. ``device`` is the rank's (``rank_device``)."""
    cfg = cfg or MeshConfig()
    world = distributed.host_count() if world is None else world
    mp = max(1, cfg.model_parallel)
    dp = cfg.data_parallel if cfg.data_parallel > 0 else world // mp
    if dp * mp != world:
        raise ValueError(
            f"mesh {dp}x{mp} does not cover {world} devices "
            f"(data_parallel={cfg.data_parallel}, model_parallel={cfg.model_parallel})"
        )
    dev = distributed.rank_device(device)
    if world == 1 and not torch.distributed.is_initialized():
        return single_device_mesh(cfg.axis_names, dev)
    from torch.distributed.device_mesh import init_device_mesh

    if dev.type == "cuda":
        # before the DeviceMesh, which otherwise picks a device by rank
        torch.cuda.set_device(dev)
    dm = init_device_mesh(dev.type, (dp, mp), mesh_dim_names=cfg.axis_names)
    return Mesh({cfg.axis_names[0]: dp, cfg.axis_names[1]: mp}, cfg.axis_names, dev, dm)


def single_device_mesh(axis_names=("data", "model"),
                       device: str | torch.device = "cuda") -> Mesh:
    """The 1 x 1 layout of one process, with no process group."""
    return Mesh({axis_names[0]: 1, axis_names[1]: 1}, tuple(axis_names), torch.device(device))
