"""One data-parallel step's collectives, on ``torch.distributed``.

Under a data group of W ranks, rank r holds rows [r B, (r + 1) B) of a
global batch of W B rows (``DataSlice``) and a replica of the parameters.
The step then computes what one process computes over the global batch, as
the JAX step does over its ``data`` axis:

* the loss: each rank's sum over the global count (or the global weight
  sum), so that the ranks' shares add up to the global mean
  (``training/loop.py::bce_with_logits``); the gradients are then summed
  across the ranks, not averaged;
* BatchNorm's train-mode statistics over the global batch
  (``ops/mlp.py``): ``all_reduce_sum`` is differentiable, its backward
  sums the cotangents over the ranks too, because every rank's loss share
  depends on every rank's rows through the statistics;
* dropout: each rank draws the global batch's mask and keeps its own rows
  (``ops/mlp.py::dropout``); the encoder's Philox masks count tokens from
  the rank's first global token (``models/trunk.py``);
* the sparse tables' ids: each rank's ids gathered from all ranks
  (``all_gather``), so that every rank dedups the global batch's ids
  (``training/sparse.py::remap_batch``);
* the gradients and the loss: summed in a few flat buckets
  (``all_reduce_buckets_``).

Only ``all_reduce`` and ``broadcast`` are used: they are the two
collectives gloo runs on CUDA tensors, so one code runs on NCCL (one rank a
card), on gloo over CPU tensors, and on gloo for ranks that share one card.
An all-gather is the all-reduce of a zeroed (W, ...) buffer in which each
rank fills its own slot. Every buffer has a size fixed by the local batch:
no rank waits on a data-dependent length.

The ops read the step's slice from ``current()``, which the trainer sets
around its train-mode forward with ``step_slice``; outside it (one process,
eval) they compute as before.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import torch
import torch.distributed as dist

# the flat gradient buckets' size; a larger tensor is a bucket of its own
BUCKET_BYTES = 32 << 20

# all_reduce calls and the bytes they reduced, since the caller last zeroed them
stats = {"calls": 0, "bytes": 0}


@dataclasses.dataclass(frozen=True)
class DataSlice:
    """A rank's share of one global batch: ``rows`` of it, every rank as
    many, starting at global row ``rank * rows``."""

    group: object  # the data axis' ProcessGroup
    world: int
    rank: int
    rows: int

    @property
    def row0(self) -> int:
        return self.rank * self.rows

    @property
    def global_rows(self) -> int:
        return self.world * self.rows


_current: contextvars.ContextVar[DataSlice | None] = contextvars.ContextVar(
    "data_slice", default=None)


def current() -> DataSlice | None:
    """The slice of the step being computed (None outside a data-parallel
    train-mode forward)."""
    return _current.get()


@contextlib.contextmanager
def step_slice(s: DataSlice | None):
    """Make ``s`` the slice that ``current()`` returns within the block."""
    token = _current.set(s)
    try:
        yield s
    finally:
        _current.reset(token)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum of a contiguous tensor over the group's ranks."""
    stats["calls"] += 1
    stats["bytes"] += t.numel() * t.element_size()
    dist.all_reduce(t, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks, differentiable: the backward
    returns the sum of the ranks' cotangents."""
    return _AllReduceSum.apply(x, group)


def all_gather(x: torch.Tensor, s: DataSlice) -> torch.Tensor:
    """Every rank's ``x`` (one shape on all), stacked (world, *x.shape) in
    rank order."""
    buf = x.new_zeros((s.world, *x.shape))
    buf[s.rank] = x
    return all_reduce_(buf, s.group)


def all_reduce_buckets_(tensors: list[torch.Tensor], group,
                        bucket_bytes: int = BUCKET_BYTES) -> None:
    """Sum each tensor over the group's ranks, in place: consecutive tensors
    of one dtype and device flattened into buckets of up to ``bucket_bytes``
    (a larger tensor is a bucket of its own), one all-reduce a bucket; a
    bucket of one contiguous tensor is reduced where it lies."""
    buckets: list[list[torch.Tensor]] = []
    size = 0
    for t in tensors:
        nb = t.numel() * t.element_size()
        if (not buckets or size + nb > bucket_bytes or t.dtype != buckets[-1][0].dtype
                or t.device != buckets[-1][0].device):
            buckets.append([])
            size = 0
        buckets[-1].append(t)
        size += nb
    for b in buckets:
        if len(b) == 1 and b[0].is_contiguous():
            all_reduce_(b[0], group)
            continue
        flat = all_reduce_(torch.cat([t.reshape(-1) for t in b]), group)
        for t, part in zip(b, flat.split([t.numel() for t in b])):
            t.copy_(part.view_as(t))
