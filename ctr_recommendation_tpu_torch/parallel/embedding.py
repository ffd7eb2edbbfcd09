"""Row-sharded embedding lookup over the ranks' model groups: the JAX
package's ``parallel/embedding.py`` on ``torch.distributed``.

Under a (dp, mp) mesh (``parallel/mesh.py``) each table lives row-sharded
P(model, None): model rank m keeps rows [m V/mp, (m + 1) V/mp). The ranks of
one model group hold the same batch rows (the batch is P(data)), so each
asks for the same ids and every rank needs every id's row. Two exchanges
assemble them:

``all_to_all`` (default): capacity-bucketed id routing.
    1. sort the rank's flat ids by owner (owner = id // rows_per);
    2. pack them into a static (mp, cap) buffer, cap = ceil(capacity_factor
       * n / mp); pad ids and out-of-range ids stay out of it;
    3. exchange the id buffers over the model group, so that each rank
       receives the ids it owns;
    4. gather them from the rank's shard;
    5. exchange the rows back and unpermute.
    A rank sends cap x mp rows instead of the n x E all-reduce of ``psum``.
    Ids past a bucket's capacity are counted; the count is all-reduced, so
    every rank of the model group reads the same value and, when it is
    non-zero, all take the ``psum`` fallback for the overflowed ids
    together.

``psum``: each rank gathers all n ids from its shard, zeros for the rows it
    does not own, and one all-reduce over the model group assembles them.

Every buffer's size is static (the local id count times the capacity
factor); the only host read is the overflow count.

The backward needs no exchange. The lookup's output is replicated over the
model group: its ranks hold the same rows and compute the same loss, so
each holds every id's cotangent already, and each owner scatter-adds, into
its shard, the cotangents of the ids it owns. That gives each owner every
id's cotangent once (JAX's transpose of the replicated output does the
same: it divides the cotangent by mp before the reverse exchange sums the
mp copies). A reverse exchange that summed the mp requesters' cotangents
would give mp times the gradient.

Collectives: gloo runs ``all_to_all_single`` on CPU tensors but not on CUDA
ones, so over gloo a CUDA buffer is staged through host memory explicitly
(gloo's own all-reduce does the same internally). NCCL exchanges on the
card; it refuses two ranks on one device, so one card cannot run that
branch at mp > 1.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ctr_recommendation_tpu_torch.ops.cuda.table_grad import table_grad
from ctr_recommendation_tpu_torch.parallel import sharding

# Tables are padded to a multiple of this many rows, so that any model
# degree up to 128 divides them evenly.
VOCAB_ROUND = 128

# Send-buffer slack over the balanced n/mp ids an owner. Uniform ids give
# Binomial(n, 1/mp) bucket counts (std sqrt(n/mp)), so 1.25x is many sigma
# of headroom; a skewed batch that overflows takes the psum fallback.
DEFAULT_CAPACITY_FACTOR = 1.25

# Tables of at most this many (padded) rows skip the exchange: their shards
# are gathered whole over the model group and indexed (the MicroLens
# category tables: 11 rows padded to 128).
SMALL_TABLE_ROWS = 1024

# the exchange's collectives since the caller last zeroed them: the calls,
# the bytes of the buffers this rank sent (ids, rows, counts), of those the
# row buffers alone, and the overflow fallbacks taken
stats = {"calls": 0, "bytes": 0, "row_bytes": 0, "fallbacks": 0}


def round_up_vocab(vocab_size: int, multiple: int = VOCAB_ROUND) -> int:
    return ((vocab_size + multiple - 1) // multiple) * multiple


def _gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    # the trunk imports this module for its vocab rounding: import it late
    from ctr_recommendation_tpu_torch.models.trunk import gather

    return gather(table, ids)


def _count(t: torch.Tensor, rows: bool = False) -> None:
    nb = t.numel() * t.element_size()
    stats["calls"] += 1
    stats["bytes"] += nb
    if rows:
        stats["row_bytes"] += nb


def _all_reduce(t: torch.Tensor, group, rows: bool = False) -> torch.Tensor:
    _count(t, rows)
    dist.all_reduce(t, group=group)
    return t


def _all_to_all(send: torch.Tensor, group, rows: bool = False) -> torch.Tensor:
    """``all_to_all_single`` of a (mp, ...) buffer: slot p of the result is
    what model rank p sent this rank. Over gloo a CUDA buffer goes through
    host memory (gloo has no all-to-all on CUDA tensors)."""
    _count(send, rows)
    if send.is_cuda and dist.get_backend(group) == "gloo":
        host = send.cpu()
        out = torch.empty_like(host)
        dist.all_to_all_single(out, host, group=group)
        return out.to(send.device)
    out = torch.empty_like(send)
    dist.all_to_all_single(out, send.contiguous(), group=group)
    return out


def _owned_rows(flat: torch.Tensor, rows_per: int, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(each id's row in model rank m's shard, clamped; whether m owns it)."""
    local = flat - m * rows_per
    ok = (local >= 0) & (local < rows_per)
    return local.clamp(0, rows_per - 1), ok


def _psum_rows(shard, flat, group, m: int) -> torch.Tensor:
    """Mask-gather-all-reduce: every rank gathers all ids from its shard,
    zeros where it is not the owner; the sum over the model group holds
    each id's row once."""
    rows_per = shard.shape[0]
    local, ok = _owned_rows(flat, rows_per, m)
    return _all_reduce(shard[local].masked_fill_(~ok[:, None], 0), group, rows=True)


def _all_to_all_rows(shard, flat, want, group, m: int, mp: int, cap: int) -> torch.Tensor:
    """The capacity-bucketed exchange of ``flat`` (n,) int64 ids: (n, E)
    rows, zeros for unwanted ids (pads, out of range)."""
    n = flat.shape[0]
    rows_per = shard.shape[0]
    v = rows_per * mp
    dev = flat.device
    # owner = id // rows_per is monotone in the id, so sorting by id makes
    # the buckets contiguous; unwanted ids sort last, with owner mp
    key = torch.where(want, flat, torch.full_like(flat, v))
    sorted_ids, order = torch.sort(key, stable=True)
    owner = sorted_ids // rows_per  # in [0, mp]; mp: unwanted
    start = torch.searchsorted(owner, torch.arange(mp, device=dev, dtype=owner.dtype))
    owner_c = owner.clamp(max=mp - 1)
    pos = torch.arange(n, device=dev) - start[owner_c]
    in_bucket = owner < mp
    fits = in_bucket & (pos < cap)
    # the (mp, cap) id buffer; what does not fit lands in a dropped last slot
    slot = torch.where(fits, owner_c * cap + pos, torch.full_like(pos, mp * cap))
    send = torch.zeros(mp * cap + 1, dtype=torch.int32, device=dev)
    send[slot] = sorted_ids.to(torch.int32)
    recv = _all_to_all(send[:-1].view(mp, cap), group)
    local = (recv.to(torch.int64) - m * rows_per).clamp(0, rows_per - 1)
    back = _all_to_all(shard[local], group, rows=True)  # (mp, cap, E)
    # masks by masked_fill (x + 0 and 0 + y are exact): the rows stay those
    # of the shard, bit for bit
    out_sorted = back[owner_c, pos.clamp(0, cap - 1)].masked_fill_(~fits[:, None], 0)
    need = in_bucket & ~fits
    overflow = _all_reduce(need.sum().reshape(1), group)
    if int(overflow.item()) > 0:  # the same value on every rank of the group
        stats["fallbacks"] += 1
        fb = _psum_rows(shard, sorted_ids.masked_fill(~need, 0), group, m)
        out_sorted += fb.masked_fill_(~need[:, None], 0)
    out = torch.empty_like(out_sorted)
    out[order] = out_sorted
    return out


class _ShardedLookup(torch.autograd.Function):
    """The exchange's forward; its backward scatter-adds the rank's own
    cotangents of the ids it owns into its shard (module docstring)."""

    @staticmethod
    def forward(ctx, shard, flat, want, group, m, mp, method, cap):
        rows_per = shard.shape[0]
        if method == "psum":
            rows = _psum_rows(shard, flat, group, m)
        else:
            rows = _all_to_all_rows(shard, flat, want, group, m, mp, cap)
        if ctx.needs_input_grad[0]:
            local, ok = _owned_rows(flat, rows_per, m)
            if method != "psum":
                ok = ok & want
            # an id this rank does not own lands in row rows_per, cut off
            ctx.save_for_backward(torch.where(ok, local, torch.full_like(local, rows_per)))
        ctx.rows_per = rows_per
        return rows

    @staticmethod
    def backward(ctx, g):
        (local,) = ctx.saved_tensors
        d = table_grad([(local, g)], ctx.rows_per + 1)
        return (d[: ctx.rows_per],) + (None,) * 7


def sharded_lookup(
    table_shard: torch.Tensor,
    ids: torch.Tensor,
    mesh,
    *,
    model_axis: str = "model",
    method: str = "all_to_all",
    capacity_factor: float = DEFAULT_CAPACITY_FACTOR,
    pad_id: int | None = None,
) -> torch.Tensor:
    """``table_shard`` (V/mp, E): this rank's rows of a P(model, None) table;
    ``ids``: this rank's ids, any shape (every rank of the model group
    holds the same). Returns the rows (ids.shape..., E), replicated over
    the model group; at mp == 1 the trunk's ``gather``.

    An id outside [0, V) returns a zero row and no gradient (JAX's
    ownership mask); with ``pad_id`` the ``all_to_all`` exchange leaves pad
    ids out as well and returns zero rows for them. That is exact: the pad
    row is zeroed at init and receives no gradient there. Padded histories
    put 30-70% of the ids on the pad's owner, whose bucket would otherwise
    overflow every batch."""
    mp = mesh.shape[model_axis]
    if mp == 1:
        return _gather(table_shard, ids)
    if method not in ("psum", "all_to_all"):
        raise ValueError(f"unknown lookup method {method!r}")
    flat = ids.reshape(-1).to(torch.int64)
    n = flat.shape[0]
    want = (flat >= 0) & (flat < table_shard.shape[0] * mp)
    if pad_id is not None:
        want &= flat != pad_id
    cap = max(1, -(-int(capacity_factor * n) // mp))
    rows = _ShardedLookup.apply(table_shard, flat, want, mesh.group(model_axis),
                                mesh.rank(model_axis), mp, method, cap)
    return rows.reshape(*ids.shape, table_shard.shape[1])


def owned_rows_gather(table_shard: torch.Tensor, ids: torch.Tensor, mesh,
                      model_axis: str = "model") -> torch.Tensor:
    """The rows (n, E) of ``ids`` (n,) in a row-sharded table, on every rank
    of the model group, zeros for ids out of range: the psum exchange,
    outside autograd. The sparse step gathers its deduplicated ids' rows
    with it and differentiates the gathered rows themselves."""
    return _psum_rows(table_shard.detach(), ids.to(torch.int64), mesh.group(model_axis),
                      mesh.rank(model_axis))


class _GatherShards(torch.autograd.Function):
    """The whole table from its shards over the model group
    (``sharding.unshard_rows``); the backward keeps the rank's own rows of
    the replicated cotangent."""

    @staticmethod
    def forward(ctx, shard, mesh, model_axis):
        ctx.m, ctx.rows = mesh.rank(model_axis), shard.shape[0]
        whole = sharding.unshard_rows(shard, mesh, model_axis)
        _count(whole, rows=True)
        return whole

    @staticmethod
    def backward(ctx, g):
        return g[ctx.m * ctx.rows : (ctx.m + 1) * ctx.rows], None, None


def gather_shards(shard: torch.Tensor, mesh, model_axis: str = "model") -> torch.Tensor:
    """The whole (V, E) table on every rank of the model group,
    differentiable (each rank's gradient: its own rows)."""
    if mesh.shape[model_axis] == 1:
        return shard
    return _GatherShards.apply(shard, mesh, model_axis)


def exchange_stats(
    ids,
    *,
    vocab_rows: int,
    dp: int,
    mp: int,
    capacity_factor: float = DEFAULT_CAPACITY_FACTOR,
    pad_id: int | None = None,
) -> dict:
    """A numpy mirror of the ``all_to_all`` routing for ONE global batch of
    ids: the strategy, the bucket capacity a rank, the largest bucket of
    wanted ids and the overflow count (ids that would take the psum
    fallback). The batch axis is split dp ways; owner = id // rows_per; pad
    and out-of-range ids are excluded."""
    ids = np.asarray(ids)
    if mp == 1:
        return {"strategy": "local_gather", "capacity": None, "max_bucket": None,
                "overflow": 0}
    rows_per = vocab_rows // mp
    per_shard = np.array_split(ids, dp, axis=0)
    n_local = per_shard[0].reshape(-1).shape[0]
    cap = max(1, -(-int(capacity_factor * n_local) // mp))
    overflow = 0
    max_bucket = 0
    for shard_ids in per_shard:
        flat = shard_ids.reshape(-1)
        want = (flat >= 0) & (flat < rows_per * mp)
        if pad_id is not None:
            want &= flat != pad_id
        counts = np.bincount(flat[want] // rows_per, minlength=mp)
        max_bucket = max(max_bucket, int(counts.max()) if len(counts) else 0)
        overflow += int(np.maximum(counts - cap, 0).sum())
    return {"strategy": "all_to_all", "capacity": cap, "max_bucket": max_bucket,
            "overflow": overflow}


def make_sharded_lookup(
    mesh,
    model_axis: str = "model",
    *,
    method: str = "all_to_all",
    capacity_factor: float = DEFAULT_CAPACITY_FACTOR,
    feature_map=None,
    small_table_rows: int = SMALL_TABLE_ROWS,
):
    """A ``lookup(tables, name, ids, feature=None, batch_dim=0)`` for the
    trunk (``models/trunk.py::apply``) over row-sharded tables.

    A table of at most ``small_table_rows`` rows (whole) is gathered whole
    and indexed; the others go through ``sharded_lookup``. ``feature_map``:
    each table's pad id (``TableSpec.pad_id``) is kept out of the
    ``all_to_all`` exchange. The lookup's ``batch_dim`` is the trunk's
    contract: each rank holds its own ids, whatever their layout."""
    mp = mesh.shape[model_axis]

    def lookup(tables: dict, name: str, ids: torch.Tensor, feature=None, batch_dim=0):
        tbl = tables[name]
        if mp == 1:
            return _gather(tbl, ids)
        if tbl.shape[0] * mp <= small_table_rows:
            return _gather(gather_shards(tbl, mesh, model_axis), ids)
        pad_id = None
        if feature_map is not None:
            try:
                pad_id = feature_map.table(name).pad_id
            except (KeyError, StopIteration):
                pad_id = None
        return sharded_lookup(tbl, ids, mesh, model_axis=model_axis, method=method,
                              capacity_factor=capacity_factor, pad_id=pad_id)

    return lookup
