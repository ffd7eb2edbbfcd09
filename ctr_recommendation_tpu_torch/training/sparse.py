"""Sparse (touched-rows-only) embedding-table updates: the JAX package's
training/sparse.py on the port.

With ``table_optimizer != "dense"`` the embedding tables leave the dense
chain (training/optim.py) and only the rows a batch touches, with their
optimizer state, are updated:

1. each table's batch ids are deduplicated into a sorted buffer of static
   size ``min(ids, vocab_rows)`` whose tail holds the out-of-range sentinels
   ``vocab_rows, vocab_rows + 1, ...`` (``dedup_ids``), built from
   fixed-shape ops (sort, an adjacent-difference mask, cumsum, scatter) so
   that nothing waits on the device for a data-dependent size;
2. the loss is differentiated with respect to the GATHERED rows
   (``gather_rows``): the row gradient is the dense table gradient
   restricted to the touched rows;
3. ``TableOptimizer.update`` writes the touched rows of the table and its
   state back with ``index_copy_``. PyTorch has no scatter that drops
   out-of-range indices, so every slot this table does not hold (the
   sentinels; at model_parallel > 1 also the rows other ranks own) is
   pointed at the first held slot's row (slot 0's in one process:
   ``remap_batch`` forces the pad id 0 in) and carries that slot's own new
   value. Every write to a repeated index then holds the same bits, and
   the copy is exact. The table row is written as ``rows + (-lr * upd)``,
   one rounding, as the JAX ``.at[u].add`` rounds.

Tables comparable in size to the batch's id count take the masked-dense
strategy instead (``update_dense``): the same lazy semantics as full-table
elementwise ops gated by ``touched = any(g != 0)`` per row.

Kinds: ``adagrad`` (per-element accumulator; with weight_decay 0 equal to
the dense adagrad chain, since untouched rows have zero gradient there
too), ``rowwise_adagrad`` (one accumulator per row, over the row-mean
squared gradient) and lazy ``adam`` (moments updated at touched rows, with
the global-step bias correction). Decay is lazy: added after the rss
scaling for the adagrad family, into the gradient for adam.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ctr_recommendation_tpu_torch.config.schema import FeatureType, TrainConfig
from ctr_recommendation_tpu_torch.models.trunk import TableLookup
from ctr_recommendation_tpu_torch.parallel import data_parallel

TABLE_OPTIMIZERS = ("adagrad", "rowwise_adagrad", "adam")


def _uniquify_sentinels(uids: torch.Tensor, vocab_rows: int) -> torch.Tensor:
    """Spread the fill slots (all ``vocab_rows``) over ``vocab_rows,
    vocab_rows + 1, ...``: the buffer stays sorted, unique and out of range
    there."""
    idx = torch.arange(uids.numel(), dtype=uids.dtype, device=uids.device)
    first = (uids < vocab_rows).sum()  # sorted: the first slot >= vocab_rows
    return torch.where(uids >= vocab_rows, vocab_rows + (idx - first), uids)


def dedup_ids_inverse(ids: torch.Tensor, vocab_rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(sorted unique ids of static size ``min(ids.numel(), vocab_rows)``
    with the sentinel tail, the position of each input element in it), as
    ``jnp.unique(..., size=, fill_value=vocab_rows, return_inverse=True)``
    then ``_uniquify_sentinels``; int64. Fixed-shape ops only: no host
    sync."""
    flat = ids.reshape(-1).to(torch.int64)
    n = flat.numel()
    srt, order = torch.sort(flat)
    new = torch.ones_like(srt, dtype=torch.bool)
    new[1:] = srt[1:] != srt[:-1]
    pos = torch.cumsum(new.to(torch.int64), 0) - 1  # slot of each sorted element
    # every element writes its own value at its slot: repeats write equal bits
    buf = torch.full((n,), vocab_rows, dtype=torch.int64, device=flat.device)
    buf.scatter_(0, pos, srt)
    inv = torch.empty_like(pos).scatter_(0, order, pos)
    return _uniquify_sentinels(buf[: min(n, vocab_rows)], vocab_rows), inv


def dedup_ids(ids: torch.Tensor, vocab_rows: int) -> torch.Tensor:
    """Sorted unique ids of static size ``min(ids.numel(), vocab_rows)``,
    the tail filled with the sentinels ``vocab_rows, vocab_rows + 1, ...``."""
    return dedup_ids_inverse(ids, vocab_rows)[0]


def gather_rows(table: torch.Tensor, uids: torch.Tensor) -> torch.Tensor:
    """Rows for unique ids; sentinel slots read a clamped row that nothing
    maps to and whose update is never written."""
    return table.index_select(0, uids.clamp(0, table.shape[0] - 1))


def _write_rows(dst: torch.Tensor, uids: torch.Tensor, new_rows: torch.Tensor) -> None:
    """``dst[uids] = new_rows`` for the slots ``dst`` holds (0 <= uid <
    rows); the others rewrite the first held slot's row with that slot's
    own value, or, when ``dst`` holds none of them, row 0 with its own."""
    held = (uids >= 0) & (uids < dst.shape[0])
    # the first held slot (0 when none is), as a 1-element index: no host read
    a = held.to(torch.int32).argmax().view(1)
    first = uids.index_select(0, a).clamp(0, dst.shape[0] - 1)
    shape = (-1, *([1] * (new_rows.dim() - 1)))
    anchor = torch.where(held.index_select(0, a).view(shape), new_rows.index_select(0, a),
                         dst.index_select(0, first))
    dst.index_copy_(0, torch.where(held, uids, first),
                    torch.where(held.view(shape), new_rows, anchor))


@dataclasses.dataclass(frozen=True)
class TableOptimizer:
    """Touched-rows-only optimizer for the embedding tables. State is a dict
    per table of tensors: ``acc`` (V, E) for adagrad, (V, 1) for
    rowwise_adagrad; ``mu``/``nu`` (V, E) for adam. ``update`` and
    ``update_dense`` change tables and state in place."""

    kind: str  # "adagrad" | "rowwise_adagrad" | "adam"
    schedule: Callable[[int], float]
    weight_decay: float = 0.0
    # the accumulator starts at 0 (torch.optim.Adagrad's default): a 0.1
    # floor swamps CTR-scale gradients (~1e-3) and freezes the tables
    rss_init: float = 0.0
    rss_eps: float = 1e-10
    b1: float = 0.9
    b2: float = 0.999
    adam_eps: float = 1e-8

    def __post_init__(self):
        if self.kind not in TABLE_OPTIMIZERS:
            raise ValueError(f"unknown table_optimizer {self.kind!r}; "
                             f"expected 'dense' or one of {TABLE_OPTIMIZERS}")

    def init(self, tables: dict[str, torch.Tensor]) -> dict[str, dict[str, torch.Tensor]]:
        if self.kind == "adagrad":
            return {n: {"acc": torch.full_like(t, self.rss_init)} for n, t in tables.items()}
        if self.kind == "rowwise_adagrad":
            return {n: {"acc": t.new_full((t.shape[0], 1), self.rss_init)}
                    for n, t in tables.items()}
        return {n: {"mu": torch.zeros_like(t), "nu": torch.zeros_like(t)}
                for n, t in tables.items()}

    def _scaled(self, g: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
        """The adagrad family's rss scaling: g / sqrt(acc + eps) where acc > 0."""
        return torch.where(acc > 0, torch.rsqrt(acc + self.rss_eps), 0.0) * g

    def _adam(self, mu: torch.Tensor, nu: torch.Tensor, count: int) -> torch.Tensor:
        """Adam's bias-corrected step direction at update ``count``."""
        return (mu / (1 - self.b1**count)) / (
            torch.sqrt(nu / (1 - self.b2**count)) + self.adam_eps)

    @torch.no_grad()
    def update(self, tables: dict[str, torch.Tensor], tstate: dict, uids: dict[str, torch.Tensor],
               row_grads: dict[str, torch.Tensor], step: int,
               row0: dict[str, int] | None = None) -> None:
        """Gathered strategy: ``uids[name]`` from ``dedup_ids`` (slot 0
        real), ``row_grads[name]`` the gradient of the gathered rows.
        ``step`` counts completed updates (lr and bias correction at step +
        1's count, as optax's). ``row0[name]``: the whole table's row that
        ``tables[name]``, a shard of it, starts at (model_parallel > 1);
        the shard's rows alone are updated, the other uids' left to their
        owners."""
        lr = self.schedule(step)
        count = step + 1
        for name, table in tables.items():
            u, g, st = uids[name], row_grads[name], tstate[name]
            if row0 is not None:
                u = u - row0[name]
            rows = gather_rows(table, u)
            if self.kind == "adam":
                if self.weight_decay:  # L2 into the gradient, before the moments
                    g = g + self.weight_decay * rows
                mu = self.b1 * gather_rows(st["mu"], u) + (1 - self.b1) * g
                nu = self.b2 * gather_rows(st["nu"], u) + (1 - self.b2) * g * g
                upd = self._adam(mu, nu, count)
                _write_rows(st["mu"], u, mu)
                _write_rows(st["nu"], u, nu)
            else:
                acc = gather_rows(st["acc"], u)
                if self.kind == "rowwise_adagrad":
                    acc = acc + (g * g).mean(-1, keepdim=True)
                else:
                    acc = acc + g * g
                upd = self._scaled(g, acc)
                if self.weight_decay:  # after the rss scaling, as the dense chain
                    upd = upd + self.weight_decay * rows
                _write_rows(st["acc"], u, acc)
            _write_rows(table, u, rows + (-lr * upd))

    @torch.no_grad()
    def update_dense(self, tables: dict[str, torch.Tensor], tstate: dict,
                     dense_grads: dict[str, torch.Tensor], step: int) -> None:
        """Masked-dense strategy: the same lazy semantics on the full table,
        a row touched where its gradient has a nonzero element (a row whose
        gradient is exactly zero only skips its lazy decay)."""
        lr = self.schedule(step)
        count = step + 1
        for name, table in tables.items():
            g, st = dense_grads[name], tstate[name]
            touched = (g != 0).any(-1, keepdim=True)
            if self.kind == "adam":
                if self.weight_decay:
                    g = g + torch.where(touched, self.weight_decay * table, 0.0)
                mu = torch.where(touched, self.b1 * st["mu"] + (1 - self.b1) * g, st["mu"])
                nu = torch.where(touched, self.b2 * st["nu"] + (1 - self.b2) * g * g, st["nu"])
                st["mu"].copy_(mu)
                st["nu"].copy_(nu)
                upd = torch.where(touched, self._adam(mu, nu, count), 0.0)
            else:
                if self.kind == "rowwise_adagrad":
                    st["acc"].add_((g * g).mean(-1, keepdim=True))
                else:
                    st["acc"].addcmul_(g, g)
                upd = self._scaled(g, st["acc"])
                if self.weight_decay:
                    upd = upd + torch.where(touched, self.weight_decay * table, 0.0)
            table.sub_(lr * upd)


def multi_feature_lookup(table: torch.Tensor, *ids: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Per-feature gathers from one table (the trunk's ``gather``: negative
    ids count from the end, then clamp; an id out of range after that adds
    no gradient, as in JAX's ``.at[ids].add``) whose backward is ONE
    ``table_grad`` over every feature's ids and cotangents, read in place
    as segments (a sum in a fixed order, not indexing's serial one),
    instead of one per feature.
    Mean-pooled sequences pass their ids transposed (S, B), as the trunk
    asks for them."""
    return TableLookup.apply(table, *ids)


# Per-table strategy: the gathered path's dedup sort and extra scatters only
# pay off when the table is much larger than the batch's id count; below this
# vocab / ids ratio the masked-dense strategy is used.
GATHERED_MIN_VOCAB_RATIO = 4.0


def choose_strategy(vocab_rows: int, flat_ids: int) -> str:
    return "gathered" if vocab_rows > GATHERED_MIN_VOCAB_RATIO * flat_ids else "masked_dense"


def make_table_optimizer(cfg: TrainConfig, schedule: Callable[[int], float]) -> TableOptimizer | None:
    """None for dense tables; else the kind's optimizer on ``schedule``
    scaled by ``cfg.resolved_table_lr_scale()`` (10 for the adagrad family
    by default)."""
    if cfg.table_optimizer == "dense":
        return None
    scale = cfg.resolved_table_lr_scale()
    if scale != 1.0:
        base = schedule
        schedule = lambda step: scale * base(step)  # noqa: E731
    return TableOptimizer(kind=cfg.table_optimizer, schedule=schedule,
                          weight_decay=cfg.weight_decay)


def remap_batch(fm, feats: dict[str, torch.Tensor], tables: dict[str, torch.Tensor],
                only=None, data=None, rows: dict[str, int] | None = None
                ) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """Dedup each table's batch ids once and rewrite its id features to
    row-buffer indices (``only``: the tables to remap, default all).

    The pad id 0 is forced in at the head of each table's ids, and negative
    ids are clamped to it, so ``uids[0] == 0`` and remap(0) == 0: the ``ids
    == 0`` pad mask of pooling and attention survives (valid while every
    sequence pad_id is 0, which the Trainer checks). Returns (remapped
    feats, uids per table).

    ``data``, a data-parallel step's ``DataSlice``: each table's ids are
    gathered from every rank (one buffer of the local batch's static size
    a rank) and deduplicated together, so that every rank holds the global
    batch's uids, as one process over the global batch does (with up to
    world - 1 more sentinel slots); the feats index into them. ``rows``:
    each table's whole row count, where ``tables`` hold shards of them."""
    plan: dict[str, list] = {}
    flats: dict[str, list[torch.Tensor]] = {}
    for f in fm.features:
        if f.type not in (FeatureType.CATEGORICAL, FeatureType.SEQUENCE) or f.name not in feats:
            continue
        t = fm.table_of[f.name]
        if only is not None and t not in only:
            continue
        ids = feats[f.name].to(torch.int64).clamp(min=0)
        if t not in flats:
            flats[t] = [torch.zeros(1, dtype=torch.int64, device=ids.device)]
            plan[t] = []
        plan[t].append((f.name, sum(a.numel() for a in flats[t]), ids.shape))
        flats[t].append(ids.reshape(-1))
    out = dict(feats)
    uids: dict[str, torch.Tensor] = {}
    for t, arrs in flats.items():
        flat, base = torch.cat(arrs), 0
        if data is not None:
            base = data.rank * flat.numel()
            flat = data_parallel.all_gather(flat, data).reshape(-1)
        uids[t], inv = dedup_ids_inverse(flat, tables[t].shape[0] if rows is None else rows[t])
        for name, start, shape in plan[t]:
            out[name] = inv[base + start : base + start + shape.numel()].reshape(shape)
    return out, uids
