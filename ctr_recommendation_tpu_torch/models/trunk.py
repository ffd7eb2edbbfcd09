"""Shared embedding trunk: FeatureMap -> (B, F, E) field stack.

Embedding tables built from the feature map (shared tables, zeroed pad rows,
rows padded to a multiple of 128 as in the JAX package), dense multimodal
vectors projected through Linear -> LayerNorm -> ReLU (the reference's
model_fibinet.py:105-109), placeholder fields as zeros (:152) and sequence
fields pooled by masked mean (:165-174), by SASRec-style target-aware
attention (``sasrec_fibinet``: the history runs through the transformer
encoder, the encoder kernel when ``use_pallas``, else ``attention.encode``,
and the candidate item queries it) or by DIN's local activation unit
(``din``: ``attention.din_pool`` over the raw history).
"""

from __future__ import annotations

from typing import Callable

import torch

from ctr_recommendation_tpu_torch.config.schema import FeatureType, ModelConfig
from ctr_recommendation_tpu_torch.features.feature_map import FeatureMap
from ctr_recommendation_tpu_torch.ops import attention, pooling
from ctr_recommendation_tpu_torch.ops.cuda.sasrec_encoder import fused_encode
from ctr_recommendation_tpu_torch.ops.cuda.table_grad import MAX_SEGMENTS, table_grad
from ctr_recommendation_tpu_torch.ops.initializers import (
    embedding_init,
    linear_apply,
    linear_init,
)
from ctr_recommendation_tpu_torch.parallel import data_parallel
from ctr_recommendation_tpu_torch.parallel.embedding import round_up_vocab
from ctr_recommendation_tpu_torch.utils.profiling import span

LN_EPS = 1e-5  # torch nn.LayerNorm default


def _check_pooling(seq_pooling: str) -> None:
    if seq_pooling not in ("mean", "attention", "din"):
        raise ValueError(f"seq_pooling must be 'mean', 'attention' or 'din', got {seq_pooling!r}")


def tower_dtype(cfg: ModelConfig, compute_dtype: torch.dtype) -> torch.dtype:
    """The dtype of the layers after the trunk: fp32 when ``tower_dtype`` is
    "float32", else the trunk's compute dtype."""
    return torch.float32 if cfg.tower_dtype == "float32" else compute_dtype


def init(
    gen: torch.Generator, fm: FeatureMap, cfg: ModelConfig, *, seq_pooling: str = "mean"
) -> dict:
    _check_pooling(seq_pooling)
    e = cfg.embedding_dim
    params: dict = {"tables": {}, "dense": {}}
    for t in fm.tables:
        # rows padded to a multiple of 128 so the shapes match the JAX
        # tables (padded rows are never addressed)
        params["tables"][t.name] = embedding_init(
            gen, round_up_vocab(t.vocab_size), e, pad_id=t.pad_id,
            std=cfg.resolved_init_std(),
        )
    for f in fm.features_of_type(FeatureType.DENSE_EMBEDDING):
        params["dense"][f.name] = {
            "proj": linear_init(gen, f.dense_dim, e),
            "ln_scale": torch.ones(e),
            "ln_bias": torch.zeros(e),
        }
    if seq_pooling == "attention":
        params["attn"] = {
            f.name: attention.init(
                gen, e, f.max_len, num_heads=cfg.attn_num_heads, num_layers=cfg.attn_num_layers
            )
            for f in fm.features_of_type(FeatureType.SEQUENCE)
        }
    elif seq_pooling == "din":
        params["attn"] = {
            f.name: attention.din_init(gen, e, cfg.din_att_hidden_units)
            for f in fm.features_of_type(FeatureType.SEQUENCE)
        }
    return params


def _layer_norm(x, scale, bias):
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + LN_EPS) * scale + bias


def gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` with the JAX package's index semantics: negative ids
    count from the end, then out-of-range ids are clamped (never a device
    fault) and, as the transpose of JAX's gather drops them, contribute no
    gradient. The backward is ``table_grad``'s (ops/cuda/table_grad.py), not
    indexing's: it sums the rows of repeated ids in a fixed order (in
    shared memory for a small table, by sorting the ids for a large one),
    where the indexing backward on CUDA walks each id's repeats serially,
    and the pad id repeats tens of thousands of times in a batch of
    histories."""
    return TableLookup.apply(table, ids)[0]


def table_rows(ids: torch.Tensor, n: int) -> torch.Tensor:
    """The rows of an ``n``-row table that ``ids`` read: int64, negative ids
    counted from the end, then clamped into range."""
    return _wrap(ids, n)[1]


def _wrap(ids: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(``ids`` as int64 with negative ids counted from the end, the rows
    they read: those clamped into range)."""
    ids = ids.to(torch.int64)
    wrapped = torch.where(ids < 0, ids + n, ids)
    return wrapped, wrapped.clamp(0, n - 1)


class TableLookup(torch.autograd.Function):
    """Gathers of one table by one or more id tensors; their backward is ONE
    ``table_grad`` over the (ids, cotangent) segments as autograd leaves
    them, one an id tensor (no concatenation; past ``MAX_SEGMENTS`` the last
    ones are merged into one), into a table with one extra row that takes
    the out-of-range ids' cotangents and is cut off."""

    @staticmethod
    def forward(ctx, table, *ids):
        n = table.shape[0]
        outs, grad_rows = [], []
        for i in ids:
            wrapped, rows = _wrap(i, n)
            outs.append(table.index_select(0, rows.reshape(-1)).reshape(*rows.shape, -1))
            if ctx.needs_input_grad[0]:
                # where the cotangents land: an id still out of range after
                # the wrap lands in row n, past the table
                grad_rows.append(rows.masked_fill(rows != wrapped, n))
        ctx.save_for_backward(*grad_rows)
        ctx.num_rows = n
        return tuple(outs)

    @staticmethod
    def backward(ctx, *cots):
        ids = ctx.saved_tensors
        segs = list(zip(ids, cots))
        if len(segs) > MAX_SEGMENTS:
            e = cots[0].shape[-1]
            tail = segs[MAX_SEGMENTS - 1:]
            segs[MAX_SEGMENTS - 1:] = [(torch.cat([i.reshape(-1) for i, _ in tail]),
                                        torch.cat([c.reshape(-1, e) for _, c in tail]))]
        dtable = table_grad(segs, ctx.num_rows + 1)
        return (dtable[: ctx.num_rows],) + (None,) * len(ids)


def _default_lookup(tables, name, ids, feature=None, batch_dim=0):
    return gather(tables[name], ids)


def apply(
    params: dict,
    fm: FeatureMap,
    cfg: ModelConfig,
    batch: dict[str, torch.Tensor],
    *,
    seq_pooling: str = "mean",
    compute_dtype: torch.dtype = torch.float32,
    train: bool = False,
    generator: torch.Generator | None = None,
    lookup: Callable | None = None,
) -> torch.Tensor:
    """batch dict -> field stack (B, F, E) in compute_dtype, fields in
    feature-map order. Mean-pooled sequences are gathered transposed,
    (S, B, E), and reduced over the leading axis by ``masked_mean_t``;
    attention- and DIN-pooled ones in (B, S) order (``_history``), then
    encoded and pooled by ``attention.target_pool``, or pooled by
    ``attention.din_pool``, with the candidate item as the query. In train
    mode with a ``generator`` the encoder's dropout draws its seed from it
    (``_attention_field``); DIN draws nothing.

    ``lookup(tables, table_name, ids, feature=<feature name>, batch_dim=0)``
    replaces the embedding gather (default ``gather``): the train step
    injects its merged-backward and row-buffer lookups here. The ids a
    feature passes are exactly ``batch[f.name]``, transposed (S, B) with
    ``batch_dim=1`` for mean-pooled sequences, so a lookup may match
    pre-gathered embeddings to callers by (feature, shape). While a profiler
    runs, the call is the span ``trunk`` (``utils/profiling.py``)."""
    _check_pooling(seq_pooling)
    with span("trunk"):
        return _fields(params, fm, cfg, batch, seq_pooling, compute_dtype, train, generator,
                       lookup or _default_lookup)


def _fields(params, fm, cfg, batch, seq_pooling, compute_dtype, train, generator, lookup):
    """``apply``'s field stack."""
    e = cfg.embedding_dim
    batch_size = next(
        (batch[f.name].shape[0] for f in fm.features if f.name in batch), None
    )
    if batch_size is None:
        raise ValueError("batch contains none of the feature-map features")
    device = next(iter(params["tables"].values())).device

    field_of: dict[str, torch.Tensor] = {}  # feature name -> its field
    for f in fm.features:
        if f.type == FeatureType.PLACEHOLDER:
            field = torch.zeros(batch_size, e, dtype=compute_dtype, device=device)
        elif f.type == FeatureType.CATEGORICAL:
            emb = lookup(params["tables"], fm.table_of[f.name], batch[f.name], feature=f.name)
            field = emb.to(compute_dtype)
        elif f.type == FeatureType.DENSE_EMBEDDING:
            p = params["dense"][f.name]
            h = linear_apply(p["proj"], batch[f.name].float())
            h = _layer_norm(h, p["ln_scale"], p["ln_bias"])
            field = torch.relu(h).to(compute_dtype)
        elif f.type == FeatureType.SEQUENCE and seq_pooling == "mean":
            seq_ids_t = batch[f.name].t()
            seq_emb = lookup(params["tables"], fm.table_of[f.name], seq_ids_t, feature=f.name,
                             batch_dim=1)
            field = pooling.masked_mean_t(seq_emb.to(compute_dtype), seq_ids_t, f.pad_id)
        elif f.type == FeatureType.SEQUENCE and seq_pooling == "din":
            seq_ids, seq_emb, target = _history(params, fm, batch, f, field_of, compute_dtype,
                                                lookup)
            field = attention.din_pool(params["attn"][f.name], seq_emb, seq_ids, target,
                                       pad_id=f.pad_id)
        elif f.type == FeatureType.SEQUENCE:
            field = _attention_field(params, fm, cfg, batch, f, field_of, compute_dtype,
                                     train, generator, lookup)
        else:
            raise ValueError(f"unsupported feature type {f.type}")
        field_of[f.name] = field
    return torch.stack(list(field_of.values()), dim=1)


def _history(params, fm, batch, f, field_of, compute_dtype, lookup):
    """(ids (B, S), embeddings (B, S, E) in compute_dtype, the query (B, E))
    of sequence feature ``f``, gathered in (B, S) order. The query is the
    field of the CATEGORICAL feature that shares the sequence's table
    (item_id for item_seq), already gathered when it comes first; else a
    fresh lookup of that feature; else the masked mean of the history."""
    table = fm.table_of[f.name]
    seq_ids = batch[f.name]
    seq_emb = lookup(params["tables"], table, seq_ids, feature=f.name).to(compute_dtype)
    target_feat = next(
        (g.name for g in fm.features
         if g.type == FeatureType.CATEGORICAL and fm.table_of.get(g.name) == table
         and g.name in batch),
        None,
    )
    if target_feat in field_of:
        target = field_of[target_feat]
    elif target_feat is not None:
        target = lookup(params["tables"], table, batch[target_feat],
                        feature=target_feat).to(compute_dtype)
    else:
        target = pooling.masked_mean(seq_emb, seq_ids, f.pad_id)
    return seq_ids, seq_emb, target


def _attention_field(params, fm, cfg, batch, f, field_of, compute_dtype, train, generator,
                     lookup):
    """The attention-pooled field of sequence feature ``f``: the history
    (``_history``) through the encoder, then queried by the candidate.

    In train mode with a generator, one int64 dropout seed is drawn for this
    feature as a device tensor (the kernels read it through a pointer: no
    host sync), before the tower's dropout draws: the part of JAX's
    ``fold_in(rng, crc32(name))``. In a data-parallel step the masks count
    tokens from the rank's first global row times S, so that the ranks draw
    the global batch's masks."""
    seq_ids, seq_emb, target = _history(params, fm, batch, f, field_of, compute_dtype, lookup)
    p = params["attn"][f.name]
    seed = None
    if train and generator is not None:
        seed = torch.randint(0, 2**63 - 1, (1,), generator=generator, dtype=torch.int64,
                             device=generator.device)
    s = data_parallel.current()
    token0 = 0 if s is None else s.row0 * seq_ids.shape[1]
    encode = fused_encode if cfg.use_pallas else attention.encode
    encoded = encode(p, seq_emb, seq_ids, num_heads=cfg.attn_num_heads, pad_id=f.pad_id,
                     train=train, dropout_rate=cfg.attn_dropout, seed=seed, token0=token0)
    return attention.target_pool(p, encoded, seq_ids, target, pad_id=f.pad_id)
