"""The JAX package's data/parquet.py on the port: the columnar split
container (with per-host ``shard`` and ``take``), the list-column padding of
the pipeline's decode and of the serving collator's requests,
``load_split`` and ``iter_batches``, the host-side batch assembly of
``Trainer.fit``. ``pyarrow`` is imported only by the
functions that read arrow data.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from ctr_recommendation_tpu_torch.config.schema import FeatureType
from ctr_recommendation_tpu_torch.features.feature_map import FeatureMap


@dataclasses.dataclass
class TableData:
    """One split, fully columnar: name -> (N,) or (N, S) numpy array."""

    columns: dict[str, np.ndarray]
    num_rows: int

    def shard(self, index: int, count: int) -> "TableData":
        """Every ``count``-th row from ``index``: one host's disjoint share."""
        if count <= 1:
            return self
        cols = {k: v[index::count] for k, v in self.columns.items()}
        n = len(next(iter(cols.values()))) if cols else 0
        return TableData(cols, n)

    def take(self, idx: np.ndarray) -> dict[str, np.ndarray]:
        return {k: v[idx] for k, v in self.columns.items()}


def pad_from_offsets(
    values: np.ndarray, offsets: np.ndarray, max_len: int, pad_id: int
) -> np.ndarray:
    """Arrow list buffers -> (n_rows, max_len) int32 keeping the LAST max_len
    entries of each row, left-padded with pad_id."""
    offsets = np.asarray(offsets, dtype=np.int64)
    n_rows = len(offsets) - 1
    out = np.full((n_rows, max_len), pad_id, dtype=np.int32)
    lens = np.minimum(np.diff(offsets), max_len)
    # slot s of row r holds values[end_r - max_len + s] where that is >= start
    pos = np.arange(max_len)[None, :]
    src = offsets[1:, None] - max_len + pos
    keep = pos >= (max_len - lens)[:, None]
    out[keep] = np.asarray(values)[src[keep]]
    return out


def _pad_sequences(seqs, max_len: int, pad_id: int) -> np.ndarray:
    """list-of-lists -> (N, max_len) int32 keeping the LAST max_len entries,
    left-padded with pad_id (the serving collator's request histories)."""
    out = np.full((len(seqs), max_len), pad_id, dtype=np.int32)
    for r, s in enumerate(seqs):
        s = np.asarray(s, dtype=np.int64)[-max_len:]
        if s.size:
            out[r, max_len - s.size :] = s
    return out


def _pad_list_column(col, max_len: int, pad_id: int) -> np.ndarray:
    """Pad a pyarrow list column to (N, max_len) int32, keeping the LAST
    max_len events (the reference's dataloader.py:113-115 semantics)."""
    import pyarrow as pa

    arr = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
    if isinstance(arr, (pa.ListArray, pa.LargeListArray)) and arr.null_count == 0:
        offsets = np.asarray(arr.offsets, dtype=np.int64)
        values = np.asarray(arr.values, dtype=np.int64)
        return pad_from_offsets(values, offsets, max_len, pad_id)
    return _pad_sequences([s or [] for s in arr.to_pylist()], max_len, pad_id)


def load_split(
    path: str,
    feature_map: FeatureMap,
    *,
    include_label: bool = True,
    columns: list[str] | None = None,
) -> TableData:
    """Read one parquet split into fixed-shape columnar arrays: sequences
    padded to (N, max_len) int32, ids int32, the label fp32. Dense item
    features are not read (they are joined from the ItemStore on the device)."""
    import pyarrow.parquet as pq

    wanted = columns or [
        f.name for f in feature_map.features if f.type != FeatureType.DENSE_EMBEDDING
    ]
    if include_label:
        wanted = wanted + [feature_map.label]
    pf = pq.ParquetFile(path)
    available = set(pf.schema_arrow.names)
    wanted = [c for c in wanted if c in available]
    table = pf.read(columns=wanted)

    spec_by_name = {f.name: f for f in feature_map.features}
    cols: dict[str, np.ndarray] = {}
    for name in wanted:
        col = table.column(name)
        spec = spec_by_name.get(name)
        if spec is not None and spec.type == FeatureType.SEQUENCE:
            cols[name] = _pad_list_column(col, spec.max_len, spec.pad_id)
        elif name == feature_map.label:
            cols[name] = col.to_numpy(zero_copy_only=False).astype(np.float32)
        else:
            arr = col.to_numpy(zero_copy_only=False)
            if arr.dtype == object:  # list column not declared as sequence
                arr = np.asarray([np.asarray(v) for v in arr])
            arr = arr.astype(np.int32 if np.issubdtype(arr.dtype, np.integer) else np.float32)
            cols[name] = arr
    return TableData(cols, table.num_rows)


def batch_rows(order: np.ndarray, start: int, batch_size: int, *, drop_last: bool,
               pad_final: bool = True) -> tuple[np.ndarray, np.ndarray] | None:
    """(row indices, ``__weight__``) of the batch at ``start`` of ``order``;
    a short last batch is None under ``drop_last``, else padded at weight 0
    with the row at index 0 (``pad_final``) or left short."""
    idx = order[start : start + batch_size]
    if len(idx) < batch_size:
        if drop_last:
            return None
        if pad_final:
            pad = np.zeros(batch_size - len(idx), dtype=idx.dtype)
            weight = np.concatenate(
                [np.ones(len(idx), np.float32), np.zeros(len(pad), np.float32)])
            return np.concatenate([idx, pad]), weight
    return idx, np.ones(len(idx), np.float32)


def host_join(batch: dict[str, np.ndarray], join_plan, item_store, strict: bool) -> dict:
    """The item join on the host: each dense feature of ``join_plan``
    looked up by its id column (``ItemStore.lookup``: zeros for unknown ids,
    a KeyError for them under ``strict``)."""
    for dense_name, id_key in join_plan:
        batch[dense_name] = item_store.lookup(batch[id_key], strict=strict)
    return batch


def iter_batches(
    data: TableData,
    feature_map: FeatureMap,
    batch_size: int,
    *,
    shuffle: bool = False,
    seed: int = 0,
    epoch: int = 0,
    drop_last: bool = False,
    pad_final: bool = True,
    item_store=None,
    strict_items: bool = False,
) -> Iterator[dict[str, np.ndarray]]:
    """Yield fixed-shape batch dicts (+ a ``__weight__`` validity mask).

    Shuffling is a seeded full permutation per (seed, epoch). A short last
    batch is dropped (``drop_last``), padded with weight-0 rows
    (``pad_final``) or yielded short. With an ``item_store`` the dense item
    features are joined on the host, each on the categorical sharing its
    source tag (``dense_join_plan``, the device join's rule)."""
    from ctr_recommendation_tpu_torch.data.device_store import dense_join_plan

    n = data.num_rows
    if shuffle:
        order = np.random.default_rng(np.random.SeedSequence([seed, epoch])).permutation(n)
    else:
        order = np.arange(n)
    join_plan = dense_join_plan(feature_map) if item_store is not None else []
    for start in range(0, n, batch_size):
        rows = batch_rows(order, start, batch_size, drop_last=drop_last, pad_final=pad_final)
        if rows is None:
            return
        idx, weight = rows
        batch = host_join(data.take(idx), join_plan, item_store, strict_items)
        batch["__weight__"] = weight
        yield batch
