"""Streaming parquet input for splits too large for host memory: the JAX
package's data/streaming.py on the port.

``stream_batches`` reads a split row group by row group:

* row groups are assigned round-robin per host (disjoint coverage), and
  their order is shuffled per (seed, epoch, host) (``host_row_groups``);
* the decoded record batches, projected to the columns the feature map
  reads, feed ``window_batches``: rows inside a window of ``shuffle_buffer``
  batches are permuted (a local-window shuffle, the streaming trade-off),
  the window's tail carries over, and the final batch is padded at weight 0;
* emitted batches have the structure of ``iter_batches``' (fixed shapes,
  ``__weight__`` masks, padded sequences).

``window_batches`` takes any iterable of column dicts, one per record
batch, so the same windowing runs on numpy row groups where no parquet
reader is at hand. ``pyarrow`` is imported only by the functions that read
parquet.
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np

from ctr_recommendation_tpu_torch.config.schema import FeatureType
from ctr_recommendation_tpu_torch.data.parquet import _pad_list_column, batch_rows, host_join
from ctr_recommendation_tpu_torch.features.feature_map import FeatureMap


def _record_batch_to_columns(rb, feature_map: FeatureMap, include_label: bool):
    """One arrow record batch -> columns as ``load_split`` types them."""
    spec_by_name = {f.name: f for f in feature_map.features}
    cols: dict[str, np.ndarray] = {}
    for name in rb.schema.names:
        spec = spec_by_name.get(name)
        is_label = name == feature_map.label
        if spec is None and not is_label:
            continue
        if is_label and not include_label:
            continue
        col = rb.column(name)
        if spec is not None and spec.type == FeatureType.SEQUENCE:
            cols[name] = _pad_list_column(col, spec.max_len, spec.pad_id)
        elif is_label:
            cols[name] = col.to_numpy(zero_copy_only=False).astype(np.float32)
        elif spec is not None and spec.type == FeatureType.DENSE_EMBEDDING:
            cols[name] = np.asarray(col.to_pylist(), dtype=np.float32)
        else:
            arr = col.to_numpy(zero_copy_only=False)
            integer = np.issubdtype(arr.dtype, np.integer)
            cols[name] = arr.astype(np.int32 if integer else np.float32)
    return cols


def common_step_count(path: str, batch_size: int, host_count: int = 1) -> int:
    """Per-epoch batch count every host can run in lockstep: min over hosts
    of floor(rows_h / batch_size), from the row-group sizes in the parquet
    footer, under the round-robin assignment of ``host_row_groups``."""
    import pyarrow.parquet as pq

    md = pq.ParquetFile(path).metadata
    rows_per_host = [0] * max(host_count, 1)
    for g in range(md.num_row_groups):
        rows_per_host[g % host_count] += md.row_group(g).num_rows
    return min(r // batch_size for r in rows_per_host)


def host_row_groups(num_groups: int, *, shuffle: bool, seed: int, epoch: int,
                    host_index: int = 0, host_count: int = 1
                    ) -> tuple[list[int], np.random.Generator]:
    """(this host's row groups in the epoch's order, the generator that
    shuffled them): groups ``g % host_count == host_index``, shuffled by
    ``SeedSequence([seed, epoch, host_index])`` when ``shuffle``. The same
    generator goes on to permute the windows (``window_batches``)."""
    groups = [g for g in range(num_groups) if g % host_count == host_index]
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch, host_index]))
    if shuffle:
        rng.shuffle(groups)
    return groups, rng


def window_batches(
    chunks: Iterable[dict[str, np.ndarray]],
    feature_map: FeatureMap,
    batch_size: int,
    *,
    rng: np.random.Generator,
    shuffle: bool = False,
    shuffle_buffer: int = 8,
    item_store=None,
    drop_last: bool = False,
    strict_items: bool = False,
) -> Iterator[dict[str, np.ndarray]]:
    """Fixed-shape batches from ``chunks`` (column dicts, one per record
    batch, in read order) through a shuffle window: chunks accumulate until
    the window holds ``shuffle_buffer`` batches of rows, then its rows are
    permuted by ``rng`` (when ``shuffle``) and the whole batches emitted; the
    rest carries into the next window. After the last chunk the remainder
    is emitted, its short batch dropped (``drop_last``) or padded at weight
    0. With an ``item_store`` the dense item features are joined on the
    host (``host_join``)."""
    from ctr_recommendation_tpu_torch.data.device_store import dense_join_plan

    join_plan = dense_join_plan(feature_map) if item_store is not None else []
    window: dict[str, list[np.ndarray]] = {}
    window_rows = 0
    target_window = max(batch_size * shuffle_buffer, batch_size)

    def flush(final: bool):
        nonlocal window, window_rows
        if not window_rows:
            return
        cols = {k: np.concatenate(v) for k, v in window.items()}
        n = window_rows
        order = rng.permutation(n) if shuffle else np.arange(n)
        emit_until = n if final else (n // batch_size) * batch_size
        for start in range(0, emit_until, batch_size):
            rows = batch_rows(order, start, batch_size, drop_last=drop_last)
            if rows is None:
                break
            idx, weight = rows
            batch = host_join({k: v[idx] for k, v in cols.items()}, join_plan, item_store,
                              strict_items)
            batch["__weight__"] = weight
            yield batch
        # carry the un-emitted tail into the next window
        if final:
            window, window_rows = {}, 0
        else:
            keep = order[emit_until:]
            window = {k: [v[keep]] for k, v in cols.items()}
            window_rows = len(keep)

    for cols in chunks:
        for k, v in cols.items():
            window.setdefault(k, []).append(v)
        window_rows += len(next(iter(cols.values())))
        if window_rows >= target_window:
            yield from flush(final=False)
    yield from flush(final=True)


def stream_batches(
    path: str,
    feature_map: FeatureMap,
    batch_size: int,
    *,
    shuffle: bool = False,
    seed: int = 0,
    epoch: int = 0,
    shuffle_buffer: int = 8,
    host_index: int = 0,
    host_count: int = 1,
    include_label: bool = True,
    item_store=None,
    drop_last: bool = False,
    strict_items: bool = False,
) -> Iterator[dict[str, np.ndarray]]:
    """Yield fixed-shape batch dicts without loading the split into memory:
    this host's row groups (``host_row_groups``), decoded in record batches
    of ``4 * batch_size`` rows projected to the columns the feature map
    reads, through ``window_batches``."""
    import pyarrow.parquet as pq

    pf = pq.ParquetFile(path)
    groups, rng = host_row_groups(pf.num_row_groups, shuffle=shuffle, seed=seed, epoch=epoch,
                                  host_index=host_index, host_count=host_count)
    spec_names = {f.name for f in feature_map.features}
    wanted = [c for c in pf.schema_arrow.names
              if c in spec_names or (include_label and c == feature_map.label)]
    chunks = (
        _record_batch_to_columns(rb, feature_map, include_label)
        for g in groups
        for rb in pf.iter_batches(batch_size=batch_size * 4, row_groups=[g], columns=wanted)
    )
    yield from window_batches(chunks, feature_map, batch_size, rng=rng, shuffle=shuffle,
                              shuffle_buffer=shuffle_buffer, item_store=item_store,
                              drop_last=drop_last, strict_items=strict_items)
