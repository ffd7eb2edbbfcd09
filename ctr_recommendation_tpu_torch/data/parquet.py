"""The parts of the JAX package's data/parquet.py that the port uses: the
columnar split container, the list-column padding of the pipeline's decode
and ``load_split``. ``pyarrow`` is imported only by the functions that read
arrow data.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ctr_recommendation_tpu_torch.config.schema import FeatureType
from ctr_recommendation_tpu_torch.features.feature_map import FeatureMap


@dataclasses.dataclass
class TableData:
    """One split, fully columnar: name -> (N,) or (N, S) numpy array."""

    columns: dict[str, np.ndarray]
    num_rows: int


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


def _pad_list_column(col, max_len: int, pad_id: int) -> np.ndarray:
    """Pad a pyarrow list column to (N, max_len) int32, keeping the LAST
    max_len events (the reference's dataloader.py:113-115 semantics)."""
    import pyarrow as pa

    arr = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
    if isinstance(arr, (pa.ListArray, pa.LargeListArray)) and arr.null_count == 0:
        offsets = np.asarray(arr.offsets, dtype=np.int64)
        values = np.asarray(arr.values, dtype=np.int64)
        return pad_from_offsets(values, offsets, max_len, pad_id)
    out = np.full((len(arr), max_len), pad_id, dtype=np.int32)
    for r, s in enumerate(arr.to_pylist()):
        s = np.asarray(s or [], dtype=np.int64)[-max_len:]
        if s.size:
            out[r, max_len - s.size :] = s
    return out


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
