"""The parts of the JAX package's data/parquet.py that the serving path uses:
the columnar split container and the list-column padding of the pipeline's
decode. ``pyarrow`` is imported only by the function that reads arrow data.
"""

from __future__ import annotations

import dataclasses

import numpy as np


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
