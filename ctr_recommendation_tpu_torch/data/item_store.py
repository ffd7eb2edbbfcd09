"""Dense item-side feature store.

The reference joins the frozen 128-d multimodal vectors into every batch with
a pandas ``.loc`` on the CPU hot path (dataloader.py:91-95 — flagged as a
known hot spot in SURVEY §3.1). Here the join is done ONCE up front: the
item_info parquet is compiled into a dense ``(max_item_id + 1, dim)`` float32
matrix indexed directly by item_id, placed on device, and the per-batch
lookup becomes a device gather (data/device_store.py).

Unknown / missing items resolve to zero vectors — the *tolerant* semantics of
the reference's inference path (Prediction.py:39-42) applied everywhere
(training raises only if ``strict=True``, reproducing dataloader.py:104-106
when explicitly requested).
"""

from __future__ import annotations

import numpy as np


class ItemStore:
    """item_id -> dense feature vector, zeros for unknown ids."""

    def __init__(self, emb: np.ndarray, known_mask: np.ndarray):
        self.emb = emb  # (max_id + 1, dim) float32
        self.known_mask = known_mask  # (max_id + 1,) bool

    @property
    def dim(self) -> int:
        return self.emb.shape[1]

    @classmethod
    def from_parquet(
        cls,
        path: str,
        id_col: str = "item_id",
        emb_col: str = "item_emb_d128",
        max_item_id: int | None = None,
    ) -> "ItemStore":
        import pyarrow as pa
        import pyarrow.parquet as pq

        table = pq.read_table(path, columns=[id_col, emb_col])
        ids = table.column(id_col).to_numpy()
        col = table.column(emb_col)
        arr = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
        if isinstance(arr, (pa.ListArray, pa.LargeListArray)) and arr.null_count == 0:
            # zero-copy path over the raw list buffers (fixed-width vectors)
            offsets = np.asarray(arr.offsets, dtype=np.int64)
            widths = np.diff(offsets)
            if len(widths) and (widths == widths[0]).all():
                vecs = np.asarray(arr.values, dtype=np.float32).reshape(
                    len(ids), int(widths[0])
                )
                return cls.from_arrays(ids, vecs, max_item_id=max_item_id)
        emb_list = arr.to_pylist()
        dim = len(emb_list[0])
        vecs = np.asarray(emb_list, dtype=np.float32).reshape(len(ids), dim)
        return cls.from_arrays(ids, vecs, max_item_id=max_item_id)

    @classmethod
    def from_arrays(
        cls, ids: np.ndarray, vecs: np.ndarray, max_item_id: int | None = None
    ) -> "ItemStore":
        top = int(max(ids.max(initial=0), max_item_id or 0))
        dim = vecs.shape[1]
        emb = np.zeros((top + 1, dim), dtype=np.float32)
        known = np.zeros((top + 1,), dtype=bool)
        emb[ids] = vecs
        known[ids] = True
        return cls(emb, known)

    def lookup(self, item_ids: np.ndarray, strict: bool = False) -> np.ndarray:
        """Vectorized join; ids beyond the table or unseen resolve to zeros."""
        clipped = np.clip(item_ids, 0, self.emb.shape[0] - 1)
        if strict:
            in_range = (item_ids >= 0) & (item_ids < self.emb.shape[0])
            ok = in_range & self.known_mask[clipped]
            if not ok.all():
                bad = np.unique(item_ids[~ok])[:10]
                raise KeyError(f"item_ids not in item_info: {bad.tolist()}")
        out = self.emb[clipped]
        oob = (item_ids < 0) | (item_ids >= self.emb.shape[0])
        if oob.any():
            out = np.where(oob[..., None], 0.0, out)
        return out
