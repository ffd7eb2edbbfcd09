"""Device-resident item feature store.

The dense item matrix is uploaded to device memory ONCE and the per-batch
item join is a gather on the device: batches carry only ids. Unknown but
in-range ids hit rows the host store already zero-filled; negative and
out-of-range ids are masked to zero rows explicitly (the reference's
tolerant Prediction.py:39-42 semantics).
"""

from __future__ import annotations

import torch

from ctr_recommendation_tpu_torch.config.schema import FeatureType
from ctr_recommendation_tpu_torch.data.item_store import ItemStore


class DeviceItemStore:
    def __init__(self, emb: torch.Tensor):
        self.emb = emb  # (max_id + 1, dim) float32, zeros at unknown rows

    @classmethod
    def from_host(cls, store: ItemStore, device: torch.device) -> "DeviceItemStore":
        return cls(torch.as_tensor(store.emb, dtype=torch.float32).to(device))

    @property
    def dim(self) -> int:
        """Width of an item's dense vector."""
        return self.emb.shape[1]

    def lookup(self, ids: torch.Tensor) -> torch.Tensor:
        """Gather with zero rows for negative or out-of-range ids."""
        v = self.emb.shape[0]
        rows = self.emb[ids.clamp(0, v - 1)]
        oob = (ids < 0) | (ids >= v)
        return rows.masked_fill(oob[..., None], 0.0)


def device_join(
    feats: dict, mm_tables: dict, join_plan: list[tuple[str, str]]
) -> dict:
    """Item join on the device: dense features gathered from the resident
    item matrix by id, zeros for out-of-range ids."""
    for dense_name, id_key in join_plan:
        if dense_name in feats or dense_name not in mm_tables:
            continue
        feats[dense_name] = DeviceItemStore(mm_tables[dense_name]).lookup(
            feats[id_key].to(torch.int64)
        )
    return feats


def dense_join_plan(feature_map) -> list[tuple[str, str]]:
    """[(dense_feature_name, id_feature_name)] pairs for the on-device join:
    each dense feature joins on the categorical feature sharing its source
    tag (item_emb_d128 joins on item_id for MicroLens)."""
    plans = []
    for f in feature_map.features_of_type(FeatureType.DENSE_EMBEDDING):
        if f.source is None:
            # no source tag -> no join key; the dense feature must arrive in
            # the batch itself (never silently join on an unrelated id column)
            continue
        id_key = None
        for g in feature_map.features:
            if g.type == FeatureType.CATEGORICAL and g.source == f.source:
                id_key = g.name
                break
        if id_key is not None:
            plans.append((f.name, id_key))
    return plans
