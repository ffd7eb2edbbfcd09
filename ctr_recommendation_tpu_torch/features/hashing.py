"""On-device id hashing (the "hash trick") for unbounded vocabularies.

Port of the JAX package's features/hashing.py, same function:

    h(id) = (uint32(id) * 2654435761) % (buckets - 1) + 1      in [1, buckets)

with the pad id mapped to itself. PyTorch has no full uint32 arithmetic, so
the multiply runs in int64 masked to 32 bits. The constant is split into two
16-bit halves so no partial product leaves int64 (a 32 x 32-bit product
would overflow the signed 64-bit range).
"""

from __future__ import annotations

import torch

from ctr_recommendation_tpu_torch.config.schema import FeatureType
from ctr_recommendation_tpu_torch.features.feature_map import FeatureMap

_KNUTH = 2654435761  # 2^32 / golden ratio, odd
_MASK32 = 0xFFFFFFFF


def hash_ids(ids: torch.Tensor, buckets: int, pad_id: int = 0) -> torch.Tensor:
    """(any int dtype) -> int32 rows in [1, buckets); pad_id maps to itself."""
    u = ids.to(torch.int64) & _MASK32  # uint32(id): two's-complement wrap
    lo = u * (_KNUTH & 0xFFFF)
    hi = ((u * (_KNUTH >> 16)) & 0xFFFF) << 16
    h = (lo + hi) & _MASK32
    h = (h % (buckets - 1) + 1).to(torch.int32)
    return torch.where(ids == pad_id, torch.full_like(h, pad_id), h)


def hash_plan(fm: FeatureMap) -> list[tuple[str, int, int]]:
    """[(feature name, buckets, pad_id)] for features whose table is hashed."""
    plan = []
    for f in fm.features:
        if f.type not in (FeatureType.CATEGORICAL, FeatureType.SEQUENCE):
            continue
        t = fm.table(fm.table_of[f.name])
        if t.hashed:
            plan.append((f.name, t.vocab_size, t.pad_id if t.pad_id is not None else 0))
    return plan


def apply_hashing(feats: dict, plan: list[tuple[str, int, int]]) -> dict:
    if not plan:
        return feats
    out = dict(feats)
    for name, buckets, pad_id in plan:
        if name in out:
            out[name] = hash_ids(out[name], buckets, pad_id)
    return out
