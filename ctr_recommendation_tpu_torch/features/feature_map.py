"""FeatureMap: compiled view of a dataset's feature schema.

Resolves shared-table references, assigns each active feature a slot in the
interaction-field stack, and enumerates the embedding tables that must be
allocated (and, in the distributed case, row-sharded). This replaces the
reference's hardcoded field count / vocab sizes (model_fibinet.py:100-113)
with something actually derived from config.
"""

from __future__ import annotations

import dataclasses

from ctr_recommendation_tpu_torch.config.schema import DatasetConfig, FeatureSpec, FeatureType


@dataclasses.dataclass(frozen=True)
class TableSpec:
    """One embedding table to allocate: ``(vocab_size, embedding_dim)``."""

    name: str  # named after the first feature that owns it
    vocab_size: int
    pad_id: int | None  # row zeroed at init & kept out of gradient updates
    # Hash-trick table: ids are hashed on device into [1, vocab_size) before
    # lookup (FeatureSpec.hash_buckets); vocab_size == the bucket count.
    hashed: bool = False


@dataclasses.dataclass(frozen=True)
class FeatureMap:
    dataset_id: str
    features: tuple[FeatureSpec, ...]  # active, model-visible, in field order
    tables: tuple[TableSpec, ...]
    # feature name -> owning table name (after share_embedding resolution)
    table_of: dict[str, str]
    label: str

    @property
    def num_fields(self) -> int:
        """Fields entering the interaction stack (each feature = 1 field;
        sequence features contribute their pooled vector)."""
        return len(self.features)

    @property
    def num_pairs(self) -> int:
        f = self.num_fields
        return f * (f - 1) // 2

    def table(self, name: str) -> TableSpec:
        for t in self.tables:
            if t.name == name:
                return t
        raise KeyError(name)

    def features_of_type(self, ftype: FeatureType) -> tuple[FeatureSpec, ...]:
        return tuple(f for f in self.features if f.type == ftype)

    @property
    def field_names(self) -> tuple[str, ...]:
        return tuple(f.name for f in self.features)


def build_feature_map(dataset: DatasetConfig) -> FeatureMap:
    model_visible = tuple(
        f
        for f in dataset.features
        if f.active and f.type not in (FeatureType.META, FeatureType.LABEL)
    )
    by_name = {f.name: f for f in dataset.features}

    def _owner(f: FeatureSpec) -> FeatureSpec:
        seen: set[str] = set()
        while f.share_embedding is not None:
            if f.name in seen:
                raise ValueError(f"share_embedding cycle at {f.name!r}")
            seen.add(f.name)
            f = by_name[f.share_embedding]
        return f

    tables: list[TableSpec] = []
    table_of: dict[str, str] = {}
    for f in model_visible:
        if f.type not in (FeatureType.CATEGORICAL, FeatureType.SEQUENCE):
            continue
        owner = _owner(f)
        vocab = owner.hash_buckets or owner.vocab_size
        if vocab is None:
            raise ValueError(
                f"table owner {owner.name!r} has no vocab_size or hash_buckets"
            )
        table_of[f.name] = owner.name
        if all(t.name != owner.name for t in tables):
            # A table gets a pad row iff any user of it declares one (e.g. the
            # item table: padding_idx=0 at model_fibinet.py:100 is required by
            # the sequence user even though plain item_id lookups ignore it).
            users = [g for g in model_visible if _owner(g).name == owner.name]
            seq_pads = {
                g.pad_id for g in users if g.type == FeatureType.SEQUENCE
            }
            if len(seq_pads) > 1:
                raise ValueError(
                    f"sequence features sharing table {owner.name!r} declare "
                    f"conflicting pad_ids {sorted(seq_pads)}; the table can "
                    "zero/freeze only one pad row"
                )
            pad_id = next(iter(seq_pads)) if seq_pads else None
            if owner.hash_buckets is not None and pad_id not in (None, 0):
                # FeatureSpec.__post_init__ can only check a SEQUENCE that
                # hashes itself; a sequence share_embedding-ing a hashed
                # categorical owner resolves its pad here — enforce at the
                # final TableSpec so hashed ids (which land in [1, buckets))
                # can never collide with a nonzero zeroed/masked pad row.
                raise ValueError(
                    f"table {owner.name!r} is hashed but sequence users "
                    f"declare pad_id {pad_id}: hashed ids land in "
                    "[1, buckets), so only row 0 can be the pad row "
                    "(a nonzero pad would silently mask real hashed ids)"
                )
            tables.append(
                TableSpec(
                    name=owner.name,
                    vocab_size=vocab,
                    pad_id=pad_id,
                    hashed=owner.hash_buckets is not None,
                )
            )

    return FeatureMap(
        dataset_id=dataset.dataset_id,
        features=model_visible,
        tables=tuple(tables),
        table_of=table_of,
        label=dataset.label,
    )
