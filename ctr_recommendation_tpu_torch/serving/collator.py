"""Request rows -> fixed-shape scoring batches (the JAX package's
serving/collator.py on the port).

Online requests arrive as JSON rows ({"item_id": 7, "item_seq": [3, 9], ...}).
The Predictor takes the same columnar batch the offline path feeds it
(data/parquet.py's batch contract): int32 (B,) categoricals, (B, S)
left-padded sequences, optional (B, D) dense vectors, plus a ``__weight__``
mask marking pad rows. The collator rounds every batch up to a fixed menu of
bucket sizes, so the card sees a handful of batch shapes, each warmed once.
It works on the host, in numpy only.
"""

from __future__ import annotations

import numpy as np

from ctr_recommendation_tpu_torch.config.schema import FeatureType
from ctr_recommendation_tpu_torch.data.parquet import _pad_sequences
from ctr_recommendation_tpu_torch.features.feature_map import FeatureMap

DEFAULT_BUCKETS = (16, 64, 256, 1024, 4096, 8192)


class RequestCollator:
    """Collate request rows into the Predictor's columnar batch contract."""

    def __init__(self, fm: FeatureMap, buckets: tuple[int, ...] = DEFAULT_BUCKETS):
        if not buckets or any(b <= 0 for b in buckets):
            raise ValueError(f"invalid bucket sizes: {buckets}")
        self.fm = fm
        self.buckets = tuple(sorted(set(buckets)))
        # model-visible input columns (PLACEHOLDER fields contribute a zeros
        # embedding and read no column; LABEL/META never reach the model)
        self.features = tuple(
            f
            for f in fm.features
            if f.type
            in (FeatureType.CATEGORICAL, FeatureType.SEQUENCE, FeatureType.DENSE_EMBEDDING)
        )

    @property
    def max_batch(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(
            f"request of {n} rows exceeds the largest bucket {self.buckets[-1]}; split it "
            "client-side or add a larger bucket (--buckets)"
        )

    def _id_limit(self, f) -> int | None:
        """Upper bound (exclusive) for raw request ids of feature ``f``: the
        feature map's vocab, not the port's 128-padded table rows; None when
        any int is acceptable (a hashed table hashes ids on the device into
        [1, buckets) whatever the raw value)."""
        t = self.fm.table(self.fm.table_of[f.name])
        return None if t.hashed else t.vocab_size

    def validate_chunk(self, rows: list[dict]) -> frozenset:
        """Full request validation WITHOUT allocating a padded batch.

        Returns the chunk's dense-column signature (the DENSE_EMBEDDING
        names supplied by every row), so that the micro-batcher can group
        compatible chunks before merging them into one dispatch: a
        malformed or structurally different request must never fail the
        requests that arrived beside it.

        Checks, each raising ValueError:
        * every row is a JSON object (dict);
        * categorical/sequence ids of NON-hashed tables lie in
          [0, vocab_size): the embedding gather clamps an out-of-range id to
          a table row, which would answer 200 with a wrong probability (the
          device item join zero-masks such ids, the lookup does not);
        * dense columns are all-or-none across the chunk and each vector
          has exactly ``dense_dim`` floats.
        """
        if not rows:
            raise ValueError("empty request: no rows to score")
        for i, r in enumerate(rows):
            if not isinstance(r, dict):
                raise ValueError(
                    f"row {i}: expected an object {{feature: value}}, got {type(r).__name__}"
                )
        sig: set[str] = set()
        for f in self.features:
            if f.type == FeatureType.CATEGORICAL:
                limit = self._id_limit(f)
                for i, r in enumerate(rows):
                    v = int(r.get(f.name, 0))
                    if limit is not None and not 0 <= v < limit:
                        raise ValueError(
                            f"column {f.name!r} row {i}: id {v} outside [0, {limit}); "
                            "pre-encode ids to the model's vocabulary"
                        )
            elif f.type == FeatureType.SEQUENCE:
                limit = self._id_limit(f)
                for i, r in enumerate(rows):
                    for v in r.get(f.name) or []:
                        v = int(v)
                        if limit is not None and not 0 <= v < limit:
                            raise ValueError(
                                f"column {f.name!r} row {i}: id {v} outside [0, {limit}); "
                                "pre-encode ids to the model's vocabulary"
                            )
            else:  # DENSE_EMBEDDING
                present = [f.name in r for r in rows]
                if not any(present):
                    continue
                if not all(present):
                    raise ValueError(
                        f"column {f.name!r}: supplied by only {sum(present)}/{len(rows)} "
                        "rows; send it on every row or on none (server-side join)"
                    )
                for i, r in enumerate(rows):
                    v = np.asarray(r[f.name], np.float32)
                    if v.shape != (f.dense_dim,):
                        raise ValueError(
                            f"column {f.name!r} row {i}: expected {f.dense_dim} floats, "
                            f"got shape {v.shape}"
                        )
                sig.add(f.name)
        return frozenset(sig)

    def collate(self, rows: list[dict]) -> tuple[dict[str, np.ndarray], int]:
        """rows -> (columnar batch padded to a bucket, n_valid).

        DENSE_EMBEDDING columns may be omitted entirely (the Predictor's
        device item join fills them from the id column, the reference's
        tolerant Prediction.py:39-42 semantics); if ANY row supplies one,
        every row must, so a batch never mixes client vectors with joins.
        """
        dense_sig = self.validate_chunk(rows)
        n = len(rows)
        padded = self.bucket_for(n)
        batch: dict[str, np.ndarray] = {}
        for f in self.features:
            if f.type == FeatureType.CATEGORICAL:
                col = np.zeros((padded,), np.int64)
                for i, r in enumerate(rows):
                    col[i] = int(r.get(f.name, 0))
                if self._id_limit(f) is None:
                    # hashed tables accept ANY int id; the device hash reads
                    # the value as uint32 (features/hashing.py::hash_ids), so
                    # wrap to the matching int32 bit pattern. An id = 0 mod
                    # 2^32 lands on the pad row, as in a hash-trick table.
                    col = col.astype(np.uint32)
                batch[f.name] = col.astype(np.int32)
            elif f.type == FeatureType.SEQUENCE:
                seqs = [r.get(f.name) or [] for r in rows]
                if self._id_limit(f) is None:  # the same uint32 wrap
                    seqs = [
                        np.asarray(s, np.int64).astype(np.uint32).astype(np.int32) for s in seqs
                    ]
                seqs += [[] for _ in range(padded - n)]
                batch[f.name] = _pad_sequences(seqs, f.max_len, f.pad_id or 0)
            else:  # DENSE_EMBEDDING
                if f.name not in dense_sig:
                    continue  # the device join fills it from the source id
                col = np.zeros((padded, f.dense_dim), np.float32)
                for i, r in enumerate(rows):
                    col[i] = np.asarray(r[f.name], np.float32)
                batch[f.name] = col
        w = np.zeros((padded,), np.float32)
        w[:n] = 1.0
        batch["__weight__"] = w
        return batch, n
