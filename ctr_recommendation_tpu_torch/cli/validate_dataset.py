"""Validate a user-supplied dataset directory against the data contract.

The port's copy of the JAX package's ``cli/validate_dataset.py``: the same
checks, messages and exit codes, against the port's ``config`` and
``features``. It runs on the host only (numpy, and pyarrow imported when a
file is read).

    python -m ctr_recommendation_tpu_torch.cli.validate_dataset --data-root DIR \\
        [--expect-rows test=385024]

The one number this framework cannot reproduce in-repo is the reference's
logged valid AUC on the real MicroLens_1M_x1 parquet (0.9315,
train_predict_kaggle.ipynb cell 6) — the dataset is not redistributable.
This command is the acceptance gate for users who have it: it verifies the
exact contracts the reference's loaders assume silently
(the reference's src/dataloader.py:27-48,59-65,104-106; readme.md:67-72)
and this framework's loaders enforce, with actionable per-column errors:

* the four parquet files exist (train/valid/test/item_info);
* ``item_info``: unique integer key within the configured vocab, the
  ``item_emb_d128`` column list-valued with exactly ``dense_dim`` finite
  floats per row (zeros-for-missing rows are counted, not failed);
* each split: every model-read column present; categorical/sequence ids
  integer-typed and inside their table's vocab bound (the reference would
  either KeyError at train time or index out of range); sequence columns
  list-valued (any length — the loader keeps the LAST max_len entries);
* labels in train/valid binary 0/1 (soft labels are a warning: supported
  by this framework's loss, but not the reference recipe);
* referential integrity: train/valid item ids must exist in item_info
  (training raises on unknown ids, dataloader.py:104-106 semantics);
  unknown ids in TEST are a warning only (inference resolves them to zero
  vectors, Prediction.py:39-42 semantics).

Row counts are reported; pass ``--expect-rows train=N`` style options to
assert them. Exit code 0 = contract satisfied. Reading is streamed per
record batch, so arbitrarily large splits validate in constant memory.

The pinned recipe to reproduce the 0.9315 run once a directory passes is
in docs/OPERATIONS.md ("Reproducing the reference run").
"""

from __future__ import annotations

import argparse


class _Report:
    def __init__(self, log=print):
        self.errors: list[str] = []
        self.warnings: list[str] = []
        self.log = log

    def ok(self, msg: str) -> None:
        self.log(f"[ok] {msg}")

    def warn(self, msg: str) -> None:
        self.warnings.append(msg)
        self.log(f"[warn] {msg}")

    def error(self, msg: str) -> None:
        self.errors.append(msg)
        self.log(f"[ERROR] {msg}")


def _is_list_like(arrow_type) -> bool:
    import pyarrow as pa

    return pa.types.is_list(arrow_type) or pa.types.is_large_list(arrow_type)


def _validate_item_info(path: str, fm, dataset, rep: _Report):
    """Returns the set of item ids present (for referential checks), or
    None when the file is unusable."""
    import numpy as np
    import pyarrow.parquet as pq

    key, emb_col = dataset.item_info_key, dataset.item_info_emb_col
    dense = [
        f for f in fm.features if f.dense_dim is not None and f.name == emb_col
    ]
    dim = dense[0].dense_dim if dense else 128
    try:
        pf = pq.ParquetFile(path)
    except Exception as e:
        rep.error(f"{path}: unreadable parquet ({e})")
        return None
    names = set(pf.schema_arrow.names)
    for col in (key, emb_col):
        if col not in names:
            rep.error(
                f"{path}: missing column {col!r} "
                f"(item_info needs {key!r} + {emb_col!r}, readme.md:67-72)"
            )
            return None
    emb_field = pf.schema_arrow.field(emb_col)
    if not _is_list_like(emb_field.type):
        rep.error(
            f"{path}: {emb_col!r} must be LIST-valued ({dim} floats per "
            f"row, the pandas object-dtype layout the reference writes), "
            f"got arrow type {emb_field.type}"
        )
        return None
    ids: list[np.ndarray] = []
    n_zero = bad_len = 0
    n_rows = 0
    nonfinite = 0
    for rb in pf.iter_batches(columns=[key, emb_col]):
        n_rows += rb.num_rows
        id_arr = rb.column(0).to_numpy(zero_copy_only=False)
        if not np.issubdtype(np.asarray(id_arr).dtype, np.integer):
            rep.error(
                f"{path}: {key!r} must be integer-typed, got "
                f"{np.asarray(id_arr).dtype}"
            )
            return None
        ids.append(id_arr.astype(np.int64))
        col = rb.column(1)
        flat = col.flatten()  # arrow list -> values
        values = flat.to_numpy(zero_copy_only=False).astype(np.float64)
        nonfinite += int((~np.isfinite(values)).sum())
        offsets = np.asarray(col.combine_chunks().offsets if hasattr(col, "combine_chunks") else col.offsets)
        lens = np.diff(np.asarray(offsets, np.int64))
        bad_len += int((lens != dim).sum())
        # count all-zero vectors (missing-item placeholder, task-1 cell 8)
        if len(values) and (lens == dim).all():
            mat = values.reshape(-1, dim)
            n_zero += int((~mat.any(axis=1)).sum())
    if bad_len:
        rep.error(
            f"{path}: {bad_len} rows of {emb_col!r} do not hold exactly "
            f"{dim} floats (reference contract: {dim}-d vectors, "
            "zeros for missing items — task-1.ipynb cell 8)"
        )
    if nonfinite:
        rep.error(f"{path}: {emb_col!r} contains {nonfinite} non-finite values")
    all_ids = np.concatenate(ids) if ids else np.zeros(0, np.int64)
    uniq = np.unique(all_ids)
    if len(uniq) != len(all_ids):
        rep.error(
            f"{path}: {key!r} has {len(all_ids) - len(uniq)} duplicate ids "
            "(the item join is a unique-key lookup, dataloader.py:59)"
        )
    vocab = None
    t_name = fm.table_of.get("item_id")
    if t_name is not None:
        t = fm.table(t_name)
        vocab = None if t.hashed else t.vocab_size
    if vocab is not None and len(uniq) and (uniq.min() < 0 or uniq.max() >= vocab):
        rep.error(
            f"{path}: {key!r} ids outside [0, {vocab}) — min {uniq.min()}, "
            f"max {uniq.max()} (embedding table bound, model_fibinet.py:100)"
        )
    rep.ok(
        f"{path}: {n_rows} items, {dim}-d {emb_col!r}"
        + (f", {n_zero} zero vectors (missing-item placeholders)" if n_zero else "")
    )
    if bad_len or nonfinite:
        return None
    return set(int(i) for i in uniq)


def _validate_split(
    path: str, split: str, fm, rep: _Report, item_ids, has_label: bool
):
    import numpy as np
    import pyarrow.parquet as pq

    from ctr_recommendation_tpu_torch.config.schema import FeatureType

    try:
        pf = pq.ParquetFile(path)
    except Exception as e:
        rep.error(f"{path}: unreadable parquet ({e})")
        return 0
    names = set(pf.schema_arrow.names)
    wanted = []
    for f in fm.features:
        if f.type in (FeatureType.PLACEHOLDER, FeatureType.DENSE_EMBEDDING):
            continue  # placeholder reads no column; dense joins from item_info
        if f.name not in names:
            rep.error(
                f"{path}: missing model column {f.name!r} "
                f"(declared {f.type.value} in the dataset schema)"
            )
            continue
        wanted.append(f)
        if f.type == FeatureType.SEQUENCE and not _is_list_like(
            pf.schema_arrow.field(f.name).type
        ):
            rep.error(
                f"{path}: {f.name!r} must be LIST-valued (click-history "
                f"layout, dataloader.py:27-39), got arrow type "
                f"{pf.schema_arrow.field(f.name).type}"
            )
            wanted.remove(f)
    label = fm.label if (has_label and fm.label in names) else None
    if has_label and fm.label not in names:
        rep.error(f"{path}: missing label column {fm.label!r}")

    cols = [f.name for f in wanted] + ([label] if label else [])
    n_rows = 0
    id_stats = {f.name: [np.iinfo(np.int64).max, np.iinfo(np.int64).min] for f in wanted}
    unknown_items = 0
    soft_labels = 0
    bad_labels = 0
    seq_longer = 0
    for rb in pf.iter_batches(columns=cols):
        n_rows += rb.num_rows
        for f in wanted:
            col = rb.column(rb.schema.get_field_index(f.name))
            if f.type == FeatureType.SEQUENCE:
                flat = col.flatten()
                v = flat.to_numpy(zero_copy_only=False)
                offs = np.asarray(col.combine_chunks().offsets if hasattr(col, "combine_chunks") else col.offsets, np.int64)
                if f.max_len is not None:
                    seq_longer += int((np.diff(offs) > f.max_len).sum())
            else:
                v = col.to_numpy(zero_copy_only=False)
            if len(v) == 0:
                continue
            if not np.issubdtype(np.asarray(v).dtype, np.integer):
                rep.error(
                    f"{path}: {f.name!r} must be integer-typed, got "
                    f"{np.asarray(v).dtype}"
                )
                continue
            v = np.asarray(v, np.int64)
            id_stats[f.name][0] = min(id_stats[f.name][0], int(v.min()))
            id_stats[f.name][1] = max(id_stats[f.name][1], int(v.max()))
            if f.name == "item_id" and item_ids is not None:
                present = np.isin(v, np.fromiter(item_ids, np.int64, len(item_ids)))
                unknown_items += int((~present).sum())
        if label:
            lv = rb.column(rb.schema.get_field_index(label)).to_numpy(
                zero_copy_only=False
            ).astype(np.float64)
            bad_labels += int(((lv < 0) | (lv > 1) | ~np.isfinite(lv)).sum())
            soft_labels += int(((lv > 0) & (lv < 1)).sum())

    for f in wanted:
        lo, hi = id_stats[f.name]
        if lo > hi:
            continue  # empty
        t_name = fm.table_of.get(f.name)
        if t_name is None:
            continue
        t = fm.table(t_name)
        if t.hashed:
            continue  # any int id is legal; hashed on device
        if lo < 0 or hi >= t.vocab_size:
            rep.error(
                f"{path}: {f.name!r} ids outside [0, {t.vocab_size}) — "
                f"observed [{lo}, {hi}] (embedding bound for table "
                f"{t_name!r}; the reference would index out of range)"
            )
    if seq_longer:
        rep.warn(
            f"{path}: {seq_longer} sequences exceed max_len (the loader "
            "keeps the LAST max_len entries, dataloader.py:113-115)"
        )
    if bad_labels:
        rep.error(
            f"{path}: {bad_labels} label values outside [0, 1] or non-finite"
        )
    elif soft_labels:
        rep.warn(
            f"{path}: {soft_labels} soft (non-binary) labels — supported "
            "here, but not the reference recipe"
        )
    if unknown_items:
        msg = (
            f"{path}: {unknown_items} item_id values not present in "
            "item_info"
        )
        if split == "test":
            rep.warn(
                msg + " (inference resolves them to zero vectors, "
                "Prediction.py:39-42)"
            )
        else:
            rep.error(
                msg + " (training raises on unknown ids, "
                "dataloader.py:104-106)"
            )
    rep.ok(f"{path}: {n_rows} rows, all model columns present")
    return n_rows


def validate(data_root: str, exp=None, log=print, expect_rows=None) -> int:
    """Programmatic entry: returns 0 when the contract is satisfied."""
    import os

    from ctr_recommendation_tpu_torch.config import microlens_experiment
    from ctr_recommendation_tpu_torch.features import build_feature_map

    if exp is None:
        exp = microlens_experiment(data_root=data_root)
    fm = build_feature_map(exp.dataset)
    rep = _Report(log)

    paths = {
        "train": exp.dataset.train_data,
        "valid": exp.dataset.valid_data,
        "test": exp.dataset.test_data,
        "item_info": exp.dataset.item_info,
    }
    missing = {k: p for k, p in paths.items() if not os.path.exists(p)}
    for k, p in missing.items():
        rep.error(f"missing {k} parquet at {p}")
    if "item_info" not in missing:
        item_ids = _validate_item_info(paths["item_info"], fm, exp.dataset, rep)
    else:
        item_ids = None
    counts = {}
    for split in ("train", "valid", "test"):
        if split in missing:
            continue
        counts[split] = _validate_split(
            paths[split], split, fm, rep, item_ids, has_label=split != "test"
        )
    for split, want in (expect_rows or {}).items():
        got = counts.get(split)
        if got is not None and got != want:
            rep.error(f"{split}: expected {want} rows, found {got}")
    if rep.errors:
        log(f"FAILED: {len(rep.errors)} contract violations "
            f"({len(rep.warnings)} warnings)")
        return 1
    log(f"PASSED ({len(rep.warnings)} warnings) — directory satisfies the "
        "MicroLens data contract; see docs/OPERATIONS.md 'Reproducing the "
        "reference run' for the pinned 0.9315 recipe")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Validate a dataset directory against the exact "
        "reference data contracts (readme.md:67-72, dataloader.py:27-48)"
    )
    p.add_argument("--data-root", required=True)
    p.add_argument(
        "--expect-rows",
        nargs="*",
        default=[],
        metavar="SPLIT=N",
        help="assert split row counts, e.g. --expect-rows test=385024",
    )
    args = p.parse_args(argv)
    expect = {}
    for spec in args.expect_rows:
        split, _, n = spec.partition("=")
        expect[split] = int(n)
    return validate(args.data_root, expect_rows=expect)


if __name__ == "__main__":
    raise SystemExit(main())
