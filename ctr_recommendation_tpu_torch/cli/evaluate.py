"""Evaluate CLI: the JAX package's ``cli/evaluate.py`` on the port.

Scores a labeled split with the serving path (BatchNorm-folded tower,
tolerant item lookup) and prints AUC and logloss, the trainer's exact
tie-aware metrics, and with ``--gauc-col`` the group AUC keyed by that
column. Weights come from ``<checkpoint-dir>/best/export.npz`` (the port's
train CLI writes it) or from ``--weights``, an .npz in the same layout made
from a JAX export with tools/jax_bridge.save.

    python -m ctr_recommendation_tpu_torch.cli.evaluate --data-root DIR \\
        --checkpoint-dir CKPT [--split valid] [--gauc-col user_id] \\
        [--weights weights.npz] [--device cuda]

``--model`` names any model of ``models.available_models()``; with an
``experiment.json`` in the checkpoint directory the model is read from it.
``evaluate`` does the scoring and the metrics for a ``Predictor`` and a
``TableData``; ``main`` only loads and prints.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch


def evaluate(pred, table, *, batch_size: int = 8192, gauc_col: str | None = None) -> dict:
    """Score ``table`` (it must hold the label column, and ``gauc_col`` when
    given) with ``pred``. AUC and logloss are computed on the predictor's
    device, the group AUC's keys factorized on the host. Returns ``rows``,
    ``auc``, ``logloss``, ``gauc`` (None without ``gauc_col``) and the
    ``probs`` scored."""
    from ctr_recommendation_tpu_torch.training.metrics import auc, group_auc, logloss

    probs = pred.score_table(table, batch_size=batch_size)
    labels_np = np.asarray(table.columns[pred.fm.label], np.float32)
    labels = torch.as_tensor(labels_np, device=pred.device)
    p = torch.as_tensor(probs, device=pred.device)
    gauc = None
    if gauc_col:
        gauc = group_auc(labels_np, probs, table.columns[gauc_col], device=pred.device)
    return {"rows": len(probs), "auc": float(auc(labels, p)), "logloss": float(logloss(labels, p)),
            "gauc": gauc, "probs": probs}


def eval_line(result: dict, gauc_col: str | None = None) -> str:
    """The ``[eval]`` line the JAX CLI prints."""
    extra = f" gAUC[{gauc_col}]={result['gauc']:.6f}" if gauc_col else ""
    return (f"[eval] rows={result['rows']} AUC={result['auc']:.6f} "
            f"logloss={result['logloss']:.6f}{extra}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Evaluate a checkpoint on a labeled split "
                                            "(PyTorch port)")
    p.add_argument("--data-root", required=True)
    p.add_argument("--split", default="valid",
                   help="split file stem under data-root (valid/test/train) or a parquet path")
    p.add_argument("--model", default=None,
                   help="model name (default mm_fibinet), one of models.available_models(); "
                        "with an experiment.json in --checkpoint-dir it must name the model "
                        "there")
    p.add_argument("--checkpoint-dir", default="checkpoints",
                   help="read for experiment.json and best/export.npz, when present")
    p.add_argument("--batch-size", type=int, default=8192)
    p.add_argument("--gauc-col", default=None,
                   help="also report group AUC keyed by this id column (e.g. user_id)")
    p.add_argument("--weights", default=None,
                   help=".npz of params/model_state written by tools/jax_bridge.save "
                        "(default: <checkpoint-dir>/best/export.npz)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from ctr_recommendation_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    weights = args.weights or os.path.join(args.checkpoint_dir, "best", "export.npz")
    if not os.path.exists(weights):
        p.error(f"no weights at {weights}: train with the port's train CLI, or convert a "
                "JAX export with tools/jax_bridge.save and pass --weights")

    import dataclasses

    from ctr_recommendation_tpu_torch.config import microlens_experiment, serialize
    from ctr_recommendation_tpu_torch.config.schema import MeshConfig
    from ctr_recommendation_tpu_torch.data import ItemStore, load_split
    from ctr_recommendation_tpu_torch.features import build_feature_map
    from ctr_recommendation_tpu_torch.inference import Predictor
    from ctr_recommendation_tpu_torch.models import get_model
    from ctr_recommendation_tpu_torch.tools import jax_bridge

    exp_json = os.path.join(args.checkpoint_dir, "experiment.json")
    if os.path.exists(exp_json):
        exp = serialize.load(exp_json)
        if args.model and args.model.lower() != exp.model.model.lower():
            p.error(f"--model {args.model}, but {exp_json} describes {exp.model.model}")
        root = args.data_root
        exp = exp.replace(
            dataset=dataclasses.replace(
                exp.dataset, data_root=root, item_info=os.path.join(root, "item_info.parquet"),
            ),
            mesh=MeshConfig(),  # the serving mesh, not the training one
        )
    else:
        exp = microlens_experiment(data_root=args.data_root, model=args.model or "mm_fibinet")
    get_model(exp.model.model)  # fail fast on an unknown model, before data load
    fm = build_feature_map(exp.dataset)

    split_path = (
        args.split if args.split.endswith(".parquet")
        else os.path.join(args.data_root, f"{args.split}.parquet")
    )
    data = load_split(split_path, fm, include_label=True)
    if fm.label not in data.columns:
        # e.g. the MicroLens test split ships without labels (load_split
        # drops absent columns): say so before any scoring
        print(f"split {split_path} has no {fm.label!r} column — evaluation "
              "needs a labeled split (use cli.predict for unlabeled scoring)", file=sys.stderr)
        return 2
    if args.gauc_col and args.gauc_col not in data.columns:
        print(f"--gauc-col {args.gauc_col!r} is not a column of {split_path} "
              f"(have: {sorted(data.columns)})", file=sys.stderr)
        return 2
    store = ItemStore.from_parquet(
        exp.dataset.item_info,
        id_col=exp.dataset.item_info_key,
        emb_col=exp.dataset.item_info_emb_col,
    )
    print(f"[data] {split_path}: {data.num_rows} rows")

    params, state = jax_bridge.params_from_jax(*jax_bridge.load(weights), fm, exp.model)
    pred = Predictor(exp, params, state, item_store=store, device=device)
    result = evaluate(pred, data, batch_size=args.batch_size, gauc_col=args.gauc_col)
    print(eval_line(result, args.gauc_col))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
