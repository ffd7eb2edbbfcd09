"""Predict CLI: the JAX package's ``cli/predict.py`` on the port.

Scores the test split with the BatchNorm-folded tower and tolerant item
lookup through the overlapped pipeline and writes the Kaggle submission
pair (prediction_fibinet.csv + submission_fibinet.zip). Weights come from
the port's own best export, ``<checkpoint-dir>/best/export.npz`` (written by
the train CLI), or from ``--weights``, an .npz in the same layout made from
a JAX export with tools/jax_bridge.py (reading the orbax export itself needs
JAX).

    python -m ctr_recommendation_tpu_torch.cli.predict --data-root DIR \\
        --checkpoint-dir CKPT [--model NAME] [--weights weights.npz] \\
        [--stream] [--device cuda]

``--stream`` reads the test split row group by row group
(``stream_batches``, unshuffled: the parquet's row order), scores it batch
by batch through ``Predictor.predict_all`` and writes the pair with
``write_submission``.

Every model of ``models.available_models()`` serves, from the port's own
export (trained with ``cli/train.py --model NAME``) or from ``--weights``:
``sasrec_fibinet``'s history runs through the encoder kernel, the FiBiNET
family's interaction and tower through the scoring kernel, and the zoo
(autoint, dcnv2, deepfm, din, dlrm, finalmlp, masknet, pnn, xdeepfm) runs
its eval forward in plain PyTorch with its "mlp" tower's BatchNorm folded.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Batch scoring + submission (PyTorch port)")
    p.add_argument("--data-root", required=True)
    p.add_argument("--model", default=None,
                   help="model name (default mm_fibinet), one of models.available_models(); "
                        "with an experiment.json in --checkpoint-dir it must name the model "
                        "there")
    p.add_argument("--checkpoint-dir", default="checkpoints",
                   help="read for experiment.json and best/export.npz, when present")
    p.add_argument("--out-dir", default="output")
    p.add_argument("--batch-size", type=int, default=8192)
    p.add_argument("--embedding-dim", type=int, default=None)
    p.add_argument("--stream", action="store_true",
                   help="stream the test split from parquet row groups instead of the "
                        "overlapped pipeline; scores batch by batch in row order")
    p.add_argument("--weights", default=None,
                   help=".npz of params/model_state written by tools/jax_bridge.save "
                        "(default: <checkpoint-dir>/best/export.npz)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    weights = args.weights or os.path.join(args.checkpoint_dir, "best", "export.npz")
    if not os.path.exists(weights):
        p.error(f"no weights at {weights}: train with the port's train CLI, or convert a "
                "JAX export with tools/jax_bridge.save and pass --weights")

    import dataclasses

    from ctr_recommendation_tpu_torch.config import microlens_experiment, serialize
    from ctr_recommendation_tpu_torch.config.schema import MeshConfig
    from ctr_recommendation_tpu_torch.data import ItemStore
    from ctr_recommendation_tpu_torch.features import build_feature_map
    from ctr_recommendation_tpu_torch.inference import (
        Predictor,
        run_submission_pipeline,
        write_submission,
    )
    from ctr_recommendation_tpu_torch.models import get_model
    from ctr_recommendation_tpu_torch.tools import jax_bridge

    exp_json = os.path.join(args.checkpoint_dir, "experiment.json")
    if os.path.exists(exp_json):
        # checkpoint is self-describing: rebuild the exact trained model
        exp = serialize.load(exp_json)
        if args.model and args.model.lower() != exp.model.model.lower():
            p.error(f"--model {args.model}, but {exp_json} describes {exp.model.model}")
        root = args.data_root
        exp = exp.replace(
            dataset=dataclasses.replace(
                exp.dataset,
                data_root=root,
                test_data=os.path.join(root, "test.parquet"),
                item_info=os.path.join(root, "item_info.parquet"),
            ),
            mesh=MeshConfig(),
        )
    else:
        overrides = {}
        if args.embedding_dim:
            overrides["embedding_dim"] = args.embedding_dim
        exp = microlens_experiment(
            data_root=args.data_root, model=args.model or "mm_fibinet", **overrides
        )
    get_model(exp.model.model)  # fail fast on an unknown model, before data load
    fm = build_feature_map(exp.dataset)

    store = ItemStore.from_parquet(
        exp.dataset.item_info,
        id_col=exp.dataset.item_info_key,
        emb_col=exp.dataset.item_info_emb_col,
    )
    import pyarrow.parquet as pq

    n_rows = pq.ParquetFile(exp.dataset.test_data).metadata.num_rows
    print(f"[data] test {n_rows} rows")

    params, state = jax_bridge.params_from_jax(*jax_bridge.load(weights), fm, exp.model)
    pred = Predictor(exp, params, state, item_store=store, device=args.device)
    if args.stream:
        # one "host", unshuffled: the submission's rows in the parquet's order
        from ctr_recommendation_tpu_torch.data.streaming import stream_batches

        probs = pred.predict_all(stream_batches(
            exp.dataset.test_data, fm, args.batch_size, include_label=False))
        if len(probs) != n_rows:
            raise RuntimeError(f"scored {len(probs)} rows, the test split has {n_rows}")
        csv_path, zip_path = write_submission(probs, args.out_dir)
    else:
        written, csv_path, zip_path = run_submission_pipeline(
            exp.dataset.test_data, pred, args.out_dir, batch_size=args.batch_size
        )
        if written != n_rows:
            raise RuntimeError(f"wrote {written} rows, the test split has {n_rows}")
    print(f"[out] {csv_path}\n[out] {zip_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
