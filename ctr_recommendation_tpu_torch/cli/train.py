"""Train CLI: the JAX package's ``cli/train.py`` on the port.

    python -m ctr_recommendation_tpu_torch.cli.train --data-root DIR [--device cuda]
    python -m ctr_recommendation_tpu_torch.cli.train --synthetic /tmp/synth --device cpu
    python -m ctr_recommendation_tpu_torch.cli.train --synthetic /tmp/synth --model xdeepfm
    torchrun --nproc_per_node N -m ctr_recommendation_tpu_torch.cli.train --data-root DIR
    torchrun --nproc_per_node 2 -m ctr_recommendation_tpu_torch.cli.train --model-parallel 2 ...

``--model`` takes any name of ``models.available_models()``: the FiBiNET
family (fibinet, mm_fibinet, sasrec_fibinet) and the zoo (autoint, dcnv2,
deepfm, din, dlrm, finalmlp, masknet, pnn, xdeepfm); an unknown name fails
before any data is loaded.

Loads the valid split and the item store, then trains with per-epoch AUC,
the best export to ``<checkpoint-dir>/best/export.npz`` and resume points:
by default with the train split resident on the device
(``Trainer.fit_on_device``); with ``--stream`` (the train split read row
group by row group, ``stream_batches``) or ``--strict-items`` (the item join
on the host, raising on an item_id missing from item_info) host-driven
(``Trainer.fit``, ``--steps-per-dispatch`` batches an upload).
``--profile-dir DIR`` instead writes a torch.profiler trace of one
device-resident epoch into DIR (``Trainer.profile_epoch``) and exits; it
needs the in-memory, non-strict path.

Under a launcher (torchrun: one process a rank, ``cuda:{LOCAL_RANK}``, NCCL;
gloo with ``--device cpu``) it trains data-parallel as the JAX CLI trains
multi-host: each data rank takes its shard of the train split
(``TableData.shard``, or its row groups under ``--stream``), every rank runs
the same step count, ``--batch-size`` is each data rank's batch, and
training goes through ``Trainer.fit``; world rank 0 alone writes the
checkpoint directory. ``--model-parallel N`` row-shards the embedding
tables over N ranks (``WORLD_SIZE`` = dp x N): the ranks of one model group
train on the same rows, their tables read through
``parallel/embedding.py::make_sharded_lookup`` (the sparse table optimizers'
gathered rows through its psum form), and the checkpoint holds whole
tables, which the predict, evaluate and serve CLIs restore on one device.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys



def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train a CTR model (PyTorch port)")
    p.add_argument("--config", help="reference-compatible YAML config")
    p.add_argument("--logged-run-parity", action="store_true",
                   help="apply the reference CODE's hardcoded values over dead YAML keys")
    p.add_argument("--expid", help="experiment id in the YAML")
    p.add_argument("--data-root", help="directory with train/valid/test/item_info parquet")
    p.add_argument("--synthetic", metavar="DIR",
                   help="generate a synthetic MicroLens-shaped dataset in DIR and train on it")
    p.add_argument("--synthetic-rows", type=int, default=200_000)
    p.add_argument("--synthetic-items", type=int, default=4096,
                   help="item vocab for --synthetic (91717 for full MicroLens scale)")
    p.add_argument("--synthetic-signal", choices=("planted", "high"), default="planted")
    p.add_argument("--model", default=None,
                   help="model name (default mm_fibinet); one of models.available_models(): "
                        "autoint, dcnv2, deepfm, din, dlrm, fibinet, finalmlp, masknet, "
                        "mm_fibinet, pnn, sasrec_fibinet, xdeepfm")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--embedding-dim", type=int, default=None)
    p.add_argument("--embedding-init-std", type=float, default=None)
    p.add_argument("--learning-rate", type=float, default=None)
    p.add_argument("--optimizer", default=None, help="adam | adamw | adagrad")
    p.add_argument("--table-optimizer", default=None,
                   help="embedding-table update: dense (the reference's) | adagrad | "
                        "rowwise_adagrad | adam (touched-rows-only sparse updates)")
    p.add_argument("--table-lr-scale", type=float, default=None,
                   help="lr multiplier of the sparse table optimizer (default 10 for the "
                        "adagrad family, 1 for adam)")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=None,
                   help="full-state resume-point cadence in epochs")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--no-pallas", action="store_true",
                   help="run the interaction block and the SASRec encoder on plain PyTorch "
                        "ops, not the kernels")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--strict-items", action="store_true",
                   help="raise on item_ids missing from item_info (the reference's train "
                        "semantics); the item join runs on the host")
    p.add_argument("--stream", action="store_true",
                   help="stream the train split from parquet row groups instead of "
                        "loading it (for splits larger than memory)")
    p.add_argument("--steps-per-dispatch", type=int, default=None,
                   help="host-driven runs (--stream / --strict-items) upload this many "
                        "batches at a time; 1 = one upload a batch")
    p.add_argument("--rng-impl", default=None,
                   help="the JAX package's training-rng PRNG (threefry | rbg); recorded in "
                        "experiment.json and ignored: the port draws its masks from torch "
                        "generators")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="row-shard the embedding tables over this many ranks of the launcher's "
                        "(the world size must be a multiple of it)")
    p.add_argument("--profile-dir", default=None,
                   help="capture a torch.profiler trace of one epoch into DIR and exit")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    from ctr_recommendation_tpu_torch.config import load_experiment, microlens_experiment
    from ctr_recommendation_tpu_torch.config.loader import microlens_features
    from ctr_recommendation_tpu_torch.parallel import distributed

    # joins the launcher's process group, if any (a no-op in one process)
    distributed.initialize(backend=distributed.default_backend(args.device))

    overrides = {}
    for k in ("epochs", "batch_size", "embedding_dim", "embedding_init_std",
              "learning_rate", "optimizer", "table_optimizer", "table_lr_scale",
              "checkpoint_dir", "checkpoint_every", "steps_per_dispatch", "rng_impl"):
        v = getattr(args, k)
        if v is not None:
            overrides[k] = v
    if args.no_pallas:
        overrides["use_pallas"] = False

    if args.synthetic:
        from ctr_recommendation_tpu_torch.data import write_synthetic_dataset

        os.makedirs(args.synthetic, exist_ok=True)
        if (distributed.host_id() == 0
                and not os.path.exists(os.path.join(args.synthetic, "train.parquet"))):
            print(f"[synthetic] generating {args.synthetic_rows} rows in {args.synthetic}")
            write_synthetic_dataset(
                args.synthetic, num_rows=args.synthetic_rows,
                num_items=args.synthetic_items, signal=args.synthetic_signal,
            )
        if distributed.host_count() > 1:  # the other ranks read what rank 0 wrote
            import torch.distributed as dist

            dist.barrier()
        exp = microlens_experiment(
            data_root=args.synthetic, model=args.model or "mm_fibinet", **overrides
        )
        exp = exp.replace(dataset=dataclasses.replace(
            exp.dataset,
            features=microlens_features(
                item_vocab=args.synthetic_items + 1, cate_vocab=11, max_len=20, mm_dim=128
            ),
        ))
    elif args.config:
        exp = load_experiment(
            args.config, expid=args.expid, data_root=args.data_root,
            logged_run_parity=args.logged_run_parity,
        )
        if args.model:
            exp = exp.replace(model=dataclasses.replace(exp.model, model=args.model))
        for k, v in overrides.items():
            target = (
                "model" if k in ("embedding_dim", "embedding_init_std", "use_pallas") else "train"
            )
            exp = exp.replace(**{target: dataclasses.replace(getattr(exp, target), **{k: v})})
    else:
        if not args.data_root:
            print("need --data-root, --config, or --synthetic", file=sys.stderr)
            return 2
        exp = microlens_experiment(
            data_root=args.data_root, model=args.model or "mm_fibinet", **overrides
        )
    if args.model_parallel > 1:
        from ctr_recommendation_tpu_torch.config.schema import MeshConfig

        exp = exp.replace(mesh=MeshConfig(model_parallel=args.model_parallel))
    return run_training(exp, resume=args.resume, strict_items=args.strict_items,
                        stream=args.stream, device=args.device, profile_dir=args.profile_dir)


def run_training(exp, *, resume: bool = False, strict_items: bool = False,
                 stream: bool = False, device: str = "cuda",
                 profile_dir: str | None = None) -> int:
    """Load the valid split and the item store, then train: with
    ``profile_dir``, only ``Trainer.profile_epoch`` (refused under ``stream``
    or ``strict_items``); else ``fit_on_device`` unless ``stream`` or
    ``strict_items``, else ``fit`` over this epoch's
    ``stream_batches`` / ``iter_batches`` (drop_last), cut to the step
    count. Under ``strict_items`` the batches carry the dense item column
    joined on the host (an unknown item_id raises), and the trainer holds
    no item store.

    Over a process group of dp x mp ranks (``parallel.distributed.initialize``,
    mp = ``exp.mesh.model_parallel``) each rank trains on ``cuda:{LOCAL_RANK}``
    (or the CPU) through ``fit``: its data rank's shard of the split (its row
    groups under ``stream``), ``(rows // dp) // batch_size`` steps an epoch
    on every rank (``common_step_count`` under ``stream``), its batches
    shuffled with seed + data rank, so that the ranks of one model group
    step through the same rows."""
    import itertools

    from ctr_recommendation_tpu_torch.data import ItemStore, iter_batches, load_split
    from ctr_recommendation_tpu_torch.data.streaming import common_step_count, stream_batches
    from ctr_recommendation_tpu_torch.features import build_feature_map
    from ctr_recommendation_tpu_torch.models.registry import get_model
    from ctr_recommendation_tpu_torch.parallel import distributed
    from ctr_recommendation_tpu_torch.parallel.mesh import make_mesh
    from ctr_recommendation_tpu_torch.training import Trainer

    get_model(exp.model.model)  # fail fast on an unknown model, before data load
    dev = distributed.rank_device(device)
    mesh = make_mesh(exp.mesh, device=dev)
    fm = build_feature_map(exp.dataset)
    print(f"[data] loading {exp.dataset.train_data}")
    valid = load_split(exp.dataset.valid_data, fm)
    store = ItemStore.from_parquet(
        exp.dataset.item_info,
        id_col=exp.dataset.item_info_key,
        emb_col=exp.dataset.item_info_emb_col,
    )
    bs = exp.train.batch_size
    # the train split shards over the data axis: a model group shares its rows
    n_hosts, host = mesh.shape[exp.mesh.data_axis], mesh.data_rank
    if stream:
        import pyarrow.parquet as pq

        train_rows = pq.ParquetFile(exp.dataset.train_data).metadata.num_rows
        train = None
        # every rank runs as many steps: unequal counts would leave the
        # others waiting in a collective
        steps = common_step_count(exp.dataset.train_data, bs, n_hosts)
    else:
        train = load_split(exp.dataset.train_data, fm)
        train_rows = train.num_rows
        # a disjoint shard a rank, with a lockstep step count (the shards
        # differ by up to n_hosts - 1 rows)
        train = train.shard(host, n_hosts)
        steps = (train_rows // n_hosts) // bs
    print(f"[data] train {train_rows} rows, valid {valid.num_rows} rows")
    if steps < 1:
        # not clamped to 1: every rank computes the same count, so all exit
        print(f"batch size {bs} exceeds the smallest per-host train shard "
              f"({train_rows} rows / {n_hosts} host(s)); lower --batch-size", file=sys.stderr)
        return 2
    # the item join runs on the device unless strict mode needs the host's check
    host_store = store if strict_items else None
    # at model_parallel > 1 the Trainer reads the tables through
    # make_sharded_lookup(mesh, exp.mesh's lookup_method and capacity factor),
    # as the JAX CLI injects it (its cli/train.py:200-215)
    trainer = Trainer(exp, mesh=mesh, steps_per_epoch=steps, device=dev,
                      item_store=None if strict_items else store)
    if profile_dir:
        if stream or strict_items:
            # profile_epoch runs the device-resident epoch: it needs the whole
            # split in memory (not --stream) and the device's item join (not
            # --strict-items)
            print("--profile-dir requires the in-memory, non-strict path "
                  "(drop --stream/--strict-items)", file=sys.stderr)
            return 2
        trainer.profile_epoch(train, profile_dir)
        return 0
    if distributed.host_count() == 1 and not (stream or strict_items):
        trainer.fit_on_device(train, valid, resume=resume)
        return 0

    def train_batches(epoch):
        if stream:
            it = stream_batches(
                exp.dataset.train_data, fm, bs, shuffle=exp.train.shuffle,
                seed=exp.train.seed, epoch=epoch, host_index=host, host_count=n_hosts,
                item_store=host_store, drop_last=True, strict_items=strict_items)
        else:
            it = iter_batches(
                train, fm, bs, shuffle=exp.train.shuffle, seed=exp.train.seed + host,
                epoch=epoch, item_store=host_store, drop_last=True, strict_items=strict_items)
        return itertools.islice(it, steps)

    def valid_batches():
        return iter_batches(valid, fm, exp.train.eval_batch_size, item_store=host_store)

    trainer.fit(train_batches, valid_batches, resume=resume)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
