"""Serve CLI: online scoring over HTTP (the JAX package's ``cli/serve.py``
on the port).

Stands a checkpoint up as a latency-oriented service: the BatchNorm-folded
Predictor (on the fused branch the scoring kernel, and for sasrec_fibinet
the encoder kernel), fixed-bucket request collation, dynamic
micro-batching across concurrent clients (``serving/``). Weights come from
the port's own best export, ``<checkpoint-dir>/best/export.npz`` (written
by the train CLI), or from ``--weights``, an .npz in the same layout made
from a JAX export with tools/jax_bridge.py. The kernels' builds are cached
by ``ops/cuda/build.py``.

    python -m ctr_recommendation_tpu_torch.cli.serve --data-root DIR \\
        --checkpoint-dir CKPT [--port 8080] [--weights weights.npz] [--device cuda]
    curl -s localhost:8080/v1/score -d '{"rows": [{"item_id": 7,
        "likes_level": 3, "views_level": 2, "item_seq": [5, 9, 12]}]}'
"""

from __future__ import annotations

import argparse
import os


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Online CTR scoring over HTTP (PyTorch port)")
    p.add_argument("--data-root", required=True,
                   help="directory holding item_info.parquet (the item join)")
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--model", default="mm_fibinet",
                   help="fallback when the checkpoint has no experiment.json")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--buckets", default=None,
                   help="comma-separated batch buckets (default 16..8192)")
    p.add_argument("--max-wait-ms", type=float, default=2.0,
                   help="micro-batcher linger before dispatching a partial batch")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip running every bucket shape once at startup")
    p.add_argument("--weights", default=None,
                   help=".npz of params/model_state written by tools/jax_bridge.save "
                        "(default: <checkpoint-dir>/best/export.npz)")
    p.add_argument("--device", default="cuda")
    return p


def build_service(args):
    """The ScoringService of ``args`` (``build_argparser``'s namespace)."""
    import dataclasses

    from ctr_recommendation_tpu_torch.config import microlens_experiment, serialize
    from ctr_recommendation_tpu_torch.config.schema import MeshConfig
    from ctr_recommendation_tpu_torch.data import ItemStore
    from ctr_recommendation_tpu_torch.features import build_feature_map
    from ctr_recommendation_tpu_torch.inference import Predictor
    from ctr_recommendation_tpu_torch.serving import ScoringService
    from ctr_recommendation_tpu_torch.tools import jax_bridge
    from ctr_recommendation_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    weights = args.weights or os.path.join(args.checkpoint_dir, "best", "export.npz")
    if not os.path.exists(weights):
        raise FileNotFoundError(
            f"no weights at {weights}: train with the port's train CLI, or convert a JAX "
            "export with tools/jax_bridge.save and pass --weights")
    exp_json = os.path.join(args.checkpoint_dir, "experiment.json")
    if os.path.exists(exp_json):
        # self-describing checkpoint (same contract as cli/predict.py)
        exp = serialize.load(exp_json)
        root = args.data_root
        exp = exp.replace(
            dataset=dataclasses.replace(
                exp.dataset,
                data_root=root,
                item_info=os.path.join(root, "item_info.parquet"),
            ),
            mesh=MeshConfig(),  # serving ignores the training mesh
        )
    else:
        exp = microlens_experiment(data_root=args.data_root, model=args.model)
    fm = build_feature_map(exp.dataset)
    store = ItemStore.from_parquet(
        exp.dataset.item_info,
        id_col=exp.dataset.item_info_key,
        emb_col=exp.dataset.item_info_emb_col,
    )
    params, state = jax_bridge.params_from_jax(*jax_bridge.load(weights), fm, exp.model)
    pred = Predictor(exp, params, state, item_store=store, device=device)
    buckets = tuple(int(b) for b in args.buckets.split(",")) if args.buckets else None
    return ScoringService(
        pred, fm, model_name=exp.model.model, buckets=buckets, max_wait_ms=args.max_wait_ms
    )


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    from ctr_recommendation_tpu_torch.serving import make_http_server

    service = build_service(args)
    if not args.no_warmup:
        print(f"[serve] warming {len(service.collator.buckets)} bucket shapes...")
        service.warmup()
    server = make_http_server(service, host=args.host, port=args.port)
    host, port = server.server_address[:2]
    print(f"[serve] {service.model_name} listening on http://{host}:{port} "
          f"(buckets={list(service.collator.buckets)}, max_wait={args.max_wait_ms}ms)",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.close()
        print(f"[serve] stats: {service.stats()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
