"""Task-1 CLI: offline multimodal item-embedding generation.

    python -m ctr_recommendation_tpu_torch.cli.item_embeddings \
        --item-feature item_feature.parquet --output item_info.parquet [--device cpu]

Assembles "{title} | tags: ... | likes_level: x | views_level: y" text per
item, probes the image directory (jpg/png/jpeg/webp + glob, black 224x224
placeholder), encodes text+image through ViLT (dandelin/vilt-b32-mlm, CLS
token, L2-normalized), PCA to ``--dims`` dims on ``--device``,
re-L2-normalizes, and writes the refreshed ``item_emb_d128`` column
(tools/item_embeddings.py). When the transformers weights are unavailable
it warns and substitutes the deterministic n-gram hash encoder, as
``--encoder hash`` does, so the output contract is still exercised end to
end. Reads and writes parquet: needs pyarrow.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Generate multimodal item embeddings")
    p.add_argument("--item-feature", required=True, help="input item_feature.parquet")
    p.add_argument("--output", required=True, help="output item_info parquet")
    p.add_argument("--image-dir", default=None, help="raw item images ({item_id}.ext)")
    p.add_argument("--encoder", choices=("vilt", "hash"), default="vilt")
    p.add_argument("--dims", type=int, default=128)
    p.add_argument("--vilt-model", default="dandelin/vilt-b32-mlm")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from ctr_recommendation_tpu_torch.tools.item_embeddings import (
        HashTextEncoder,
        ViltEncoder,
        generate_item_embeddings,
    )
    from ctr_recommendation_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)  # no CUDA and no --device cpu: fail before any work
    if args.encoder == "vilt":
        try:
            encoder = ViltEncoder(args.vilt_model, batch_size=args.batch_size, device=device)
        except Exception as e:  # no weights / no transformers in this environment
            print(f"[warn] ViLT unavailable ({e!r}); falling back to hash encoder")
            encoder = HashTextEncoder()
    else:
        encoder = HashTextEncoder()

    n = generate_item_embeddings(
        args.item_feature,
        args.output,
        encoder=encoder,
        n_components=args.dims,
        image_dir=args.image_dir,
        device=device,
    )
    print(f"[out] {args.output}: {n} items, {args.dims}-d item_emb_d128")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
