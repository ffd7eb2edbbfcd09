from ctr_recommendation_tpu_torch.tools.item_embeddings import (
    HashTextEncoder,
    build_text,
    generate_item_embeddings,
    parse_tags,
    pca_project,
)

__all__ = [
    "HashTextEncoder",
    "build_text",
    "generate_item_embeddings",
    "parse_tags",
    "pca_project",
]
