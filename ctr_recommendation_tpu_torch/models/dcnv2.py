"""DCNv2 (Wang et al., WWW'21, the parallel variant), the JAX package's
``models/dcnv2.py``: flat = flatten(fields); cross = CrossNetV2(flat), three
layers; deep = a headless BatchNorm MLP(flat); logit = Linear([cross ‖ deep]).
"""

from __future__ import annotations

import torch

from ctr_recommendation_tpu_torch.config.schema import ModelConfig
from ctr_recommendation_tpu_torch.features.feature_map import FeatureMap
from ctr_recommendation_tpu_torch.models import trunk
from ctr_recommendation_tpu_torch.ops import crossnet as cross_ops
from ctr_recommendation_tpu_torch.ops import mlp as mlp_ops
from ctr_recommendation_tpu_torch.ops.initializers import linear_apply, linear_init

SEQ_POOLING = "mean"
NUM_CROSS_LAYERS = 3


def init(gen: torch.Generator, fm: FeatureMap, cfg: ModelConfig) -> tuple[dict, dict]:
    """(params, state) on the CPU, drawn from ``gen`` in a fixed order."""
    in_dim = fm.num_fields * cfg.embedding_dim
    params = {
        "trunk": trunk.init(gen, fm, cfg, seq_pooling=SEQ_POOLING),
        "cross": cross_ops.init(gen, in_dim, NUM_CROSS_LAYERS),
    }
    params["mlp"], mlp_state = mlp_ops.init(
        gen, in_dim, cfg.hidden_units, out_dim=None, batch_norm=cfg.batch_norm
    )
    params["out"] = linear_init(gen, in_dim + cfg.hidden_units[-1], 1)
    return params, {"mlp": mlp_state}


def apply(
    params: dict,
    state: dict,
    fm: FeatureMap,
    cfg: ModelConfig,
    batch: dict[str, torch.Tensor],
    *,
    train: bool = False,
    generator: torch.Generator | None = None,
    compute_dtype: torch.dtype = torch.float32,
    weight: torch.Tensor | None = None,
    lookup=None,
) -> tuple[torch.Tensor, dict]:
    """As ``din.apply``; the cross network, the deep tower and the head in
    ``tower_dtype``."""
    x = trunk.apply(params["trunk"], fm, cfg, batch, seq_pooling=SEQ_POOLING,
                    compute_dtype=compute_dtype, train=train, generator=generator, lookup=lookup)
    flat = x.flatten(1).to(trunk.tower_dtype(cfg, compute_dtype))
    crossed = cross_ops.apply(params["cross"], flat)
    deep, mlp_state = mlp_ops.apply(
        params["mlp"], state["mlp"], flat,
        train=train, dropout_rate=cfg.net_dropout, generator=generator, weight=weight,
    )
    logit = linear_apply(params["out"], torch.cat([crossed, deep], dim=-1))[..., 0]
    return logit.float(), {"mlp": mlp_state}
