"""DIN: Deep Interest Network (Zhou et al., KDD 2018) on the shared trunk,
the JAX package's ``models/din.py``: the click history pooled by the local
activation unit against the candidate item (``attention.din_pool``, raw
un-normalized weights), the field stack flattened into the BatchNorm MLP.
"""

from __future__ import annotations

import torch

from ctr_recommendation_tpu_torch.config.schema import ModelConfig
from ctr_recommendation_tpu_torch.features.feature_map import FeatureMap
from ctr_recommendation_tpu_torch.models import trunk
from ctr_recommendation_tpu_torch.ops import mlp as mlp_ops

SEQ_POOLING = "din"


def init(gen: torch.Generator, fm: FeatureMap, cfg: ModelConfig) -> tuple[dict, dict]:
    """(params, state) on the CPU, drawn from ``gen`` in a fixed order."""
    f, e = fm.num_fields, cfg.embedding_dim
    params = {"trunk": trunk.init(gen, fm, cfg, seq_pooling=SEQ_POOLING)}
    params["mlp"], mlp_state = mlp_ops.init(
        gen, f * e, cfg.hidden_units, out_dim=1, batch_norm=cfg.batch_norm
    )
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
    """batch -> (logits (B,) fp32, new state), as every zoo model: the trunk
    in ``compute_dtype``, the layers after it as the JAX model runs them; in
    train mode BatchNorm takes batch statistics (zero-``weight`` rows left
    out) and dropout draws from ``generator``; ``lookup`` replaces the
    trunk's embedding gather."""
    x = trunk.apply(params["trunk"], fm, cfg, batch, seq_pooling=SEQ_POOLING,
                    compute_dtype=compute_dtype, train=train, generator=generator, lookup=lookup)
    logits, mlp_state = mlp_ops.apply(
        params["mlp"], state["mlp"], x.flatten(1).to(trunk.tower_dtype(cfg, compute_dtype)),
        train=train, dropout_rate=cfg.net_dropout, generator=generator, weight=weight,
    )
    return logits[..., 0].float(), {"mlp": mlp_state}
