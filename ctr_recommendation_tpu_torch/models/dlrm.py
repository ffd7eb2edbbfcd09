"""DLRM-style dot interaction (Naumov et al. 2019), the JAX package's
``models/dlrm.py``: every field is an E-vector; the top MLP reads the dense
component (the first DENSE_EMBEDDING field, the trunk's projection of the
multimodal vector, or zeros when the feature map has none) beside the
F(F-1)/2 pairwise dots (``bilinear.inner_products``):
``logits = TopMLP([dense ‖ dots])``.
"""

from __future__ import annotations

import torch

from ctr_recommendation_tpu_torch.config.schema import FeatureType, ModelConfig
from ctr_recommendation_tpu_torch.features.feature_map import FeatureMap
from ctr_recommendation_tpu_torch.models import trunk
from ctr_recommendation_tpu_torch.ops import mlp as mlp_ops
from ctr_recommendation_tpu_torch.ops.bilinear import inner_products

SEQ_POOLING = "mean"


def _dense_field_index(fm: FeatureMap) -> int | None:
    return next((i for i, f in enumerate(fm.features)
                 if f.type == FeatureType.DENSE_EMBEDDING), None)


def init(gen: torch.Generator, fm: FeatureMap, cfg: ModelConfig) -> tuple[dict, dict]:
    """(params, state) on the CPU, drawn from ``gen`` in a fixed order."""
    params = {"trunk": trunk.init(gen, fm, cfg, seq_pooling=SEQ_POOLING)}
    params["mlp"], mlp_state = mlp_ops.init(
        gen, cfg.embedding_dim + fm.num_pairs, cfg.hidden_units, out_dim=1,
        batch_norm=cfg.batch_norm,
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
    """As ``din.apply``; the dots of the fields in ``tower_dtype`` summed in
    fp32, then the MLP in ``tower_dtype``."""
    x = trunk.apply(params["trunk"], fm, cfg, batch, seq_pooling=SEQ_POOLING,
                    compute_dtype=compute_dtype, train=train, generator=generator, lookup=lookup)
    td = trunk.tower_dtype(cfg, compute_dtype)
    di = _dense_field_index(fm)
    dense = x[:, di, :] if di is not None else x.new_zeros(x.shape[0], x.shape[2])
    h = torch.cat([dense.to(td), inner_products(x.to(td)).to(td)], dim=-1)
    logits, mlp_state = mlp_ops.apply(
        params["mlp"], state["mlp"], h,
        train=train, dropout_rate=cfg.net_dropout, generator=generator, weight=weight,
    )
    return logits[..., 0].float(), {"mlp": mlp_state}
