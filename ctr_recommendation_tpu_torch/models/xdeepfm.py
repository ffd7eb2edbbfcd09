"""xDeepFM: the CIN's compressed interactions beside the DNN tower, the JAX
package's ``models/xdeepfm.py`` (BASELINE.json configs[2]):
``logit = DNN(flatten(fields)) + CIN(fields)``.
"""

from __future__ import annotations

import torch

from ctr_recommendation_tpu_torch.config.schema import ModelConfig
from ctr_recommendation_tpu_torch.features.feature_map import FeatureMap
from ctr_recommendation_tpu_torch.models import trunk
from ctr_recommendation_tpu_torch.ops import cin as cin_ops
from ctr_recommendation_tpu_torch.ops import mlp as mlp_ops

SEQ_POOLING = "mean"


def init(gen: torch.Generator, fm: FeatureMap, cfg: ModelConfig) -> tuple[dict, dict]:
    """(params, state) on the CPU, drawn from ``gen`` in a fixed order."""
    f, e = fm.num_fields, cfg.embedding_dim
    params = {
        "trunk": trunk.init(gen, fm, cfg, seq_pooling=SEQ_POOLING),
        "cin": cin_ops.init(gen, f, cfg.cin_layer_units),
    }
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
    """As ``din.apply``; the CIN runs on the trunk's dtype (its last layer in
    fp32, ``cin.apply``) and its logit is cast to the DNN logit's dtype."""
    x = trunk.apply(params["trunk"], fm, cfg, batch, seq_pooling=SEQ_POOLING,
                    compute_dtype=compute_dtype, train=train, generator=generator, lookup=lookup)
    dnn_logit, mlp_state = mlp_ops.apply(
        params["mlp"], state["mlp"], x.flatten(1).to(trunk.tower_dtype(cfg, compute_dtype)),
        train=train, dropout_rate=cfg.net_dropout, generator=generator, weight=weight,
    )
    cin_logit = cin_ops.apply(params["cin"], x).to(dnn_logit.dtype)
    return (dnn_logit + cin_logit)[..., 0].float(), {"mlp": mlp_state}
