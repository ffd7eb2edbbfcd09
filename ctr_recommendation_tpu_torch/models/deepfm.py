"""DeepFM (Guo et al. 2017), the JAX package's ``models/deepfm.py``, over the
(B, F, E) field stack: logits = first + second + deep, where

* first = sum_f <w_f, x_f> + b, one (F, E) weight and a 0-d bias, in fp32;
* second = 0.5 * sum_E((sum_f x_f)^2 - sum_f x_f^2), the factorization
  machine by the square-of-sum identity, in fp32;
* deep = the BatchNorm MLP over the flattened stack.

Its embeddings start at N(0, 0.01) (``ModelConfig.resolved_init_std``): at
std 1 the raw FM term saturates the loss.
"""

from __future__ import annotations

import torch

from ctr_recommendation_tpu_torch.config.schema import ModelConfig
from ctr_recommendation_tpu_torch.features.feature_map import FeatureMap
from ctr_recommendation_tpu_torch.models import trunk
from ctr_recommendation_tpu_torch.ops import mlp as mlp_ops
from ctr_recommendation_tpu_torch.ops.initializers import xavier_normal

SEQ_POOLING = "mean"


def init(gen: torch.Generator, fm: FeatureMap, cfg: ModelConfig) -> tuple[dict, dict]:
    """(params, state) on the CPU, drawn from ``gen`` in a fixed order."""
    f, e = fm.num_fields, cfg.embedding_dim
    params = {
        "trunk": trunk.init(gen, fm, cfg, seq_pooling=SEQ_POOLING),
        "first_order": {"w": xavier_normal(gen, (f, e)), "b": torch.zeros(())},
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
    """As ``din.apply``; the first- and second-order terms in fp32, the
    deep tower in ``tower_dtype``."""
    x = trunk.apply(params["trunk"], fm, cfg, batch, seq_pooling=SEQ_POOLING,
                    compute_dtype=compute_dtype, train=train, generator=generator, lookup=lookup)
    xs = x.float()
    fo = params["first_order"]
    first = torch.einsum("bfe,fe->b", xs, fo["w"]) + fo["b"]
    second = 0.5 * (xs.sum(1).square() - xs.square().sum(1)).sum(-1)
    deep, mlp_state = mlp_ops.apply(
        params["mlp"], state["mlp"], x.flatten(1).to(trunk.tower_dtype(cfg, compute_dtype)),
        train=train, dropout_rate=cfg.net_dropout, generator=generator, weight=weight,
    )
    return first + second + deep[..., 0].float(), {"mlp": mlp_state}
